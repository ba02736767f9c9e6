"""URL scheme → StoragePlugin, with tpusnap's middleware composition.

Counterpart of tpusnap/storage_plugin.py. Built-ins: ``fs`` (default,
also ``file://`` or a bare path), ``s3``, ``gs``/``gcs`` and the fsspec
bridge (``fsspec+<protocol>://``); ``register_storage_plugin`` adds others at
run time. Layers compose around the raw plugin in
tpusnap's order:

- ``chaos+<scheme>://`` wraps it in the seeded fault injection of
  ``faults`` (``storage_options["fault_plan"]`` or
  ``TPUSNAP_FAULT_SPEC``);
- ``InstrumentedStoragePlugin`` times every payload write, read, delete
  and listing into the I/O histograms (``telemetry.observe_io``);
- the whole-op retry layer (``retry``) wraps chaos URLs and the plugins
  that ask for it (s3, fsspec; gcs retries per chunk itself). The local
  filesystem takes none unless under chaos;
- ``tier+local=<dir>+remote=<url>://`` builds the write-back tier
  (``tiering``), each tier with its own layers;
- ``cas+<scheme>://``, or a plain ``fs`` path while ``TPUSNAP_CAS_DIR``
  is set, adds the content-addressed layer (``cas``).

Every wrapper passes the fs plugin's in-place reads through
(``supports_in_place_reads``, ``in_place_read_overhead_bytes``), so a
restore still lands in pinned or target memory without a second copy.
"""

import asyncio
import time
from typing import Any, Dict, Optional

from .io_types import SIDECAR_PREFIX, ReadIO, StoragePlugin, WriteIO, run_on_loop

_CHAOS_PREFIX = "chaos+"

# scheme → factory(path, storage_options), registered at run time and
# consulted before the built-ins and entry points.
_RUNTIME_REGISTRY: Dict[str, Any] = {}


def register_storage_plugin(scheme: str, factory: Any) -> None:
    """Register ``factory(path, storage_options) -> StoragePlugin`` for a
    URL scheme at run time."""
    _RUNTIME_REGISTRY[scheme.lower()] = factory


def unregister_storage_plugin(scheme: str) -> None:
    """Remove a run-time registration (no-op if absent)."""
    _RUNTIME_REGISTRY.pop(scheme.lower(), None)


def _resolve_raw_plugin(
    scheme: str, path: str, storage_options: Optional[Dict[str, Any]]
) -> StoragePlugin:
    """The plugin of a (chaos-stripped) scheme, without middleware."""
    if scheme in _RUNTIME_REGISTRY:
        return _RUNTIME_REGISTRY[scheme](path, storage_options)
    if scheme in ("", "fs", "file"):
        from .storage_plugins.fs import FSStoragePlugin

        return FSStoragePlugin(root=path, storage_options=storage_options)
    if scheme == "s3":
        from .storage_plugins.s3 import S3StoragePlugin

        return S3StoragePlugin(root=path, storage_options=storage_options)
    if scheme in ("gs", "gcs"):
        from .storage_plugins.gcs import GCSStoragePlugin

        return GCSStoragePlugin(root=path, storage_options=storage_options)
    if scheme.startswith("fsspec+"):
        from .storage_plugins.fsspec import FsspecStoragePlugin

        return FsspecStoragePlugin(
            protocol=scheme[len("fsspec+"):], root=path, storage_options=storage_options
        )
    raise RuntimeError(f"Unsupported storage scheme: {scheme}:// ({path})")


class InstrumentedStoragePlugin(StoragePlugin):
    """Latency × size histograms at the storage-plugin boundary: every
    successful payload write/read/delete/list is timed on the monotonic
    clock into ``telemetry.observe_io``, keyed ``<op>.<PluginClass>`` of
    the innermost backend. Inside the retry middleware (one sample per
    attempt), outside the chaos layer (injected latency shows as the
    tail it is). Sidecar traffic is not sampled; failures are not
    sampled. Everything else delegates to the wrapped plugin."""

    def __init__(self, inner: StoragePlugin) -> None:
        self.inner = inner
        base = inner
        while isinstance(getattr(base, "inner", None), StoragePlugin):
            base = base.inner
        self.label = type(base).__name__

    def __getattr__(self, name: str) -> Any:
        if name == "inner":
            raise AttributeError(name)
        return getattr(self.inner, name)

    @property
    def supports_in_place_reads(self) -> bool:  # type: ignore[override]
        return self.inner.supports_in_place_reads

    def classify_transient(self, exc: BaseException) -> bool:
        return self.inner.classify_transient(exc)

    def in_place_read_overhead_bytes(self, nbytes: int) -> int:
        return self.inner.in_place_read_overhead_bytes(nbytes)

    @property
    def wants_retry_middleware(self) -> bool:  # type: ignore[override]
        return self.inner.wants_retry_middleware

    @property
    def handles_own_retries(self) -> bool:  # type: ignore[override]
        return self.inner.handles_own_retries

    def drain_in_flight(self) -> None:
        self.inner.drain_in_flight()

    def _observe(self, op: str, path: str, t0: float, nbytes: int) -> None:
        if path.startswith(SIDECAR_PREFIX):
            return
        from . import telemetry

        try:
            telemetry.observe_io(op, self.label, time.monotonic() - t0, nbytes)
        except Exception:
            pass  # telemetry never fails an op

    async def write(self, write_io: WriteIO) -> None:
        t0 = time.monotonic()
        await self.inner.write(write_io)
        self._observe("write", write_io.path, t0, memoryview(write_io.buf).nbytes)

    async def write_atomic(self, write_io: WriteIO, durable: bool = False) -> None:
        t0 = time.monotonic()
        await self.inner.write_atomic(write_io, durable=durable)
        self._observe("write", write_io.path, t0, memoryview(write_io.buf).nbytes)

    @staticmethod
    def _read_nbytes(read_io: ReadIO) -> int:
        if read_io.byte_range is not None:
            return int(read_io.byte_range[1] - read_io.byte_range[0])
        if read_io.in_place and read_io.into is not None:
            return memoryview(read_io.into).nbytes
        try:
            return read_io.buf.getbuffer().nbytes
        except Exception:
            return 0

    async def read(self, read_io: ReadIO) -> None:
        t0 = time.monotonic()
        await self.inner.read(read_io)
        self._observe("read", read_io.path, t0, self._read_nbytes(read_io))

    async def delete(self, path: str) -> None:
        t0 = time.monotonic()
        await self.inner.delete(path)
        self._observe("delete", path, t0, 0)

    async def list_with_sizes(self) -> Optional[dict]:
        t0 = time.monotonic()
        out = await self.inner.list_with_sizes()
        self._observe("list", "", t0, 0)
        return out

    async def flush_created_dirs(self) -> None:
        await self.inner.flush_created_dirs()

    async def close(self) -> None:
        await self.inner.close()


def storage_plugin_label(plugin: StoragePlugin) -> str:
    """The innermost backend class name of a composed plugin (the label
    the I/O histograms key on). A tiered plugin is labelled by the tier
    a restore would read: local while the cache is whole, remote once
    evicted."""
    from .tiering import TieredStoragePlugin, restore_source_label

    base = plugin
    while True:
        if isinstance(base, TieredStoragePlugin):
            try:
                label = restore_source_label(base.spec.url)
            except Exception:
                label = None
            return label or type(base).__name__
        inner = getattr(base, "inner", None)
        if isinstance(inner, StoragePlugin):
            base = inner
            continue
        return type(base).__name__


def url_to_storage_plugin(
    url_path: str, storage_options: Optional[Dict[str, Any]] = None
) -> StoragePlugin:
    """Map ``[scheme://]path`` to a plugin, composing the tier, CAS,
    chaos, I/O histogram and retry layers in tpusnap's order."""
    if "://" in url_path:
        scheme, path = url_path.split("://", 1)
    else:
        scheme, path = "fs", url_path
    # Tier and CAS URLs embed case-sensitive paths in the scheme, and
    # compose their own layers (chaos belongs on the remote sub-scheme).
    if scheme.lower().startswith("tier+"):
        from .tiering import build_tiered_plugin

        return build_tiered_plugin(url_path, storage_options)
    if scheme.lower().startswith("cas+"):
        from .cas import build_cas_plugin

        return build_cas_plugin(url_path, storage_options)
    scheme = scheme.lower()
    chaos = scheme.startswith(_CHAOS_PREFIX)
    if chaos:
        scheme = scheme[len(_CHAOS_PREFIX):] or "fs"
        if scheme.startswith("tier+"):
            raise RuntimeError(
                "chaos cannot wrap a whole tier URL — compose it on the remote "
                "sub-scheme instead (tier+local=...+remote=chaos+<scheme>://...), "
                "so faults hit the tier the drain tolerates, not the local "
                "commit of record"
            )
    # Run-time registered factories own their composition; chaos still
    # composes around them.
    from_runtime_registry = scheme in _RUNTIME_REGISTRY
    plugin = _resolve_raw_plugin(scheme, path, storage_options)
    if chaos:
        from .faults import FaultInjectionStoragePlugin, FaultPlan

        plan = FaultPlan.coerce((storage_options or {}).get("fault_plan"))
        plugin = FaultInjectionStoragePlugin(plugin, plan)
    if chaos or not from_runtime_registry:
        plugin = InstrumentedStoragePlugin(plugin)
    wants_retry = chaos or (
        not from_runtime_registry and getattr(plugin, "wants_retry_middleware", False)
    )
    if (
        wants_retry
        and (storage_options or {}).get("retry", True)
        and not getattr(plugin, "handles_own_retries", False)
    ):
        from .retry import RetryingStoragePlugin, RetryPolicy

        plugin = RetryingStoragePlugin(
            plugin, RetryPolicy.from_storage_options(storage_options)
        )
    # TPUSNAP_CAS_DIR composes the CAS layer around fs-family snapshots
    # (ref records and the store's mark phase need a listable local
    # directory). Internal builds (the store's own plugin, fsck/gc
    # probes, the tier drain's local re-root) pass {"cas": False}.
    if (storage_options or {}).get("cas", True) and scheme in ("fs", "file"):
        from .cas import CASStoragePlugin, resolve_store_url

        store_url = resolve_store_url(None, storage_options)
        if store_url:
            plugin = CASStoragePlugin(
                plugin,
                base_url=f"fs://{path}",
                store_url=store_url,
                storage_options=dict(storage_options or {}, cas=False),
            )
    return plugin


def url_to_storage_plugin_in_event_loop(
    url_path: str,
    event_loop: asyncio.AbstractEventLoop,
    storage_options: Optional[Dict[str, Any]] = None,
) -> StoragePlugin:
    async def _create() -> StoragePlugin:
        return url_to_storage_plugin(url_path, storage_options)

    return run_on_loop(event_loop, _create())
