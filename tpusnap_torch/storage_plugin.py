"""URL scheme → StoragePlugin, with tpusnap's middleware composition.

Counterpart of tpusnap/storage_plugin.py for the local filesystem
(``fs://``, ``file://`` or a bare path) and its ``chaos+`` form:

- a plain path gets ``Instrumented(fs)``: every payload write, read,
  delete and listing lands in the I/O histograms
  (``telemetry.observe_io``);
- ``chaos+fs://`` gets ``Retrying(Instrumented(FaultInjection(fs)))``:
  the seeded ``faults.FaultPlan`` (``storage_options["fault_plan"]`` or
  ``TPUSNAP_FAULT_SPEC``) misbehaves under the whole-op retry middleware
  (``retry``), the histograms see each attempt with its injected latency.

Every wrapper passes the fs plugin's in-place reads through
(``supports_in_place_reads``, ``in_place_read_overhead_bytes``), so a
restore still lands in pinned or target memory without a second copy.
Object stores, write-back tiering (``tier+``) and the content-addressed
store (``cas+``, ``TPUSNAP_CAS_DIR``) are not ported yet (ROADMAP.md item
A8b); asking for one raises ``NotImplementedError`` instead of silently
writing locally.
"""

import asyncio
import time
from typing import Any, Dict, Optional

from .io_types import SIDECAR_PREFIX, ReadIO, StoragePlugin, WriteIO, run_on_loop
from .knobs import get_cas_dir

_CHAOS_PREFIX = "chaos+"


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to tpusnap_torch yet — it writes to the local "
        "filesystem only (ROADMAP.md item A8b)"
    )


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
    the I/O histograms key on)."""
    base = plugin
    while isinstance(getattr(base, "inner", None), StoragePlugin):
        base = base.inner
    return type(base).__name__


def url_to_storage_plugin(
    url_path: str, storage_options: Optional[Dict[str, Any]] = None
) -> StoragePlugin:
    """Map ``[scheme://]path`` to a plugin, composing the chaos, I/O
    histogram and retry layers in tpusnap's order."""
    if "://" in url_path:
        scheme, path = url_path.split("://", 1)
    else:
        scheme, path = "fs", url_path
    low = scheme.lower()
    if low.startswith("tier+"):
        raise _not_ported(f"write-back tiering ({scheme}://)")
    if low.startswith("cas+"):
        raise _not_ported(f"the content-addressed store ({scheme}://)")
    chaos = low.startswith(_CHAOS_PREFIX)
    if chaos:
        low = low[len(_CHAOS_PREFIX):] or "fs"
    if low not in ("fs", "file"):
        raise _not_ported(f"storage scheme {low!r}://")
    if get_cas_dir() is not None or (storage_options or {}).get("cas_dir"):
        raise _not_ported("the content-addressed store (TPUSNAP_CAS_DIR)")
    from .storage_plugins.fs import FSStoragePlugin

    plugin: StoragePlugin = FSStoragePlugin(root=path, storage_options=storage_options)
    if chaos:
        from .faults import FaultInjectionStoragePlugin, FaultPlan

        plan = FaultPlan.coerce((storage_options or {}).get("fault_plan"))
        plugin = FaultInjectionStoragePlugin(plugin, plan)
    plugin = InstrumentedStoragePlugin(plugin)
    # A plain path takes no retry layer; a chaos URL needs one to
    # converge.
    if chaos and (storage_options or {}).get("retry", True):
        from .retry import RetryingStoragePlugin, RetryPolicy

        plugin = RetryingStoragePlugin(
            plugin, RetryPolicy.from_storage_options(storage_options)
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
