"""URL scheme → StoragePlugin.

Counterpart of tpusnap/storage_plugin.py, reduced to the local
filesystem (``fs://`` or a bare path). Object stores, fault injection,
retry middleware, write-back tiering and the content-addressed store
are later slices of the port (ROADMAP.md, section A); asking for one
raises ``NotImplementedError`` instead of silently writing locally.
"""

import asyncio
from typing import Any, Dict, Optional

from .io_types import StoragePlugin, run_on_loop
from .knobs import get_cas_dir


def url_to_storage_plugin(
    url_path: str, storage_options: Optional[Dict[str, Any]] = None
) -> StoragePlugin:
    if "://" in url_path:
        scheme, path = url_path.split("://", 1)
    else:
        scheme, path = "fs", url_path
    if scheme.lower() not in ("fs", "file"):
        raise NotImplementedError(
            f"storage scheme {scheme!r}:// is not ported yet — tpusnap_torch "
            "writes to the local filesystem only (ROADMAP.md item A8)"
        )
    if get_cas_dir() is not None or (storage_options or {}).get("cas_dir"):
        raise NotImplementedError(
            "the content-addressed store (TPUSNAP_CAS_DIR) is not ported yet "
            "(ROADMAP.md item A8)"
        )
    from .storage_plugins.fs import FSStoragePlugin

    return FSStoragePlugin(root=path, storage_options=storage_options)


def url_to_storage_plugin_in_event_loop(
    url_path: str,
    event_loop: asyncio.AbstractEventLoop,
    storage_options: Optional[Dict[str, Any]] = None,
) -> StoragePlugin:
    async def _create() -> StoragePlugin:
        return url_to_storage_plugin(url_path, storage_options)

    return run_on_loop(event_loop, _create())
