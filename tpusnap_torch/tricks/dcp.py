"""Drop-in for ``torch.distributed.checkpoint``: migrate in one line.

Counterpart of tpusnap/tricks/orbax.py. The JAX package mirrors its
ecosystem's standard checkpointer surface (orbax's ``PyTreeCheckpointer``);
in PyTorch that surface is DCP's ``save`` / ``async_save`` / ``load``, so

    import torch.distributed.checkpoint as dcp

becomes

    import tpusnap_torch.tricks.dcp as dcp

and ``dcp.save(state_dict, checkpoint_id=path)``,
``dcp.async_save(...)`` and ``dcp.load(state_dict, checkpoint_id=path)``
(in place, as DCP's) go through tpusnap's pipelined, budget-gated,
replication-deduped snapshots. The files are tpusnap's format, not DCP's:
no planner, ``StorageWriter`` or ``StorageReader`` is involved.

``PyTreeCheckpointer`` is the JAX class's surface and layout: one
``PytreeState`` under the key ``"pytree"``, so a directory written by
either package's checkpointer restores through the other's.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Optional

from ..flatten import _decode
from ..manifest import is_container_entry
from ..pytree_state import PytreeState
from ..snapshot import PendingSnapshot, Snapshot

__all__ = ["AsyncSave", "PyTreeCheckpointer", "async_save", "load", "save"]


class _Placeholder:
    """A leaf to be replaced by the saved value. Not ``None``: under
    ``torch.utils._pytree`` ``None`` is a leaf that ``PytreeState`` gives
    no entry (as JAX's empty node gets none), so a ``None`` placeholder
    would restore nothing."""


_PLACEHOLDER = _Placeholder()


def _fspath(path: Optional[Any]) -> Optional[str]:
    return os.fspath(path) if path is not None else None


class PyTreeCheckpointer:
    """save/restore a pytree at a directory, orbax-style."""

    _KEY = "pytree"

    def save(
        self,
        directory: Any,
        item: Any,
        *,
        force: bool = False,
        incremental_from: Optional[Any] = None,
    ) -> None:
        """``incremental_from``: dedup against a previous checkpoint
        directory — unchanged leaves reference the base instead of being
        rewritten (see ``Snapshot.take``)."""
        path = os.fspath(directory)
        if force and os.path.isdir(path):
            shutil.rmtree(path, ignore_errors=True)
        Snapshot.take(
            path, {self._KEY: PytreeState(item)}, incremental_from=_fspath(incremental_from)
        )

    def async_save(
        self, directory: Any, item: Any, *, incremental_from: Optional[Any] = None
    ) -> PendingSnapshot:
        """Returns once the state is staged; storage I/O and the commit
        drain on a background thread (call ``.wait()``)."""
        return Snapshot.async_take(
            os.fspath(directory),
            {self._KEY: PytreeState(item)},
            incremental_from=_fspath(incremental_from),
        )

    def restore(self, directory: Any, item: Optional[Any] = None) -> Any:
        """Restore the saved pytree. With ``item`` (a target pytree of
        tensors), tensors restore in place and the tree's structure is
        kept. Without a target, the saved structure is rebuilt from the
        manifest (nested dicts keyed by each leaf's key path) with CPU
        tensors."""
        snapshot = Snapshot(os.fspath(directory))
        state = PytreeState(self._placeholder_tree(snapshot) if item is None else item)
        snapshot.restore({self._KEY: state})
        return state.tree

    def _placeholder_tree(self, snapshot: Snapshot) -> Any:
        """Nested dict of placeholders mirroring the saved pytree's key
        paths (``PytreeState``'s named state_dict layout)."""
        leaf_paths = set()
        prefix = f"{self._KEY}/"
        for p, entry in snapshot.get_manifest().items():
            parts = p.split("/", 1)
            if len(parts) != 2 or is_container_entry(entry):
                continue
            if parts[1].startswith(prefix):
                leaf_paths.add(parts[1][len(prefix):])
        if leaf_paths == {"__value__"}:
            return _PLACEHOLDER  # bare-leaf pytree (PytreeState's sentinel)
        root: Any = {}
        for lp in sorted(leaf_paths):
            segs = [_decode(s) for s in lp.split("/")]
            node = root
            for seg in segs[:-1]:
                node = node.setdefault(seg, {})
            node[segs[-1]] = _PLACEHOLDER
        return root


class AsyncSave:
    """What ``async_save`` returns: DCP's future surface (``result()``,
    ``done()``) over the pending snapshot."""

    def __init__(self, pending: PendingSnapshot) -> None:
        self.pending = pending

    def done(self) -> bool:
        return self.pending.done()

    def result(self) -> Snapshot:
        return self.pending.wait()


def save(state_dict: Any, *, checkpoint_id: Any) -> None:
    """``torch.distributed.checkpoint.save`` through tpusnap."""
    PyTreeCheckpointer().save(checkpoint_id, state_dict)


def async_save(state_dict: Any, *, checkpoint_id: Any) -> AsyncSave:
    """``torch.distributed.checkpoint.async_save`` through tpusnap:
    returns once the state is staged."""
    return AsyncSave(PyTreeCheckpointer().async_save(checkpoint_id, state_dict))


def load(state_dict: Any, *, checkpoint_id: Any) -> None:
    """``torch.distributed.checkpoint.load`` through tpusnap, in place:
    tensors are restored into, other values replaced in their dicts and
    lists."""
    restored = PyTreeCheckpointer().restore(checkpoint_id, state_dict)
    _assign(state_dict, restored)


def _assign(dst: Any, src: Any) -> None:
    """Put ``src``'s leaves into ``dst``'s mutable containers where they
    are other objects (a tensor restored in place is the same object)."""
    keys = dst.keys() if isinstance(dst, dict) else range(len(dst))
    for k in keys:
        if isinstance(dst[k], (dict, list)):
            _assign(dst[k], src[k])
        elif src[k] is not dst[k]:
            dst[k] = src[k]
