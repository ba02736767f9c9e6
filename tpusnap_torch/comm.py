"""Metadata collectives.

Counterpart of tpusnap/comm.py, reduced to the single-process no-op
``Communicator`` (tpusnap/comm.py:60-124) and ``get_communicator``. The
multi-process communicator over a ``torch.distributed`` store is a later
slice (ROADMAP.md item A4): asking for one raises.
"""

from __future__ import annotations

from typing import Any, List, Optional


class Communicator:
    """Uniform interface; this base class is the single-process no-op
    implementation."""

    @property
    def rank(self) -> int:
        return 0

    @property
    def world_size(self) -> int:
        return 1

    def barrier(self) -> None:
        return None

    def all_gather_object(self, obj: Any) -> List[Any]:
        return [obj]

    def broadcast_object(self, obj: Any, src: int = 0) -> Any:
        return obj


def get_communicator(comm: Optional[Communicator] = None) -> Communicator:
    """The given communicator, or the single-process one. A multi-process
    world — an explicit communicator with ``world_size > 1``, or an
    initialised ``torch.distributed`` group of more than one rank — is
    refused until the distributed slice lands."""
    if comm is None:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
            raise NotImplementedError(
                "multi-process snapshots are not ported yet (ROADMAP.md item A4)"
            )
        return Communicator()
    if comm.world_size > 1:
        raise NotImplementedError(
            "multi-process snapshots are not ported yet (ROADMAP.md item A4)"
        )
    return comm
