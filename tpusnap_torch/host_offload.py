"""Host-offloaded tensors — pinned CPU memory, the UVM analog.

Counterpart of tpusnap/host_offload.py. tpusnap places an array in an XLA
host memory kind (``pinned_host`` or ``unpinned_host``); in PyTorch that
is a CPU tensor in page-locked (pinned) or pageable memory. The card
reads and writes pinned memory by DMA, so a host-offloaded table is
usable from the card, and a snapshot stages it as a view of itself: no
device-to-host copy (the reference's ``_uvm_to_cpu`` shortcut).

Pinning needs CUDA. Without it, ``to_host_offload`` degrades to pageable
memory and says so at debug level, as tpusnap degrades on backends that
lack ``pinned_host``.
"""

from __future__ import annotations

import logging

import torch

logger = logging.getLogger(__name__)

_HOST_MEMORY_KINDS = frozenset({"pinned_host", "unpinned_host"})


def supports_host_offload() -> bool:
    """Whether pinned host memory is available: it is when CUDA is."""
    return torch.cuda.is_available()


def is_host_resident(t: object) -> bool:
    """True when the value lives in host memory: any CPU tensor, and
    numpy or any other non-tensor value."""
    if not isinstance(t, torch.Tensor):
        return True
    return t.device.type == "cpu"


def is_offloaded_to_host(t: object) -> bool:
    """True for a tensor in pinned host memory: offloaded from the card,
    not merely a CPU tensor."""
    return isinstance(t, torch.Tensor) and t.device.type == "cpu" and t.is_pinned()


def to_host_offload(t: torch.Tensor, memory_kind: str = "pinned_host") -> torch.Tensor:
    """A copy of ``t`` in host memory: pinned for ``"pinned_host"``,
    pageable for ``"unpinned_host"``. Without CUDA, pinned memory
    degrades to pageable."""
    if memory_kind not in _HOST_MEMORY_KINDS:
        raise ValueError(f"not a host memory kind: {memory_kind!r}")
    pin = memory_kind == "pinned_host"
    if pin and not supports_host_offload():
        logger.debug("pinned host memory needs CUDA; using pageable memory")
        pin = False
    out = torch.empty(tuple(t.shape), dtype=t.dtype, pin_memory=pin)
    out.copy_(t.detach())
    return out


def to_device(t: torch.Tensor, device="cuda") -> torch.Tensor:
    """A host-offloaded tensor back on the card."""
    return t.to(device)
