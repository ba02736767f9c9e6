"""Kernels of the port and their plain PyTorch versions (counterpart of
tpusnap/ops). ``tpusnap_torch.ops.flash_attention`` is the flash attention
module and ``tpusnap_torch.ops.ring_attention`` the ring attention module
(kernel wrapper, plain version, launch count each)."""

from .ring_attention import ring_attention  # noqa: F401

__all__ = ["ring_attention"]
