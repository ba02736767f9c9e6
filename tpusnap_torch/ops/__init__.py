"""Kernels of the port and their plain PyTorch versions (counterpart of
tpusnap/ops). ``tpusnap_torch.ops.flash_attention`` is the flash attention
module (kernel wrapper, plain version, launch count). Ring attention is a
later slice (ROADMAP.md item B3)."""
