"""Integration tricks: route another framework's checkpoint calls through
tpusnap_torch (counterpart of tpusnap/tricks/). ``tricks.dcp`` mirrors
``torch.distributed.checkpoint``'s ``save`` / ``async_save`` / ``load``
and orbax's ``PyTreeCheckpointer``."""
