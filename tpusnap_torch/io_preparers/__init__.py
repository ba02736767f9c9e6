"""Per-type write/read preparers (counterpart of tpusnap/io_preparers)."""
