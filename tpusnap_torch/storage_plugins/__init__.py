"""Storage backends (counterpart of tpusnap/storage_plugins)."""
