# Version of the snapshot format written to SnapshotMetadata — the same
# value tpusnap/version.py writes, so either package reads the other's
# snapshots.
__version__ = "0.1.0"
