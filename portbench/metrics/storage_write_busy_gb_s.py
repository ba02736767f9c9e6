"""Bytes the window's takes wrote over the wall time during which at
least one of their ``storage_write`` spans was open (``stages
.storage_write.busy_s``, from each take's telemetry summary), in GB/s:
the storage layer's rate while it had work, however many writes were in
flight."""

from portbench.metrics._common import rate_gb_s


def read(run: dict):
    return rate_gb_s(
        ((r["take_summary"].get("counters") or {}).get("storage.bytes_written", 0),
         ((r["take_summary"].get("stages") or {}).get("storage_write") or {}).get("busy_s"))
        for r in run["records"] if "take_summary" in r
    )
