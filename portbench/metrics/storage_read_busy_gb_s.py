"""Bytes the window's restores read over the wall time during which at
least one of their ``storage_read`` spans was open (``stages
.storage_read.busy_s``, from each restore's telemetry summary), in GB/s."""

from portbench.metrics._common import rate_gb_s


def read(run: dict):
    return rate_gb_s(
        ((r["summary"].get("counters") or {}).get("storage.bytes_read", 0),
         ((r["summary"].get("stages") or {}).get("storage_read") or {}).get("busy_s"))
        for r in run["records"] if "summary" in r
    )
