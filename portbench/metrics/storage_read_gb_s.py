"""Bytes the window's restores read over their ``storage_read`` span
seconds, from each restore's telemetry summary, in GB/s."""

from portbench.metrics._common import category_s, rate_gb_s


def read(run: dict):
    return rate_gb_s(
        (r["summary"].get("counters", {}).get("storage.bytes_read", 0),
         category_s(r["summary"].get("stages"), "storage_read", "total_s"))
        for r in run["records"] if "summary" in r
    )
