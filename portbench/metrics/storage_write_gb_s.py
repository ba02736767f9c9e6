"""Bytes the window's takes wrote over their ``storage_write`` span
seconds (summed over the writes in flight, so a rate per write stream),
from each take's telemetry rollup, in GB/s."""

from portbench.metrics._common import category_s, rate_gb_s


def read(run: dict):
    return rate_gb_s(
        (r["rollup"].get("bytes_written", 0), category_s(r["rollup"].get("stages"), "storage_write", "max_s"))
        for r in run["records"] if "rollup" in r
    )
