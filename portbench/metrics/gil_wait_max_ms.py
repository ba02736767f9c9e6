"""Mean over the window's takes of the longest single wait of the
program's GIL probe for the interpreter (``gauges.gil.wait_max_s``, from
each take's telemetry summary), in ms."""

from portbench.metrics._common import mean_ms


def read(run: dict):
    return mean_ms((r["take_summary"].get("gauges") or {}).get("gil.wait_max_s")
                   for r in run["records"] if "take_summary" in r)
