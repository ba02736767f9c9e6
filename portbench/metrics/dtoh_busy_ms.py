"""Mean wall time per take during which at least one ``dtoh`` span was
open (``stages.dtoh.busy_s``, the union of the take's device-to-host
copies, from each take's telemetry summary), in ms."""

from portbench.metrics._common import mean_ms


def read(run: dict):
    return mean_ms(((r["take_summary"].get("stages") or {}).get("dtoh") or {}).get("busy_s")
                   for r in run["records"] if "take_summary" in r)
