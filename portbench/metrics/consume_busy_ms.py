"""Mean wall time per restore during which at least one ``consume`` span
(deserialise and host-to-device copy) was open (``stages.consume
.busy_s``, from each restore's telemetry summary), in ms."""

from portbench.metrics._common import mean_ms


def read(run: dict):
    return mean_ms(((r["summary"].get("stages") or {}).get("consume") or {}).get("busy_s")
                   for r in run["records"] if "summary" in r)
