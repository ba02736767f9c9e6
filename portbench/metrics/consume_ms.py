"""Mean seconds per restore of the spans in the ``consume`` category
(deserialise and host-to-device copy), from each restore's telemetry
summary, in ms."""

from portbench.metrics._common import category_s, mean_ms


def read(run: dict):
    return mean_ms(category_s(r["summary"].get("stages"), "consume", "total_s")
                   for r in run["records"] if "summary" in r)
