"""Mean seconds per take of the spans in the ``dtoh`` category, from each
take's telemetry rollup, in ms."""

from portbench.metrics._common import category_s, mean_ms


def read(run: dict):
    return mean_ms(category_s(r["rollup"].get("stages"), "dtoh", "max_s")
                   for r in run["records"] if "rollup" in r)
