"""Mean host time per take spent allocating the pinned buffers of its
device-to-host copies (``dtoh.pin_alloc_ns``, from each take's telemetry
summary), in ms."""

from portbench.metrics._common import mean_ms


def read(run: dict):
    ns = ((r["take_summary"].get("counters") or {}).get("dtoh.pin_alloc_ns")
          for r in run["records"] if "take_summary" in r)
    return mean_ms(None if v is None else v / 1e9 for v in ns)
