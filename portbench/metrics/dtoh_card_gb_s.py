"""Bytes the window's takes copied from the card to pinned host memory
over the copies' time on the card (``dtoh.bytes`` over ``dtoh.card_ns``,
timed by events on the copy's stream, from each take's telemetry
summary), in GB/s."""


def read(run: dict):
    counters = [r["take_summary"].get("counters") or {} for r in run["records"] if "take_summary" in r]
    nbytes = sum(c.get("dtoh.bytes", 0) for c in counters)
    card_ns = sum(c.get("dtoh.card_ns", 0) for c in counters)
    return nbytes / card_ns if nbytes and card_ns else None
