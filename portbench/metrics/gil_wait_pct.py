"""The share of the window's takes' wall time that the program's GIL
probe, a Python thread woken every few ms, spent waiting to run
(``gil.wait_ns`` over ``take_wall_s``, from each take's telemetry
summary), in %."""


def read(run: dict):
    pairs = [((r["take_summary"].get("counters") or {}).get("gil.wait_ns"), r["take_summary"].get("take_wall_s"))
             for r in run["records"] if "take_summary" in r]
    pairs = [(ns, s) for ns, s in pairs if ns is not None and s]
    if not pairs:
        return None
    return 100.0 * sum(ns for ns, _ in pairs) / 1e9 / sum(s for _, s in pairs)
