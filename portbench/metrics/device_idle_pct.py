"""The share of the traced window in which no kernel, copy or memset ran
on the card, from the profiler's trace, in %."""


def read(run: dict):
    tr = run["trace"]
    if not tr or not tr["window_s"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
