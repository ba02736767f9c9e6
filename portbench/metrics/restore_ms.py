"""Mean host-clock time of the window's in-place restores (each returns
after its device copies have completed), in ms."""

from portbench.metrics._common import mean_ms


def read(run: dict):
    return mean_ms(r.get("restore_s") for r in run["records"])
