"""Mean staging seconds of the window's takes, from the scheduler's
``LAST_EXECUTION_STATS["write"]["staging_s"]`` after each, in ms."""

from portbench.metrics._common import mean_ms


def read(run: dict):
    return mean_ms(r["stats"].get("staging_s") for r in run["records"] if "rollup" in r)
