"""Mean wall time of the window's async takes from the call to the commit
(the program's own ``take_wall_s`` in each take's telemetry rollup), in
ms."""

from portbench.metrics._common import mean_ms


def read(run: dict):
    return mean_ms(r["rollup"].get("take_wall_s") for r in run["records"] if "rollup" in r)
