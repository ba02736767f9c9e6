"""The configuration's FLOPs a step (counted from shapes by its plain
reference's ``step_flops``) times the steps of the window, over their
summed times, as a share of the card's dense bf16 peak, in %."""

from portbench import registry
from portbench.frozen import PEAK_FLOPS


def read(run: dict):
    steps = run["steps_s"]
    if not steps:
        return None
    flops = registry.reference(run["config"]["reference"]).step_flops(run["config"])
    return 100.0 * flops * len(steps) / sum(steps) / PEAK_FLOPS["bfloat16"]
