"""The control: the plain reference put in the program's place and
computed in fp8, the precision below the configuration's bfloat16, has
to come out not correct under the configuration's limits; so has the
reference over half of each batch. At a tiny size on the CPU, and at the
configuration's own size on the card (``-m cuda``)."""

import pytest
import torch

from portbench import calibrate, registry

from .conftest import TINY


def _fails(limits, gaps):
    return [k for k in limits if gaps[k] > limits[k]]


@pytest.mark.parametrize("name", ["transformer-big"])
def test_control_fails_at_a_tiny_size(name):
    cfg = {**registry.config(name), **TINY}
    found = calibrate.readings(cfg, 2**31 + 3, torch.device("cpu"), program=True, control=True)
    limits = cfg["limits"]
    assert not _fails(limits, found["program"]), found["program"]
    assert _fails(limits, found["control"]), found["control"]
    assert _fails(limits, found["half_batch"]), found["half_batch"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["transformer-big"])
@pytest.mark.parametrize("seed", [2**31 + 21, 2**31 + 22, 2**31 + 23])
def test_control_fails_at_the_configuration_size(name, seed, card):
    cfg = registry.config(name)
    found = calibrate.readings(cfg, seed, card, program=True, control=True)
    limits = cfg["limits"]
    assert not _fails(limits, found["program"]), found["program"]
    assert _fails(limits, found["control"]), found["control"]
    assert _fails(limits, found["half_batch"]), found["half_batch"]
