"""Finds each piece of the benchmark by its name, as a file of its own:

- a configuration: ``configs/<name>.json``, whose ``reference`` names its
  plain reference, ``references/<reference>.py``;
- a traffic mix: ``mixes/<name>.json``;
- a metric, end-to-end or per-layer: ``metrics/<name>.py``, a module with
  ``read(run) -> float or None``;
- the cells and the metrics they report: ``BENCHMARK.json`` at the root
  of the checkout.

A new configuration, mix, metric or cell is a new file and a new entry;
no file that is already there changes.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent


def benchmark(root: Path = CHECKOUT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def config(name: str, base: Path = HERE) -> dict:
    return json.loads((Path(base) / "configs" / f"{name}.json").read_text())


def mix(name: str, base: Path = HERE) -> dict:
    return json.loads((Path(base) / "mixes" / f"{name}.json").read_text())


def _module(path: Path, kind: str):
    mod_name = f"portbench.{kind}.{re.sub(r'[^0-9A-Za-z_]', '_', path.stem)}"
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric(name: str, base: Path = HERE):
    """The reader of metric ``name``: ``read(run) -> float or None``."""
    return _module(Path(base) / "metrics" / f"{name}.py", "metrics").read


def reference(name: str, base: Path = HERE):
    return _module(Path(base) / "references" / f"{name}.py", "references")


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def metrics_of(bench: dict, cell_name: str, traced: bool) -> list:
    """The metrics a run of ``cell_name`` reports: the end-to-end ones
    untraced, the per-layer ones traced; each listed for the cell or for
    every cell."""
    group = bench["per_layer" if traced else "end_to_end"]
    return [m for m in group if cell_name in m.get("workloads", [cell_name])]
