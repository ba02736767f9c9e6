"""The harness finds every piece by name, as a file of its own, and
BENCHMARK.json keeps to the shape the check reads."""

import hashlib
import json
import re
import shutil
from pathlib import Path

import pytest

from portbench import registry

NAME = re.compile(r"^[0-9A-Za-z_][0-9A-Za-z_.-]{0,63}$")
UNIT = re.compile(r"^[0-9A-Za-z_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return registry.benchmark()


def test_finds_the_pieces_by_name():
    assert registry.config("transformer-big")["d_model"] == 1024
    assert registry.mix("async_mem")["checkpoint"] == "async_take"
    assert registry.metric("step_ms_p95")({"steps_s": [0.01] * 20}) == pytest.approx(10.0)
    assert registry.reference("flagship_transformer").step_flops


def _digests(base: Path) -> dict:
    return {str(p.relative_to(base)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(base.rglob("*")) if p.is_file()}


def test_new_pieces_are_new_files_only(tmp_path):
    base = tmp_path / "portbench"
    for sub in ("configs", "mixes", "metrics", "references"):
        shutil.copytree(registry.HERE / sub, base / sub)
    before = _digests(base)
    cfg = dict(registry.config("transformer-big"), n_layers=8, name="flagship-deep")
    (base / "configs" / "flagship-deep.json").write_text(json.dumps(cfg))
    (base / "mixes" / "async_mem_8.json").write_text(json.dumps(dict(registry.mix("async_mem"), every_steps=8)))
    (base / "metrics" / "steps_per_s.py").write_text(
        "def read(run):\n    return len(run['steps_s']) / run['window_s']\n")
    assert registry.config("flagship-deep", base)["n_layers"] == 8
    assert registry.mix("async_mem_8", base)["every_steps"] == 8
    assert registry.metric("steps_per_s", base)({"steps_s": [0.1] * 5, "window_s": 2.0}) == 2.5
    after = _digests(base)
    assert {k: after[k] for k in before} == before
    assert set(after) - set(before) == {
        "configs/flagship-deep.json", "mixes/async_mem_8.json", "metrics/steps_per_s.py"}


def test_every_name_and_unit_keeps_to_its_characters(bench):
    names = [c["name"] for c in bench["configs"]] + [w["name"] for w in bench["workloads"]]
    names += [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    names += [w["traffic"] for w in bench["workloads"]] + [k for c in bench["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    assert len(set(names[:len(bench["configs"]) + len(bench["workloads"])])) == \
        len(bench["configs"]) + len(bench["workloads"])
    assert all(UNIT.match(m["unit"]) for m in bench["end_to_end"] + bench["per_layer"])


def test_every_cell_finds_its_files_and_reports_what_it_must(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for c in bench["configs"]:
        cfg = json.loads((registry.CHECKOUT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
    for w in bench["workloads"]:
        assert w["chips"] == 1
        registry.config(w["config"]), registry.mix(w["traffic"])
        reported = [m["name"] for m in registry.metrics_of(bench, w["name"], False)]
        assert "setup_s" in reported and len(reported) >= 2, w["name"]
        layered = registry.metrics_of(bench, w["name"], True)
        assert layered, w["name"]
        for m in layered:
            assert m["moves"] in reported, (w["name"], m["name"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(registry.metric(m["name"]))
        for key in m.get("workloads", []):
            registry.cell(bench, key)
    assert e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in bench["end_to_end"])


def test_every_configuration_keeps_its_source_values_but_what_it_lists_as_reduced(bench):
    """A configuration's file gives the published sizes (``source_values``)
    and runs them: a key whose value differs from the source's is listed
    in ``reduced``, and no width is among those."""
    widths = {"d_model", "n_heads", "d_ff"}
    for c in bench["configs"]:
        cfg = registry.config(c["name"])
        changed = {k for k, v in cfg["source_values"].items() if cfg[k] != v}
        assert changed == set(c["reduced"]), c["name"]
        assert not changed & widths, c["name"]
        ref = registry.reference(cfg["reference"])
        assert cfg["flops_per_step"] == ref.step_flops(cfg)
