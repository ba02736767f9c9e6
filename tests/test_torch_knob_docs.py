"""Doc/code drift guards of the port (mirroring tests/test_knob_docs.py),
thin wrappers over the port's lint engine:

1. Knob drift (TPS007, ``tpusnap_torch/devtools/rules/tps007_knob_docs.py``)
   — every ``TPUSNAP_*`` env var defined in tpusnap_torch/knobs.py must
   appear in docs/api.md (the knob table both packages share), and every
   knob row in api.md's table must be referenced somewhere in the port's
   source.
2. Monotonic-only clocks (TPS002, ``rules/tps002_monotonic.py``) —
   direct wall-clock CALLS are forbidden in telemetry/progress/history;
   timestamps ride each module's injectable ``_wall`` seam (a bare
   ``time.time`` reference). The AST rule also catches the aliased
   imports (``from time import time``) the original grep missed.

Kept as named tests (not just the whole-package gate in
test_torch_lint.py) so a drift failure points at the invariant by name."""

from tpusnap_torch.devtools.lint import render_table, run_lint


def _run_rule(rule_id):
    result = run_lint(select=[rule_id])
    assert result.rules_run == [rule_id]
    return result


def test_knob_doc_drift_tps007():
    result = _run_rule("TPS007")
    assert result.findings == [], "\n" + render_table(result)


def test_monotonic_only_clocks_tps002():
    result = _run_rule("TPS002")
    assert result.findings == [], "\n" + render_table(result)
