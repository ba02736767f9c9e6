"""TPS002 — monotonic-only clocks in the observability modules.

Duration/throttle math in telemetry, progress and history must run on
``time.monotonic()``: wall clocks step (NTP, suspend) and a stepped
duration is a 2 a.m. incident, not a test failure. Wall-clock
TIMESTAMPS go through each module's injectable ``_wall`` seam — a bare
``time.time`` REFERENCE stays legal, only direct CALLS are flagged.
Unlike a grep, it also catches ``from time import time`` and
``import time as t`` aliases."""

from __future__ import annotations

import ast
from typing import Iterable, List

from ..lint import Finding, LintContext, Rule, SourceFile
from ._common import member_alias_names, module_alias_names

# The monotonic-only modules (slo.py among them: RPO/interval math on a
# stepped wall clock would misreport exposure).
# Paths relative to the package root.
SCOPED_MODULES = {
    "telemetry.py",
    "progress.py",
    "history.py",
    "flight.py",
    "slo.py",
    "liveness.py",
    "fleet.py",
}


class MonotonicClockRule(Rule):
    id = "TPS002"
    title = "wall-clock call in a monotonic-only module"

    def check_file(
        self, sf: SourceFile, ctx: LintContext
    ) -> Iterable[Finding]:
        if sf.relpath not in SCOPED_MODULES or sf.tree is None:
            return ()
        tree = sf.tree
        time_mods = module_alias_names(tree, "time")
        time_funcs = member_alias_names(tree, "time", "time")
        findings: List[Finding] = []
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            direct = (
                isinstance(f, ast.Attribute)
                and f.attr == "time"
                and isinstance(f.value, ast.Name)
                and f.value.id in time_mods
            )
            aliased = isinstance(f, ast.Name) and f.id in time_funcs
            if direct or aliased:
                findings.append(
                    Finding(
                        rule=self.id,
                        path=sf.display_path,
                        line=node.lineno,
                        col=node.col_offset,
                        message=(
                            "direct wall-clock call in a monotonic-only "
                            "module — durations use time.monotonic(); "
                            "wall timestamps go through the module's "
                            "injectable _wall seam (a bare time.time "
                            "reference, never a call)"
                        ),
                    )
                )
        return findings
