"""TPS004 — no silent exception swallows in crash-safety modules.

``except Exception: pass`` in the modules that implement abort
propagation, the take journal and fault injection hides exactly the
failures those layers exist to surface. Every swallow must be either
logged (``logger.debug(..., exc_info=True)`` is enough — the point is
that the evidence EXISTS when someone turns the level up) or waived
with a reason (``pass  # tpusnap: waive=TPS004 <why>``), so every
swallow in a crash-safety module is deliberate and self-documenting.
Handlers that return/continue/raise are deliberate control flow and are
not flagged."""

from __future__ import annotations

import ast
from typing import Iterable, List

from ..lint import Finding, LintContext, Rule, SourceFile

# The crash-safety modules: distributed abort + coordination (comm,
# dist_store), the take journal / fsck / gc (lifecycle), and the fault
# injection layer itself (faults).
SCOPED_MODULES = {"comm.py", "dist_store.py", "lifecycle.py", "faults.py"}

_BROAD = {"Exception", "BaseException"}


def _is_broad(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:  # bare except
        return True
    if isinstance(t, ast.Name):
        return t.id in _BROAD
    if isinstance(t, ast.Tuple):
        return any(
            isinstance(e, ast.Name) and e.id in _BROAD for e in t.elts
        )
    return False


class SilentSwallowRule(Rule):
    id = "TPS004"
    title = "silent except-pass in a crash-safety module"

    def check_file(
        self, sf: SourceFile, ctx: LintContext
    ) -> Iterable[Finding]:
        if sf.relpath not in SCOPED_MODULES or sf.tree is None:
            return ()
        findings: List[Finding] = []
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.ExceptHandler) or not _is_broad(node):
                continue
            if not all(isinstance(s, ast.Pass) for s in node.body):
                continue
            anchor = node.body[0]
            findings.append(
                Finding(
                    rule=self.id,
                    path=sf.display_path,
                    line=anchor.lineno,
                    col=anchor.col_offset,
                    message=(
                        "broad exception silently swallowed in a "
                        "crash-safety module — add a logger.debug(..., "
                        "exc_info=True) or waive with a reason"
                    ),
                )
            )
        return findings
