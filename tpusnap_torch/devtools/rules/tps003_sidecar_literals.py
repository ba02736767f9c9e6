"""TPS003 — one canonical definition of the ``.tpusnap`` sidecar
namespace. The journal writer, fsck's classifier, the heartbeat pump,
the probe runner and the histogram sampler all make decisions keyed on
these paths; a private string copy in any of them is a silent-drift
hazard (rename the namespace in one place and fsck starts calling
committed snapshots foreign). All code references go through the
constants exported by :mod:`tpusnap_torch.io_types`; docstrings and comments
are exempt (they describe the layout, they don't implement it)."""

from __future__ import annotations

import ast
from typing import Iterable, List

from ..lint import Finding, LintContext, Rule, SourceFile
from ._common import statement_string_ids

# Built by concatenation so this rule module does not flag itself.
NEEDLE = ".tpusnap" + "/"

_EXEMPT_FILES = {"io_types.py"}


class SidecarLiteralRule(Rule):
    id = "TPS003"
    title = "sidecar namespace literal outside io_types"

    def check_file(
        self, sf: SourceFile, ctx: LintContext
    ) -> Iterable[Finding]:
        if sf.relpath in _EXEMPT_FILES or sf.tree is None:
            return ()
        doc_ids = statement_string_ids(sf.tree)
        findings: List[Finding] = []
        for node in ast.walk(sf.tree):
            if (
                isinstance(node, ast.Constant)
                and isinstance(node.value, str)
                and NEEDLE in node.value
                and id(node) not in doc_ids
            ):
                findings.append(
                    Finding(
                        rule=self.id,
                        path=sf.display_path,
                        line=node.lineno,
                        col=node.col_offset,
                        message=(
                            f"hardcoded sidecar path {node.value!r} — use "
                            "the canonical constants exported by "
                            "tpusnap_torch.io_types (SIDECAR_PREFIX, "
                            "JOURNAL_PATH, PROGRESS_DIR, TELEMETRY_DIR, "
                            "PROBE_DIR)"
                        ),
                    )
                )
        return findings
