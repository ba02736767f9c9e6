"""TPS007 — knob/doc drift. Every ``TPUSNAP_*`` env var defined in
``knobs.py`` must be documented in ``docs/api.md``, and every knob row
in api.md's knob table must still be referenced somewhere in the
package source — an undocumented knob is invisible to operators, and a
documented-but-dead knob is a support trap. The table in ``docs/api.md``
is shared with tpusnap: one knob table drives both packages
(tests/test_torch_knob_docs.py wraps this rule)."""

from __future__ import annotations

import os
import re
from typing import Iterable, List

from ..lint import Finding, LintContext, Rule

_DEFINED_RE = re.compile(r'"(TPUSNAP_[A-Z0-9_]+)"')
_DOC_ROW_RE = re.compile(r"^\|\s*`(TPUSNAP_[A-Z0-9_]+)`", re.M)


class KnobDocDriftRule(Rule):
    id = "TPS007"
    title = "knob/doc drift between knobs.py and docs/api.md"

    def check_project(self, ctx: LintContext) -> Iterable[Finding]:
        findings: List[Finding] = []
        knobs = ctx.file("knobs.py")
        if knobs is None:
            return [
                Finding(
                    rule=self.id,
                    path="knobs.py",
                    line=1,
                    col=0,
                    message="knobs.py not found — knob/doc drift unverifiable",
                )
            ]
        docs_dir = os.path.join(ctx.repo_root, "docs")
        if not os.path.isdir(docs_dir):
            # No docs/ directory next to the package at all: this is an
            # installed copy (site-packages), not a repo checkout — the
            # drift check has nothing to check against and must not
            # fail `lint --check` on a clean install. A CHECKOUT that
            # loses docs/api.md while keeping docs/ still fails below.
            return []
        api_path = os.path.join(docs_dir, "api.md")
        try:
            with open(api_path, "r", encoding="utf-8") as f:
                docs = f.read()
        except OSError:
            return [
                Finding(
                    rule=self.id,
                    path="docs/api.md",
                    line=1,
                    col=0,
                    message=(
                        "docs/ exists but docs/api.md is unreadable — "
                        "knob/doc drift unverifiable"
                    ),
                )
            ]

        # Vacuous-pass guards (the deleted grep tests carried these):
        # zero knobs found or zero table rows means the PATTERNS broke,
        # not that drift is absent — a silently disabled gate is itself
        # a finding.
        if not _DEFINED_RE.search(knobs.source):
            findings.append(
                Finding(
                    rule=self.id,
                    path=knobs.display_path,
                    line=1,
                    col=0,
                    message=(
                        "no TPUSNAP_* knob definitions found in knobs.py "
                        "— did the declaration style change? The drift "
                        "gate would pass vacuously"
                    ),
                )
            )
        if not _DOC_ROW_RE.search(docs):
            findings.append(
                Finding(
                    rule=self.id,
                    path="docs/api.md",
                    line=1,
                    col=0,
                    message=(
                        "no knob table rows found in docs/api.md — did "
                        "the table format change? The drift gate would "
                        "pass vacuously"
                    ),
                )
            )

        # 1. defined but undocumented (anchor: the knob's knobs.py line)
        seen = set()
        for m in _DEFINED_RE.finditer(knobs.source):
            name = m.group(1)
            if name in seen:
                continue
            seen.add(name)
            if name not in docs:
                findings.append(
                    Finding(
                        rule=self.id,
                        path=knobs.display_path,
                        line=knobs.source.count("\n", 0, m.start()) + 1,
                        col=0,
                        message=(
                            f"knob {name} is defined in knobs.py but "
                            "undocumented in docs/api.md"
                        ),
                    )
                )

        # 2. documented but referenced nowhere in the package source
        all_source = "".join(sf.source for sf in ctx.files)
        for m in _DOC_ROW_RE.finditer(docs):
            name = m.group(1)
            if name not in all_source:
                findings.append(
                    Finding(
                        rule=self.id,
                        path="docs/api.md",
                        line=docs.count("\n", 0, m.start()) + 1,
                        col=0,
                        message=(
                            f"knob {name} has an api.md table row but is "
                            "referenced nowhere in the package source"
                        ),
                    )
                )
        return findings
