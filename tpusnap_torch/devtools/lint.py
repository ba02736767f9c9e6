"""AST invariant checker for the tpusnap_torch source tree (vendored from
tpusnap/devtools/lint.py, retargeted at the port's layout).

The project's correctness story rests on cross-cutting invariants no
single test enumerates — knob reads only through ``knobs.py``,
monotonic-only clocks in the observability modules, one canonical
definition of the ``.tpusnap`` sidecar namespace, no silent exception
swallows in crash-safety modules, no blocking calls in the scheduler's
async bodies, no thread joins reachable from GC finalizers. Each is a
:class:`Rule` with a stable ``TPSnnn`` id; the engine walks every
``*.py`` file of the package with :mod:`ast` (the tree is PARSED, never
imported — it can lint a seeded temp copy), applies every selected
rule, and subtracts per-line waivers.

Waivers::

    x = os.environ["TPUSNAP_TEST_RANK"]  # tpusnap: waive=TPS001 why

A waive comment suppresses the named rule(s) (comma-separated) on its
own line; a waive inside a pure-comment line applies to the next code
line below it (for block comments above the waived statement). The
reason text is free-form but expected — a waiver is documentation of a
deliberate exception, not an off switch.

CLI: ``python -m tpusnap_torch lint [--json] [--check] [--root DIR]
[--select RULES]`` — ``--check`` exits 2 on any unwaived finding, 0 on
a clean tree; the test suite runs it over the whole package
(tests/test_torch_lint.py).
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
import re
import sys
from typing import Dict, Iterable, List, Optional, Sequence, Set

_WAIVE_RE = re.compile(r"#\s*tpusnap:\s*waive=([A-Z0-9_,]+)")


@dataclasses.dataclass
class Finding:
    """One rule violation, anchored to a file:line."""

    rule: str
    path: str  # display path, relative to the package root's parent
    line: int
    col: int
    message: str

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    def location(self) -> str:
        return f"{self.path}:{self.line}"


@dataclasses.dataclass
class SourceFile:
    """A parsed package source file plus its waiver map."""

    relpath: str  # relative to the package root, e.g. "telemetry.py"
    display_path: str  # e.g. "tpusnap_torch/telemetry.py"
    source: str
    tree: Optional[ast.AST]
    parse_error: Optional[str]
    waivers: Dict[int, Set[str]]  # line -> waived rule ids


@dataclasses.dataclass
class LintContext:
    """Everything a rule may inspect: the parsed package files plus the
    repo root (for project rules that cross-check docs)."""

    package_root: str
    repo_root: str
    files: List[SourceFile]

    def file(self, relpath: str) -> Optional[SourceFile]:
        for f in self.files:
            if f.relpath == relpath:
                return f
        return None


class Rule:
    """One invariant. Subclasses set ``id``/``title`` and implement
    ``check_file`` (per-file AST walk) and/or ``check_project``
    (repo-level cross-checks, e.g. knob/doc drift)."""

    id: str = "TPS000"
    title: str = ""

    def check_file(
        self, sf: SourceFile, ctx: LintContext
    ) -> Iterable[Finding]:
        return ()

    def check_project(self, ctx: LintContext) -> Iterable[Finding]:
        return ()


@dataclasses.dataclass
class LintResult:
    findings: List[Finding]
    waived: List[Finding]
    files_scanned: int
    rules_run: List[str]

    @property
    def clean(self) -> bool:
        return not self.findings

    def as_dict(self) -> dict:
        return {
            "clean": self.clean,
            "files_scanned": self.files_scanned,
            "rules_run": self.rules_run,
            "findings": [f.as_dict() for f in self.findings],
            "waived": [f.as_dict() for f in self.waived],
        }


def parse_waivers(source: str) -> Dict[int, Set[str]]:
    """Line → waived rule ids. A waive comment on a code line covers
    that line; a waive in a comment block covers the code line DIRECTLY
    below the block (so the explanation sits above the statement it
    waives). A blank line clears a pending comment waiver — a stale
    waive comment stranded by a refactor must not silently suppress a
    finding on unrelated code further down."""
    waivers: Dict[int, Set[str]] = {}
    pending: Set[str] = set()
    for lineno, line in enumerate(source.splitlines(), 1):
        stripped = line.strip()
        m = _WAIVE_RE.search(line)
        rules = (
            {r for r in m.group(1).split(",") if r} if m is not None else set()
        )
        if stripped.startswith("#"):
            pending |= rules
            continue
        if not stripped:
            pending = set()
            continue
        if rules or pending:
            waivers.setdefault(lineno, set()).update(rules | pending)
        pending = set()
    return waivers


def _collect_files(package_root: str) -> List[SourceFile]:
    package_root = os.path.abspath(package_root)
    pkg_name = os.path.basename(package_root.rstrip(os.sep))
    out: List[SourceFile] = []
    for dirpath, dirnames, filenames in os.walk(package_root):
        dirnames[:] = sorted(
            d for d in dirnames if d != "__pycache__" and not d.startswith(".")
        )
        for fn in sorted(filenames):
            if not fn.endswith(".py"):
                continue
            abspath = os.path.join(dirpath, fn)
            relpath = os.path.relpath(abspath, package_root).replace(
                os.sep, "/"
            )
            with open(abspath, "r", encoding="utf-8") as f:
                source = f.read()
            tree: Optional[ast.AST] = None
            err: Optional[str] = None
            try:
                tree = ast.parse(source, filename=abspath)
            except SyntaxError as e:
                err = f"{e.msg} (line {e.lineno})"
            out.append(
                SourceFile(
                    relpath=relpath,
                    display_path=f"{pkg_name}/{relpath}",
                    source=source,
                    tree=tree,
                    parse_error=err,
                    waivers=parse_waivers(source),
                )
            )
    return out


def all_rules() -> List[Rule]:
    from .rules import ALL_RULES

    return [cls() for cls in ALL_RULES]


def default_package_root() -> str:
    """The tpusnap_torch package directory (what the zero-findings gate
    lints), found from this file: the engine never imports the tree."""
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_lint(
    package_root: Optional[str] = None,
    select: Optional[Sequence[str]] = None,
) -> LintResult:
    """Lint every ``*.py`` under ``package_root`` (default: the
    tpusnap_torch package) with the selected rules (default: all).
    Unparseable files surface as ``PARSE`` findings — a tree the linter
    cannot read must not pass as clean."""
    root = os.path.abspath(package_root or default_package_root())
    if not os.path.isdir(root):
        raise RuntimeError(f"lint root is not a directory: {root!r}")
    ctx = LintContext(
        package_root=root,
        repo_root=os.path.dirname(root),
        files=_collect_files(root),
    )
    rules = all_rules()
    if select is not None:
        wanted: Set[str] = set()
        for item in select:
            for tok in item.split(","):
                tok = tok.strip().upper()
                if tok:
                    wanted.add(tok)
        unknown = wanted - {r.id for r in rules}
        if unknown:
            raise RuntimeError(
                f"unknown lint rule(s): {sorted(unknown)} "
                f"(known: {sorted(r.id for r in rules)})"
            )
        rules = [r for r in rules if r.id in wanted]

    raw: List[Finding] = []
    for sf in ctx.files:
        if sf.parse_error is not None:
            raw.append(
                Finding(
                    rule="PARSE",
                    path=sf.display_path,
                    line=1,
                    col=0,
                    message=f"file does not parse: {sf.parse_error}",
                )
            )
            continue
        for rule in rules:
            raw.extend(rule.check_file(sf, ctx))
    for rule in rules:
        raw.extend(rule.check_project(ctx))

    findings: List[Finding] = []
    waived: List[Finding] = []
    waiver_index = {sf.display_path: sf.waivers for sf in ctx.files}
    for f in sorted(raw, key=lambda f: (f.path, f.line, f.rule)):
        if f.rule in waiver_index.get(f.path, {}).get(f.line, ()):
            waived.append(f)
        else:
            findings.append(f)
    return LintResult(
        findings=findings,
        waived=waived,
        files_scanned=len(ctx.files),
        rules_run=[r.id for r in rules],
    )


# ----------------------------------------------------------------- rendering


def render_table(result: LintResult) -> str:
    lines: List[str] = []
    if result.findings:
        width = max(len(f.location()) for f in result.findings)
        for f in result.findings:
            lines.append(
                f"{f.rule:<7} {f.location():<{width}}  {f.message}"
            )
    lines.append(
        f"lint: {len(result.findings)} finding(s), "
        f"{len(result.waived)} waived, {result.files_scanned} files, "
        f"rules {','.join(result.rules_run)}"
    )
    return "\n".join(lines)


def main(args) -> int:
    """``python -m tpusnap_torch lint`` entry point (argparse namespace with
    ``root``/``select``/``json``/``check``)."""
    try:
        result = run_lint(
            package_root=args.root,
            select=[args.select] if args.select else None,
        )
    except RuntimeError as e:
        # stderr, not stdout: --json consumers parse stdout.
        print(f"error: {e}", file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps(result.as_dict(), indent=2))
    else:
        print(render_table(result))
    if args.check:
        return 2 if result.findings else 0
    return 0
