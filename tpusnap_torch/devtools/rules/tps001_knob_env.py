"""TPS001 — every ``TPUSNAP_*`` env var is a knob, and knobs are read
through :mod:`tpusnap_torch.knobs` only. A raw ``os.environ``/``os.getenv``
access elsewhere bypasses the knob registry: no docstring, no default
in one place, invisible to the knob/doc drift gate (TPS007), and no
context-manager override for tests."""

from __future__ import annotations

import ast
from typing import Iterable, List

from ..lint import Finding, LintContext, Rule, SourceFile
from ._common import const_str, member_alias_names, module_alias_names

_EXEMPT_FILES = {"knobs.py"}
_ENV_METHODS = {"get", "setdefault", "pop"}


class KnobEnvAccessRule(Rule):
    id = "TPS001"
    title = "TPUSNAP_* env access outside knobs.py"

    def check_file(
        self, sf: SourceFile, ctx: LintContext
    ) -> Iterable[Finding]:
        if sf.relpath in _EXEMPT_FILES or sf.tree is None:
            return ()
        tree = sf.tree
        os_names = module_alias_names(tree, "os")
        environ_names = member_alias_names(tree, "os", "environ")
        getenv_names = member_alias_names(tree, "os", "getenv")

        def is_environ(node: ast.AST) -> bool:
            if isinstance(node, ast.Name):
                return node.id in environ_names
            return (
                isinstance(node, ast.Attribute)
                and node.attr == "environ"
                and isinstance(node.value, ast.Name)
                and node.value.id in os_names
            )

        def is_getenv(node: ast.AST) -> bool:
            if isinstance(node, ast.Name):
                return node.id in getenv_names
            return (
                isinstance(node, ast.Attribute)
                and node.attr == "getenv"
                and isinstance(node.value, ast.Name)
                and node.value.id in os_names
            )

        def tpusnap_key(node: ast.AST) -> bool:
            s = const_str(node)
            return s is not None and s.startswith("TPUSNAP_")

        findings: List[Finding] = []

        def flag(node: ast.AST, key: str) -> None:
            findings.append(
                Finding(
                    rule=self.id,
                    path=sf.display_path,
                    line=node.lineno,
                    col=node.col_offset,
                    message=(
                        f"raw environment access of {key!r} — route it "
                        "through a tpusnap_torch.knobs getter (registered, "
                        "documented, override-able)"
                    ),
                )
            )

        for node in ast.walk(tree):
            if isinstance(node, ast.Call):
                f = node.func
                if (
                    isinstance(f, ast.Attribute)
                    and f.attr in _ENV_METHODS
                    and is_environ(f.value)
                    and node.args
                    and tpusnap_key(node.args[0])
                ):
                    flag(node, const_str(node.args[0]))
                elif is_getenv(f) and node.args and tpusnap_key(node.args[0]):
                    flag(node, const_str(node.args[0]))
            elif isinstance(node, ast.Subscript):
                if is_environ(node.value) and tpusnap_key(node.slice):
                    flag(node, const_str(node.slice))
            elif isinstance(node, ast.Compare):
                if (
                    tpusnap_key(node.left)
                    and any(isinstance(op, (ast.In, ast.NotIn)) for op in node.ops)
                    and any(is_environ(c) for c in node.comparators)
                ):
                    flag(node, const_str(node.left))
        return findings
