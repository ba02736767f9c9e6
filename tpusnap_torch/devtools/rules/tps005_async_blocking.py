"""TPS005 — no blocking calls inside the scheduler's ``async def``
bodies. The write/read schedulers run every request on one event loop;
a ``time.sleep`` or synchronous file op inside a coroutine stalls ALL
in-flight I/O for its duration (the budget gate, the probe runner and
the abort watcher all share that loop). Blocking work belongs on the
executor (``run_in_executor`` / the staging executor). Calls inside
nested synchronous ``def``s are fine — those run on worker threads."""

from __future__ import annotations

import ast
from typing import Iterable, List

from ..lint import Finding, LintContext, Rule, SourceFile
from ._common import member_alias_names, module_alias_names

SCOPED_MODULES = {"scheduler.py"}

# module → attribute calls that block the calling thread
_BLOCKING_ATTRS = {
    "time": {"sleep"},
    "os": {"open", "fsync", "fdatasync"},
    "io": {"open"},
}


class AsyncBlockingCallRule(Rule):
    id = "TPS005"
    title = "blocking call in an async def body"

    def check_file(
        self, sf: SourceFile, ctx: LintContext
    ) -> Iterable[Finding]:
        if sf.relpath not in SCOPED_MODULES or sf.tree is None:
            return ()
        tree = sf.tree
        mod_aliases = {
            mod: module_alias_names(tree, mod) for mod in _BLOCKING_ATTRS
        }
        sleep_funcs = member_alias_names(tree, "time", "sleep")

        def blocking_call(node: ast.Call) -> str:
            f = node.func
            if isinstance(f, ast.Name):
                if f.id == "open":
                    return "open()"
                if f.id in sleep_funcs:
                    return "time.sleep()"
                return ""
            if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name):
                for mod, attrs in _BLOCKING_ATTRS.items():
                    if f.attr in attrs and f.value.id in mod_aliases[mod]:
                        return f"{mod}.{f.attr}()"
            return ""

        findings: List[Finding] = []

        def visit(node: ast.AST, fn_name: str) -> None:
            # Nested function definitions get their own scan: sync defs
            # run on worker threads (exempt), nested async defs are
            # found by the outer walk.
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.Call):
                    what = blocking_call(child)
                    if what:
                        findings.append(
                            Finding(
                                rule=self.id,
                                path=sf.display_path,
                                line=child.lineno,
                                col=child.col_offset,
                                message=(
                                    f"blocking {what} inside `async def "
                                    f"{fn_name}` stalls every in-flight "
                                    "request on the scheduler loop — use "
                                    "asyncio.sleep / run_in_executor"
                                ),
                            )
                        )
                visit(child, fn_name)

        for node in ast.walk(tree):
            if isinstance(node, ast.AsyncFunctionDef):
                for stmt in node.body:
                    visit(stmt, node.name)
        return findings
