"""TPS006 — no thread joins reachable from a GC-finalizer path without
the :func:`tpusnap_torch.io_types.finalizer_close_scope` guard.

The finalizer-join deadlock class: GC can run ``__del__`` from inside a STARTING
thread's ``Thread._set_tstate_lock`` (which holds
``threading._shutdown_locks_lock``); a join on that path re-acquires
the same lock and the process hangs forever. The fix is a policy, and
policies drift — so this rule pins it:

- inside ``__del__``, any call that could transitively join (``join``,
  ``shutdown``, ``stop``, anything close-shaped) must sit under
  ``with finalizer_close_scope():``;
- inside plugin ``close()``/``sync_close()`` methods — the canonical
  finalizer-reachable path — executor ``.shutdown(...)`` and thread
  ``.join(...)`` must go through
  :func:`tpusnap_torch.io_types.shutdown_plugin_executor` (or gate on
  ``close_may_join()``), the ONE place the join-on-close policy lives.
"""

from __future__ import annotations

import ast
from typing import Iterable, List

from ..lint import Finding, LintContext, Rule, SourceFile
from ._common import call_name

# Calls that are safe anywhere: the guard machinery itself.
_GUARD_CALLS = {
    "finalizer_close_scope",
    "close_may_join",
    "shutdown_plugin_executor",
}

_CLOSE_METHODS = {"close", "sync_close", "aclose"}


def _is_scope_with(node: ast.With) -> bool:
    return any(
        isinstance(item.context_expr, ast.Call)
        and call_name(item.context_expr) == "finalizer_close_scope"
        for item in node.items
    )


def _dangerous_in_del(name: str) -> bool:
    # Exact close-shaped names, not a substring net: `is_closed()` /
    # `on_closed()` / `disclose()` in a __del__ are innocuous and a
    # false positive here teaches maintainers to waive reflexively.
    return name in ("join", "shutdown", "stop") or (
        name not in _GUARD_CALLS
        and (name == "close" or name.endswith("_close"))
    )


def _thread_join_like(node: ast.Call) -> bool:
    """Filter the string/path ``join``s out: only attribute joins on
    something that could plausibly be a thread/executor count."""
    f = node.func
    if not isinstance(f, ast.Attribute) or f.attr != "join":
        return True  # not a join at all — caller decides on other names
    v = f.value
    if isinstance(v, ast.Constant) and isinstance(v.value, str):
        return False  # ", ".join(...)
    if isinstance(v, ast.Attribute) and v.attr == "path":
        return False  # os.path.join(...)
    if isinstance(v, ast.Name) and v.id in {"os", "posixpath", "ntpath"}:
        return False
    return True


class FinalizerJoinRule(Rule):
    id = "TPS006"
    title = "thread join reachable from a finalizer path"

    def check_file(
        self, sf: SourceFile, ctx: LintContext
    ) -> Iterable[Finding]:
        if sf.tree is None:
            return ()
        findings: List[Finding] = []
        for node in ast.walk(sf.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if node.name == "__del__":
                    self._scan_del(node, sf, findings)
                elif node.name in _CLOSE_METHODS:
                    self._scan_close(node, sf, findings)
        return findings

    # --- __del__ ------------------------------------------------------

    def _scan_del(self, fn, sf: SourceFile, findings: List[Finding]) -> None:
        def visit(node: ast.AST, protected: bool) -> None:
            if isinstance(node, ast.With):
                inner = protected or _is_scope_with(node)
                for item in node.items:
                    visit(item, protected)
                for stmt in node.body:
                    visit(stmt, inner)
                return
            if isinstance(node, ast.Call) and not protected:
                name = call_name(node) or ""
                if _dangerous_in_del(name) and _thread_join_like(node):
                    findings.append(
                        Finding(
                            rule=self.id,
                            path=sf.display_path,
                            line=node.lineno,
                            col=node.col_offset,
                            message=(
                                f"`{name}()` in __del__ outside `with "
                                "finalizer_close_scope():` — a join "
                                "reachable from GC self-deadlocks on "
                                "threading._shutdown_locks_lock; wrap "
                                "the close in the scope"
                            ),
                        )
                    )
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    continue
                visit(child, protected)

        for stmt in fn.body:
            visit(stmt, False)

    # --- close() ------------------------------------------------------

    def _scan_close(self, fn, sf: SourceFile, findings: List[Finding]) -> None:
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if not isinstance(f, ast.Attribute):
                continue
            if f.attr == "shutdown":
                wait = next(
                    (kw.value for kw in node.keywords if kw.arg == "wait"),
                    None,
                )
                # shutdown(wait=False) never joins; shutdown(
                # wait=close_may_join()) is the policy helper inlined.
                if isinstance(wait, ast.Constant) and wait.value is False:
                    continue
                if (
                    isinstance(wait, ast.Call)
                    and call_name(wait) == "close_may_join"
                ):
                    continue
                findings.append(
                    Finding(
                        rule=self.id,
                        path=sf.display_path,
                        line=node.lineno,
                        col=node.col_offset,
                        message=(
                            "executor .shutdown() with a join inside "
                            f"{fn.name}() — close() is finalizer-"
                            "reachable; route through io_types."
                            "shutdown_plugin_executor (the one join-on-"
                            "close policy)"
                        ),
                    )
                )
            elif f.attr == "join" and _thread_join_like(node):
                findings.append(
                    Finding(
                        rule=self.id,
                        path=sf.display_path,
                        line=node.lineno,
                        col=node.col_offset,
                        message=(
                            f"thread .join() inside {fn.name}() — "
                            "close() is finalizer-reachable; gate on "
                            "io_types.close_may_join() or move the "
                            "join off the close path"
                        ),
                    )
                )
