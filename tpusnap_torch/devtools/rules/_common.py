"""Shared AST helpers for the lint rules: import-alias resolution (so
``import os as o`` / ``from time import time as now`` cannot dodge a
rule that greps would miss) and docstring detection."""

from __future__ import annotations

import ast
from typing import Dict, Optional, Set, Tuple


def import_aliases(tree: ast.AST) -> Tuple[Dict[str, str], Dict[str, Tuple[str, str]]]:
    """(module_aliases, from_imports): ``import os as o`` →
    ``{"o": "os"}``; ``from os import environ as e`` →
    ``{"e": ("os", "environ")}``. Walks the whole tree so function-local
    imports count too."""
    modules: Dict[str, str] = {}
    members: Dict[str, Tuple[str, str]] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                modules[a.asname or a.name.split(".")[0]] = a.name
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            for a in node.names:
                members[a.asname or a.name] = (node.module, a.name)
    return modules, members


def module_alias_names(tree: ast.AST, module: str) -> Set[str]:
    """Local names bound to ``import <module>`` (including aliases)."""
    modules, _ = import_aliases(tree)
    return {name for name, mod in modules.items() if mod == module}


def member_alias_names(tree: ast.AST, module: str, attr: str) -> Set[str]:
    """Local names bound to ``from <module> import <attr>`` aliases."""
    _, members = import_aliases(tree)
    return {
        name for name, (mod, a) in members.items() if mod == module and a == attr
    }


def const_str(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def statement_string_ids(tree: ast.AST) -> Set[int]:
    """``id()`` of every string Constant that is a bare statement
    expression — docstrings and no-op strings, which carry no behavior
    and are exempt from string-literal rules."""
    out: Set[int] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Expr) and isinstance(node.value, ast.Constant):
            if isinstance(node.value.value, str):
                out.add(id(node.value))
    return out


def call_name(node: ast.Call) -> Optional[str]:
    """The trailing name of a call — ``foo()`` → "foo",
    ``a.b.foo()`` → "foo"."""
    f = node.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return None
