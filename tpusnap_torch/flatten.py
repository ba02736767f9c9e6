"""Reversible flattening of nested state into ``{logical_path: leaf}``.

Counterpart of tpusnap/flatten.py (copied unchanged), so both packages
derive the same logical paths from the same nesting:
- path components are percent-escaped so ``/`` and ``%`` in keys round-trip;
- dicts with non-str/int keys, or keys that collide after ``str()``
  conversion, are NOT flattened — the whole dict becomes a single leaf;
- ``inflate`` rebuilds the original containers from the container manifest,
  skipping leaf paths absent from ``flattened``.
"""

from collections import OrderedDict
from typing import Any, Dict, List, Tuple, Union
from urllib.parse import quote, unquote

from .manifest import (
    DictEntry,
    Entry,
    ListEntry,
    Manifest,
    OrderedDictEntry,
    TupleEntry,
    is_container_entry,
)

Flattened = Dict[str, Any]


def _encode(key: Union[str, int]) -> str:
    # An empty-string key would produce an empty path component; encode it as
    # a bare "%" (percent-quoting always emits two hex digits after "%", so
    # this cannot collide with any quoted key).
    encoded = quote(str(key), safe="")
    return encoded if encoded else "%"


def _decode(component: str) -> str:
    if component == "%":
        return ""
    return unquote(component)


def _dict_is_flattenable(obj: Dict[Any, Any]) -> bool:
    keys = list(obj.keys())
    if not all(isinstance(k, (str, int)) and not isinstance(k, bool) for k in keys):
        return False
    # Refuse if two keys collide after str() conversion (e.g. 1 vs "1").
    return len({str(k) for k in keys}) == len(keys)


def _join(prefix: str, component: str) -> str:
    return f"{prefix}/{component}" if prefix else component


def flatten(obj: Any, prefix: str = "") -> Tuple[Manifest, Flattened]:
    """Flatten nested containers into (container manifest, {path: leaf})."""
    manifest: Manifest = {}
    flattened: Flattened = {}
    _flatten(obj, prefix, manifest, flattened)
    return manifest, flattened


def _flatten(obj: Any, path: str, manifest: Manifest, flattened: Flattened) -> None:
    if isinstance(obj, OrderedDict) and _dict_is_flattenable(obj):
        manifest[path] = OrderedDictEntry(keys=list(obj.keys()))
        for key, val in obj.items():
            _flatten(val, _join(path, _encode(key)), manifest, flattened)
    elif isinstance(obj, dict) and _dict_is_flattenable(obj):
        manifest[path] = DictEntry(keys=list(obj.keys()))
        for key, val in obj.items():
            _flatten(val, _join(path, _encode(key)), manifest, flattened)
    elif isinstance(obj, list):
        manifest[path] = ListEntry()
        for idx, val in enumerate(obj):
            _flatten(val, _join(path, str(idx)), manifest, flattened)
    elif isinstance(obj, tuple):
        # Covers NamedTuples too; they inflate to plain tuples — callers that
        # need the exact pytree structure (PytreeState) re-apply the treedef.
        manifest[path] = TupleEntry()
        for idx, val in enumerate(obj):
            _flatten(val, _join(path, str(idx)), manifest, flattened)
    else:
        flattened[path] = obj


_MISSING = object()


def inflate(manifest: Manifest, flattened: Flattened, prefix: str = "") -> Any:
    """Rebuild the nested object flattened under ``prefix``.

    Leaf paths present in ``manifest``'s container skeleton but absent from
    ``flattened`` are dropped (reference flatten.py:176-199 semantics) —
    dict entries lose the key, list/tuple entries compact.
    """
    entries: Dict[str, Entry] = {}
    for path, entry in manifest.items():
        rel = _strip_prefix(path, prefix)
        if rel is not None:
            entries[rel] = entry
    leaves: Dict[str, Any] = {}
    for path, value in flattened.items():
        rel = _strip_prefix(path, prefix)
        if rel is not None:
            leaves[rel] = value

    if "" not in entries:
        # The root itself is a leaf (not a container).
        if "" in leaves:
            return leaves[""]
        raise ValueError(f"No root found under prefix {prefix!r}")

    children: Dict[str, List[str]] = {}
    for rel in list(entries.keys()) + list(leaves.keys()):
        if rel == "":
            continue
        parent = rel.rsplit("/", 1)[0] if "/" in rel else ""
        children.setdefault(parent, []).append(rel)

    def build(rel: str) -> Any:
        if rel not in entries:
            return leaves.get(rel, _MISSING)
        entry = entries[rel]
        if not is_container_entry(entry):
            raise ValueError(f"Non-container entry in container manifest at {rel!r}")
        kids = children.get(rel, [])
        components = {k: (k.rsplit("/", 1)[-1] if "/" in k else k) for k in kids}
        if isinstance(entry, (ListEntry, TupleEntry)):
            built = [
                build(k) for k in sorted(kids, key=lambda k: int(components[k]))
            ]
            built = [v for v in built if v is not _MISSING]
            return tuple(built) if isinstance(entry, TupleEntry) else built
        # dict/OrderedDict: original key list preserves both order and the
        # str-vs-int type of each key.
        key_by_str = {str(orig): orig for orig in entry.keys}
        order = {str(orig): i for i, orig in enumerate(entry.keys)}
        out = OrderedDict() if isinstance(entry, OrderedDictEntry) else {}
        for k in sorted(
            kids, key=lambda k: order.get(_decode(components[k]), len(order))
        ):
            decoded = _decode(components[k])
            if decoded not in key_by_str:
                # The container entry is the source of truth for membership
                # (reference flatten.py:176-199); stray leaves are dropped.
                continue
            value = build(k)
            if value is _MISSING:
                continue
            out[key_by_str[decoded]] = value
        return out

    return build("")


def _strip_prefix(path: str, prefix: str) -> Union[str, None]:
    if prefix == "":
        return path
    if path == prefix:
        return ""
    if path.startswith(prefix + "/"):
        return path[len(prefix) + 1 :]
    return None
