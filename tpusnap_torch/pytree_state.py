"""PytreeState — any pytree of tensors (nested dicts, lists, tuples,
NamedTuples) as a Stateful.

Counterpart of tpusnap/pytree_state.py over ``torch.utils._pytree``.
``state_dict`` exposes the tree as nested dicts keyed by each leaf's key
path, so every leaf has the logical path tpusnap gives it for the same
tree (``emb/tables/t0``): a dict key becomes ``str(key)``, a sequence
index ``str(idx)``, a NamedTuple field its name. ``load_state_dict``
restores values by the same paths while keeping the original tree
structure, NamedTuples included.

Two differences of torch's pytree from JAX's are bridged so that the
paths agree: torch keeps a dict's insertion order where JAX sorts its
keys (the paths are the same; only the order in which they are listed
differs), and torch makes ``None`` a leaf where JAX makes it an empty
node. A ``None`` therefore gets no entry here, as in tpusnap, and stays
``None`` on load.
"""

from typing import Any, Dict, List, Tuple

import torch.utils._pytree as pytree


def _segments(path: Tuple[Any, ...]) -> List[str]:
    segs: List[str] = []
    for k in path:
        if isinstance(k, pytree.MappingKey):
            segs.append(str(k.key))
        elif isinstance(k, pytree.SequenceKey):
            segs.append(str(k.idx))
        elif isinstance(k, pytree.GetAttrKey):
            segs.append(k.name)
        else:  # other key types: fall back to their str
            segs.append(str(k))
    return segs


class PytreeState:
    def __init__(self, tree: Any) -> None:
        self._tree = tree

    @property
    def tree(self) -> Any:
        return self._tree

    @tree.setter
    def tree(self, new_tree: Any) -> None:
        self._tree = new_tree

    def state_dict(self) -> Dict[str, Any]:
        paths_and_leaves, _ = pytree.tree_flatten_with_path(self._tree)
        paths_and_leaves = [(p, leaf) for p, leaf in paths_and_leaves if leaf is not None]
        if len(paths_and_leaves) == 1 and not paths_and_leaves[0][0]:
            # Bare-leaf tree: store under a sentinel key unlikely to
            # collide with a real pytree dict key.
            return {"__value__": paths_and_leaves[0][1]}
        out: Dict[str, Any] = {}
        for path, leaf in paths_and_leaves:
            segs = _segments(path)
            node = out
            for seg in segs[:-1]:
                node = node.setdefault(seg, {})
                if not isinstance(node, dict):
                    raise ValueError(
                        f"pytree key path collision at {'/'.join(segs)!r}"
                    )
            if segs[-1] in node:
                raise ValueError(
                    f"pytree key paths collide after string conversion: "
                    f"{'/'.join(segs)!r}"
                )
            node[segs[-1]] = leaf
        return out

    def load_state_dict(self, state_dict: Dict[str, Any]) -> None:
        paths_and_leaves, spec = pytree.tree_flatten_with_path(self._tree)

        def lookup(path, leaf):
            if leaf is None:
                return None
            if not path:
                return state_dict["__value__"]
            node: Any = state_dict
            segs = _segments(path)
            for seg in segs:
                if not isinstance(node, dict) or seg not in node:
                    raise KeyError(
                        f"snapshot is missing pytree path {'/'.join(segs)!r}"
                    )
                node = node[seg]
            if isinstance(node, dict):
                # The snapshot's tree is deeper here than the target's:
                # installing a container as a leaf would surface as a
                # confusing failure far from the cause.
                raise ValueError(
                    f"snapshot holds a subtree at {'/'.join(segs)!r} where "
                    "the target pytree has a leaf"
                )
            return node

        leaves = [lookup(path, leaf) for path, leaf in paths_and_leaves]
        self._tree = pytree.tree_unflatten(leaves, spec)
