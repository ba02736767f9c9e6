"""Layouts of the model families over a ``("data", "fsdp", "tensor")``
``DeviceMesh``.

tpusnap writes each parameter's layout as a ``PartitionSpec``: one entry
per tensor dim, naming the mesh axis (or axes, major to minor) that
shards it, or ``None``. The models here keep those specs as tuples
(``param_specs()``) and turn them into DTensor placements:

- a mesh axis named at tensor dim ``d`` gives ``Shard(d)`` on that mesh
  dim, an axis not named gives ``Replicate()``;
- a tuple entry (``("fsdp", "tensor")``) gives ``Shard(d)`` on each of
  its mesh dims. DTensor nests several ``Shard(d)`` of one tensor dim in
  mesh-dim order, which is JAX's major-to-minor order only when the
  tuple lists its axes in mesh order, so another order is refused.

With these placements, ``io_preparers.sharded.local_box`` gives each rank
the box of every leaf that tpusnap's ``NamedSharding`` gives the device
at the same mesh coordinate.

``shard_tree`` exposes a tree of whole tensors, which every rank holds
(replica training), as DTensors: ``views=True`` makes each local tensor a
view of this rank's box of the rank's own tensor, so a restore lands in
the model; ``views=False`` gives each rank a contiguous copy of its box,
the state a rank of a sharded job owns. No collective runs.

The collectives of the sharded train step (``models/transformer.py``) run
over gloo and stage CUDA tensors through pinned host buffers, so ranks
that share one card can run them (gloo takes no CUDA tensors in its
point-to-point calls, and NCCL needs one card per rank). A collective that
fails raises; nothing falls back to computing on the CPU.

- ``mesh_groups(mesh, axes)``: the gloo group of this rank's ranks that
  differ only in their coordinates on ``axes`` (one mesh axis, a
  sub-group; several, their product; all three, the whole mesh).
- ``gather_full(tree, group)``: every leaf's full value from the DTensor
  boxes of the mesh's ranks, one ``all_gather`` of the owners' bytes.
- ``sum_across(tensors, group)``: the tensors, in place, summed over the
  ranks of ``group`` (one ``all_reduce``).
- ``local_slice(full, like)``: this rank's box of a full tensor, at the
  placements of the DTensor ``like``.
"""

from __future__ import annotations

import itertools
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

MESH_AXES = ("data", "fsdp", "tensor")


def default_mesh_shape(n: int) -> Tuple[int, int, int]:
    """tpusnap's split of ``n`` devices into (data, fsdp, tensor):
    fsdp x tensor of 2 x 2 when 4 divides ``n``, else 1 x 2 when 2 does."""
    if n % 4 == 0:
        return (n // 4, 2, 2)
    if n % 2 == 0:
        return (n // 2, 1, 2)
    return (n, 1, 1)


def make_mesh(device_type: str = "cuda", mesh_shape: Optional[Sequence[int]] = None):
    """A ``("data", "fsdp", "tensor")`` ``DeviceMesh`` over the ranks of
    this process's default group, in rank order (every rank must call
    it). ``mesh_shape`` defaults to tpusnap's split of the world size."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    n = dist.get_world_size()
    shape = tuple(mesh_shape) if mesh_shape is not None else default_mesh_shape(n)
    if len(shape) != 3 or math.prod(shape) != n:
        raise ValueError(f"mesh_shape {shape} does not hold {n} ranks in 3 dims")
    return DeviceMesh(device_type, torch.arange(n).reshape(shape), mesh_dim_names=MESH_AXES)


def spec_placements(spec: Sequence[Any], mesh_axes: Sequence[str] = MESH_AXES) -> List[Any]:
    """DTensor placements, one per mesh dim, of a tpusnap spec."""
    from torch.distributed.tensor import Replicate, Shard

    placements: List[Any] = [Replicate() for _ in mesh_axes]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        mesh_dims = [list(mesh_axes).index(a) for a in axes]
        if mesh_dims != sorted(mesh_dims):
            raise NotImplementedError(
                f"spec entry {entry!r}: axes sharding one dim out of mesh "
                "order have no DTensor placement"
            )
        for m in mesh_dims:
            if not placements[m].is_replicate():
                raise ValueError(f"spec {tuple(spec)!r} names mesh axis {mesh_axes[m]!r} twice")
            placements[m] = Shard(d)
    return placements


def map_specs(fn, specs: Any) -> Any:
    """``fn`` over every spec (a tuple) of a nested dict of specs."""
    if isinstance(specs, dict):
        return {k: map_specs(fn, v) for k, v in specs.items()}
    return fn(specs)


def shard_tree(
    tree: Any, placements: Any, mesh, views: bool = True, host_mesh=None
) -> Any:
    """``tree`` (a nested dict of whole tensors) as DTensors over ``mesh``
    with the placements of the same nesting; see the module docstring.
    CPU tensors (host-offloaded tables) go over ``host_mesh``, a ``"cpu"``
    mesh of the same ranks and shape, when it is given."""
    from torch.distributed.tensor import DTensor

    from ..io_preparers.sharded import local_box

    if isinstance(tree, dict):
        return {k: shard_tree(tree[k], placements[k], mesh, views, host_mesh) for k in tree}
    full = tree.detach()
    tmesh = host_mesh if host_mesh is not None and full.device.type == "cpu" else mesh
    coordinate = tmesh.get_coordinate()
    if coordinate is None:
        local = full.new_empty((0,) * full.dim())
    else:
        offsets, sizes = local_box(list(full.shape), list(tmesh.shape), coordinate, placements)
        local = full[_box(offsets, sizes)]
        if not views:
            pinned = full.device.type == "cpu" and full.is_pinned()
            local = torch.empty(
                tuple(sizes), dtype=full.dtype, device=full.device, pin_memory=pinned
            ).copy_(local)
    return DTensor.from_local(
        local, tmesh, placements, run_check=False, shape=full.shape, stride=full.stride()
    )


# (the mesh's ranks, its shape, axes) -> this rank's group. ``new_group`` is
# collective and every group keeps its own connections, so the groups of a
# layout are made once per process, however many steps use them.
_GROUPS: Dict[Tuple[Any, ...], Any] = {}


def mesh_groups(mesh, axes: Sequence[str]):
    """The gloo group of the ranks that share this rank's coordinates on
    every mesh axis but ``axes``, in coordinate order. The first call for
    a layout calls ``new_group`` for every such group of the mesh, so
    every rank of the world must make the same calls in the same order."""
    import torch.distributed as dist

    names = list(mesh.mesh_dim_names)
    key = (tuple(mesh.mesh.reshape(-1).tolist()), tuple(mesh.mesh.shape), tuple(names), tuple(axes))
    if key not in _GROUPS:
        dims = [names.index(a) for a in axes]
        others = [d for d in range(len(names)) if d not in dims]
        size = math.prod(mesh.mesh.shape[d] for d in dims)
        me = dist.get_rank()
        for line in mesh.mesh.permute(*others, *dims).reshape(-1, size).tolist():
            group = dist.new_group(line, backend="gloo")
            if me in line:
                _GROUPS[key] = group
    return _GROUPS[key]


def _coordinates(mesh) -> Dict[int, List[int]]:
    """Global rank -> its coordinate on ``mesh``."""
    ranks = mesh.mesh
    return {int(ranks[idx]): list(idx) for idx in itertools.product(*map(range, ranks.shape))}


def _leaves(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        return [leaf for k in tree for leaf in _leaves(tree[k], f"{prefix}/{k}" if prefix else k)]
    return [(prefix, tree)]


def _unflatten(tree: Any, values: Dict[str, Any], prefix: str = "") -> Any:
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], values, f"{prefix}/{k}" if prefix else k) for k in tree}
    return values[prefix]


def _box(offsets: Sequence[int], sizes: Sequence[int]) -> Tuple[slice, ...]:
    """The index of a box of a full tensor."""
    return tuple(slice(o, o + n) for o, n in zip(offsets, sizes))


def _owns(coordinate: Sequence[int], placements: Sequence[Any]) -> bool:
    """Whether the rank at ``coordinate`` is its box's owner: coordinate 0
    on every ``Replicate`` mesh dim (the rank a take has write it)."""
    return all(c == 0 for c, p in zip(coordinate, placements) if p.is_replicate())


def _aligned(nbytes: int) -> int:
    """``nbytes`` rounded up to 16: every box starts aligned for its dtype."""
    return -(-nbytes // 16) * 16


def _host_buffer(numel: int, dtype: torch.dtype, like: torch.Tensor) -> torch.Tensor:
    return torch.empty(numel, dtype=dtype, pin_memory=like.is_cuda)


def gather_full(tree: Any, group) -> Any:
    """The full value of every DTensor leaf of ``tree`` (a nested dict),
    on the leaf's device: each box's owner contributes its local bytes to
    one ``all_gather`` over ``group`` (every rank of the leaves' mesh),
    through host memory; each rank assembles the full tensors from the
    owners' boxes. Every rank of ``group`` must call it."""
    import torch.distributed as dist

    from ..io_preparers.sharded import local_box

    leaves = _leaves(tree)
    if not leaves:
        return tree
    mesh = leaves[0][1].device_mesh
    coords = _coordinates(mesh)
    me = dist.get_rank()
    n = dist.get_world_size(group)
    members = [dist.get_global_rank(group, i) for i in range(n)]
    if sorted(members) != sorted(coords):
        raise ValueError(f"group ranks {members} are not the mesh's {sorted(coords)}")

    def boxes_of(rank):
        """[(path, offsets, sizes)] of the boxes ``rank`` owns, and their bytes."""
        out, nbytes = [], 0
        for path, t in leaves:
            if _owns(coords[rank], t.placements):
                offsets, sizes = local_box(list(t.shape), list(mesh.shape), coords[rank], t.placements)
                out.append((path, offsets, sizes))
                nbytes += _aligned(math.prod(sizes) * t.element_size())
        return out, nbytes

    plan = {rank: boxes_of(rank) for rank in members}
    width = max(nbytes for _, nbytes in plan.values())
    like = leaves[0][1].to_local()
    send = _host_buffer(width, torch.uint8, like)
    at = 0
    by_path = dict(leaves)
    for path, _, _ in plan[me][0]:
        local = by_path[path].to_local()
        nbytes = local.numel() * local.element_size()
        send[at:at + nbytes].copy_(local.contiguous().view(-1).view(torch.uint8))
        at += _aligned(nbytes)
    recv = [_host_buffer(width, torch.uint8, like) for _ in members]
    dist.all_gather(recv, send, group=group)
    full = {path: torch.empty(tuple(t.shape), dtype=t.dtype, pin_memory=like.is_cuda)
            for path, t in leaves}
    for rank, buf in zip(members, recv):
        at = 0
        for path, offsets, sizes in plan[rank][0]:
            dst = full[path]
            nbytes = math.prod(sizes) * dst.element_size()
            box = buf[at:at + nbytes].view(dst.dtype).view(tuple(sizes))
            dst[_box(offsets, sizes)].copy_(box)
            at += _aligned(nbytes)
    values = {path: full[path].to(by_path[path].to_local().device) for path, _ in leaves}
    return _unflatten(tree, values)


def sum_across(tensors: Sequence[torch.Tensor], group) -> None:
    """Replace each tensor, in place, by its sum over the ranks of
    ``group``: the tensors (one dtype) packed into one host buffer and one
    ``all_reduce``. Every rank of ``group`` must call it with tensors of
    the same shapes. A group of one changes nothing."""
    import torch.distributed as dist

    if dist.get_world_size(group) == 1 or not tensors:
        return
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1:
        raise ValueError(f"sum_across takes tensors of one dtype, got {sorted(map(str, dtypes))}")
    flat = torch.cat([t.reshape(-1) for t in tensors])
    host = _host_buffer(flat.numel(), flat.dtype, flat)
    host.copy_(flat)
    dist.all_reduce(host, group=group)
    flat.copy_(host)
    at = 0
    for t in tensors:
        t.copy_(flat[at:at + t.numel()].view(t.shape))
        at += t.numel()


def local_slice(full: torch.Tensor, like) -> torch.Tensor:
    """The view of ``full`` at this rank's box of the DTensor ``like``
    (the same global shape)."""
    from ..io_preparers.sharded import local_box

    mesh = like.device_mesh
    if tuple(full.shape) != tuple(like.shape):
        raise ValueError(f"full shape {tuple(full.shape)} is not the DTensor's {tuple(like.shape)}")
    offsets, sizes = local_box(list(full.shape), list(mesh.shape), mesh.get_coordinate(), like.placements)
    return full[_box(offsets, sizes)]
