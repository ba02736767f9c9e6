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
"""

from __future__ import annotations

import math
from typing import Any, List, Optional, Sequence, Tuple

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
        local = full[tuple(slice(o, o + n) for o, n in zip(offsets, sizes))]
        if not views:
            pinned = full.device.type == "cpu" and full.is_pinned()
            local = torch.empty(
                tuple(sizes), dtype=full.dtype, device=full.device, pin_memory=pinned
            ).copy_(local)
    return DTensor.from_local(
        local, tmesh, placements, run_check=False, shape=full.shape, stride=full.stride()
    )
