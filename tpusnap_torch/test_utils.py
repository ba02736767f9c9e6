"""Run a function in N processes that form one ``torch.distributed`` world.

Counterpart of tpusnap/test_utils.py's ``run_subprocess_world``, for the
port (it imports neither JAX nor the JAX package):

    from tpusnap_torch.test_utils import run_subprocess_world
    outputs = run_subprocess_world(my_fn, world_size=2, args=["/tmp/snap"])

``my_fn`` is a module-level function; each rank's process imports its
module, calls ``torch.distributed.init_process_group("gloo")`` with
``MASTER_ADDR``, ``MASTER_PORT``, ``RANK`` and ``WORLD_SIZE`` set, and
then ``my_fn(*args)``. The call returns each rank's output (stdout and
stderr) and raises with every rank's log if any rank fails or the world
outlives ``timeout``. Once one rank has failed, the others get
``grace`` seconds to finish before they are killed, so a rank blocked in
a barrier its peer will never reach does not hold the caller for the
whole timeout. Every process started is ended before the call returns.

``init_process_group=False`` skips the process group: the processes
share only the TCPStore on ``MASTER_PORT`` (rank 0 hosts it), which
``store_from_env()`` connects to — enough for the port's store-based
collectives at large world sizes.

``world_mesh`` builds a ``DeviceMesh`` over such a world,
``host_mesh_like`` a ``"cpu"`` mesh of the same ranks beside a ``"cuda"``
one (for host-offloaded state), and ``as_dtensor`` exposes a tensor every rank holds whole as a DTensor whose
local tensor is a view of this rank's box of it, with no collective.

The entry point of each child is ``python -m tpusnap_torch.test_utils``.
"""

from __future__ import annotations

import datetime
import importlib
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NO_GROUP_ENV = "TPUSNAP_TORCH_TEST_NO_GROUP"
_MODULE_DIR_ENV = "TPUSNAP_TORCH_TEST_MODULE_DIR"
# numpy has no bf16 or fp8: ``rand_array`` casts their float64 draw in torch.
_NON_NUMPY_FLOATS = ("bfloat16", "float8_e4m3fn", "float8_e5m2")


def rand_array(dtype_str: str, shape=(16, 9), seed: int = 0):
    """Random CPU tensor of any supported dtype string with full bit
    diversity, from the same numpy draw as tpusnap's ``rand_array`` for
    the same seed: normal floats, both parts of complex values, 0/1 for
    bool, uniform bytes for integers."""
    import numpy as np
    import torch

    from .serialization import string_to_dtype

    rng = np.random.default_rng(seed)
    if dtype_str in _NON_NUMPY_FLOATS:
        return torch.from_numpy(rng.standard_normal(shape)).to(string_to_dtype(dtype_str))
    string_to_dtype(dtype_str)  # refuses an unsupported string
    dtype = np.dtype(dtype_str)
    if dtype_str == "bool":
        arr = rng.integers(0, 2, size=shape).astype(bool)
    elif dtype_str.startswith("float"):
        arr = rng.standard_normal(shape).astype(dtype)
    elif dtype_str.startswith("complex"):
        arr = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(dtype)
    else:
        raw = rng.integers(0, 256, size=(*shape, dtype.itemsize), dtype=np.uint8)
        arr = raw.view(dtype).reshape(*shape, -1)[..., 0].copy()
    return torch.from_numpy(arr)


def _is_node(x: Any) -> bool:
    return x is None or isinstance(x, (dict, list, tuple))


def check_state_dict_eq(a: Any, b: Any) -> bool:
    """Deep equality over nested state, nested as tpusnap's does: dicts
    by key (an ordered dict by key order), lists and tuples by type and
    length, None as an empty node. Tensors (and numpy arrays) are equal
    when dtype, shape and every byte are (``torch.equal`` over their
    bytes, so a NaN equals the same NaN); other leaves by ``==``."""
    import collections

    import numpy as np
    import torch

    if _is_node(a) or _is_node(b):
        if type(a) is not type(b):
            return False
        if isinstance(a, dict):
            ka, kb = list(a), list(b)
            if not isinstance(a, collections.OrderedDict):
                ka, kb = sorted(ka, key=repr), sorted(kb, key=repr)
            return ka == kb and all(check_state_dict_eq(a[k], b[k]) for k in ka)
        if a is None:
            return True
        return len(a) == len(b) and all(check_state_dict_eq(x, y) for x, y in zip(a, b))
    if isinstance(a, (torch.Tensor, np.ndarray)) or isinstance(b, (torch.Tensor, np.ndarray)):
        if not (isinstance(a, (torch.Tensor, np.ndarray)) and isinstance(b, (torch.Tensor, np.ndarray))):
            return False
        ta, tb = (
            torch.from_numpy(np.ascontiguousarray(x)) if isinstance(x, np.ndarray)
            else x.detach().cpu()
            for x in (a, b)
        )
        if ta.dtype != tb.dtype or ta.shape != tb.shape:
            return False
        return torch.equal(
            ta.contiguous().reshape(-1).view(torch.uint8),
            tb.contiguous().reshape(-1).view(torch.uint8),
        )
    return bool(a == b)


def find_free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


_world_store = None


def store_from_env():
    """The TCPStore of the world this process belongs to (rank 0 hosts
    it), from ``MASTER_ADDR``, ``MASTER_PORT``, ``RANK`` and
    ``WORLD_SIZE``; one client per process."""
    global _world_store
    if _world_store is None:
        import torch.distributed as dist

        _world_store = dist.TCPStore(
            os.environ["MASTER_ADDR"],
            int(os.environ["MASTER_PORT"]),
            int(os.environ["WORLD_SIZE"]),
            is_master=int(os.environ["RANK"]) == 0,
            timeout=datetime.timedelta(seconds=300),
        )
    return _world_store


def world_mesh(device_type: str = "cpu", mesh_shape: Optional[List[int]] = None):
    """A ``DeviceMesh`` of ``mesh_shape`` (default: one dim of every rank)
    over the ranks of this process's default group, in rank order. Every
    rank must call it: the mesh builds its sub-groups collectively. For
    ``"cuda"``, set the current device first (several ranks may share
    one card; the group stays gloo)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    world = dist.get_world_size()
    shape = list(mesh_shape) if mesh_shape is not None else [world]
    return DeviceMesh(device_type, torch.arange(world).reshape(shape))


def host_mesh_like(mesh):
    """A ``"cpu"`` ``DeviceMesh`` over the ranks, shape and dim names of
    ``mesh``: host-offloaded (pinned) tensors shard over it beside the
    ``"cuda"`` mesh of the device state. Every rank must call it."""
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh("cpu", mesh.mesh, mesh_dim_names=mesh.mesh_dim_names)


def as_dtensor(full, mesh, placements):
    """``full`` (the whole tensor, held by every rank) as a DTensor over
    ``mesh`` whose local tensor is a view of this rank's box of it. No
    collective runs (``run_check=False``); a rank outside the mesh gets an
    empty local tensor."""
    from torch.distributed.tensor import DTensor

    from .io_preparers.sharded import local_box

    coordinate = mesh.get_coordinate()
    if coordinate is None:
        local = full.new_empty((0,) * full.dim())
    else:
        offsets, sizes = local_box(list(full.shape), list(mesh.shape), coordinate, placements)
        local = full[tuple(slice(o, o + n) for o, n in zip(offsets, sizes))]
    return DTensor.from_local(
        local, mesh, placements, run_check=False, shape=full.shape, stride=full.stride()
    )


def run_subprocess_world(
    fn: Callable[..., None],
    world_size: int,
    timeout: float = 180.0,
    extra_env: Optional[Dict[str, str]] = None,
    args: Optional[List[str]] = None,
    hostnames: Optional[List[str]] = None,
    init_process_group: bool = True,
    grace: float = 30.0,
) -> List[str]:
    """Run ``fn(*args)`` in ``world_size`` processes of one world; return
    each rank's output. ``hostnames`` simulates several hosts on one
    machine: rank i runs with ``TPUSNAP_NODE_NAME=hostnames[i]``, which
    the per-host memory-budget divisor reads in place of the OS
    hostname."""
    port = find_free_port()
    module = sys.modules.get(fn.__module__)
    module_dir, module_name = "", fn.__module__
    if module is not None and getattr(module, "__file__", None):
        module_path = os.path.abspath(module.__file__)
        module_dir = os.path.dirname(module_path)
        if module_name == "__main__":
            # Defined in a script run directly: re-import it by file name.
            module_name = os.path.splitext(os.path.basename(module_path))[0]
    procs, logs = [], []
    try:
        for rank in range(world_size):
            env = dict(os.environ)
            env.update(
                {
                    "PYTHONPATH": _REPO_ROOT,
                    "MASTER_ADDR": "127.0.0.1",
                    "MASTER_PORT": str(port),
                    "RANK": str(rank),
                    "WORLD_SIZE": str(world_size),
                    _MODULE_DIR_ENV: module_dir,
                    _NO_GROUP_ENV: "0" if init_process_group else "1",
                }
            )
            if hostnames is not None:
                env["TPUSNAP_NODE_NAME"] = hostnames[rank]
            if extra_env:
                env.update(extra_env)
            log = tempfile.TemporaryFile(mode="w+")
            logs.append(log)
            procs.append(
                subprocess.Popen(
                    [
                        sys.executable, "-m", "tpusnap_torch.test_utils",
                        module_name, fn.__qualname__, *(args or []),
                    ],
                    env=env,
                    cwd=_REPO_ROOT,
                    stdout=log,
                    stderr=subprocess.STDOUT,
                )
            )
        timed_out = _wait_all(procs, timeout, grace)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
    outputs = []
    for log in logs:
        log.seek(0)
        outputs.append(log.read())
        log.close()
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed or timed_out:
        text = "\n".join(
            f"----- rank {r} (exit {procs[r].returncode}) -----\n{outputs[r]}"
            for r in range(world_size)
        )
        what = f"ranks {failed} failed" if failed else ""
        if timed_out:
            what += (" and " if what else "") + "timed out"
        raise RuntimeError(f"world of {world_size} {what}:\n{text}")
    return outputs


def _wait_all(procs: List[subprocess.Popen], timeout: float, grace: float) -> bool:
    """Wait for every process; after the first failure the rest get
    ``grace`` seconds. Returns whether the deadline ended the wait."""
    deadline = time.monotonic() + timeout
    while True:
        codes = [p.poll() for p in procs]
        if all(c is not None for c in codes):
            return False
        if any(c not in (None, 0) for c in codes):
            deadline = min(deadline, time.monotonic() + grace)
        if time.monotonic() > deadline:
            return True
        time.sleep(0.05)


def _subprocess_main() -> None:
    module_name, qualname = sys.argv[1], sys.argv[2]
    if os.environ.get(_NO_GROUP_ENV) != "1":
        import torch.distributed as dist

        dist.init_process_group(
            "gloo",
            rank=int(os.environ["RANK"]),
            world_size=int(os.environ["WORLD_SIZE"]),
            timeout=datetime.timedelta(seconds=300),
        )
    # Test modules import from tests/; user modules from where the
    # function was defined.
    sys.path.insert(0, os.path.join(_REPO_ROOT, "tests"))
    module_dir = os.environ.get(_MODULE_DIR_ENV)
    if module_dir:
        sys.path.insert(0, module_dir)
    fn = importlib.import_module(module_name)
    for part in qualname.split("."):
        fn = getattr(fn, part)
    fn(*sys.argv[3:])
    # Rank 0 hosts the store: it leaves last, so no peer loses the store
    # in its final wait.
    if os.environ.get(_NO_GROUP_ENV) != "1":
        import torch.distributed as dist

        dist.barrier()
        dist.destroy_process_group()
    elif _world_store is not None:
        world_size = int(os.environ["WORLD_SIZE"])
        _world_store.add("tpusnap_torch_test/done", 1)
        if int(os.environ["RANK"]) == 0:
            while _world_store.add("tpusnap_torch_test/done", 0) < world_size:
                time.sleep(0.01)


if __name__ == "__main__":
    _subprocess_main()
