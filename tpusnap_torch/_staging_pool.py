"""Reusable aligned host buffers for the defensive clones of async takes.

Counterpart of tpusnap/_staging_pool.py. Which pool serves which buffer:

- **This pool** serves the clone buffers of CPU sources. An async take of
  a CPU tensor with ``TPUSNAP_ASYNC_COW=0`` copies its live bytes into a
  buffer from here before control returns; the write pipeline hands the
  buffer back after its storage write. Most of a fresh clone's cost is
  first-touch page faults, and a checkpoint loop clones the same sizes
  every take, so released buffers are kept and handed back warm.
- **Pinned device→host buffers** of CUDA sources come from PyTorch's
  caching host allocator (``torch.empty(..., pin_memory=True)``), which
  already reuses them; they never enter this pool.
- **Device copies** that freeze CUDA state outside an async take's first
  window come from PyTorch's CUDA caching allocator.

Exact-size matching only, LIFO (the newest match has the warmest pages,
and it lets window N+1 of a pipelined take reuse what window N's write
just released), bounded by ``TPUSNAP_STAGING_POOL_BYTES`` (default 4 GiB;
0 disables), and leak-proof: outstanding buffers are tracked by weakref,
so a buffer dropped on an abort path is garbage-collected and forgotten.
``release`` accepts any buffer and ignores those it did not hand out.
"""

from __future__ import annotations

import threading
import weakref
from typing import Dict, List, Tuple

import numpy as np

from . import knobs

_lock = threading.Lock()
_free: List[Tuple[int, np.ndarray]] = []  # [(nbytes, buffer)], oldest first
_free_bytes = 0
# id(buffer) -> weakref of the buffers handed out and not yet released.
_outstanding: Dict[int, "weakref.ref"] = {}


def acquire(nbytes: int) -> np.ndarray:
    """An aligned uint8 buffer of exactly ``nbytes``: a released one of
    that size when there is one (newest first), fresh otherwise. Its
    contents are undefined."""
    global _free_bytes
    from . import _native

    with _lock:
        for k in [k for k, r in _outstanding.items() if r() is None]:
            del _outstanding[k]
        for i in range(len(_free) - 1, -1, -1):
            n, buf = _free[i]
            if n == nbytes:
                _free.pop(i)
                _free_bytes -= n
                _outstanding[id(buf)] = weakref.ref(buf)
                return buf
    buf = _native.aligned_empty(nbytes)
    with _lock:
        _outstanding[id(buf)] = weakref.ref(buf)
    return buf


def release(buf) -> bool:
    """Return a buffer to the pool; True when the pool kept it. Buffers
    larger than the cap are dropped; otherwise the oldest free entries
    are evicted until it fits, so sizes a process no longer stages age
    out."""
    global _free_bytes
    if not isinstance(buf, np.ndarray):
        return False
    with _lock:
        ref = _outstanding.pop(id(buf), None)
        if ref is None or ref() is not buf:
            return False
        cap = knobs.get_staging_pool_bytes()
        if buf.nbytes > cap:
            return False
        while _free and _free_bytes + buf.nbytes > cap:
            old_n, _ = _free.pop(0)
            _free_bytes -= old_n
        _free.append((buf.nbytes, buf))
        _free_bytes += buf.nbytes
        return True


def free_bytes() -> int:
    """Bytes parked in the free list."""
    with _lock:
        return _free_bytes


def clear() -> None:
    """Drop every parked buffer."""
    global _free_bytes
    with _lock:
        _free.clear()
        _free_bytes = 0
