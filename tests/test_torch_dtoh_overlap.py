"""Device-to-host staging on the card: the port's counterpart of
tests/test_dtoh_overlap.py. ``io_preparers/array.py::enqueue_dtoh``
stages a CUDA tensor the way every take does: a side stream that waits on
the caller's ready event, a pinned host buffer, a non-blocking copy and a
done event. A child process on the card (run through
``tpusnap_torch._subproc.run_hard_timeout``, so a wedged CUDA child
cannot hang the suite) stages N = 4 tensors of 64 MiB behind a busy
caller stream. The prepare calls must return before the copies complete
(every done event still pending), and the staged bytes must be exact. The
copies' wall time is reported beside one copy of the same 256 MiB, as a
number with no threshold.

Marked ``cuda``: it skips without a card. From the repo root:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_dtoh_overlap.py -q -s
"""

import json
import os
import sys

import pytest

from tpusnap_torch._subproc import run_hard_timeout

pytestmark = pytest.mark.cuda

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import json, time
import torch
from tpusnap_torch.io_preparers.array import enqueue_dtoh

N, NBYTES = 4, 64 << 20
dev = torch.device("cuda")
gen = torch.Generator(device=dev).manual_seed(0)
srcs = [torch.randn(NBYTES // 4, generator=gen, device=dev) for _ in range(N)]
whole = torch.cat(srcs)

def stage(spin_cycles):
    stream = torch.cuda.current_stream()
    if spin_cycles:
        torch.cuda._sleep(spin_cycles)  # the caller's stream is still busy
    ready = torch.cuda.Event()
    ready.record(stream)
    t0 = time.perf_counter()
    staged = [enqueue_dtoh(t, ready) for t in srcs]
    returned = time.perf_counter() - t0
    pending = [not done.query() for _, done in staged]
    for _, done in staged:
        done.synchronize()
    return staged, returned, pending, time.perf_counter() - t0

stage(0)  # warm the pinned allocator and the streams
torch.cuda.synchronize()
staged, returned_s, pending, _ = stage(200_000_000)
exact = all(torch.equal(host.view(torch.float32), src.cpu()) for (host, _), src in zip(staged, srcs))
del staged  # its pinned buffers go back to the allocator's cache

torch.cuda.synchronize()
_, _, _, copies_s = stage(0)
one = torch.empty(whole.numel() * 4, dtype=torch.uint8, pin_memory=True)
torch.cuda.synchronize()
t0 = time.perf_counter()
one.copy_(whole.view(torch.uint8), non_blocking=True)
torch.cuda.synchronize()
one_copy_s = time.perf_counter() - t0
print(json.dumps({
    "device": torch.cuda.get_device_name(0), "tensors": N, "bytes_each": NBYTES,
    "returned_s": returned_s, "pending_at_return": pending, "bytes_exact": exact,
    "four_copies_s": copies_s, "one_copy_s": one_copy_s,
}))
"""


def test_staging_returns_before_the_copies_complete_and_stages_exact_bytes(record_property):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the copies under test are device-to-host DMAs")
    env = dict(os.environ, PYTHONPATH=_REPO)
    proc = run_hard_timeout([sys.executable, "-c", _PROBE], timeout_s=150, env=env)
    assert not proc.timed_out, f"the probe wedged: {proc.stdout[-500:]} {proc.stderr[-500:]}"
    assert proc.returncode == 0, proc.stderr[-2000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert all(result["pending_at_return"]), result
    assert result["bytes_exact"], result
    # The report: a number, no threshold.
    record_property("dtoh", result)
    print(f"\n{result['tensors']} x {result['bytes_each'] >> 20} MiB staged in "
          f"{result['four_copies_s'] * 1e3:.3f} ms; one copy of the same bytes "
          f"{result['one_copy_s'] * 1e3:.3f} ms ({result['device']})")
