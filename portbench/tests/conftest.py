"""Shared settings of the benchmark's own tests: CPU async takes clone
their sources (``TPUSNAP_ASYNC_COW=0``: the job steps its state in place
while a take drains) and the program's telemetry files go to a
temporary directory."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

# A configuration small enough for a CPU test, at the flagship's shape.
# Its limits are its own: sums over fewer elements read bf16's rounding
# higher (the program's first steps read up to 4.9e-4, 2.3e-3 and
# 1.2e-3 over ten seeds on the CPU; the fp8 control's grad_gap at least
# 1.6e-2). The card tests hold the configurations' own limits.
TINY = dict(vocab_size=512, d_model=64, n_heads=4, n_layers=2, d_ff=128, max_seq_len=64, batch=4,
            limits={"loss_gap": 8e-4, "grad_gap": 6e-3, "update_gap": 2e-3})
# A run of it: checkpoints every few steps, so that a short window holds
# several on a loaded CPU.
TINY_RUN = {"config": TINY, "mix": {"every_steps": 3}}


@pytest.fixture(autouse=True)
def _program_env(tmp_path, monkeypatch):
    import torch

    # Several test workers share the machine's cores.
    torch.set_num_threads(2)
    monkeypatch.setenv("TPUSNAP_ASYNC_COW", "0")
    monkeypatch.setenv("TPUSNAP_TELEMETRY_DIR", str(tmp_path / "telemetry"))
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))


@pytest.fixture
def card():
    """The CUDA device, or a skip with the reason; decided inside the
    test run, never at import."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run on the card with -m cuda")
    return torch.device("cuda")
