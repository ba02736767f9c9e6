"""The port's examples (tpusnap_torch/examples/) run as subprocesses on the
CPU, held to the output checks and resumes of tests/test_examples.py, and
each entry point's refusal to run without a card unless asked for the CPU.
The cross-package resume of the flagship example is in
tests/test_torch_examples_parity.py."""

import glob
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_module(module, *args, tmp_path, timeout=300, device="cpu"):
    """``python -m <module> [--device cpu] ARGS`` from the repo root; returns
    the completed process."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               TPUSNAP_TELEMETRY_DIR=str(tmp_path / "telemetry"))
    cmd = [sys.executable, "-m", module, *args]
    if device is not None:
        cmd += ["--device", device]
    return subprocess.run(cmd, capture_output=True, text=True, timeout=timeout,
                          cwd=REPO, env=env)


def _run_example(name, *args, tmp_path):
    proc = run_module(f"tpusnap_torch.examples.{name}", *args, tmp_path=tmp_path)
    assert proc.returncode == 0, (
        f"{name} failed (rc={proc.returncode})\n"
        f"stdout:\n{proc.stdout}\nstderr:\n{proc.stderr}"
    )
    return proc.stdout


def test_simple_example_and_resume(tmp_path):
    work = tmp_path / "work"
    out = _run_example("simple", "--work-dir", str(work), tmp_path=tmp_path)
    assert "epoch 4" in out
    # Resume from epoch 2's snapshot: the loop must continue at epoch 3,
    # with the losses of the uninterrupted run.
    resumed = _run_example(
        "simple", "--work-dir", str(work), "--resume-from", str(work / "epoch_2"),
        tmp_path=tmp_path,
    )
    assert "resumed" in resumed and "at epoch 2" in resumed
    assert "epoch 3" in resumed and "epoch 4" in resumed
    losses = lambda text, e: [l.split()[2] for l in text.splitlines() if l.startswith(f"epoch {e}:")]  # noqa: E731,E741
    assert losses(resumed, 3) == losses(out, 3) and losses(resumed, 4) == losses(out, 4)


def test_transformer_example(tmp_path):
    work = tmp_path / "work"
    _run_example("transformer", "--work-dir", str(work), tmp_path=tmp_path)
    # Resume from the last epoch snapshot: exercises async_restore (reads
    # overlap the setup) in the canonical flagship journey.
    snaps = sorted(glob.glob(str(work / "epoch_*")))
    assert snaps, "example produced no snapshots"
    out = _run_example(
        "transformer", "--work-dir", str(work), "--resume-from", snaps[-1], tmp_path=tmp_path
    )
    assert "resumed at epoch" in out
    # And from epoch 2: it trains epoch 3 and commits it.
    out = _run_example(
        "transformer", "--work-dir", str(tmp_path / "resumed"),
        "--resume-from", str(work / "epoch_2"), tmp_path=tmp_path,
    )
    assert "resumed at epoch 2" in out and "epoch 3:" in out
    assert "final snapshot committed" in out


@pytest.mark.distributed
def test_distributed_example(tmp_path):
    out = _run_example("distributed", "--work-dir", str(tmp_path / "work"), tmp_path=tmp_path)
    assert "rank 0: restore verified" in out and "rank 1: restore verified" in out


def test_incremental_example(tmp_path):
    out = _run_example("incremental", "--work-dir", str(tmp_path / "work"), tmp_path=tmp_path)
    assert "incremental on" in out
    assert "0 corrupt" in out
    assert "bit-exact" in out


ENTRY_POINTS = [
    "tpusnap_torch.examples.simple",
    "tpusnap_torch.examples.incremental",
    "tpusnap_torch.examples.distributed",
    "tpusnap_torch.examples.transformer",
    "tpusnap_torch.benchmarks.load_tensor",
    "tpusnap_torch.benchmarks.pinned_host",
    "tpusnap_torch.benchmarks.async_latency",
    "tpusnap_torch.benchmarks.incremental",
    "tpusnap_torch.benchmarks.replicated",
    "tpusnap_torch.benchmarks.sharded",
    "tpusnap_torch.benchmarks.embedding",
    "tpusnap_torch.benchmarks.gcs_pipeline",
    "tpusnap_torch.benchmarks.dcp_compare",
    "tpusnap_torch.benchmarks.fleetsim",
]


@pytest.mark.parametrize("module", ENTRY_POINTS)
def test_entry_point_without_cuda_returns_2_with_a_message(module, capsys):
    """Not asked for the CPU, on a host without a card: ``main`` returns 2
    after one line on stderr, before any work (nothing on stdout)."""
    import importlib

    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry point would run on it")
    assert importlib.import_module(module).main([]) == 2
    out, err = capsys.readouterr()
    assert out == ""
    lines = err.strip().splitlines()
    assert len(lines) == 1 and "no CUDA device is available" in lines[0], err


def test_module_run_without_cuda_exits_2(tmp_path):
    """The same through ``python -m``: the process's exit code."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry point would run on it")
    proc = run_module("tpusnap_torch.examples.transformer", tmp_path=tmp_path, device=None)
    assert proc.returncode == 2 and proc.stdout == "", proc.stdout + proc.stderr
    assert "no CUDA device is available" in proc.stderr
