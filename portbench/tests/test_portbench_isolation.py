"""Nothing the benchmark runs imports JAX or the JAX package (top-level
names compared whole), the reference imports nothing of the program, and
nothing reads the JAX package's benchmark files."""

import ast
import subprocess
import sys
from pathlib import Path

from portbench import harness, registry

HERE = registry.HERE


def _imports(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


def test_no_source_imports_jax_or_the_jax_package():
    for path in HERE.rglob("*.py"):
        assert not _imports(path) & harness.FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_program():
    for path in (HERE / "references").glob("*.py"):
        assert _imports(path) <= {"__future__", "math", "typing", "torch"}, path


def test_nothing_reads_the_jax_packages_benchmark():
    for path in HERE.rglob("*.py"):
        if path.parent.name == "tests":
            continue
        text = path.read_text()
        for needle in ("bench.py", "BENCH_", "benchmarks/", "tpusnap_torch.benchmarks"):
            assert needle not in text, (path, needle)


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "tpusnap_torch_like", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_like", sys)
    monkeypatch.setitem(sys.modules, "tpusnap.fake", sys)
    found = harness.forbidden_modules()
    assert "tpusnap.fake" in found
    assert "tpusnap_torch_like" not in found and "jaxtyping_like" not in found


def test_a_run_loads_no_jax(tmp_path):
    code = (
        "import sys, os; sys.path.insert(0, %r);"
        "os.environ['TPUSNAP_ASYNC_COW'] = '0';"
        "from portbench import harness;"
        "from portbench.tests.conftest import TINY_RUN;"
        "import time;"
        "r = harness.run('big.async_mem', 3, 1.0, False, time.perf_counter(), device='cpu', overrides=TINY_RUN);"
        "print(r['correct'], harness.forbidden_modules())"
    ) % str(registry.CHECKOUT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "TMPDIR": str(tmp_path), "OMP_NUM_THREADS": "2",
                              "TPUSNAP_TELEMETRY_DIR": str(tmp_path / "t"), "HOME": str(tmp_path)})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "True []"


def test_without_a_card_the_run_exits_non_zero_and_prints_nothing(tmp_path):
    out = subprocess.run([sys.executable, str(HERE / "run.py"), "--workload", "big.sync_mem",
                          "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=registry.CHECKOUT,
                         env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "", "TMPDIR": str(tmp_path),
                              "HOME": str(tmp_path)})
    assert out.returncode != 0 and out.stdout == ""


def test_a_module_loaded_after_the_window_refuses_the_result(monkeypatch):
    """The check runs after the window (restores, the reference, the
    readers); a JAX-package module that any of them loads is caught
    before the result is returned."""
    import time

    import pytest

    from portbench import job

    from .conftest import TINY_RUN

    verify = job._MemoryPolicy.verify

    def loading_verify(self):
        sys.modules["tpusnap.fake_after_window"] = sys
        return verify(self)

    monkeypatch.setattr(job._MemoryPolicy, "verify", loading_verify)
    monkeypatch.delitem(sys.modules, "tpusnap.fake_after_window", raising=False)
    try:
        with pytest.raises(harness.Refused, match="tpusnap.fake_after_window"):
            harness.run("big.sync_mem", 2**31 + 7, 1.0, False, time.perf_counter(), device="cpu",
                        overrides=TINY_RUN)
    finally:
        sys.modules.pop("tpusnap.fake_after_window", None)
