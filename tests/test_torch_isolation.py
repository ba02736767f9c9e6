"""tpusnap_torch stands alone: it imports neither JAX nor the JAX package.

Importing any ``tpusnap.*`` module runs ``tpusnap/__init__.py``, which
imports JAX, so the port keeps its own copies of what it needs. The first
test imports every module of the port in a fresh interpreter in which
``jax`` and ``tpusnap`` cannot be imported; the second scans the sources
of the port and of ``chip_smoke.py`` for such imports.
"""

import os
import pkgutil
import re
import subprocess
import sys

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PKG = os.path.join(_REPO, "tpusnap_torch")


def _port_modules():
    """Every Python module of the port (not the built native libraries,
    which ``pkgutil`` would also list)."""
    names = ["tpusnap_torch"]
    for info in pkgutil.walk_packages([_PKG], prefix="tpusnap_torch."):
        leaf = os.path.join(_PKG, *info.name.split(".")[1:])
        if info.ispkg or os.path.exists(leaf + ".py"):
            names.append(info.name)
    return sorted(names)


def test_every_module_imports_without_jax_or_tpusnap():
    modules = _port_modules()
    assert "tpusnap_torch.ops.flash_attention" in modules
    assert "tpusnap_torch.models.transformer" in modules
    for name in (
        "compress", "inspect", "retention", "transforms",
        "comm", "dist_store", "partitioner", "test_utils",
        "io_preparers.sharded", "host_offload", "pytree_state",
        "models.embedding", "models.layout",
        "telemetry", "flight", "progress", "retry", "faults", "lifecycle",
        "liveness", "rss_profiler", "storage_plugin",
        "tiering", "cas", "delta", "storage_plugins.s3", "storage_plugins.gcs",
        "storage_plugins.fsspec",
    ):
        assert f"tpusnap_torch.{name}" in modules
    code = (
        "import importlib, sys\n"
        "for name in ('jax', 'jaxlib', 'tpusnap'):\n"
        "    sys.modules[name] = None\n"
        f"for name in {modules!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'tpusnap')"
        " and sys.modules[m] is not None)\n"
        "assert not bad, bad\n"
        "print('imported', len(sys.modules))\n"
    )
    env = dict(os.environ, PYTHONPATH=_REPO)
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=_REPO, env=env, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("imported")


_FORBIDDEN = [
    re.compile(r"^\s*(import|from)\s+jax(lib)?\b", re.M),
    re.compile(r"^\s*from\s+tpusnap(?!_torch)\b", re.M),
    re.compile(r"^\s*import\s+tpusnap(?!_torch)\b", re.M),
    re.compile(r"""import_module\(\s*["'](jax|tpusnap(?!_torch))"""),
]


def _sources():
    for root, _, files in os.walk(_PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(_REPO, "chip_smoke.py")


@pytest.mark.parametrize(
    "path", sorted(_sources()), ids=lambda p: os.path.relpath(p, _REPO)
)
def test_source_has_no_jax_or_tpusnap_import(path):
    with open(path) as f:
        text = f.read()
    hits = [m.group(0).strip() for pat in _FORBIDDEN for m in pat.finditer(text)]
    assert not hits, f"{os.path.relpath(path, _REPO)}: {hits}"
