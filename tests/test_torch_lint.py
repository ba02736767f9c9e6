"""The port's AST invariant checker (``python -m tpusnap_torch lint``),
mirroring tests/test_lint.py: per-rule unit matrix on synthetic snippets
(positive / negative / waived), the whole-package zero-findings gate over
``tpusnap_torch/``, and the CLI exit-code contract — exit 0 on the clean
tree, exit 2 when a violation of each shipped rule is seeded into a temp
copy of the package. One cross-package case runs tpusnap's linter and the
port's over the same seeded tree: the same rule ids at the same lines."""

import json
import os
import shutil
import subprocess
import sys
import textwrap

import pytest

from tpusnap_torch.devtools.lint import (
    parse_waivers,
    render_table,
    run_lint,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _lint(tmp_path, files, select=None, api_md=None):
    """Build a throwaway package tree from ``files`` (relpath → source)
    and lint it."""
    tmp_path.mkdir(parents=True, exist_ok=True)
    pkg = tmp_path / "pkg"
    pkg.mkdir(exist_ok=True)
    for rel, src in files.items():
        p = pkg / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))
    if api_md is not None:
        docs = tmp_path / "docs"
        docs.mkdir(exist_ok=True)
        (docs / "api.md").write_text(textwrap.dedent(api_md))
    return run_lint(package_root=str(pkg), select=select)


def _rules_of(result):
    return [f.rule for f in result.findings]


# ------------------------------------------------------------- framework


def test_parse_waivers_same_line_and_comma_list():
    w = parse_waivers(
        "x = 1  # tpusnap: waive=TPS001 reason text\n"
        "y = 2  # tpusnap: waive=TPS003,TPS004\n"
        "z = 3\n"
    )
    assert w == {1: {"TPS001"}, 2: {"TPS003", "TPS004"}}


def test_parse_waivers_comment_above_applies_to_next_code_line():
    w = parse_waivers(
        "a = 1\n"
        "# tpusnap: waive=TPS004 why this swallow is fine\n"
        "# (continued explanation)\n"
        "pass_line = 2\n"
    )
    assert w == {4: {"TPS004"}}


def test_parse_waivers_blank_line_clears_pending():
    """A stale waive comment stranded by a refactor (blank line between
    it and the next code) must NOT suppress findings further down."""
    w = parse_waivers(
        "# tpusnap: waive=TPS004 this statement was deleted\n"
        "\n"
        "x = 1\n"
    )
    assert w == {}


def test_unknown_rule_select_raises(tmp_path):
    with pytest.raises(RuntimeError, match="TPS999"):
        _lint(tmp_path, {"a.py": "x = 1\n"}, select=["TPS999"])


def test_unparseable_file_is_a_finding(tmp_path):
    res = _lint(tmp_path, {"bad.py": "def broken(:\n"}, select=["TPS001"])
    assert _rules_of(res) == ["PARSE"]


# ---------------------------------------------------------------- TPS001


TPS001_CASES = [
    'import os\nX = os.environ.get("TPUSNAP_FOO")\n',
    'import os\nX = os.environ["TPUSNAP_FOO"]\n',
    'import os\nX = os.getenv("TPUSNAP_FOO")\n',
    'import os\nX = "TPUSNAP_FOO" in os.environ\n',
    'from os import environ as env\nX = env.get("TPUSNAP_FOO")\n',
    'from os import getenv\nX = getenv("TPUSNAP_FOO")\n',
    'import os as _o\n_o.environ["TPUSNAP_FOO"] = "1"\n',
]


@pytest.mark.parametrize("src", TPS001_CASES)
def test_tps001_positive(tmp_path, src):
    res = _lint(tmp_path, {"mod.py": src}, select=["TPS001"])
    assert _rules_of(res) == ["TPS001"], render_table(res)


def test_tps001_negative(tmp_path):
    res = _lint(
        tmp_path,
        {
            # knobs.py is the blessed accessor
            "knobs.py": 'import os\nX = os.environ.get("TPUSNAP_FOO")\n',
            # non-TPUSNAP keys are out of scope
            "mod.py": 'import os\nX = os.environ.get("OTHER_VAR")\n',
        },
        select=["TPS001"],
    )
    assert res.findings == []


def test_tps001_waived(tmp_path):
    res = _lint(
        tmp_path,
        {
            "mod.py": (
                "import os\n"
                'X = os.environ["TPUSNAP_T"]  # tpusnap: waive=TPS001 why\n'
            )
        },
        select=["TPS001"],
    )
    assert res.findings == [] and len(res.waived) == 1


# ---------------------------------------------------------------- TPS002


@pytest.mark.parametrize(
    "src",
    [
        "import time\nx = time.time()\n",
        "import time as t\nx = t.time()\n",
        "from time import time\nx = time()\n",
        "from time import time as now\nx = now()\n",
    ],
)
def test_tps002_positive(tmp_path, src):
    res = _lint(tmp_path, {"telemetry.py": src}, select=["TPS002"])
    assert _rules_of(res) == ["TPS002"], render_table(res)


def test_tps002_negative(tmp_path):
    res = _lint(
        tmp_path,
        {
            # the seam: a bare reference, not a call
            "progress.py": "import time\n_wall = time.time\n",
            # monotonic is the point
            "history.py": "import time\nx = time.monotonic()\n",
            # out-of-scope module may use wall clocks
            "other.py": "import time\nx = time.time()\n",
        },
        select=["TPS002"],
    )
    assert res.findings == []


def test_tps002_waived(tmp_path):
    res = _lint(
        tmp_path,
        {
            "history.py": (
                "import time\n"
                "x = time.time()  # tpusnap: waive=TPS002 event timestamp\n"
            )
        },
        select=["TPS002"],
    )
    assert res.findings == [] and len(res.waived) == 1


# ---------------------------------------------------------------- TPS003


def test_tps003_positive(tmp_path):
    needle = ".tpusnap" + "/"
    res = _lint(
        tmp_path,
        {
            "mod.py": f'P = "{needle}journal"\n',
            "fstr.py": (
                "def p(r):\n"
                f'    return f"{needle}probe/rank_{{r}}.bin"\n'
            ),
        },
        select=["TPS003"],
    )
    assert sorted(_rules_of(res)) == ["TPS003", "TPS003"], render_table(res)


def test_tps003_negative(tmp_path):
    needle = ".tpusnap" + "/"
    res = _lint(
        tmp_path,
        {
            # the canonical definition site
            "io_types.py": f'SIDECAR_PREFIX = "{needle}"\n',
            # docstrings describe the layout; they don't implement it
            "mod.py": f'"""Sidecars live under {needle}."""\nX = 1\n',
        },
        select=["TPS003"],
    )
    assert res.findings == []


def test_tps003_waived(tmp_path):
    needle = ".tpusnap" + "/"
    res = _lint(
        tmp_path,
        {"mod.py": f'P = "{needle}x"  # tpusnap: waive=TPS003 test fixture\n'},
        select=["TPS003"],
    )
    assert res.findings == [] and len(res.waived) == 1


# ---------------------------------------------------------------- TPS004


@pytest.mark.parametrize(
    "handler", ["except Exception:", "except BaseException:", "except:"]
)
def test_tps004_positive(tmp_path, handler):
    src = f"def f():\n    try:\n        g()\n    {handler}\n        pass\n"
    res = _lint(tmp_path, {"comm.py": src}, select=["TPS004"])
    assert _rules_of(res) == ["TPS004"], render_table(res)


def test_tps004_negative(tmp_path):
    res = _lint(
        tmp_path,
        {
            # a log call makes the swallow deliberate and visible
            "dist_store.py": (
                "def f():\n"
                "    try:\n"
                "        g()\n"
                "    except Exception:\n"
                "        logger.debug('x', exc_info=True)\n"
            ),
            # narrow exception types are deliberate control flow
            "lifecycle.py": (
                "def f():\n"
                "    try:\n"
                "        g()\n"
                "    except ValueError:\n"
                "        pass\n"
            ),
            # out-of-scope modules are not crash-safety surface
            "other.py": (
                "def f():\n"
                "    try:\n"
                "        g()\n"
                "    except Exception:\n"
                "        pass\n"
            ),
        },
        select=["TPS004"],
    )
    assert res.findings == []


def test_tps004_waived_same_line_and_comment_above(tmp_path):
    res = _lint(
        tmp_path,
        {
            "comm.py": (
                "def f():\n"
                "    try:\n"
                "        g()\n"
                "    except Exception:\n"
                "        pass  # tpusnap: waive=TPS004 reason\n"
            ),
            "faults.py": (
                "def f():\n"
                "    try:\n"
                "        g()\n"
                "    except Exception:\n"
                "        # tpusnap: waive=TPS004 injected-fault path\n"
                "        # re-raises below either way\n"
                "        pass\n"
            ),
        },
        select=["TPS004"],
    )
    assert res.findings == [] and len(res.waived) == 2


# ---------------------------------------------------------------- TPS005


@pytest.mark.parametrize(
    "src",
    [
        "import time\nasync def f():\n    time.sleep(1)\n",
        "import time as t\nasync def f():\n    t.sleep(1)\n",
        "from time import sleep\nasync def f():\n    sleep(1)\n",
        "async def f(p):\n    open(p)\n",
        "import os\nasync def f(fd):\n    os.fsync(fd)\n",
    ],
)
def test_tps005_positive(tmp_path, src):
    res = _lint(tmp_path, {"scheduler.py": src}, select=["TPS005"])
    assert _rules_of(res) == ["TPS005"], render_table(res)


def test_tps005_negative(tmp_path):
    res = _lint(
        tmp_path,
        {
            "scheduler.py": (
                "import asyncio, time\n"
                "async def f():\n"
                "    await asyncio.sleep(1)\n"
                "    def worker():\n"
                "        time.sleep(1)  # runs on an executor thread\n"
                "    return worker\n"
                "def sync_helper(p):\n"
                "    return open(p)\n"
            ),
            # other modules may block freely
            "other.py": "import time\nasync def f():\n    time.sleep(1)\n",
        },
        select=["TPS005"],
    )
    assert res.findings == []


def test_tps005_waived(tmp_path):
    res = _lint(
        tmp_path,
        {
            "scheduler.py": (
                "import time\n"
                "async def f():\n"
                "    time.sleep(0)  # tpusnap: waive=TPS005 yield hack\n"
            )
        },
        select=["TPS005"],
    )
    assert res.findings == [] and len(res.waived) == 1


# ---------------------------------------------------------------- TPS006


@pytest.mark.parametrize(
    "body",
    [
        "self._thread.join()",
        "self.close()",
        "self._monitor.stop()",
        "self._executor.shutdown()",
    ],
)
def test_tps006_del_positive(tmp_path, body):
    src = f"class C:\n    def __del__(self):\n        {body}\n"
    res = _lint(tmp_path, {"mod.py": src}, select=["TPS006"])
    assert _rules_of(res) == ["TPS006"], render_table(res)


@pytest.mark.parametrize(
    "src",
    [
        # executor joins in close() must route through the policy helper
        "class C:\n    def close(self):\n"
        "        self._ex.shutdown(wait=True)\n",
        "class C:\n    def close(self):\n        self._ex.shutdown()\n",
        "class C:\n    def close(self):\n        self._t.join()\n",
    ],
)
def test_tps006_close_positive(tmp_path, src):
    res = _lint(tmp_path, {"mod.py": src}, select=["TPS006"])
    assert _rules_of(res) == ["TPS006"], render_table(res)


def test_tps006_negative(tmp_path):
    res = _lint(
        tmp_path,
        {
            "a.py": (
                "from .io_types import finalizer_close_scope\n"
                "class C:\n"
                "    def __del__(self):\n"
                "        with finalizer_close_scope():\n"
                "            self.close()\n"
            ),
            "b.py": (
                "from .io_types import shutdown_plugin_executor\n"
                "class C:\n"
                "    def close(self):\n"
                "        shutdown_plugin_executor(self._ex)\n"
            ),
            "c.py": (
                "from .io_types import close_may_join\n"
                "class C:\n"
                "    def close(self):\n"
                "        self._ex.shutdown(wait=close_may_join())\n"
                "class D:\n"
                "    def close(self):\n"
                "        self._ex.shutdown(wait=False)\n"
            ),
            # string/path joins are not thread joins
            "d.py": (
                "import os\n"
                "class C:\n"
                "    def __del__(self):\n"
                '        x = ", ".join(self.names)\n'
                "    def close(self):\n"
                "        p = os.path.join(self.a, self.b)\n"
            ),
        },
        select=["TPS006"],
    )
    assert res.findings == [], render_table(res)


def test_tps006_waived(tmp_path):
    res = _lint(
        tmp_path,
        {
            "mod.py": (
                "class C:\n"
                "    def __del__(self):\n"
                "        self._t.join()  # tpusnap: waive=TPS006 daemon\n"
            )
        },
        select=["TPS006"],
    )
    assert res.findings == [] and len(res.waived) == 1


# ---------------------------------------------------------------- TPS007


def test_tps007_undocumented_knob(tmp_path):
    res = _lint(
        tmp_path,
        {"knobs.py": '_FOO = "TPUSNAP_FOO"\n_BAR = "TPUSNAP_BAR"\n'},
        select=["TPS007"],
        api_md="| `TPUSNAP_FOO` | doc |\n",
    )
    assert _rules_of(res) == ["TPS007"]
    assert "TPUSNAP_BAR" in res.findings[0].message


def test_tps007_documented_but_dead_knob(tmp_path):
    res = _lint(
        tmp_path,
        {"knobs.py": '_FOO = "TPUSNAP_FOO"\n'},
        select=["TPS007"],
        api_md="| `TPUSNAP_FOO` | doc |\n| `TPUSNAP_GONE` | doc |\n",
    )
    assert _rules_of(res) == ["TPS007"]
    assert "TPUSNAP_GONE" in res.findings[0].message
    assert res.findings[0].path == "docs/api.md"


def test_tps007_clean_and_missing_docs(tmp_path):
    res = _lint(
        tmp_path,
        {"knobs.py": '_FOO = "TPUSNAP_FOO"\n'},
        select=["TPS007"],
        api_md="| `TPUSNAP_FOO` | doc |\n",
    )
    assert res.findings == []
    # No docs/ directory at all = an installed copy, not a checkout:
    # the drift check skips instead of failing a clean install.
    res = _lint(
        tmp_path / "nodocs",
        {"knobs.py": '_FOO = "TPUSNAP_FOO"\n'},
        select=["TPS007"],
    )
    assert res.findings == []
    # docs/ present but api.md unreadable = a checkout that lost the
    # file: that IS a finding.
    base = tmp_path / "docsonly"
    base.mkdir()
    (base / "docs").mkdir()
    res = _lint(
        base, {"knobs.py": '_FOO = "TPUSNAP_FOO"\n'}, select=["TPS007"]
    )
    assert _rules_of(res) == ["TPS007"]


# ----------------------------------------------- the whole-package gate


def test_whole_package_zero_findings():
    """The port's lint gate: the shipped tree is clean under every rule.
    (Waivers are allowed — they are deliberate, documented exceptions —
    but unwaived findings fail.)"""
    res = run_lint()
    assert res.findings == [], "\n" + render_table(res)
    # sanity: the gate actually scanned the real package
    assert res.files_scanned > 40
    assert set(res.rules_run) == {
        "TPS001", "TPS002", "TPS003", "TPS004", "TPS005", "TPS006", "TPS007"
    }


# ------------------------------------------------------------- CLI gate


def _cli(argv):
    from tpusnap_torch.__main__ import main

    return main(argv)


@pytest.fixture()
def package_copy(tmp_path):
    """A temp copy of the real package + docs, lint-clean by
    construction (asserted), ready for violation seeding."""
    dst = tmp_path / "tpusnap_torch"
    shutil.copytree(
        os.path.join(REPO, "tpusnap_torch"),
        dst,
        ignore=shutil.ignore_patterns("__pycache__", "*.pyc", "*.so", "_build"),
    )
    shutil.copytree(os.path.join(REPO, "docs"), tmp_path / "docs")
    assert _cli(["lint", "--check", "--root", str(dst)]) == 0
    return dst


def test_cli_clean_tree_exits_0(capsys):
    assert _cli(["lint", "--check"]) == 0
    out = capsys.readouterr().out
    assert "0 finding(s)" in out


def test_cli_json_shape(capsys):
    assert _cli(["lint", "--json"]) == 0
    data = json.loads(capsys.readouterr().out)
    assert data["clean"] is True
    assert data["files_scanned"] > 40
    assert isinstance(data["waived"], list)


SEEDS = {
    "TPS001": (
        "analyze.py",
        'import os\n_SEEDED = os.environ.get("TPUSNAP_SEEDED")\n',
    ),
    "TPS002": ("telemetry.py", "import time\n_SEEDED = time.time()\n"),
    "TPS003": ("progress.py", '_SEEDED = ".tpusnap" "/seeded"\n'),
    "TPS004": (
        "comm.py",
        "def _seeded():\n"
        "    try:\n"
        "        raise RuntimeError()\n"
        "    except Exception:\n"
        "        pass\n",
    ),
    "TPS005": (
        "scheduler.py",
        "import time as _seeded_time\n"
        "async def _seeded():\n"
        "    _seeded_time.sleep(0.01)\n",
    ),
    "TPS006": (
        "lifecycle.py",
        "class _Seeded:\n"
        "    def __del__(self):\n"
        "        self._thread.join()\n",
    ),
    "TPS007": ("knobs.py", '_SEEDED_ENV = "TPUSNAP_SEEDED_UNDOCUMENTED"\n'),
}


@pytest.mark.parametrize("rule", sorted(SEEDS))
def test_cli_seeded_violation_exits_2(package_copy, capsys, rule):
    """Each shipped rule actually fires: seed one violation of it into
    a (verified-clean) temp copy and the gate exits 2 naming the rule."""
    relpath, snippet = SEEDS[rule]
    target = package_copy / relpath
    target.write_text(target.read_text() + "\n" + snippet)
    rc = _cli(["lint", "--check", "--root", str(package_copy)])
    out = capsys.readouterr().out
    assert rc == 2, out
    assert rule in out


def test_cli_subprocess_smoke():
    """The real entry point end to end: `python -m tpusnap_torch lint
    --check` on the shipped tree exits 0."""
    proc = subprocess.run(
        [sys.executable, "-m", "tpusnap_torch", "lint", "--check"],
        cwd=REPO,
        capture_output=True,
        text=True,
        env={**os.environ, "JAX_PLATFORMS": "cpu"},
        timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


# ------------------------------------------------------- across packages


def test_both_linters_agree_on_one_seeded_tree(tmp_path):
    """tpusnap's engine and the port's, over one tree holding a violation
    of every rule: the same rule ids at the same files and lines (the
    messages name each package's own modules)."""
    from tpusnap.devtools.lint import run_lint as jax_run_lint

    files = {rel: snippet for rel, snippet in SEEDS.values()}
    files["io_types.py"] = 'SIDECAR_PREFIX = ".tpusnap" "/"\n'
    res = _lint(tmp_path, files, api_md="| `TPUSNAP_DOCUMENTED` | doc |\n")
    theirs = jax_run_lint(package_root=str(tmp_path / "pkg"))

    def key(result):
        return sorted((f.rule, f.path, f.line) for f in result.findings)

    assert key(res) == key(theirs)
    assert set(_rules_of(res)) == set(SEEDS)
