"""The port's runtime lock-order watchdog
(``tpusnap_torch.devtools.lockwatch``), mirroring tests/test_lockwatch.py:
cycle detection on a deliberate AB/BA pattern across two threads, trylock
semantics, RLock re-entry, held-across-I/O notes, the global
``threading.Lock`` patch's compatibility with the stdlib synchronization
primitives, and the finalizer-path executor shutdown.

Then what the port adds: two watchdogs in one process (tpusnap's and the
port's, imported in either order, each in a fresh interpreter) give one
graph, one wrapper per lock, and still catch a cycle; the storage hook
reaches the active watch; and the port's gate: the active watch holds no
cycle (the suite runs with ``TPUSNAP_LOCKCHECK=1``, tests/conftest.py).

The synthetic-cycle tests use a PRIVATE :class:`LockOrderWatch` over
``raw_lock()`` primitives so the process's graph stays clean."""

import os
import queue
import subprocess
import sys
import textwrap
import threading
import time

import pytest

from tpusnap_torch.devtools import lockwatch
from tpusnap_torch.devtools.lockwatch import LockOrderWatch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_in_thread(fn):
    t = threading.Thread(target=fn)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()


def test_ab_ba_cycle_two_threads_names_locks_and_sites():
    """The acceptance shape: two threads acquire two locks in opposite
    orders (sequentially — the graph records POTENTIAL deadlocks, no
    lucky schedule needed) and the cycle report names both locks and
    both acquisition sites."""
    watch = LockOrderWatch()
    lock_a = watch.wrap(lockwatch.raw_lock(), "A")
    lock_b = watch.wrap(lockwatch.raw_lock(), "B")

    def thread_one():
        with lock_a:
            with lock_b:  # A -> B
                pass

    def thread_two():
        with lock_b:
            with lock_a:  # B -> A
                pass

    _run_in_thread(thread_one)
    _run_in_thread(thread_two)

    cycles = watch.cycles()
    assert len(cycles) == 1
    assert set(cycles[0]["locks"]) == {"A", "B"}
    # Both edges carry held-at/acquired-at evidence from THIS file.
    for edge in cycles[0]["edges"]:
        assert "test_torch_lockwatch.py:" in edge["held_at"]
        assert "test_torch_lockwatch.py:" in edge["acquired_at"]
    rendered = watch.render()
    assert "CYCLE" in rendered and "A" in rendered and "B" in rendered


def test_consistent_order_is_not_a_cycle():
    watch = LockOrderWatch()
    lock_a = watch.wrap(lockwatch.raw_lock(), "A")
    lock_b = watch.wrap(lockwatch.raw_lock(), "B")
    for _ in range(3):
        with lock_a:
            with lock_b:
                pass
    assert watch.cycles() == []
    assert watch.report()["edges"] == 1


def test_three_lock_cycle_detected():
    """Longer cycles (A→B→C→A) are potential deadlocks too — the SCC
    pass catches what a pairwise AB/BA scan would miss."""
    watch = LockOrderWatch()
    locks = {n: watch.wrap(lockwatch.raw_lock(), n) for n in "ABC"}
    for first, second in [("A", "B"), ("B", "C"), ("C", "A")]:
        with locks[first]:
            with locks[second]:
                pass
    cycles = watch.cycles()
    assert len(cycles) == 1
    assert set(cycles[0]["locks"]) == {"A", "B", "C"}


def test_trylock_adds_no_order_edge():
    """A non-blocking acquire cannot wait, so it cannot deadlock: no
    edge (lockdep's trylock rule) — but the lock still joins the held
    stack, so locks acquired UNDER it do edge from it."""
    watch = LockOrderWatch()
    lock_a = watch.wrap(lockwatch.raw_lock(), "A")
    lock_b = watch.wrap(lockwatch.raw_lock(), "B")
    with lock_a:
        assert lock_b.acquire(blocking=False)  # no A -> B edge
        lock_b.release()
    assert watch.report()["edges"] == 0
    # ...but a blocking acquire under a trylock still records.
    assert lock_a.acquire(blocking=False)
    with lock_b:  # A -> B via blocking acquire under held trylock
        pass
    lock_a.release()
    assert watch.report()["edges"] == 1


def test_rlock_reentry_is_one_hold():
    watch = LockOrderWatch()
    rlock = watch.wrap(lockwatch.raw_rlock(), "R")
    other = watch.wrap(lockwatch.raw_lock(), "L")
    with rlock:
        with rlock:  # re-entry: no self-edge, still one held entry
            with other:
                pass
    report = watch.report()
    assert report["edges"] == 1  # R -> L only
    assert watch.cycles() == []
    assert report["nested_same_site"] == {}


def test_io_hold_recorded_with_site_and_count():
    watch = LockOrderWatch()
    lock_a = watch.wrap(lockwatch.raw_lock(), "A")
    with lock_a:
        watch.note_blocking("storage_write")
        watch.note_blocking("storage_write")
    watch.note_blocking("storage_write")  # nothing held: not recorded
    holds = watch.report()["io_holds"]
    assert len(holds) == 1
    assert holds[0]["lock"] == "A"
    assert holds[0]["tag"] == "storage_write"
    assert holds[0]["count"] == 2
    assert "test_torch_lockwatch.py:" in holds[0]["held_at"]


def test_wrap_dispatches_lock_vs_rlock():
    watch = LockOrderWatch()
    assert isinstance(
        watch.wrap(lockwatch.raw_lock(), "l"), lockwatch.TrackedLock
    )
    assert isinstance(
        watch.wrap(lockwatch.raw_rlock(), "r"), lockwatch.TrackedRLock
    )


# ------------------------------------------------- global install patch


@pytest.fixture()
def global_watch():
    """The process's active watch (the suite runs with TPUSNAP_LOCKCHECK=1,
    installed at package import: the port's own, or tpusnap's that it
    shares); installs a temporary one if the suite was launched with
    lockcheck disabled."""
    watch = lockwatch.active_watch()
    if watch is not None:
        yield watch
        return
    watch = lockwatch.install()
    try:
        yield watch
    finally:
        lockwatch.uninstall()


def test_threading_lock_is_tracked_and_edges_recorded(global_watch):
    # The proxies may be tpusnap's copy of the classes when its watch is
    # the shared one: both carry ``_tracked`` and the watch they feed.
    lock_a = threading.Lock()
    lock_b = threading.RLock()
    assert lock_a._tracked and lock_a._watch is global_watch
    assert lock_b._tracked and lock_b._watch is global_watch
    assert hasattr(lock_b, "_is_owned")  # the reentrant proxy
    with lock_a:
        with lock_b:  # one consistent-order edge; never a cycle
            pass
    edges = global_watch._edges  # keyed by creation site
    assert any(
        "test_torch_lockwatch.py" in a and "test_torch_lockwatch.py" in b
        for (a, b) in edges
    )


def test_stdlib_primitives_survive_the_patch(global_watch):
    """Event/Condition/Queue are built on the patched factories; the
    proxies must keep the Condition protocol (full release across
    wait) consistent or the held stacks go stale."""
    event = threading.Event()
    event.set()
    assert event.wait(0.5)

    q = queue.Queue()
    q.put(42)
    assert q.get(timeout=1) == 42

    cond = threading.Condition()
    woke = []

    def waiter():
        with cond:
            woke.append(cond.wait(timeout=5))

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.05)
    with cond:
        cond.notify_all()
    t.join(timeout=10)
    assert not t.is_alive() and woke == [True]


def test_locked_and_context_protocol(global_watch):
    lock = threading.Lock()
    assert not lock.locked()
    with lock:
        assert lock.locked()
    assert not lock.locked()


def test_finalizer_executor_shutdown_never_waits_on_the_lock():
    """Regression for the watchdog's second catch: a GC finalizer
    calling ``executor.shutdown()`` BLOCKS on ``_shutdown_lock`` and
    can complete an AB/BA deadlock with two ``submit()``s (one holding
    its executor lock waiting for the global shutdown lock, the other
    holding the global lock when GC fires). The finalizer path of
    ``shutdown_plugin_executor`` must trylock: shut down when
    uncontended, skip (leave the executor to the exit reaper) when
    not — never wait."""
    from concurrent.futures import ThreadPoolExecutor

    from tpusnap_torch.io_types import finalizer_close_scope, shutdown_plugin_executor

    # Uncontended: behaves like shutdown(wait=False) — flag set, queued
    # work still completes, no thread join.
    ex = ThreadPoolExecutor(1)
    fut = ex.submit(lambda: 42)
    with finalizer_close_scope():
        shutdown_plugin_executor(ex)
    assert ex._shutdown
    assert fut.result(timeout=10) == 42

    # Contended: returns immediately instead of blocking — the deadlock
    # scenario has another thread holding the shutdown lock forever.
    ex2 = ThreadPoolExecutor(1)
    assert ex2._shutdown_lock.acquire(timeout=5)
    try:
        done = threading.Event()

        def finalizer_path():
            with finalizer_close_scope():
                shutdown_plugin_executor(ex2)
            done.set()

        t = threading.Thread(target=finalizer_path)
        t.start()
        assert done.wait(timeout=10), (
            "finalizer shutdown blocked on a contended _shutdown_lock"
        )
        t.join(timeout=10)
        assert not ex2._shutdown  # skipped, not half-applied
    finally:
        ex2._shutdown_lock.release()
    ex2.shutdown(wait=True)


def test_fs_plugin_close_in_a_finalizer_does_not_join(tmp_path):
    """The fs plugin's close() goes through shutdown_plugin_executor: in a
    finalizer scope it returns while a write is still running (an explicit
    close would wait for it), and the pool still finishes the write."""
    import asyncio

    from tpusnap_torch.io_types import finalizer_close_scope
    from tpusnap_torch.storage_plugins.fs import FSStoragePlugin

    plugin = FSStoragePlugin(str(tmp_path))
    release, started = threading.Event(), threading.Event()

    def slow():
        started.set()
        release.wait(10)
        return "done"

    fut = plugin._get_executor().submit(slow)
    assert started.wait(10)
    done = threading.Event()

    def finalizer_path():
        with finalizer_close_scope():
            asyncio.run(plugin.close())
        done.set()

    t = threading.Thread(target=finalizer_path)
    t.start()
    try:
        assert done.wait(timeout=5), "a finalizer-scope close joined the running write"
    finally:
        release.set()
    t.join(timeout=10)
    assert not t.is_alive()
    assert fut.result(timeout=10) == "done"
    assert plugin._executor is None


def test_storage_hook_notes_a_lock_held_across_io(tmp_path, global_watch):
    """The instrumented storage boundary reports a tracked lock held
    across a payload write into the active watch."""
    import asyncio

    from tpusnap_torch.io_types import WriteIO
    from tpusnap_torch.storage_plugin import InstrumentedStoragePlugin
    from tpusnap_torch.storage_plugins.fs import FSStoragePlugin

    plugin = InstrumentedStoragePlugin(FSStoragePlugin(str(tmp_path)))
    lock = threading.Lock()
    with lock:
        asyncio.run(plugin.write(WriteIO(path="blob", buf=b"x" * 16)))
    asyncio.run(plugin.close())
    holds = global_watch.report()["io_holds"]
    assert any(
        h["tag"] == "storage_write" and "test_torch_lockwatch.py" in h["lock"] for h in holds
    ), holds


# ------------------------------------------- two watchdogs in one process

_TWO_WATCHDOGS = """
import threading, _thread
first, second = {order!r}
import importlib
importlib.import_module(first)
before = threading.Lock()  # created under the first watchdog alone
importlib.import_module(second)
from tpusnap.devtools import lockwatch as jax_lw
from tpusnap_torch.devtools import lockwatch as port_lw

watch = port_lw.active_watch()
assert watch is not None and watch is jax_lw.active_watch(), "two graphs"
after = threading.Lock()
inner = after._lock
assert type(inner) is _thread.LockType, f"wrapped twice: {{inner!r}}"
assert type(after).__module__ == "tpusnap.devtools.lockwatch"
assert before._watch is watch or before._watch._forward is watch

def order(x, y):
    with x:
        with y:
            pass

for x, y in ((before, after), (after, before)):
    t = threading.Thread(target=order, args=(x, y))
    t.start()
    t.join(10)
cycles = watch.cycles()
assert len(cycles) == 1, watch.render()
print("OK", len(cycles))
"""


@pytest.mark.parametrize(
    "order",
    [("tpusnap", "tpusnap_torch"), ("tpusnap_torch", "tpusnap")],
    ids=["tpusnap-first", "port-first"],
)
def test_two_watchdogs_share_one_graph_and_catch_a_cycle(order):
    """Either import order: one watch for both packages, every new lock
    wrapped once, and a cycle between a lock made under the first
    watchdog and one made after the second is still caught."""
    env = {**os.environ, "TPUSNAP_LOCKCHECK": "1", "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(_TWO_WATCHDOGS.format(order=order))],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=240,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "OK 1" in proc.stdout


_SHARE_AND_UNINSTALL = """
import importlib.util, threading
from tpusnap_torch.devtools import lockwatch

assert lockwatch.active_watch() is None and threading.Lock is lockwatch._allocate_lock
spec = importlib.util.spec_from_file_location("_other_lockwatch", lockwatch.__file__)
other = importlib.util.module_from_spec(spec)
spec.loader.exec_module(other)
theirs = other.install()
assert lockwatch.install() is theirs, "did not share the installed watch"
lock = threading.Lock()
assert type(lock) is other.TrackedLock and type(lock._lock) is not other.TrackedLock
lockwatch.uninstall()
assert threading.Lock is other._factories[0], "uninstall removed the other's patch"
other.uninstall()
assert threading.Lock is lockwatch._allocate_lock
print("OK")
"""


def test_install_shares_a_watch_it_finds_and_uninstall_leaves_it():
    """Another copy of the module (a second module object of the same
    source) installed first: install shares its watch and patches
    nothing; uninstall restores nothing it did not patch. In a fresh
    interpreter with lockcheck off, so no watch is active at the start."""
    env = {**os.environ, "TPUSNAP_LOCKCHECK": "0"}
    proc = subprocess.run(
        [sys.executable, "-c", _SHARE_AND_UNINSTALL],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "OK" in proc.stdout


# ---------------------------------------------------------------- the gate


def test_active_watch_holds_no_lock_order_cycle():
    """The port's gate over the suite's lock traffic in this process so
    far (tests/conftest.py's session gate reads tpusnap's watch only; the
    port's locks feed the same graph when both are installed)."""
    watch = lockwatch.active_watch()
    if watch is None:
        pytest.skip("TPUSNAP_LOCKCHECK is off: no watch to gate")
    assert watch.cycles() == [], "\n" + watch.render()
