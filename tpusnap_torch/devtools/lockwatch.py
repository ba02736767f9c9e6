"""Runtime lock-order watchdog (``TPUSNAP_LOCKCHECK=1``).

Vendored from tpusnap/devtools/lockwatch.py. A lock-order bug can hang a
process with no test asserting it: a join reachable from a GC finalizer
re-acquiring ``threading._shutdown_locks_lock`` once hung the test suite.
Static rules (TPS006) pin the known shapes; this module catches
the UNKNOWN ones at runtime: when installed, every ``threading.Lock``/
``threading.RLock`` created afterwards is wrapped in a tracking proxy
that records, per thread, the stack of currently-held locks. Acquiring
lock B while holding lock A adds the directed edge A→B (keyed by the
locks' CREATION sites, so every instance of a class contributes to one
ordering class) with the acquisition sites as evidence. At any point —
and at process exit — the global graph can be checked for cycles: an
A→B plus B→A pair is two threads one unlucky schedule away from a
deadlock, reported with both locks' names and both acquisition sites
instead of a 2 a.m. hang.

Second check: :func:`note_blocking` — called by the storage layer at
every payload I/O — records any tracked lock the calling thread holds
ACROSS storage I/O. Those are latency/starvation hazards (a lock held
for a disk round-trip), reported informationally (``io_holds``), not
gated: some are deliberate coarse-grained op locks.

Semantics and bounds:

- Only locks created AFTER :func:`install` are tracked (the patch
  replaces the ``threading.Lock``/``RLock`` factories; stdlib internals
  using ``_thread.allocate_lock`` directly are untouched, which keeps
  the interpreter's own locking out of both the overhead and the
  graph).
- Overhead is one pure-Python hop + a thread-local list append per
  acquisition, and a dict update only when an edge is first seen.
  Disabled (the default), locks are never wrapped; the only residual
  cost is a no-op ``note_blocking`` call (one None check) at the
  instrumented storage boundary.
- ``RLock`` re-entry does not self-edge; two DIFFERENT locks from the
  same creation site acquired nested are counted separately
  (``nested_same_site``) and excluded from cycle verdicts — same-site
  nesting is usually a container iterating its children, not an
  ordering bug the AB/BA report could name meaningfully.

The test suite runs with ``TPUSNAP_LOCKCHECK=1`` (tests/conftest.py),
and a port test fails on any cycle in the active watch, so every test
doubles as a deadlock detector over the scheduler / staging-pool /
telemetry / comm lock set. Tests that need a deliberately cyclic graph
use a private :class:`LockOrderWatch` over :func:`raw_lock` primitives so
the global graph stays clean.

Two watchdogs in one process. A process that imports both tpusnap and
this package has two copies of this module, and on this Python
``threading.Lock`` is a factory that :func:`install` replaces for the
whole process. The design is ONE graph, ONE wrapper per lock:

- tpusnap's watchdog installed first: :func:`install` finds
  ``threading.Lock`` is neither ``_thread.allocate_lock`` nor its own
  factory, takes the other watch from a probe lock (its proxies carry
  their watch) and SHARES it: it patches nothing, and
  :func:`active_watch` and :func:`note_blocking` use that watch.
- this watchdog installed first, tpusnap's after it: tpusnap's install
  keeps this module's factory as its "original" and wraps what it
  returns. This factory sees that its caller is another copy's factory
  and returns an untracked lock, so the other proxy is the only wrapper;
  this watch then merges the edges it recorded so far into the other
  watch and forwards every later note to it (locks created before the
  hand-over keep reporting into the same graph).
"""

from __future__ import annotations

import _thread
import atexit
import os
import sys
import threading
from typing import Dict, List, Optional, Tuple

__all__ = [
    "LockOrderWatch",
    "TrackedLock",
    "TrackedRLock",
    "active_watch",
    "install",
    "uninstall",
    "note_blocking",
    "raw_lock",
    "raw_rlock",
]

_allocate_lock = _thread.allocate_lock
_allocate_rlock = _thread.RLock

# Diagnostic aid: TPUSNAP_LOCKCHECK_DEBUG=<substr> dumps a full Python
# stack to stderr whenever an order edge is recorded whose HELD node
# contains <substr> — how the "which call path created this edge?"
# question gets answered without guessing.
# tpusnap: waive=TPS001 diagnostic of the lint tooling itself, read once
_DEBUG_NODE = os.environ.get("TPUSNAP_LOCKCHECK_DEBUG")


def _short(path: str) -> str:
    parts = path.replace("\\", "/").split("/")
    return "/".join(parts[-2:])


def _site() -> str:
    """file:line of the nearest frame outside this module and the
    threading machinery — the code that created/acquired the lock."""
    try:
        f = sys._getframe(2)
    except ValueError:  # pragma: no cover - shallow stack
        return "?"
    for _ in range(12):
        if f is None:
            break
        fn = f.f_code.co_filename
        # Fast path: frames from this module share the exact co_filename
        # string; threading.py is matched by basename so a test file
        # named *lockwatch.py / *threading.py is not filtered away.
        if fn != __file__ and os.path.basename(fn) != "threading.py":
            return f"{_short(fn)}:{f.f_lineno}"
        f = f.f_back
    return "?"


class LockOrderWatch:
    """The lock-order graph plus per-thread held stacks. Thread-safe;
    its internal mutex is a raw ``_thread`` lock (invisible to itself)
    and strictly leaf-ordered (never held while acquiring anything)."""

    def __init__(self) -> None:
        self._mu = _allocate_lock()
        self._tls = threading.local()
        # (held_node, acquired_node) -> evidence
        self._edges: Dict[Tuple[str, str], Dict] = {}
        # node -> times a same-site pair was nested (excluded from cycles)
        self._nested_same_site: Dict[str, int] = {}
        # (node, tag) -> evidence for locks held across storage I/O
        self._io_holds: Dict[Tuple[str, str], Dict] = {}
        self._locks_created = 0
        self.enabled = True
        # The other watchdog's watch this one hands its notes to once that
        # watchdog's factory has wrapped this one's (see the module doc).
        self._forward = None

    # --- bookkeeping called by the proxies ----------------------------

    def _held(self) -> List[Tuple[object, str, str]]:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = []
            self._tls.stack = stack
        return stack

    def note_created(self) -> None:
        if self._forward is not None:
            return self._forward.note_created()
        with self._mu:
            self._locks_created += 1

    def hand_over(self, other) -> None:
        """Merge this watch's graph into ``other`` (a watch of another
        copy of this module) and forward every later note and query to
        it."""
        with self._mu:
            edges = {k: dict(v) for k, v in self._edges.items()}
            nested = dict(self._nested_same_site)
            holds = {k: dict(v) for k, v in self._io_holds.items()}
            created = self._locks_created
        with other._mu:
            for key, ev in edges.items():
                mine = other._edges.setdefault(key, dict(ev, count=0))
                mine["count"] += ev["count"]
            for node, n in nested.items():
                other._nested_same_site[node] = other._nested_same_site.get(node, 0) + n
            for key, ev in holds.items():
                mine = other._io_holds.setdefault(key, dict(ev, count=0))
                mine["count"] += ev["count"]
            other._locks_created += created
        self._forward = other

    def note_acquired(
        self, lock: object, node: str, site: str, blocking: bool = True
    ) -> None:
        """``blocking=False`` acquisitions (trylocks) join the held
        stack — locks held BELOW them still matter — but add no
        incoming order edge: a thread that cannot wait cannot deadlock
        (lockdep's trylock rule).

        Reentrancy guard: the dict/list work below ALLOCATES, so GC can
        fire a finalizer mid-note that acquires tracked locks and
        re-enters this watch on the same thread — straight into a
        self-deadlock on the non-reentrant ``_mu``. A per-thread busy
        flag makes the reentrant note a no-op instead (the finalizer's
        acquire goes unrecorded; its release is identity-matched and
        safely finds nothing)."""
        if self._forward is not None:
            return self._forward.note_acquired(lock, node, site, blocking)
        if not self.enabled or getattr(self._tls, "busy", False):
            return
        self._tls.busy = True
        try:
            self._note_acquired(lock, node, site, blocking)
        finally:
            self._tls.busy = False

    def _note_acquired(self, lock, node, site, blocking) -> None:
        held = self._held()
        debug_edges = []
        if held and blocking:
            with self._mu:
                for _, hnode, hsite in held:
                    if hnode == node:
                        self._nested_same_site[node] = (
                            self._nested_same_site.get(node, 0) + 1
                        )
                        continue
                    key = (hnode, node)
                    e = self._edges.get(key)
                    if e is None:
                        self._edges[key] = {
                            "held_site": hsite,
                            "acquire_site": site,
                            "count": 1,
                        }
                    else:
                        e["count"] += 1
                    if _DEBUG_NODE and _DEBUG_NODE in hnode:
                        debug_edges.append((hnode, hsite))
        # Debug dump OUTSIDE the mutex: print_stack allocates (GC can
        # fire a finalizer that re-enters this watch on the same
        # thread), and _mu is a plain non-reentrant lock.
        for hnode, hsite in debug_edges:
            import traceback

            print(
                f"lockwatch DEBUG edge {hnode} -> {node} "
                f"(held at {hsite}, acquiring at {site}):",
                file=sys.stderr,
            )
            traceback.print_stack(file=sys.stderr)
        held.append((lock, node, site))

    def note_released(self, lock: object) -> None:
        if self._forward is not None:
            return self._forward.note_released(lock)
        if not self.enabled:
            return
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] is lock:
                del held[i]
                return

    def note_blocking(self, tag: str) -> None:
        """Record every tracked lock the calling thread holds across a
        blocking region (storage I/O). Same reentrancy guard as
        ``note_acquired``: the evidence dicts allocate, GC can fire a
        finalizer mid-note that re-enters the watch on this thread, and
        ``_mu`` is non-reentrant — so the busy flag must be HELD here,
        not just checked."""
        if self._forward is not None:
            return self._forward.note_blocking(tag)
        if not self.enabled or getattr(self._tls, "busy", False):
            return
        held = self._held()
        if not held:
            return
        self._tls.busy = True
        try:
            with self._mu:
                for _, node, site in held:
                    key = (node, tag)
                    e = self._io_holds.get(key)
                    if e is None:
                        self._io_holds[key] = {"held_site": site, "count": 1}
                    else:
                        e["count"] += 1
        finally:
            self._tls.busy = False

    # --- analysis -----------------------------------------------------

    def cycles(self) -> List[Dict]:
        """Cycles in the lock-order graph, each with the member locks
        and the edge evidence (where each lock was held / acquired).
        Any cycle is a potential deadlock: there exists a schedule in
        which each participant holds one lock and waits for the next."""
        if self._forward is not None:
            return self._forward.cycles()
        with self._mu:
            edges = {k: dict(v) for k, v in self._edges.items()}
        adj: Dict[str, List[str]] = {}
        for a, b in edges:
            adj.setdefault(a, []).append(b)
            adj.setdefault(b, [])

        # Tarjan SCC, iterative.
        index: Dict[str, int] = {}
        low: Dict[str, int] = {}
        onstack: Dict[str, bool] = {}
        stack: List[str] = []
        sccs: List[List[str]] = []
        counter = [0]

        for root in adj:
            if root in index:
                continue
            work: List[Tuple[str, int]] = [(root, 0)]
            while work:
                node, pi = work[-1]
                if pi == 0:
                    index[node] = low[node] = counter[0]
                    counter[0] += 1
                    stack.append(node)
                    onstack[node] = True
                advanced = False
                succs = adj[node]
                for i in range(pi, len(succs)):
                    nxt = succs[i]
                    if nxt not in index:
                        work[-1] = (node, i + 1)
                        work.append((nxt, 0))
                        advanced = True
                        break
                    if onstack.get(nxt):
                        low[node] = min(low[node], index[nxt])
                if advanced:
                    continue
                if low[node] == index[node]:
                    comp = []
                    while True:
                        w = stack.pop()
                        onstack[w] = False
                        comp.append(w)
                        if w == node:
                            break
                    if len(comp) > 1:
                        sccs.append(comp)
                work.pop()
                if work:
                    parent = work[-1][0]
                    low[parent] = min(low[parent], low[node])

        out: List[Dict] = []
        for comp in sccs:
            members = set(comp)
            # Extract one concrete cycle inside the SCC by DFS.
            start = comp[0]
            path = [start]
            seen = {start}
            node = start
            while True:
                nxt = next(
                    (
                        b
                        for a, b in edges
                        if a == node and b in members
                    ),
                    None,
                )
                if nxt is None:  # pragma: no cover - SCC guarantees a succ
                    break
                if nxt == start:
                    break
                if nxt in seen:
                    # Trim to the loop portion.
                    path = path[path.index(nxt):]
                    start = nxt
                    break
                path.append(nxt)
                seen.add(nxt)
                node = nxt
            cyc_edges = []
            for i, a in enumerate(path):
                b = path[(i + 1) % len(path)]
                ev = edges.get((a, b), {})
                cyc_edges.append(
                    {
                        "held": a,
                        "acquired": b,
                        "held_at": ev.get("held_site", "?"),
                        "acquired_at": ev.get("acquire_site", "?"),
                        "count": ev.get("count", 0),
                    }
                )
            out.append({"locks": list(path), "edges": cyc_edges})
        return out

    def report(self) -> Dict:
        if self._forward is not None:
            return self._forward.report()
        cycles = self.cycles()
        with self._mu:
            return {
                "locks_created": self._locks_created,
                "edges": len(self._edges),
                "cycles": cycles,
                "io_holds": [
                    {
                        "lock": node,
                        "tag": tag,
                        "held_at": ev["held_site"],
                        "count": ev["count"],
                    }
                    for (node, tag), ev in sorted(self._io_holds.items())
                ],
                "nested_same_site": dict(self._nested_same_site),
            }

    def render(self) -> str:
        rep = self.report()
        lines = [
            f"lockwatch: {rep['locks_created']} locks tracked, "
            f"{rep['edges']} order edges, {len(rep['cycles'])} cycle(s), "
            f"{len(rep['io_holds'])} lock-across-I/O site(s)"
        ]
        for cyc in rep["cycles"]:
            lines.append(f"  CYCLE: {' -> '.join(cyc['locks'] + [cyc['locks'][0]])}")
            for e in cyc["edges"]:
                lines.append(
                    f"    {e['held']} held at {e['held_at']} while "
                    f"acquiring {e['acquired']} at {e['acquired_at']} "
                    f"(x{e['count']})"
                )
        for h in rep["io_holds"]:
            lines.append(
                f"  io-hold: {h['lock']} (held at {h['held_at']}) across "
                f"{h['tag']} x{h['count']}"
            )
        return "\n".join(lines)

    # --- manual wrapping (tests, explicit instrumentation) ------------

    def wrap(self, lock, name: str) -> "TrackedLock":
        """Wrap an EXISTING raw lock under an explicit node name (the
        synthetic-cycle tests use this over :func:`raw_lock` primitives
        so the global graph is not polluted)."""
        if hasattr(lock, "_is_owned"):
            return TrackedRLock(lock, self, name)
        return TrackedLock(lock, self, name)


class TrackedLock:
    """Tracking proxy over a non-reentrant lock. API-compatible with
    ``threading.Lock`` including use as a ``threading.Condition``
    backing lock (the Condition falls back to acquire/release, both of
    which route through here)."""

    _tracked = True

    def __init__(self, lock, watch: LockOrderWatch, name: str) -> None:
        self._lock = lock
        self._watch = watch
        self.name = name
        watch.note_created()

    def acquire(self, blocking: bool = True, timeout: float = -1):
        ok = self._lock.acquire(blocking, timeout)
        if ok:
            self._watch.note_acquired(
                self, self.name, _site(), blocking=blocking
            )
        return ok

    def release(self) -> None:
        self._lock.release()
        self._watch.note_released(self)

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self):
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    def __getattr__(self, name: str):
        # Passthrough for the long tail of private lock API consumers
        # (e.g. concurrent.futures registers _at_fork_reinit).
        if name == "_lock":
            raise AttributeError(name)
        return getattr(self._lock, name)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<TrackedLock {self.name} wrapping {self._lock!r}>"


class TrackedRLock:
    """Tracking proxy over a reentrant lock. Implements the private
    ``_release_save``/``_acquire_restore``/``_is_owned`` trio so
    ``threading.Condition`` keeps the held-stack consistent across
    ``wait()`` (which fully releases and re-acquires)."""

    _tracked = True

    def __init__(self, lock, watch: LockOrderWatch, name: str) -> None:
        self._lock = lock
        self._watch = watch
        self.name = name
        self._depth = threading.local()
        watch.note_created()

    def _d(self) -> int:
        return getattr(self._depth, "v", 0)

    def acquire(self, blocking: bool = True, timeout: float = -1):
        ok = self._lock.acquire(blocking, timeout)
        if ok:
            d = self._d()
            self._depth.v = d + 1
            if d == 0:
                self._watch.note_acquired(
                    self, self.name, _site(), blocking=blocking
                )
        return ok

    def release(self) -> None:
        self._lock.release()
        d = self._d() - 1
        self._depth.v = d
        if d == 0:
            self._watch.note_released(self)

    def __enter__(self):
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    # Condition protocol (full release across wait()).
    def _is_owned(self) -> bool:
        return self._lock._is_owned()

    def _release_save(self):
        state = self._lock._release_save()
        saved = self._d()
        self._depth.v = 0
        self._watch.note_released(self)
        return (state, saved)

    def _acquire_restore(self, state) -> None:
        inner_state, saved = state
        self._lock._acquire_restore(inner_state)
        self._depth.v = saved
        self._watch.note_acquired(self, self.name, _site())

    def __getattr__(self, name: str):
        if name == "_lock":
            raise AttributeError(name)
        return getattr(self._lock, name)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<TrackedRLock {self.name} wrapping {self._lock!r}>"


# --------------------------------------------------------------- install

_watch: Optional[LockOrderWatch] = None
_own_watch: Optional[LockOrderWatch] = None  # the watch this module's factories feed
_orig_lock = None
_orig_rlock = None
_factories: Tuple = ()  # this module's (Lock, RLock) factories while installed
_adopt_mu = _allocate_lock()
_atexit_registered = False


def raw_lock():
    """An UNTRACKED non-reentrant lock, whether or not a watchdog is
    installed (tests building deliberate cycles in a private watch use
    these so the global graph stays clean)."""
    return _allocate_lock()


def raw_rlock():
    """An UNTRACKED reentrant lock (see :func:`raw_lock`)."""
    return _allocate_rlock()


def active_watch() -> Optional[LockOrderWatch]:
    """The watch the process's lock traffic feeds: this module's, or the
    other watchdog's it shares or handed over to; None when not
    installed."""
    return _watch


def note_blocking(tag: str) -> None:
    """Module-level hook for blocking regions (storage I/O): records
    held tracked locks into the active watch; no-op when the watchdog
    is not installed."""
    w = _watch
    if w is not None:
        w.note_blocking(tag)


def _foreign_watch():
    """The watch behind a tracking factory another copy of this module
    put over ``threading.Lock``: a probe lock from that factory carries
    it. None when ``threading.Lock`` is the original or this module's."""
    if threading.Lock is _allocate_lock or threading.Lock in _factories:
        return None
    return getattr(threading.Lock(), "_watch", None)


def _called_by_foreign_factory() -> bool:
    """This module's factory was called by another copy's factory (which
    kept it as its "original" and wraps what it returns)."""
    code = sys._getframe(2).f_code
    return code.co_filename != __file__ and code.co_name in ("_tracked_lock", "_tracked_rlock")


def _hand_over() -> None:
    """Send this watch's graph and later notes to the other watchdog's
    watch, once (the probe inside comes back here and returns at once)."""
    global _watch
    if not _adopt_mu.acquire(False):
        return
    try:
        own = _own_watch
        if own is None or own._forward is not None:
            return
        other = _foreign_watch()
        if other is not None and other is not own:
            own.hand_over(other)
            _watch = other
    finally:
        _adopt_mu.release()


def install(watch: Optional[LockOrderWatch] = None) -> LockOrderWatch:
    """Patch ``threading.Lock``/``threading.RLock`` so locks created
    from here on are tracked in the (given or fresh) global watch.
    Idempotent: a second install returns the active watch. If another
    copy of this module (tpusnap's) has already patched them, its watch
    is shared and nothing is patched again (see the module doc).

    On Pythons where ``threading.Lock`` is a real TYPE rather than a
    factory function (3.13+), replacing it with a factory would break
    every ``isinstance(x, threading.Lock)`` in stdlib/third-party code
    — so the patch degrades gracefully: the watch is still returned
    (manual ``wrap()`` instrumentation works), but the factories are
    left alone and a single WARNING explains why."""
    global _watch, _own_watch, _orig_lock, _orig_rlock, _factories, _atexit_registered
    if _watch is not None:
        return _watch
    w = watch or LockOrderWatch()
    if isinstance(threading.Lock, type) or isinstance(threading.RLock, type):
        import logging

        logging.getLogger(__name__).warning(
            "TPUSNAP_LOCKCHECK: threading.Lock/RLock are types on this "
            "Python — global lock tracking disabled (isinstance checks "
            "would break); LockOrderWatch.wrap() still works"
        )
        _watch = w
        return w
    if threading.Lock is not _allocate_lock:
        shared = _foreign_watch()
        if shared is None:
            # Patched by something that is not a lock-order watchdog:
            # wrapping its locks again would hide them from it.
            import logging

            logging.getLogger(__name__).warning(
                "TPUSNAP_LOCKCHECK: threading.Lock is already replaced by "
                "%r — standing aside; LockOrderWatch.wrap() still works",
                threading.Lock,
            )
            _watch = w
            return w
        _watch = shared
        return shared
    _orig_lock = threading.Lock
    _orig_rlock = threading.RLock

    def _tracked_lock():
        if _called_by_foreign_factory():
            _hand_over()
            return _orig_lock()
        return TrackedLock(_orig_lock(), w, _site())

    def _tracked_rlock():
        if _called_by_foreign_factory():
            _hand_over()
            return _orig_rlock()
        return TrackedRLock(_orig_rlock(), w, _site())

    threading.Lock = _tracked_lock
    threading.RLock = _tracked_rlock
    _factories = (_tracked_lock, _tracked_rlock)
    _watch = _own_watch = w
    if not _atexit_registered:
        _atexit_registered = True
        atexit.register(_report_at_exit)
    return w


def uninstall() -> None:
    """Restore the real lock factories (when they are still this
    module's) and drop the global watch. Already-created proxies keep
    functioning (their watch reference stays valid; it just stops being
    the active one)."""
    global _watch, _own_watch, _orig_lock, _orig_rlock, _factories
    if _watch is None:
        return
    if _factories and threading.Lock is _factories[0]:
        threading.Lock = _orig_lock
        threading.RLock = _orig_rlock
    _orig_lock = None
    _orig_rlock = None
    _factories = ()
    _watch = _own_watch = None


def _report_at_exit() -> None:
    """Opt-in exit report: WARN loudly when the process's lock traffic
    contained an ordering cycle. stderr (not logging): logging may
    already be shut down during interpreter exit."""
    w = _watch
    if w is None or w is not _own_watch:
        return  # a shared or handed-over watch is the other watchdog's to report
    try:
        cycles = w.cycles()
        if cycles:
            print(
                "tpusnap_torch lockwatch: POTENTIAL DEADLOCK — lock-order "
                "cycle(s) detected:\n" + w.render(),
                file=sys.stderr,
            )
    except Exception:  # pragma: no cover - exit path must never raise
        pass
