"""Runtime lock-order witness: a lock-acquisition-order graph.

Copy of trivy_tpu/analysis/witness.py. The port names its locks as the
reference does (``sched.scheduler._cond``, ...), and reads the same
``TRIVY_TPU_LOCK_WITNESS``; its graph is its own.

Deadlock by lock inversion (thread 1 takes A then B, thread 2 takes B
then A) only materializes under a losing interleaving — a test suite
can pass forever while carrying one.  The witness makes the *order*
observable on ANY interleaving: every named lock records, at acquire
time, an edge from each lock the acquiring thread already holds to the
lock being taken.  A cycle in that graph is a potential deadlock even
if no run ever deadlocked.

Opt-in and zero-cost when off: production modules create their locks
through :func:`make_lock`, which returns the *raw* ``threading``
primitive unchanged unless ``TRIVY_TPU_LOCK_WITNESS=1`` is set at
creation time — the disabled path adds one function call per lock
*creation*, nothing per acquisition (guarded by a tier-1 overhead
test, mirroring the tracing slow-mark guard).

Naming convention (load-bearing — the static companion pass in
``analysis.lockstatic`` derives the same names from the AST so the two
graphs can be unioned): ``<module path under trivy_tpu, dotted>.<attr>``,
e.g. ``sched.scheduler._cond`` for ``self._cond`` in
``trivy_tpu/sched/scheduler.py``.

The pytest conftest enables the witness for the concurrency-marked
suites (sched / fanal / obs / durability) and fails any test that
leaves a cycle in the graph at teardown.

Known boundary: the enable check runs at lock CREATION, so locks
created at import time (module-level ``_CONN_POOL_LOCK``-style
globals, imported during collection before any fixture sets the env)
stay raw under the per-test fixture — only objects constructed inside
an enabled test are witnessed.  Their acquisition order is still
covered by the static ``with``-nesting pass (``analysis.lockstatic``),
whose graph is unioned with the runtime graph in the tier-1 acyclicity
test; for a full-process runtime witness, export
``TRIVY_TPU_LOCK_WITNESS=1`` before interpreter start.

Known boundary: the graph is keyed by lock NAME (one node per lock
*class*, e.g. every journal's ``durability.journal._lock`` is one
node), because names are what the static pass can derive and what an
order discipline is stated over.  Re-entrancy is still distinguished
per INSTANCE — holding journal A's lock while taking journal B's
records every cross-name edge — but the A→B vs B→A inversion *between
two same-named instances* collapses to a single node and is invisible
to both passes.  Code that nests two instances of one lock class must
impose its own tiebreak order (e.g. by id()) and say so at the site.
"""

from __future__ import annotations

import os
import threading

ENV = "TRIVY_TPU_LOCK_WITNESS"


def enabled() -> bool:
    return os.environ.get(ENV, "") not in ("", "0")


class LockWitness:
    """The process-wide acquisition-order graph.

    Thread-held state is a per-thread stack of lock names; edges are
    recorded under one internal leaf lock (never held while acquiring
    a witnessed lock, so the witness itself cannot deadlock)."""

    def __init__(self):
        self._mu = threading.Lock()
        self._edges: dict[str, set[str]] = {}
        self._edge_info: dict[tuple[str, str], str] = {}
        self._tls = threading.local()
        # diagnostics: witnessed-acquisition count, kept as per-thread
        # cells (registered once per thread per generation) so the hot
        # path never touches _mu just to count — a process-global mutex
        # per acquire would serialize the very cross-thread
        # interleavings the witness-enabled tests exist to exercise
        self._counters: list[list[int]] = []
        # bumped by reset(): a thread that outlives a reset (daemon
        # worker parked in Condition.wait across tests) must not leak
        # its pre-reset held-stack into the fresh graph — its stale
        # stack is discarded on first touch (conservative: a held lock
        # from the old generation records no edge, rather than a
        # fabricated cross-test one).  Same idiom as tracing.reset().
        self._gen = 0

    # ------------------------------------------------------ recording

    def _stack(self) -> list[tuple[str, int]]:
        """Per-thread held stack of ``(name, key)`` pairs — key is the
        wrapped primitive's id(), so RLock re-entrancy is recognized per
        INSTANCE while the edge graph stays keyed by name."""
        st = getattr(self._tls, "stack", None)
        if st is None or getattr(self._tls, "gen", -1) != self._gen:
            st = self._tls.stack = []
            cell = self._tls.count = [0]
            self._tls.gen = self._gen
            with self._mu:
                self._counters.append(cell)
        return st

    def push(self, name: str, key: int | None = None) -> None:
        """Record that this thread acquired `name` (call AFTER the real
        acquire succeeds, so a blocked acquire never records)."""
        if key is None:
            key = hash(name)
        st = self._stack()
        self._tls.count[0] += 1
        if not any(k == key for _, k in st):  # re-entrant re-acquire of
            # the SAME instance: no new edges.  A same-named but
            # DISTINCT lock still records edges from every other held
            # name (self-name edges skipped — see module docstring).
            held = {h for h, _ in st if h != name}
            if held:
                thread = threading.current_thread().name
                with self._mu:
                    for h in held:
                        self._edges.setdefault(h, set()).add(name)
                        self._edge_info.setdefault((h, name), thread)
        st.append((name, key))

    def pop(self, name: str, key: int | None = None) -> None:
        if key is None:
            key = hash(name)
        st = self._stack()
        # release order need not be LIFO; drop the most recent entry
        for i in range(len(st) - 1, -1, -1):
            if st[i] == (name, key):
                del st[i]
                return

    # ------------------------------------------------------ inspection

    def edges(self) -> dict[str, set[str]]:
        with self._mu:
            return {a: set(bs) for a, bs in self._edges.items()}

    def acquired_total(self) -> int:
        """Witnessed acquisitions so far — lets tests assert the
        wiring is live even when no two locks ever nested (an empty
        edge set is the GOOD outcome, not proof nothing ran)."""
        with self._mu:
            return sum(c[0] for c in self._counters)

    def edge_thread(self, a: str, b: str) -> str:
        with self._mu:
            return self._edge_info.get((a, b), "")

    def find_cycle(self) -> list[str] | None:
        """A lock-name cycle ``[a, b, ..., a]`` if the witnessed order
        graph has one, else None."""
        return find_cycle(self.edges())

    def reset(self) -> None:
        with self._mu:
            self._edges.clear()
            self._edge_info.clear()
            # surviving threads re-register a fresh cell on first
            # touch via the generation check in _stack()
            self._counters.clear()
            self._gen += 1

    def report(self) -> str:
        """Human-readable graph dump for test-failure messages."""
        lines = []
        for a in sorted(self.edges()):
            for b in sorted(self.edges()[a]):
                lines.append(f"  {a} -> {b}  (first: {self.edge_thread(a, b)})")
        cyc = self.find_cycle()
        if cyc:
            lines.append("  CYCLE: " + " -> ".join(cyc))
        return "lock-order graph:\n" + ("\n".join(lines) or "  (empty)")


def find_cycle(edges: dict[str, set[str]]) -> list[str] | None:
    """DFS cycle search over an adjacency-set graph; returns the cycle
    path ``[a, ..., a]`` or None.  Shared with the static pass so the
    runtime graph, the static graph, and their union all use one
    detector."""
    WHITE, GREY, BLACK = 0, 1, 2
    color: dict[str, int] = {}
    parent: dict[str, str] = {}

    def dfs(node: str) -> list[str] | None:
        color[node] = GREY
        for nxt in sorted(edges.get(node, ())):
            c = color.get(nxt, WHITE)
            if c == GREY:  # back edge: unwind node..nxt
                path = [node]
                while path[-1] != nxt:
                    path.append(parent[path[-1]])
                path.reverse()
                return path + [nxt]
            if c == WHITE:
                parent[nxt] = node
                found = dfs(nxt)
                if found:
                    return found
        color[node] = BLACK
        return None

    for start in sorted(edges):
        if color.get(start, WHITE) == WHITE:
            found = dfs(start)
            if found:
                return found
    return None


WITNESS = LockWitness()


class _WitnessedLock:
    """Wraps Lock/RLock; pushes/pops the witness around the real
    primitive.  Only successful acquisitions record."""

    __slots__ = ("_inner", "_name")

    def __init__(self, name: str, inner):
        self._inner = inner
        self._name = name

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._inner.acquire(blocking, timeout)
        if got:
            WITNESS.push(self._name, id(self._inner))
        return got

    def release(self) -> None:
        self._inner.release()
        WITNESS.pop(self._name, id(self._inner))

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False


class _WitnessedCondition:
    """Wraps Condition.  ``wait`` keeps the lock on the witness stack:
    the thread re-acquires before returning, and treating the wait
    window as held avoids spurious stack churn (lost-wakeup bugs are
    out of scope for an order witness)."""

    __slots__ = ("_inner", "_name")

    def __init__(self, name: str, inner: threading.Condition):
        self._inner = inner
        self._name = name

    def acquire(self, *args) -> bool:
        got = self._inner.acquire(*args)
        if got:
            WITNESS.push(self._name, id(self._inner))
        return got

    def release(self) -> None:
        self._inner.release()
        WITNESS.pop(self._name, id(self._inner))

    def wait(self, timeout: float | None = None) -> bool:
        return self._inner.wait(timeout)

    def wait_for(self, predicate, timeout: float | None = None):
        return self._inner.wait_for(predicate, timeout)

    def notify(self, n: int = 1) -> None:
        self._inner.notify(n)

    def notify_all(self) -> None:
        self._inner.notify_all()

    def __enter__(self):
        self._inner.__enter__()
        WITNESS.push(self._name, id(self._inner))
        return self

    def __exit__(self, *exc):
        WITNESS.pop(self._name, id(self._inner))
        return self._inner.__exit__(*exc)


def make_lock(name: str, lock=None):
    """Name a lock for the witness.

    ``lock`` defaults to a fresh ``threading.Lock()``; pass an RLock or
    Condition to wrap those.  With the witness disabled (the default)
    the primitive is returned UNCHANGED — same object, zero per-acquire
    overhead — so production lock sites can call this unconditionally.
    """
    if lock is None:
        lock = threading.Lock()
    if not enabled():
        return lock
    if isinstance(lock, threading.Condition):
        return _WitnessedCondition(name, lock)
    return _WitnessedLock(name, lock)
