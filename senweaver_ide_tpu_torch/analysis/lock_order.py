"""Dynamic lock-order recorder (a miniature lockdep).

The static pass proves writes happen under *a* lock; it cannot prove
two threads take *two* locks in compatible orders. This recorder does,
at test time: while installed it wraps ``threading.Lock``/``RLock``
construction so every acquire records an edge

    (site of every lock currently held by this thread) → (acquired site)

where a site is the ``file:line`` that CREATED the lock — one node per
creation site, not per instance, so the fleet's N per-replica locks
collapse into one "replica._lock" node and an order inversion between
any two replicas is still a cycle on the graph. A cycle in the graph is
a potential deadlock even if the interleaving never bit during the run
— that is the whole point of recording orders instead of waiting for
the hang.

Intended hierarchy in this codebase (enforced by the serve chaos tests
running under the recorder):

    ServingFleet._lock  →  EngineReplica._lock  →  RolloutEngine._lock
    WeightPublisher._lock  →  EngineReplica._lock

Usage::

    rec = LockOrderRecorder(scope="senweaver_ide_tpu_torch")
    with rec:
        ... multithreaded test body ...
    rec.assert_acyclic()

``scope`` filters by creation-site path substring so library-internal
locks (logging, concurrent.futures) don't pollute the graph; pass
``scope=None`` to instrument everything (used by the seeded-cycle unit
test). Install/uninstall is process-global — hold the recorder for the
duration of one test, not across tests.

Reentrant acquires of the same RLock *instance* are skipped (not an
edge); distinct instances from the same creation site still record, so
a replica→replica inversion would surface as a self-loop on that site.
Self-loops are reported as cycles for plain ``Lock`` sites (guaranteed
self-deadlock) and for cross-instance RLock nesting only when
``strict_self_loops`` is set, because same-site RLock nesting (e.g.
iterating replicas under another replica's lock) is order-undefined.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Set, Tuple


def _creation_site(skip_substrings: Tuple[str, ...]) -> str:
    """file:line of the frame that called Lock()/RLock(), skipping
    threading internals and this module."""
    import sys
    frame = sys._getframe(2)
    while frame is not None:
        fname = frame.f_code.co_filename
        if not any(s in fname for s in skip_substrings):
            return f"{fname}:{frame.f_lineno}"
        frame = frame.f_back
    return "<unknown>:0"        # pragma: no cover


class _InstrumentedLock:
    """Delegating wrapper; must stay duck-typable as a real lock so
    ``threading.Condition(wrapped_lock)`` keeps working."""

    def __init__(self, inner, site: str, recorder: "LockOrderRecorder",
                 reentrant: bool):
        self._inner = inner
        self._site = site
        self._rec = recorder
        self._reentrant = reentrant

    def acquire(self, blocking: bool = True, timeout: float = -1):
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._rec._on_acquire(self)
        return got

    def release(self):
        self._rec._on_release(self)
        return self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self):
        return self._inner.locked()

    def __getattr__(self, name):
        # Dynamic delegation keeps Condition(lock) duck-typing exact:
        # it probes hasattr(lock, "_is_owned") etc. at construction, so
        # the wrapper must raise AttributeError exactly when the inner
        # lock would (RLock has these helpers, plain Lock doesn't).
        return getattr(self._inner, name)

    def __repr__(self):
        return f"<instrumented {self._inner!r} @ {self._site}>"


class LockOrderRecorder:
    """Records the global lock-order graph while installed."""

    _SKIP = ("threading.py", "lock_order.py")

    def __init__(self, scope: Optional[str] = "senweaver_ide_tpu_torch",
                 strict_self_loops: bool = False):
        self.scope = scope
        self.strict_self_loops = strict_self_loops
        # edge -> one witness (held_site, acquired_site, thread name)
        self.edges: Dict[Tuple[str, str], str] = {}
        self._self_loop_ok: Set[str] = set()    # RLock sites
        self._held = threading.local()
        self._graph_lock = threading.Lock()     # created pre-install
        self._orig_lock = None
        self._orig_rlock = None
        self._installed = False

    # -- install / uninstall ----------------------------------------------
    def install(self) -> "LockOrderRecorder":
        if self._installed:
            raise RuntimeError("recorder already installed")
        self._orig_lock = threading.Lock
        self._orig_rlock = threading.RLock
        rec = self

        def make_lock():
            site = _creation_site(rec._SKIP)
            inner = rec._orig_lock()
            if rec.scope is not None and rec.scope not in site:
                return inner
            return _InstrumentedLock(inner, site, rec, reentrant=False)

        def make_rlock():
            site = _creation_site(rec._SKIP)
            inner = rec._orig_rlock()
            if rec.scope is not None and rec.scope not in site:
                return inner
            rec._self_loop_ok.add(site)
            return _InstrumentedLock(inner, site, rec, reentrant=True)

        threading.Lock = make_lock
        threading.RLock = make_rlock
        self._installed = True
        return self

    def uninstall(self) -> None:
        if not self._installed:
            return
        threading.Lock = self._orig_lock
        threading.RLock = self._orig_rlock
        self._installed = False

    def __enter__(self) -> "LockOrderRecorder":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()

    # -- event hooks -------------------------------------------------------
    def _stack(self) -> List["_InstrumentedLock"]:
        if not hasattr(self._held, "stack"):
            self._held.stack = []
        return self._held.stack

    def _on_acquire(self, lock: "_InstrumentedLock") -> None:
        stack = self._stack()
        if lock._reentrant and any(h is lock for h in stack):
            stack.append(lock)      # reentrant re-acquire: no edge
            return
        # get_ident, NOT current_thread(): the latter constructs a
        # _DummyThread (which builds an Event → an instrumented lock →
        # this hook again) when called from an unregistered thread —
        # infinite recursion.
        witness = f"thread-{threading.get_ident()}"
        with self._graph_lock:
            for held in stack:
                if held is lock:
                    continue
                edge = (held._site, lock._site)
                if edge not in self.edges:
                    self.edges[edge] = witness
        stack.append(lock)

    def _on_release(self, lock: "_InstrumentedLock") -> None:
        stack = self._stack()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] is lock:
                del stack[i]
                return

    # -- analysis ----------------------------------------------------------
    def _filtered_edges(self) -> Dict[Tuple[str, str], str]:
        out = {}
        for (a, b), w in self.edges.items():
            if a == b and not self.strict_self_loops \
                    and a in self._self_loop_ok:
                continue        # same-site RLock nesting: see docstring
            out[(a, b)] = w
        return out

    def cycles(self) -> List[List[str]]:
        """Elementary cycles in the recorded order graph (self-loops
        included), as site lists. Empty list ⇔ acyclic ⇔ no potential
        deadlock observed."""
        with self._graph_lock:
            edges = self._filtered_edges()
        adj: Dict[str, Set[str]] = {}
        for a, b in edges:
            adj.setdefault(a, set()).add(b)
            adj.setdefault(b, set())

        out: List[List[str]] = []
        for a, b in edges:
            if a == b:
                out.append([a, a])

        # Tarjan SCC: any SCC with >1 node contains a cycle.
        index: Dict[str, int] = {}
        low: Dict[str, int] = {}
        on_stack: Set[str] = set()
        stack: List[str] = []
        counter = [0]

        def strongconnect(v: str) -> None:
            work = [(v, iter(sorted(adj[v])))]
            index[v] = low[v] = counter[0]
            counter[0] += 1
            stack.append(v)
            on_stack.add(v)
            while work:
                node, it = work[-1]
                advanced = False
                for w in it:
                    if w not in index:
                        index[w] = low[w] = counter[0]
                        counter[0] += 1
                        stack.append(w)
                        on_stack.add(w)
                        work.append((w, iter(sorted(adj[w]))))
                        advanced = True
                        break
                    if w in on_stack:
                        low[node] = min(low[node], index[w])
                if advanced:
                    continue
                work.pop()
                if work:
                    parent = work[-1][0]
                    low[parent] = min(low[parent], low[node])
                if low[node] == index[node]:
                    scc = []
                    while True:
                        w = stack.pop()
                        on_stack.discard(w)
                        scc.append(w)
                        if w == node:
                            break
                    if len(scc) > 1:
                        out.append(sorted(scc))

        for v in sorted(adj):
            if v not in index:
                strongconnect(v)
        return out

    def assert_acyclic(self) -> None:
        cyc = self.cycles()
        if cyc:
            with self._graph_lock:
                edges = self._filtered_edges()
            lines = ["lock-order cycle(s) detected "
                     "(potential deadlock):"]
            for c in cyc:
                lines.append("  cycle: " + " -> ".join(c))
                members = set(c)
                for (a, b), w in sorted(edges.items()):
                    if a in members and b in members:
                        lines.append(f"    {a} -> {b}  "
                                     f"[witness thread {w}]")
            raise AssertionError("\n".join(lines))

    def order_pairs(self) -> List[Tuple[str, str]]:
        """Distinct (held, acquired) site pairs observed, for asserting
        an expected hierarchy in tests."""
        with self._graph_lock:
            return sorted(self.edges)
