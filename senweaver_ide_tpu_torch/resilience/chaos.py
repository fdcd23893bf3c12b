"""Deterministic fault injection for the training stack.

A :class:`FaultPlan` is a seeded, replayable schedule of failures at
exact ``(round_idx, task_idx, g)`` episode coordinates — the harness the
resilience tests use to PROVE every degraded path end-to-end instead of
hoping a mock raised in the right place. Three episode fault kinds:

- ``raise``      — the episode dies with :class:`ChaosError` before any
                   LLM call (a crashed worker);
- ``hang``       — the episode sleeps ``hang_s`` before proceeding (a
                   wedged engine slot; the boundary's timeout fires);
- ``nan_reward`` — the episode completes but its reward is NaN (the
                   poison propagates through advantages into a NaN loss
                   the update guard must veto).

Coordinates reach the injected session through the episode boundary's
bind protocol: ``collect_group_trajectories`` calls
``session.bind_episode(round_idx, task_idx, g)`` on any session that
exposes it, and :class:`ChaosSession` uses that to consult the plan.
``FaultSpec.times`` counts ATTEMPTS (retries re-bind a fresh session),
so ``times=1`` with retries enabled exercises retry-then-succeed and
``times=2`` with one retry exercises quarantine.

Engine faults ride :class:`ChaosEngine` — ``submit``-call-indexed, for
failures below the session layer (the serving plane dying mid-round).
"""

from __future__ import annotations

import dataclasses
import random
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

EPISODE_FAULT_KINDS = ("raise", "hang", "nan_reward")
ENGINE_FAULT_KINDS = ("raise", "hang")
NETWORK_FAULT_KINDS = ("drop", "drop_response", "delay", "http_500",
                       "partition")


class ChaosError(RuntimeError):
    """A deterministically injected failure (never a real bug)."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scheduled episode fault at exact coordinates."""

    round_idx: int
    task_idx: int
    g: int
    kind: str                   # one of EPISODE_FAULT_KINDS
    times: int = 1              # attempts this fault fires for
    hang_s: float = 30.0        # only for kind="hang"

    def __post_init__(self):
        if self.kind not in EPISODE_FAULT_KINDS:
            raise ValueError(f"unknown episode fault kind {self.kind!r} "
                             f"(want one of {EPISODE_FAULT_KINDS})")


@dataclasses.dataclass(frozen=True)
class EngineFault:
    """One scheduled engine fault, fired on the Nth submit() call."""

    call_idx: int               # 0-based index into submit() calls
    kind: str = "raise"         # one of ENGINE_FAULT_KINDS
    hang_s: float = 30.0

    def __post_init__(self):
        if self.kind not in ENGINE_FAULT_KINDS:
            raise ValueError(f"unknown engine fault kind {self.kind!r} "
                             f"(want one of {ENGINE_FAULT_KINDS})")


class FaultPlan:
    """Seeded, thread-safe schedule of faults; wraps factories/engines.

    The plan is the single source of truth — every injection is consumed
    under a lock and logged to :attr:`injected`, so a test can assert
    exactly which faults fired (and the
    ``senweaver_chaos_faults_injected_total{kind=}`` counter mirrors it
    for live runs)."""

    def __init__(self, faults: Sequence[FaultSpec] = (),
                 engine_faults: Sequence[EngineFault] = (), *,
                 registry=None):
        self.faults = list(faults)
        self.engine_faults = list(engine_faults)
        self._lock = threading.Lock()
        # remaining attempt budget per episode fault (parallel index)
        self._remaining: List[int] = [f.times for f in self.faults]
        self._engine_remaining: Dict[int, EngineFault] = {
            f.call_idx: f for f in self.engine_faults}
        self._submit_calls = 0
        self.injected: List[Tuple[str, Tuple[int, ...]]] = []
        if registry is None:
            from ..obs import get_registry
            registry = get_registry()
        self._injected_total = registry.counter(
            "senweaver_chaos_faults_injected_total",
            "Faults injected by the chaos harness", labelnames=("kind",))

    # -- construction ------------------------------------------------------
    @classmethod
    def sample(cls, seed: int, *, rounds: int, num_tasks: int,
               group_size: int, rate: float = 0.1,
               kinds: Sequence[str] = EPISODE_FAULT_KINDS,
               hang_s: float = 30.0, times: int = 1) -> "FaultPlan":
        """Random-but-replayable plan: each (round, task, g) coordinate
        independently faults with probability ``rate``; the same seed
        always yields the same plan (a local Random — never the global
        one, so test ordering can't perturb it)."""
        rng = random.Random(seed)
        faults = []
        for r in range(rounds):
            for t in range(num_tasks):
                for g in range(group_size):
                    if rng.random() < rate:
                        faults.append(FaultSpec(
                            r, t, g, rng.choice(list(kinds)),
                            times=times, hang_s=hang_s))
        return cls(faults)

    # -- consumption -------------------------------------------------------
    def take(self, round_idx: int, task_idx: int,
             g: int) -> Optional[FaultSpec]:
        """Consume one attempt of the fault at these coordinates (None if
        nothing is scheduled or its budget is spent)."""
        with self._lock:
            for i, f in enumerate(self.faults):
                if ((f.round_idx, f.task_idx, f.g)
                        == (round_idx, task_idx, g)
                        and self._remaining[i] > 0):
                    self._remaining[i] -= 1
                    self.injected.append(
                        (f.kind, (round_idx, task_idx, g)))
                    self._injected_total.inc(kind=f.kind)
                    return f
        return None

    def take_engine(self) -> Optional[EngineFault]:
        with self._lock:
            idx = self._submit_calls
            self._submit_calls += 1
            f = self._engine_remaining.pop(idx, None)
            if f is not None:
                self.injected.append((f"engine_{f.kind}", (idx,)))
                self._injected_total.inc(kind=f"engine_{f.kind}")
            return f

    def injected_counts(self) -> Dict[str, int]:
        with self._lock:
            out: Dict[str, int] = {}
            for kind, _ in self.injected:
                out[kind] = out.get(kind, 0) + 1
            return out

    # -- wrappers ----------------------------------------------------------
    def wrap_factory(self, make_session: Callable) -> Callable:
        """Session factory that returns plan-aware :class:`ChaosSession`
        proxies. Keyword-transparent (``**kwargs`` forwards ``rules=`` /
        ``thread_id=``), so OnlineImprovementLoop's factory-signature
        inspection still sees a thread_id-capable factory."""

        def factory(*args, **kwargs):
            return ChaosSession(make_session(*args, **kwargs), self)

        return factory

    def wrap_reward(self, reward_fn: Callable) -> Callable:
        """Reward override that yields NaN when the episode's session
        carries an active ``nan_reward`` fault — the injection path for
        callers that score via ``reward_override`` (which bypasses the
        trace reward ChaosSession poisons)."""

        def reward(task_idx: int, g: int, session):
            fault = getattr(session, "chaos_fault", None)
            if fault is not None and fault.kind == "nan_reward":
                return float("nan")
            return reward_fn(task_idx, g, session)

        return reward

    def wrap_engine(self, engine) -> "ChaosEngine":
        return ChaosEngine(engine, self)


class ChaosSession:
    """Transparent session proxy that fires the plan's episode faults.

    Delegates everything to the wrapped session; only ``bind_episode``
    (coordinate intake), ``run_turn`` (injection point), and ``close``
    are intercepted. A ``nan_reward`` fault lets the turn complete and
    then poisons ``trace.summary.final_reward`` — the default reward
    path in ``collect_group_trajectories``; callers scoring through a
    ``reward_override`` should wrap it with ``FaultPlan.wrap_reward``.
    """

    def __init__(self, inner, plan: FaultPlan):
        self._inner = inner
        self._plan = plan
        self.chaos_fault: Optional[FaultSpec] = None

    def bind_episode(self, round_idx: int, task_idx: int, g: int) -> None:
        self.chaos_fault = self._plan.take(round_idx, task_idx, g)
        inner_bind = getattr(self._inner, "bind_episode", None)
        if inner_bind is not None:
            inner_bind(round_idx, task_idx, g)

    def run_turn(self, task: str):
        fault = self.chaos_fault
        if fault is not None and fault.kind == "raise":
            raise ChaosError(
                f"injected raise at (r{fault.round_idx}, "
                f"t{fault.task_idx}, g{fault.g})")
        if fault is not None and fault.kind == "hang":
            time.sleep(fault.hang_s)
        out = self._inner.run_turn(task)
        if (fault is not None and fault.kind == "nan_reward"
                and out.trace is not None):
            out.trace.summary.final_reward = float("nan")
        return out

    def close(self) -> None:
        self._inner.close()

    def __getattr__(self, name):
        return getattr(self._inner, name)


@dataclasses.dataclass(frozen=True)
class NetworkFault:
    """One scheduled network fault on the remote-replica transport.

    Matching: ``target`` (the loopback transport's peer name; None = any
    peer) and ``method`` (the rpc method; None = any). ``call_idx``
    selects WHICH matching call fires the fault (0-based index among
    calls that match this spec's filters; None = the first ``times``
    matching calls). Kinds, in increasing nastiness:

    - ``drop``          — the request never reaches the server (refused /
                          reset → ``RpcTransportError``); safe to retry.
    - ``drop_response`` — the server EXECUTES the call but the response
                          is lost (→ ``RpcTimeout``). The dangerous one:
                          a naive retry double-executes; the idempotent
                          request-id cache is what makes it safe.
    - ``delay``         — the response takes ``delay_s``. When that
                          meets or exceeds the caller's timeout this is
                          ``drop_response`` with extra steps (executed,
                          then ``RpcTimeout``); under the timeout it is
                          just latency (a slow-drip host the hedged
                          probes must NOT declare dead).
    - ``http_500``      — the server answers 5xx before executing
                          (→ ``RpcServerError``); safe to retry.
    - ``partition``     — this call and EVERY subsequent call to the
                          target fail with ``RpcTransportError`` until
                          :meth:`NetworkFaultPlan.heal`.
    """

    kind: str                   # one of NETWORK_FAULT_KINDS
    target: Optional[str] = None
    method: Optional[str] = None
    call_idx: Optional[int] = None
    times: int = 1
    delay_s: float = 0.0

    def __post_init__(self):
        if self.kind not in NETWORK_FAULT_KINDS:
            raise ValueError(f"unknown network fault kind {self.kind!r} "
                             f"(want one of {NETWORK_FAULT_KINDS})")


class NetworkFaultPlan:
    """Deterministic schedule of network faults for loopback transports.

    The serve-side twin of :class:`FaultPlan`: each
    ``serve.rpc.LoopbackTransport`` consults :meth:`take` before (and
    for response-loss kinds, after) delivering a call, so the remote-
    fleet chaos tests inject drops, partitions, 5xx, and slow-drip
    latency at exact call coordinates with no sockets and no real time.
    Everything consumed is logged to :attr:`injected` and mirrored on
    ``senweaver_chaos_network_faults_total{kind=}``.
    """

    def __init__(self, faults: Sequence[NetworkFault] = (), *,
                 registry=None):
        self.faults = list(faults)
        self._lock = threading.Lock()
        self._remaining = [f.times for f in self.faults]  # guarded-by: _lock
        # per-fault count of calls that matched its filters so far
        self._seen = [0 for _ in self.faults]             # guarded-by: _lock
        self._partitioned: set = set()                    # guarded-by: _lock
        self.injected: List[Tuple[str, Tuple[str, str]]] = []  # guarded-by: _lock
        if registry is None:
            from ..obs import get_registry
            registry = get_registry()
        self._injected_total = registry.counter(
            "senweaver_chaos_network_faults_total",
            "Network faults injected into the remote-replica transport",
            labelnames=("kind",))

    def partition(self, target: str) -> None:
        """Partition ``target`` immediately (outside any call)."""
        with self._lock:
            self._partitioned.add(target)
            self.injected.append(("partition", (target, "*")))
            self._injected_total.inc(kind="partition")

    def heal(self, target: Optional[str] = None) -> None:
        """Lift the partition on ``target`` (None = all)."""
        with self._lock:
            if target is None:
                self._partitioned.clear()
            else:
                self._partitioned.discard(target)

    def is_partitioned(self, target: str) -> bool:
        with self._lock:
            return target in self._partitioned

    def take(self, target: str, method: str) -> Optional[NetworkFault]:
        """Consume the fault (if any) scheduled for this call. An active
        partition dominates every scheduled fault."""
        with self._lock:
            if target in self._partitioned:
                return NetworkFault(kind="partition", target=target)
            # Every spec's call counter advances on every matching call
            # (even when another spec fires), so a spec's ``call_idx``
            # coordinate never depends on which other faults exist.
            fired: Optional[Tuple[int, NetworkFault]] = None
            for i, f in enumerate(self.faults):
                if f.target is not None and f.target != target:
                    continue
                if f.method is not None and f.method != method:
                    continue
                seen = self._seen[i]
                self._seen[i] += 1
                if f.call_idx is not None and seen != f.call_idx:
                    continue
                if self._remaining[i] <= 0 or fired is not None:
                    continue
                fired = (i, f)
            if fired is None:
                return None
            i, f = fired
            self._remaining[i] -= 1
            if f.kind == "partition":
                self._partitioned.add(target)
            self.injected.append((f.kind, (target, method)))
            self._injected_total.inc(kind=f.kind)
            return f

    def injected_counts(self) -> Dict[str, int]:
        with self._lock:
            out: Dict[str, int] = {}
            for kind, _ in self.injected:
                out[kind] = out.get(kind, 0) + 1
            return out


@dataclasses.dataclass(frozen=True)
class MemoryPressureFault:
    """One scheduled KV-pool squeeze on a paged engine.

    At step ``at_step`` (0-based index of engine.step() calls), the
    plan allocates ``hold_blocks`` REAL blocks from the engine's pool
    and sits on them — a deterministic pool shrink, so the engine's
    pressure ladder (evict → tier → preempt) fires from a genuine
    ``BlocksExhausted``, not a mock. The squat releases at
    ``release_step`` (None = held until :meth:`MemoryPressurePlan.
    release_all`, e.g. at drain). ``hold_blocks`` is clamped to what
    the pool can actually grant — a squeeze never kills the engine."""

    at_step: int
    hold_blocks: int
    release_step: Optional[int] = None

    def __post_init__(self):
        if self.hold_blocks <= 0:
            raise ValueError("hold_blocks must be positive")
        if (self.release_step is not None
                and self.release_step <= self.at_step):
            raise ValueError("release_step must come after at_step")


class MemoryPressurePlan:
    """Deterministic schedule of KV memory-pressure faults.

    The paged-pool twin of :class:`FaultPlan`: :meth:`wrap_engine`
    returns a proxy whose ``step()`` consults the plan by step index,
    squatting and releasing real pool blocks at exact coordinates.
    Everything injected is logged to :attr:`injected` and mirrored on
    ``senweaver_chaos_faults_injected_total{kind="memory_pressure"}``.
    """

    def __init__(self, faults: Sequence[MemoryPressureFault] = (), *,
                 registry=None):
        self.faults = list(faults)
        self._lock = threading.Lock()
        self._fired = [False] * len(self.faults)   # guarded-by: _lock
        # fault index -> squatted block ids (released on schedule)
        self._held: Dict[int, List[int]] = {}      # guarded-by: _lock
        self._steps = 0                            # guarded-by: _lock
        self.injected: List[Tuple[str, Tuple[int, ...]]] = []  # guarded-by: _lock
        if registry is None:
            from ..obs import get_registry
            registry = get_registry()
        self._injected_total = registry.counter(
            "senweaver_chaos_faults_injected_total",
            "Faults injected by the chaos harness", labelnames=("kind",))

    def on_step(self, engine) -> None:
        """Advance the step clock; squat/release blocks due this step.
        Called by the :class:`ChaosEngine` proxy before delegating."""
        alloc = getattr(engine, "_alloc", None)
        with self._lock:
            idx = self._steps
            self._steps += 1
            if alloc is None:
                return                     # slot layout: nothing to squeeze
            for i, f in enumerate(self.faults):
                if (f.release_step is not None and f.release_step == idx
                        and i in self._held):
                    alloc.release(self._held.pop(i))
                if f.at_step == idx and not self._fired[i]:
                    self._fired[i] = True
                    # clamp to grantable so the squeeze pressures the
                    # ladder instead of instantly exhausting the pool
                    n = min(f.hold_blocks, alloc.free_blocks)
                    if n > 0:
                        self._held[i] = alloc.alloc(n)
                    self.injected.append(("memory_pressure", (idx, n)))
                    self._injected_total.inc(kind="memory_pressure")

    def release_all(self, engine) -> None:
        """Give every squatted block back (end of scenario / drain —
        the leak tripwire ``check_leaks`` then owns the pool again)."""
        alloc = getattr(engine, "_alloc", None)
        with self._lock:
            if alloc is not None:
                for blocks in self._held.values():
                    alloc.release(blocks)
            self._held.clear()

    @property
    def holding_blocks(self) -> int:
        with self._lock:
            return sum(len(b) for b in self._held.values())

    def injected_counts(self) -> Dict[str, int]:
        with self._lock:
            out: Dict[str, int] = {}
            for kind, _ in self.injected:
                out[kind] = out.get(kind, 0) + 1
            return out

    def wrap_engine(self, engine) -> "ChaosEngine":
        return ChaosEngine(engine, None, pressure=self)


class ChaosEngine:
    """Engine proxy injecting submit()-indexed faults below the session
    layer (EnginePolicyClient calls submit/step on this transparently).
    Optionally carries a :class:`MemoryPressurePlan` whose step-indexed
    pool squeezes fire inside ``step()``."""

    def __init__(self, inner, plan: Optional[FaultPlan], *,
                 pressure: Optional["MemoryPressurePlan"] = None):
        self._inner = inner
        self._plan = plan
        self._pressure = pressure

    def submit(self, *args, **kwargs):
        if self._plan is not None:
            fault = self._plan.take_engine()
            if fault is not None:
                if fault.kind == "hang":
                    time.sleep(fault.hang_s)
                else:
                    raise ChaosError(
                        f"injected engine raise at submit "
                        f"#{fault.call_idx}")
        return self._inner.submit(*args, **kwargs)

    def step(self, *args, **kwargs):
        if self._pressure is not None:
            self._pressure.on_step(self._inner)
        return self._inner.step(*args, **kwargs)

    def __getattr__(self, name):
        return getattr(self._inner, name)
