"""Bounded admission control for the serving fleet.

The single-engine ``RolloutEngine.submit`` enqueues without judgment; a
fleet serving mixed traffic cannot — the ROADMAP's "heavy traffic from
millions of users" premise means the steady state is OVERLOAD, and the
only question is who waits, who runs, and who is told no. This module is
that decision, made explicit:

- two priority classes: ``INTERACTIVE`` (a human is watching — editor
  autocomplete, sidebar chat) and ``TRAIN_ROLLOUT`` (GRPO collection —
  throughput matters, latency doesn't), with interactive strictly first
  in dispatch order;
- per-class bounded queues — past the bound the request is shed with a
  typed :class:`Rejected` outcome, never silently dropped (the
  acceptance invariant: every submitted request completes or is
  explicitly rejected);
- per-class token-bucket rate limits (admission-time shed, so a
  misbehaving client can't starve the other class by queue pressure);
- per-request deadlines: a request whose deadline passes while QUEUED is
  shed at the next dispatch scan — deadlines bound queue wait, they do
  not kill in-flight decodes (a dispatched request's tokens are already
  paid for).

Everything takes an injectable monotonic ``now`` so the priority /
deadline tests run on a deterministic fake clock (seeded like
``resilience/chaos.py`` — no sleeps, no wall-clock flakes).
"""

from __future__ import annotations

import dataclasses
import threading
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple

# Priority classes, in strict dispatch order (first = served first).
INTERACTIVE = "interactive"
TRAIN_ROLLOUT = "train_rollout"
PRIORITY_CLASSES: Tuple[str, ...] = (INTERACTIVE, TRAIN_ROLLOUT)

# Rejection reasons carried on the typed outcome.
REJECT_QUEUE_FULL = "queue_full"
REJECT_RATE_LIMITED = "rate_limited"
REJECT_DEADLINE = "deadline"
REJECT_REPLICA_FAILURE = "replica_failure"
REJECT_NO_REPLICAS = "no_replicas"
REJECT_KV_PRESSURE = "kv_pressure"
REJECT_TENANT_RATE = "tenant_rate_limited"


@dataclasses.dataclass(frozen=True)
class Rejected:
    """Typed load-shed outcome — the explicit "no" admission promises.

    ``reason`` is one of the REJECT_* constants; ``detail`` is a human
    string for logs; ``priority`` the class the request was submitted
    under."""

    ticket: int
    priority: str
    reason: str
    detail: str = ""


class RequestRejected(RuntimeError):
    """Raised when a result is demanded for a shed request.

    Carries the :class:`Rejected` outcome so callers that only speak the
    single-engine API (``result()`` returning tokens) still surface the
    shed as a typed error instead of an empty generation."""

    def __init__(self, rejected: Rejected):
        super().__init__(
            f"request {rejected.ticket} rejected: {rejected.reason}"
            + (f" ({rejected.detail})" if rejected.detail else ""))
        self.rejected = rejected


@dataclasses.dataclass
class FleetRequest:
    """One fleet submission, from admission through dispatch to outcome.

    ``deadline`` is ABSOLUTE (clock domain of the fleet's injected
    clock); ``not_before`` is the retry backoff floor the router sets
    after a replica death. Dispatch state (``replica_id``,
    ``engine_rid``, ``version_at_dispatch``) is rewritten on every
    (re)dispatch — a retried request must not carry its dead replica's
    weight version into the mixing assertion."""

    ticket: int
    prompt: List[int]
    max_new_tokens: int
    priority: str = TRAIN_ROLLOUT
    eos_id: Optional[int] = None
    prefix_tokens: Optional[List[int]] = None
    hold_slot: bool = False
    # Multi-tenant serving: the tenant this request decodes for. Drives
    # per-tenant admission fairness, router adapter affinity, and —
    # when the tenant has a published LoRA adapter — which adapter the
    # engine binds at submit. None = anonymous/base traffic.
    tenant_id: Optional[str] = None
    deadline: Optional[float] = None
    submitted_at: float = 0.0
    # -- dispatch state (owned by the fleet) --------------------------------
    attempts: int = 0
    not_before: float = 0.0
    # tokens decoded so far on the current replica — max_new_tokens
    # minus this is the request's REMAINING decode work, the unit the
    # router balances in (reset to 0 on re-dispatch after a death: the
    # partial tokens died with the replica).
    emitted: int = 0
    replica_id: Optional[str] = None
    engine_rid: Optional[int] = None
    version_at_dispatch: Optional[int] = None
    # Stamped by the replica UNDER ITS LOCK at the instant the request
    # is popped from ``inflight`` — the fleet must not re-read
    # ``replica.weight_version`` at completion time, because the
    # publisher may legally swap weights between the pop (zero
    # in-flight) and the fleet's bookkeeping.
    version_at_finish: Optional[int] = None
    first_token_at: Optional[float] = None
    dispatched_at: Optional[float] = None
    # -- timeline provenance (read by the fleet's TimelineRecorder) ----------
    # Stamped by AdmissionQueue.pop_ready at the instant the queue
    # hands the request over — the queue-ownership boundary, measured
    # where it happens rather than inferred at dispatch.
    queue_exit_at: Optional[float] = None
    # Router.pick's reason for its choice ("affinity" | "load").
    routed_by: Optional[str] = None
    # Wall time replica.submit spent inside engine.submit — for a
    # remote replica this is the RPC + remote prefill cost.
    submit_ms: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class ClassPolicy:
    """Admission knobs for one priority class.

    ``rate``/``burst`` parameterize a token bucket (None = unlimited);
    ``default_deadline_s`` applies when the caller passes no deadline
    (None = no deadline)."""

    max_queue: int = 256
    rate: Optional[float] = None          # requests/sec refill
    burst: Optional[float] = None         # bucket capacity (defaults rate)
    default_deadline_s: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class AdmissionConfig:
    interactive: ClassPolicy = ClassPolicy(max_queue=64)
    train_rollout: ClassPolicy = ClassPolicy(max_queue=512)
    # KV-pool pressure watermarks (rollout/kv_pressure.WatermarkGate):
    # the fleet feeds note_kv_pressure() each pump; at >= high the
    # queue gates — new offers shed with REJECT_KV_PRESSURE and
    # dispatch defers — until pressure drains to <= low. Backpressure
    # thus arrives BEFORE BlocksExhausted, and in-flight decodes (whose
    # blocks are already granted) always run to completion.
    kv_pressure_high: float = 0.92
    kv_pressure_low: float = 0.75
    # Per-tenant fairness: every distinct ``tenant_id`` gets its own
    # token bucket at these knobs (None = no per-tenant limiting), so
    # one hot tenant is shed at the door instead of starving the fleet.
    # Checked BEFORE the class bucket — a tenant-shed request must not
    # burn a class token other tenants could have used.
    tenant_rate: Optional[float] = None    # requests/sec per tenant
    tenant_burst: Optional[float] = None   # bucket size (defaults rate)

    def policy(self, priority: str) -> ClassPolicy:
        if priority == INTERACTIVE:
            return self.interactive
        if priority == TRAIN_ROLLOUT:
            return self.train_rollout
        raise ValueError(f"unknown priority class {priority!r} "
                         f"(want one of {PRIORITY_CLASSES})")


class TokenBucket:
    """Standard token bucket on an injectable clock. ``try_take`` is the
    only mutation; refill is computed lazily from elapsed time, so a
    fake clock that jumps forward refills exactly rate×dt."""

    def __init__(self, rate: float, burst: float, *, now: float = 0.0):
        self.rate = float(rate)
        self.burst = float(burst)
        self._tokens = float(burst)
        self._last = now

    def try_take(self, now: float) -> bool:
        self._tokens = min(self.burst,
                           self._tokens + (now - self._last) * self.rate)
        self._last = now
        if self._tokens >= 1.0:
            self._tokens -= 1.0
            return True
        return False


class AdmissionQueue:
    """Per-class bounded queues (EDF within a class) with rate limits
    and deadline shed.

    Not a thread in sight: the fleet serializes access under its own
    lock and supplies ``now`` — this object is pure policy, which is
    what makes the semantics testable on a fake clock."""

    def __init__(self, config: AdmissionConfig = AdmissionConfig(), *,
                 registry=None, now: float = 0.0):
        self.config = config
        self._queues: Dict[str, Deque[FleetRequest]] = {
            p: deque() for p in PRIORITY_CLASSES}
        self._buckets: Dict[str, Optional[TokenBucket]] = {}
        for p in PRIORITY_CLASSES:
            pol = config.policy(p)
            self._buckets[p] = (
                TokenBucket(pol.rate, pol.burst or pol.rate, now=now)
                if pol.rate is not None else None)
        # Per-tenant buckets, created lazily at first offer. Bounded in
        # practice by the tenant population; a bucket is just two
        # floats, so no eviction machinery.
        self._tenant_buckets: Dict[str, TokenBucket] = {}
        if registry is None:
            from ..obs import get_registry
            registry = get_registry()
        self._depth_gauge = registry.gauge(
            "senweaver_serve_queue_depth",
            "Requests admitted but not yet dispatched to a replica.",
            labelnames=("priority",))
        self._shed_total = registry.counter(
            "senweaver_serve_shed_total",
            "Requests shed by admission control (typed Rejected).",
            labelnames=("priority", "reason"))
        self._admitted_total = registry.counter(
            "senweaver_serve_admitted_total",
            "Requests admitted past the queue/rate gates.",
            labelnames=("priority",))
        from ..rollout.kv_pressure import WatermarkGate
        self._kv_gate = WatermarkGate(config.kv_pressure_high,
                                      config.kv_pressure_low)
        self._kv_pressure = 0.0
        self._kv_gated_gauge = registry.gauge(
            "senweaver_serve_kv_gated",
            "1 while admission is gated on KV-pool pressure "
            "(watermark hysteresis), else 0.")
        self._kv_gated_gauge.set(0)
        for p in PRIORITY_CLASSES:      # pre-touch so gauges render at 0
            self._depth_gauge.set(0, priority=p)

    # -- pressure ------------------------------------------------------------
    def note_kv_pressure(self, pressure: float) -> bool:
        """Feed the fleet's KV pool-pressure sample (0..1, worst
        placeable replica). Returns the resulting gate state: True =
        new offers shed and dispatch deferred until pressure drains
        below the low watermark."""
        self._kv_pressure = float(pressure)
        gated = self._kv_gate.update(self._kv_pressure)
        self._kv_gated_gauge.set(1 if gated else 0)
        return gated

    @property
    def kv_gated(self) -> bool:
        return self._kv_gate.gated

    # -- intake --------------------------------------------------------------
    def offer(self, req: FleetRequest, now: float) -> Optional[Rejected]:
        """Admit or shed ``req``. Returns the Rejected outcome on shed
        (queue full / rate limited), None on admission. Applies the
        class default deadline when the request carries none."""
        pol = self.config.policy(req.priority)
        if self._kv_gate.gated:
            # proactive backpressure: the pool is near exhaustion
            # fleet-wide — shed at the door (typed, before any blocks
            # are at stake) rather than let BlocksExhausted preempt
            # someone already decoding
            return self._shed(req, REJECT_KV_PRESSURE,
                              f"kv pool pressure "
                              f"{self._kv_pressure:.2f} >= "
                              f"{self.config.kv_pressure_high:g}")
        # Tenant fairness gate FIRST: a tenant over its budget must be
        # shed before the class bucket is touched, or one hot tenant's
        # rejections would still drain tokens from everyone else.
        if req.tenant_id is not None and self.config.tenant_rate is not None:
            tb = self._tenant_buckets.get(req.tenant_id)
            if tb is None:
                tb = TokenBucket(
                    self.config.tenant_rate,
                    self.config.tenant_burst or self.config.tenant_rate,
                    now=now)
                self._tenant_buckets[req.tenant_id] = tb
            if not tb.try_take(now):
                return self._shed(req, REJECT_TENANT_RATE,
                                  f"tenant {req.tenant_id} over "
                                  f"{self.config.tenant_rate:g} req/s")
        bucket = self._buckets[req.priority]
        if bucket is not None and not bucket.try_take(now):
            return self._shed(req, REJECT_RATE_LIMITED,
                              f"class {req.priority} over "
                              f"{pol.rate:g} req/s")
        q = self._queues[req.priority]
        if len(q) >= pol.max_queue:
            return self._shed(req, REJECT_QUEUE_FULL,
                              f"class {req.priority} queue at "
                              f"{pol.max_queue}")
        if req.deadline is None and pol.default_deadline_s is not None:
            req.deadline = now + pol.default_deadline_s
        q.append(req)
        self._admitted_total.inc(priority=req.priority)
        self._depth_gauge.set(len(q), priority=req.priority)
        return None

    def requeue(self, req: FleetRequest) -> None:
        """Put a retried request back at the FRONT of its class queue —
        it already waited once; backoff is enforced by ``not_before``,
        not by queue position."""
        q = self._queues[req.priority]
        q.appendleft(req)
        self._depth_gauge.set(len(q), priority=req.priority)

    # -- dispatch ------------------------------------------------------------
    def pop_ready(self, now: float) -> Tuple[Optional[FleetRequest],
                                             List[Rejected]]:
        """Next dispatchable request plus any shed because their
        deadline passed while queued.

        Order: strict priority class first; WITHIN a class, earliest
        deadline first (EDF — the queue-wait deadline is the SLO, so
        the request closest to blowing it runs next), deadline-less
        requests after all deadline-bearing ones in FIFO order.
        ``not_before`` backoff is honored: a request inside its retry
        floor is skipped without losing its queue position.

        While the KV-pressure gate is engaged, dispatch DEFERS: already
        -queued requests keep their positions (the deadline sweep still
        runs) and drain once in-flight completions release blocks and
        the gate opens at the low watermark."""
        if self._kv_gate.gated:
            return None, self.shed_expired(now)
        sheds: List[Rejected] = []
        picked: Optional[FleetRequest] = None
        for p in PRIORITY_CLASSES:
            q = self._queues[p]
            keep: List[FleetRequest] = []
            best_key = None
            best_i = -1
            for req in q:
                if req.deadline is not None and now >= req.deadline:
                    sheds.append(self._shed(
                        req, REJECT_DEADLINE,
                        f"queued past deadline "
                        f"(+{now - req.deadline:.3f}s)"))
                    continue
                keep.append(req)
                if req.not_before > now:
                    continue
                key = (req.deadline is None,
                       req.deadline if req.deadline is not None else 0.0,
                       len(keep) - 1)
                if best_key is None or key < best_key:
                    best_key = key
                    best_i = len(keep) - 1
            if best_i >= 0:
                picked = keep.pop(best_i)
                picked.queue_exit_at = now
            if len(keep) != len(q):
                q.clear()
                q.extend(keep)
            self._depth_gauge.set(len(q), priority=p)
            if picked is not None:
                break
        return picked, sheds

    def shed_expired(self, now: float) -> List[Rejected]:
        """Deadline sweep without dispatching (used between pumps while
        every replica is busy — expired requests must not wait for a
        free slot to learn they're dead)."""
        sheds: List[Rejected] = []
        for p in PRIORITY_CLASSES:
            q = self._queues[p]
            keep: List[FleetRequest] = []
            for req in q:
                if req.deadline is not None and now >= req.deadline:
                    sheds.append(self._shed(
                        req, REJECT_DEADLINE,
                        f"queued past deadline "
                        f"(+{now - req.deadline:.3f}s)"))
                else:
                    keep.append(req)
            if len(keep) != len(q):
                q.clear()
                q.extend(keep)
                self._depth_gauge.set(len(q), priority=p)
        return sheds

    def shed_all(self, reason: str, detail: str = "") -> List[Rejected]:
        """Drain every queue into Rejected outcomes (fleet shutdown or
        last-replica death — the none-lost invariant still holds)."""
        sheds: List[Rejected] = []
        for p in PRIORITY_CLASSES:
            q = self._queues[p]
            while q:
                sheds.append(self._shed(q.popleft(), reason, detail))
            self._depth_gauge.set(0, priority=p)
        return sheds

    # -- introspection -------------------------------------------------------
    def depth(self, priority: Optional[str] = None) -> int:
        if priority is not None:
            return len(self._queues[priority])
        return sum(len(q) for q in self._queues.values())

    def stats(self) -> Dict[str, Any]:
        out = {f"queue_depth_{p}": len(self._queues[p])
               for p in PRIORITY_CLASSES}
        out["kv_pressure"] = self._kv_pressure
        out["kv_gated"] = int(self._kv_gate.gated)
        return out

    # -- internals -----------------------------------------------------------
    def _shed(self, req: FleetRequest, reason: str,
              detail: str) -> Rejected:
        self._shed_total.inc(priority=req.priority, reason=reason)
        return Rejected(ticket=req.ticket, priority=req.priority,
                        reason=reason, detail=detail)
