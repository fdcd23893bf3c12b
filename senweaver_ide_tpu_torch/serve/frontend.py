"""ServingFleet — N rollout engines behind one submit/result/stream API.

The facade composes the other serve/ pieces into a drop-in SUPERSET of
the single-engine surface (``submit / step / is_done / result /
result_logps / register_prefix / release_slot / update_params / stats /
context_bound``), which is exactly what ``EnginePolicyClient`` and
``OnlineImprovementLoop`` program against — point them at a fleet and
they scale from one engine to N without code changes. On top of that it
adds what only a fleet can have: priority classes and deadlines at
submit, typed :class:`Rejected` outcomes, replica failover, and rolling
weight publication.

Request lifecycle::

    submit() ── admission (bound/rate/deadline) ──┐
        │                                         ├─ Rejected (typed)
        ▼                                         │
    class queue ── pump(): router.pick ───────────┘
        │              │
        │              ▼
        │         replica.submit → decode steps → Completed
        │              │ (replica dies)
        └──── requeue with backoff (resilience shape) ── retries spent ──▶
                                                          Rejected

Drive it either way:

- **manually**: ``step()`` (one pump: publish-roll advance, deadline
  sweep, dispatch, one decode step per replica) — deterministic, what
  the tests and single-threaded callers use; ``run()`` pumps until idle.
- **threaded**: ``start()`` gives every replica its stepper thread and
  the fleet a dispatcher thread — N engines decode concurrently.

Time is an injectable ``clock`` (monotonic seconds) so admission and
retry backoff run on a fake clock in tests.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Sequence, Union

from ..obs.slo import SLOConfig, SLOTracker
from ..obs.timeline import TimelineRecorder
from ..resilience.faults import REASON_ERROR, REASON_TIMEOUT
from .admission import (AdmissionConfig, AdmissionQueue, FleetRequest,
                        REJECT_NO_REPLICAS, REJECT_REPLICA_FAILURE,
                        Rejected, RequestRejected, TRAIN_ROLLOUT)
from .prefix_store import SharedPrefixStore
from .replica import DEAD, EngineReplica, ReplicaDead
from .router import Router
from .rpc import RpcError
from .weights import WeightPublisher


@dataclasses.dataclass(frozen=True)
class Completed:
    """Terminal success outcome for one fleet request."""

    ticket: int
    priority: str
    tokens: List[int]
    logps: List[float]
    replica_id: str
    weight_version: int             # replica version when dispatched
    weight_version_at_finish: int   # and when it finished (must match —
                                    # the no-mixed-versions invariant)
    attempts: int
    ttft_ms: Optional[float]
    e2e_ms: float


class ServingFleet:
    """N EngineReplicas + admission + router + publisher, one facade."""

    def __init__(self, engines: Sequence[Any], *,
                 admission: AdmissionConfig = AdmissionConfig(),
                 clock=time.monotonic,
                 registry=None,
                 max_retries: int = 2,
                 retry_base_delay_s: float = 0.05,
                 retry_max_delay_s: float = 2.0,
                 max_consecutive_faults: int = 3,
                 metrics_service=None,
                 shared_prefix_broadcast: bool = True,
                 probe_interval_s: float = 1.0,
                 host_groups: Optional[Sequence[Optional[str]]] = None,
                 slo: Optional[SLOConfig] = None,
                 peer_id: Optional[str] = None):
        if not engines:
            raise ValueError("a fleet needs at least one engine")
        if host_groups is not None and len(host_groups) != len(engines):
            raise ValueError(
                f"host_groups has {len(host_groups)} entries for "
                f"{len(engines)} engines")
        if registry is None:
            from ..obs import get_registry
            registry = get_registry()
        self.registry = registry
        self.clock = clock
        self.metrics_service = metrics_service
        # host_groups labels engines by rack/host for the prefix
        # store's one-donor-per-host fanout; None entries (and wrapped
        # EngineReplica instances, which carry their own label) keep
        # the every-replica-its-own-host default.
        self.replicas: List[EngineReplica] = [
            e if isinstance(e, EngineReplica) else EngineReplica(
                f"replica-{i}", e,
                max_consecutive_faults=max_consecutive_faults,
                host_group=(host_groups[i] if host_groups else None),
                registry=registry)
            for i, e in enumerate(engines)]
        self.admission = AdmissionQueue(admission, registry=registry,
                                        now=clock())
        self.router = Router(self.replicas, max_retries=max_retries,
                             retry_base_delay_s=retry_base_delay_s,
                             retry_max_delay_s=retry_max_delay_s,
                             registry=registry)
        self.publisher = WeightPublisher(self.replicas, registry=registry)
        # Fleet prefix ids + the one-prefill broadcast protocol. The
        # store sees ``self.replicas`` by reference, so add_replica'd
        # members participate; a publisher begin() invalidates every
        # shared entry (stale pids raise KeyError at submit, mirroring
        # engine semantics so auto_prefix clients re-register).
        self.prefix_store = SharedPrefixStore(
            self.replicas, self.publisher, registry=registry,
            enabled=shared_prefix_broadcast)
        self._lock = threading.RLock()
        self._next_ticket = 0                   # guarded-by: _lock
        self._requests: Dict[int, FleetRequest] = {}    # guarded-by: _lock
        self._outcomes: Dict[int, Union[Completed, Rejected]] = {}  # guarded-by: _lock
        self._dispatcher: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._requests_total = registry.counter(
            "senweaver_serve_requests_total",
            "Requests submitted to the fleet.",
            labelnames=("priority",))
        self._completed_total = registry.counter(
            "senweaver_serve_completed_total",
            "Requests completed by the fleet.",
            labelnames=("priority",))
        self._shed_total = registry.counter(
            "senweaver_serve_shed_total",
            "Requests shed by admission control (typed Rejected).",
            labelnames=("priority", "reason"))
        self._ttft_ms = registry.histogram(
            "senweaver_serve_ttft_ms",
            "Submit-to-first-token latency (ms).",
            labelnames=("priority",))
        self._e2e_ms = registry.histogram(
            "senweaver_serve_e2e_ms",
            "Submit-to-completion latency (ms).",
            labelnames=("priority",))
        self._replicas_live = registry.gauge(
            "senweaver_serve_replicas_live",
            "Replicas not DEAD.")
        self._replicas_live.set(len(self.replicas))
        # Fleet KV pool pressure: min over placeable (accepting)
        # replicas — if ANY replica still has block headroom the fleet
        # can route there, so that is the honest backpressure signal.
        # Admission watermarks and the autoscaler both read this.
        self._kv_pressure_gauge = registry.gauge(
            "senweaver_kv_pressure",
            "Fleet KV pool pressure (0..1): the least-pressured "
            "placeable replica's block-pool utilization.")
        self._kv_pressure_gauge.set(0.0)
        self._group_submits = registry.counter(
            "senweaver_serve_group_submits_total",
            "GRPO groups dispatched through the replica-local "
            "shared-prefill path (one prefill, KV forked on-replica).")
        self._group_degrades = registry.counter(
            "senweaver_serve_group_degrades_total",
            "GRPO groups that fell back to independent per-member "
            "submits (no live replica with a group-capable engine).")
        self._continuation_replays = registry.counter(
            "senweaver_serve_continuation_replays_total",
            "Held-slot turn continuations replayed on a survivor after "
            "their replica died (full re-prefill of the transcript "
            "instead of the ValueError fallback).")
        # Hedged health probing of replicas that support it (remote
        # ones); local replicas have no probe() and are skipped.
        self.probe_interval_s = float(probe_interval_s)
        self._last_probe_at: Optional[float] = None  # guarded-by: _lock
        # Optional admission-driven autoscaler (attach_autoscaler);
        # evaluated once per pump, inside the fleet lock.
        self.autoscaler = None                       # guarded-by: _lock
        # Optional live-migration plane (attach_migration): a
        # MigrationCoordinator pumped right after the autoscaler, so
        # pressure offers and eager-publish relief act on this pump's
        # signals.
        self.migrator = None                         # guarded-by: _lock
        # Request-level SLO layer: milestone timelines feeding the
        # per-priority seconds histograms, violation counters, and the
        # K-worst exemplar ring (always on — dict writes per request).
        # peer_id names THIS process in the federated fleet — stamped
        # into timelines/exemplars so incident stitching can attribute
        # them, and used as the scrape identity when federated.
        self.peer_id = peer_id
        self.slo = SLOTracker(slo, registry=registry, peer_id=peer_id)
        self.timelines = TimelineRecorder(clock=clock, slo=self.slo,
                                          registry=registry,
                                          peer_id=peer_id)
        # Optional fleet observability plane (attach_federation):
        # a MetricsFederator polled once per pump + an AlertManager
        # evaluated right after, so federated rollups are fresh for
        # both the alert rules and the autoscaler.
        self.federation = None                       # guarded-by: _lock
        self.alerts = None                           # guarded-by: _lock
        # Open publish-pause window (begin seen, roll not converged) —
        # closed windows are pushed onto the timeline recorder so a
        # finished request knows how much of its e2e was publish pause.
        self._publish_started_at: Optional[float] = None  # guarded-by: _lock
        # Exact window edges: the publisher fires these on the very
        # begin/land transitions (the pump's polling calls below are a
        # no-op backstop once these have run).
        self.publisher.subscribe_begin(
            lambda _v: self._track_publish_window(self.clock()))
        self.publisher.subscribe_end(
            lambda _v: self._track_publish_window(self.clock()))

    # -- single-engine API superset ------------------------------------------
    @property
    def context_bound(self) -> int:
        """Longest servable context — the most conservative replica's
        bound (a request must be servable wherever routing lands it)."""
        return min(int(getattr(r.engine, "context_bound", 1 << 30))
                   for r in self.replicas)

    @property
    def num_slots(self) -> int:
        return sum(r.capacity for r in self.replicas)

    def submit(self, prompt: List[int], *, max_new_tokens: int = 128,
               priority: str = TRAIN_ROLLOUT,
               deadline_s: Optional[float] = None,
               prefix_id: Optional[int] = None,
               eos_id: Optional[int] = None,
               hold_slot: bool = False,
               continue_from: Optional[int] = None,
               tenant_id: Optional[str] = None) -> int:
        """Admit a generation request; returns a fleet ticket.

        Sheds (queue full / rate limit) are NOT exceptions: the ticket's
        outcome is a typed :class:`Rejected` and ``is_done`` is
        immediately True — the caller always gets an answer. KeyError
        (stale ``prefix_id`` after a weight publish) and ValueError (bad
        continuation) match engine semantics so ``EnginePolicyClient``'s
        recovery paths work unchanged."""
        with self._lock:
            now = self.clock()
            ticket = self._next_ticket
            self._next_ticket += 1
            self._requests_total.inc(priority=priority)
            if continue_from is not None:
                return self._submit_continuation(
                    ticket, prompt, max_new_tokens=max_new_tokens,
                    eos_id=eos_id, hold_slot=hold_slot,
                    continue_from=continue_from, priority=priority)
            prefix_tokens = None
            if prefix_id is not None:
                entry = self.prefix_store.lookup(prefix_id)
                if entry is None:
                    raise KeyError(
                        f"unknown or stale fleet prefix_id {prefix_id}")
                prefix_tokens = list(entry.tokens)
                if prompt[:len(prefix_tokens)] != prefix_tokens:
                    raise ValueError(
                        "prompt does not start with the registered "
                        f"prefix (prefix_id {prefix_id})")
            req = FleetRequest(
                ticket=ticket, prompt=list(prompt),
                max_new_tokens=max_new_tokens, priority=priority,
                eos_id=eos_id, prefix_tokens=prefix_tokens,
                hold_slot=hold_slot, tenant_id=tenant_id,
                deadline=None if deadline_s is None else now + deadline_s,
                submitted_at=now)
            self._requests[ticket] = req
            self.timelines.begin(ticket, priority, now)
            rejected = self.admission.offer(req, now)
            if rejected is not None:
                self._outcomes[ticket] = rejected
                self.timelines.finish_rejected(ticket, now,
                                               reason=rejected.reason)
            return ticket

    def submit_group(self, prompt: List[int], group_size: int, *,
                     max_new_tokens: int = 128,
                     priority: str = TRAIN_ROLLOUT,
                     eos_id: Optional[int] = None,
                     tenant_id: Optional[str] = None) -> List[int]:
        """GRPO group submit: ``group_size`` decodes of one shared
        prompt, dispatched to ONE router-picked replica so the engine's
        shared-prefill path applies (one prefill, KV block tables
        forked replica-locally — fork sharing never crosses a replica
        boundary, and a migration checkpoint of any member gathers an
        unshared payload, so per-leaf migration stays legal). Group
        submits are the training plane's own rollouts and dispatch
        immediately, like continuations; when no live replica offers a
        group-capable engine, members degrade to ``group_size``
        independent submits through normal admission — slower, never
        inexact. Returns one fleet ticket per member, donor first."""
        if group_size < 1:
            raise ValueError(f"group_size {group_size} < 1")
        with self._lock:
            now = self.clock()
            reqs: List[FleetRequest] = []
            for _ in range(group_size):
                ticket = self._next_ticket
                self._next_ticket += 1
                self._requests_total.inc(priority=priority)
                req = FleetRequest(
                    ticket=ticket, prompt=list(prompt),
                    max_new_tokens=max_new_tokens, priority=priority,
                    eos_id=eos_id, tenant_id=tenant_id,
                    submitted_at=now)
                self._requests[ticket] = req
                self.timelines.begin(ticket, priority, now)
                reqs.append(req)
            tickets = [r.ticket for r in reqs]
            replica = self.router.pick(reqs[0])
            if (replica is not None
                    and hasattr(replica, "submit_group")
                    and hasattr(replica.engine, "submit_group")):
                try:
                    replica.submit_group(reqs)
                except (ValueError, KeyError, RpcError, ReplicaDead):
                    pass    # degrade below — members still dispatch
                else:
                    for req in reqs:
                        req.dispatched_at = now
                        self.timelines.mark(
                            req.ticket, "dispatched", now,
                            replica=replica.replica_id, group=True)
                    self._group_submits.inc()
                    return tickets
            self._group_degrades.inc()
            for req in reqs:
                rejected = self.admission.offer(req, now)
                if rejected is not None:
                    self._outcomes[req.ticket] = rejected
                    self.timelines.finish_rejected(
                        req.ticket, now, reason=rejected.reason)
            return tickets

    def _submit_continuation(self, ticket: int, prompt: List[int], *,
                             max_new_tokens: int, eos_id: Optional[int],
                             hold_slot: bool, continue_from: int,
                             priority: str) -> int:
        # guarded-by: caller
        """Turn continuation: pinned to the replica holding the slot's
        KV, dispatched immediately (it extends a conversation that
        already passed admission).

        When the holding replica is dead/gone (or alive but its slot is
        lost — e.g. the id was resurrected under a fresh engine), the
        conversation is NOT lost: the engine's continuation contract
        passes the FULL token stream, so ``prompt`` is the complete
        transcript — the fleet re-prefills it on a survivor and re-pins
        the ticket there (``senweaver_serve_continuation_replays_total``).
        ValueError only when no survivor can take it — the same contract
        as the engine, so clients still have their full-prefill
        fallback."""
        prev = self._requests.get(continue_from)
        if prev is None or prev.replica_id is None:
            raise ValueError(
                f"continue_from={continue_from}: unknown ticket")
        replica = next((r for r in self.replicas
                        if r.replica_id == prev.replica_id), None)
        now = self.clock()
        req = FleetRequest(
            ticket=ticket, prompt=list(prompt),
            max_new_tokens=max_new_tokens, priority=priority,
            eos_id=eos_id, hold_slot=hold_slot, submitted_at=now)
        if replica is not None and replica.state != DEAD:
            try:
                rid = replica.engine.submit(
                    prompt, max_new_tokens=max_new_tokens,
                    continue_from=prev.engine_rid, hold_slot=hold_slot,
                    eos_id=eos_id)
            except (ValueError, KeyError, RpcError):
                # The slot is gone even though the replica id answers
                # (fresh engine behind a resurrected id), or a remote
                # holder is unreachable: survivor replay below.
                replica = None
            else:
                self._requests[ticket] = req
                replica.adopt(rid, req)
                req.dispatched_at = now
                self.timelines.begin(ticket, priority, now)
                self.timelines.mark(ticket, "dispatched", now,
                                    replica=replica.replica_id,
                                    continuation=True)
                return ticket
        # Survivor replay: full re-prefill of the recorded transcript,
        # slot re-held on whichever live replica the router picks.
        survivor = self.router.pick(req)
        if survivor is None:
            raise ValueError(
                f"continue_from={continue_from}: replica "
                f"{prev.replica_id} is gone and no survivor accepts; "
                f"slot released")
        kwargs = dict(max_new_tokens=max_new_tokens,
                      hold_slot=hold_slot, eos_id=eos_id)
        if getattr(survivor.engine, "supports_idempotency", False):
            kwargs["idempotency_key"] = f"cont-{ticket}"
        rid = survivor.engine.submit(list(prompt), **kwargs)
        self._requests[ticket] = req
        survivor.adopt(rid, req)
        req.dispatched_at = now
        self._continuation_replays.inc()
        self.timelines.begin(ticket, priority, now)
        self.timelines.mark(ticket, "dispatched", now,
                            replica=survivor.replica_id,
                            continuation=True)
        self.timelines.event(ticket, "continuation_replay", now,
                             source=prev.replica_id,
                             replica=survivor.replica_id)
        return ticket

    def register_prefix(self, tokens: List[int]) -> int:
        """Fleet-level prefix id. The KV materializes at first dispatch
        via the one-prefill broadcast: the picked replica prefills ONCE
        and the store installs its buffer into every other live replica
        (device-to-device copy), so the whole fleet is warm — the
        router's prefix affinity becomes a tiebreak, not a necessity.
        Invalidated by the next weight publish — submit() raises
        KeyError then, and auto_prefix clients re-register."""
        with self._lock:
            return self.prefix_store.register(tokens)

    def is_done(self, ticket: int) -> bool:
        with self._lock:
            self._require(ticket)
            return ticket in self._outcomes

    def outcome(self, ticket: int
                ) -> Optional[Union[Completed, Rejected]]:
        with self._lock:
            self._require(ticket)
            return self._outcomes.get(ticket)

    def result(self, ticket: int) -> List[int]:
        """Tokens so far (live view while decoding, final list once
        completed). Raises :class:`RequestRejected` for shed requests —
        a typed error, never a silently empty generation."""
        with self._lock:
            out = self._outcomes.get(ticket)
            if isinstance(out, Completed):
                return list(out.tokens)
            if isinstance(out, Rejected):
                raise RequestRejected(out)
            req = self._require(ticket)
            if req.engine_rid is not None and req.replica_id is not None:
                replica = self._replica_by_id(req.replica_id)
                if replica is not None and replica.state != DEAD:
                    return replica.engine.result(req.engine_rid)
            return []

    def result_logps(self, ticket: int) -> List[float]:
        with self._lock:
            out = self._outcomes.get(ticket)
            if isinstance(out, Completed):
                return list(out.logps)
            if isinstance(out, Rejected):
                raise RequestRejected(out)
            req = self._require(ticket)
            if req.engine_rid is not None and req.replica_id is not None:
                replica = self._replica_by_id(req.replica_id)
                if replica is not None and replica.state != DEAD:
                    return replica.engine.result_logps(req.engine_rid)
            return []

    def release_slot(self, ticket: int) -> None:
        """Free a held decode slot (turn continuation ended)."""
        with self._lock:
            req = self._requests.get(ticket)
            if req is None or req.replica_id is None \
                    or req.engine_rid is None:
                return
            replica = self._replica_by_id(req.replica_id)
            if replica is not None and replica.state != DEAD:
                replica.engine.release_slot(req.engine_rid)

    # -- pump ----------------------------------------------------------------
    def step(self) -> Dict[int, List[int]]:
        """One scheduling + decode round; returns {ticket: [tokens]}
        emitted this step (the engine.step contract, ticket-keyed)."""
        with self._lock:
            now = self.clock()
            self.publisher.advance()
            self._track_publish_window(now)
            self._reap_quarantined(now)
            self._probe_replicas(now)
            self._note_kv_pressure()
            for rej in self.admission.shed_expired(now):
                self._record_rejection(rej)
            self._pump_federation(now)
            if self.autoscaler is not None:
                self.autoscaler.evaluate(now)
            if self.migrator is not None:
                self.migrator.pump(now)
            self._dispatch(now)
            emitted_by_ticket: Dict[int, List[int]] = {}
            for replica in list(self.replicas):
                if replica.state == DEAD or not replica.has_work():
                    continue
                try:
                    emitted, done = replica.step()
                except Exception:
                    self._record_fault(replica, now)
                    continue
                self._ingest(replica, emitted, done, emitted_by_ticket)
            return emitted_by_ticket

    def run(self) -> Dict[int, List[int]]:
        """Pump until every submitted request has an outcome. Returns
        {ticket: tokens} for the COMPLETED ones (rejected tickets carry
        their outcome, reachable via ``outcome()``)."""
        while self.pending():
            self.step()
        with self._lock:
            return {t: list(o.tokens)
                    for t, o in self._outcomes.items()
                    if isinstance(o, Completed)}

    def pending(self) -> int:
        with self._lock:
            return len(self._requests) - len(self._outcomes)

    def stream(self, ticket: int) -> Iterator[int]:
        """Yield ``ticket``'s tokens as they decode, pumping the fleet
        (manual mode) until the request finishes."""
        sent = 0
        while True:
            done = self.is_done(ticket)
            toks = self.result(ticket)      # raises if rejected
            while sent < len(toks):
                yield toks[sent]
                sent += 1
            if done:
                return
            self.step()

    # -- weights -------------------------------------------------------------
    def update_params(self, params, *, epoch: Optional[int] = None,
                      version: Optional[int] = None) -> int:
        """Versioned rolling publish (the ``engine.update_params``
        drop-in the online loop calls). Blocks until every live replica
        serves the new version, pumping the fleet meanwhile — serving
        never stops, generations never mix versions.

        ``(epoch, version)`` is the optional fencing token (see
        :meth:`WeightPublisher.begin`); a stale pair raises
        :class:`~.weights.StalePublishError` without touching any
        replica."""
        v = self.begin_publish(params, epoch=epoch, version=version)
        if self._dispatcher is not None:
            # Threaded mode: the dispatcher pumps the roll forward.
            while self.publisher.in_progress:
                time.sleep(0.001)
        else:
            while self.publisher.in_progress:
                self.step()
        return v

    def begin_publish(self, params, *, epoch: Optional[int] = None,
                      version: Optional[int] = None,
                      eager: bool = False) -> int:
        """Stage a fenced publish WITHOUT blocking on the roll — the
        learner-gateway path: the fleet's own pump (manual ``step()``
        or the dispatcher thread) rolls it forward while the learner
        polls convergence over rpc. ``eager=True`` requests the
        no-drain roll (replicas swap opportunistically at zero
        in-flight; see :meth:`WeightPublisher.begin`) — the streaming
        learner's default, so collection never pauses for a publish."""
        with self._lock:
            v = self.publisher.begin(params, epoch=epoch,
                                     version=version, eager=eager)
            self._track_publish_window(self.clock())
            return v

    def publish_draft(self, params, *, epoch: Optional[int] = None,
                      version: Optional[int] = None) -> int:
        """Publish speculation-DRAFT weights to every live replica
        (the online distiller's fleet entry point). Same
        ``(epoch, version)`` fence as :meth:`update_params`, but
        applied immediately — no drain, because draft weights only
        move the acceptance rate, never the outputs."""
        with self._lock:
            return self.publisher.publish_draft(params, epoch=epoch,
                                                version=version)

    def publish_adapter(self, tenant_id: str, lora, *,
                        epoch: Optional[int] = None,
                        version: Optional[int] = None) -> int:
        """Publish one tenant's LoRA adapter to every live replica
        (the per-tenant learner's fleet entry point). Same
        ``(epoch, version)`` fence as :meth:`begin_publish`, but
        applied immediately with no drain: adapter versions bind at
        submit time, so in-flight decodes — including this tenant's —
        finish untouched and only the tenant's next requests see the
        new version. Other tenants never notice."""
        with self._lock:
            return self.publisher.publish_adapter(
                tenant_id, lora, epoch=epoch, version=version)

    @property
    def threaded(self) -> bool:
        """True when the dispatcher thread owns the pump (start()ed)."""
        return self._dispatcher is not None

    # -- chaos / operations --------------------------------------------------
    def add_replica(self, engine, *,
                    replica_id: Optional[str] = None,
                    host_group: Optional[str] = None) -> EngineReplica:
        """Grow the fleet with a new (or resurrected) replica. The
        engine must already hold the CURRENT published params — the
        fleet stamps it with the publisher's version rather than
        replaying the publish. Shared prefixes are NOT pushed eagerly;
        the store backfills on the replica's first prefix-bearing
        dispatch (the lazy half of the broadcast protocol)."""
        with self._lock:
            if replica_id is None:
                replica_id = f"replica-{len(self.replicas)}"
            existing = self._replica_by_id(replica_id)
            if existing is not None:
                if existing.state != DEAD:
                    raise ValueError(f"replica id {replica_id!r} taken")
                # Resurrection: the id's previous incarnation is DEAD —
                # drop the carcass from every membership list (fleet,
                # router load tracking, publisher roll set) and from the
                # prefix store's installed sets, so the new engine is
                # lazily backfilled instead of assumed warm.
                self.replicas.remove(existing)
                self.router.replicas.remove(existing)
                if existing in self.publisher.replicas:
                    self.publisher.replicas.remove(existing)
                self.prefix_store.forget_replica(replica_id)
            replica = (engine if isinstance(engine, EngineReplica)
                       else EngineReplica(replica_id, engine,
                                          host_group=host_group,
                                          registry=self.registry))
            # Through the replica's own locked mutator: weight_version
            # is guarded by replica._lock, not ours (analysis LOCK102).
            replica.stamp_version(self.publisher.version)
            if self.migrator is not None \
                    and hasattr(replica.engine, "migrate_on_pressure"):
                replica.engine.migrate_on_pressure = True
            # router and publisher hold their own list copies; the
            # prefix store shares self.replicas by reference.
            self.replicas.append(replica)
            self.router.replicas.append(replica)
            self.publisher.replicas.append(replica)
            self._replicas_live.set(
                sum(r.state != DEAD for r in self.replicas))
        if self._dispatcher is not None:        # threaded mode
            replica.start(self._on_replica_step)
        return replica

    def attach_autoscaler(self, spawn_engine, *, config=None):
        """Wire the admission-driven autoscaler: queue-depth and
        shed-rate signals drive ``add_replica``/drain through a
        hysteresis controller evaluated once per pump.
        ``spawn_engine()`` must return an engine already holding the
        CURRENT published params (``add_replica`` stamps the version);
        it runs under the fleet lock, so keep it cheap or pre-built.
        When federation is attached (before or after), the controller
        reads FLEET-WIDE rollups instead of this process's gauges."""
        from .autoscale import AutoscaleConfig, AutoscaleController
        with self._lock:
            self.autoscaler = AutoscaleController(
                self, spawn_engine,
                config=config or AutoscaleConfig(),
                registry=self.registry,
                fleet_store=(self.federation.store
                             if self.federation is not None else None))
            if self.migrator is not None:
                self.autoscaler.migrator = self.migrator
            return self.autoscaler

    def attach_migration(self, *, min_headroom: Optional[float] = None):
        """Wire the live-migration plane (serve/scheduler.py): a
        :class:`~.scheduler.MigrationCoordinator` pumped once per fleet
        tick turns the three request-hurting degrade paths into
        placement decisions — KV-pressure preempt caps migrate instead
        of truncate-finishing, blocked eager publishes migrate work off
        instead of degrading to a drain, and autoscale scale-down
        evacuates instead of draining out. Local engines get
        ``migrate_on_pressure`` flipped on; remote engines keep the
        legacy truncate ladder (the flag is host-local — their own
        fleet process flips it)."""
        from .scheduler import GlobalScheduler, MigrationCoordinator
        with self._lock:
            store = (self.federation.store
                     if self.federation is not None else None)
            kwargs = {}
            if min_headroom is not None:
                kwargs["min_headroom"] = float(min_headroom)
            # router.replicas by reference: add_replica appends there,
            # so autoscaled joiners are migration targets immediately.
            scheduler = GlobalScheduler(self.router.replicas,
                                        fleet_store=store, **kwargs)
            self.migrator = MigrationCoordinator(
                self.router, self.publisher, scheduler=scheduler,
                registry=self.registry)
            if self.autoscaler is not None:
                self.autoscaler.migrator = self.migrator
            for r in self.replicas:
                if hasattr(r.engine, "migrate_on_pressure"):
                    r.engine.migrate_on_pressure = True
            return self.migrator

    def attach_federation(self, federator, *, alert_manager=None):
        """Wire the fleet observability plane into the pump: the
        :class:`~..obs.federation.MetricsFederator` polls every peer on
        its own cadence and an optional
        :class:`~..obs.alerts.AlertManager` is evaluated right after,
        both once per pump under the fleet lock. An already-attached
        autoscaler is pointed at the federated store so capacity
        decisions see fleet-wide pressure."""
        with self._lock:
            self.federation = federator
            self.alerts = alert_manager
            if self.autoscaler is not None:
                self.autoscaler.fleet_store = federator.store
            return federator

    def _pump_federation(self, now: float) -> None:
        # guarded-by: _lock
        if self.federation is not None:
            self.federation.poll(now)
            if self.alerts is not None:
                self.alerts.evaluate(now)

    def kill_replica(self, replica_id: str) -> None:
        """Declare a replica dead (chaos hook / operator action); its
        in-flight requests are retried elsewhere or shed explicitly."""
        with self._lock:
            replica = self._replica_by_id(replica_id)
            if replica is None:
                raise KeyError(f"no replica {replica_id!r}")
            self._handle_death(replica, self.clock())

    # -- threaded mode -------------------------------------------------------
    def start(self, *, dispatch_interval_s: float = 0.001) -> None:
        """Threaded serving: per-replica stepper threads + a dispatcher
        thread running admission/routing/publish; ``submit``/``result``
        stay safe from any thread."""
        if self._dispatcher is not None:
            return
        self._stop.clear()
        for replica in self.replicas:
            replica.start(self._on_replica_step)

        def dispatch_loop():
            while not self._stop.is_set():
                with self._lock:
                    now = self.clock()
                    self.publisher.advance()
                    self._track_publish_window(now)
                    self._reap_quarantined(now)
                    self._probe_replicas(now)
                    self._note_kv_pressure()
                    for rej in self.admission.shed_expired(now):
                        self._record_rejection(rej)
                    self._pump_federation(now)
                    if self.autoscaler is not None:
                        self.autoscaler.evaluate(now)
                    if self.migrator is not None:
                        self.migrator.pump(now)
                    self._dispatch(now)
                    self._reap_faulted(now)
                time.sleep(dispatch_interval_s)

        self._dispatcher = threading.Thread(
            target=dispatch_loop, name="serve-dispatch", daemon=True)
        self._dispatcher.start()

    def stop(self) -> None:
        self._stop.set()
        if self._dispatcher is not None:
            self._dispatcher.join(timeout=5)
            self._dispatcher = None
        for replica in self.replicas:
            replica.stop()

    def _note_kv_pressure(self) -> None:
        # guarded-by: _lock
        """Sample fleet KV pool pressure and feed the admission gate.

        The aggregate is the MIN over accepting live replicas (any
        headroom anywhere means the fleet can still place work); with
        none accepting, the min over all live ones. Runs every pump,
        BEFORE autoscaler.evaluate and _dispatch, so both planes act on
        this pump's signal rather than last pump's."""
        live = [r for r in self.replicas if r.state != DEAD]
        pool = [r for r in live if r.accepting] or live
        pressure = min((float(getattr(r, "kv_pressure", 0.0))
                        for r in pool), default=0.0)
        self._kv_pressure_gauge.set(pressure)
        self.admission.note_kv_pressure(pressure)

    def _on_replica_step(self, replica: EngineReplica,
                         emitted: Dict[int, List[int]],
                         done: List[FleetRequest]) -> None:
        """Stepper-thread completion intake (threaded mode)."""
        with self._lock:
            self._ingest(replica, emitted, done, {})

    # -- stats ---------------------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        with self._lock:
            completed = sum(isinstance(o, Completed)
                            for o in self._outcomes.values())
            rejected = sum(isinstance(o, Rejected)
                           for o in self._outcomes.values())
            out: Dict[str, Any] = {
                "replicas": {r.replica_id: r.stats()
                             for r in self.replicas},
                "replicas_live": sum(r.state != DEAD
                                     for r in self.replicas),
                "queue_depth": self.admission.depth(),
                **self.admission.stats(),
                "pending": len(self._requests) - len(self._outcomes),
                "completed": completed,
                "rejected": rejected,
                "weight_version": self.publisher.version,
                "publish_epoch": self.publisher.epoch,
                "weight_version_skew": self.publisher.skew(),
                "publish_in_progress": self.publisher.in_progress,
                "adapter_versions": dict(self.publisher.adapter_versions),
                **self.prefix_store.stats(),
                **self.timelines.stats(),
                "slo": self.slo.summary(),
            }
            return out

    def snapshot_event(self) -> Dict[str, Any]:
        """Flat serving snapshot for the metrics JSONL (the shape
        ``scripts/serve_report.py`` renders). Captured via the wired
        ``metrics_service`` when :meth:`record_snapshot` is called."""
        with self._lock:
            def hsnap(name):
                h = self.registry.get(name)
                if h is None:
                    return 0.0, 0
                total_sum = total_count = 0.0
                for cell in h.samples().values():
                    total_sum += cell[-2]
                    total_count += cell[-1]
                return total_sum, int(total_count)

            def ctotal(name):
                m = self.registry.get(name)
                if m is None:
                    return 0
                return sum(float(v) for v in m.samples().values())

            ttft_sum, ttft_n = hsnap("senweaver_serve_ttft_ms")
            e2e_sum, e2e_n = hsnap("senweaver_serve_e2e_ms")
            inst_sum, inst_n = hsnap("senweaver_serve_prefix_install_ms")

            def ttft_buckets():
                # Per-priority cumulative TTFT buckets — what
                # scripts/prefix_report.py derives p50/p95 from.
                h = self.registry.get("senweaver_serve_ttft_ms")
                if h is None or not hasattr(h, "snapshot"):
                    return {}
                out = {}
                from .admission import PRIORITY_CLASSES
                for p in PRIORITY_CLASSES:
                    snap = h.snapshot(priority=p)
                    if snap["count"]:
                        out[p] = {
                            "buckets": {str(k): v for k, v
                                        in snap["buckets"].items()},
                            "sum": snap["sum"],
                            "count": snap["count"]}
                return out

            return {
                "replicas_live": sum(r.state != DEAD
                                     for r in self.replicas),
                "queue_depth": self.admission.depth(),
                "completed": ctotal("senweaver_serve_completed_total"),
                "shed": ctotal("senweaver_serve_shed_total"),
                "retries": ctotal("senweaver_serve_retries_total"),
                "publishes": ctotal("senweaver_serve_publishes_total"),
                "weight_version_skew": self.publisher.skew(),
                "ttft_ms_sum": ttft_sum, "ttft_count": ttft_n,
                "e2e_ms_sum": e2e_sum, "e2e_count": e2e_n,
                "prefix_broadcasts": ctotal(
                    "senweaver_serve_prefix_broadcasts_total"),
                "prefix_prefills_avoided": ctotal(
                    "senweaver_serve_prefix_prefills_avoided_total"),
                "prefix_broadcast_failures": ctotal(
                    "senweaver_serve_prefix_broadcast_failures_total"),
                "prefix_invalidations": ctotal(
                    "senweaver_serve_prefix_invalidations_total"),
                "prefix_install_ms_sum": inst_sum,
                "prefix_install_count": inst_n,
                "remote_rpcs": ctotal(
                    "senweaver_serve_remote_rpcs_total"),
                "remote_rpc_retries": ctotal(
                    "senweaver_serve_remote_rpc_retries_total"),
                "remote_rpc_errors": ctotal(
                    "senweaver_serve_remote_rpc_errors_total"),
                "breaker_opens": ctotal(
                    "senweaver_serve_remote_breaker_opens_total"),
                "continuation_replays": ctotal(
                    "senweaver_serve_continuation_replays_total"),
                "publish_quarantined": ctotal(
                    "senweaver_serve_publish_quarantined_total"),
                "weight_version": self.publisher.version,
                "publish_epoch": self.publisher.epoch,
                "stale_publishes": ctotal(
                    "senweaver_serve_stale_publish_total"),
                "autoscale_actions": ctotal(
                    "senweaver_serve_autoscale_actions_total"),
                "learner_publishes": ctotal(
                    "senweaver_learner_publishes_total"),
                "adapter_publishes": ctotal(
                    "senweaver_serve_adapter_fleet_publishes_total"),
                "adapter_install_failures": ctotal(
                    "senweaver_serve_adapter_install_failures_total"),
                "adapter_affinity_hits": ctotal(
                    "senweaver_serve_adapter_affinity_hits_total"),
                "ttft_by_priority": ttft_buckets(),
                "slo_requests": ctotal(
                    "senweaver_serve_slo_requests_total"),
                "slo_violations": ctotal(
                    "senweaver_serve_slo_violations_total"),
                "slo": self.slo.summary(),
            }

    def record_snapshot(self) -> None:
        """Capture a "Serving Snapshot" event on the wired metrics
        service (no-op without one)."""
        if self.metrics_service is not None:
            self.metrics_service.capture("Serving Snapshot",
                                         self.snapshot_event())

    # -- internals -----------------------------------------------------------
    def _require(self, ticket: int) -> FleetRequest:
        req = self._requests.get(ticket)
        if req is None:
            raise KeyError(f"unknown ticket {ticket}")
        return req

    def _replica_by_id(self, replica_id: str
                       ) -> Optional[EngineReplica]:
        return next((r for r in self.replicas
                     if r.replica_id == replica_id), None)

    def _dispatch(self, now: float) -> None:
        """Move admitted requests onto accepting replicas, priority
        first, until nothing is ready or nothing accepts."""
        while True:
            req, sheds = self.admission.pop_ready(now)
            for rej in sheds:
                self._record_rejection(rej)
            if req is None:
                return
            replica = self.router.pick(req)
            if replica is None:
                self.admission.requeue(req)     # nothing accepting now
                return
            self.timelines.mark(
                req.ticket, "queue_exit",
                req.queue_exit_at if req.queue_exit_at is not None
                else now,
                **({"routed_by": req.routed_by} if req.routed_by
                   else {}))
            prefill_mode = None
            if req.prefix_tokens:
                # Warm the picked replica BEFORE dispatch: donor prefill
                # + fleet broadcast on first touch, backfill install for
                # late joiners — never raises; on failure the replica's
                # own lazy register_prefix path inside submit() covers.
                prefill_mode = self.prefix_store.ensure(
                    replica, req.prefix_tokens) or "lazy"
            from ..obs import get_tracer
            tracer = get_tracer()
            try:
                # The dispatch span is the trace ROOT the remote side
                # stitches under: the client-attempt spans open inside
                # it (same thread), transports inject its context, and
                # the server spans attach to it across the wire.
                with tracer.span("fleet.dispatch", ticket=req.ticket,
                                 replica=replica.replica_id,
                                 priority=req.priority,
                                 attempt=req.attempts):
                    ctx = tracer.capture()
                    if ctx is not None:
                        self.timelines.set_trace(req.ticket, ctx[0])
                    self.timelines.mark(
                        req.ticket, "prefill_start", now,
                        **({"mode": prefill_mode} if prefill_mode
                           else {}))
                    replica.submit(req)
                req.dispatched_at = now
                self.timelines.mark(req.ticket, "prefill_done",
                                    self.clock())
                dispatch_attrs: Dict[str, Any] = {
                    "replica": replica.replica_id}
                if req.submit_ms is not None:
                    dispatch_attrs["submit_ms"] = round(req.submit_ms, 3)
                self.timelines.mark(req.ticket, "dispatched", now,
                                    **dispatch_attrs)
            except Exception:
                self.timelines.event(req.ticket, "retry", now,
                                     reason="submit_failed",
                                     replica=replica.replica_id)
                # Submit blew up (chaos engine, OOM, wedged pool):
                # fault the replica; the request goes back through the
                # router's retry/shed triage like an orphan.
                if replica.record_fault(REASON_ERROR):
                    self.admission.requeue(req)
                    self._handle_death(replica, now)
                else:
                    req.attempts += 1
                    if req.attempts > self.router.max_retries:
                        self._record_rejection(Rejected(
                            ticket=req.ticket, priority=req.priority,
                            reason=REJECT_REPLICA_FAILURE,
                            detail=f"submit failed "
                                   f"{req.attempts} times"))
                    else:
                        req.not_before = now + self.router.retry.backoff_s(
                            req.attempts)
                        self.admission.requeue(req)

    def _ingest(self, replica: EngineReplica,
                emitted: Dict[int, List[int]],
                done: List[FleetRequest],
                emitted_by_ticket: Dict[int, List[int]]) -> None:
        """Book token emissions (TTFT) and completions (outcomes)."""
        now = self.clock()
        done_by_rid = {r.engine_rid: r for r in done}
        for rid, toks in emitted.items():
            req = replica.inflight.get(rid) or done_by_rid.get(rid)
            if req is None:
                continue                # e.g. pre-kill stragglers
            emitted_by_ticket.setdefault(req.ticket, []).extend(toks)
            if req.first_token_at is None and toks:
                req.first_token_at = now
                self._ttft_ms.observe(
                    (now - req.submitted_at) * 1000.0,
                    priority=req.priority)
                # First-wins: after a mid-decode failover the engine
                # re-emits, but the timeline keeps the FIRST time any
                # token reached the caller.
                self.timelines.mark(req.ticket, "first_token", now,
                                    replica=replica.replica_id)
            if toks and self.migrator is not None:
                # First post-migration token = the handoff ack: the
                # target demonstrably owns the decode, so the frozen
                # source copy can be released (no-op for unmigrated
                # requests).
                self.migrator.note_progress(req, now)
        for req in done:
            self._complete(replica, req, now)

    def _complete(self, replica: EngineReplica, req: FleetRequest,
                  now: float) -> None:
        # guarded-by: caller
        try:
            tokens = replica.engine.result(req.engine_rid)
            logps = replica.engine.result_logps(req.engine_rid)
        except Exception:
            # The replica vanished between emitting ``done`` and the
            # result fetch (a remote holder partitioned mid-handoff, or
            # its breaker opened). The finished tokens died with it —
            # route the request through the SAME retry/shed triage as a
            # death orphan instead of losing an admitted ticket.
            self._record_fault(replica, now)
            self.timelines.event(req.ticket, "retry", now,
                                 reason="result_lost",
                                 replica=replica.replica_id)
            if self.migrator is not None \
                    and self.migrator.rescue_request(req, now):
                # The request was a pre-ack migration target whose
                # result vanished — its frozen source copy resumed, so
                # this is a zero-loss failover, not a retry.
                return
            self.router.on_request_departure(req)
            if not self.router.live_replicas():
                self._record_rejection(Rejected(
                    ticket=req.ticket, priority=req.priority,
                    reason=REJECT_NO_REPLICAS,
                    detail="result lost and no live replicas"))
            elif req.attempts > self.router.max_retries:
                self._record_rejection(Rejected(
                    ticket=req.ticket, priority=req.priority,
                    reason=REJECT_REPLICA_FAILURE,
                    detail=f"result fetch failed after "
                           f"{req.attempts - 1} retries"))
            else:
                req.not_before = now + self.router.retry.backoff_s(
                    req.attempts)
                self.admission.requeue(req)
            return
        if self.migrator is not None:
            # Defensive ack: a decode that finishes on its migration
            # target in the very step it was installed never passes
            # through _ingest with the pending entry open.
            self.migrator.note_complete(req, now)
        e2e_ms = (now - req.submitted_at) * 1000.0
        self._outcomes[req.ticket] = Completed(
            ticket=req.ticket, priority=req.priority,
            tokens=list(tokens), logps=list(logps),
            replica_id=replica.replica_id,
            weight_version=(req.version_at_dispatch
                            if req.version_at_dispatch is not None
                            else replica.weight_version),
            weight_version_at_finish=(req.version_at_finish
                                      if req.version_at_finish is not None
                                      else replica.weight_version),
            attempts=req.attempts,
            ttft_ms=(None if req.first_token_at is None
                     else (req.first_token_at - req.submitted_at)
                     * 1000.0),
            e2e_ms=e2e_ms)
        self._completed_total.inc(priority=req.priority)
        self._e2e_ms.observe(e2e_ms, priority=req.priority)
        # Exactly-once by construction: finishing pops the live
        # timeline, so a chaos-retried path cannot produce a second one.
        self.timelines.finish_completed(
            req.ticket, now, tokens=len(tokens),
            replica_id=replica.replica_id, attempts=req.attempts)

    def _record_rejection(self, rej: Rejected) -> None:
        # Admission already counted its own sheds; router/fleet-origin
        # rejections (replica_failure / no_replicas) are counted here —
        # same counter, so the shed rate is one number.
        # guarded-by: caller
        if rej.reason in (REJECT_REPLICA_FAILURE, REJECT_NO_REPLICAS):
            self._shed_total.inc(priority=rej.priority,
                                 reason=rej.reason)
        self._outcomes[rej.ticket] = rej
        self.timelines.finish_rejected(rej.ticket, self.clock(),
                                       reason=rej.reason)

    def _record_fault(self, replica: EngineReplica, now: float) -> None:
        if replica.record_fault(REASON_ERROR):
            self._handle_death(replica, now)

    def _handle_death(self, replica: EngineReplica, now: float) -> None:
        if self.migrator is not None:
            # BEFORE orphan triage: pre-ack migration targets hand
            # their requests back to the frozen source copies (token-
            # exact, not a retry); pre-ack sources just drop out of the
            # pending ledger. Either way the router below never sees
            # those requests as orphans.
            self.migrator.on_replica_death(replica, now)
        requeue, shed = self.router.on_replica_death(replica, now)
        self._replicas_live.set(
            sum(r.state != DEAD for r in self.replicas))
        for rej in shed:
            self._record_rejection(rej)
        for req in requeue:
            self.timelines.event(req.ticket, "failover", now,
                                 replica=replica.replica_id,
                                 attempt=req.attempts)
            self.admission.requeue(req)
        if not self.router.live_replicas():
            for rej in self.admission.shed_all(
                    REJECT_NO_REPLICAS, "no live replicas"):
                self._record_rejection(rej)

    def _track_publish_window(self, now: float) -> None:
        """Turn publisher in_progress transitions into publish-pause
        windows on the timeline recorder, so a request completed during
        (or across) a rolling publish can account for the stall."""
        # guarded-by: caller
        in_progress = self.publisher.in_progress
        if in_progress and self._publish_started_at is None:
            self._publish_started_at = now
        elif not in_progress and self._publish_started_at is not None:
            self.timelines.publish_window(self._publish_started_at, now)
            self._publish_started_at = None

    def _reap_quarantined(self, now: float) -> None:
        """Turn publish-quarantined replicas (install unreachable mid-
        roll) into proper deaths: the publisher has no router, so orphan
        triage and live-count bookkeeping happen here."""
        # guarded-by: caller
        for replica in self.publisher.take_quarantined():
            if replica.state != DEAD:
                self._handle_death(replica, now)

    def _probe_replicas(self, now: float) -> None:
        """Hedged health probing of probe-capable (remote) replicas.
        A PROBE_DEAD outcome records a timeout fault — the SAME
        escalation budget real dispatch faults use — so a host that
        stops answering dies through the one LIVE→DEAD path; PROBE_SLOW
        is latency, counted but never lethal."""
        # guarded-by: caller
        if self.probe_interval_s <= 0:
            return
        if (self._last_probe_at is not None
                and now - self._last_probe_at < self.probe_interval_s):
            return
        self._last_probe_at = now
        for replica in list(self.replicas):
            probe = getattr(replica, "probe", None)
            if probe is None or replica.state == DEAD:
                continue
            if probe(now) == "dead":
                if replica.record_fault(REASON_TIMEOUT):
                    self._handle_death(replica, now)

    def _reap_faulted(self, now: float) -> None:
        """Threaded mode: stepper threads can only RECORD faults; the
        dispatcher turns a replica whose fault budget is spent into a
        proper death (orphan triage included)."""
        for replica in self.replicas:
            if (replica.state != DEAD
                    and replica._consecutive_faults
                    >= replica.max_consecutive_faults):
                self._handle_death(replica, now)
