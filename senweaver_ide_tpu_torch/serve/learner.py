"""Disaggregated learner: crash-tolerant training-side weight publication.

The remote fleet is the actor half of the Podracer "Sebulba" split — replicas
that serve across a transport. This module is the learner half: a
process that trains (an :class:`~..training.online.OnlineImprovementLoop`
or any round-running trainer) and publishes versioned weights to a
:class:`~.frontend.ServingFleet` over the same rpc transport, surviving
every failure a separate process invites:

- **zombie/duplicate learners** — every publish carries the
  ``(lease_epoch, weight_version)`` fencing token from the fleet-side
  :class:`~..resilience.lease.LeaseStore`; a superseded learner's
  publishes raise :class:`~.weights.StalePublishError` /
  :class:`~..resilience.lease.LeaseLost` fleet-wide instead of applying.
- **crash/resume** — :meth:`LearnerService.start` re-acquires the lease
  (strictly higher epoch) and, when the durable state file records a
  prior publish, REPUBLISHES that version. A publish torn by the crash
  is superseded by the republish (higher epoch), so the fleet converges
  on the learner's last durable weights — serving never runs a policy
  the trainer cannot resume from.
- **partitions mid-publish** — publish is a resumable saga: stage
  (idempotent under retried request ids, bounded by a learner-side
  :class:`~..resilience.retry.RetryBudget`) → the fleet pump rolls →
  the learner polls convergence. A replica unreachable mid-roll is
  quarantined fleet-side and backfills through ``add_replica``; the
  learner's poll still converges on the reachable set.

The transport is injected: ``LoopbackTransport`` for hermetic CPU tests
(with ``NetworkFaultPlan`` chaos), ``HttpTransport`` against
:func:`~.learner_server.serve_fleet_http` for real deployment.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import os
import threading
import time
import uuid
from typing import Any, Callable, Dict, Optional

from ..resilience.lease import LeaseLost
from ..resilience.retry import RetryBudget, RetryPolicy
from .rpc import RpcApplicationError, RpcError
from .weights import StalePublishError

_client_counter = itertools.count()


class LearnerPublishError(RuntimeError):
    """A staged publish failed to converge within the deadline (the
    fleet is unreachable or wedged — NOT a fencing rejection)."""


class FleetPublishClient:
    """Learner-side rpc proxy to a :class:`~.learner_server.FleetRpcHandler`.

    The retry story mirrors ``RemoteEngineClient._call``: transient wire
    errors retry under a shared :class:`RetryPolicy` (the learner-side
    RetryBudget that bounds retry storms), publishes carry stable
    ``(epoch, version)``-keyed request ids so a retried stage REPLAYS
    server-side, and remote application errors re-raise locally as
    their original types (``LeaseLost`` stays ``LeaseLost`` across the
    wire). Lease calls are NOT idempotency-cached server-side —
    re-executing them on retry is safe — so request ids never need to
    survive a client restart; the per-instance nonce in the default
    ``name`` keeps incarnations from sharing an id space regardless."""

    def __init__(self, transport, *, name: Optional[str] = None,
                 policy: RetryPolicy = RetryPolicy(max_retries=3,
                                                   base_delay_s=0.05,
                                                   max_delay_s=2.0),
                 clock=time.monotonic, sleep=None, rng=None,
                 registry=None):
        self.transport = transport
        if name is None:
            # Unique per INSTANCE, not per target: request ids prefixed
            # by a shared target would collide across restarts (seq
            # restarts at 0), and a colliding id must never be able to
            # replay a previous incarnation's cached response.
            target = getattr(transport, "target",
                             f"learner-{next(_client_counter)}")
            name = f"{target}#{uuid.uuid4().hex[:8]}"
        self.name = name
        self.policy = policy
        self.clock = clock
        self.sleep = sleep or time.sleep
        self._rng = rng
        self._seq = itertools.count()
        if registry is None:
            from ..obs import get_registry
            registry = get_registry()
        self._rpcs_total = registry.counter(
            "senweaver_learner_rpcs_total",
            "Learner→fleet RPCs attempted (per attempt, not per call).",
            labelnames=("method",))
        self._retries_total = registry.counter(
            "senweaver_learner_rpc_retries_total",
            "Learner→fleet RPC retries (transient error, budget left).")

    def _call(self, method: str,
              params: Optional[Dict[str, Any]] = None, *,
              idempotency_key: Optional[str] = None,
              timeout_s: Optional[float] = None) -> Any:
        request_id = idempotency_key or f"{self.name}:{next(self._seq)}"
        budget = RetryBudget(self.policy, now=self.clock(), rng=self._rng)
        while True:
            self._rpcs_total.inc(method=method)
            try:
                return self.transport.call(
                    method, params, request_id=request_id,
                    timeout_s=timeout_s)
            except RpcApplicationError as e:
                e.raise_local()     # LeaseLost / StalePublishError / …
            except RpcError as e:
                if not e.retriable:
                    raise
                delay = budget.next_delay(
                    now=self.clock(),
                    retry_after_s=getattr(e, "retry_after_s", None))
                if delay is None:
                    raise
                self._retries_total.inc()
                if delay > 0:
                    self.sleep(delay)

    # -- gateway surface -----------------------------------------------------
    def acquire_lease(self, holder: str, *,
                      steal: bool = False) -> Dict[str, Any]:
        return self._call("acquire_lease",
                          {"holder": holder, "steal": steal})

    def renew_lease(self, holder: str, epoch: int) -> Dict[str, Any]:
        return self._call("renew_lease",
                          {"holder": holder, "epoch": epoch})

    def release_lease(self, holder: str, epoch: int) -> Dict[str, Any]:
        return self._call("release_lease",
                          {"holder": holder, "epoch": epoch})

    def publish(self, params, *, epoch: int, version: int,
                eager: bool = False,
                timeout_s: Optional[float] = None) -> Dict[str, Any]:
        # The idempotency key is the fencing token itself: a retried
        # stage of (epoch, version) must replay, never double-stage.
        # eager=True requests the fleet's no-drain roll (streaming
        # learner: collection never pauses for the publish).
        return self._call(
            "publish",
            {"params": params, "epoch": epoch, "version": version,
             "eager": eager},
            idempotency_key=f"{self.name}:publish:e{epoch}:v{version}",
            timeout_s=timeout_s)

    def publish_adapter(self, tenant_id: str, lora, *, epoch: int,
                        version: Optional[int] = None,
                        timeout_s: Optional[float] = None) -> Dict[str, Any]:
        # Adapter publishes are fenced by (epoch, per-tenant version);
        # the key mirrors publish: a lost response replays the apply
        # (idempotent — the per-tenant watermark rejects the re-stage).
        return self._call(
            "publish_adapter",
            {"tenant_id": tenant_id, "lora": lora, "epoch": epoch,
             "version": version},
            idempotency_key=(f"{self.name}:publish_adapter:{tenant_id}"
                             f":e{epoch}:v{version}"),
            timeout_s=timeout_s)

    def publish_status(self) -> Dict[str, Any]:
        return self._call("publish_status")

    def signals(self) -> Dict[str, Any]:
        return self._call("signals")

    def fleet_stats(self) -> Dict[str, Any]:
        return self._call("fleet_stats")


@dataclasses.dataclass(frozen=True)
class LearnerConfig:
    """Knobs for one learner process."""

    holder: str = "learner-0"
    # Durable (version, rounds) JSON beside the trainer's checkpoints;
    # None = in-memory only (no crash/resume republish).
    state_path: Optional[str] = None
    publish_timeout_s: float = 30.0
    # Sleep between convergence polls; 0 = poll hot (loopback tests —
    # each poll pumps the fleet one step anyway).
    publish_poll_interval_s: float = 0.0
    steal_lease: bool = False


class LearnerService:
    """One GRPO learner: train a round, publish fenced weights, repeat.

    ``trainer`` is either an object with ``run_round()`` + a
    ``state.params`` attribute (the :class:`OnlineImprovementLoop`
    contract) or a bare callable returning fresh params. The service
    owns no training logic — only leadership, versioning, and the
    publish saga."""

    def __init__(self, trainer, client: FleetPublishClient, *,
                 config: LearnerConfig = LearnerConfig(),
                 clock=time.monotonic, sleep=None, registry=None):
        self.trainer = trainer
        self.client = client
        self.config = config
        self.clock = clock
        self.sleep = sleep or time.sleep
        self.epoch = 0              # guarded-by: _lock
        self.version = 0            # guarded-by: _lock
        self.rounds = 0             # guarded-by: _lock
        self._lease_expires_at: Optional[float] = None  # guarded-by: _lock
        self._lock = threading.Lock()
        if registry is None:
            from ..obs import get_registry
            registry = get_registry()
        self._rounds_total = registry.counter(
            "senweaver_learner_rounds_total",
            "Training rounds the learner completed.")
        self._publishes_total = registry.counter(
            "senweaver_learner_publishes_total",
            "Fenced weight publishes that converged fleet-wide.")
        self._publish_failures_total = registry.counter(
            "senweaver_learner_publish_failures_total",
            "Publishes that failed to stage or converge.")
        self._resumes_total = registry.counter(
            "senweaver_learner_resume_republishes_total",
            "Crash/resume republishes of the last durable version.")
        self._lease_lost_total = registry.counter(
            "senweaver_learner_lease_lost_total",
            "Lease losses observed (superseded by another learner).")
        self._epoch_gauge = registry.gauge(
            "senweaver_learner_lease_epoch",
            "This learner's fencing epoch (0 = no lease).")
        self._version_gauge = registry.gauge(
            "senweaver_learner_weight_version",
            "Last weight version this learner published durably.")
        self._epoch_gauge.set(0)
        self._version_gauge.set(0)

    # -- durable state -------------------------------------------------------
    def _load_state(self) -> Dict[str, Any]:
        path = self.config.state_path
        if path is None or not os.path.exists(path):
            return {}
        try:
            with open(path, "r", encoding="utf-8") as f:
                return json.load(f)
        except (OSError, ValueError):
            # Torn write from a crash — treat as no durable state; the
            # save path is atomic, so this only covers external damage.
            return {}

    def _save_state(self) -> None:
        path = self.config.state_path
        if path is None:
            return
        with self._lock:
            payload = {"weight_version": self.version,
                       "rounds": self.rounds}
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(payload, f)
        os.replace(tmp, path)

    # -- leadership ----------------------------------------------------------
    def start(self) -> int:
        """Acquire the lease (a strictly higher epoch — fencing out any
        previous incarnation) and reconverge the fleet: republish the
        last durable version if one exists, else adopt the fleet's
        current version so the next publish lands above it. Returns
        the lease epoch."""
        saved = self._load_state()
        lease = self.client.acquire_lease(self.config.holder,
                                          steal=self.config.steal_lease)
        with self._lock:
            self.epoch = int(lease["epoch"])
            self._lease_expires_at = float(lease["expires_at"])
            self.rounds = int(saved.get("rounds", 0))
        self._epoch_gauge.set(self.epoch)
        durable_version = int(saved.get("weight_version", 0))
        if durable_version > 0:
            with self._lock:
                self.version = durable_version
            self._resumes_total.inc()
            self._publish(self._params(), durable_version)
        else:
            fleet_version = int(
                self.client.signals().get("weight_version", 0))
            with self._lock:
                self.version = max(self.version, fleet_version)
        self._version_gauge.set(self.version)
        return self.epoch

    def stop(self) -> None:
        """Voluntary leadership release (best-effort — a crash skips
        this and the TTL/fencing path covers it)."""
        with self._lock:
            epoch = self.epoch
        if epoch > 0:
            try:
                self.client.release_lease(self.config.holder, epoch)
            except (RpcError, LeaseLost):
                pass

    def _renew(self) -> None:
        try:
            lease = self.client.renew_lease(self.config.holder,
                                            self.epoch)
        except LeaseLost:
            self._lease_lost_total.inc()
            self._epoch_gauge.set(0)
            raise
        with self._lock:
            self._lease_expires_at = float(lease["expires_at"])

    # -- the round -----------------------------------------------------------
    def _params(self):
        t = self.trainer
        state = getattr(t, "state", None)
        if state is not None and hasattr(state, "params"):
            return state.params
        if callable(t):
            # Bare-callable trainers expose no "current params" — the
            # crash/resume republish invokes the callable once so a
            # restart with durable state has weights to publish.
            return t()
        raise ValueError(
            "trainer has neither state.params nor __call__; the "
            "learner cannot obtain params to publish")

    def _train(self):
        t = self.trainer
        if hasattr(t, "run_round"):
            t.run_round()
            return t.state.params
        return t()

    def run_round(self) -> int:
        """Renew leadership, train one round, publish the new version;
        returns the published version. Raises :class:`LeaseLost` /
        :class:`StalePublishError` when fenced out — the caller must
        stop training, not retry."""
        self._renew()
        params = self._train()
        with self._lock:
            self.version += 1
            version = self.version
        try:
            self._publish(params, version)
        except (LeaseLost, StalePublishError):
            # Fenced out mid-round: roll the version back so a (buggy)
            # caller that keeps going cannot silently skip numbers.
            with self._lock:
                self.version = version - 1
            self._lease_lost_total.inc()
            raise
        with self._lock:
            self.rounds += 1
        self._rounds_total.inc()
        self._save_state()
        self._version_gauge.set(version)
        return version

    def run(self, rounds: int) -> int:
        for _ in range(rounds):
            self.run_round()
        return self.version

    # -- the publish saga ----------------------------------------------------
    def _publish(self, params, version: int) -> None:
        """Stage (idempotent, retry-bounded) then poll to convergence."""
        deadline = self.clock() + self.config.publish_timeout_s
        try:
            self.client.publish(params, epoch=self.epoch,
                                version=version)
        except (LeaseLost, StalePublishError):
            self._publish_failures_total.inc()
            raise
        except RpcError as e:
            self._publish_failures_total.inc()
            raise LearnerPublishError(
                f"publish v{version} failed to stage: {e}") from e
        while True:
            try:
                status = self.client.publish_status()
            except RpcError as e:
                self._publish_failures_total.inc()
                raise LearnerPublishError(
                    f"publish v{version} staged but convergence poll "
                    f"failed: {e}") from e
            if (status.get("converged")
                    and int(status.get("version", -1)) == version
                    and int(status.get("epoch", -1)) == self.epoch):
                break
            if int(status.get("epoch", 0)) > self.epoch:
                # Another learner took over while we rolled.
                self._publish_failures_total.inc()
                raise LeaseLost(
                    f"fleet moved to epoch {status.get('epoch')} while "
                    f"publishing at epoch {self.epoch}")
            if self.clock() >= deadline:
                self._publish_failures_total.inc()
                raise LearnerPublishError(
                    f"publish v{version} staged but did not converge "
                    f"within {self.config.publish_timeout_s}s "
                    f"(status: {status})")
            if self.config.publish_poll_interval_s > 0:
                self.sleep(self.config.publish_poll_interval_s)
        self._publishes_total.inc()
        self._save_state()


# -- streaming (continuous-flow) learner -------------------------------------


class ExperienceClient:
    """Collector-side rpc proxy to an
    :class:`~.learner_server.ExperienceRpcHandler`. Submits episode
    batches under a DETERMINISTIC idempotency key (first episode id +
    count) so a retried submit whose ack frame was lost replays the
    recorded acks instead of re-offering; the learner queue's seen-set
    is the second, incarnation-proof line of defense."""

    def __init__(self, transport, *, name: Optional[str] = None,
                 policy: RetryPolicy = RetryPolicy(max_retries=3,
                                                   base_delay_s=0.05,
                                                   max_delay_s=2.0),
                 clock=time.monotonic, sleep=None, rng=None,
                 registry=None):
        self._rpc = FleetPublishClient(transport, name=name,
                                       policy=policy, clock=clock,
                                       sleep=sleep, rng=rng,
                                       registry=registry)
        self.name = self._rpc.name

    def submit(self, episodes) -> Dict[str, str]:
        """Offer ``episodes`` to the learner; returns
        ``{episode_id: outcome}`` acks (see training/experience.py for
        the vocabulary). Transport errors propagate after the retry
        budget — the caller (:class:`EpisodeStreamer`) keeps the batch
        buffered and tries again later."""
        if not episodes:
            return {}
        key = (f"{self.name}:submit:{episodes[0].episode_id}"
               f"+{len(episodes)}")
        out = self._rpc._call(
            "submit_episodes",
            {"episodes": [ep.to_wire() for ep in episodes]},
            idempotency_key=key)
        return dict(out.get("acks", {}))

    def stream_stats(self) -> Dict[str, Any]:
        return self._rpc._call("stream_stats")


class EpisodeStreamer:
    """Collector-side at-least-once buffer: episodes stay pending until
    the learner acks them (accepted / duplicate / stale all retire the
    id — only ``full`` and transport failures keep it buffered for the
    next flush). Paired with the learner's seen-set dedup this gives
    exactly-once training effect under drops, replays, and learner
    restarts. The stall gauge is the collector half of the headline
    metric: the fraction of flushes that could not fully hand off."""

    def __init__(self, client: ExperienceClient, *, registry=None):
        self.client = client
        self._pending: list = []
        self._flushes = 0
        self._stalls = 0
        if registry is None:
            from ..obs import get_registry
            registry = get_registry()
        self._submitted_total = registry.counter(
            "senweaver_collector_episodes_submitted_total",
            "Episode submissions attempted by the collector "
            "(per flush attempt, so retries count again).")
        self._retired_total = registry.counter(
            "senweaver_collector_episodes_retired_total",
            "Episodes retired from the collector buffer, by learner "
            "ack outcome.", labelnames=("outcome",))
        self._stall_gauge = registry.gauge(
            "senweaver_collector_stall_fraction",
            "Fraction of collector flushes that left episodes pending "
            "(queue full or learner unreachable — backpressure).")
        self._stall_gauge.set(0.0)

    @property
    def pending(self) -> int:
        return len(self._pending)

    def offer(self, episodes) -> None:
        self._pending.extend(episodes)

    def flush(self) -> Dict[str, int]:
        """One submit attempt over everything pending; returns
        ``{"retired": n, "pending": m}``. Never raises — a transport
        failure keeps the batch for the next flush (at-least-once)."""
        if not self._pending:
            return {"retired": 0, "pending": 0}
        self._flushes += 1
        self._submitted_total.inc(len(self._pending))
        try:
            acks = self.client.submit(self._pending)
        except (RpcError, LeaseLost):
            self._stalls += 1
            self._stall_gauge.set(self._stalls / self._flushes)
            return {"retired": 0, "pending": len(self._pending)}
        keep = []
        retired = 0
        for ep in self._pending:
            outcome = acks.get(ep.episode_id)
            if outcome in ("accepted", "duplicate", "stale"):
                self._retired_total.inc(outcome=outcome)
                retired += 1
            else:                   # "full" or missing: resubmit later
                keep.append(ep)
        self._pending = keep
        if keep:
            self._stalls += 1
        self._stall_gauge.set(self._stalls / self._flushes)
        return {"retired": retired, "pending": len(keep)}


@dataclasses.dataclass(frozen=True)
class StreamingLearnerConfig:
    """Knobs for the continuous-flow learner mode."""

    group_size: int = 4
    # Train as soon as this many COMPLETE groups are ready.
    min_groups: int = 1
    # Hard staleness bound: episodes more than this many versions
    # behind are dropped and counted, never trained.
    max_staleness: int = 4
    queue_capacity: int = 1024
    seen_capacity: int = 65536
    # Seen-ids persisted with the durable state (the no-double-train
    # half of crash recovery).
    seen_snapshot_limit: int = 8192
    # Stage publishes as no-drain eager rolls (collection never
    # pauses); the lockstep fallback always publishes draining+blocking
    # regardless.
    eager_publish: bool = True


class StreamingLearnerService(LearnerService):
    """Continuous-flow GRPO learner: train on streamed episode groups
    the moment a staleness-bounded batch is ready; publish WITHOUT
    blocking on roll convergence (the fenced no-drain path), polling
    opportunistically between steps.

    ``trainer`` must expose ``state.params`` and
    ``train_on_batch(episodes) -> metrics`` —
    :class:`~..training.experience.StreamingTrainerAdapter` is the
    concrete GRPO implementation; tests use lighter fakes. When it
    also exposes ``note_published(version)`` the service calls it at
    every accepted stage so the behavior-params cache can serve
    importance-ratio recomputes.

    Correctness story (streaming mode): per-episode behavior stamps +
    recorded logps give token-exact importance ratios; the hard
    staleness bound drops (and counts) what correction can't fix; the
    ``staleness_drift`` health detector + mitigation hysteresis can
    veto the async mode back to lockstep (synchronous, blocking
    publishes) until staleness quiets; the queue's seen-set plus the
    collector's resubmit-until-acked buffer give exactly-once training
    effect across crashes and replays."""

    def __init__(self, trainer, client: FleetPublishClient, *,
                 stream_config: StreamingLearnerConfig =
                 StreamingLearnerConfig(),
                 config: LearnerConfig = LearnerConfig(),
                 health_config=None, mitigator=None,
                 clock=time.monotonic, sleep=None, registry=None):
        super().__init__(trainer, client, config=config, clock=clock,
                         sleep=sleep, registry=registry)
        if registry is None:
            from ..obs import get_registry
            registry = get_registry()
        from ..training.experience import ExperienceQueue
        self.stream_config = stream_config
        self.queue = ExperienceQueue(
            group_size=stream_config.group_size,
            capacity=stream_config.queue_capacity,
            max_staleness=stream_config.max_staleness,
            min_groups=stream_config.min_groups,
            seen_capacity=stream_config.seen_capacity,
            registry=registry)
        # staleness_drift detector + lockstep veto (both optional).
        self.health_config = health_config
        self.mitigator = mitigator
        self._outstanding_publish: Optional[int] = None  # guarded-by: _lock
        self._busy_s = 0.0              # guarded-by: _lock
        self._idle_s = 0.0              # guarded-by: _lock
        self._idle_gauge = registry.gauge(
            "senweaver_learner_idle_fraction",
            "Fraction of learner wall time spent waiting for a ready "
            "batch (streamed mode's headline vs lockstep).")
        self._mode_gauge = registry.gauge(
            "senweaver_learner_streaming_mode",
            "1 = streaming (async no-drain publishes), 0 = lockstep "
            "fallback (staleness-drift veto active).")
        self._steps_total = registry.counter(
            "senweaver_learner_stream_steps_total",
            "Streaming train steps, by mode.", labelnames=("mode",))
        self._idle_gauge.set(0.0)
        self._mode_gauge.set(1)

    # -- intake (called by ExperienceRpcHandler) -----------------------------
    def intake(self, episodes) -> Dict[str, Any]:
        with self._lock:
            version = self.version
        return self.queue.offer_many(episodes, current_version=version)

    def stream_stats(self) -> Dict[str, Any]:
        st = dict(self.queue.stats())
        with self._lock:
            st.update({"version": self.version, "epoch": self.epoch,
                       "outstanding_publish": self._outstanding_publish})
        st["mode"] = "lockstep" if self._lockstep() else "streaming"
        return st

    def _lockstep(self) -> bool:
        return (self.mitigator is not None
                and self.mitigator.lockstep_fallback_active())

    # -- durable state (adds the seen-ids snapshot) --------------------------
    def _save_state(self) -> None:
        path = self.config.state_path
        if path is None:
            return
        with self._lock:
            payload = {"weight_version": self.version,
                       "rounds": self.rounds}
        payload["seen_episodes"] = self.queue.seen_snapshot(
            limit=self.stream_config.seen_snapshot_limit)
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(payload, f)
        os.replace(tmp, path)

    def start(self) -> int:
        # Restore the predecessor's seen-ids BEFORE the lease/republish
        # handshake: collectors may resubmit the moment the endpoint is
        # back, and anything the previous incarnation trained must ack
        # "duplicate", not re-enter the queue.
        saved = self._load_state()
        self.queue.restore_seen(saved.get("seen_episodes", []))
        epoch = super().start()
        self._note_published_to_trainer()
        return epoch

    def _note_published_to_trainer(self) -> None:
        note = getattr(self.trainer, "note_published", None)
        if note is not None:
            with self._lock:
                version = self.version
            note(version)

    # -- the async publish saga ----------------------------------------------
    def pump_publish(self, *, block: bool = False) -> bool:
        """Drive any outstanding staged publish toward convergence;
        returns True when none remains. One non-blocking status poll by
        default (which also pumps a manual fleet one step);
        ``block=True`` polls to the publish deadline — the lockstep
        fallback's synchronous shape. Raises :class:`LeaseLost` when
        the fleet moved to a higher epoch."""
        with self._lock:
            outstanding = self._outstanding_publish
        if outstanding is None:
            return True
        deadline = self.clock() + self.config.publish_timeout_s
        while True:
            try:
                status = self.client.publish_status()
            except RpcError as e:
                if not block:
                    return False
                self._publish_failures_total.inc()
                raise LearnerPublishError(
                    f"publish v{outstanding} staged but convergence "
                    f"poll failed: {e}") from e
            if int(status.get("epoch", 0)) > self.epoch:
                self._publish_failures_total.inc()
                self._lease_lost_total.inc()
                raise LeaseLost(
                    f"fleet moved to epoch {status.get('epoch')} while "
                    f"streaming at epoch {self.epoch}")
            # >= because a superseding stage fast-forwards the roll:
            # convergence at ANY version past the outstanding one
            # retires it.
            if (status.get("converged")
                    and int(status.get("version", -1)) >= outstanding
                    and int(status.get("epoch", -1)) == self.epoch):
                with self._lock:
                    self._outstanding_publish = None
                self._publishes_total.inc()
                return True
            if not block:
                return False
            if self.clock() >= deadline:
                self._publish_failures_total.inc()
                raise LearnerPublishError(
                    f"publish v{outstanding} staged but did not "
                    f"converge within {self.config.publish_timeout_s}s "
                    f"(status: {status})")
            if self.config.publish_poll_interval_s > 0:
                self.sleep(self.config.publish_poll_interval_s)

    def _stage_publish(self, params, version: int) -> None:
        """Stage (idempotent, fenced, no-drain) WITHOUT waiting for the
        roll — the streaming learner keeps training while the fleet
        pump swaps replicas at zero in-flight."""
        try:
            self.client.publish(params, epoch=self.epoch,
                                version=version,
                                eager=self.stream_config.eager_publish)
        except (LeaseLost, StalePublishError):
            self._publish_failures_total.inc()
            raise
        except RpcError as e:
            self._publish_failures_total.inc()
            raise LearnerPublishError(
                f"publish v{version} failed to stage: {e}") from e
        with self._lock:
            self._outstanding_publish = version

    # -- the streaming step --------------------------------------------------
    def run_step(self) -> Optional[Dict[str, Any]]:
        """One continuous-flow step: pump the outstanding publish, pop
        a staleness-bounded batch, train, stage the next version.
        Returns the step record, or None when no batch was ready (the
        idle fraction accounts the wait). Raises :class:`LeaseLost` /
        :class:`StalePublishError` when fenced out."""
        t0 = self.clock()
        lockstep = self._lockstep()
        self._mode_gauge.set(0 if lockstep else 1)
        # Lockstep fallback: block until the previous publish fully
        # landed — zero skew, zero staleness growth — before training.
        self.pump_publish(block=lockstep)
        with self._lock:
            version = self.version
        batch = self.queue.take_batch(
            current_version=version,
            min_groups=self.stream_config.min_groups)
        if batch is None:
            self._note_step_time(t0, busy=False)
            return None
        self._renew()
        metrics = self.trainer.train_on_batch(batch)
        staleness = [max(0, version - ep.version) for ep in batch]
        staleness_mean = sum(staleness) / len(staleness)
        with self._lock:
            self.version += 1
            new_version = self.version
        params = self._params()
        try:
            if lockstep:
                self._publish(params, new_version)
            else:
                self._stage_publish(params, new_version)
        except (LeaseLost, StalePublishError):
            with self._lock:
                self.version = new_version - 1
            self._lease_lost_total.inc()
            raise
        self._note_published_to_trainer()
        with self._lock:
            self.rounds += 1
        self._rounds_total.inc()
        mode = "lockstep" if lockstep else "streaming"
        self._steps_total.inc(mode=mode)
        self._save_state()
        self._version_gauge.set(new_version)
        events = self._observe_health(staleness_mean, len(batch))
        self._note_step_time(t0, busy=True)
        return {"version": new_version, "mode": mode,
                "episodes": len(batch),
                "staleness_mean": staleness_mean,
                "metrics": metrics, "events": events}

    # -- health / accounting -------------------------------------------------
    def _observe_health(self, staleness_mean: float,
                        batch_size: int) -> list:
        """Feed the streaming signals to the staleness_drift detector
        and fold the trigger into the mitigator's streak hysteresis —
        the veto that flips async back to lockstep (and, after quiet
        rounds, back again)."""
        if self.health_config is None and self.mitigator is None:
            return []
        stats = self.queue.stats()
        dropped = stats.get("stale_dropped", 0)
        consumed = dropped + max(1, stats.get("accepted", 1))
        health = {"staleness_mean": float(staleness_mean),
                  "stale_drop_fraction": dropped / consumed}
        triggers = []
        if self.health_config is not None:
            from ..obs.training_health import evaluate_health
            triggers = evaluate_health(health, self.health_config)
        events = []
        if self.mitigator is not None:
            grpo_config = getattr(self.trainer, "grpo_config", None)
            if grpo_config is None:
                from ..training.trainer import GRPOConfig
                grpo_config = GRPOConfig()
            _, events = self.mitigator.apply(grpo_config, triggers)
        return events

    def _note_step_time(self, t0: float, *, busy: bool) -> None:
        dt = max(0.0, self.clock() - t0)
        with self._lock:
            if busy:
                self._busy_s += dt
            else:
                self._idle_s += dt
            total = self._busy_s + self._idle_s
            idle = self._idle_s / total if total > 0 else 0.0
        self._idle_gauge.set(idle)

    def note_idle(self, seconds: float) -> None:
        """Credit learner wall time spent waiting for experience that
        run_step itself didn't see (a driver sleeping between polls)."""
        with self._lock:
            self._idle_s += max(0.0, float(seconds))
            total = self._busy_s + self._idle_s
            idle = self._idle_s / total if total > 0 else 0.0
        self._idle_gauge.set(idle)

    def idle_fraction(self) -> float:
        with self._lock:
            total = self._busy_s + self._idle_s
            return self._idle_s / total if total > 0 else 0.0

    def reset_utilization(self) -> None:
        """Zero the busy/idle accounting. Call after warmup so one-time
        first-call compiles don't swamp the steady-state idle fraction."""
        with self._lock:
            self._busy_s = 0.0
            self._idle_s = 0.0
        self._idle_gauge.set(0.0)
