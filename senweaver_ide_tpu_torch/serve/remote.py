"""RemoteReplica — a fleet member that lives across a transport.

Two layers, both deliberately thin:

- :class:`RemoteEngineClient` is an ENGINE-SHAPED proxy: it exposes the
  exact single-engine surface (``submit / step / is_done / result /
  result_logps / release_slot / register_prefix / export_prefix /
  import_prefix / update_params / stats / has_work / num_slots /
  context_bound``) over an rpc transport, adding the robustness the
  wire demands — per-call retry under a shared
  :class:`~..resilience.retry.RetryPolicy`, idempotent request ids on
  every mutating call (a retried dispatch replays on the server instead
  of double-executing), and a per-peer
  :class:`~..resilience.retry.CircuitBreaker` so a dead host fails fast
  instead of burning a timeout per touch. Remote APPLICATION errors
  (KeyError / ValueError / QueueFull…) re-raise locally as the original
  types — fleet semantics are transparent to distance.

- :class:`RemoteReplica` is ``EngineReplica`` with that client as its
  engine — the health state machine, in-flight map, and stepper thread
  are REUSED VERBATIM, which is the point: Router / WeightPublisher /
  ServingFleet cannot tell a remote replica from a local one. What it
  adds is what only the network needs: breaker-gated ``accepting`` and
  **hedged health probes** (:meth:`RemoteReplica.probe`) that
  distinguish a SLOW peer (first probe times out, hedge answers — back
  off, don't kill) from a DEAD one (nothing answers — feed the existing
  LIVE→DEAD fault escalation).

When an RpcError survives the client's whole retry budget it propagates
to the fleet exactly like a local engine exception, landing in the same
fault/requeue/shed triage — the failure PATHS are shared; only the
failure SOURCES are new.
"""

from __future__ import annotations

import itertools
import threading
import time
import uuid
from typing import Any, Dict, List, Optional

from ..resilience.retry import CircuitBreaker, RetryBudget, RetryPolicy
from .replica import EngineReplica
from .rpc import (RpcApplicationError, RpcCircuitOpen, RpcError,
                  RpcTimeout)

_client_counter = itertools.count()


class RemoteEngineClient:
    """Engine-shaped rpc proxy with retries, idempotency, breaker."""

    # EngineReplica.submit checks this before passing idempotency_key.
    supports_idempotency = True
    # EngineReplica.install_weights checks this before passing the
    # (epoch, version) fencing token — the remote handler keeps its own
    # high-water mark and rejects stale writers at the host boundary.
    supports_versioned_update = True

    def __init__(self, transport, *, name: Optional[str] = None,
                 policy: RetryPolicy = RetryPolicy(max_retries=2,
                                                   base_delay_s=0.05,
                                                   max_delay_s=1.0),
                 breaker: Optional[CircuitBreaker] = None,
                 clock=time.monotonic, sleep=None, rng=None,
                 registry=None):
        self.transport = transport
        self.name = name or getattr(transport, "target",
                                    f"remote-{next(_client_counter)}")
        self.policy = policy
        self.breaker = breaker
        self.clock = clock
        self.sleep = sleep or time.sleep
        self._rng = rng
        self._seq = itertools.count()
        self._nonce = uuid.uuid4().hex[:8]
        self._opens_seen = 0
        self._meta: Optional[Dict[str, Any]] = None     # guarded-by: _lock
        self._lock = threading.Lock()
        if registry is None:
            from ..obs import get_registry
            registry = get_registry()
        self._rpcs_total = registry.counter(
            "senweaver_serve_remote_rpcs_total",
            "Remote engine RPCs attempted (per attempt, not per call).",
            labelnames=("replica", "method"))
        self._retries_total = registry.counter(
            "senweaver_serve_remote_rpc_retries_total",
            "Remote engine RPC retries (transient error, budget left).",
            labelnames=("replica",))
        self._errors_total = registry.counter(
            "senweaver_serve_remote_rpc_errors_total",
            "Remote engine RPCs that exhausted their retry budget.",
            labelnames=("replica", "kind"))
        self._breaker_gauge = registry.gauge(
            "senweaver_serve_remote_breaker_state",
            "Circuit breaker state per remote replica "
            "(0=closed, 1=half-open, 2=open).",
            labelnames=("replica",))
        self._breaker_opens_total = registry.counter(
            "senweaver_serve_remote_breaker_opens_total",
            "Circuit breaker open transitions per remote replica.",
            labelnames=("replica",))
        self._breaker_gauge.set(0, replica=self.name)

    # -- call machinery ------------------------------------------------------
    def _request_id(self, key: Optional[str] = None) -> str:
        """The wire request id: the caller's idempotency key (or the next
        sequence number) under this client's own nonce. A fleet's keys
        (``ticket-N-aM``) and the sequence restart with every client
        incarnation, and a long-lived host's idempotency cache must never
        replay a previous incarnation's response to a new request."""
        tail = key if key is not None else str(next(self._seq))
        return f"{self.name}#{self._nonce}:{tail}"

    def _sync_breaker_gauge(self) -> None:
        if self.breaker is None:
            return
        self._breaker_gauge.set(self.breaker.state_code,
                                replica=self.name)
        opens = self.breaker.opens_total
        while self._opens_seen < opens:
            self._opens_seen += 1
            self._breaker_opens_total.inc(replica=self.name)

    def _call(self, method: str,
              params: Optional[Dict[str, Any]] = None, *,
              idempotency_key: Optional[str] = None,
              timeout_s: Optional[float] = None) -> Any:
        """One logical call = up to 1 + max_retries attempts. Mutating
        methods always carry a request id so a retry after a lost
        response REPLAYS server-side instead of re-executing."""
        now = self.clock()
        if self.breaker is not None and not self.breaker.allow(now):
            self._sync_breaker_gauge()
            raise RpcCircuitOpen(
                f"{self.name}: circuit open, refusing {method}")
        request_id = self._request_id(idempotency_key)
        budget = RetryBudget(self.policy, now=now, rng=self._rng)
        from ..obs import get_tracer
        tracer = get_tracer()
        attempt = 0
        while True:
            self._rpcs_total.inc(replica=self.name, method=method)
            try:
                # One client span per ATTEMPT (retries are annotated,
                # not hidden); the transport injects this span's context
                # into the frame, so the server span stitches under it.
                with tracer.span(f"rpc.client.{method}",
                                 replica=self.name, method=method,
                                 request_id=request_id,
                                 attempt=attempt) as sp:
                    if sp is not None and attempt > 0:
                        sp.set_attr("retry", True)
                    result = self.transport.call(
                        method, params, request_id=request_id,
                        timeout_s=timeout_s)
            except RpcApplicationError as e:
                # The SERVER answered — the peer is healthy; only the
                # request is bad. Never retried, never a breaker strike.
                if self.breaker is not None:
                    self.breaker.record_success(self.clock())
                    self._sync_breaker_gauge()
                e.raise_local()
            except RpcError as e:
                if self.breaker is not None:
                    self.breaker.record_failure(self.clock())
                    self._sync_breaker_gauge()
                if not e.retriable:
                    self._errors_total.inc(replica=self.name,
                                           kind=type(e).__name__)
                    raise
                delay = budget.next_delay(
                    now=self.clock(),
                    retry_after_s=getattr(e, "retry_after_s", None))
                if delay is None:
                    self._errors_total.inc(replica=self.name,
                                           kind=type(e).__name__)
                    raise
                self._retries_total.inc(replica=self.name)
                attempt += 1
                if delay > 0:
                    self.sleep(delay)
                continue
            if self.breaker is not None:
                self.breaker.record_success(self.clock())
                self._sync_breaker_gauge()
            return result

    # -- engine surface ------------------------------------------------------
    def submit(self, prompt: List[int], *, max_new_tokens: int = 128,
               prefix_id: Optional[int] = None,
               eos_id: Optional[int] = None, hold_slot: bool = False,
               continue_from: Optional[int] = None,
               idempotency_key: Optional[str] = None) -> int:
        return int(self._call("submit", {
            "prompt": list(prompt), "max_new_tokens": max_new_tokens,
            "prefix_id": prefix_id, "eos_id": eos_id,
            "hold_slot": hold_slot, "continue_from": continue_from},
            idempotency_key=idempotency_key))

    def step(self) -> Dict[int, List[int]]:
        emitted = self._call("step")
        return {int(rid): list(toks) for rid, toks in emitted.items()}

    def is_done(self, rid: int) -> bool:
        return bool(self._call("is_done", {"rid": rid}))

    def result(self, rid: int) -> List[int]:
        return list(self._call("result", {"rid": rid}))

    def result_logps(self, rid: int) -> List[float]:
        return list(self._call("result_logps", {"rid": rid}))

    def release_slot(self, rid: int) -> None:
        self._call("release_slot", {"rid": rid})

    def register_prefix(self, tokens: List[int]) -> int:
        return int(self._call("register_prefix",
                              {"tokens": list(tokens)}))

    def export_prefix(self, prefix_id: int):
        return self._call("export_prefix", {"prefix_id": prefix_id})

    def import_prefix(self, tokens: List[int], kv,
                      last_logits=None) -> int:
        return int(self._call("import_prefix", {
            "tokens": list(tokens), "kv": kv,
            "last_logits": last_logits}))

    def release_prefix(self, prefix_id: int) -> None:
        self._call("release_prefix", {"prefix_id": prefix_id})

    def update_params(self, params, *, version: Optional[int] = None,
                      epoch: Optional[int] = None) -> None:
        if epoch is not None and version is None:
            # The host-side high-water mark is (epoch, version); an
            # epoch alone cannot be fenced and silently dropping it
            # would hand a caller unfenced writes it thinks are fenced.
            raise ValueError(
                "update_params: epoch requires version — the remote "
                "fencing mark is (epoch, version)")
        call_params: Dict[str, Any] = {"params": params}
        if version is not None:
            call_params["version"] = int(version)
            call_params["epoch"] = 0 if epoch is None else int(epoch)
        self._call("update_params", call_params)

    # -- live migration (serve/scheduler.py) ---------------------------------
    def checkpoint_request(self, rid: int, *, pause: bool = True):
        """Snapshot an in-flight decode on the remote host; returns the
        decoded :class:`~..rollout.migration.DecodeCheckpoint`. The
        snapshot also FREEZES the row (pause=True), so a lost-response
        retry replays the cached checkpoint rather than cutting a
        second, later one."""
        from ..rollout.migration import DecodeCheckpoint
        wire = self._call("checkpoint_request",
                          {"rid": int(rid), "pause": bool(pause)})
        return DecodeCheckpoint.from_wire(wire)

    def restore_checkpoint(self, ckpt, *,
                           idempotency_key: Optional[str] = None) -> int:
        """Install a checkpoint on the remote host; returns the new
        engine rid. The coordinator passes a stable idempotency key so
        the install is at-least-once on the wire but exactly-once on
        the engine (the server's idempotency cache replays the first
        rid instead of double-installing)."""
        if hasattr(ckpt, "to_wire"):
            ckpt = ckpt.to_wire()
        return int(self._call("restore_checkpoint", {"ckpt": ckpt},
                              idempotency_key=idempotency_key))

    def resume_request(self, rid: int) -> None:
        self._call("resume_request", {"rid": int(rid)})

    def release_request(self, rid: int) -> bool:
        return bool(self._call("release_request", {"rid": int(rid)}))

    def stats(self) -> Dict[str, Any]:
        return dict(self._call("stats"))

    def health(self, *, timeout_s: Optional[float] = None,
               hedged: bool = False) -> Dict[str, Any]:
        """One UNRETRIED health probe (the prober owns hedging — a probe
        that internally retried could not distinguish slow from dead)."""
        now = self.clock()
        if (not hedged and self.breaker is not None
                and not self.breaker.allow(now)):
            raise RpcCircuitOpen(f"{self.name}: circuit open")
        from ..obs import get_tracer
        try:
            # Probes skip _call, so they get their client span here —
            # otherwise the server-side health span has no parent and
            # shows up as an orphan root in stitched traces.
            with get_tracer().span("rpc.client.health",
                                   replica=self.name, method="health",
                                   hedged=hedged):
                out = self.transport.call("health", request_id=None,
                                          timeout_s=timeout_s)
        except RpcError:
            if self.breaker is not None:
                self.breaker.record_failure(self.clock())
                self._sync_breaker_gauge()
            raise
        if self.breaker is not None:
            self.breaker.record_success(self.clock())
            self._sync_breaker_gauge()
        return out

    @property
    def has_work(self) -> bool:
        """Polled every pump; a dead peer must answer False fast (via
        the open breaker), never raise out of a property."""
        try:
            return bool(self.health().get("has_work", False))
        except (RpcError, KeyError, ValueError, TypeError):
            return False

    def _meta_cached(self) -> Dict[str, Any]:
        with self._lock:
            if self._meta is not None:
                return self._meta
        try:
            meta = self._call("meta")
        except RpcError:
            # Conservative fallbacks (EngineReplica's own defaults);
            # NOT cached — the next touch retries the real values.
            return {"num_slots": 8, "context_bound": 1 << 30}
        with self._lock:
            self._meta = meta
        return meta

    @property
    def num_slots(self) -> int:
        return int(self._meta_cached()["num_slots"])

    @property
    def context_bound(self) -> int:
        return int(self._meta_cached()["context_bound"])


PROBE_OK = "ok"
PROBE_SLOW = "slow"
PROBE_DEAD = "dead"


class RemoteReplica(EngineReplica):
    """EngineReplica over a transport: same health machine, same fleet
    surface, plus breaker-gated accepting and hedged probing."""

    def __init__(self, replica_id: str, transport, *,
                 max_consecutive_faults: int = 3,
                 registry=None,
                 policy: Optional[RetryPolicy] = None,
                 breaker_failure_threshold: int = 5,
                 breaker_reset_timeout_s: float = 5.0,
                 probe_timeout_s: float = 0.5,
                 probe_hedges: int = 1,
                 clock=time.monotonic, sleep=None, rng=None):
        if registry is None:
            from ..obs import get_registry
            registry = get_registry()
        breaker = CircuitBreaker(
            failure_threshold=breaker_failure_threshold,
            reset_timeout_s=breaker_reset_timeout_s)
        client = RemoteEngineClient(
            transport, name=replica_id,
            policy=policy or RetryPolicy(max_retries=2,
                                         base_delay_s=0.05,
                                         max_delay_s=1.0),
            breaker=breaker, clock=clock, sleep=sleep, rng=rng,
            registry=registry)
        super().__init__(replica_id, client,
                         max_consecutive_faults=max_consecutive_faults,
                         registry=registry)
        self.client = client
        self.breaker = breaker
        self.clock = clock
        self.probe_timeout_s = probe_timeout_s
        self.probe_hedges = max(0, int(probe_hedges))
        self._probe_total = registry.counter(
            "senweaver_serve_remote_probes_total",
            "Hedged health probes by outcome (ok / slow / dead).",
            labelnames=("replica", "result"))

    @property
    def accepting(self) -> bool:
        """Routable = the EngineReplica contract AND a breaker willing
        to carry the dispatch — routing at a host the breaker already
        condemned just converts admitted requests into retries."""
        if not self.breaker.would_allow(self.clock()):
            return False
        return super().accepting

    def probe(self, now: Optional[float] = None) -> str:
        """Hedged health probe: PROBE_OK (first attempt answered),
        PROBE_SLOW (an attempt timed out but a hedge answered — latency,
        not death; do NOT kill), PROBE_DEAD (every attempt failed —
        feeds the fleet's fault escalation). Each attempt is a single
        un-retried rpc on a short timeout."""
        saw_timeout = False
        for attempt in range(1 + self.probe_hedges):
            try:
                self.client.health(timeout_s=self.probe_timeout_s,
                                   hedged=attempt > 0)
            except RpcTimeout:
                saw_timeout = True
                continue
            except RpcError:
                continue
            result = PROBE_SLOW if attempt > 0 else PROBE_OK
            self._probe_total.inc(replica=self.replica_id, result=result)
            return result
        # All attempts failed. A pure-timeout pattern still reads dead —
        # the distinguishing signal is "a hedge eventually answered",
        # not the error class.
        del saw_timeout
        self._probe_total.inc(replica=self.replica_id, result=PROBE_DEAD)
        return PROBE_DEAD
