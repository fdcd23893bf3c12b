"""EngineReplica — one RolloutEngine as a member of a serving fleet.

The wrapper owns what the bare engine doesn't know it has: an identity
(``replica_id``), a health state machine (LIVE → DRAINING → LIVE for
weight rolls, anything → DEAD on faults), a weight version, the
in-flight request map the router balances on, and — in threaded mode —
the stepper thread that drives ``engine.step()`` so N replicas decode
concurrently while the fleet's dispatcher admits and routes.

Fault vocabulary is reused from ``resilience.faults`` (REASON_ERROR /
REASON_TIMEOUT): a replica that throws out of submit/step records a
fault, and ``max_consecutive_faults`` of them without a healthy step in
between kill it — the same escalate-after-bounded-retries shape the
episode boundary uses, applied to the serving plane.

State transitions never lose requests: ``kill()`` returns the orphaned
in-flight FleetRequests so the router can resubmit them elsewhere (or
shed them with a typed Rejected when retries are spent).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

from ..resilience.faults import REASON_ERROR
from .admission import FleetRequest

LIVE = "live"
DRAINING = "draining"
DEAD = "dead"
_STATE_CODE = {LIVE: 0, DRAINING: 1, DEAD: 2}


class ReplicaDead(RuntimeError):
    """Operation attempted on a DEAD replica."""


class EngineReplica:
    """One engine + its fleet-facing bookkeeping. All mutation is
    serialized under ``self._lock`` (the engine has its own lock; this
    one covers the replica's maps so the dispatcher thread and the
    stepper thread compose)."""

    def __init__(self, replica_id: str, engine, *,
                 max_consecutive_faults: int = 3,
                 host_group: Optional[str] = None,
                 registry=None):
        self.replica_id = replica_id
        self.engine = engine
        # Rack/host placement label for the shared-prefix store's
        # one-donor-per-host fanout. None (the default) means "its own
        # host", which degrades rack-awareness to the original
        # broadcast-to-everyone behavior.
        self.host_group = host_group
        self.state = LIVE                       # guarded-by: _lock
        self.weight_version = 0                 # guarded-by: _lock
        self.max_consecutive_faults = max(1, int(max_consecutive_faults))
        self._consecutive_faults = 0            # guarded-by: _lock
        # engine rid -> FleetRequest, the router's outstanding-work signal
        self.inflight: Dict[int, FleetRequest] = {}  # guarded-by: _lock
        # prefix tokens (tuple) -> engine prefix_id; cleared on weight
        # install (engine.update_params drops old-policy prefix KV)
        self._prefixes: Dict[tuple, int] = {}   # guarded-by: _lock
        self._lock = threading.RLock()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        if registry is None:
            from ..obs import get_registry
            registry = get_registry()
        self._state_gauge = registry.gauge(
            "senweaver_serve_replica_state",
            "Replica health (0=live, 1=draining, 2=dead).",
            labelnames=("replica",))
        self._inflight_gauge = registry.gauge(
            "senweaver_serve_replica_inflight",
            "Requests decoding on this replica.",
            labelnames=("replica",))
        self._version_gauge = registry.gauge(
            "senweaver_serve_weight_version",
            "Weight version this replica is serving.",
            labelnames=("replica",))
        self._faults_total = registry.counter(
            "senweaver_serve_replica_faults_total",
            "Faults recorded against fleet replicas.",
            labelnames=("replica", "reason"))
        self._decode_tokens_gauge = registry.gauge(
            "senweaver_serve_replica_decode_tokens",
            "Remaining decode tokens (max_new_tokens - emitted) across "
            "this replica's in-flight requests — the router's "
            "outstanding-work signal.",
            labelnames=("replica",))
        self._state_gauge.set(0, replica=replica_id)
        self._inflight_gauge.set(0, replica=replica_id)
        self._version_gauge.set(0, replica=replica_id)
        self._decode_tokens_gauge.set(0, replica=replica_id)

    # -- capacity / routing signals -----------------------------------------
    @property
    def capacity(self) -> int:
        return int(getattr(self.engine, "num_slots", 8))

    @property
    def outstanding(self) -> int:
        with self._lock:
            return len(self.inflight)

    @property
    def outstanding_decode_tokens(self) -> int:
        """Remaining decode work in TOKENS: Σ max(0, max_new_tokens −
        emitted) over in-flight requests. A replica holding two nearly-
        finished generations has less outstanding work than one holding
        a single fresh 512-token request — in-flight COUNT can't see
        that; this can (the router's primary load signal)."""
        with self._lock:
            return sum(max(0, r.max_new_tokens - r.emitted)
                       for r in self.inflight.values())

    def _update_decode_gauge(self) -> None:
        """Caller holds the lock."""
        tokens = sum(max(0, r.max_new_tokens - r.emitted)
                     for r in self.inflight.values())
        self._decode_tokens_gauge.set(tokens, replica=self.replica_id)
        # Same signal, pushed INTO the engine: the speculation depth
        # controller reads remaining decode work as fleet load (an
        # engine without speculation has no hook; skip silently).
        note = getattr(self.engine, "note_decode_load", None)
        if note is not None:
            note(tokens)

    @property
    def kv_pressure(self) -> float:
        """This replica's KV block-pool utilization (0..1; 0.0 for
        engines without a pool) — the fleet pump aggregates it into the
        senweaver_kv_pressure gauge admission/autoscale watermark on."""
        return float(getattr(self.engine, "kv_pressure", 0.0))

    @property
    def accepting(self) -> bool:
        """Routable: live with a free decode slot."""
        with self._lock:
            return self.state == LIVE and len(self.inflight) < self.capacity

    @property
    def host(self) -> str:
        """Host-group key for rack-aware fanout (falls back to the
        replica id — every unlabeled replica is its own host)."""
        return self.host_group if self.host_group is not None \
            else self.replica_id

    def holds_prefix(self, tokens: Tuple[int, ...]) -> bool:
        with self._lock:
            return tokens in self._prefixes

    def prefix_in_host_tier(self, tokens: Tuple[int, ...]) -> bool:
        """True when this replica holds the prefix but its KV currently
        lives in the engine's host-RAM tier (a donor export from here
        costs zero device traffic — prefix_store counts those backfills
        separately)."""
        with self._lock:
            pid = self._prefixes.get(tuple(tokens))
            if pid is None:
                return False
            probe = getattr(self.engine, "prefix_in_host_tier", None)
            return bool(probe(pid)) if probe is not None else False

    # -- shared prefix broadcast (serve/prefix_store.py) ---------------------
    def register_shared_prefix(self, tokens: List[int]):
        """Donor side of the fleet broadcast: prefill ``tokens`` locally
        (once, content-deduped by the engine) and export the one-slot KV
        buffer. Returns ``(tokens, kv, last_logits)``."""
        with self._lock:
            if self.state == DEAD:
                raise ReplicaDead(self.replica_id)
            key = tuple(tokens)
            prefix_id = self._prefixes.get(key)
            if prefix_id is None:
                prefix_id = self.engine.register_prefix(list(tokens))
                self._prefixes[key] = prefix_id
            return self.engine.export_prefix(prefix_id)

    def export_shared_prefix(self, tokens: List[int]):
        """Re-export an ALREADY-resident prefix (no prefill): the
        nearest-copy backfill path reads a same-host peer's KV instead
        of the store's original donor export. KeyError if this replica
        never installed the prefix."""
        with self._lock:
            if self.state == DEAD:
                raise ReplicaDead(self.replica_id)
            prefix_id = self._prefixes[tuple(tokens)]
            return self.engine.export_prefix(prefix_id)

    def install_shared_prefix(self, tokens: List[int], kv,
                              last_logits=None) -> int:
        """Receive side: adopt a peer's prefix KV without prefilling
        (``engine.import_prefix`` — device-to-device copy, validated,
        LRU-accounted). Raises ``PrefixImportError`` on layout mismatch;
        the store translates that into graceful degradation."""
        with self._lock:
            if self.state == DEAD:
                raise ReplicaDead(self.replica_id)
            prefix_id = self.engine.import_prefix(list(tokens), kv,
                                                  last_logits)
            self._prefixes[tuple(tokens)] = prefix_id
            return prefix_id

    # -- lifecycle -----------------------------------------------------------
    def drain(self) -> None:
        """Stop accepting new work; in-flight decodes run to completion
        (the first half of a rolling weight swap)."""
        with self._lock:
            if self.state == DEAD:
                raise ReplicaDead(self.replica_id)
            self.state = DRAINING
            self._state_gauge.set(_STATE_CODE[DRAINING],
                                  replica=self.replica_id)

    def resume(self) -> None:
        with self._lock:
            if self.state == DEAD:
                raise ReplicaDead(self.replica_id)
            self.state = LIVE
            self._state_gauge.set(_STATE_CODE[LIVE],
                                  replica=self.replica_id)

    def kill(self) -> List[FleetRequest]:
        """Mark DEAD and hand back the orphaned in-flight requests for
        the router to resubmit. Idempotent — a second kill returns []."""
        with self._lock:
            if self.state == DEAD:
                return []
            self.state = DEAD
            self._state_gauge.set(_STATE_CODE[DEAD],
                                  replica=self.replica_id)
            orphans = list(self.inflight.values())
            self.inflight.clear()
            self._inflight_gauge.set(0, replica=self.replica_id)
            self._decode_tokens_gauge.set(0, replica=self.replica_id)
            return orphans

    def record_fault(self, reason: str = REASON_ERROR) -> bool:
        """Count a fault; returns True when this one crossed
        ``max_consecutive_faults`` (the replica is NOT killed here — the
        fleet does that so it can collect the orphans in one place)."""
        with self._lock:
            self._faults_total.inc(replica=self.replica_id, reason=reason)
            self._consecutive_faults += 1
            return self._consecutive_faults >= self.max_consecutive_faults

    # -- serving -------------------------------------------------------------
    def submit(self, req: FleetRequest) -> int:
        """Dispatch one admitted request onto this replica's engine.
        Registers the request's prefix on demand (prefix-affinity means
        the router usually picked a replica that already holds it).
        Raises whatever the engine raises — the fleet translates that
        into a fault + retry."""
        with self._lock:
            if self.state != LIVE:
                raise ReplicaDead(
                    f"{self.replica_id} is {self.state}, not accepting")
            prefix_id = None
            if req.prefix_tokens:
                key = tuple(req.prefix_tokens)
                prefix_id = self._prefixes.get(key)
                if prefix_id is None:
                    prefix_id = self.engine.register_prefix(
                        list(req.prefix_tokens))
                    self._prefixes[key] = prefix_id
            kwargs = dict(max_new_tokens=req.max_new_tokens,
                          prefix_id=prefix_id, eos_id=req.eos_id,
                          hold_slot=req.hold_slot)
            if req.tenant_id is not None and self.has_adapter(
                    req.tenant_id):
                # Tenant with a published adapter: the engine binds its
                # current version at submit. An unpublished tenant
                # decodes base-only — graceful, not an error.
                kwargs["adapter_id"] = req.tenant_id
            if getattr(self.engine, "supports_idempotency", False):
                # Stable per (ticket, dispatch attempt): an in-call
                # retry after a lost response REPLAYS on the server
                # instead of double-executing; a fresh requeue attempt
                # gets a fresh key (a cached transient error must not
                # shadow a later genuine try).
                kwargs["idempotency_key"] = \
                    f"ticket-{req.ticket}-a{req.attempts}"
            t0 = time.perf_counter()
            try:
                rid = self.engine.submit(req.prompt, **kwargs)
            except KeyError:
                if prefix_id is None or self._prefixes.get(key) != prefix_id:
                    raise
                # The engine dropped the prefix on its own (LRU, or the
                # pool-pressure ladder evicting an idle prefix): the
                # cached id is stale, not the replica broken. Register
                # again and resubmit once (a fresh idempotency key: the
                # server cached the KeyError under the first one).
                self._prefixes[key] = kwargs["prefix_id"] = \
                    self.engine.register_prefix(list(req.prefix_tokens))
                if "idempotency_key" in kwargs:
                    kwargs["idempotency_key"] += "-prefix"
                rid = self.engine.submit(req.prompt, **kwargs)
            # Engine-side submit cost (for a remote replica: RPC +
            # remote prefill) — the timeline's dispatched milestone
            # carries it as an attribute.
            req.submit_ms = (time.perf_counter() - t0) * 1000.0
            self.inflight[rid] = req
            req.replica_id = self.replica_id
            req.engine_rid = rid
            req.version_at_dispatch = self.weight_version
            self._consecutive_faults = 0
            self._inflight_gauge.set(len(self.inflight),
                                     replica=self.replica_id)
            self._update_decode_gauge()
            return rid

    def submit_group(self, reqs: List[FleetRequest]) -> List[int]:
        """Dispatch one GRPO group onto this replica through the
        engine's shared-prefill path (``engine.submit_group``: one
        prefill, the followers fork the donor's KV spine — sharing is
        strictly replica-local). All members land atomically or the
        call raises and the fleet degrades to per-member dispatch.
        Members are tracked individually, so completion, migration,
        and fault handling stay per-leaf."""
        with self._lock:
            if self.state != LIVE:
                raise ReplicaDead(
                    f"{self.replica_id} is {self.state}, not accepting")
            lead = reqs[0]
            kwargs = dict(max_new_tokens=lead.max_new_tokens,
                          eos_id=lead.eos_id)
            if lead.tenant_id is not None and self.has_adapter(
                    lead.tenant_id):
                kwargs["adapter_id"] = lead.tenant_id
            t0 = time.perf_counter()
            rids = self.engine.submit_group(
                list(lead.prompt), len(reqs), **kwargs)
            ms = (time.perf_counter() - t0) * 1000.0
            for rid, req in zip(rids, reqs):
                req.submit_ms = ms
                self.inflight[rid] = req
                req.replica_id = self.replica_id
                req.engine_rid = rid
                req.version_at_dispatch = self.weight_version
            self._consecutive_faults = 0
            self._inflight_gauge.set(len(self.inflight),
                                     replica=self.replica_id)
            self._update_decode_gauge()
            return rids

    def adopt(self, rid: int, req: FleetRequest) -> None:
        """Track an engine rid submitted outside :meth:`submit` (turn
        continuations pin themselves to the held slot's replica and call
        the engine directly)."""
        with self._lock:
            self.inflight[rid] = req
            req.replica_id = self.replica_id
            req.engine_rid = rid
            req.version_at_dispatch = self.weight_version
            self._inflight_gauge.set(len(self.inflight),
                                     replica=self.replica_id)
            self._update_decode_gauge()

    def detach(self, rid: int) -> Optional[FleetRequest]:
        """Stop tracking an engine rid WITHOUT completing it — the
        migration-out half of a live handoff (the engine-side state is
        the coordinator's problem: checkpointed and, after the target
        acks, released). Returns the FleetRequest, or None when the rid
        isn't tracked here (already completed / already detached —
        detach is idempotent so rescue paths can call it blindly)."""
        with self._lock:
            req = self.inflight.pop(rid, None)
            if req is not None:
                self._inflight_gauge.set(len(self.inflight),
                                         replica=self.replica_id)
                self._update_decode_gauge()
            return req

    def step(self) -> Tuple[Dict[int, List[int]], List[FleetRequest]]:
        """One engine step. Returns (emitted {engine_rid: [tokens]},
        completed FleetRequests). Engine exceptions propagate — the
        fleet records the fault and decides whether this kills us."""
        with self._lock:
            if self.state == DEAD:
                return {}, []
            emitted = self.engine.step()
            self._consecutive_faults = 0
            for rid, toks in emitted.items():
                req = self.inflight.get(rid)
                if req is not None:
                    req.emitted += len(toks)
            done: List[FleetRequest] = []
            for rid in list(self.inflight):
                if self.engine.is_done(rid):
                    req = self.inflight.pop(rid)
                    # Capture the finish version here, while we still
                    # hold the lock that install_weights needs: once we
                    # return, in-flight may be zero and the publisher
                    # can swap weights before the fleet records the
                    # completion.
                    req.version_at_finish = self.weight_version
                    done.append(req)
            if done:
                self._inflight_gauge.set(len(self.inflight),
                                         replica=self.replica_id)
            self._update_decode_gauge()
            return emitted, done

    def has_work(self) -> bool:
        with self._lock:
            return self.state != DEAD and bool(
                getattr(self.engine, "has_work", False))

    # -- weights -------------------------------------------------------------
    def install_weights(self, params, version: int,
                        epoch: Optional[int] = None) -> None:
        """Swap in a published weight version. The publisher only calls
        this at zero in-flight (drain-first), which is the whole
        no-mixed-versions guarantee; asserting it here turns a publisher
        bug into a loud error instead of silent off-policy tokens.

        Version-aware engines (``RemoteEngineClient``) get the fencing
        token too, so the REMOTE host enforces its own (epoch, version)
        high-water mark — a stale writer that somehow reaches a replica
        directly is still rejected at the engine boundary."""
        with self._lock:
            if self.inflight:
                raise RuntimeError(
                    f"{self.replica_id}: install_weights with "
                    f"{len(self.inflight)} in flight — drain first")
            if getattr(self.engine, "supports_versioned_update", False):
                self.engine.update_params(params, version=int(version),
                                          epoch=epoch)
            else:
                self.engine.update_params(params)
            self.weight_version = int(version)
            self._prefixes.clear()      # engine dropped old-policy KV
            self._version_gauge.set(version, replica=self.replica_id)

    def mark_draft_stale(self) -> None:
        """Publish-begin hook: the fleet is rolling new policy weights,
        so this replica's speculation draft no longer matches the
        policy being installed — stamp it stale and reset the
        acceptance EMA immediately (engines without speculation have
        no hook; no-op)."""
        with self._lock:
            if self.state == DEAD:
                return
            note = getattr(self.engine, "spec_note_publish_begin", None)
            if note is not None:
                note()

    def install_draft_weights(self, params, version: int) -> bool:
        """Install republished DRAFT weights (the online distiller's
        output). Unlike :meth:`install_weights` this never waits for
        drain: draft weights cannot affect output correctness, only
        acceptance rate, so the swap is safe mid-decode. Returns False
        when the engine has no speculation hook."""
        with self._lock:
            if self.state == DEAD:
                raise ReplicaDead(self.replica_id)
            update = getattr(self.engine, "update_draft_params", None)
            if update is None:
                return False
            update(params, version=int(version))
            return True

    def install_adapter(self, tenant_id: str, lora, version: int) -> bool:
        """Install one tenant's published LoRA adapter into the
        engine's pool. Like :meth:`install_draft_weights` this never
        waits for drain: the engine binds adapter versions at submit
        time, so in-flight decodes (this tenant's included) are
        untouched and only the tenant's NEXT requests see the new
        version. Returns False when the engine has no adapter pool."""
        with self._lock:
            if self.state == DEAD:
                raise ReplicaDead(self.replica_id)
            publish = getattr(self.engine, "publish_adapter", None)
            if publish is None:
                return False
            try:
                publish(tenant_id, lora, version=int(version))
            except RuntimeError:
                return False    # engine without an adapter pool
            return True

    def has_adapter(self, tenant_id: Optional[str]) -> bool:
        """True when this replica's engine can decode under the
        tenant's adapter (a version is published to its pool)."""
        fn = getattr(self.engine, "has_adapter", None)
        return bool(fn(tenant_id)) if fn is not None else False

    def has_adapter_resident(self, tenant_id: Optional[str]) -> bool:
        """True when the tenant's CURRENT adapter version already
        occupies a device slot here — the router's warm-affinity
        signal (no upload on the next submit)."""
        if tenant_id is None:
            return False
        fn = getattr(self.engine, "adapter_resident", None)
        return bool(fn(tenant_id)) if fn is not None else False

    def stamp_version(self, version: int) -> None:
        """Record the fleet's current published version on a replica
        that just joined (no weight transfer — the caller constructed it
        with current params). The fleet must NOT write
        ``weight_version`` directly: that attribute is guarded by THIS
        object's lock, which the fleet's own lock doesn't cover."""
        with self._lock:
            self.weight_version = int(version)
            self._version_gauge.set(version, replica=self.replica_id)

    # -- stepper thread (threaded mode) --------------------------------------
    def start(self, on_step, *, idle_sleep_s: float = 0.001) -> None:
        """Drive ``step()`` in a daemon thread while there is work;
        ``on_step(replica, emitted, done)`` is the fleet's completion
        intake (called outside the replica lock)."""
        if self._thread is not None:
            return
        self._stop.clear()

        def run():
            while not self._stop.is_set():
                if self.state == DEAD:
                    return
                if not self.has_work():
                    time.sleep(idle_sleep_s)
                    continue
                try:
                    emitted, done = self.step()
                except Exception:
                    # The fleet's dispatcher notices via record_fault on
                    # its next touch; the stepper must not die silently
                    # holding requests.
                    self.record_fault()
                    time.sleep(idle_sleep_s)
                    continue
                if emitted or done:
                    on_step(self, emitted, done)

        self._thread = threading.Thread(
            target=run, name=f"serve-step-{self.replica_id}", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def stats(self) -> Dict[str, object]:
        with self._lock:
            out = {"state": self.state,
                   "weight_version": self.weight_version,
                   "inflight": len(self.inflight),
                   "capacity": self.capacity}
        try:
            out["engine"] = self.engine.stats()
        except Exception as e:        # a dead engine still reports
            out["engine"] = {"error": str(e)}
        return out
