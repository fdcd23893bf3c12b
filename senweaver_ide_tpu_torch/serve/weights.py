"""Versioned weight publication with rolling replica swaps.

``RolloutEngine.update_params`` is instantaneous for one engine but a
fleet can't blink: swapping every replica at once means zero serving
capacity for the duration of N param transfers, and swapping NONE means
rollouts drift off-policy. The publisher threads the needle the way RLAX
/ Podracer actor fleets do — roll one replica at a time:

    for each live replica:  drain → wait for zero in-flight → swap →
                            resume

The fleet keeps serving on the other replicas throughout; the weight-
version SKEW this creates (some replicas on v, some on v+1 mid-roll) is
first-class and exported as ``senweaver_serve_weight_version_skew`` —
GRPO's importance ratio tolerates bounded skew, but only if you can see
it.

The roll is a resumable state machine advanced by :meth:`advance` (the
fleet pumps it between decode steps), never a blocking loop — a publish
must not stall the dispatcher that keeps the other replicas fed. Because
a replica swaps only at zero in-flight, no generation ever mixes tokens
from two weight versions; :meth:`EngineReplica.install_weights` asserts
exactly that.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Sequence

from ..obs.incidents import emit_event
from .placement import engine_device, on_device
from .replica import DEAD, LIVE, EngineReplica


class StalePublishError(RuntimeError):
    """Fenced-out publish: the offered ``(lease_epoch, weight_version)``
    is not ahead of the fleet's high-water mark. Raised instead of
    applied — a zombie or duplicate learner can never roll the fleet
    backward or interleave versions. Not retriable: the writer must
    re-acquire the lease (a higher epoch) before publishing again."""


class WeightPublisher:
    def __init__(self, replicas: Sequence[EngineReplica], *,
                 registry=None):
        self.replicas = list(replicas)
        # latest PUBLISHED (begun) version
        self.version = 0                        # guarded-by: _lock
        # Fencing high-water mark: the lease epoch of the newest
        # accepted publish. Within an epoch versions are strictly
        # monotonic; a HIGHER epoch may republish any version (the
        # crash-resume reconvergence path rolls back to the learner's
        # last durable version); a LOWER epoch is rejected outright.
        self.epoch = 0                          # guarded-by: _lock
        self._pending_params = None             # guarded-by: _lock
        self._roll_queue: List[EngineReplica] = []  # guarded-by: _lock
        self._current: Optional[EngineReplica] = None  # guarded-by: _lock
        # Eager (no-drain) roll state: while True the pump swaps
        # replicas opportunistically at zero in-flight instead of
        # draining them; _eager_waits counts consecutive pump steps
        # that swapped nothing, and past _eager_wait_limit the roll
        # falls back to classic draining so it always converges.
        self._eager = False                     # guarded-by: _lock
        self._eager_wait_limit = 512            # guarded-by: _lock
        self._eager_waits = 0                   # guarded-by: _lock
        self._lock = threading.RLock()
        if registry is None:
            from ..obs import get_registry
            registry = get_registry()
        self._skew_gauge = registry.gauge(
            "senweaver_serve_weight_version_skew",
            "Max minus min weight version across live replicas.")
        self._publishes_total = registry.counter(
            "senweaver_serve_publishes_total",
            "Weight versions published to the fleet.")
        self._rolled_total = registry.counter(
            "senweaver_serve_replicas_rolled_total",
            "Per-replica weight swaps completed.")
        self._quarantined_total = registry.counter(
            "senweaver_serve_publish_quarantined_total",
            "Replicas quarantined mid-publish (install unreachable/"
            "failed); the roll completes on the reachable set.")
        self._stale_total = registry.counter(
            "senweaver_serve_stale_publish_total",
            "Publishes rejected by (epoch, version) fencing — a stale "
            "or duplicate writer was denied.")
        self._eager_degrades_total = registry.counter(
            "senweaver_serve_eager_degrades_total",
            "Eager (no-drain) publishes that exhausted their patience "
            "and degraded to classic draining rolls.")
        # Draft (speculation) weight publishes share the epoch fence
        # with target publishes but keep their own version watermark.
        self.draft_version = 0                  # guarded-by: _lock
        self._draft_publishes_total = registry.counter(
            "senweaver_serve_draft_publishes_total",
            "Speculation-draft weight versions published to the fleet.")
        self._draft_install_failures_total = registry.counter(
            "senweaver_serve_draft_install_failures_total",
            "Per-replica draft installs that failed (replica keeps "
            "serving with its previous draft; never quarantined — "
            "drafts cannot corrupt outputs).")
        # Per-tenant LoRA adapter publishes: same no-drain shape as
        # drafts (they change only that tenant's NEXT requests, never a
        # decode in flight), same epoch fence, but one monotonic
        # version watermark PER TENANT.
        self.adapter_versions = {}              # guarded-by: _lock
        self._adapter_publishes_total = registry.counter(
            "senweaver_serve_adapter_fleet_publishes_total",
            "Tenant adapter versions published to the fleet.")
        self._adapter_install_failures_total = registry.counter(
            "senweaver_serve_adapter_install_failures_total",
            "Per-replica adapter installs that failed (replica keeps "
            "the tenant's previous adapter; never quarantined — the "
            "base policy is untouched).")
        # install_weights failures collected here for the fleet to turn
        # into proper deaths (orphan triage included); the publisher
        # itself never kills — it has no router.
        self._quarantined: List[EngineReplica] = []  # guarded-by: _lock
        self._skew_gauge.set(0)
        # begin() observers, called with the NEW version the moment a
        # publish is staged — before any replica swaps. The shared
        # prefix store invalidates here: its KV belongs to the old
        # policy from the instant a roll starts.
        self._on_begin: List = []               # guarded-by: _lock
        # end observers, called the pump step the roll fully lands —
        # the fleet closes its publish-pause timeline window here, so
        # the window edge is exact rather than poll-quantized.
        self._on_end: List = []                 # guarded-by: _lock

    def subscribe_begin(self, fn) -> None:
        """Register ``fn(version)`` to run at every :meth:`begin`."""
        with self._lock:
            self._on_begin.append(fn)

    def subscribe_end(self, fn) -> None:
        """Register ``fn(version)`` to run when a publish fully lands
        (every :meth:`advance` that transitions to not-in-progress)."""
        with self._lock:
            self._on_end.append(fn)

    def _fire_end(self) -> None:
        # guarded-by: _lock
        emit_event("publish_end", version=self.version)
        for fn in self._on_end:
            fn(self.version)

    @property
    def in_progress(self) -> bool:
        with self._lock:
            return self._pending_params is not None

    def skew(self) -> int:
        """Version spread across non-dead replicas (0 = converged)."""
        with self._lock:
            versions = [r.weight_version for r in self.replicas
                        if r.state != DEAD]
        if not versions:
            return 0
        return max(versions) - min(versions)

    def begin(self, params, *, epoch: Optional[int] = None,
              version: Optional[int] = None,
              eager: bool = False,
              eager_wait_limit: int = 512) -> int:
        """Stage a new version for rolling install; returns it. A begin
        during an unfinished roll fast-forwards: the in-progress roll
        retargets to the newest params (replicas already swapped to the
        superseded version will be re-rolled — they're in the queue
        again), which is the right semantics for a trainer publishing
        faster than the fleet drains.

        ``(epoch, version)`` is the fencing token a disaggregated
        learner stamps on every publish. Defaults (None) mean the
        in-process trainer path: current epoch, next version. The
        monotonic rule: ``epoch`` below the high-water mark is rejected
        (:class:`StalePublishError`); at the SAME epoch the version
        must strictly increase; a HIGHER epoch may carry any version —
        that is the crash-resume republish, which deliberately rolls
        the fleet back to the new leader's last durable weights.

        ``eager=True`` is the streaming learner's NO-DRAIN roll: the
        pump swaps replicas opportunistically as each hits zero
        in-flight on its own (requests keep finishing — the fleet
        never pauses admission for the publish), falling back to a
        classic drain for a replica that stays busy
        ``eager_wait_limit`` consecutive pump steps so convergence
        stays bounded under saturation. Generations still never mix
        weight versions — a replica swaps only at zero in-flight
        either way, which is what keeps every streamed episode's
        behavior stamp exact."""
        with self._lock:
            new_epoch = self.epoch if epoch is None else int(epoch)
            new_version = (self.version + 1 if version is None
                           else int(version))
            if new_epoch < self.epoch or (
                    new_epoch == self.epoch
                    and new_version <= self.version):
                self._stale_total.inc()
                raise StalePublishError(
                    f"publish (epoch={new_epoch}, version={new_version})"
                    f" is behind the fleet's high-water mark "
                    f"(epoch={self.epoch}, version={self.version})")
            self.epoch = new_epoch
            self.version = new_version
            self._pending_params = self._snapshot(params)
            self._publishes_total.inc()
            emit_event("publish_begin", version=new_version,
                       epoch=new_epoch, eager=bool(eager))
            # (Re)build the roll queue: every non-dead replica needs the
            # new version, including ones mid-drain from a previous roll.
            self._roll_queue = [r for r in self.replicas
                                if r.state != DEAD]
            self._current = None
            self._eager = bool(eager)
            self._eager_wait_limit = max(0, int(eager_wait_limit))
            self._eager_waits = 0
            # Speculation drafts are distilled against the OLD policy:
            # stamp them stale on every replica now — mirroring the
            # prefix-refcount drop below via _on_begin — instead of
            # letting acceptance gauges keep vouching for a draft that
            # no longer matches the weights being rolled out.
            for r in self.replicas:
                if r.state != DEAD:
                    mark = getattr(r, "mark_draft_stale", None)
                    if mark is not None:
                        mark()
            for fn in self._on_begin:
                fn(self.version)
            return self.version

    def _snapshot(self, params):
        # guarded-by: _lock
        """The roll's own copy of ``params``, made once per publish and
        installed on every replica. Tensors are mutable and a trainer
        steps its params in place, so a roll that spans many pump steps
        must not hold the caller's tree: a replica swapped late would
        serve weights a step newer than the version it is stamped with.
        The copy lands on the device of the fleet's in-process engines
        (a decoded wire payload arrives on the host) in their dtypes;
        remote replicas encode it from there."""
        local = next((r.engine for r in self.replicas
                      if r.state != DEAD
                      and engine_device(r.engine) is not None), None)
        if local is None:
            return on_device(params, copy=True)
        return on_device(params, engine_device(local),
                         like=getattr(local, "params", None), copy=True)

    def publish_draft(self, params, *, epoch: Optional[int] = None,
                      version: Optional[int] = None) -> int:
        """Publish republished DRAFT (speculation) weights through the
        same ``(epoch, version)`` fence as target publishes — a zombie
        distiller is denied exactly like a zombie learner — but with no
        drain/roll: a draft swap cannot affect output correctness (only
        the acceptance rate), so it applies to every live replica
        immediately instead of stalling behind a rolling drain. Returns
        the accepted draft version. Per-replica install failures are
        counted, not quarantined: the replica simply keeps its previous
        draft."""
        with self._lock:
            new_epoch = self.epoch if epoch is None else int(epoch)
            new_version = (self.draft_version + 1 if version is None
                           else int(version))
            if new_epoch < self.epoch or (
                    new_epoch == self.epoch
                    and new_version <= self.draft_version):
                self._stale_total.inc()
                raise StalePublishError(
                    f"draft publish (epoch={new_epoch}, "
                    f"version={new_version}) is behind the fleet's "
                    f"high-water mark (epoch={self.epoch}, "
                    f"draft_version={self.draft_version})")
            self.epoch = new_epoch
            self.draft_version = new_version
            self._draft_publishes_total.inc()
            emit_event("draft_publish", version=new_version,
                       epoch=new_epoch)
            for r in self.replicas:
                if r.state == DEAD:
                    continue
                install = getattr(r, "install_draft_weights", None)
                if install is None:
                    continue
                try:
                    install(params, new_version)
                except Exception:
                    self._draft_install_failures_total.inc()
            return new_version

    def publish_adapter(self, tenant_id: str, lora, *,
                        epoch: Optional[int] = None,
                        version: Optional[int] = None) -> int:
        """Publish one TENANT's LoRA adapter through the same
        ``(epoch, version)`` fence as target publishes, but with no
        drain/roll: an adapter publish changes only that tenant's NEXT
        requests (engines bind (rung, slot, version) at submit time),
        so it must never pause unrelated tenants' decodes, never stamp
        speculation drafts stale, and never drop shared prefixes —
        those belong to the BASE policy, which is untouched. The
        version watermark is per-tenant monotonic. Per-replica install
        failures are counted, not quarantined: the replica keeps
        serving the tenant's previous adapter (or base-only)."""
        with self._lock:
            new_epoch = self.epoch if epoch is None else int(epoch)
            cur = int(self.adapter_versions.get(tenant_id, 0))
            new_version = cur + 1 if version is None else int(version)
            if new_epoch < self.epoch or (
                    new_epoch == self.epoch and new_version <= cur):
                self._stale_total.inc()
                raise StalePublishError(
                    f"adapter publish (tenant={tenant_id!r}, "
                    f"epoch={new_epoch}, version={new_version}) is "
                    f"behind the fleet's high-water mark "
                    f"(epoch={self.epoch}, adapter_version={cur})")
            self.epoch = new_epoch
            self.adapter_versions[tenant_id] = new_version
            self._adapter_publishes_total.inc()
            emit_event("adapter_publish", tenant=tenant_id,
                       version=new_version, epoch=new_epoch)
            for r in self.replicas:
                if r.state == DEAD:
                    continue
                install = getattr(r, "install_adapter", None)
                if install is None:
                    continue
                try:
                    install(tenant_id, lora, new_version)
                except Exception:
                    self._adapter_install_failures_total.inc()
            return new_version

    def advance(self) -> bool:
        """One state-machine step of the roll; returns True when the
        publish has fully landed (or there was none). Called by the
        fleet's pump between decode steps, so draining replicas keep
        stepping their in-flight work toward zero."""
        with self._lock:
            if self._pending_params is None:
                self._update_skew()
                return True
            if self._eager:
                return self._advance_eager()
            if self._current is None:
                # Next replica to roll; skip ones that died mid-roll.
                while self._roll_queue:
                    cand = self._roll_queue.pop(0)
                    if cand.state != DEAD:
                        self._current = cand
                        break
                if self._current is None:       # queue exhausted
                    self._pending_params = None
                    self._update_skew()
                    self._fire_end()
                    return True
                if self._current.state == LIVE:
                    self._current.drain()
            cur = self._current
            if cur.state == DEAD:
                # Died while draining: its orphans are the router's
                # problem; the roll just moves on.
                self._current = None
                self._update_skew()
                return False
            if cur.outstanding == 0:
                try:
                    cur.install_weights(self._pending_params,
                                        self.version, epoch=self.epoch)
                except Exception:
                    # Unreachable (or otherwise failed) mid-publish: the
                    # roll must converge on the REACHABLE set, not wedge
                    # behind one dead host. Quarantine the replica for
                    # the fleet to reap — a straggler that recovers
                    # re-syncs through add_replica (version stamp) and
                    # the lazy prefix backfill path.
                    self._quarantined_total.inc()
                    self._quarantined.append(cur)
                    self._current = None
                    if not self._roll_queue:
                        self._pending_params = None
                        self._update_skew()
                        self._fire_end()
                        return True
                    self._update_skew()
                    return False
                cur.resume()
                self._rolled_total.inc()
                self._current = None
                if not self._roll_queue:
                    self._pending_params = None
                    self._update_skew()
                    self._fire_end()
                    return True
            self._update_skew()
            return False

    def _advance_eager(self) -> bool:
        # guarded-by: caller (advance() holds _lock). No-drain roll: swap
        # every queued replica currently at zero in-flight; replicas
        # stay LIVE throughout so fleet capacity never dips. A pump step
        # that swaps nothing burns one unit of eager patience; past the
        # limit the roll degrades to the classic draining machinery
        # (self._eager = False) so a saturated replica can't wedge the
        # publish forever.
        self._roll_queue = [r for r in self._roll_queue
                            if r.state != DEAD]
        swapped = 0
        remaining: List[EngineReplica] = []
        for cand in self._roll_queue:
            if cand.outstanding != 0:
                remaining.append(cand)
                continue
            try:
                cand.install_weights(self._pending_params,
                                     self.version, epoch=self.epoch)
            except Exception:
                self._quarantined_total.inc()
                self._quarantined.append(cand)
                continue
            if cand.state != LIVE:
                cand.resume()
            self._rolled_total.inc()
            swapped += 1
        self._roll_queue = remaining
        if not self._roll_queue:
            self._pending_params = None
            self._update_skew()
            self._fire_end()
            return True
        if swapped == 0:
            self._eager_waits += 1
            if self._eager_waits > self._eager_wait_limit:
                # Patience exhausted: fall back to draining rolls.
                # LOUDLY — this is the no-drain guarantee degrading to
                # the exact drain it promised to avoid, so the incident
                # journal gets a first-class event (the correlator can
                # name it as a cause) and a counter tracks the rate.
                self._eager = False
                self._eager_degrades_total.inc()
                emit_event("eager_degrade", version=self.version,
                           waits=self._eager_waits,
                           blocked=len(self._roll_queue))
        else:
            self._eager_waits = 0
        self._update_skew()
        return False

    def eager_pending(self) -> List[str]:
        """Replica ids still BLOCKED on an in-progress eager roll
        (queued for the new version, in-flight work > 0). The
        migration coordinator reads this to move long decodes off
        blocked replicas — onto peers still at the OLD version — so
        eager patience never runs out in the first place."""
        with self._lock:
            if self._pending_params is None or not self._eager:
                return []
            return [r.replica_id for r in self._roll_queue
                    if r.state != DEAD and r.outstanding > 0]

    def take_quarantined(self) -> List[EngineReplica]:
        """Drain the replicas whose install failed mid-roll; the fleet
        escalates each through its normal death path."""
        with self._lock:
            out = self._quarantined
            self._quarantined = []
            return out

    def _update_skew(self) -> None:
        self._skew_gauge.set(self.skew())
