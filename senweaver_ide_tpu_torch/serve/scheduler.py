"""Global fleet scheduler + live-migration coordinator.

Before this module the fleet had three sanctioned ways to hurt a
request: the KV pressure ladder truncate-finishes a decode at the
preempt cap, an eager (no-drain) weight publish degrades to classic
draining when its patience runs out, and autoscale scale-down is
drain-then-kill. All three are the same problem — work is pinned to
the replica it started on — and all three get the same fix: checkpoint
the in-flight decode (``rollout/migration.py``), graft it onto a
replica with headroom, resume token-exactly.

Two objects:

* :class:`GlobalScheduler` — placement. Consumes the same per-replica
  signals the router balances on (KV pressure, remaining decode
  tokens, adapter residency) plus the federation store's staleness
  verdicts, and answers one question: *where should this decode go?*
  A replica whose gauges the fleet can no longer trust (stale peer) is
  never a migration target.

* :class:`MigrationCoordinator` — the two-phase handoff, run over the
  existing idempotency-keyed RPC layer:

  ::

      freeze (pause on source)
        → snapshot (checkpoint_request; ONE host gather)
          → fence check (same weight version on both ends, publisher
            quiescent — a publish landing mid-handoff forces a local
            finish on the source, NEVER a cross-version splice)
            → install on target (idempotency-keyed restore: at-least-
              once on the wire, exactly-once on the engine)
              → re-point fleet bookkeeping (router departure hook,
                source detach, target adopt)
                → ack on the target's FIRST post-migration token
                  → release on source

  The source keeps its frozen copy (blocks and all) until the ack: a
  target that dies mid-install or pre-first-token costs nothing — the
  coordinator resumes the source copy and the decode continues as if
  the handoff never happened (outcome ``rescued``). Completion is
  exactly-once because only ONE side is ever unpaused: the source
  until re-point, the target after, and the rescue path flips it back
  atomically under the fleet pump.

Failure outcomes (the ``outcome`` label on
``senweaver_serve_migrations_total``):

=================  ======================================================
``completed``      target acked its first post-migration token; source
                   copy released.
``rescued``        target died (or was partitioned into death) before
                   the ack; source copy resumed, decode finishes there.
``snapshot_abort`` checkpoint_request failed (source fault); request
                   simply resumes on the source.
``fence_abort``    a weight publish landed between snapshot and
                   install (version skew source↔target, or the
                   checkpoint's fence no longer matches) — local
                   finish on the source.
``install_abort``  restore RPC failed through its retry budget; source
                   copy resumed.
=================  ======================================================
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

from ..obs.incidents import emit_event
from .admission import FleetRequest
from .replica import DEAD, LIVE, EngineReplica

# A migration target must have at least this much free KV pool
# (1 - kv_pressure) before we graft a decode onto it — grafting onto a
# replica that is itself about to preempt just moves the problem.
DEFAULT_MIN_HEADROOM = 0.15


@dataclasses.dataclass
class PendingMigration:
    """One handoff between install-on-target and first-token ack."""
    ticket: int
    source: Optional[EngineReplica]   # None once the source died
    source_rid: int
    target: EngineReplica
    target_rid: int
    reason: str
    started_at: float


class GlobalScheduler:
    """Fleet-wide placement for migrating decodes.

    Reads the replicas' own gauges directly (they are authoritative for
    local replicas and RPC-backed for remote ones) and uses the
    federation store only as a VETO: a peer whose scrapes have gone
    stale may be partitioned, and grafting a decode onto a replica we
    cannot observe trades a known-good copy for an unobservable one."""

    def __init__(self, replicas: Sequence[EngineReplica], *,
                 fleet_store=None,
                 min_headroom: float = DEFAULT_MIN_HEADROOM):
        self.replicas = list(replicas)
        self.fleet_store = fleet_store
        self.min_headroom = float(min_headroom)

    def pick_target(self, source: Optional[EngineReplica], *,
                    tenant_id: Optional[str] = None,
                    require_version: Optional[int] = None,
                    need_headroom: bool = True,
                    exclude: Sequence[str] = ()) -> Optional[EngineReplica]:
        """The best replica to receive a migrating decode, or None
        when nowhere qualifies (the caller falls back to the legacy
        degrade path — truncate / drain — which is exactly what this
        module exists to make rare, not impossible)."""
        excluded = set(exclude)
        cands: List[EngineReplica] = []
        for r in self.replicas:
            if r is source or r.replica_id in excluded:
                continue
            if not r.accepting:                 # LIVE + free slot
                continue
            if require_version is not None \
                    and r.weight_version != require_version:
                continue
            if need_headroom \
                    and (1.0 - r.kv_pressure) < self.min_headroom:
                continue
            if self.fleet_store is not None \
                    and self.fleet_store.is_stale(r.replica_id):
                continue
            cands.append(r)
        if not cands:
            return None
        if tenant_id is not None:
            resident = [r for r in cands
                        if r.has_adapter_resident(tenant_id)]
            if resident:
                cands = resident
        return min(cands, key=lambda r: (r.kv_pressure,
                                         r.outstanding_decode_tokens,
                                         r.outstanding))


class MigrationCoordinator:
    """Runs live handoffs and owns their metrics + pending-ack ledger.

    Wired by ``ServingFleet.attach_migration()``; the fleet pump calls
    :meth:`pump` each tick, ``_ingest`` feeds :meth:`note_progress`,
    ``_complete`` feeds :meth:`note_complete`, and ``_handle_death``
    calls :meth:`on_replica_death` BEFORE the router triages orphans
    (rescue must pull the migrated copy out of the dead target's
    in-flight map so it is not double-requeued)."""

    def __init__(self, router, publisher=None, *,
                 scheduler: Optional[GlobalScheduler] = None,
                 fleet_store=None, registry=None):
        self.router = router
        self.publisher = publisher
        self.scheduler = scheduler or GlobalScheduler(
            router.replicas, fleet_store=fleet_store)
        # ticket -> PendingMigration (install done, first token pending)
        self.pending: Dict[int, PendingMigration] = {}
        # monotonically counts handoffs for idempotency-key uniqueness
        self._seq = 0
        if registry is None:
            from ..obs import get_registry
            registry = get_registry()
        self._migrations_total = registry.counter(
            "senweaver_serve_migrations_total",
            "Live decode migrations by trigger and outcome.",
            labelnames=("reason", "outcome"))
        self._migration_ms = registry.histogram(
            "senweaver_serve_migration_ms",
            "Wall ms from freeze to install-acked re-point (the ack "
            "itself lands with the target's next emitted token).")

    # -- the handoff ---------------------------------------------------------
    def migrate(self, req: FleetRequest, source: EngineReplica,
                target: EngineReplica, *, reason: str,
                now: float) -> bool:
        """Two-phase handoff of ``req`` from ``source`` to ``target``.
        Returns True when the install landed and fleet bookkeeping was
        re-pointed (the request now decodes on ``target``); False on
        any abort — in which case the request is resumed on ``source``
        and nothing was lost."""
        rid = req.engine_rid
        if rid is None or req.ticket in self.pending:
            return False
        t0 = time.perf_counter()

        # Phase 1: freeze + snapshot. checkpoint_request pauses the
        # row, so the source engine stops emitting for this request
        # the moment the snapshot is cut.
        try:
            ckpt = source.engine.checkpoint_request(rid)
        except Exception as e:
            self._abort(req, source, rid, reason, "snapshot_abort", e)
            return False
        ckpt = ckpt.with_fence(epoch=self._publisher_epoch(),
                               version=source.weight_version,
                               deadline=req.deadline)

        # Fence: a weight publish between snapshot and install means
        # the checkpoint's KV was produced by weights the target no
        # longer runs. Never splice across versions — finish locally
        # instead. The check is against the TARGET's resident version
        # (re-read here, after the snapshot), not the publisher's roll
        # target: mid-roll, migrating an old-version decode onto a
        # not-yet-swapped peer is legal — it is exactly the eager-
        # publish relief path — and the publisher cannot swap the
        # target concurrently because swaps and migrations both run
        # under the fleet's pump.
        if target.weight_version != ckpt.weight_version:
            self._abort(req, source, rid, reason, "fence_abort", None)
            return False

        # Phase 2: install on target. At-least-once on the wire (the
        # RPC client retries under the SAME idempotency key), exactly-
        # once on the engine (the server's idempotency cache replays
        # the first outcome).
        self._seq += 1
        key = f"mig-{req.ticket}-s{self._seq}"
        try:
            if getattr(target.engine, "supports_idempotency", False):
                new_rid = target.engine.restore_checkpoint(
                    ckpt.to_wire(), idempotency_key=key)
            else:
                new_rid = target.engine.restore_request(ckpt)
        except Exception as e:
            self._abort(req, source, rid, reason, "install_abort", e)
            return False

        # Re-point fleet bookkeeping. tokens_survive: the emitted
        # count and first-token timestamp moved WITH the checkpoint —
        # a migration is progress relocation, not a retry.
        self.router.on_request_departure(req, tokens_survive=True)
        source.detach(rid)
        target.adopt(new_rid, req)
        self.pending[req.ticket] = PendingMigration(
            ticket=req.ticket, source=source, source_rid=rid,
            target=target, target_rid=new_rid, reason=reason,
            started_at=now)
        self._migration_ms.observe((time.perf_counter() - t0) * 1000.0)
        emit_event("migration_start", t=now, ticket=req.ticket,
                   reason=reason, source=source.replica_id,
                   target=target.replica_id)
        return True

    def _abort(self, req: FleetRequest, source: EngineReplica,
               rid: int, reason: str, outcome: str,
               err: Optional[Exception]) -> None:
        """Any failure before re-point: unfreeze the source copy and
        count the outcome. The request never left the source, so there
        is nothing to undo on the target — a half-installed restore
        there is an unreferenced engine request the server's release
        path (or its own completion) cleans up."""
        try:
            source.engine.resume_request(rid)
        except Exception:
            pass    # source died too — death triage owns the request now
        self._migrations_total.inc(reason=reason, outcome=outcome)
        emit_event("migration_abort", ticket=req.ticket, reason=reason,
                   outcome=outcome,
                   error=(type(err).__name__ if err else ""))

    def _publisher_epoch(self) -> int:
        return int(getattr(self.publisher, "epoch", 0) or 0)

    # -- evacuation (scale-down + eager-publish relief) ----------------------
    def evacuate(self, source: EngineReplica, *, reason: str,
                 now: float, limit: Optional[int] = None,
                 exclude=()) -> int:
        """Migrate as many of ``source``'s in-flight decodes as the
        fleet has room for. Returns the number moved; whatever could
        not be placed keeps decoding on the source (the caller's
        legacy drain path still applies to the remainder)."""
        moved = 0
        with source._lock:
            work = list(source.inflight.items())
        for rid, req in work:
            if limit is not None and moved >= limit:
                break
            if req.hold_slot or req.ticket in self.pending:
                continue    # held slots pin multi-turn state; skip
            target = self.scheduler.pick_target(
                source, tenant_id=req.tenant_id,
                require_version=source.weight_version,
                exclude=exclude)
            if target is None:
                continue
            if self.migrate(req, source, target, reason=reason, now=now):
                moved += 1
        return moved

    # -- pump (KV pressure + eager publish call sites) -----------------------
    def pump(self, now: float) -> int:
        """One coordinator tick, called from the fleet pump:

        1. Drain each local engine's pressure-migration offers (rows
           the KV ladder would otherwise truncate-finish at the
           preempt cap) and move them to a replica with headroom —
           or resume them in place when nowhere qualifies, in which
           case the next cap trip truncates exactly as before.
        2. When an eager publish has been blocked long enough to risk
           degrading, migrate decodes off the blocked replicas toward
           same-version peers so the roll can advance before its
           patience runs out."""
        moved = 0
        for rep in self.router.replicas:
            if rep.state == DEAD:
                continue
            take = getattr(rep.engine, "take_pressure_migrations", None)
            if take is None:
                continue
            for rid in take():
                req = rep.inflight.get(rid)
                if req is None or req.ticket in self.pending:
                    continue
                target = self.scheduler.pick_target(
                    rep, tenant_id=req.tenant_id,
                    require_version=rep.weight_version)
                if target is not None and self.migrate(
                        req, rep, target, reason="kv_pressure", now=now):
                    moved += 1
                else:
                    # No headroom anywhere: unfreeze; the engine's
                    # _migration_offered set guarantees the NEXT cap
                    # trip truncate-finishes instead of re-offering
                    # (no livelock).
                    try:
                        rep.engine.resume_request(rid)
                    except Exception:
                        pass
        moved += self._pump_eager_relief(now)
        return moved

    def _pump_eager_relief(self, now: float) -> int:
        """Eager-publish call site: the publisher names the replicas
        whose outstanding work is blocking the no-drain roll; move
        their longest-remaining decodes to peers still on the same
        version so the blocked replicas drain without degrading."""
        if self.publisher is None:
            return 0
        pending_fn = getattr(self.publisher, "eager_pending", None)
        if pending_fn is None:
            return 0
        blocked_ids = set(pending_fn())
        if not blocked_ids:
            return 0
        moved = 0
        blocked = [r for r in self.router.replicas
                   if r.replica_id in blocked_ids and r.state != DEAD]
        if len(blocked) < 2:
            return 0    # one blocker: nowhere same-version to put it —
                        # every idle peer already swapped to the new
                        # version, and a cross-version splice is banned
        # Consolidate: the blocker with the MOST remaining decode work
        # drains last no matter what, so it becomes the receiver; every
        # other blocker evacuates into it, swaps on the next pump, and
        # the roll stops burning patience. (Receiver-directed, so two
        # blocked peers can never ping-pong work between each other.)
        receiver = max(blocked, key=lambda r: r.outstanding_decode_tokens)
        others = [r for r in self.router.replicas if r is not receiver]
        for rep in blocked:
            if rep is receiver:
                continue
            moved += self.evacuate(
                rep, reason="eager_publish", now=now,
                exclude=[r for r in others if r is not rep])
        return moved

    # -- ack / rescue --------------------------------------------------------
    def note_progress(self, req: FleetRequest, now: float) -> None:
        """First post-migration token observed (fleet ``_ingest``):
        the target owns the decode for real now — release the frozen
        source copy and count the handoff completed."""
        pend = self.pending.get(req.ticket)
        if pend is None:
            return
        if req.replica_id != pend.target.replica_id \
                or req.engine_rid != pend.target_rid:
            return          # token from a life the ledger already left
        self._finish_pending(pend, now)

    def note_complete(self, req: FleetRequest, now: float) -> None:
        """Defensive ack on completion — a decode that finishes on the
        target in the same step it was installed may never pass
        through ``_ingest`` with its pending entry still open."""
        pend = self.pending.get(req.ticket)
        if pend is None:
            return
        self._finish_pending(pend, now)

    def _finish_pending(self, pend: PendingMigration, now: float) -> None:
        self.pending.pop(pend.ticket, None)
        if pend.source is not None and pend.source.state != DEAD:
            try:
                pend.source.engine.release_request(pend.source_rid)
            except Exception:
                pass    # best-effort: a dead/partitioned source leaks
                        # nothing the fleet owns — its janitor reclaims
        self._migrations_total.inc(reason=pend.reason,
                                   outcome="completed")
        emit_event("migration_ack", t=now, ticket=pend.ticket,
                   reason=pend.reason,
                   target=pend.target.replica_id)

    def rescue_request(self, req: FleetRequest, now: float) -> bool:
        """Result-lost triage hook: a pre-ack migration TARGET failed
        to hand over its result (partition mid-handoff). The frozen
        source copy is still intact — resume it and re-point the fleet
        there. True = rescued (token-exact continuation on the source);
        False = no pending entry or the source is gone too, and the
        caller falls back to retry-from-prompt triage."""
        pend = self.pending.get(req.ticket)
        if pend is None:
            return False
        del self.pending[req.ticket]
        pend.target.detach(pend.target_rid)
        src = pend.source
        if src is None or src.state == DEAD:
            return False
        try:
            src.engine.resume_request(pend.source_rid)
        except Exception:
            return False
        self.router.on_request_departure(req, tokens_survive=True)
        src.adopt(pend.source_rid, req)
        self._migrations_total.inc(reason=pend.reason,
                                   outcome="rescued")
        emit_event("migration_rescue", t=now, ticket=pend.ticket,
                   source=src.replica_id,
                   target=pend.target.replica_id)
        return True

    def on_replica_death(self, replica: EngineReplica,
                         now: float) -> List[FleetRequest]:
        """Death intersects the pending ledger two ways:

        * the TARGET died pre-ack — the frozen source copy is the
          request: detach it from the dying target (so the router's
          orphan triage doesn't double-requeue it), resume the source
          row, re-adopt there. Token-exact, zero lost work, outcome
          ``rescued``.
        * the SOURCE died pre-ack — the target's copy is the request;
          the ledger just forgets the source so the eventual ack skips
          the release.

        Returns the requests rescued back onto their sources."""
        rescued: List[FleetRequest] = []
        for ticket, pend in list(self.pending.items()):
            if pend.target is replica:
                req = replica.detach(pend.target_rid)
                del self.pending[ticket]
                src = pend.source
                if src is None or src.state == DEAD:
                    # both ends gone — re-adopt on the dying target so
                    # normal orphan triage (retry-from-prompt) finds
                    # it; nothing to rescue
                    if req is not None:
                        replica.adopt(pend.target_rid, req)
                    continue
                try:
                    src.engine.resume_request(pend.source_rid)
                except Exception:
                    if req is not None:
                        replica.adopt(pend.target_rid, req)
                    continue
                if req is not None:
                    self.router.on_request_departure(
                        req, tokens_survive=True)
                    src.adopt(pend.source_rid, req)
                    rescued.append(req)
                self._migrations_total.inc(reason=pend.reason,
                                           outcome="rescued")
                emit_event("migration_rescue", t=now, ticket=ticket,
                           source=src.replica_id,
                           target=replica.replica_id)
            elif pend.source is replica:
                pend.source = None      # ack will skip the release
        return rescued

    def has_pending_on(self, replica: EngineReplica) -> bool:
        """True while ``replica`` is either end of an un-acked handoff
        — autoscale must not retire a frozen source out from under the
        exactly-once guarantee."""
        return any(p.source is replica or p.target is replica
                   for p in self.pending.values())

    def stats(self) -> Dict[str, object]:
        return {"pending": len(self.pending),
                "handoffs": self._seq}
