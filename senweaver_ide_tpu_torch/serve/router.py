"""SLO-aware request routing across the replica fleet.

Two signals, in order:

1. **Prefix affinity** — a request carrying ``prefix_tokens`` (the
   shared agent system prompt) prefers a replica that already holds that
   prefix's KV: installing it there is one HBM copy
   (``engine._install_prefix``) instead of a full prefill on a cold
   replica. Ties break by least outstanding work.
2. **Least outstanding work, in decode TOKENS** — otherwise the live
   replica with the fewest REMAINING decode tokens wins
   (Σ ``max_new_tokens − emitted`` over its in-flight requests, which
   replicas already track per request). In-flight count treats a
   replica two steps from draining the same as one holding fresh
   512-token generations; remaining tokens is the actual queue-time
   signal. Count is kept as the tiebreaker.

Replica death is the router's second job: orphaned in-flight requests
come back through :meth:`on_replica_death`, which either schedules a
retry on the surviving fleet — backoff via the SAME exponential shape
the episode fault boundary uses (``resilience.episode_retry_delay_s``)
— or sheds the request with a typed ``Rejected`` once its retry budget
is spent. A retried request restarts from its prompt: partial tokens
from the dead replica are discarded (they may belong to a different
weight version than the surviving replicas serve).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from ..resilience.retry import RetryPolicy
from .admission import (REJECT_NO_REPLICAS, REJECT_REPLICA_FAILURE,
                        FleetRequest, Rejected)
from .replica import EngineReplica


class Router:
    def __init__(self, replicas: Sequence[EngineReplica], *,
                 max_retries: int = 2,
                 retry_base_delay_s: float = 0.05,
                 retry_max_delay_s: float = 2.0,
                 registry=None):
        self.replicas = list(replicas)
        # The shared resilience retry shape; UNJITTERED — requeue
        # backoff is enforced by fake-clock-friendly `not_before`
        # timestamps, and deterministic delays keep the SLO tests exact.
        self.retry = RetryPolicy(max_retries=int(max_retries),
                                 base_delay_s=retry_base_delay_s,
                                 max_delay_s=retry_max_delay_s,
                                 jitter=False)
        if registry is None:
            from ..obs import get_registry
            registry = get_registry()
        self._affinity_hits = registry.counter(
            "senweaver_serve_prefix_affinity_hits_total",
            "Requests routed to a replica already holding their prefix.")
        self._adapter_affinity_hits = registry.counter(
            "senweaver_serve_adapter_affinity_hits_total",
            "Tenant requests routed to a replica whose pool already "
            "holds their current adapter version (no upload at submit).")
        self._retries_total = registry.counter(
            "senweaver_serve_retries_total",
            "Requests resubmitted after a replica death/fault.")
        self._deaths_total = registry.counter(
            "senweaver_serve_replica_deaths_total",
            "Replicas declared dead.")

    # -- selection -----------------------------------------------------------
    def live_replicas(self) -> List[EngineReplica]:
        from .replica import DEAD
        return [r for r in self.replicas if r.state != DEAD]

    def pick(self, req: FleetRequest) -> Optional[EngineReplica]:
        """Choose a replica for ``req`` (None = nothing accepting; the
        request stays queued)."""
        accepting = [r for r in self.replicas if r.accepting]
        if not accepting:
            return None
        def load(r: EngineReplica):
            return (r.outstanding_decode_tokens, r.outstanding)

        if req.prefix_tokens:
            key = tuple(req.prefix_tokens)
            warm = [r for r in accepting if r.holds_prefix(key)]
            if warm:
                self._affinity_hits.inc()
                req.routed_by = "affinity"
                return min(warm, key=load)
        if req.tenant_id is not None:
            # Tenant→adapter-slot affinity, below prefix affinity
            # (prefix KV is the bigger transfer) but above raw load: a
            # replica whose pool already holds the tenant's CURRENT
            # adapter version skips the submit-time upload.
            resident = [
                r for r in accepting
                if getattr(r, "has_adapter_resident", None) is not None
                and r.has_adapter_resident(req.tenant_id)]
            if resident:
                self._adapter_affinity_hits.inc()
                req.routed_by = "adapter_affinity"
                return min(resident, key=load)
        req.routed_by = "load"
        return min(accepting, key=load)

    def load_snapshot(self) -> dict:
        """Per-replica remaining-decode-token snapshot — the signal
        :meth:`pick` balances on, exposed for the speculation depth
        controller's report surface (scripts/spec_report.py) and the
        dashboard. Keys are replica ids; DEAD replicas are omitted."""
        return {r.replica_id: r.outstanding_decode_tokens
                for r in self.live_replicas()}

    # -- failure handling ----------------------------------------------------
    def on_request_departure(self, req: FleetRequest, *,
                             tokens_survive: bool = False) -> None:
        """THE hook for a request leaving a replica without completing
        — replica death, result-lost triage, or migration-out. Clears
        the dispatch state in one place so the load accounting
        (remaining decode tokens = ``max_new_tokens − emitted``) can
        never go stale-high on a replica the request no longer
        occupies.

        ``tokens_survive=False`` (death / lost result): the partial
        tokens died with the replica — the retry restarts from the
        prompt, so ``emitted`` resets and the attempt is spent.
        ``tokens_survive=True`` (live migration): the tokens moved
        WITH the request — ``emitted`` and ``first_token_at`` are
        real progress and a migration is not a retry."""
        req.replica_id = None
        req.engine_rid = None
        req.version_at_dispatch = None
        req.version_at_finish = None
        if not tokens_survive:
            req.attempts += 1
            req.first_token_at = None
            req.emitted = 0     # partial tokens died with the replica

    def on_replica_death(self, replica: EngineReplica, now: float
                         ) -> Tuple[List[FleetRequest], List[Rejected]]:
        """Kill ``replica`` and triage its orphans: (requeue, shed).

        Requeued requests carry a ``not_before`` backoff floor — the
        dispatcher won't touch them until it passes — and cleared
        dispatch state (their partial tokens died with the replica)."""
        orphans = replica.kill()
        self._deaths_total.inc()
        requeue: List[FleetRequest] = []
        shed: List[Rejected] = []
        have_survivors = bool(self.live_replicas())
        for req in orphans:
            self.on_request_departure(req, tokens_survive=False)
            if not have_survivors:
                shed.append(Rejected(
                    ticket=req.ticket, priority=req.priority,
                    reason=REJECT_NO_REPLICAS,
                    detail="last replica died"))
            elif req.attempts > self.max_retries:
                shed.append(Rejected(
                    ticket=req.ticket, priority=req.priority,
                    reason=REJECT_REPLICA_FAILURE,
                    detail=f"retry budget spent "
                           f"({req.attempts - 1} retries)"))
            else:
                req.not_before = now + self.retry.backoff_s(req.attempts)
                self._retries_total.inc()
                requeue.append(req)
        return requeue, shed

    # -- policy accessors (fleet + legacy callers) ---------------------------
    @property
    def max_retries(self) -> int:
        return self.retry.max_retries

    @property
    def retry_base_delay_s(self) -> float:
        return self.retry.base_delay_s

    @property
    def retry_max_delay_s(self) -> float:
        return self.retry.max_delay_s
