"""Fleet-side learner gateway: lease authority + fenced publish over rpc.

The serving fleet is the single authority over its replicas, so it is
also the natural home for the learner lease: colocating the
:class:`~..resilience.lease.LeaseStore` with the fleet gives
single-writer semantics without a coordination service. The handler
exposes exactly the surface a disaggregated learner needs:

====================  ========================================================
method                semantics
====================  ========================================================
acquire_lease         grant the publish lease at a fresh (higher) fencing
                      epoch; a restarted learner fences out its zombie twin
renew_lease           heartbeat; raises ``LeaseLost`` when superseded/expired
release_lease         voluntary release (the epoch is retired, never reused)
publish               STAGE a fenced ``(epoch, version)`` publish; the
                      fleet's own pump rolls it replica by replica. Validated
                      twice: live-lease check here, monotonic high-water
                      check in ``WeightPublisher.begin``. Idempotent under
                      retried request ids — a publish whose response was
                      lost replays instead of staging twice.
publish_status        roll progress + convergence; in manual-pump fleets each
                      poll also advances the fleet one step, so a learner
                      polling over loopback drives the roll it is waiting on
signals / fleet_stats the autoscaler-ish load surface (queue depth, sheds,
                      versions) a learner or operator reads over the wire
====================  ========================================================

Publishes are a resumable saga: stage (durable fleet-side) → roll
(advanced by the fleet pump, partition-tolerant via quarantine) →
confirm (the learner polls ``publish_status``). A learner killed after
stage loses nothing — the roll still lands; its successor re-acquires
the lease at a higher epoch and republishes its last durable version,
which supersedes any torn roll.

:func:`serve_fleet_http` puts the handler on a real socket (same JSON
frame as the engine shim); tests run it behind ``LoopbackTransport``
with a ``NetworkFaultPlan`` for deterministic partition chaos.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from ..obs.federation import MetricsScrapeMixin
from ..resilience.lease import LeaseStore
from .remote_server import RpcHandlerBase, serve_rpc_http
from .replica import DEAD

# Publish staging consults the idempotency cache (a staged publish
# whose response was lost must REPLAY, never double-stage), as does
# federation ``scrape`` (a retried scrape must replay the same delta,
# its cursor already advanced).
LEARNER_MUTATING_METHODS = frozenset({"publish", "publish_adapter",
                                      "scrape"})
# Lease mutations are deliberately NOT cached — re-executing them on a
# retry is safe (acquire grants a fresh higher epoch, renew/release
# are idempotent on live state), whereas caching them lets a restarted
# client whose request ids collide with a previous incarnation replay
# that incarnation's lease grant and run at a zombie epoch, defeating
# the fencing (rpc_lint RPC103 keeps them OUT of the cached set).
# publish_status rides along: each manual-pump poll advances the fleet
# one step, so it mutates, but an extra step on a retry is harmless.
LEARNER_REEXECUTE_SAFE_METHODS = frozenset({
    "acquire_lease", "renew_lease", "release_lease", "publish_status"})
# Reads; never cached, must see fresh state.
LEARNER_READONLY_METHODS = frozenset({"signals", "fleet_stats",
                                      "health"})


class FleetRpcHandler(MetricsScrapeMixin, RpcHandlerBase):
    """Lease + fenced-publish dispatch table over one ServingFleet."""

    mutating_methods = LEARNER_MUTATING_METHODS
    readonly_methods = LEARNER_READONLY_METHODS
    reexecute_safe_methods = LEARNER_REEXECUTE_SAFE_METHODS
    # Stitched-trace role: spans from this handler belong to the
    # fleet/learner gateway process (see obs/propagation.py).
    span_service = "fleet"

    def __init__(self, fleet, *, lease_store: Optional[LeaseStore] = None,
                 lease_ttl_s: float = 30.0, clock=None,
                 idempotency_cache_size: int = 1024, registry=None):
        super().__init__(idempotency_cache_size=idempotency_cache_size)
        self.fleet = fleet
        self.clock = clock if clock is not None else fleet.clock
        if registry is None:
            registry = fleet.registry
        self.lease_store = lease_store or LeaseStore(
            ttl_s=lease_ttl_s, registry=registry)

    # -- lease ---------------------------------------------------------------
    def _m_acquire_lease(self, holder, steal=False) -> Dict[str, Any]:
        """Reexecute-safe, never cached: re-execution grants a fresh
        HIGHER epoch, while a cached replay could hand a restarted
        client a previous incarnation's (zombie) epoch."""
        lease = self.lease_store.acquire(str(holder), now=self.clock(),
                                         steal=bool(steal))
        return {"epoch": lease.epoch, "expires_at": lease.expires_at,
                "ttl_s": self.lease_store.ttl_s}

    def _m_renew_lease(self, holder, epoch) -> Dict[str, Any]:
        """Reexecute-safe: renewal is idempotent on LIVE state; a
        cached replay could acknowledge an epoch that has since been
        superseded."""
        lease = self.lease_store.renew(str(holder), int(epoch),
                                       now=self.clock())
        return {"epoch": lease.epoch, "expires_at": lease.expires_at}

    def _m_release_lease(self, holder, epoch) -> Dict[str, Any]:
        """Reexecute-safe: releasing an already-released epoch is a
        no-op on live state, so retries need no cache."""
        return {"released": self.lease_store.release(str(holder),
                                                     int(epoch))}

    # -- publish saga --------------------------------------------------------
    def _m_publish(self, params, epoch, version,
                   eager=False) -> Dict[str, Any]:
        """Cached-mutating: a staged publish whose response was lost
        must REPLAY on retry, never double-stage."""
        # Fencing check 1: the epoch must be the LIVE lease (raises
        # LeaseLost across the wire). Check 2 is the publisher's own
        # monotonic high-water mark — both must pass. ``eager``
        # requests the no-drain roll (the streaming learner's default).
        self.lease_store.validate(int(epoch), now=self.clock())
        v = self.fleet.begin_publish(params, epoch=int(epoch),
                                     version=int(version),
                                     eager=bool(eager))
        return {"version": v, "epoch": int(epoch), "staged": True,
                "eager": bool(eager)}

    def _m_publish_adapter(self, tenant_id, lora, epoch,
                           version=None) -> Dict[str, Any]:
        """Cached-mutating: a lost-response retry replays the first
        apply instead of re-installing the adapter."""
        # Same double fencing as _m_publish (live lease here, per-
        # tenant monotonic watermark in WeightPublisher), but the
        # apply is immediate and no-drain: there is no roll to poll.
        self.lease_store.validate(int(epoch), now=self.clock())
        v = self.fleet.publish_adapter(
            str(tenant_id), lora, epoch=int(epoch),
            version=None if version is None else int(version))
        return {"tenant_id": str(tenant_id), "version": v,
                "epoch": int(epoch), "applied": True}

    def _m_publish_status(self) -> Dict[str, Any]:
        """Reexecute-safe: each poll may pump the fleet one step, so it
        mutates, but a retry's extra step is harmless and the caller
        needs FRESH roll progress, never a cached replay."""
        # Manual-pump fleets advance one step per poll so a loopback
        # learner's status loop drives the roll it waits on; threaded
        # fleets are already pumped by their dispatcher.
        if not self.fleet.threaded:
            self.fleet.step()
        pub = self.fleet.publisher
        versions = [r.weight_version for r in self.fleet.replicas
                    if r.state != DEAD]
        return {
            "in_progress": pub.in_progress,
            "version": pub.version,
            "epoch": pub.epoch,
            "skew": pub.skew(),
            "replicas_live": len(versions),
            "min_version": min(versions) if versions else 0,
            "max_version": max(versions) if versions else 0,
            "converged": (not pub.in_progress and versions != []
                          and min(versions) == max(versions)
                          == pub.version),
        }

    # -- load / health surface -----------------------------------------------
    def _m_signals(self) -> Dict[str, Any]:
        pub = self.fleet.publisher
        return {
            "queue_depth": self.fleet.admission.depth(),
            "replicas_live": sum(r.state != DEAD
                                 for r in self.fleet.replicas),
            "weight_version": pub.version,
            "publish_epoch": pub.epoch,
            "publish_in_progress": pub.in_progress,
        }

    def _m_fleet_stats(self) -> Dict[str, Any]:
        s = self.fleet.stats()
        return {k: s[k] for k in (
            "replicas_live", "queue_depth", "pending", "completed",
            "rejected", "weight_version", "publish_epoch",
            "weight_version_skew", "publish_in_progress") if k in s}

    def _m_health(self) -> Dict[str, Any]:
        return {"state": "ok",
                "replicas_live": sum(r.state != DEAD
                                     for r in self.fleet.replicas)}


def serve_fleet_http(fleet_or_handler, *, host: str = "127.0.0.1",
                     port: int = 0):
    """Serve a fleet's learner gateway over real HTTP; returns
    ``(server, port)`` (started daemon ``ThreadingHTTPServer``)."""
    handler = (fleet_or_handler
               if isinstance(fleet_or_handler, FleetRpcHandler)
               else FleetRpcHandler(fleet_or_handler))
    return serve_rpc_http(handler, host=host, port=port,
                          thread_name="serve-learner-http")


# -- standalone lease authority (satellite: shared across fleets) ------------

LEASE_MUTATING_METHODS = frozenset({"scrape"})
# No LEASE op is cached, on purpose — the zombie-grant rule, in
# its new topology:
# idempotency-caching a lease grant would let a restarted client whose
# request ids collide with a previous incarnation REPLAY that
# incarnation's epoch and write as a zombie. Re-EXECUTING lease ops on
# a retried request id is always safe (acquire grants a fresh higher
# epoch; renew/release act on live state), so the mutating lease ops
# live in the reexecute-safe set (rpc_lint RPC103 fails the gate if
# one ever migrates into the cached set). ``scrape`` (federation delta
# shipping) is the one exception: its per-scraper cursor makes replays
# the only safe retry.
LEASE_REEXECUTE_SAFE_METHODS = frozenset({
    "acquire_lease", "renew_lease", "release_lease"})
# validate_lease only READS (it raises when the epoch isn't live);
# lease_info/health are plain reads.
LEASE_READONLY_METHODS = frozenset({"validate_lease", "lease_info",
                                    "health"})


class LeaseRpcHandler(MetricsScrapeMixin, RpcHandlerBase):
    """The learner lease as its OWN process: one
    :class:`~..resilience.lease.LeaseStore` behind an rpc endpoint, so
    several fleets can share a single learner (each fleet's
    :class:`FleetRpcHandler` delegates through a
    :class:`RemoteLeaseStore`) without any fleet being the authority.
    Time is always THIS process's clock — lease validity must not
    depend on N fleet clocks agreeing."""

    mutating_methods = LEASE_MUTATING_METHODS
    readonly_methods = LEASE_READONLY_METHODS
    reexecute_safe_methods = LEASE_REEXECUTE_SAFE_METHODS
    span_service = "lease"

    def __init__(self, store: Optional[LeaseStore] = None, *,
                 ttl_s: float = 30.0, clock=None,
                 idempotency_cache_size: int = 256, registry=None):
        super().__init__(idempotency_cache_size=idempotency_cache_size)
        import time as _time
        self.store = store or LeaseStore(ttl_s=ttl_s, registry=registry)
        self.clock = clock if clock is not None else _time.monotonic

    def _m_acquire_lease(self, holder, steal=False) -> Dict[str, Any]:
        """Reexecute-safe, never cached: re-execution grants a fresh
        HIGHER epoch; a cached replay would resurrect a zombie one."""
        lease = self.store.acquire(str(holder), now=self.clock(),
                                   steal=bool(steal))
        return {"epoch": lease.epoch, "expires_at": lease.expires_at,
                "ttl_s": self.store.ttl_s}

    def _m_renew_lease(self, holder, epoch) -> Dict[str, Any]:
        """Reexecute-safe: idempotent on live state; replay could
        acknowledge a superseded epoch."""
        lease = self.store.renew(str(holder), int(epoch),
                                 now=self.clock())
        return {"epoch": lease.epoch, "expires_at": lease.expires_at}

    def _m_release_lease(self, holder, epoch) -> Dict[str, Any]:
        """Reexecute-safe: double-release is a no-op on live state."""
        return {"released": self.store.release(str(holder), int(epoch))}

    def _m_validate_lease(self, epoch) -> Dict[str, Any]:
        # Raises LeaseLost across the wire when ``epoch`` isn't live —
        # the fencing check a fleet runs before staging a publish.
        self.store.validate(int(epoch), now=self.clock())
        return {"valid": True, "epoch": int(epoch)}

    def _m_lease_info(self) -> Dict[str, Any]:
        cur = self.store.current()
        return {"ttl_s": self.store.ttl_s,
                "epoch": self.store.current_epoch,
                "holder": cur.holder if cur is not None else None}

    def _m_health(self) -> Dict[str, Any]:
        return {"state": "ok", "epoch": self.store.current_epoch}


class RemoteLeaseStore:
    """Client-side duck of :class:`~..resilience.lease.LeaseStore` over
    rpc — what a fleet injects as ``FleetRpcHandler(lease_store=...)``
    when the lease authority runs in its own process. The surface
    matches the in-memory store (acquire/renew/release/validate +
    ``ttl_s``); callers' ``now=`` kwargs are accepted for signature
    compatibility but IGNORED — the authority's clock is the only one
    that counts. Typed lease errors (``LeaseLost``,
    ``LeaseUnavailable``) rehydrate across the wire as themselves."""

    def __init__(self, transport, *, name: Optional[str] = None,
                 policy=None, clock=None, sleep=None, rng=None,
                 registry=None):
        from ..resilience.retry import RetryPolicy
        from .learner import FleetPublishClient
        import time as _time
        self._rpc = FleetPublishClient(
            transport, name=name,
            policy=policy or RetryPolicy(max_retries=3,
                                         base_delay_s=0.05,
                                         max_delay_s=2.0),
            clock=clock if clock is not None else _time.monotonic,
            sleep=sleep, rng=rng, registry=registry)
        self.name = self._rpc.name
        self._ttl_s: Optional[float] = None

    @property
    def ttl_s(self) -> float:
        if self._ttl_s is None:
            self._ttl_s = float(self._rpc._call("lease_info")["ttl_s"])
        return self._ttl_s

    def acquire(self, holder: str, *, now: Optional[float] = None,
                steal: bool = False):
        from ..resilience.lease import Lease
        out = self._rpc._call("acquire_lease",
                              {"holder": str(holder),
                               "steal": bool(steal)})
        self._ttl_s = float(out.get("ttl_s", self._ttl_s or 30.0))
        return Lease(holder=str(holder), epoch=int(out["epoch"]),
                     expires_at=float(out["expires_at"]))

    def renew(self, holder: str, epoch: int, *,
              now: Optional[float] = None):
        from ..resilience.lease import Lease
        out = self._rpc._call("renew_lease",
                              {"holder": str(holder),
                               "epoch": int(epoch)})
        return Lease(holder=str(holder), epoch=int(out["epoch"]),
                     expires_at=float(out["expires_at"]))

    def release(self, holder: str, epoch: int) -> bool:
        out = self._rpc._call("release_lease",
                              {"holder": str(holder),
                               "epoch": int(epoch)})
        return bool(out.get("released"))

    def validate(self, epoch: int, *,
                 now: Optional[float] = None) -> None:
        self._rpc._call("validate_lease", {"epoch": int(epoch)})


def serve_lease_http(store_or_handler=None, *, host: str = "127.0.0.1",
                     port: int = 0, ttl_s: float = 30.0):
    """Serve a standalone lease authority over real HTTP; returns
    ``(server, port)``."""
    handler = (store_or_handler
               if isinstance(store_or_handler, LeaseRpcHandler)
               else LeaseRpcHandler(store_or_handler, ttl_s=ttl_s))
    return serve_rpc_http(handler, host=host, port=port,
                          thread_name="serve-lease-http")


# -- streaming experience intake (learner-side endpoint) ---------------------

EXPERIENCE_MUTATING_METHODS = frozenset({"submit_episodes", "scrape"})
# submit_episodes IS idempotency-cached: a batch whose ack frame was
# lost (drop_response chaos) must REPLAY the recorded acks, not
# re-offer — the queue's seen-set would ack "duplicate" anyway, but
# replaying keeps the collector's view of each episode's FIRST outcome
# stable (an episode accepted then evicted must not flap to "stale" on
# the retry of the same request).
EXPERIENCE_READONLY_METHODS = frozenset({"stream_stats", "health"})


class ExperienceRpcHandler(MetricsScrapeMixin, RpcHandlerBase):
    """Collector→learner episode intake over rpc. Wraps a
    :class:`~.learner.StreamingLearnerService` (or any object with
    ``intake(episodes)`` / ``stream_stats()``)."""

    mutating_methods = EXPERIENCE_MUTATING_METHODS
    readonly_methods = EXPERIENCE_READONLY_METHODS
    span_service = "learner"

    def __init__(self, learner, *, idempotency_cache_size: int = 1024):
        super().__init__(idempotency_cache_size=idempotency_cache_size)
        self.learner = learner

    def _m_submit_episodes(self, episodes) -> Dict[str, Any]:
        """Cached-mutating: a batch whose ack frame was lost must
        REPLAY the recorded acks on retry — re-offering would flap an
        accepted-then-evicted episode's outcome to "stale"."""
        from ..training.experience import StreamedEpisode
        eps = [e if isinstance(e, StreamedEpisode)
               else StreamedEpisode.from_wire(dict(e))
               for e in episodes]
        return self.learner.intake(eps)

    def _m_stream_stats(self) -> Dict[str, Any]:
        return self.learner.stream_stats()

    def _m_health(self) -> Dict[str, Any]:
        return {"state": "ok"}


def serve_experience_http(learner_or_handler, *,
                          host: str = "127.0.0.1", port: int = 0):
    """Serve a streaming learner's episode intake over real HTTP;
    returns ``(server, port)``."""
    handler = (learner_or_handler
               if isinstance(learner_or_handler, ExperienceRpcHandler)
               else ExperienceRpcHandler(learner_or_handler))
    return serve_rpc_http(handler, host=host, port=port,
                          thread_name="serve-experience-http")
