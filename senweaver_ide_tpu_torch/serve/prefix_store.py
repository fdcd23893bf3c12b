"""SharedPrefixStore — fleet prefix KV: prefill once, broadcast to all.

The fleet's dominant redundant work is N replicas each re-prefilling an
identical multi-hundred-token prefix (the optimized system prompt every
episode shares). Per-replica lazy registration made the FIRST dispatch
to each replica pay the full prefill; this store makes registration
**prefill-once / broadcast-to-all** — the RadixAttention / PagedAttention
economics (PAPERS.md) applied across engines instead of within one:

1. On the first dispatch of a fleet prefix, the chosen replica becomes
   the **donor**: it prefills the tokens (``engine.register_prefix``)
   and exports its one-slot KV buffer (``engine.export_prefix``).
2. The store installs that buffer into every other LIVE replica via
   ``engine.import_prefix`` — validated against the receiver's pool
   layout and accounted in its prefix LRU like a locally-prefilled
   entry. TTFT for prefix-bearing requests on those replicas drops from
   O(prefix FLOPs) to O(HBM bandwidth). Under the slot layout the
   install is one buffer copy onto its device; under the paged layout
   (EngineConfig.kv_layout="paged", the default) it is ONE scatter into
   freshly allocated pool blocks (``senweaver_kv_install_copies_total``)
   — and from then on every request naming the prefix GRAFTS those
   blocks into its own block table (a refcount bump,
   ``senweaver_kv_prefix_grafts_total``, zero KV bytes moved; divergent
   writes copy-on-write only the boundary block). Per-request prefix
   cost on a warm replica is therefore O(table ints), not O(prefix KV).
3. Replicas that join late, resurrect after death, or were DRAINING
   during the broadcast are **backfilled** on their next prefix-bearing
   dispatch (:meth:`ensure` runs in the dispatch path).

Invalidation follows the no-version-mixing rule: the store subscribes
to ``WeightPublisher.begin`` and drops every shared entry the moment a
publish starts — old-policy KV must never serve under new weights. A
stale fleet ``prefix_id`` then raises ``KeyError`` at submit, exactly
the single-engine contract auto_prefix clients already recover from.

Degradation: any export or install failure (chaos engine, layout
mismatch → :class:`~..rollout.engine.PrefixImportError`, OOM) marks the
entry failed and falls back to the pre-store behavior — each replica
lazily prefills on first use (``EngineReplica.submit``). The store can
make serving faster, never wedge it.

Rack-aware fanout: when replicas carry ``host_group`` labels the eager
broadcast installs into ONE replica per host group (the donor covers
its own); the rest of each host backfills lazily from the NEAREST
resident copy — a same-host peer re-exports its installed KV
(``EngineReplica.export_shared_prefix``,
``senweaver_serve_prefix_nearest_backfills_total``) so the donor
buffer crosses each rack boundary once instead of once per replica.
Unlabeled fleets default to one host per replica, which degrades both
paths to the original broadcast-to-all behavior exactly.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

from .replica import LIVE, EngineReplica


@dataclasses.dataclass
class _SharedPrefix:
    """One fleet prefix and its broadcast state."""

    pid: int
    tokens: List[int]
    version: int                      # publisher version at registration
    donor_id: Optional[str] = None    # replica that paid the one prefill
    kv: Any = None                    # exported one-slot KVCache
    last_logits: Any = None           # donor's final-token logits (host)
    installed: Set[str] = dataclasses.field(default_factory=set)
    failed: bool = False              # degraded to per-replica lazy path


class SharedPrefixStore:
    """Fleet-level prefix registry + one-prefill broadcast protocol.

    Owns the pid namespace the :class:`ServingFleet` hands to clients.
    ``replicas`` is the fleet's LIVE list object (shared, not copied) so
    replicas added after construction participate automatically. All
    calls happen under the fleet's lock — no locking of its own."""

    def __init__(self, replicas: Sequence[EngineReplica], publisher, *,
                 registry=None, enabled: bool = True):
        self.replicas = replicas
        self.publisher = publisher
        self.enabled = bool(enabled)
        self._entries: Dict[int, _SharedPrefix] = {}
        # (tuple(tokens), version) -> pid: O(1) content dedup, replacing
        # the fleet's former O(pids) linear scan per register call.
        self._by_key: Dict[Tuple[tuple, int], int] = {}
        self._next_pid = 0
        publisher.subscribe_begin(self._on_publish)
        if registry is None:
            from ..obs import get_registry
            registry = get_registry()
        self._broadcasts_total = registry.counter(
            "senweaver_serve_prefix_broadcasts_total",
            "Shared-prefix KV buffers installed into non-donor replicas.")
        self._avoided_total = registry.counter(
            "senweaver_serve_prefix_prefills_avoided_total",
            "Prefix prefills avoided by serving an installed copy "
            "instead of recomputing.")
        self._failures_total = registry.counter(
            "senweaver_serve_prefix_broadcast_failures_total",
            "Shared-prefix exports/installs that failed (entry degrades "
            "to per-replica lazy prefill).")
        self._invalidations_total = registry.counter(
            "senweaver_serve_prefix_invalidations_total",
            "Shared prefixes dropped by a weight publish.")
        self._install_ms = registry.histogram(
            "senweaver_serve_prefix_install_ms",
            "Wall time of one shared-prefix install (device-to-device "
            "KV copy + validation).")
        self._shared_gauge = registry.gauge(
            "senweaver_serve_prefix_shared",
            "Shared prefixes currently registered in the store.")
        self._host_backfills_total = registry.counter(
            "senweaver_serve_prefix_host_backfills_total",
            "Donor exports served from the engine's host-RAM KV tier "
            "(the prefix had been swapped out — the broadcast cost "
            "zero donor device traffic and no re-prefill).")
        self._nearest_backfills_total = registry.counter(
            "senweaver_serve_prefix_nearest_backfills_total",
            "Late-replica prefix backfills served from a same-host "
            "resident copy (peer re-export) instead of the original "
            "donor buffer crossing the rack boundary again.")
        self._shared_gauge.set(0)

    # -- registry ------------------------------------------------------------
    def register(self, tokens: List[int]) -> int:
        """Fleet prefix id for ``tokens`` under the current weight
        version. Content-identical registrations dedup to one pid; the
        KV materializes lazily at first dispatch (donor prefill +
        broadcast)."""
        if not tokens:
            raise ValueError("empty prefix")
        key = (tuple(tokens), self.publisher.version)
        pid = self._by_key.get(key)
        if pid is not None:
            return pid
        pid = self._next_pid
        self._next_pid += 1
        self._entries[pid] = _SharedPrefix(
            pid=pid, tokens=list(tokens), version=self.publisher.version)
        self._by_key[key] = pid
        self._shared_gauge.set(len(self._entries))
        return pid

    def lookup(self, pid: int) -> Optional[_SharedPrefix]:
        """The entry behind ``pid`` — None when unknown or stale (its
        registration version predates the current weights)."""
        entry = self._entries.get(pid)
        if entry is None or entry.version != self.publisher.version:
            return None
        return entry

    def stats(self) -> Dict[str, Any]:
        out = {
            "shared_prefixes": len(self._entries),
            "prefixes_materialized": sum(
                e.kv is not None for e in self._entries.values()),
            "prefixes_failed": sum(
                e.failed for e in self._entries.values()),
        }
        # Graft-vs-copy economics across the fleet: paged replicas report
        # kv_prefix_grafts / kv_install_copies in engine stats — aggregate
        # them so one number answers "are imports actually zero-copy?".
        grafts = copies = 0
        paged_any = False
        for rep in self.replicas:
            st = getattr(rep, "engine", None)
            st = st.stats() if st is not None else {}
            if st.get("kv_paged"):
                paged_any = True
                grafts += st.get("kv_grafts", 0)
                copies += st.get("kv_install_copies", 0)
        if paged_any:
            out["kv_prefix_grafts"] = grafts
            out["kv_install_copies"] = copies
        return out

    # -- broadcast protocol --------------------------------------------------
    def ensure(self, replica: EngineReplica,
               tokens: List[int]) -> Optional[str]:
        """Dispatch-path hook: make ``replica`` warm for ``tokens``
        before the request lands on it. Never raises — every failure
        path degrades to the replica's own lazy prefill in
        ``EngineReplica.submit``. Returns how the replica got (or will
        get) warm — ``"donor"`` (paid the one prefill), ``"import"``
        (broadcast/backfill install), ``"warm"`` (already held it),
        ``"lazy"`` (degraded to the per-replica path) or None (not a
        fleet prefix) — the request timeline records it as the
        prefill-mode attribute."""
        if not self.enabled or not tokens:
            return None
        key = (tuple(tokens), self.publisher.version)
        pid = self._by_key.get(key)
        if pid is None:
            return None                  # not a fleet-registered prefix
        entry = self._entries[pid]
        if entry.failed:
            return "lazy"                # degraded: lazy per-replica
        if replica.holds_prefix(tuple(tokens)):
            entry.installed.add(replica.replica_id)
            return "warm"
        if entry.kv is None:
            self._donate(entry, replica)
            return ("donor" if entry.donor_id == replica.replica_id
                    else "lazy")
        # Late joiner / resurrected replica / was DRAINING during the
        # broadcast / non-seed member of a labeled host group: backfill
        # from the NEAREST resident copy — a same-host peer re-exports
        # its installed KV so the donor buffer doesn't cross the rack
        # boundary twice — falling back to the stored donor buffer.
        nearest = self._nearest_source(entry, replica)
        if nearest is not None:
            try:
                _, kv, last = nearest.export_shared_prefix(entry.tokens)
            except Exception:
                self._failures_total.inc()
            else:
                if self._install(entry, replica, kv=kv, last_logits=last):
                    self._nearest_backfills_total.inc()
                    return "import"
                if entry.failed:
                    return "lazy"
        return "import" if self._install(entry, replica) else "lazy"

    def _nearest_source(self, entry: _SharedPrefix,
                        replica: EngineReplica
                        ) -> Optional[EngineReplica]:
        """A LIVE same-host peer that already installed the entry (the
        cheapest backfill source). None when the replica's host has no
        resident copy — including every unlabeled fleet, where each
        replica is its own host."""
        for peer in self.replicas:
            if (peer.replica_id == replica.replica_id
                    or peer.state != LIVE
                    or peer.replica_id not in entry.installed):
                continue
            if peer.host == replica.host:
                return peer
        return None

    def _donate(self, entry: _SharedPrefix,
                replica: EngineReplica) -> None:
        """First dispatch: ``replica`` pays the ONE prefill, then its
        buffer broadcasts to every other live replica. A donor whose
        engine had already tiered the prefix to host RAM serves the
        export straight from its host buffers — counted separately,
        since the fleet then backfilled without any prefill OR device
        readback."""
        try:
            probe = getattr(replica, "prefix_in_host_tier", None)
            from_host = bool(probe(tuple(entry.tokens))) if probe else False
            tokens, kv, last = replica.register_shared_prefix(
                entry.tokens)
            if from_host:
                self._host_backfills_total.inc()
        except Exception:
            # Donor prefill failed (chaos / OOM): leave kv unset so the
            # next dispatch elects a new donor; repeated failure is the
            # replica fault path's problem, not the store's.
            self._failures_total.inc()
            return
        entry.donor_id = replica.replica_id
        entry.kv = kv
        entry.last_logits = last
        entry.installed.add(replica.replica_id)
        # Rack-aware fanout: ONE eager install per host group (the
        # donor already covers its own); the rest of each host
        # backfills from its seeded peer via the nearest-copy path in
        # :meth:`ensure`. Unlabeled replicas are each their own host,
        # so this is broadcast-to-all exactly as before.
        covered = {replica.host}
        for peer in self.replicas:
            if (peer.replica_id == replica.replica_id
                    or peer.state != LIVE
                    or peer.host in covered):
                continue
            if self._install(entry, peer):
                covered.add(peer.host)
            elif entry.failed:
                break

    def _install(self, entry: _SharedPrefix,
                 replica: EngineReplica, *, kv=None,
                 last_logits=None) -> bool:
        from ..rollout.engine import PrefixImportError
        t0 = time.perf_counter()
        if kv is None:
            kv, last_logits = entry.kv, entry.last_logits
        try:
            replica.install_shared_prefix(entry.tokens, kv, last_logits)
        except PrefixImportError:
            # Import refused: the buffer doesn't fit this pool's layout.
            # That's a fleet-config property, not a transient — it would
            # repeat on every replica, so degrade the whole entry to the
            # lazy per-replica path.
            self._failures_total.inc()
            entry.failed = True
            return False
        except Exception:
            # Replica-local blow-up (chaos / OOM): this replica serves
            # via its own lazy prefill; the entry keeps broadcasting to
            # the others.
            self._failures_total.inc()
            return False
        entry.installed.add(replica.replica_id)
        self._broadcasts_total.inc()
        self._avoided_total.inc()
        self._install_ms.observe((time.perf_counter() - t0) * 1000.0)
        return True

    def forget_replica(self, replica_id: str) -> None:
        """Drop ``replica_id`` from every entry's installed/donor
        bookkeeping — a replica id being resurrected under a FRESH
        engine holds none of the KV its predecessor did, so it must
        fall back into the lazy-backfill set (``ensure`` reinstalls on
        its next prefix-bearing dispatch). Retained donor buffers stay:
        they are host/device copies, valid independent of the donor."""
        for entry in self._entries.values():
            entry.installed.discard(replica_id)
            if entry.donor_id == replica_id:
                entry.donor_id = None

    # -- invalidation --------------------------------------------------------
    def _on_publish(self, version: int) -> None:
        """WeightPublisher.begin hook: every shared entry's KV belongs
        to the OLD policy — drop them all (no version mixing). Stale
        pids then fail :meth:`lookup` and submit raises KeyError."""
        dropped = len(self._entries)
        self._entries.clear()
        self._by_key.clear()
        if dropped:
            self._invalidations_total.inc(dropped)
        self._shared_gauge.set(0)
