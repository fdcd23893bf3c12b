"""Fleet metrics federation: scrape RPC, bounded series store, rollups.

Since the fleet went multi-process (remote replicas, a disaggregated
learner, a standalone lease authority), no single
:class:`~.metrics.MetricsRegistry` sees the whole system — KV pressure
lives on engine hosts, staleness on the learner, SLO burn on the
frontend. This module federates them:

- :class:`MetricsScrapeMixin` adds a ``scrape`` RPC to any
  ``serve.remote_server.RpcHandlerBase`` subclass. A scrape ships the
  local registry snapshot (FULL on first contact, counter/histogram
  DELTAS after — ``MetricsRegistry.snapshot_delta``) plus the event
  journal tail, cursor-tracked per ``scraper_id``. The method is
  declared MUTATING on its handlers so the idempotency cache makes
  retried scrapes exactly-once: a timeout retry replays the SAME delta
  instead of silently skipping a window.

- :class:`FleetMetricsStore` holds bounded time-series rings keyed
  ``(metric, labels, peer)`` plus the federated event timeline, and
  registers fleet-level rollups (``senweaver_fleet_rollup{metric,stat}``
  over sum/min/max across non-stale peers, worst replica named in
  :meth:`summary`) back into the local registry as first-class gauges.

- :class:`MetricsFederator` pulls each peer on a cadence over the
  existing rpc transports (loopback + HTTP). Chaos tolerance is a hard
  rule: a partitioned peer's series develops a GAP and the peer is
  marked stale — never interpolated, never fabricated. Unreachable /
  recovered transitions are stamped into the event journal so the
  incident correlator can name a partition as a cause.

Layering: obs stays below serve, so transports and rpc errors are
duck-typed (``transport.call(...)``; errors are classified retriable
via their ``retriable`` attribute) — no serve imports anywhere here.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Sequence, Tuple

from .incidents import get_event_journal

SCRAPE_METHOD = "scrape"

# Metrics the store rolls up into senweaver_fleet_rollup{metric,stat}
# by default — the global-scheduler signal set the ROADMAP names.
DEFAULT_ROLLUP_METRICS: Tuple[str, ...] = (
    "senweaver_kv_pressure",
    "senweaver_serve_slo_burn_ratio",
    "senweaver_serve_queue_depth",
    "senweaver_serve_shed_total",
    "senweaver_learner_idle_fraction",
    "senweaver_spec_depth",
)


class MetricsScrapeMixin:
    """``_m_scrape`` for rpc handlers: registry snapshot + journal tail.

    Handlers mixing this in must also add ``"scrape"`` to their
    ``mutating_methods`` — delta shipping advances a per-scraper cursor,
    so a retried scrape MUST replay from the idempotency cache rather
    than compute (and thereby skip) a second delta.

    State is created lazily so existing handler ``__init__`` signatures
    stay untouched; override :meth:`scrape_sources` (or assign
    ``scrape_registry`` / ``scrape_journal`` / ``scrape_clock`` /
    ``scrape_peer``) to bind explicit objects instead of the process
    globals."""

    scrape_registry = None
    scrape_journal = None
    scrape_clock = None
    scrape_peer: Optional[str] = None

    def scrape_sources(self):
        registry = self.scrape_registry
        if registry is None:
            from . import get_registry
            registry = get_registry()
        journal = self.scrape_journal
        if journal is None:
            journal = get_event_journal()
        clock = self.scrape_clock or time.monotonic
        return registry, journal, clock

    def _scrape_state(self) -> Dict[str, Dict[str, Any]]:
        # Lazy per-scraper cursor map; guarded by the handler's own
        # dispatch lock is NOT assumed — it has its own.
        state = getattr(self, "_scrape_cursors", None)
        if state is None:
            state = self._scrape_cursors = {}
            self._scrape_cursors_lock = threading.Lock()
        return state

    def _m_scrape(self, scraper_id: str = "fleet",
                  full: bool = False) -> Dict[str, Any]:
        """Cached-mutating: advancing the cursor then losing the
        response frame would drop that delta forever, so a retried
        request id must REPLAY the recorded payload."""
        registry, journal, clock = self.scrape_sources()
        cursors = self._scrape_state()
        with self._scrape_cursors_lock:
            cur = cursors.get(scraper_id)
            since_snap = None if (full or cur is None) else cur["snap"]
            event_seq = 0 if (full or cur is None) else cur["eseq"]
            delta, snap = registry.snapshot_delta(since_snap)
            events = journal.since(event_seq)
            cursors[scraper_id] = {
                "snap": snap,
                "eseq": (events[-1]["seq"] if events else event_seq)}
        return {"peer": self.scrape_peer,
                "t": clock(),
                "mode": "full" if since_snap is None else "delta",
                "metrics": delta,
                "events": events}


def _labels_key(labelnames: Sequence[str], labels: Dict[str, str]) -> str:
    return ",".join(str(labels.get(n, "")) for n in labelnames)


class FleetMetricsStore:
    """Bounded per-``(metric, labels, peer)`` series rings + rollups.

    Points are ``(t, value)`` — value is the ABSOLUTE counter/gauge
    reading at scrape time (histograms: ``{"sum", "count"}`` dicts), so
    window deltas are exact differences between ring points. A stale
    peer's rings simply stop growing: the gap IS the record; nothing is
    interpolated and the peer is excluded from rollups until it
    recovers."""

    def __init__(self, *, clock=time.monotonic, registry=None,
                 ring: int = 240, max_events: int = 4096,
                 rollup_metrics: Sequence[str] = DEFAULT_ROLLUP_METRICS):
        self.clock = clock
        self._ring = max(2, int(ring))
        self.rollup_metrics = tuple(rollup_metrics)
        self._lock = threading.Lock()
        # (metric, cell, peer) -> deque[(t, value)]
        self._rings: Dict[Tuple[str, str, str], Deque] = {}  # guarded-by: _lock
        # peer -> {"t": last ingest, "stale": bool,
        #          "metrics": latest absolute snapshot per metric}
        self._peers: Dict[str, Dict[str, Any]] = {}          # guarded-by: _lock
        # metric -> labelnames (from the last snapshot that carried it)
        self._labelnames: Dict[str, List[str]] = {}          # guarded-by: _lock
        self._kinds: Dict[str, str] = {}                     # guarded-by: _lock
        self._events: Deque[Dict[str, Any]] = deque(
            maxlen=max(1, int(max_events)))                  # guarded-by: _lock
        if registry is None:
            from . import get_registry
            registry = get_registry()
        self._peers_gauge = registry.gauge(
            "senweaver_fleet_peers", "Peers known to the federation.")
        self._stale_gauge = registry.gauge(
            "senweaver_fleet_peers_stale",
            "Peers currently marked stale (unreachable at last scrape; "
            "their series have a gap, never an interpolation).")
        self._scrapes_total = registry.counter(
            "senweaver_fleet_scrapes_total",
            "Successful federation scrapes, per peer.",
            labelnames=("peer",))
        self._scrape_failures_total = registry.counter(
            "senweaver_fleet_scrape_failures_total",
            "Failed federation scrapes (peer marked stale), per peer.",
            labelnames=("peer",))
        self._rollup_gauge = registry.gauge(
            "senweaver_fleet_rollup",
            "Fleet-level rollups over non-stale peers for the watched "
            "metric set (per-peer scalar: counters sum their cells, "
            "gauges take their max cell).",
            labelnames=("metric", "stat"))
        self._events_gauge = registry.gauge(
            "senweaver_fleet_events",
            "Events in the federated control-plane timeline.")
        self._peers_gauge.set(0)
        self._stale_gauge.set(0)

    # -- ingest --------------------------------------------------------------
    def ingest(self, peer: str, payload: Dict[str, Any],
               t: Optional[float] = None) -> None:
        """Fold one scrape payload (full or delta) into the store."""
        t = self.clock() if t is None else float(t)
        metrics = payload.get("metrics") or {}
        mode = payload.get("mode", "full")
        with self._lock:
            entry = self._peers.setdefault(
                peer, {"t": t, "stale": False, "metrics": {}})
            entry["t"] = t
            entry["stale"] = False
            latest = entry["metrics"]
            for name, m in metrics.items():
                kind = m.get("kind", "gauge")
                self._kinds[name] = kind
                self._labelnames[name] = list(m.get("labels", ()))
                cells = latest.setdefault(name, {})
                for cell, value in (m.get("values") or {}).items():
                    if mode == "delta" and kind == "counter":
                        value = float(cells.get(cell, 0.0)) + float(value)
                    elif mode == "delta" and kind == "histogram":
                        old = cells.get(cell) or {"sum": 0.0, "count": 0}
                        value = {
                            "sum": old["sum"] + float(value["sum"]),
                            "count": old["count"] + int(value["count"])}
                    cells[cell] = value
                    ring = self._rings.setdefault(
                        (name, cell, peer), deque(maxlen=self._ring))
                    ring.append((t, value))
            for event in payload.get("events") or ():
                e = dict(event)
                e.setdefault("peer", peer)
                self._events.append(e)
            self._events_gauge.set(len(self._events))
            self._update_peer_gauges()
        self._scrapes_total.inc(peer=peer)

    def mark_stale(self, peer: str, t: Optional[float] = None,
                   reason: str = "") -> None:
        """Record a failed scrape: the peer's rings get a GAP (no point
        appended, nothing interpolated) and its latest values leave the
        rollups until it recovers."""
        with self._lock:
            entry = self._peers.setdefault(
                peer, {"t": None, "stale": True, "metrics": {}})
            entry["stale"] = True
            self._update_peer_gauges()
        self._scrape_failures_total.inc(peer=peer)

    def _update_peer_gauges(self) -> None:
        # guarded-by: _lock
        self._peers_gauge.set(len(self._peers))
        self._stale_gauge.set(
            sum(1 for p in self._peers.values() if p["stale"]))

    # -- queries -------------------------------------------------------------
    def peers(self) -> List[str]:
        with self._lock:
            return sorted(self._peers)

    def is_stale(self, peer: str) -> bool:
        with self._lock:
            entry = self._peers.get(peer)
            return bool(entry and entry["stale"])

    def series(self, metric: str, *, peer: str,
               cell: str = "") -> List[Tuple[float, Any]]:
        with self._lock:
            return list(self._rings.get((metric, cell, peer), ()))

    def cells(self, metric: str, peer: str) -> Dict[str, Any]:
        with self._lock:
            entry = self._peers.get(peer)
            if entry is None:
                return {}
            return dict(entry["metrics"].get(metric, {}))

    def _matching_cells(self, metric: str,
                        labels: Optional[Dict[str, str]]) -> Optional[set]:
        # guarded-by: _lock. None = all cells match.
        if not labels:
            return None
        names = self._labelnames.get(metric, [])
        matched = set()
        for key in {c for (m, c, _p) in self._rings if m == metric}:
            parts = key.split(",") if key else []
            got = dict(zip(names, parts))
            if all(got.get(k) == str(v) for k, v in labels.items()):
                matched.add(key)
        return matched

    def window_delta(self, metric: str, window_s: float, *,
                     labels: Optional[Dict[str, str]] = None,
                     now: Optional[float] = None,
                     per_peer: bool = False):
        """Counter increase over the trailing window, from ring points
        only (a stale peer's frozen ring contributes a decaying-to-zero
        delta — honest, not fabricated). Histogram cells return
        ``{"sum": Δ, "count": Δ}``. ``per_peer=True`` → ``{peer: Δ}``;
        else the fleet-wide sum."""
        now = self.clock() if now is None else float(now)
        start = now - float(window_s)
        out: Dict[str, Any] = {}
        with self._lock:
            wanted = self._matching_cells(metric, labels)
            for (m, cell, peer), ring in self._rings.items():
                if m != metric or not ring:
                    continue
                if wanted is not None and cell not in wanted:
                    continue
                base = None
                for (pt, pv) in ring:
                    if pt <= start:
                        base = pv
                    else:
                        break
                if base is None:
                    base = (0.0 if not isinstance(ring[0][1], dict)
                            else {"sum": 0.0, "count": 0})
                last = ring[-1][1]
                if isinstance(last, dict):
                    d = {"sum": last["sum"] - base["sum"],
                         "count": last["count"] - base["count"]}
                    agg = out.setdefault(
                        peer, {"sum": 0.0, "count": 0})
                    agg["sum"] += d["sum"]
                    agg["count"] += d["count"]
                else:
                    out[peer] = out.get(peer, 0.0) + (
                        float(last) - float(base))
        if per_peer:
            return out
        if not out:
            return 0.0
        first = next(iter(out.values()))
        if isinstance(first, dict):
            return {"sum": sum(v["sum"] for v in out.values()),
                    "count": sum(v["count"] for v in out.values())}
        return sum(out.values())

    def _peer_scalar(self, metric: str, cells: Dict[str, Any]) -> float:
        # guarded-by: _lock. One scalar per peer: counters sum their
        # cells (totals), gauges take the max cell (worst signal).
        kind = self._kinds.get(metric, "gauge")
        vals = []
        for v in cells.values():
            if isinstance(v, dict):
                vals.append(float(v.get("sum", 0.0)))
            else:
                vals.append(float(v))
        if not vals:
            return 0.0
        return sum(vals) if kind == "counter" else max(vals)

    def rollup_value(self, metric: str, stat: str = "max",
                     *, include_stale: bool = False) -> Optional[float]:
        """sum/min/max of the per-peer scalar across (non-stale) peers;
        None when no peer carries the metric."""
        with self._lock:
            vals = [self._peer_scalar(metric, e["metrics"][metric])
                    for e in self._peers.values()
                    if metric in e["metrics"]
                    and (include_stale or not e["stale"])]
        if not vals:
            return None
        return {"sum": sum, "min": min, "max": max}[stat](vals)

    def worst_peer(self, metric: str
                   ) -> Optional[Tuple[str, float]]:
        """(peer, value) with the MAX per-peer scalar (non-stale)."""
        with self._lock:
            scored = [(self._peer_scalar(metric, e["metrics"][metric]), p)
                      for p, e in self._peers.items()
                      if metric in e["metrics"] and not e["stale"]]
        if not scored:
            return None
        v, p = max(scored)
        return p, v

    def events_in(self, start: float, end: float) -> List[Dict[str, Any]]:
        with self._lock:
            return [dict(e) for e in self._events
                    if start <= e["t"] <= end]

    def recent_events(self, n: int = 32) -> List[Dict[str, Any]]:
        with self._lock:
            return [dict(e) for e in list(self._events)[-max(0, n):]]

    # -- rollup publication --------------------------------------------------
    def rollup(self, now: Optional[float] = None) -> Dict[str, Any]:
        """Recompute the fleet rollup gauges for the watched metric set
        and return the summary (worst replica named per metric)."""
        summary: Dict[str, Any] = {}
        for metric in self.rollup_metrics:
            entry: Dict[str, Any] = {}
            for stat in ("sum", "min", "max"):
                v = self.rollup_value(metric, stat)
                if v is None:
                    continue
                entry[stat] = v
                self._rollup_gauge.set(v, metric=metric, stat=stat)
            worst = self.worst_peer(metric)
            if worst is not None:
                entry["worst_peer"], entry["worst_value"] = worst
            if entry:
                summary[metric] = entry
        return summary

    def summary(self) -> Dict[str, Any]:
        with self._lock:
            peers = {p: {"stale": e["stale"], "last_scrape_t": e["t"],
                         "metrics": len(e["metrics"])}
                     for p, e in sorted(self._peers.items())}
            n_events = len(self._events)
            n_rings = len(self._rings)
        return {"peers": peers, "events": n_events,
                "series_rings": n_rings,
                "rollups": self.rollup()}


class MetricsFederator:
    """Pulls every peer's scrape RPC on a cadence into the store.

    ``peers`` maps peer name → transport (anything with
    ``call(method, params, request_id=..., timeout_s=...)`` — both
    ``serve.rpc`` transports qualify). Each scrape carries a FRESH
    idempotency key; a retriable failure is retried once with the SAME
    key, so a lost response replays the server's cached delta instead
    of skipping a window. Anything still failing marks the peer stale
    and stamps a ``peer_unreachable`` event (once per outage) for the
    correlator; recovery stamps ``peer_recovered`` and resumes with a
    FULL snapshot so the delta chain re-anchors."""

    def __init__(self, store: FleetMetricsStore,
                 peers: Optional[Dict[str, Any]] = None, *,
                 clock=time.monotonic, journal=None,
                 scraper_id: str = "federator",
                 interval_s: float = 1.0, retries: int = 1):
        self.store = store
        self.clock = clock
        self.journal = journal
        self.scraper_id = scraper_id
        self.interval_s = float(interval_s)
        self.retries = max(0, int(retries))
        self._lock = threading.Lock()
        self._peers: Dict[str, Any] = dict(peers or {})  # guarded-by: _lock
        self._down: Dict[str, bool] = {}                 # guarded-by: _lock
        self._resync: Dict[str, bool] = {}               # guarded-by: _lock
        self._seq = 0                                    # guarded-by: _lock
        self._last_poll_at: Optional[float] = None       # guarded-by: _lock

    def add_peer(self, name: str, transport) -> None:
        with self._lock:
            self._peers[name] = transport
            self._resync[name] = True

    def _journal(self):
        return self.journal if self.journal is not None \
            else get_event_journal()

    def poll(self, now: Optional[float] = None) -> Optional[Dict[str, str]]:
        """Scrape all peers if the cadence is due; None when skipped.
        Safe to call from a fleet pump every step."""
        now = self.clock() if now is None else float(now)
        with self._lock:
            if (self._last_poll_at is not None
                    and now - self._last_poll_at < self.interval_s):
                return None
            self._last_poll_at = now
        return self.scrape_once(now)

    def scrape_once(self, now: Optional[float] = None) -> Dict[str, str]:
        """One federation sweep; returns peer → "ok" | "stale"."""
        now = self.clock() if now is None else float(now)
        with self._lock:
            peers = list(self._peers.items())
            self._seq += 1
            seq = self._seq
        results: Dict[str, str] = {}
        for name, transport in peers:
            payload = self._scrape_peer(name, transport, seq)
            if payload is None:
                self.store.mark_stale(name, now)
                with self._lock:
                    first_failure = not self._down.get(name)
                    self._down[name] = True
                    self._resync[name] = True  # re-anchor on recovery
                if first_failure:
                    self._journal().emit("peer_unreachable", t=now,
                                         peer=name)
                results[name] = "stale"
                continue
            self.store.ingest(name, payload, t=now)
            with self._lock:
                was_down = self._down.pop(name, False)
                self._resync.pop(name, None)
            if was_down:
                self._journal().emit("peer_recovered", t=now, peer=name)
            results[name] = "ok"
        self.store.rollup(now)
        return results

    def _scrape_peer(self, name: str, transport,
                     seq: int) -> Optional[Dict[str, Any]]:
        with self._lock:
            full = bool(self._resync.get(name))
        request_id = f"scrape:{self.scraper_id}:{name}:{seq}"
        params = {"scraper_id": self.scraper_id, "full": full}
        # Lazy import: resilience.retry only pulls resilience.faults, so
        # this stays cycle-free even though obs can't import serve.
        from ..resilience.retry import RetryBudget, RetryPolicy
        budget = RetryBudget(
            RetryPolicy(max_retries=self.retries, base_delay_s=0.0,
                        jitter=False),
            now=self.clock())
        while True:
            try:
                return transport.call(SCRAPE_METHOD, params,
                                      request_id=request_id)
            except Exception as e:
                # Duck-typed rpc taxonomy (obs can't import serve):
                # retriable wire weather retries on the SAME idempotency
                # key under the shared budget; anything else is an
                # outage.
                if not getattr(e, "retriable", False):
                    return None
                delay = budget.next_delay(
                    now=self.clock(),
                    retry_after_s=getattr(e, "retry_after_s", None))
                if delay is None:
                    return None
                if delay > 0:
                    time.sleep(delay)
