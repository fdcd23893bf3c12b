"""Control-plane event journal + causal incident correlator.

The fleet's control plane already *acts* — publishes roll, adapters
land, the autoscaler adds and drains, leases change hands, spec depth
steps down under load — but those actions only surface as counters.
When an alert fires (``obs/alerts.py``) the on-call question is never
"what is the burn ratio" (the alert says), it is "what CHANGED right
before it". This module answers that:

- :class:`EventJournal` — a bounded, thread-safe ring of discrete
  control-plane events (``publish_begin``/``publish_end``,
  ``adapter_publish``, ``autoscale_action``, ``lease_acquired``,
  ``spec_depth_change``, ``health_mitigation``, …). Emission sites call
  the module-level :func:`emit_event`, which never raises and costs a
  dict append — safe inside the publisher's lock. Each event captures
  the ACTIVE trace context (W3C trace_id via ``Tracer.capture``) when
  tracing is on, so an incident record links straight into the stitched
  span tree. Events federate: the metrics ``scrape`` RPC ships each
  peer's journal tail (cursor-tracked per scraper, replayed exactly
  once through the idempotency cache) into the
  :class:`~.federation.FleetMetricsStore`'s fleet-wide timeline.

- :class:`IncidentCorrelator` — when an alert fires, stitches the
  event window (direct journal events + events SYNTHESIZED from
  federated counter movement: evictions, swaps, preemptions, sheds —
  the reactions the system already counts) into an :class:`Incident`
  naming the ranked candidate causes. Ranking is deliberately simple
  and inspectable: per-rule cause-kind weights × recency decay × a
  same-peer bonus against the alert's worst replica. Chaos-injection
  counters (``senweaver_chaos_*``) are EXCLUDED from synthesis — the
  correlator must find the injected cause from the system's observable
  reaction, not read the answer off the chaos plan.

Layering: obs stays below serve — everything here is duck-typed
(``store`` needs ``events_in``/``window_delta``/``worst_peer``), no
serve imports.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import math
import threading
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple

# Federated counters whose WINDOW MOVEMENT becomes a synthesized cause
# event (kind, per metric). senweaver_chaos_* is deliberately absent.
SYNTHESIZED_CAUSES: Tuple[Tuple[str, str], ...] = (
    ("senweaver_kv_evictions_total", "kv_evictions"),
    ("senweaver_kv_swaps_out_total", "kv_swaps_out"),
    ("senweaver_kv_exhaustion_rejections_total", "kv_exhaustion"),
    ("senweaver_kv_preemption_storms_total", "kv_preemption_storm"),
    ("senweaver_runtime_retrace_storms_total", "retrace_storm"),
    ("senweaver_serve_shed_total", "admission_sheds"),
    ("senweaver_serve_stale_publish_total", "stale_publish_denied"),
)

# Weight for an event kind no rule names explicitly — something always
# ranks, just never above a named cause.
_DEFAULT_CAUSE_WEIGHT = 0.05


def _current_trace_id() -> Optional[str]:
    """trace_id of the active span, or None (never raises — emission
    sites live inside serve-plane locks)."""
    try:
        from . import get_tracer
        ctx = get_tracer().capture()
        return ctx[0] if ctx else None
    except Exception:
        return None


class EventJournal:
    """Bounded ring of control-plane events, oldest evicted first.

    Events are plain dicts ``{"seq", "kind", "t", **attrs}`` (+
    ``trace_id`` when a span is active at emission). ``seq`` is a
    process-local monotonic cursor — the federation scrape uses it to
    ship each peer's tail exactly once per scraper."""

    def __init__(self, *, clock=time.monotonic, maxlen: int = 2048,
                 registry=None):
        self.clock = clock
        self._lock = threading.Lock()
        self._events: Deque[Dict[str, Any]] = deque(maxlen=max(
            1, int(maxlen)))                        # guarded-by: _lock
        self._seq = itertools.count(1)
        if registry is None:
            from . import get_registry
            registry = get_registry()
        self._events_total = registry.counter(
            "senweaver_obs_events_total",
            "Control-plane events stamped into the journal.",
            labelnames=("kind",))

    def emit(self, kind: str, t: Optional[float] = None,
             **attrs: Any) -> Dict[str, Any]:
        """Append one event; returns it (callers may keep a handle for
        tests). ``t`` defaults to the journal's clock."""
        event = {"seq": next(self._seq), "kind": str(kind),
                 "t": self.clock() if t is None else float(t), **attrs}
        trace_id = _current_trace_id()
        if trace_id is not None:
            event.setdefault("trace_id", trace_id)
        with self._lock:
            self._events.append(event)
        self._events_total.inc(kind=kind)
        return event

    def since(self, seq: int) -> List[Dict[str, Any]]:
        """Events with ``seq`` strictly greater than the cursor (the
        scrape tail; copies, callers may stamp peers onto them)."""
        with self._lock:
            return [dict(e) for e in self._events if e["seq"] > seq]

    def recent(self, n: int = 32) -> List[Dict[str, Any]]:
        with self._lock:
            return [dict(e) for e in list(self._events)[-max(0, n):]]

    def window(self, start: float, end: float) -> List[Dict[str, Any]]:
        with self._lock:
            return [dict(e) for e in self._events
                    if start <= e["t"] <= end]

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)


# -- process-global journal (get_registry idiom) -----------------------------
_journal_lock = threading.Lock()
_journal: Optional[EventJournal] = None


def get_event_journal() -> EventJournal:
    """The process-global journal, built lazily on first use."""
    global _journal
    with _journal_lock:
        if _journal is None:
            _journal = EventJournal()
        return _journal


def set_event_journal(journal: Optional[EventJournal]) -> None:
    """Swap the global journal (tests / fake clocks); None lazily
    rebuilds on next :func:`get_event_journal`."""
    global _journal
    with _journal_lock:
        _journal = journal


def emit_event(kind: str, t: Optional[float] = None, **attrs: Any) -> None:
    """Fire-and-forget emission for serve-plane call sites: never
    raises, never blocks beyond the journal's own lock. The obs plane
    must not be able to take the control plane down."""
    try:
        get_event_journal().emit(kind, t, **attrs)
    except Exception:
        pass


# -- incidents ---------------------------------------------------------------
@dataclasses.dataclass
class Incident:
    """One alert firing, stitched to its ranked candidate causes."""

    incident_id: int
    alert: str
    fired_at: float
    window_s: float
    value: float
    worst_peer: Optional[str]
    candidates: List[Dict[str, Any]]
    trace_ids: List[str]
    summary: str

    @property
    def top_cause(self) -> Optional[Dict[str, Any]]:
        return self.candidates[0] if self.candidates else None

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


class IncidentCorrelator:
    """Stitches alert firings to candidate causes from the federated
    event window.

    ``store`` duck-type: ``events_in(start, end)`` → stamped events,
    ``window_delta(metric, window_s, now=..., per_peer=True)`` →
    ``{peer: delta}``, ``worst_peer(metric)`` → ``(peer, value)`` or
    None. ``journal`` adds THIS process's local events (stamped
    ``peer="local"`` unless the event carries one)."""

    def __init__(self, store=None, *, journal: Optional[EventJournal] = None,
                 clock=time.monotonic, window_s: float = 120.0,
                 max_incidents: int = 64, registry=None):
        self.store = store
        self.journal = journal
        self.clock = clock
        self.window_s = float(window_s)
        self._lock = threading.Lock()
        self._incidents: Deque[Incident] = deque(
            maxlen=max(1, int(max_incidents)))      # guarded-by: _lock
        self._ids = itertools.count(1)
        if registry is None:
            from . import get_registry
            registry = get_registry()
        self._incidents_total = registry.counter(
            "senweaver_fleet_incidents_total",
            "Incident records opened by the correlator, per alert.",
            labelnames=("alert",))

    # -- intake --------------------------------------------------------------
    def on_alert(self, rule, value: float,
                 now: Optional[float] = None) -> Incident:
        """Open an incident for one alert firing. ``rule`` duck-type:
        ``.name``, ``.metric``, ``.causes`` (kind → weight pairs)."""
        now = self.clock() if now is None else float(now)
        start = now - self.window_s
        events = self._gather_events(start, now)
        events.extend(self._synthesize_events(now))
        worst = self._worst_peer(rule)
        weights = dict(getattr(rule, "causes", ()) or ())
        candidates = self._rank(events, weights, worst, now)
        trace_ids = sorted({c["event"]["trace_id"] for c in candidates
                            if c["event"].get("trace_id")})
        incident = Incident(
            incident_id=next(self._ids),
            alert=rule.name, fired_at=now, window_s=self.window_s,
            value=float(value), worst_peer=worst,
            candidates=candidates, trace_ids=trace_ids,
            summary=self._summarize(rule, value, worst, candidates, now))
        with self._lock:
            self._incidents.append(incident)
        self._incidents_total.inc(alert=rule.name)
        return incident

    def _gather_events(self, start: float,
                       end: float) -> List[Dict[str, Any]]:
        events: List[Dict[str, Any]] = []
        if self.store is not None:
            try:
                events.extend(self.store.events_in(start, end))
            except Exception:
                pass
        if self.journal is not None:
            for e in self.journal.window(start, end):
                e.setdefault("peer", "local")
                events.append(e)
        return events

    def _synthesize_events(self, now: float) -> List[Dict[str, Any]]:
        """Cause events derived from federated counter MOVEMENT in the
        window — evictions, swaps, preemptions, sheds. The system's
        reaction is observable even where no one emitted an event."""
        if self.store is None:
            return []
        out: List[Dict[str, Any]] = []
        for metric, kind in SYNTHESIZED_CAUSES:
            try:
                per_peer = self.store.window_delta(
                    metric, self.window_s, now=now, per_peer=True)
            except Exception:
                continue
            for peer, delta in sorted(per_peer.items()):
                if delta > 0:
                    out.append({"kind": kind, "peer": peer, "t": now,
                                "delta": float(delta),
                                "synthesized": True, "metric": metric})
        return out

    def _worst_peer(self, rule) -> Optional[str]:
        metric = getattr(rule, "metric", "") or ""
        if self.store is None or not metric:
            return None
        try:
            worst = self.store.worst_peer(metric)
        except Exception:
            return None
        return worst[0] if worst else None

    def _rank(self, events: List[Dict[str, Any]],
              weights: Dict[str, float], worst_peer: Optional[str],
              now: float) -> List[Dict[str, Any]]:
        tau = max(1e-9, self.window_s / 2.0)
        scored = []
        for e in events:
            w = float(weights.get(e["kind"], _DEFAULT_CAUSE_WEIGHT))
            recency = math.exp(-max(0.0, now - float(e["t"])) / tau)
            peer_bonus = (1.25 if worst_peer is not None
                          and e.get("peer") == worst_peer else 1.0)
            scored.append({"cause": e["kind"],
                           "peer": e.get("peer"),
                           "t": float(e["t"]),
                           "score": round(w * recency * peer_bonus, 6),
                           "event": e})
        scored.sort(key=lambda c: (-c["score"], -c["t"]))
        return scored[:5]

    @staticmethod
    def _summarize(rule, value: float, worst_peer: Optional[str],
                   candidates: List[Dict[str, Any]],
                   now: float) -> str:
        head = f"{rule.name} fired (value={value:.3g})"
        if worst_peer:
            head += f" worst={worst_peer}"
        if not candidates:
            return head + "; no candidate cause in window"
        top = candidates[0]
        ago = now - top["t"]
        where = f" on {top['peer']}" if top.get("peer") else ""
        detail = top["event"]
        extras = [f"{k}={detail[k]}" for k in ("version", "action",
                                               "tenant", "depth", "delta")
                  if k in detail]
        suffix = f" ({', '.join(extras)})" if extras else ""
        return (f"{head}; candidate cause: {top['cause']}{where} "
                f"{ago:.1f}s before{suffix}")

    # -- export --------------------------------------------------------------
    def incidents(self, n: int = 16) -> List[Incident]:
        """Most recent first."""
        with self._lock:
            return list(self._incidents)[-max(0, n):][::-1]

    def export_jsonl(self, path: str) -> str:
        with open(path, "w") as f:
            for inc in self.incidents(n=len(self)):
                f.write(json.dumps(inc.to_dict()) + "\n")
        return path

    def __len__(self) -> int:
        with self._lock:
            return len(self._incidents)

    def summary(self) -> Dict[str, Any]:
        with self._lock:
            incs = list(self._incidents)
        return {"incidents": len(incs),
                "last": incs[-1].summary if incs else None}
