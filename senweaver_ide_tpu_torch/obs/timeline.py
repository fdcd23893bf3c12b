"""Per-request milestone timelines for the serving fleet.

One :class:`RequestTimeline` is the request-level counterpart of a
trace: where spans record *durations of code*, the timeline records the
*milestones of a ticket's life* — admitted, queue exit, prefill
start/done (with the shared-prefix mode: donor prefill vs broadcast
import vs lazy), first token, completion — plus an append-only event
log for the messy parts (retries, failovers, continuation replays) and
the publish-pause windows that overlapped it. From those it derives the
SLO quantities: TTFT, TPOT, queue wait, end-to-end latency, and how
much of that e2e was spent under a weight publish.

Two properties make chaos accounting exact:

- **milestones are first-wins** — a replayed RPC or a re-dispatched
  attempt can try to mark ``dispatched`` again; the original timestamp
  stands and the repeat becomes nothing. Retries show up where they
  belong: as events.
- **finish is exactly-once** — finishing pops the ticket from the live
  map, so however many times chaos retries the path, one request yields
  exactly one finished timeline.

:class:`TimelineRecorder` is the bounded ticket→timeline map the fleet
owns; finished timelines flow into an :class:`~.slo.SLOTracker` (when
wired) for histogram/violation/exemplar accounting. All timestamps are
in the fleet's injected clock domain (monotonic seconds; fake clocks in
tests), so derived durations are exact under deterministic chaos.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple


@dataclasses.dataclass
class RequestTimeline:
    """Milestones + events + derived SLO quantities for one ticket."""

    ticket: int
    priority: str
    trace_id: Optional[str] = None
    milestones: Dict[str, float] = dataclasses.field(default_factory=dict)
    milestone_attrs: Dict[str, Dict[str, Any]] = \
        dataclasses.field(default_factory=dict)
    events: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    outcome: Optional[str] = None            # "completed" | "rejected"
    reject_reason: Optional[str] = None
    tokens: int = 0
    attempts: int = 0
    replica_id: Optional[str] = None
    peer_id: Optional[str] = None            # recording process's identity
    derived: Dict[str, float] = dataclasses.field(default_factory=dict)
    violations: List[str] = dataclasses.field(default_factory=list)

    def mark(self, name: str, t: float, **attrs: Any) -> bool:
        """First-wins milestone; returns False (and records nothing)
        when ``name`` was already marked — the double-count guard."""
        if name in self.milestones:
            return False
        self.milestones[name] = t
        if attrs:
            self.milestone_attrs[name] = dict(attrs)
        return True

    def event(self, name: str, t: float, **attrs: Any) -> None:
        self.events.append({"event": name, "t": t, **attrs})

    def derive(self, publish_windows: List[Tuple[float, float]]
               ) -> Dict[str, float]:
        """Compute the SLO quantities; requires ``admitted``."""
        m = self.milestones
        d: Dict[str, float] = {}
        t0 = m.get("admitted")
        if t0 is None:
            self.derived = d
            return d
        if "queue_exit" in m:
            d["queue_wait_s"] = m["queue_exit"] - t0
        elif "dispatched" in m:
            d["queue_wait_s"] = m["dispatched"] - t0
        if "first_token" in m:
            d["ttft_s"] = m["first_token"] - t0
        if "prefill_start" in m and "prefill_done" in m:
            d["prefill_s"] = m["prefill_done"] - m["prefill_start"]
        end = m.get("completed")
        if end is not None:
            d["e2e_s"] = end - t0
            if "first_token" in m and self.tokens > 1:
                d["tpot_s"] = ((end - m["first_token"])
                               / (self.tokens - 1))
            pause = 0.0
            for start, stop in publish_windows:
                pause += max(0.0, min(end, stop) - max(t0, start))
            if pause > 0.0:
                d["publish_pause_s"] = pause
        self.derived = d
        return d

    def to_dict(self) -> Dict[str, Any]:
        out = dataclasses.asdict(self)
        out["milestones"] = {k: round(v, 6)
                             for k, v in self.milestones.items()}
        out["derived"] = {k: round(v, 6) for k, v in self.derived.items()}
        return out


class TimelineRecorder:
    """Bounded live-ticket map feeding finished timelines to the SLO
    layer. Every mutator tolerates unknown tickets (a milestone arriving
    after finish, or for a never-begun ticket, is dropped — never a
    raise into the fleet's dispatch path)."""

    def __init__(self, *, clock=time.monotonic, slo=None, registry=None,
                 max_live: int = 4096, max_windows: int = 256,
                 peer_id: Optional[str] = None):
        self.clock = clock
        self.slo = slo
        # Stamped into every timeline so federated incident stitching
        # can attribute exemplars to the process that recorded them
        # (replica_id is where the request RAN; peer_id is who SAW it).
        self.peer_id = peer_id
        self._live: Dict[int, RequestTimeline] = {}  # guarded-by: _lock
        self._windows: Deque[Tuple[float, float]] = \
            deque(maxlen=max_windows)                # guarded-by: _lock
        self._max_live = max(1, int(max_live))
        self._lock = threading.Lock()
        if registry is None:
            from . import get_registry
            registry = get_registry()
        self._finished_total = registry.counter(
            "senweaver_serve_timelines_total",
            "Request timelines finished, by outcome.",
            labelnames=("outcome",))
        self._evicted_total = registry.counter(
            "senweaver_serve_timelines_evicted_total",
            "Live timelines evicted unfinished (map at max_live — a "
            "leak or a pathological backlog, either way visible).")
        self._live_gauge = registry.gauge(
            "senweaver_serve_timelines_live",
            "Tickets with an open (unfinished) timeline.")
        self._publish_windows_total = registry.counter(
            "senweaver_serve_publish_windows_total",
            "Publish-pause windows recorded against timelines.")

    # -- lifecycle -----------------------------------------------------------
    def begin(self, ticket: int, priority: str,
              t: Optional[float] = None) -> None:
        with self._lock:
            if ticket in self._live:
                return
            while len(self._live) >= self._max_live:
                evicted = next(iter(self._live))
                del self._live[evicted]
                self._evicted_total.inc()
            self._live[ticket] = RequestTimeline(ticket=ticket,
                                                 priority=priority,
                                                 peer_id=self.peer_id)
            self._live_gauge.set(len(self._live))
        self.mark(ticket, "admitted", t)

    def mark(self, ticket: int, name: str, t: Optional[float] = None,
             **attrs: Any) -> bool:
        t = self.clock() if t is None else t
        with self._lock:
            tl = self._live.get(ticket)
            if tl is None:
                return False
            return tl.mark(name, t, **attrs)

    def event(self, ticket: int, name: str, t: Optional[float] = None,
              **attrs: Any) -> None:
        t = self.clock() if t is None else t
        with self._lock:
            tl = self._live.get(ticket)
            if tl is not None:
                tl.event(name, t, **attrs)

    def set_trace(self, ticket: int, trace_id: str) -> None:
        """First-wins trace binding (a retried dispatch opens a new
        span tree; the timeline keeps the one that first carried it)."""
        with self._lock:
            tl = self._live.get(ticket)
            if tl is not None and tl.trace_id is None:
                tl.trace_id = trace_id

    def publish_window(self, start: float, end: float) -> None:
        with self._lock:
            self._windows.append((start, end))
            self._publish_windows_total.inc()

    # -- finish (exactly-once: pops the live entry) --------------------------
    def finish_completed(self, ticket: int, t: Optional[float] = None, *,
                         tokens: int = 0,
                         replica_id: Optional[str] = None,
                         attempts: int = 0
                         ) -> Optional[RequestTimeline]:
        t = self.clock() if t is None else t
        with self._lock:
            tl = self._live.pop(ticket, None)
            if tl is None:
                return None
            self._live_gauge.set(len(self._live))
            windows = list(self._windows)
        tl.mark("completed", t)
        tl.outcome = "completed"
        tl.tokens = int(tokens)
        tl.replica_id = replica_id
        tl.attempts = int(attempts)
        tl.derive(windows)
        self._finished_total.inc(outcome="completed")
        if self.slo is not None:
            self.slo.observe(tl)
        return tl

    def finish_rejected(self, ticket: int, t: Optional[float] = None, *,
                        reason: str = ""
                        ) -> Optional[RequestTimeline]:
        t = self.clock() if t is None else t
        with self._lock:
            tl = self._live.pop(ticket, None)
            if tl is None:
                return None
            self._live_gauge.set(len(self._live))
            windows = list(self._windows)
        tl.mark("rejected", t)
        tl.outcome = "rejected"
        tl.reject_reason = reason
        tl.derive(windows)
        self._finished_total.inc(outcome="rejected")
        return tl

    # -- introspection -------------------------------------------------------
    def live_count(self) -> int:
        with self._lock:
            return len(self._live)

    def peek(self, ticket: int) -> Optional[RequestTimeline]:
        """The live timeline object (tests/debugging; None once
        finished — finished ones live in the SLO exemplar ring)."""
        with self._lock:
            return self._live.get(ticket)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {"timelines_live": len(self._live),
                    "publish_windows": len(self._windows)}
