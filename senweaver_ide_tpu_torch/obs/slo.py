"""Per-priority-class SLO tracking with exemplar capture.

The ROADMAP's million-user item asks for a per-commit SLO report —
TTFT/TPOT percentiles and shed rate — next to the bench artifact. This
module is the accounting half of that: :class:`SLOTracker` folds every
finished :class:`~.timeline.RequestTimeline` into

- ``senweaver_serve_{ttft,tpot,queue_wait,e2e}_seconds{priority}``
  histograms (seconds, ms-scale buckets — 1ms..60s);
- ``senweaver_serve_slo_requests_total`` / ``_slo_violations_total``
  counters and a running ``senweaver_serve_slo_burn_ratio`` gauge
  (violating / total, per class — the error-budget burn signal);
- an **exemplar ring**: the K worst requests (violating first, then by
  end-to-end latency) keep their FULL stitched timelines — milestones,
  retry/failover events, trace_id — so a percentile regression comes
  with the concrete requests that caused it, exportable as JSONL for
  ``scripts/slo_report.py`` and the dashboard tile.

Targets are per priority class (:class:`SLOConfig`); a class field name
matches the fleet's priority string ("interactive"/"train_rollout"), so
this module needs no import from serve/ (obs must stay below serve in
the layering). A target of None disables that objective — histograms
still populate, violations just never fire.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
import json
import threading
from typing import Any, Dict, List, Optional

# Seconds histograms with ms-scale resolution at the interactive end.
SECONDS_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 15.0, 60.0)

# The derived-latency keys a timeline carries; order = report order.
SLO_KEYS = ("ttft_s", "tpot_s", "queue_wait_s", "e2e_s")


@dataclasses.dataclass(frozen=True)
class SLOTarget:
    """Latency objectives for one priority class (None = unset)."""

    ttft_s: Optional[float] = None
    tpot_s: Optional[float] = None
    queue_wait_s: Optional[float] = None
    e2e_s: Optional[float] = None

    def limits(self) -> Dict[str, float]:
        return {k: v for k, v in dataclasses.asdict(self).items()
                if v is not None}


@dataclasses.dataclass(frozen=True)
class SLOConfig:
    """Per-class targets + exemplar budget. Field names deliberately
    match the serve priority strings so ``target(priority)`` is a
    getattr, not an import of serve/admission."""

    interactive: SLOTarget = SLOTarget(ttft_s=0.5, tpot_s=0.1,
                                       queue_wait_s=0.25, e2e_s=5.0)
    train_rollout: SLOTarget = SLOTarget(e2e_s=60.0)
    exemplar_k: int = 8

    def target(self, priority: str) -> SLOTarget:
        t = getattr(self, priority, None)
        return t if isinstance(t, SLOTarget) else SLOTarget()


class SLOTracker:
    """Folds finished request timelines into SLO metrics + exemplars."""

    def __init__(self, config: Optional[SLOConfig] = None, *,
                 registry=None, peer_id: Optional[str] = None):
        self.config = config or SLOConfig()
        # Stamped into every exemplar record so federated incident
        # stitching can attribute an exported timeline to the replica
        # process whose tracker kept it.
        self.peer_id = peer_id
        if registry is None:
            from . import get_registry
            registry = get_registry()
        self._hist = {
            "ttft_s": registry.histogram(
                "senweaver_serve_ttft_seconds",
                "Admission-to-first-token latency (seconds).",
                buckets=SECONDS_BUCKETS, labelnames=("priority",)),
            "tpot_s": registry.histogram(
                "senweaver_serve_tpot_seconds",
                "Per-output-token decode time after the first token "
                "(seconds/token).",
                buckets=SECONDS_BUCKETS, labelnames=("priority",)),
            "queue_wait_s": registry.histogram(
                "senweaver_serve_queue_wait_seconds",
                "Admission-to-queue-exit wait (seconds).",
                buckets=SECONDS_BUCKETS, labelnames=("priority",)),
            "e2e_s": registry.histogram(
                "senweaver_serve_e2e_seconds",
                "Admission-to-completion latency (seconds).",
                buckets=SECONDS_BUCKETS, labelnames=("priority",)),
        }
        self._requests_total = registry.counter(
            "senweaver_serve_slo_requests_total",
            "Completed requests folded into SLO accounting.",
            labelnames=("priority",))
        self._violations_total = registry.counter(
            "senweaver_serve_slo_violations_total",
            "SLO objective violations (one per violated objective).",
            labelnames=("priority", "slo"))
        self._burn_gauge = registry.gauge(
            "senweaver_serve_slo_burn_ratio",
            "Running fraction of requests violating at least one "
            "objective (error-budget burn).",
            labelnames=("priority",))
        self._lock = threading.Lock()
        self._counts: Dict[str, List[int]] = {}  # priority -> [total, bad]
        # Min-heap of (badness, seq, timeline_dict); heap pop evicts the
        # LEAST bad, so what remains is the K worst. seq breaks ties so
        # dicts are never compared.
        self._exemplars: List[Any] = []          # guarded-by: _lock
        self._seq = itertools.count()

    # -- intake --------------------------------------------------------------
    def observe(self, timeline) -> List[str]:
        """Fold one finished timeline (duck-typed: needs ``priority``,
        ``derived``, a ``violations`` list to fill, and ``to_dict()``).
        Returns the violated objective names."""
        priority = timeline.priority
        derived = timeline.derived
        for key, hist in self._hist.items():
            value = derived.get(key)
            if value is not None:
                hist.observe(max(0.0, float(value)), priority=priority)
        limits = self.config.target(priority).limits()
        violated = [k for k, lim in limits.items()
                    if derived.get(k) is not None and derived[k] > lim]
        timeline.violations = violated
        with self._lock:
            c = self._counts.setdefault(priority, [0, 0])
            c[0] += 1
            self._requests_total.inc(priority=priority)
            if violated:
                c[1] += 1
                for name in violated:
                    self._violations_total.inc(priority=priority,
                                               slo=name)
            self._burn_gauge.set(c[1] / c[0], priority=priority)
            self._consider_exemplar(timeline)
        return violated

    def _consider_exemplar(self, timeline) -> None:
        # guarded-by: _lock
        k = max(0, int(self.config.exemplar_k))
        if k == 0:
            return
        badness = (1 if timeline.violations else 0,
                   float(timeline.derived.get("e2e_s", 0.0)))
        record = timeline.to_dict()
        if self.peer_id is not None and not record.get("peer_id"):
            record["peer_id"] = self.peer_id
        heapq.heappush(self._exemplars,
                       (badness, next(self._seq), record))
        while len(self._exemplars) > k:
            heapq.heappop(self._exemplars)

    # -- export --------------------------------------------------------------
    def exemplars(self) -> List[Dict[str, Any]]:
        """The kept timelines, worst first."""
        with self._lock:
            ranked = sorted(self._exemplars,
                            key=lambda e: (e[0], e[1]), reverse=True)
        return [dict(e[2]) for e in ranked]

    def export_jsonl(self, path: str) -> str:
        """One exemplar timeline per line, worst first."""
        with open(path, "w") as f:
            for rec in self.exemplars():
                f.write(json.dumps(rec) + "\n")
        return path

    def summary(self) -> Dict[str, Any]:
        with self._lock:
            per_class = {
                p: {"requests": c[0], "violating": c[1],
                    "burn_ratio": (c[1] / c[0]) if c[0] else 0.0,
                    "targets": self.config.target(p).limits()}
                for p, c in sorted(self._counts.items())}
            n_ex = len(self._exemplars)
        return {"per_class": per_class, "exemplars_kept": n_ex,
                "exemplar_k": self.config.exemplar_k}
