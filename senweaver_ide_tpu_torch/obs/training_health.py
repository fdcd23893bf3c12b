"""GRPO training-health observatory: thresholds, gauges, worst-K ring.

The consumer half of the training-health plane. ``training/diagnostics.py``
computes the per-round health dict ON DEVICE (rank spectrum, credit
entropy, zero-group fraction, NaN fraction) and ``rl_loop`` merges in
the step's own metrics (grad_sparsity, policy entropy, KL-to-anchor).
This module is pure host-side accounting over that flat dict:

- :func:`evaluate_health` — stateless threshold checks returning the
  tripped trigger names (the same names ``resilience.HealthMitigator``
  keys its streak hysteresis on);
- :class:`TrainingHealthMonitor` — per-signal
  ``senweaver_grpo_health_<key>`` gauges, a ``rank_fraction``
  histogram, trigger counters, a rolling per-round ring (JSONL
  exportable) and a K-worst round capture mirroring ``obs/slo.py``'s
  exemplar heap, so a collapsed run ships the concrete rounds that
  collapsed it;
- a process-global accessor (``get_health_monitor``) that
  ``StepTelemetry.record_round(health=...)`` publishes through, swapped
  by ``obs._reset_for_tests``.

Layering: obs stays below training — nothing here imports training/.
"""

from __future__ import annotations

import collections
import dataclasses
import heapq
import itertools
import json
import threading
from typing import Any, Deque, Dict, List, Optional

# Trigger names (health dict key -> threshold direction). These strings
# are the contract with resilience.HealthMitigator and the dashboards;
# add new detectors here, not ad hoc.
TRIGGER_RANK_COLLAPSE = "rank_collapse"
TRIGGER_ZERO_GROUPS = "zero_groups"
TRIGGER_CREDIT_COLLAPSE = "credit_collapse"
TRIGGER_GRAD_SPARSITY = "grad_sparsity"
TRIGGER_NONFINITE = "nonfinite_rewards"
TRIGGER_ENTROPY_FLOOR = "entropy_floor"
TRIGGER_KL_DRIFT = "kl_drift"
# Streaming-learner detector: the mean versions-behind of the
# episodes trained this round drifted past the configured bound — the
# async pipeline is running too far off-policy and the mitigator can
# veto it back to lockstep (resilience.MITIGATION_LOCKSTEP_FALLBACK).
TRIGGER_STALENESS_DRIFT = "staleness_drift"

# Gauge-published signals, in report order. Keys absent from a round's
# health dict are simply skipped (e.g. grad_sparsity on a vetoed round).
HEALTH_KEYS = (
    "nonfinite_reward_fraction", "zero_advantage_group_fraction",
    "groups_present", "advantage_mean", "advantage_std",
    "effective_rank", "rank_fraction", "participation_ratio",
    "top_singular_value", "credit_entropy", "grad_sparsity",
    "policy_entropy", "kl_to_anchor", "staleness_mean",
    "stale_drop_fraction",
)

RANK_FRACTION_BUCKETS = (0.05, 0.1, 0.2, 0.3, 0.5, 0.7, 0.9, 1.0)


@dataclasses.dataclass(frozen=True)
class TrainingHealthConfig:
    """Detector thresholds + ring/exemplar budgets. ``None`` disables a
    detector (its gauge still publishes)."""

    rank_fraction_min: Optional[float] = 0.25
    zero_group_fraction_max: Optional[float] = 0.5
    credit_entropy_min: Optional[float] = 0.2
    grad_sparsity_max: Optional[float] = 0.75
    nonfinite_max: Optional[float] = 0.0
    policy_entropy_min: Optional[float] = None
    kl_max: Optional[float] = None
    # Streaming mode only: mean versions-behind of a trained batch
    # (None for lockstep runs — the signal isn't even reported there).
    staleness_mean_max: Optional[float] = None
    window: int = 256      # rolling per-round ring length
    worst_k: int = 8       # K-worst round capture


def evaluate_health(health: Dict[str, float],
                    config: Optional[TrainingHealthConfig] = None
                    ) -> List[str]:
    """Stateless threshold pass over one round's health dict. Returns
    tripped trigger names (stable order). Missing keys never trip."""
    cfg = config or TrainingHealthConfig()
    triggers: List[str] = []

    def _get(key):
        v = health.get(key)
        return float(v) if v is not None else None

    def _check(name, key, limit, *, below):
        v = _get(key)
        if limit is None or v is None:
            return
        if (v < limit) if below else (v > limit):
            triggers.append(name)

    _check(TRIGGER_NONFINITE, "nonfinite_reward_fraction",
           cfg.nonfinite_max, below=False)
    _check(TRIGGER_ZERO_GROUPS, "zero_advantage_group_fraction",
           cfg.zero_group_fraction_max, below=False)
    _check(TRIGGER_RANK_COLLAPSE, "rank_fraction",
           cfg.rank_fraction_min, below=True)
    _check(TRIGGER_CREDIT_COLLAPSE, "credit_entropy",
           cfg.credit_entropy_min, below=True)
    _check(TRIGGER_GRAD_SPARSITY, "grad_sparsity",
           cfg.grad_sparsity_max, below=False)
    _check(TRIGGER_ENTROPY_FLOOR, "policy_entropy",
           cfg.policy_entropy_min, below=True)
    _check(TRIGGER_KL_DRIFT, "kl_to_anchor", cfg.kl_max, below=False)
    _check(TRIGGER_STALENESS_DRIFT, "staleness_mean",
           cfg.staleness_mean_max, below=False)
    return triggers


class TrainingHealthMonitor:
    """Folds per-round health dicts into metrics + ring + worst-K."""

    def __init__(self, config: Optional[TrainingHealthConfig] = None, *,
                 registry=None):
        self.config = config or TrainingHealthConfig()
        if registry is None:
            from . import get_registry
            registry = get_registry()
        self._gauges = {
            key: registry.gauge(
                f"senweaver_grpo_health_{key}",
                f"GRPO training-health signal: {key} (latest round).")
            for key in HEALTH_KEYS
        }
        self._rank_hist = registry.histogram(
            "senweaver_grpo_health_rank_fraction_dist",
            "Per-round advantage effective-rank fraction distribution.",
            buckets=RANK_FRACTION_BUCKETS)
        self._rounds_total = registry.counter(
            "senweaver_grpo_health_rounds_total",
            "Rounds folded into training-health accounting.")
        self._triggers_total = registry.counter(
            "senweaver_grpo_health_triggers_total",
            "Health-detector trips, by detector signal.",
            labelnames=("signal",))
        self._score_gauge = registry.gauge(
            "senweaver_grpo_health_score",
            "1 minus the fraction of enabled detectors tripped last "
            "round (1 = fully healthy).")
        self._lock = threading.Lock()
        self._rounds = 0
        self._trigger_counts: Dict[str, int] = {}
        self._ring: Deque[Dict[str, Any]] = collections.deque(
            maxlen=max(1, int(self.config.window)))
        # Min-heap of (badness, seq, record) — pop evicts the least bad,
        # leaving the K WORST rounds (slo.py exemplar pattern).
        self._worst: List[Any] = []               # guarded-by: _lock
        self._seq = itertools.count()

    # -- intake --------------------------------------------------------------
    def observe(self, health: Dict[str, float], *,
                round_index: Optional[int] = None,
                triggers: Optional[List[str]] = None,
                events: Optional[List[str]] = None) -> List[str]:
        """Fold one round. ``triggers`` may be precomputed (rl_loop
        evaluates pre-step); otherwise thresholds run here. Returns the
        trigger list."""
        if triggers is None:
            triggers = evaluate_health(health, self.config)
        clean: Dict[str, float] = {}
        for key in HEALTH_KEYS:
            v = health.get(key)
            if v is None:
                continue
            v = float(v)
            clean[key] = v
            self._gauges[key].set(v)
        if "rank_fraction" in clean:
            self._rank_hist.observe(clean["rank_fraction"])
        self._rounds_total.inc()
        for name in triggers:
            self._triggers_total.inc(signal=name)
        n_detectors = sum(
            1 for lim in (self.config.rank_fraction_min,
                          self.config.zero_group_fraction_max,
                          self.config.credit_entropy_min,
                          self.config.grad_sparsity_max,
                          self.config.nonfinite_max,
                          self.config.policy_entropy_min,
                          self.config.kl_max,
                          self.config.staleness_mean_max)
            if lim is not None)
        score = 1.0 - (len(triggers) / n_detectors if n_detectors else 0.0)
        self._score_gauge.set(score)
        with self._lock:
            self._rounds += 1
            idx = round_index if round_index is not None else self._rounds
            for name in triggers:
                self._trigger_counts[name] = (
                    self._trigger_counts.get(name, 0) + 1)
            record = {"round": idx, "health": clean,
                      "triggers": list(triggers),
                      "events": list(events or []), "score": score}
            self._ring.append(record)
            self._consider_worst(record)
        return list(triggers)

    def _consider_worst(self, record: Dict[str, Any]) -> None:
        # guarded-by: _lock
        k = max(0, int(self.config.worst_k))
        if k == 0:
            return
        # Badness: trigger count first, then how collapsed the rank is.
        badness = (len(record["triggers"]),
                   1.0 - record["health"].get("rank_fraction", 1.0))
        heapq.heappush(self._worst,
                       (badness, next(self._seq), dict(record)))
        while len(self._worst) > k:
            heapq.heappop(self._worst)

    # -- export --------------------------------------------------------------
    def history(self) -> List[Dict[str, Any]]:
        """The rolling ring, oldest first."""
        with self._lock:
            return [dict(r) for r in self._ring]

    def worst_rounds(self) -> List[Dict[str, Any]]:
        """The K worst rounds kept, worst first."""
        with self._lock:
            ranked = sorted(self._worst,
                            key=lambda e: (e[0], e[1]), reverse=True)
        return [dict(e[2]) for e in ranked]

    def export_jsonl(self, path: str, *, worst_only: bool = False) -> str:
        """Ring (oldest first) or worst-K (worst first), one round per
        line — the artifact ``scripts/training_health_report.py`` reads."""
        records = self.worst_rounds() if worst_only else self.history()
        with open(path, "w") as f:
            for rec in records:
                f.write(json.dumps(rec) + "\n")
        return path

    def summary(self) -> Dict[str, Any]:
        with self._lock:
            rounds = self._rounds
            trigger_counts = dict(sorted(self._trigger_counts.items()))
            last = dict(self._ring[-1]) if self._ring else None
            n_worst = len(self._worst)
        return {"rounds": rounds, "trigger_counts": trigger_counts,
                "last_round": last, "worst_kept": n_worst,
                "worst_k": self.config.worst_k}


_monitor_lock = threading.Lock()
_monitor: Optional[TrainingHealthMonitor] = None


def get_health_monitor() -> TrainingHealthMonitor:
    """Process-global monitor, built lazily against the CURRENT global
    registry (so it lands in whatever registry tests swapped in)."""
    global _monitor
    with _monitor_lock:
        if _monitor is None:
            _monitor = TrainingHealthMonitor()
        return _monitor


def set_health_monitor(monitor: Optional[TrainingHealthMonitor]
                       ) -> Optional[TrainingHealthMonitor]:
    """Swap the global monitor (None resets to lazy rebuild). Returns
    the previous one. Used by ``obs._reset_for_tests`` and by runs that
    want custom thresholds published globally."""
    global _monitor
    with _monitor_lock:
        old, _monitor = _monitor, monitor
    return old
