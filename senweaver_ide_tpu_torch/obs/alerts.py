"""Burn-rate / threshold / trend alerting over federated fleet series.

Three rule kinds, all evaluated host-side against a
:class:`~.federation.FleetMetricsStore` (never against live jax state):

- ``burn_rate`` — classic multi-window SLO burn: the violation fraction
  over the error budget must exceed ``burn_threshold`` in BOTH the fast
  (5m) and slow (1h) windows before firing. The fast window makes the
  alert prompt; the slow window keeps a single bad scrape from paging.
- ``threshold`` — a fleet rollup (e.g. max KV pressure) sustained above
  ``threshold`` for ``sustain_s``.
- ``trend`` — a counter moving: window delta ≥ ``min_delta`` (retrace
  storms, preemption storms).
- ``hist_mean`` — windowed mean of a federated histogram (Δsum/Δcount
  over the trend window), e.g. learner episode staleness drifting up.
- ``stale_peers`` — peers the federator marked unreachable.

Hysteresis is mandatory — the chaos plans flap inputs by design. A
firing alert clears only when the value drops below ``clear_threshold``
AND ``hold_s`` has elapsed since it fired; `transitions` counts
fire/clear edges so the selftest can assert an alert fired exactly once
across a mitigation boundary.

Each rule carries ``causes`` — (event kind, weight) priors handed to the
incident correlator when the rule fires.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

FAST_WINDOW_S = 300.0     # 5m
SLOW_WINDOW_S = 3600.0    # 1h


@dataclass(frozen=True)
class AlertRule:
    name: str
    kind: str     # burn_rate | threshold | trend | hist_mean | stale_peers
    metric: str = ""
    description: str = ""
    # burn_rate
    priority: str = "interactive"
    budget_fraction: float = 0.1    # tolerated violation fraction (error budget)
    fast_window_s: float = FAST_WINDOW_S
    slow_window_s: float = SLOW_WINDOW_S
    burn_threshold: float = 2.0     # budget multiples/window before firing
    # threshold
    stat: str = "max"
    threshold: float = 0.0
    clear_threshold: Optional[float] = None   # default: threshold
    sustain_s: float = 0.0
    # trend
    trend_window_s: float = FAST_WINDOW_S
    min_delta: float = 1.0
    # hysteresis
    hold_s: float = 30.0
    # correlator priors: ((event_kind, weight), ...)
    causes: Tuple[Tuple[str, float], ...] = ()

    @property
    def clear_at(self) -> float:
        return (self.threshold if self.clear_threshold is None
                else self.clear_threshold)


@dataclass
class _RuleState:
    pending_since: Optional[float] = None
    firing: bool = False
    fired_at: Optional[float] = None
    value: float = 0.0
    transitions: int = 0
    history: List[Tuple[float, str, float]] = field(default_factory=list)


class AlertManager:
    """Evaluates rules against the store; fires into the journal and
    (when attached) the incident correlator."""

    def __init__(self, store, rules, *, clock=time.monotonic,
                 registry=None, journal=None, correlator=None):
        self.store = store
        self.rules: List[AlertRule] = list(rules)
        self.clock = clock
        self.journal = journal
        self.correlator = correlator
        self._state: Dict[str, _RuleState] = {
            r.name: _RuleState() for r in self.rules}
        if registry is None:
            from . import get_registry
            registry = get_registry()
        self._active_gauge = registry.gauge(
            "senweaver_fleet_alert_active",
            "1 while the alert rule is firing, 0 otherwise.",
            labelnames=("alert",))
        self._fired_total = registry.counter(
            "senweaver_fleet_alerts_fired_total",
            "Fire transitions per alert rule (hysteresis edges, not "
            "evaluations).",
            labelnames=("alert",))
        self._burn_gauge = registry.gauge(
            "senweaver_fleet_burn_ratio",
            "SLO burn ratio (violation fraction / error budget) per "
            "burn-rate rule and window, refreshed every evaluation — "
            "the dashboard's per-window burn readout.",
            labelnames=("alert", "window"))
        for r in self.rules:
            self._active_gauge.set(0, alert=r.name)

    def _journal(self):
        if self.journal is not None:
            return self.journal
        from .incidents import get_event_journal
        return get_event_journal()

    # -- rule evaluation -----------------------------------------------------
    def _burn_ratio(self, rule: AlertRule, window_s: float,
                    now: float) -> Optional[float]:
        labels = {"priority": rule.priority}
        viol = self.store.window_delta(
            "senweaver_serve_slo_violations_total", window_s,
            labels=labels, now=now)
        reqs = self.store.window_delta(
            "senweaver_serve_slo_requests_total", window_s,
            labels=labels, now=now)
        if not reqs:
            return None
        return (viol / reqs) / max(rule.budget_fraction, 1e-9)

    def _evaluate_rule(self, rule: AlertRule,
                       now: float) -> Tuple[Optional[float], bool]:
        """(value, breaching) — value None when no data yet."""
        if rule.kind == "burn_rate":
            fast = self._burn_ratio(rule, rule.fast_window_s, now)
            slow = self._burn_ratio(rule, rule.slow_window_s, now)
            if fast is not None:
                self._burn_gauge.set(fast, alert=rule.name,
                                     window="fast")
            if slow is not None:
                self._burn_gauge.set(slow, alert=rule.name,
                                     window="slow")
            if fast is None or slow is None:
                return None, False
            return fast, (fast >= rule.burn_threshold
                          and slow >= rule.burn_threshold)
        if rule.kind == "threshold":
            v = self.store.rollup_value(rule.metric, rule.stat)
            if v is None:
                return None, False
            return v, v >= rule.threshold
        if rule.kind == "trend":
            d = self.store.window_delta(rule.metric, rule.trend_window_s,
                                        now=now)
            return float(d), float(d) >= rule.min_delta
        if rule.kind == "hist_mean":
            d = self.store.window_delta(rule.metric, rule.trend_window_s,
                                        now=now)
            if not isinstance(d, dict) or not d.get("count"):
                return None, False
            mean = d["sum"] / d["count"]
            return mean, mean >= rule.threshold
        if rule.kind == "stale_peers":
            stale = sum(1 for p in self.store.peers()
                        if self.store.is_stale(p))
            return float(stale), stale >= max(rule.threshold, 1.0)
        raise ValueError(f"unknown alert kind {rule.kind!r}")

    def evaluate(self, now: Optional[float] = None) -> List[str]:
        """One evaluation sweep; returns the names of rules that FIRED
        on this sweep (edge, not level)."""
        now = self.clock() if now is None else float(now)
        fired: List[str] = []
        for rule in self.rules:
            st = self._state[rule.name]
            value, breaching = self._evaluate_rule(rule, now)
            if value is not None:
                st.value = value
            if not st.firing:
                if breaching:
                    if st.pending_since is None:
                        st.pending_since = now
                    if now - st.pending_since >= rule.sustain_s:
                        st.firing = True
                        st.fired_at = now
                        st.pending_since = None
                        st.transitions += 1
                        st.history.append((now, "fired", st.value))
                        self._active_gauge.set(1, alert=rule.name)
                        self._fired_total.inc(alert=rule.name)
                        self._on_fire(rule, st.value, now)
                        fired.append(rule.name)
                else:
                    st.pending_since = None
            else:
                # Hysteresis: must drop below clear_at AND outlast hold_s.
                cleared_value = (value is not None
                                 and self._below_clear(rule, value))
                if (cleared_value and st.fired_at is not None
                        and now - st.fired_at >= rule.hold_s):
                    st.firing = False
                    st.fired_at = None
                    st.transitions += 1
                    st.history.append((now, "cleared", st.value))
                    self._active_gauge.set(0, alert=rule.name)
                    self._journal().emit(
                        "alert_cleared", t=now, alert=rule.name,
                        value=st.value)
        return fired

    @staticmethod
    def _below_clear(rule: AlertRule, value: float) -> bool:
        if rule.kind == "burn_rate":
            return value < rule.burn_threshold
        if rule.kind == "trend":
            return value < rule.min_delta
        return value < rule.clear_at

    def _on_fire(self, rule: AlertRule, value: float, now: float) -> None:
        self._journal().emit("alert_fired", t=now, alert=rule.name,
                             value=value, metric=rule.metric)
        if self.correlator is not None:
            try:
                self.correlator.on_alert(rule, value, now=now)
            except Exception:
                pass  # alerting must not die on a correlator bug

    # -- introspection -------------------------------------------------------
    def active(self) -> List[str]:
        return [r.name for r in self.rules if self._state[r.name].firing]

    def transitions(self, name: str) -> int:
        return self._state[name].transitions

    def state(self, name: str) -> _RuleState:
        return self._state[name]

    def summary(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for rule in self.rules:
            st = self._state[rule.name]
            out[rule.name] = {
                "kind": rule.kind, "metric": rule.metric,
                "firing": st.firing, "value": st.value,
                "transitions": st.transitions,
                "fired_at": st.fired_at,
                "description": rule.description}
        return out


def default_alert_rules(slo_config=None) -> List[AlertRule]:
    """The stock fleet rule set (docs/observability.md has the table)."""
    return [
        AlertRule(
            name="slo_burn_fast", kind="burn_rate",
            metric="senweaver_serve_slo_violations_total",
            priority="interactive", budget_fraction=0.1,
            burn_threshold=2.0, hold_s=60.0,
            description="Interactive SLO violations burning the error "
                        "budget >2x in both the 5m and 1h windows.",
            causes=(("publish_begin", 1.0), ("publish_end", 0.8),
                    ("adapter_publish", 0.6), ("autoscale_action", 0.5),
                    ("kv_preemption_storm", 0.6),
                    ("health_mitigation", 0.5))),
        AlertRule(
            name="kv_pressure_high", kind="threshold",
            metric="senweaver_kv_pressure", stat="max",
            threshold=0.85, clear_threshold=0.75, sustain_s=2.0,
            hold_s=30.0,
            description="Worst-replica KV pressure sustained above the "
                        "0.85 watermark.",
            causes=(("kv_exhaustion", 1.0), ("kv_evictions", 0.9),
                    ("kv_swaps_out", 0.8), ("kv_preemption_storm", 0.8),
                    ("admission_sheds", 0.4))),
        AlertRule(
            name="retrace_storm", kind="trend",
            metric="senweaver_runtime_retrace_storms_total",
            min_delta=1.0, hold_s=60.0,
            description="Retrace-storm counter moved in the fast window "
                        "(shape churn recompiling hot functions).",
            causes=(("retrace_storm", 1.0), ("publish_begin", 0.5),
                    ("spec_depth_change", 0.5))),
        AlertRule(
            name="learner_staleness_drift", kind="hist_mean",
            metric="senweaver_learner_episode_staleness",
            threshold=4.0, clear_threshold=2.0, sustain_s=2.0,
            hold_s=30.0,
            description="Learner seeing episodes ≥4 versions stale — "
                        "publish cadence or rollout lag drifting.",
            causes=(("peer_unreachable", 0.9), ("publish_begin", 0.6),
                    ("stale_publish_denied", 0.6))),
        AlertRule(
            name="learner_idle_collapse", kind="threshold",
            metric="senweaver_learner_idle_fraction", stat="min",
            threshold=0.9, clear_threshold=0.5, sustain_s=4.0,
            hold_s=30.0,
            description="Learner idle fraction pinned >0.9 — experience "
                        "starvation (rollout fleet stalled or partitioned).",
            causes=(("peer_unreachable", 1.0), ("kv_exhaustion", 0.6),
                    ("admission_sheds", 0.5))),
        AlertRule(
            name="fleet_peer_stale", kind="stale_peers",
            threshold=1.0, sustain_s=0.0, hold_s=5.0,
            description="One or more peers unreachable at scrape time; "
                        "their series are gapped, not interpolated.",
            causes=(("peer_unreachable", 1.0),)),
    ]
