"""Update guard: veto optimizer steps that would corrupt the policy.

One NaN gradient is enough to zero a run — Adam moments absorb the
non-finite update and every subsequent step inherits it, silently.
The guard sits between ``train_step``'s metrics and the decision to
ADOPT the new state (training/rl_loop.py, trainer.train_step_guarded):
it never touches device buffers, it just reads the already-synced host
floats and answers "keep or revert".

Three tripwires, checked in order:

1. non-finite loss (NaN/Inf),
2. non-finite global grad norm,
3. loss spike — rolling z-score of the loss against the last
   ``spike_window`` ACCEPTED losses (rejected losses never enter the
   history, so one spike can't poison the baseline that judges the
   next).

Every trip increments ``senweaver_grpo_updates_skipped_total{reason=}``
AND the dashboard-facing ``senweaver_guard_skips_total{reason=}`` (the
Resilience tile reads the latter per-reason), and is appended to
:attr:`UpdateGuard.skipped` for the round capture.

:class:`HealthMitigator` is the training-health companion: where the guard vetoes
a single poisoned STEP, the mitigator reshapes the OBJECTIVE when the
training-health detectors (obs/training_health.py) trip persistently —
RLOO leave-one-out baselines, token-level credit, group-size
rescheduling — with streak hysteresis, hard config gates, and every
enable/disable/veto counted and surfaced as a round event.
"""

from __future__ import annotations

import collections
import math
import threading

from ..obs.incidents import emit_event
from typing import Dict, Iterable, List, Optional, Tuple

from ..obs.training_health import (TRIGGER_CREDIT_COLLAPSE,
                                   TRIGGER_GRAD_SPARSITY,
                                   TRIGGER_RANK_COLLAPSE,
                                   TRIGGER_STALENESS_DRIFT,
                                   TRIGGER_ZERO_GROUPS)
from .faults import ResilienceConfig

REASON_NONFINITE_LOSS = "nonfinite_loss"
REASON_NONFINITE_GRAD = "nonfinite_grad_norm"
REASON_LOSS_SPIKE = "loss_spike"


class UpdateGuard:
    """Stateful keep-or-revert decision over per-update metrics.

    One guard instance spans a RUN (the rolling loss history is the
    whole point) — construct it once per loop, not per round."""

    def __init__(self, *, spike_zscore: float = 6.0,
                 spike_window: int = 16, spike_min_history: int = 5,
                 spike_min_std: float = 1e-3, registry=None):
        if registry is None:
            from ..obs import get_registry
            registry = get_registry()
        self.spike_zscore = float(spike_zscore)
        self.spike_min_history = int(spike_min_history)
        self.spike_min_std = float(spike_min_std)
        self._history: collections.deque = collections.deque(
            maxlen=int(spike_window))
        self._lock = threading.Lock()
        self._skipped_total = registry.counter(
            "senweaver_grpo_updates_skipped_total",
            "GRPO optimizer steps vetoed by the update guard",
            labelnames=("reason",))
        self._skips_total = registry.counter(
            "senweaver_guard_skips_total",
            "Update-guard skips by reason (dashboard Resilience tile).",
            labelnames=("reason",))
        self.skipped: List[Tuple[str, Optional[float]]] = []

    @classmethod
    def from_config(cls, config: ResilienceConfig,
                    registry=None) -> Optional["UpdateGuard"]:
        if not config.guard_updates:
            return None
        return cls(spike_zscore=config.spike_zscore,
                   spike_window=config.spike_window,
                   spike_min_history=config.spike_min_history,
                   spike_min_std=config.spike_min_std, registry=registry)

    def check(self, metrics: Dict[str, float]) -> Optional[str]:
        """Returns a skip reason, or None to accept (and the accepted
        loss joins the spike baseline)."""
        loss = metrics.get("loss")
        grad_norm = metrics.get("grad_norm")
        reason = None
        with self._lock:
            if loss is None or not math.isfinite(loss):
                reason = REASON_NONFINITE_LOSS
            elif grad_norm is not None and not math.isfinite(grad_norm):
                reason = REASON_NONFINITE_GRAD
            elif len(self._history) >= self.spike_min_history:
                mean = sum(self._history) / len(self._history)
                var = sum((x - mean) ** 2 for x in self._history) \
                    / len(self._history)
                std = max(math.sqrt(var), self.spike_min_std)
                if abs(loss - mean) / std > self.spike_zscore:
                    reason = REASON_LOSS_SPIKE
            if reason is None:
                self._history.append(float(loss))
                return None
            self.skipped.append((reason, loss))
        self._skipped_total.inc(reason=reason)
        self._skips_total.inc(reason=reason)
        return reason

    @property
    def history(self) -> List[float]:
        with self._lock:
            return list(self._history)


# Mitigation names — the {mitigation=} label values and round-event
# suffixes. Each maps to the detector triggers that motivate it.
MITIGATION_LEAVE_ONE_OUT = "leave_one_out"
MITIGATION_TOKEN_LEVEL = "token_level_advantages"
MITIGATION_GROUP_SIZE = "group_size"
MITIGATION_LOCKSTEP_FALLBACK = "lockstep_fallback"

_MITIGATION_TRIGGERS: Dict[str, Tuple[str, ...]] = {
    # Rank collapse / tied groups: std-normalization couples every
    # trajectory to its own group's spread — RLOO decouples it.
    MITIGATION_LEAVE_ONE_OUT: (TRIGGER_RANK_COLLAPSE,
                               TRIGGER_ZERO_GROUPS),
    # Credit concentrating on a few tokens / sparse gradients: spread
    # sequence advantage with gamma-decay token credit.
    MITIGATION_TOKEN_LEVEL: (TRIGGER_CREDIT_COLLAPSE,
                             TRIGGER_GRAD_SPARSITY),
    # Mostly-tied groups also mean the group size is too small to
    # separate rewards — grow it (scheduler lives in training/rl_loop).
    MITIGATION_GROUP_SIZE: (TRIGGER_ZERO_GROUPS,
                            TRIGGER_GRAD_SPARSITY),
    # Streaming learner running too far off-policy: drop back to
    # lockstep (train only on current-version batches and block on
    # publish convergence) until staleness quiets. No config field on
    # GRPOConfig — the streaming learner polls
    # :meth:`HealthMitigator.lockstep_fallback_active`, exactly the
    # group_size pattern.
    MITIGATION_LOCKSTEP_FALLBACK: (TRIGGER_STALENESS_DRIFT,),
}


class HealthMitigator:
    """Streak-hysteresis gate from health triggers to GRPO mitigations.

    One instance spans a run (like :class:`UpdateGuard`). Per round,
    :meth:`apply` folds the PRE-step triggers (plus any post-step
    triggers noted last round via :meth:`note_post_step` — grad
    sparsity, entropy and KL only exist after the update) into
    per-mitigation streaks: ``trigger_rounds`` consecutive firing
    rounds enable a mitigation, the same count of quiet rounds disable
    it. A mitigation whose config gate is off (master
    ``health_mitigations`` or its sub-gate) is VETOED instead of
    enabled — counted once per streak in
    ``senweaver_grpo_health_mitigations_total{action="vetoed"}`` so a
    run that WOULD have self-modified is visible without it actually
    doing so. All transitions are returned as round events
    (``mitigation_<action>:<name>``)."""

    def __init__(self, *, enabled: bool = False,
                 allow: Optional[Dict[str, bool]] = None,
                 trigger_rounds: int = 2, registry=None):
        if registry is None:
            from ..obs import get_registry
            registry = get_registry()
        self.enabled = bool(enabled)
        self.allow = {m: True for m in _MITIGATION_TRIGGERS}
        if allow:
            self.allow.update(allow)
        self.trigger_rounds = max(1, int(trigger_rounds))
        self.active: Dict[str, bool] = {m: False
                                        for m in _MITIGATION_TRIGGERS}
        self._streak_on = {m: 0 for m in _MITIGATION_TRIGGERS}
        self._streak_off = {m: 0 for m in _MITIGATION_TRIGGERS}
        self._vetoed_this_streak = {m: False for m in _MITIGATION_TRIGGERS}
        self._pending_post: set = set()
        self._lock = threading.Lock()
        self._transitions = registry.counter(
            "senweaver_grpo_health_mitigations_total",
            "Health-mitigation transitions (enabled/disabled/vetoed).",
            labelnames=("mitigation", "action"))

    @classmethod
    def from_config(cls, config: ResilienceConfig,
                    registry=None) -> "HealthMitigator":
        return cls(
            enabled=config.health_mitigations,
            allow={
                MITIGATION_LEAVE_ONE_OUT: config.mitigate_leave_one_out,
                MITIGATION_TOKEN_LEVEL: config.mitigate_token_level,
                MITIGATION_GROUP_SIZE: config.mitigate_group_size,
                MITIGATION_LOCKSTEP_FALLBACK:
                    config.mitigate_lockstep_fallback,
            },
            trigger_rounds=config.health_trigger_rounds,
            registry=registry)

    def effective(self, grpo_config):
        """The config CURRENTLY in force (active mitigations applied,
        no streak folding) — what the round's diagnostics should mirror
        before this round's triggers are known."""
        with self._lock:
            loo = self.active[MITIGATION_LEAVE_ONE_OUT]
            tok = self.active[MITIGATION_TOKEN_LEVEL]
        out = grpo_config
        if loo and not out.leave_one_out:
            out = out._replace(leave_one_out=True)
        if tok and not out.token_level_advantages:
            out = out._replace(token_level_advantages=True)
        return out

    def note_post_step(self, triggers: Iterable[str]) -> None:
        """Feed POST-step triggers (grad sparsity / entropy / KL drift)
        into the NEXT round's streak accounting."""
        with self._lock:
            self._pending_post.update(triggers)

    def apply(self, grpo_config, triggers: Iterable[str]):
        """Fold one round's triggers; returns ``(effective_config,
        events)`` where the config has active mitigations switched on
        via ``_replace`` (the caller's config object is never mutated;
        group_size has no config field — poll :meth:`group_size_active`
        or read ``active``)."""
        events: List[str] = []
        with self._lock:
            trig = set(triggers) | self._pending_post
            self._pending_post = set()
            for mit, names in _MITIGATION_TRIGGERS.items():
                fired = any(t in trig for t in names)
                if fired:
                    self._streak_on[mit] += 1
                    self._streak_off[mit] = 0
                else:
                    self._streak_off[mit] += 1
                    self._streak_on[mit] = 0
                    self._vetoed_this_streak[mit] = False
                if (not self.active[mit]
                        and self._streak_on[mit] >= self.trigger_rounds):
                    if self.enabled and self.allow.get(mit, False):
                        self.active[mit] = True
                        self._transitions.inc(mitigation=mit,
                                              action="enabled")
                        emit_event("health_mitigation", action="enabled",
                                   mitigation=mit)
                        events.append(f"mitigation_enabled:{mit}")
                    elif not self._vetoed_this_streak[mit]:
                        self._vetoed_this_streak[mit] = True
                        self._transitions.inc(mitigation=mit,
                                              action="vetoed")
                        emit_event("health_mitigation", action="vetoed",
                                   mitigation=mit)
                        events.append(f"mitigation_vetoed:{mit}")
                elif (self.active[mit]
                        and self._streak_off[mit] >= self.trigger_rounds):
                    self.active[mit] = False
                    self._transitions.inc(mitigation=mit,
                                          action="disabled")
                    emit_event("health_mitigation", action="disabled",
                               mitigation=mit)
                    events.append(f"mitigation_disabled:{mit}")
            loo = self.active[MITIGATION_LEAVE_ONE_OUT]
            tok = self.active[MITIGATION_TOKEN_LEVEL]
        effective = grpo_config
        if loo and not effective.leave_one_out:
            effective = effective._replace(leave_one_out=True)
        if tok and not effective.token_level_advantages:
            effective = effective._replace(token_level_advantages=True)
        return effective, events

    def group_size_active(self) -> bool:
        with self._lock:
            return self.active[MITIGATION_GROUP_SIZE]

    def lockstep_fallback_active(self) -> bool:
        """True while the staleness-drift streak holds — the streaming
        learner polls this each step and runs lockstep (synchronous
        publish, zero-staleness batches) until the detector quiets."""
        with self._lock:
            return self.active[MITIGATION_LOCKSTEP_FALLBACK]
