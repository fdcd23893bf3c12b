"""Training telemetry: tokens/sec, step-time breakdown, analytic MFU.

RLAX (arxiv 2512.06392) and the Podracer architectures (arxiv
2104.06272) treat actor/learner throughput counters as load-bearing
infrastructure for distributed RL; this module is that layer for the
GRPO loop. ``StepTelemetry.record_round`` is called once per round from
``training/rl_loop.py`` (a handful of dict writes — cheap enough to run
unconditionally, so the dashboard tile is live without span tracing) and
publishes:

- ``senweaver_tokens_per_sec{phase=train|collect}`` gauges,
- ``senweaver_train_step_ms`` histogram (plus collect/batch_build stage
  gauges ``senweaver_stage_seconds{stage=...}``),
- ``senweaver_rounds_total`` / ``senweaver_episodes_total`` /
  ``senweaver_trajectories_total`` counters,
- ``senweaver_step_flops_per_sec`` and, when a peak-FLOPs figure is
  known, ``senweaver_train_mfu``.

MFU: when the runtime observatory (``obs/runtime_profile.py``) has an
XLA ``cost_analysis()`` FLOPs figure for the profiled GRPO step, the
``senweaver_train_mfu`` gauge publishes the MEASURED utilization — compiled
FLOPs per update over the round's wall time — instead of the analytic
``6 * params * tokens`` estimate (fwd 2x + bwd 4x), which remains the
fallback when cost analysis is off. ``mfu_source`` in the returned dict
says which one you got. Peak FLOPs comes from the constructor or the
``SENWEAVER_PEAK_FLOPS`` env var (e.g. 1.97e14 for a v5e chip in bf16);
without it the absolute achieved FLOP/s gauge still publishes.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

from .metrics import MetricsRegistry

TRAIN_STEP_MS_BUCKETS = (10.0, 25.0, 50.0, 100.0, 250.0, 500.0, 1_000.0,
                         2_500.0, 5_000.0, 10_000.0, 30_000.0, 60_000.0,
                         120_000.0, 300_000.0)


def estimate_mfu(param_count: int, tokens: int, step_s: float,
                 peak_flops: float) -> float:
    """Model-FLOPs utilization of one train step (6N FLOPs/token)."""
    if step_s <= 0 or peak_flops <= 0:
        return 0.0
    return (6.0 * param_count * tokens) / (step_s * peak_flops)


def advantage_stats(rewards, group_ids) -> Dict[str, float]:
    """GRPO advantage diagnostics from HOST-side reward/group arrays.

    A group whose rewards are all identical contributes zero advantage
    — no learning signal for any of its trajectories; when most groups
    degenerate this way (reward saturation or collapse), the update is
    noise. ``zero_advantage_group_fraction`` is that early-warning
    signal (ROADMAP item 4); ``advantage_std`` is the spread of the
    group-relative advantages actually fed to the loss.

    Call BEFORE ``place_batch_for_mesh`` — sharded arrays would force a
    device sync here, and this is pure bookkeeping.

    This delegates to ``training.diagnostics.advantage_stats``
    (lazy import — obs stays below training in the layering): one
    NaN-safe code path shared with the jitted diagnostics head, instead
    of a second numpy implementation that a single non-finite reward
    silently poisoned."""
    from ..training.diagnostics import advantage_stats as _impl
    return _impl(rewards, group_ids)


class StepTelemetry:
    """Per-round throughput/MFU publisher over a metrics registry.

    Constructing one per round is fine: registry instruments are
    idempotent lookups. ``param_count`` enables the FLOPs estimate
    (``models.count_params`` of the trained tree); for LoRA states pass
    the FULL policy's count if an honest MFU is wanted — the adapter
    tree alone undercounts the forward cost.
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None, *,
                 param_count: Optional[int] = None,
                 peak_flops: Optional[float] = None):
        if registry is None:
            from . import get_registry
            registry = get_registry()
        self.registry = registry
        self.param_count = param_count
        if peak_flops is None:
            env = os.environ.get("SENWEAVER_PEAK_FLOPS")
            peak_flops = float(env) if env else None
        self.peak_flops = peak_flops
        r = registry
        self._tps = r.gauge(
            "senweaver_tokens_per_sec",
            "Token throughput per phase (train: batch tokens x ppo "
            "epochs / update time; collect: sampled completion tokens / "
            "collection time).", labelnames=("phase",))
        self._step_ms = r.histogram(
            "senweaver_train_step_ms",
            "Wall time of the GRPO update (all ppo epochs) per round.",
            buckets=TRAIN_STEP_MS_BUCKETS)
        self._stage_s = r.gauge(
            "senweaver_stage_seconds",
            "Last round's wall time per loop stage.",
            labelnames=("stage",))
        self._rounds = r.counter(
            "senweaver_rounds_total", "Completed GRPO rounds.")
        self._episodes = r.counter(
            "senweaver_episodes_total", "Episodes collected.")
        self._trajectories = r.counter(
            "senweaver_trajectories_total",
            "Trajectories (one per LLM call) collected.")
        self._flops = r.gauge(
            "senweaver_step_flops_per_sec",
            "Achieved model FLOP/s of the last train step "
            "(cost_analysis-measured when the runtime ledger has the "
            "GRPO step, 6N/token analytic estimate otherwise).")
        self._mfu = r.gauge(
            "senweaver_train_mfu",
            "Model-FLOPs utilization of the last train step "
            "(vs. peak_flops; measured or analytic per "
            "senweaver_step_flops_per_sec).")
        self._zero_adv_frac = r.gauge(
            "senweaver_grpo_zero_advantage_group_fraction",
            "Fraction of last round's GRPO groups with identical "
            "rewards (zero advantage — no learning signal).")
        self._adv_std = r.gauge(
            "senweaver_grpo_advantage_std",
            "Std of the group-relative advantages in the last round's "
            "batch.")

    def record_round(self, *, collect_s: float, batch_build_s: float,
                     train_s: float, batch_tokens: int,
                     completion_tokens: int = 0, episodes: int = 0,
                     trajectories: int = 0,
                     ppo_epochs: int = 1,
                     advantage_stats: Optional[Dict[str, float]] = None,
                     health: Optional[Dict[str, float]] = None,
                     health_triggers: Optional[list] = None,
                     health_events: Optional[list] = None,
                     round_index: Optional[int] = None
                     ) -> Dict[str, Any]:
        """Publish one round's telemetry; returns the derived values so
        the caller can also feed them to MetricsService captures.

        ``health`` is the round's flat training-health dict (from
        ``training.diagnostics`` + step metrics); it is routed to the
        global :class:`~.training_health.TrainingHealthMonitor`
        (gauges, ring, worst-K) with the precomputed ``health_triggers``
        and any mitigation ``health_events``."""
        train_tokens = batch_tokens * max(1, ppo_epochs)
        out: Dict[str, Any] = {}
        if train_s > 0:
            out["tokens_per_sec"] = train_tokens / train_s
            self._tps.set(out["tokens_per_sec"], phase="train")
        if collect_s > 0 and completion_tokens > 0:
            out["collect_tokens_per_sec"] = completion_tokens / collect_s
            self._tps.set(out["collect_tokens_per_sec"], phase="collect")
        self._step_ms.observe(train_s * 1000.0)
        self._stage_s.set(collect_s, stage="collect")
        self._stage_s.set(batch_build_s, stage="batch_build")
        self._stage_s.set(train_s, stage="train_step")
        self._rounds.inc()
        if episodes:
            self._episodes.inc(episodes)
        if trajectories:
            self._trajectories.inc(trajectories)
        if advantage_stats:
            frac = advantage_stats.get("zero_advantage_group_fraction")
            if frac is not None:
                out["zero_advantage_group_fraction"] = float(frac)
                self._zero_adv_frac.set(float(frac))
            std = advantage_stats.get("advantage_std")
            if std is not None:
                out["advantage_std"] = float(std)
                self._adv_std.set(float(std))
        if health:
            from .training_health import get_health_monitor
            out["health_triggers"] = get_health_monitor().observe(
                health, round_index=round_index,
                triggers=health_triggers, events=health_events)
            # Keep the advantage gauges live from the richer dict too.
            frac = health.get("zero_advantage_group_fraction")
            if frac is not None:
                self._zero_adv_frac.set(float(frac))
            std = health.get("advantage_std")
            if std is not None:
                self._adv_std.set(float(std))
        # Measured MFU: the runtime observatory's cost_analysis
        # FLOPs for the profiled GRPO step, over the round's measured
        # update time, REPLACES the 6N/token analytic estimate whenever
        # the ledger has it (cost analysis is opt-in; see
        # obs/runtime_profile.py). One update call per ppo epoch.
        measured_fps = None
        if train_s > 0:
            from .runtime_profile import get_profiler
            fpc = get_profiler().flops_per_call("trainer.grpo_step")
            if fpc:
                measured_fps = fpc * max(1, ppo_epochs) / train_s
        if measured_fps is not None:
            out["step_flops_per_sec"] = measured_fps
            out["mfu_source"] = "cost_analysis"
            self._flops.set(measured_fps)
            if self.peak_flops:
                out["mfu"] = measured_fps / self.peak_flops
                self._mfu.set(out["mfu"])
        elif self.param_count and train_s > 0:
            flops_per_sec = 6.0 * self.param_count * train_tokens / train_s
            out["step_flops_per_sec"] = flops_per_sec
            out["mfu_source"] = "analytic"
            self._flops.set(flops_per_sec)
            if self.peak_flops:
                out["mfu"] = estimate_mfu(self.param_count, train_tokens,
                                          train_s, self.peak_flops)
                self._mfu.set(out["mfu"])
        return out
