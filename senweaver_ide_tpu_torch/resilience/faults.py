"""Fault-boundary primitives for the online GRPO loop.

The failure model (docs/resilience.md): episodes crash or hang, updates
go non-finite or spike, processes get preempted. RLAX (arxiv 2512.06392)
and the Podracer architectures (arxiv 2104.06272) treat all three as the
NORMAL case for TPU RL at scale; these types give the training stack the
vocabulary to degrade instead of dying:

- :class:`FailedEpisode` — the quarantine record a tripped episode
  boundary leaves behind (``collect_group_trajectories``);
- :class:`ResilienceConfig` — one knob bundle for the episode boundary
  (timeout / bounded retry / group-survivor thresholds) and the update
  guard (NaN/Inf + rolling z-score spike detection);
- :func:`episode_retry_delay_s` — the same exponential-backoff shape the
  agent loop serves its LLM retries with (agents/loop.py
  ``retry_delay_s``), scaled down to episode granularity.

The degradation ladder is strictly monotone: retry the episode → drop
the episode → drop the task group (when fewer than
``min_group_survivors`` episodes remain — group-relative advantages over
0–1 survivors are degenerate anyway) → skip the round. No rung raises.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

# Episodes that die with an exception vs. episodes the boundary gave up
# waiting on — kept distinct because the operator response differs
# (a timeout usually means a wedged engine slot, not bad episode code).
REASON_ERROR = "error"
REASON_TIMEOUT = "timeout"


@dataclasses.dataclass
class FailedEpisode:
    """Quarantine record for one episode the fault boundary gave up on.

    ``attempts`` counts every try including the first (attempts=3 means
    two retries were burned); ``error`` is the final attempt's repr —
    intermediate errors are assumed to share the cause."""

    task_idx: int
    g: int
    round_idx: int
    reason: str                 # REASON_ERROR | REASON_TIMEOUT
    error: str
    attempts: int
    elapsed_s: float


@dataclasses.dataclass(frozen=True)
class ResilienceConfig:
    """Knobs for the episode fault boundary + update guard.

    Frozen so a config can be shared across rounds/threads and hashed
    into test parametrizations without aliasing surprises."""

    # -- episode boundary --------------------------------------------------
    # None disables the per-episode wall-clock bound (episodes then only
    # fail by raising). A hung episode past the timeout is ABANDONED, not
    # killed — Python threads can't be; its session closes when (if) the
    # attempt eventually returns, and the round moves on without it.
    episode_timeout_s: Optional[float] = None
    episode_retries: int = 1            # extra attempts after the first
    retry_base_delay_s: float = 0.05
    retry_max_delay_s: float = 2.0
    # A task group keeps its trajectories only while at least this many
    # episodes survive (capped at group_size, so group_size=1 smoke runs
    # aren't dropped wholesale). Below it the group's advantages are
    # degenerate: 0 survivors is vacuous, 1 survivor mean-centers to 0.
    min_group_survivors: int = 2

    # -- update guard ------------------------------------------------------
    guard_updates: bool = True
    spike_zscore: float = 6.0           # |z| of loss vs rolling history
    spike_window: int = 16              # rolling history length (rounds)
    spike_min_history: int = 5          # don't judge before this many
    spike_min_std: float = 1e-3         # floor: constant history ≠ spike

    # -- health-guarded mitigations (obs/training_health.py triggers) ------
    # Master switch: when False every trigger is recorded but every
    # mitigation is VETOED (observed, counted, not applied). The
    # sub-gates pick which mitigations MAY fire once the master is on.
    health_mitigations: bool = False
    mitigate_leave_one_out: bool = True     # RLOO on rank_collapse/zero_groups
    mitigate_token_level: bool = True       # token credit on credit_collapse
    mitigate_group_size: bool = False       # scheduler hook (rl_loop/online)
    # Streaming learner → lockstep veto on staleness_drift (the async
    # pipeline polls lockstep_fallback_active, like group_size).
    mitigate_lockstep_fallback: bool = True
    # Hysteresis: a trigger must fire this many CONSECUTIVE rounds to
    # enable its mitigation, and stay quiet this many to disable it —
    # one noisy round shouldn't flip the objective back and forth.
    health_trigger_rounds: int = 2
    # Group-size scheduler clamp (only used when mitigate_group_size).
    group_size_min: int = 2
    group_size_max: int = 16


def episode_retry_delay_s(attempt: int, *, base_s: float,
                          max_s: float) -> float:
    """Backoff before retry ``attempt`` (1-based, like agents/loop.py's
    ``retry_delay_s`` — same 1.5x exponential shape, episode-scaled)."""
    return min(base_s * (1.5 ** (attempt - 1)), max_s)
