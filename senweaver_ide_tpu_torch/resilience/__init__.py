"""resilience — fault boundaries, update guards, and chaos injection.

The robustness layer for the online GRPO loop (docs/resilience.md):

- :mod:`.faults` — :class:`FailedEpisode` quarantine records,
  :class:`ResilienceConfig` (episode timeout/retry/survivor thresholds +
  update-guard knobs), and the shared retry-backoff shape;
- :mod:`.guard` — :class:`UpdateGuard`, the NaN/Inf + loss-spike veto
  over optimizer steps;
- :mod:`.chaos` — :class:`FaultPlan`, the seeded deterministic
  fault-injection harness (episode raise/hang/NaN-reward, engine
  faults) the resilience tests drive every degraded path with;
- :mod:`.lease` — :class:`LeaseStore`, single-writer leases with
  monotonically increasing fencing epochs (the learner's split-brain
  protection; see docs/serving.md "Disaggregated learner").

The episode fault boundary itself lives where the episodes run
(``training/rl_loop.collect_group_trajectories``); preemption-safe
resume lives on ``training/online.OnlineImprovementLoop`` — this package
holds the policy objects they share.
"""

from .chaos import (ChaosEngine, ChaosError, ChaosSession, EngineFault,
                    EPISODE_FAULT_KINDS, FaultPlan, FaultSpec,
                    MemoryPressureFault, MemoryPressurePlan,
                    NETWORK_FAULT_KINDS, NetworkFault, NetworkFaultPlan)
from .faults import (FailedEpisode, REASON_ERROR, REASON_TIMEOUT,
                     ResilienceConfig, episode_retry_delay_s)
from .guard import (HealthMitigator, MITIGATION_GROUP_SIZE,
                    MITIGATION_LEAVE_ONE_OUT, MITIGATION_TOKEN_LEVEL,
                    REASON_LOSS_SPIKE, REASON_NONFINITE_GRAD,
                    REASON_NONFINITE_LOSS, UpdateGuard)
from .lease import Lease, LeaseLost, LeaseStore, LeaseUnavailable
from .retry import (BREAKER_CLOSED, BREAKER_HALF_OPEN, BREAKER_OPEN,
                    CircuitBreaker, RetryBudget, RetryPolicy,
                    parse_retry_after)

__all__ = [
    "ChaosEngine", "ChaosError", "ChaosSession", "EngineFault",
    "EPISODE_FAULT_KINDS", "FaultPlan", "FaultSpec",
    "MemoryPressureFault", "MemoryPressurePlan",
    "NETWORK_FAULT_KINDS", "NetworkFault", "NetworkFaultPlan",
    "FailedEpisode", "REASON_ERROR", "REASON_TIMEOUT",
    "ResilienceConfig", "episode_retry_delay_s",
    "Lease", "LeaseLost", "LeaseStore", "LeaseUnavailable",
    "REASON_LOSS_SPIKE", "REASON_NONFINITE_GRAD", "REASON_NONFINITE_LOSS",
    "UpdateGuard", "HealthMitigator", "MITIGATION_GROUP_SIZE",
    "MITIGATION_LEAVE_ONE_OUT", "MITIGATION_TOKEN_LEVEL",
    "BREAKER_CLOSED", "BREAKER_HALF_OPEN", "BREAKER_OPEN",
    "CircuitBreaker", "RetryBudget", "RetryPolicy", "parse_retry_after",
]
