"""resilience — fault boundaries and update guards (PyTorch port).

- :mod:`.faults` — :class:`FailedEpisode` quarantine records,
  :class:`ResilienceConfig` and the shared retry-backoff shape;
- :mod:`.guard` — :class:`UpdateGuard`, the NaN/Inf + loss-spike veto
  over optimizer steps, and :class:`HealthMitigator`;
- :mod:`.retry` — retry policies, budgets and circuit breakers.

The chaos harness (``chaos``) and the learner's leases (``lease``) come
with the host-plane slice.
"""

from .faults import (FailedEpisode, REASON_ERROR, REASON_TIMEOUT,
                     ResilienceConfig, episode_retry_delay_s)
from .guard import (HealthMitigator, MITIGATION_GROUP_SIZE,
                    MITIGATION_LEAVE_ONE_OUT, MITIGATION_TOKEN_LEVEL,
                    REASON_LOSS_SPIKE, REASON_NONFINITE_GRAD,
                    REASON_NONFINITE_LOSS, UpdateGuard)
from .retry import (BREAKER_CLOSED, BREAKER_HALF_OPEN, BREAKER_OPEN,
                    CircuitBreaker, RetryBudget, RetryPolicy,
                    parse_retry_after)

__all__ = [
    "FailedEpisode", "REASON_ERROR", "REASON_TIMEOUT",
    "ResilienceConfig", "episode_retry_delay_s",
    "REASON_LOSS_SPIKE", "REASON_NONFINITE_GRAD", "REASON_NONFINITE_LOSS",
    "UpdateGuard", "HealthMitigator", "MITIGATION_GROUP_SIZE",
    "MITIGATION_LEAVE_ONE_OUT", "MITIGATION_TOKEN_LEVEL",
    "BREAKER_CLOSED", "BREAKER_HALF_OPEN", "BREAKER_OPEN",
    "CircuitBreaker", "RetryBudget", "RetryPolicy", "parse_retry_after",
]
