"""Shared retry policy + circuit breaker for every network-ish edge.

Before this module the repo had the same retry loop written twice with
different bugs available to each copy: ``traces/uploader.py`` retried
transient 5xx in-call with jittered backoff, and ``serve/router.py``
retried orphaned requests across replica deaths with the episode
boundary's backoff shape. The remote-replica transport would have been
a third copy. This is the one policy object they all share:

- :class:`RetryPolicy` — how many retries, what backoff shape (the
  ``episode_retry_delay_s`` 1.5x exponential, so serving and training
  degrade identically), whether to jitter, and an optional total
  deadline across attempts.
- :class:`RetryBudget` — per-operation accounting: ``next_delay()``
  either returns how long to back off before the next attempt or None
  when the budget (attempts OR deadline) is spent. Understands
  server-provided ``Retry-After`` floors: backoff never undercuts what
  the server asked for.
- :class:`CircuitBreaker` — per-target CLOSED → OPEN → HALF_OPEN
  machine. Consecutive failures past the threshold open the circuit
  (callers fail fast instead of burning timeouts against a dead host);
  after ``reset_timeout_s`` one probe call is let through (HALF_OPEN)
  and its outcome closes or re-opens the circuit. Time is always passed
  in by the caller (``now``), never read from a wall clock, so every
  breaker test runs on a fake clock.

None of this sleeps or reads clocks on its own — callers own time and
sleeping, which keeps the policy pure and the chaos tests hermetic.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Optional

from .faults import episode_retry_delay_s

# Breaker states (gauge-friendly codes: 0 closed, 1 half-open, 2 open).
BREAKER_CLOSED = "closed"
BREAKER_OPEN = "open"
BREAKER_HALF_OPEN = "half_open"
BREAKER_STATE_CODE = {BREAKER_CLOSED: 0, BREAKER_HALF_OPEN: 1,
                      BREAKER_OPEN: 2}


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """How one logical operation retries: attempts, backoff, deadline.

    ``max_retries`` counts retries BEYOND the first attempt (0 = one
    attempt, no retry). ``deadline_s``, when set, bounds the total time
    budget across attempts — an operation whose next backoff would land
    past the deadline gives up early instead of sleeping into it.
    """

    max_retries: int = 2
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    jitter: bool = True
    deadline_s: Optional[float] = None

    def backoff_s(self, attempt: int) -> float:
        """Raw (unjittered) backoff before retry ``attempt`` (1-based) —
        the same 1.5x exponential the episode fault boundary uses."""
        return episode_retry_delay_s(attempt, base_s=self.base_delay_s,
                                     max_s=self.max_delay_s)


class RetryBudget:
    """Attempt/deadline accounting for ONE operation under a policy.

    Usage::

        budget = RetryBudget(policy, now=clock())
        while True:
            try:
                return do_call()
            except TransientError:
                delay = budget.next_delay(now=clock())
                if delay is None:
                    raise            # budget spent
                sleep(delay)
    """

    def __init__(self, policy: RetryPolicy, *, now: float, rng=None):
        self.policy = policy
        self.started_at = now
        self.attempt = 0            # retries consumed so far
        self._rng = rng

    def next_delay(self, *, now: float,
                   retry_after_s: Optional[float] = None
                   ) -> Optional[float]:
        """Consume one retry; returns the backoff to wait, or None when
        the budget is spent. ``retry_after_s`` (a server's Retry-After)
        is a FLOOR: the delay is at least that, never jittered below."""
        self.attempt += 1
        if self.attempt > self.policy.max_retries:
            return None
        delay = self.policy.backoff_s(self.attempt)
        if self.policy.jitter and self._rng is not None:
            delay *= 0.5 + self._rng.random()
        if retry_after_s is not None:
            delay = max(delay, float(retry_after_s))
        if self.policy.deadline_s is not None:
            remaining = self.policy.deadline_s - (now - self.started_at)
            if delay >= remaining:
                return None         # would sleep past the deadline
        return delay


def parse_retry_after(value) -> Optional[float]:
    """Seconds to wait from a Retry-After header value (delta-seconds or
    HTTP-date), or None when absent/unparseable. HTTP-dates in the past
    collapse to 0 (retry immediately is what the server asked for)."""
    if value is None:
        return None
    s = str(value).strip()
    try:
        return max(0.0, float(s))
    except ValueError:
        pass
    try:
        import email.utils
        import time as _time
        dt = email.utils.parsedate_to_datetime(s)
        if dt is None:
            return None
        return max(0.0, dt.timestamp() - _time.time())
    except (TypeError, ValueError, OverflowError):
        return None


class CircuitBreaker:
    """Per-target failure gate: CLOSED → OPEN → HALF_OPEN → CLOSED.

    ``failure_threshold`` CONSECUTIVE failures open the circuit; while
    open, :meth:`allow` returns False until ``reset_timeout_s`` has
    passed, at which point exactly one caller is admitted as the
    half-open probe. A success closes the circuit; a failure re-opens it
    for another full timeout. All time arrives via ``now`` arguments.
    """

    def __init__(self, *, failure_threshold: int = 5,
                 reset_timeout_s: float = 30.0,
                 on_state_change: Optional[Callable[[str], None]] = None):
        self.failure_threshold = max(1, int(failure_threshold))
        self.reset_timeout_s = float(reset_timeout_s)
        self.state = BREAKER_CLOSED         # guarded-by: _lock
        self.failures = 0                   # guarded-by: _lock
        self.opened_at: Optional[float] = None  # guarded-by: _lock
        self.opens_total = 0                # guarded-by: _lock
        self._probe_inflight = False        # guarded-by: _lock
        self._on_state_change = on_state_change
        self._lock = threading.Lock()

    def _set_state(self, state: str) -> None:
        """Caller holds the lock."""
        if state == self.state:
            return
        self.state = state
        if state == BREAKER_OPEN:
            self.opens_total += 1
        if self._on_state_change is not None:
            self._on_state_change(state)

    def allow(self, now: float) -> bool:
        """May a call proceed right now? Transitions OPEN → HALF_OPEN
        when the reset timeout has elapsed (admitting one probe)."""
        with self._lock:
            if self.state == BREAKER_CLOSED:
                return True
            if self.state == BREAKER_OPEN:
                if (self.opened_at is not None
                        and now - self.opened_at >= self.reset_timeout_s):
                    self._set_state(BREAKER_HALF_OPEN)
                    self._probe_inflight = True
                    return True
                return False
            # HALF_OPEN: one probe at a time.
            if self._probe_inflight:
                return False
            self._probe_inflight = True
            return True

    def would_allow(self, now: float) -> bool:
        """Passive :meth:`allow` — same answer, no state transition, no
        probe-slot consumption. For routing decisions (``accepting``)
        that must not spend the half-open probe they aren't making."""
        with self._lock:
            if self.state == BREAKER_CLOSED:
                return True
            if self.state == BREAKER_OPEN:
                return (self.opened_at is not None
                        and now - self.opened_at >= self.reset_timeout_s)
            return not self._probe_inflight

    def record_success(self, now: float) -> None:
        with self._lock:
            self.failures = 0
            self._probe_inflight = False
            self._set_state(BREAKER_CLOSED)

    def record_failure(self, now: float) -> None:
        with self._lock:
            self._probe_inflight = False
            if self.state == BREAKER_HALF_OPEN:
                # The probe failed: straight back to OPEN for another
                # full reset timeout.
                self.opened_at = now
                self._set_state(BREAKER_OPEN)
                return
            self.failures += 1
            if (self.state == BREAKER_CLOSED
                    and self.failures >= self.failure_threshold):
                self.opened_at = now
                self._set_state(BREAKER_OPEN)

    @property
    def state_code(self) -> int:
        return BREAKER_STATE_CODE[self.state]
