"""Token-usage tracking + performance monitoring.

TokenUsageTracker (`common/tokenUsageTracker.ts`, 299 LoC): per-request
token breakdown records and aggregate savings stats versus the 60%
TARGET_REDUCTION. PerformanceMonitor (`common/performanceMonitor.ts`, 271
LoC): prep-time/token thresholds — system message 2 s / 4k tokens
(DEFAULT_THRESHOLDS :46) — with warning callbacks.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

from .token_config import OPTIMIZATION_TARGETS


@dataclasses.dataclass
class TokenUsageRecord:
    """TokenUsageRecord (tokenUsageTracker.ts:13-36)."""
    request_id: str
    timestamp: float
    model: str = ""
    system_tokens: int = 0
    history_tokens: int = 0
    current_input_tokens: int = 0
    tool_result_tokens: int = 0
    output_tokens: int = 0
    original_tokens: int = 0       # pre-optimization estimate

    @property
    def input_tokens(self) -> int:
        return (self.system_tokens + self.history_tokens
                + self.current_input_tokens + self.tool_result_tokens)

    @property
    def saved_tokens(self) -> int:
        return max(0, self.original_tokens - self.input_tokens)


@dataclasses.dataclass
class UsageStats:
    requests: int = 0
    total_input_tokens: int = 0
    total_output_tokens: int = 0
    total_saved_tokens: int = 0
    total_original_tokens: int = 0

    @property
    def reduction_ratio(self) -> float:
        if not self.total_original_tokens:
            return 0.0
        return self.total_saved_tokens / self.total_original_tokens

    @property
    def meets_target(self) -> bool:
        return self.reduction_ratio >= OPTIMIZATION_TARGETS[
            "TARGET_REDUCTION"]


class TokenUsageTracker:
    def __init__(self, max_records: int = 500) -> None:
        self.max_records = max_records
        self._records: List[TokenUsageRecord] = []

    def record(self, rec: TokenUsageRecord) -> None:
        self._records.append(rec)
        if len(self._records) > self.max_records:
            del self._records[:len(self._records) - self.max_records]

    def stats(self) -> UsageStats:
        s = UsageStats()
        for r in self._records:
            s.requests += 1
            s.total_input_tokens += r.input_tokens
            s.total_output_tokens += r.output_tokens
            s.total_saved_tokens += r.saved_tokens
            s.total_original_tokens += r.original_tokens
        return s

    def by_model(self) -> Dict[str, UsageStats]:
        out: Dict[str, UsageStats] = {}
        for r in self._records:
            s = out.setdefault(r.model or "unknown", UsageStats())
            s.requests += 1
            s.total_input_tokens += r.input_tokens
            s.total_output_tokens += r.output_tokens
            s.total_saved_tokens += r.saved_tokens
            s.total_original_tokens += r.original_tokens
        return out


# ---- performance monitor ----

DEFAULT_THRESHOLDS = {
    "system_message_prep_ms": 2_000.0,   # performanceMonitor.ts:46-50
    "system_message_tokens": 4_000,
    "message_prep_ms": float(OPTIMIZATION_TARGETS[
        "MAX_PREPARATION_TIME_MS"]),
}


@dataclasses.dataclass
class PerfEvent:
    label: str
    duration_ms: float
    threshold_ms: float
    exceeded: bool


class PerformanceMonitor:
    def __init__(self, on_warning: Optional[Callable[[PerfEvent], None]]
                 = None) -> None:
        self.on_warning = on_warning
        self.events: List[PerfEvent] = []

    def measure(self, label: str,
                threshold_ms: Optional[float] = None):
        """Context manager timing a stage against its threshold."""
        monitor = self
        limit = threshold_ms if threshold_ms is not None else \
            DEFAULT_THRESHOLDS.get(label,
                                   DEFAULT_THRESHOLDS["message_prep_ms"])

        class _Ctx:
            def __enter__(self):
                self.t0 = time.monotonic()
                return self

            def __exit__(self, *exc):
                ms = (time.monotonic() - self.t0) * 1e3
                ev = PerfEvent(label, ms, limit, ms > limit)
                monitor.events.append(ev)
                if ev.exceeded and monitor.on_warning:
                    monitor.on_warning(ev)
                return False

        return _Ctx()
