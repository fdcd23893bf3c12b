"""Reactive TPM rate limiter.

TPMRateLimiter (`common/tpmRateLimiter.ts`, 361 LoC): send first, back off
only on 429s. Per-provider config table (:32-75), cooldown bookkeeping,
exponential backoff 2 s × 1.5^n capped at 30 s (:93-96), retry-after
extraction (:219-260), and rate-limit error classification (:193-215).

In the TPU build 'providers' are policy backends (the local sampler never
throttles, mirroring the reference's ollama ∞ entry), but the full table
stays so rollouts can also drive remote APIs for distillation/eval.
"""

from __future__ import annotations

import math
import re
import time
from typing import Dict, Optional

INF = math.inf


class TPMConfig(dict):
    pass


DEFAULT_TPM_CONFIGS: Dict[str, Dict[str, float]] = {
    "anthropic": {"tokens_per_minute": 200_000, "requests_per_minute": 500,
                  "min_request_interval_s": 0.1},
    "openai": {"tokens_per_minute": 500_000, "requests_per_minute": 500,
               "min_request_interval_s": 0.1},
    "gemini": {"tokens_per_minute": 200_000, "requests_per_minute": 500,
               "min_request_interval_s": 0.1},
    "openrouter": {"tokens_per_minute": INF, "requests_per_minute": INF,
                   "min_request_interval_s": 0.05},
    "deepseek": {"tokens_per_minute": 500_000, "requests_per_minute": 500,
                 "min_request_interval_s": 0.1},
    "ollama": {"tokens_per_minute": INF, "requests_per_minute": INF,
               "min_request_interval_s": 0.0},
    "local": {"tokens_per_minute": INF, "requests_per_minute": INF,
              "min_request_interval_s": 0.0},
    "default": {"tokens_per_minute": 200_000, "requests_per_minute": 500,
                "min_request_interval_s": 0.1},
}

BASE_BACKOFF_S = 2.0
MAX_BACKOFF_S = 30.0
BACKOFF_MULTIPLIER = 1.5

_RATE_LIMIT_PATTERNS = (
    "rate limit", "rate_limit", "too many requests", "tpm limit",
    "tokens per minute", "quota exceeded", "429", "overloaded", "capacity",
    "try again later", "resource exhausted",
)

_RETRY_AFTER_RE = re.compile(
    r"retry[-_]?after[\"':\s]+([0-9.]+)", re.IGNORECASE)


class TPMRateLimiter:
    def __init__(self, clock=time.monotonic) -> None:
        self._clock = clock
        self._last_request: Dict[str, float] = {}
        self._wait_until: Dict[str, float] = {}
        self._consecutive_errors: Dict[str, int] = {}

    def get_config(self, provider: str) -> Dict[str, float]:
        return DEFAULT_TPM_CONFIGS.get(provider,
                                       DEFAULT_TPM_CONFIGS["default"])

    def get_wait_time(self, provider: str,
                      estimated_tokens: int = 0) -> float:
        """Seconds to wait before sending (0 = go now). Cooldown from a
        prior 429, else the minimum request interval; never predictive."""
        now = self._clock()
        until = self._wait_until.get(provider)
        if until is not None and now < until:
            return until - now
        cfg = self.get_config(provider)
        last = self._last_request.get(provider, -INF)
        gap = now - last
        if gap < cfg["min_request_interval_s"]:
            return cfg["min_request_interval_s"] - gap
        return 0.0

    def record_request_start(self, provider: str) -> None:
        self._last_request[provider] = self._clock()

    def record_success(self, provider: str) -> None:
        self._consecutive_errors[provider] = 0
        self._wait_until.pop(provider, None)

    def record_rate_limit_error(self, provider: str,
                                retry_after_s: Optional[float] = None
                                ) -> float:
        """Returns the cooldown applied (seconds)."""
        n = self._consecutive_errors.get(provider, 0)
        self._consecutive_errors[provider] = n + 1
        if retry_after_s and retry_after_s > 0:
            wait = retry_after_s
        else:
            wait = min(BASE_BACKOFF_S * (BACKOFF_MULTIPLIER ** n),
                       MAX_BACKOFF_S)
        self._wait_until[provider] = self._clock() + wait
        return wait

    @staticmethod
    def is_rate_limit_error(error: BaseException | str) -> bool:
        status = getattr(error, "status", None) or getattr(
            error, "status_code", None)
        if status == 429:
            return True
        s = str(error).lower()
        return any(p in s for p in _RATE_LIMIT_PATTERNS)

    @staticmethod
    def extract_retry_after(error: BaseException | str) -> Optional[float]:
        headers = getattr(error, "headers", None)
        if isinstance(headers, dict):
            for k in ("retry-after", "Retry-After"):
                if k in headers:
                    try:
                        return float(headers[k])
                    except (TypeError, ValueError):
                        pass
        m = _RETRY_AFTER_RE.search(str(error))
        if m:
            try:
                return float(m.group(1))
            except ValueError:
                pass
        return None


tpm_rate_limiter = TPMRateLimiter()
