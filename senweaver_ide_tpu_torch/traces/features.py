"""Trace → fixed-width feature vector for the jit reward head.

The reference computes rewards directly on ``trace.summary``
(``traceCollectorService.ts:668-788``). For TPU we need a fixed-shape,
batchable representation: every trace becomes an ``(N_FEATURES,)`` float32
vector, so a store of traces is an ``(B, N_FEATURES)`` matrix that the reward
head consumes under ``jax.vmap``.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np

from .schema import SpanType, Trace

# Feature indices. Order is load-bearing: rewards/head.py indexes these.
F_FEEDBACK = 0          # +1 good / -1 bad / 0 none  (summary.userFeedback)
F_ENDED = 1             # 1.0 if end_time is set
F_HAS_ERRORS = 2        # summary.hasErrors
F_TOOL_CALLS = 3        # summary.totalToolCalls
F_TOOL_OK = 4           # summary.toolCallsSucceeded
F_TOOL_FAIL = 5         # summary.toolCallsFailed
F_TOOL_DURATION_MS = 6  # summary.totalToolDurationMs
F_LLM_CALLS = 7         # summary.totalLLMCalls
F_TOKENS = 8            # summary.totalTokens
F_USER_MSGS = 9         # count of user_message spans
F_ASSISTANT_MSGS = 10   # count of assistant_message spans
F_IS_AGENT = 11         # 1.0 if chatMode == 'agent' (adaptive thresholds)
N_FEATURES = 12

FEATURE_NAMES = (
    "feedback", "ended", "has_errors", "tool_calls", "tool_ok", "tool_fail",
    "tool_duration_ms", "llm_calls", "tokens", "user_msgs", "assistant_msgs",
    "is_agent",
)


def trace_features(trace: Trace) -> np.ndarray:
    """Extract the reward-head feature vector from one trace."""
    s = trace.summary
    fb = 1.0 if s.user_feedback == "good" else (-1.0 if s.user_feedback == "bad" else 0.0)
    user_msgs = sum(1 for sp in trace.spans if sp.type is SpanType.USER_MESSAGE)
    asst_msgs = sum(1 for sp in trace.spans if sp.type is SpanType.ASSISTANT_MESSAGE)
    out = np.zeros((N_FEATURES,), dtype=np.float32)
    out[F_FEEDBACK] = fb
    out[F_ENDED] = 1.0 if trace.end_time is not None else 0.0
    out[F_HAS_ERRORS] = 1.0 if s.has_errors else 0.0
    out[F_TOOL_CALLS] = float(s.total_tool_calls)
    out[F_TOOL_OK] = float(s.tool_calls_succeeded)
    out[F_TOOL_FAIL] = float(s.tool_calls_failed)
    out[F_TOOL_DURATION_MS] = float(s.total_tool_duration_ms)
    out[F_LLM_CALLS] = float(s.total_llm_calls)
    out[F_TOKENS] = float(s.total_tokens)
    out[F_USER_MSGS] = float(user_msgs)
    out[F_ASSISTANT_MSGS] = float(asst_msgs)
    out[F_IS_AGENT] = 1.0 if trace.chat_mode == "agent" else 0.0
    return out


def batch_features(traces: Iterable[Trace]) -> np.ndarray:
    """Stack traces into a ``(B, N_FEATURES)`` float32 batch."""
    rows = [trace_features(t) for t in traces]
    if not rows:
        return np.zeros((0, N_FEATURES), dtype=np.float32)
    return np.stack(rows, axis=0)
