"""Pure-Python golden-model of the TS reward computation.

A direct, conditional-for-conditional transcription of the *semantics* of
``_computeRewardSignals`` (``common/traceCollectorService.ts:668-788``), used
only as the oracle in golden tests against the branchless jit head
(:mod:`senweaver_ide_tpu_torch.rewards.head`). Keep this boring and readable; never
optimize it.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..traces.schema import SpanType, Trace

_WEIGHTS = {
    "user_feedback": 0.25,
    "task_completion": 0.18,
    "tool_success_rate": 0.12,
    "tool_call_reliability": 0.08,
    "tool_call_efficiency": 0.05,
    "tool_duration_efficiency": 0.05,
    "response_efficiency": 0.08,
    "token_efficiency": 0.08,
    "conversation_efficiency": 0.11,
}


def compute_reward_signals(trace: Trace) -> Tuple[List[Dict], Optional[float]]:
    """Returns (dims, final_reward) exactly as the TS would."""
    dims: List[Dict] = []
    s = trace.summary
    is_agent = trace.chat_mode == "agent"

    # Dim 1: user feedback (:677-679)
    fb = 1.0 if s.user_feedback == "good" else (-1.0 if s.user_feedback == "bad" else 0.0)
    dims.append({"name": "user_feedback", "value": fb})

    # Dim 2: task completion (:682-692)
    completion = 0.5
    if trace.end_time is not None and not s.has_errors:
        completion = 0.8
    if s.has_errors:
        completion = -0.5
    if s.user_feedback == "good":
        completion = 1.0
    dims.append({"name": "task_completion", "value": completion})

    # Dims 3-5b, gated on tool calls (:696-729)
    if s.total_tool_calls > 0:
        rate = s.tool_calls_succeeded / s.total_tool_calls
        dims.append({"name": "tool_success_rate", "value": rate * 2 - 1})

        severe, moderate, minor = (5, 3, 2) if is_agent else (3, 2, 1)
        if s.tool_calls_failed >= severe:
            penalty = -1.0
        elif s.tool_calls_failed >= moderate:
            penalty = -0.5
        elif s.tool_calls_failed >= minor:
            penalty = -0.2
        else:
            penalty = 1.0
        dims.append({"name": "tool_call_reliability", "value": penalty})

        excellent, goodt, fair = (8, 15, 25) if is_agent else (3, 6, 10)
        if s.total_tool_calls > fair:
            count_score = -0.8
        elif s.total_tool_calls > goodt:
            count_score = -0.3
        elif s.total_tool_calls > excellent:
            count_score = 0.3
        else:
            count_score = 1.0
        dims.append({"name": "tool_call_efficiency", "value": count_score})

        if s.total_tool_duration_ms > 0:
            avg = s.total_tool_duration_ms / s.total_tool_calls
            if avg > 10000:
                dur = -0.5
            elif avg > 3000:
                dur = 0.0
            elif avg > 1000:
                dur = 0.5
            else:
                dur = 1.0
            dims.append({"name": "tool_duration_efficiency", "value": dur})

    # Dim 6: response efficiency (:732-737)
    if s.total_llm_calls > 0:
        t = 3 if is_agent else 1
        eff = max(-1.0, 1.0 - max(0, s.total_llm_calls - t) * 0.4)
        dims.append({"name": "response_efficiency", "value": eff})

    # Dim 7: token efficiency (:739-749)
    if s.total_tokens > 0:
        excellent, goodt, fair = (5000, 15000, 30000) if is_agent else (2000, 5000, 10000)
        if s.total_tokens > fair:
            tok = -0.5
        elif s.total_tokens > goodt:
            tok = 0.0
        elif s.total_tokens > excellent:
            tok = 0.5
        else:
            tok = 1.0
        dims.append({"name": "token_efficiency", "value": tok})

    # Dim 8: conversation efficiency (:752-763)
    user_msgs = sum(1 for sp in trace.spans if sp.type is SpanType.USER_MESSAGE)
    asst_msgs = sum(1 for sp in trace.spans if sp.type is SpanType.ASSISTANT_MESSAGE)
    turns = min(user_msgs, asst_msgs)
    if turns > 0:
        t = 3 if is_agent else 2
        if turns > t * 3:
            ts = -0.8
        elif turns > t * 2:
            ts = -0.3
        elif turns > t:
            ts = 0.3
        else:
            ts = 1.0
        dims.append({"name": "conversation_efficiency", "value": ts})

    # finalReward: weight-renormalized sum over present dims (:766-787)
    weighted = 0.0
    total_w = 0.0
    for d in dims:
        w = _WEIGHTS.get(d["name"], 0.05)
        weighted += d["value"] * w
        total_w += w
    final = weighted / total_w if total_w > 0 else None
    return dims, final
