"""Trace → RolloutResult conversion (ref ``_convertTracesToRolloutResults``,
``common/apoService.ts:866-914``)."""

from __future__ import annotations

import dataclasses
from typing import List

from ..traces.schema import SpanType, Trace
from .types import RolloutMessage, RolloutResult


def trace_to_rollout(trace: Trace, chat_mode: str = None) -> RolloutResult:
    messages: List[RolloutMessage] = []
    for span in trace.spans:
        if span.type is SpanType.USER_MESSAGE:
            messages.append(RolloutMessage("user", span.data.content_preview or ""))
        elif span.type is SpanType.ASSISTANT_MESSAGE:
            messages.append(RolloutMessage("assistant", span.data.content_preview or ""))
        elif span.type is SpanType.TOOL_CALL:
            messages.append(RolloutMessage(
                "tool", span.data.tool_result or "",
                tool_name=span.data.tool_name,
                tool_success=span.data.tool_success))

    s = trace.summary
    if s.user_feedback == "good":
        status = "succeeded"
    elif s.user_feedback == "bad":
        status = "failed"
    elif s.has_errors:
        status = "failed"
    else:
        status = "unknown"

    total = s.tool_calls_succeeded + s.tool_calls_failed
    mode = chat_mode if chat_mode is not None else (
        str(trace.metadata.get("chatMode")) if trace.metadata.get("chatMode")
        else "unknown")
    return RolloutResult(
        trace_id=trace.id,
        thread_id=trace.thread_id,
        status=status,
        final_reward=s.final_reward,
        reward_dimensions=list(s.reward_dimensions),
        messages=messages,
        chat_mode=mode,
        tool_call_stats={
            "total_calls": total,
            "succeeded": s.tool_calls_succeeded,
            "failed": s.tool_calls_failed,
            "success_rate": s.tool_calls_succeeded / total if total > 0 else None,
            "by_tool_name": {k: dataclasses.asdict(v)
                             for k, v in s.tool_calls_by_name.items()},
            "total_duration_ms": s.total_tool_duration_ms,
        },
        llm_stats={
            "total_calls": s.total_llm_calls,
            "total_tokens": s.total_tokens,
        },
    )


def traces_to_rollouts(traces: List[Trace]) -> List[RolloutResult]:
    return [trace_to_rollout(t) for t in traces]
