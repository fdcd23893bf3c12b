"""The 6 problem-pattern detectors + reward-dimension patterns.

Semantics of ``_analyzePatterns`` (``common/apoService.ts:635-773``) and the
reward-dim pattern augmentation (:574-596). These patterns are the repo's eval
suite: the 6-pattern synthetic corpus (:mod:`.synthetic`) replays them and the
beam search scores candidate prompts against them (BASELINE config 2).
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ..traces.schema import SpanType, Trace, new_id
from .types import DIM_CATEGORY_MAP, IssuePattern, PatternExample

# (min occurrences, high-severity threshold) per detector, ref :644-770.
P1_ERRORS_MIN, P1_HIGH = 2, 5
P2_TOOLFAIL_MIN, P2_HIGH = 2, 5
P3_TOKENS_MIN, P3_THRESHOLD = 3, 10_000
P4_MULTICALL_MIN, P4_LLM_CALLS = 2, 2
P5_LONGCONV_MIN, P5_USER_MSGS, P5_HIGH = 2, 4, 4
P6_SLOWTOOL_MIN, P6_DURATION_MS = 2, 15_000


def _examples(traces: List[Trace], assistant_text=None) -> List[PatternExample]:
    out = []
    for t in traces[:3]:
        user = next((s for s in t.spans if s.type is SpanType.USER_MESSAGE), None)
        asst = next((s for s in t.spans if s.type is SpanType.ASSISTANT_MESSAGE), None)
        out.append(PatternExample(
            thread_id=t.thread_id,
            user_message_preview=(user.data.content_preview or "") if user else "",
            assistant_message_preview=(assistant_text(t) if assistant_text
                                       else ((asst.data.content_preview or "") if asst else "")),
            feedback=t.summary.user_feedback,
        ))
    return out


def analyze_patterns(traces: List[Trace]) -> List[IssuePattern]:
    """Run the 6 detectors over a trace window (ref :635-773)."""
    bad = [t for t in traces if t.summary.user_feedback == "bad"]
    patterns: List[IssuePattern] = []
    if not bad:
        return patterns

    # P1: errors + bad feedback (:644-663)
    p1 = [t for t in traces if t.summary.has_errors and t.summary.user_feedback == "bad"]
    if len(p1) >= P1_ERRORS_MIN:
        patterns.append(IssuePattern(
            id=new_id(),
            description="Users give negative feedback after errors occur in conversations",
            frequency=len(p1),
            severity="high" if len(p1) >= P1_HIGH else "medium",
            related_category="core_behavior",
            examples=_examples(p1),
        ))

    # P2: tool-call failures + bad feedback (:666-689)
    def _has_failed_tool(t: Trace) -> bool:
        return any(s.type is SpanType.TOOL_CALL and s.data.tool_success is False
                   for s in t.spans)

    p2 = [t for t in traces if _has_failed_tool(t) and t.summary.user_feedback == "bad"]
    if len(p2) >= P2_TOOLFAIL_MIN:
        def _fail_text(t: Trace) -> str:
            sp = next(s for s in t.spans
                      if s.type is SpanType.TOOL_CALL and s.data.tool_success is False)
            return (f"Tool {sp.data.tool_name} failed: "
                    f"{(sp.data.tool_result or '')[:100]}")
        patterns.append(IssuePattern(
            id=new_id(),
            description="Tool call failures lead to user dissatisfaction",
            frequency=len(p2),
            severity="high" if len(p2) >= P2_HIGH else "medium",
            related_category="tool_usage",
            examples=_examples(p2, _fail_text),
        ))

    # P3: high token consumption + bad (:692-709)
    p3 = [t for t in traces
          if t.summary.total_tokens > P3_THRESHOLD
          and t.summary.user_feedback == "bad"]
    if len(p3) >= P3_TOKENS_MIN:
        patterns.append(IssuePattern(
            id=new_id(),
            description="User feedback is poor in conversations with high token consumption",
            frequency=len(p3),
            severity="medium",
            related_category="context_management",
            examples=_examples(p3, lambda t: f"Total tokens: {t.summary.total_tokens}"),
        ))

    # P4: >2 LLM calls + bad = retries (:712-729)
    p4 = [t for t in traces
          if t.summary.total_llm_calls > P4_LLM_CALLS and t.summary.user_feedback == "bad"]
    if len(p4) >= P4_MULTICALL_MIN:
        patterns.append(IssuePattern(
            id=new_id(),
            description="Users still dissatisfied after multiple LLM calls (possible retries)",
            frequency=len(p4),
            severity="high",
            related_category="core_behavior",
            examples=_examples(p4, lambda t: f"LLM calls: {t.summary.total_llm_calls}"),
        ))

    # P5: ≥4 user messages + bad (:732-750)
    def _user_msgs(t: Trace) -> int:
        return sum(1 for s in t.spans if s.type is SpanType.USER_MESSAGE)

    p5 = [t for t in traces
          if _user_msgs(t) >= P5_USER_MSGS and t.summary.user_feedback == "bad"]
    if len(p5) >= P5_LONGCONV_MIN:
        patterns.append(IssuePattern(
            id=new_id(),
            description="Long conversations with many turns still result in user dissatisfaction",
            frequency=len(p5),
            severity="high" if len(p5) >= P5_HIGH else "medium",
            related_category="core_behavior",
            examples=_examples(p5, lambda t: f"Conversation turns: {_user_msgs(t)}"),
        ))

    # P6: slow tools + bad (:753-770)
    p6 = [t for t in traces
          if t.summary.total_tool_duration_ms > P6_DURATION_MS
          and t.summary.user_feedback == "bad"]
    if len(p6) >= P6_SLOWTOOL_MIN:
        patterns.append(IssuePattern(
            id=new_id(),
            description="Slow tool execution (>15s total) correlates with user dissatisfaction",
            frequency=len(p6),
            severity="medium",
            related_category="tool_usage",
            examples=_examples(
                p6, lambda t: f"Tool duration: {t.summary.total_tool_duration_ms / 1000:.1f}s"),
        ))

    return patterns


def reward_dimension_patterns(
        reward_by_dim: Dict[str, Dict[str, float]]) -> List[IssuePattern]:
    """Dim-avg < −0.3 with n≥5 → pattern (ref :574-596)."""
    out: List[IssuePattern] = []
    for name, stats in reward_by_dim.items():
        if stats["avg"] < -0.3 and stats["count"] >= 5:
            out.append(IssuePattern(
                id=new_id(),
                description=(f"{name} dimension reward signal consistently low "
                             f"(avg: {stats['avg']:.3f})"),
                frequency=int(stats["count"]),
                severity="high" if stats["avg"] < -0.5 else "medium",
                related_category=DIM_CATEGORY_MAP.get(name, "core_behavior"),
                examples=[],
            ))
    return out
