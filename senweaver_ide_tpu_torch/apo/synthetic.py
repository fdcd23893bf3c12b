"""Synthetic 6-pattern trace corpus — the framework's eval fixture.

Generates conversation traces that exhibit each of the 6 problem patterns
(``apoService.ts:635-773``; BASELINE config 2 "APO Beam-Search Top-K over the
6 problem-pattern synthetic traces (Agent chatMode)"). Used by the eval
harness and beam-search tests, and as the CPU/API-baseline corpus for the
north-star ≥2× finalReward comparison.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..traces.collector import TraceCollector
from ..traces.schema import Trace


def _base_conversation(c: TraceCollector, thread: str, mode: str,
                       user_msgs: int = 1, llm_calls: int = 1,
                       tokens_per_call: int = 1000) -> None:
    for i in range(user_msgs):
        c.record_user_message(thread, i * 2, f"please fix bug #{i} in module")
        c.record_llm_call(thread, i * 2 + 1,
                          input_tokens=tokens_per_call // 2,
                          output_tokens=tokens_per_call // 2)
        c.record_assistant_message(thread, i * 2 + 1, f"attempt {i}")
    for i in range(max(0, llm_calls - user_msgs)):
        c.record_llm_call(thread, user_msgs * 2,
                          input_tokens=tokens_per_call // 2,
                          output_tokens=tokens_per_call // 2)


def generate_pattern_traces(pattern: int, n: int, collector: TraceCollector,
                            mode: str = "agent",
                            rng: Optional[np.random.Generator] = None) -> None:
    """Append ``n`` traces exhibiting problem pattern ``pattern`` (1-6)."""
    rng = rng or np.random.default_rng(pattern)
    for k in range(n):
        thread = f"p{pattern}-{mode}-{k}"
        collector.start_trace(thread, metadata={"chatMode": mode})
        if pattern == 1:  # errors + bad feedback
            _base_conversation(collector, thread, mode)
            collector.record_error(thread, 1, "TypeError: x is undefined")
        elif pattern == 2:  # tool failures + bad feedback
            _base_conversation(collector, thread, mode)
            collector.record_tool_call(thread, 1, tool_name="run_command",
                                       tool_result="exit 1: command not found",
                                       tool_success=False, duration_ms=300)
            collector.record_tool_call(thread, 1, tool_name="edit_file",
                                       tool_success=False, duration_ms=100)
        elif pattern == 3:  # >10k tokens + bad feedback
            _base_conversation(collector, thread, mode, llm_calls=3,
                               tokens_per_call=4500)
        elif pattern == 4:  # >2 LLM calls (retries) + bad feedback
            _base_conversation(collector, thread, mode, llm_calls=4,
                               tokens_per_call=800)
        elif pattern == 5:  # ≥4 user turns + bad feedback
            _base_conversation(collector, thread, mode, user_msgs=5,
                               llm_calls=5, tokens_per_call=600)
        elif pattern == 6:  # slow tools (>15 s total) + bad feedback
            _base_conversation(collector, thread, mode)
            for j in range(3):
                collector.record_tool_call(thread, 1, tool_name="web_search",
                                           tool_success=True,
                                           duration_ms=6000 + 1000 * j)
        else:
            raise ValueError(f"unknown pattern {pattern}")
        collector.record_user_feedback(thread, 1, "bad")
        collector.end_trace_for_thread(thread)


def generate_good_traces(n: int, collector: TraceCollector,
                         mode: str = "agent") -> None:
    """Healthy conversations: few calls, successful tools, good feedback."""
    for k in range(n):
        thread = f"good-{mode}-{k}"
        collector.start_trace(thread, metadata={"chatMode": mode})
        collector.record_user_message(thread, 0, "rename this function")
        collector.record_llm_call(thread, 1, input_tokens=900, output_tokens=300)
        collector.record_tool_call(thread, 1, tool_name="edit_file",
                                   tool_success=True, duration_ms=120)
        collector.record_assistant_message(thread, 1, "done, renamed in 3 sites")
        collector.record_user_feedback(thread, 1, "good")
        collector.end_trace_for_thread(thread)


def make_six_pattern_corpus(per_pattern: int = 4, good: int = 6,
                            mode: str = "agent") -> List[Trace]:
    """The standard eval corpus: per_pattern traces of each pattern + healthy
    traces, all scored by the reward head on creation."""
    c = TraceCollector(max_traces=10_000)
    for p in range(1, 7):
        generate_pattern_traces(p, per_pattern, c, mode=mode)
    generate_good_traces(good, c, mode=mode)
    return c.get_all_traces()
