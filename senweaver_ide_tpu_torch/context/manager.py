"""Smart + enhanced context managers.

SmartContextManager.buildContext (smartContextManager.ts:308-460): priority
sliding window — system prompt and current input pinned, recent turns at
priority 95/85 with per-message compression, older history summarized at
priority 60, drop-lowest-priority optimization, logical re-ordering.

EnhancedContextManager (ref :684-900): OpenCode-style compaction — model
context limits, overflow detection at OVERFLOW_THRESHOLD (0.55 of the
window minus reserved output), two-pass tool-output pruning (large outputs
always; older-than-protected outputs beyond the 20k protected-token budget,
with a 15k minimum-prune gate), and CompactionState tracking pruned tool
IDs so the agent loop can drop those messages (chatThreadService.ts:
1458-1460 isToolPruned).
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence, Set

from . import manager_types as T
from .compressor import (compress_assistant_message,
                         compress_history_to_summary, compress_tool_result)
from .estimator import TokenEstimator
from .manager_types import (ContextBuildResult, ContextPart, MessageInput,
                            PruneResult, TokenUsageInfo)


class SmartContextManager:
    def __init__(self) -> None:
        self.estimator = TokenEstimator()

    def build_context(self, messages: Sequence[MessageInput],
                      system_prompt: str, current_input: str,
                      max_tokens: int = T.DEFAULT_MAX_TOKENS
                      ) -> ContextBuildResult:
        est = self.estimator.estimate
        original = (est(system_prompt) + est(current_input)
                    + sum(est(m.content) for m in messages))
        # Keep at least MIN_CONTEXT_TOKENS of context on big windows, but
        # never promise more than the window itself holds (small models).
        available = min(max(T.MIN_CONTEXT_TOKENS,
                            max_tokens - T.RESERVED_OUTPUT_TOKENS),
                        max_tokens) * (1 - T.TOKEN_BUFFER_RATIO)

        parts: List[ContextPart] = [
            ContextPart("system", system_prompt, est(system_prompt),
                        T.PRIORITY["SYSTEM_PROMPT"], compressible=False),
            ContextPart("user", current_input, est(current_input),
                        T.PRIORITY["CURRENT_INPUT"], compressible=False,
                        is_recent=True),
        ]
        used = parts[0].tokens + parts[1].tokens
        remaining = available - used

        history, summary_generated = self._select_history(messages,
                                                          remaining)
        parts.extend(history)

        total = sum(p.tokens for p in parts)
        removed = 0
        if total > available:
            parts, total, removed = self._optimize(parts, available)
        self._sort_logical(parts)
        return ContextBuildResult(
            parts=parts, total_tokens=total, original_tokens=original,
            compression_ratio=total / max(original, 1),
            removed_count=removed, summary_generated=summary_generated)

    def _select_history(self, messages: Sequence[MessageInput],
                        max_tokens: float
                        ) -> tuple[List[ContextPart], bool]:
        est = self.estimator.estimate
        parts: List[ContextPart] = []
        if not messages:
            return parts, False
        window = self._dynamic_window(messages, max_tokens)
        recent_count = min(window * 2, len(messages))
        recent = list(messages[-recent_count:])
        older = list(messages[:-recent_count]) if recent_count else list(
            messages)

        used = 0.0
        recent_budget = max_tokens * T.RECENT_TOKEN_RATIO
        for i in range(len(recent) - 1, -1, -1):
            if used >= recent_budget:
                break
            m = recent[i]
            turn = (len(recent) - 1 - i) // 2
            very_recent = turn < 2
            content = m.content
            tokens = est(content)
            if m.role == "tool" and tokens > T.PRUNE[
                    "LARGE_OUTPUT_THRESHOLD"] // 16:
                content = compress_tool_result(content)
                tokens = est(content)
            elif m.role == "assistant" and tokens > 1000:
                content = compress_assistant_message(content)
                tokens = est(content)
            parts.insert(0, ContextPart(
                m.role, content, tokens,
                T.PRIORITY["RECENT_2_TURNS"] if very_recent
                else T.PRIORITY["RECENT_4_TURNS"],
                compressible=not very_recent, timestamp=m.timestamp,
                turn_index=turn, tool_name=m.tool_name, is_recent=True))
            used += tokens

        summary_generated = False
        if older and used < max_tokens * 0.8:
            if len(older) > T.COMPRESSION_THRESHOLD_MESSAGES:
                summary = compress_history_to_summary(older)
                parts.insert(0, ContextPart(
                    "summary", summary, est(summary),
                    T.PRIORITY["COMPRESSED_SUMMARY"]))
                summary_generated = True
            else:
                budget = max_tokens - used
                for m in reversed(older):
                    tokens = est(m.content)
                    if tokens > budget:
                        break
                    parts.insert(0, ContextPart(
                        m.role, m.content, tokens,
                        T.PRIORITY["OLDER_HISTORY"] if m.role != "tool"
                        else T.PRIORITY["TOOL_RESULTS"],
                        timestamp=m.timestamp, tool_name=m.tool_name))
                    budget -= tokens
        return parts, summary_generated

    def _dynamic_window(self, messages: Sequence[MessageInput],
                        max_tokens: float) -> int:
        """Window turns scale with budget between MIN/MAX_RECENT_TURNS."""
        est = self.estimator.estimate
        avg = max(1.0, sum(est(m.content) for m in messages)
                  / max(len(messages), 1))
        fit = int(max_tokens * T.RECENT_TOKEN_RATIO / (avg * 2))
        return max(T.MIN_RECENT_TURNS, min(T.MAX_RECENT_TURNS, fit))

    @staticmethod
    def _optimize(parts: List[ContextPart], available: float
                  ) -> tuple[List[ContextPart], int, int]:
        """Evict lowest-priority parts first — and within a priority tier
        the OLDEST first — until under budget; survivors keep their
        original insertion (chronological) order."""
        index = {id(p): i for i, p in enumerate(parts)}
        victims = sorted(parts, key=lambda p: (p.priority, index[id(p)]))
        total = sum(p.tokens for p in parts)
        dropped: set[int] = set()
        removed = 0
        for v in victims:
            if total <= available:
                break
            if not v.compressible and v.priority >= 99:
                continue        # system prompt / current input pinned
            dropped.add(id(v))
            total -= v.tokens
            removed += 1
        keep = [p for p in parts if id(p) not in dropped]
        return keep, int(total), removed

    @staticmethod
    def _sort_logical(parts: List[ContextPart]) -> None:
        """system → summary → history (stable: keeps chronological
        insertion order) → current input last."""
        def bucket(p: ContextPart) -> int:
            if p.type == "system":
                return 0
            if p.type == "summary":
                return 1
            if p.priority == T.PRIORITY["CURRENT_INPUT"]:
                return 3
            return 2
        parts.sort(key=bucket)       # list.sort is stable


@dataclasses.dataclass
class CompactionState:
    """CompactionState (ref :646-653)."""
    is_compacting: bool = False
    last_compaction_time: Optional[float] = None
    total_pruned_tokens: int = 0
    compaction_count: int = 0
    pruned_tool_ids: Set[str] = dataclasses.field(default_factory=set)


class EnhancedContextManager:
    def __init__(self) -> None:
        self.estimator = TokenEstimator()
        self.smart = SmartContextManager()
        self.state = CompactionState()

    def model_context_limit(self, model_name: str) -> int:
        return T.model_context_limit(model_name)

    def check_needs_compaction(self, messages: Sequence[MessageInput],
                               model_name: str) -> TokenUsageInfo:
        """checkNeedsCompaction (ref :713-731)."""
        est = self.estimator.estimate
        total = sum(est(m.content) for m in messages)
        # Per-model window AND output reservation from the capability DB —
        # the single source of truth (a flat 4k reserve would consume a
        # small model's whole window and force compaction on every call).
        from ..models.capabilities import get_model_capabilities
        caps = get_model_capabilities(model_name)
        limit = caps.context_window
        available = max(1, limit - caps.reserved_output_token_space)
        usage = total / available
        return TokenUsageInfo(
            total_tokens=total, context_limit=limit,
            usage_percentage=usage,
            needs_compaction=usage >= T.OVERFLOW_THRESHOLD,
            available_tokens=available)

    def prune_tool_outputs(self, messages: Sequence[MessageInput]
                           ) -> PruneResult:
        """pruneToolOutputs (ref :743-828): pass 1 marks oversized tool
        outputs anywhere; pass 2 marks tool outputs older than the
        protected turns once past the protected-token budget; the whole
        prune is discarded below the 15k minimum (large outputs stick)."""
        cfg = T.PRUNE
        est = self.estimator.estimate
        large_ids: Set[str] = set()
        pruned_tokens = 0
        pruned_count = 0
        for m in reversed(messages):
            if (m.role == "tool" and m.tool_id
                    and m.tool_id not in self.state.pruned_tool_ids
                    and len(m.content) > cfg["LARGE_OUTPUT_THRESHOLD"]):
                pruned_tokens += est(m.content)
                pruned_count += 1
                large_ids.add(m.tool_id)

        standard_ids: Set[str] = set()
        standard_tokens = 0
        user_turns = 0
        seen_tokens = 0
        for m in reversed(messages):
            if m.role == "user":
                user_turns += 1
            if user_turns < cfg["PROTECT_RECENT_TURNS"]:
                continue
            if m.role != "tool" or not m.tool_id:
                continue
            if (m.tool_id in self.state.pruned_tool_ids
                    or m.tool_id in large_ids):
                continue
            if m.tool_name in cfg["PROTECTED_TOOLS"]:
                continue
            tokens = est(m.content)
            seen_tokens += tokens
            if seen_tokens > cfg["PROTECT_TOKENS"]:
                standard_tokens += tokens
                pruned_count += 1
                standard_ids.add(m.tool_id)
        pruned_tokens += standard_tokens

        total = sum(est(m.content) for m in messages)
        if pruned_tokens < cfg["MINIMUM_TOKENS"] and not large_ids:
            return PruneResult(0, 0, total)
        if pruned_tokens < cfg["MINIMUM_TOKENS"]:
            # Large-output pruning always sticks; drop the standard part.
            pruned_count -= len(standard_ids)
            pruned_tokens -= standard_tokens
            standard_ids = set()
        self.state.pruned_tool_ids |= large_ids | standard_ids
        self.state.total_pruned_tokens += pruned_tokens
        self.state.compaction_count += 1
        self.state.last_compaction_time = time.time()
        return PruneResult(pruned_count, pruned_tokens,
                           total - pruned_tokens)

    def is_tool_pruned(self, tool_id: str) -> bool:
        return tool_id in self.state.pruned_tool_ids

    def prepare(self, messages: Sequence[MessageInput], system_prompt: str,
                current_input: str, model_name: str) -> ContextBuildResult:
        """The chatThreadService entry: compaction check → prune →
        build (ref :880-895)."""
        info = self.check_needs_compaction(messages, model_name)
        msgs = list(messages)
        if info.needs_compaction:
            self.prune_tool_outputs(msgs)
            msgs = [m for m in msgs
                    if not (m.role == "tool" and m.tool_id
                            and self.is_tool_pruned(m.tool_id))]
        max_tokens = min(T.DEFAULT_MAX_TOKENS * 4, info.available_tokens)
        return self.smart.build_context(msgs, system_prompt, current_input,
                                        max_tokens=int(max_tokens))
