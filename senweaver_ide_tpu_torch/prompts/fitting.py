"""4-phase message fitting: guarantee the prompt fits the context window.

Reproduces `prepareLLMChatMessages`'s fitting pipeline
(convertToLLMMessageService.ts:300-500):

- weight function (:313-340): trim-desire = size × multiplier; last user
  message weight 0 (never trimmed), recency ramp ×(1..2), user ×0.5,
  system ×0.01, assistant/tool ×10, already-trimmed ×0, first/last
  messages ×0.05.
- Phase 2 (:355-425): iteratively trim highest-weight messages down to
  TRIM_TO_LEN=500 chars until the budget (window − reserved output, ×3.5
  chars/token, floor 20k chars) is met.
- Phase 3 (:427-463): 15% safety margin — proportional emergency
  truncation (≥200 chars kept), then keep system + last user + last 3.
- Phase 4 (:465-500): ultimate fallback — system (trimmed to fit) + last
  user message only.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

from ..agents.llm import ChatMessage

CHARS_PER_TOKEN = 3.5             # convertToLLMMessageService.ts:48
TRIM_TO_LEN = 500                 # :49
MIN_HISTORY_CHARS = 20_000        # :363
SAFETY_MARGIN = 0.85              # :431
EMERGENCY_KEEP_CHARS = 200        # :436
MAX_TRIM_ITERATIONS = 100


@dataclasses.dataclass
class FitResult:
    messages: List[ChatMessage]
    phase_reached: int             # 1 (no trim) … 4 (ultimate fallback)
    chars_before: int
    chars_after: int


def _last_user_idx(messages: Sequence[ChatMessage]) -> int:
    for i in range(len(messages) - 1, -1, -1):
        if messages[i].role == "user":
            return i
    return -1


def _total(messages: Sequence[ChatMessage]) -> int:
    return sum(len(m.content) for m in messages)


def fit_messages(messages: Sequence[ChatMessage], *, context_window: int,
                 reserved_output_tokens: int = 4096) -> FitResult:
    msgs = [ChatMessage(m.role, m.content, m.tool_name, m.tool_params)
            for m in messages]
    before = _total(msgs)
    budget = max((context_window - reserved_output_tokens)
                 * CHARS_PER_TOKEN, 1.0)
    phase = 1
    last_user = _last_user_idx(msgs)
    trimmed: set[int] = set()

    # ---- Phase 2: weighted fine-grained trimming ----
    need = _total(msgs) - max(budget, MIN_HISTORY_CHARS)
    if need > 0:
        phase = 2

        def weight(i: int) -> float:
            m = msgs[i]
            if i == last_user:
                return 0.0
            mult = 1 + (len(msgs) - 1 - i) / len(msgs)
            if m.role == "user":
                mult *= 0.5
            elif m.role == "system":
                mult *= 0.01
            else:
                mult *= 10
            if i in trimmed:
                mult = 0.0
            if i <= 1 or i >= len(msgs) - 4:
                mult *= 0.05
            return len(m.content) * mult

        for _ in range(MAX_TRIM_ITERATIONS):
            if need <= 0 or not msgs:
                break
            idx = max(range(len(msgs)), key=weight, default=-1)
            if idx < 0 or weight(idx) <= 0:
                break
            m = msgs[idx]
            if len(m.content) <= TRIM_TO_LEN:
                trimmed.add(idx)
                continue
            will_trim = len(m.content) - TRIM_TO_LEN
            if will_trim > need:
                m.content = m.content[:len(m.content) - int(need) - 3] \
                    .rstrip() + "..."
                break
            need -= will_trim
            m.content = m.content[:TRIM_TO_LEN - 3] + "..."
            trimmed.add(idx)

    # ---- Phase 3: safety margin ----
    safe = budget * SAFETY_MARGIN
    if _total(msgs) > safe:
        phase = 3
        ratio = safe / _total(msgs)
        for i, m in enumerate(msgs):
            if m.role == "system" or i == last_user:
                continue
            target = max(EMERGENCY_KEEP_CHARS, int(len(m.content) * ratio))
            if len(m.content) > target:
                m.content = (m.content[:max(0, target - 30)]
                             + "\n...[emergency truncation]...")
        if _total(msgs) > safe and len(msgs) > 4:
            keep = {0, last_user} | set(range(max(0, len(msgs) - 3),
                                              len(msgs)))
            msgs = [m for i, m in enumerate(msgs) if i in keep]
            last_user = _last_user_idx(msgs)

    # ---- Phase 4: ultimate fallback ----
    if _total(msgs) > budget:
        phase = 4
        system = next((m for m in msgs if m.role == "system"), None)
        user = msgs[last_user] if last_user >= 0 else msgs[-1]
        out: List[ChatMessage] = []
        if system is not None:
            max_sys = max(2000, int(budget) - len(user.content) - 1000)
            if len(system.content) > max_sys:
                system = ChatMessage("system",
                                     system.content[:max_sys - 3] + "...")
            out.append(system)
        out.append(user)
        msgs = out

    return FitResult(messages=msgs, phase_reached=phase,
                     chars_before=before, chars_after=_total(msgs))
