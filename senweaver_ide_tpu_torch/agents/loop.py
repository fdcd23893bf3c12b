"""The agent loop: tool-use cycle with retries, pruning, and trace hooks.

Reproduces `_runChatAgent` (chatThreadService.ts:1172-1763) semantics as a
host-side loop driving the local TPU policy:

- outer tool-use while-loop (:1217) bounded by the agent's max_steps
- retry loop (:1294): CHAT_RETRIES=5; exponential backoff — TPM errors
  3 s·2^attempt capped at 60 s, other errors 3 s·1.5^(attempt−1) capped at
  30 s (getRetryDelay, :57-65)
- context-length errors → 3-stage progressive prune callback
  (:1437-1559); stage 3 failure falls through to the 'ultimate fallback'
  (system + last user message, convertToLLMMessageService.ts:465-472)
- rate-limit waits honor retry-after when present (:1563-1588)
- tool dispatch via ToolsService with the agent's permission filter
  (_runToolCall :939-1167 + can_agent_use_tool)
- trace hooks at the same points as the reference (:1120,:1157,:1628-1642)

The loop is deliberately synchronous: rollout concurrency comes from the
continuous-batching engine underneath (many loops interleave their chat()
calls on one chip), not from host threads.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional

from ..obs import get_tracer
from ..tools.service import ToolsService
from ..traces.collector import TraceCollector
from .llm import (ChatMessage, ContextLengthError, LLMResponse,
                  PolicyClient, RateLimitError)
from .registry import AgentDefinition, can_agent_use_tool, get_agent

CHAT_RETRIES = 5                  # chatThreadService.ts:52
BASE_RETRY_DELAY_S = 3.0          # :53
MAX_RETRY_DELAY_S = 60.0          # :54
PRUNE_STAGES = 3                  # :1437-1559


def retry_delay_s(attempt: int, is_tpm: bool) -> float:
    """getRetryDelay (chatThreadService.ts:57-65); attempt is 1-based."""
    if is_tpm:
        return min(BASE_RETRY_DELAY_S * (2.0 ** attempt), MAX_RETRY_DELAY_S)
    return min(BASE_RETRY_DELAY_S * (1.5 ** (attempt - 1)),
               MAX_RETRY_DELAY_S / 2)


@dataclasses.dataclass
class AgentLoopResult:
    final_text: str
    steps: int
    llm_calls: int
    tool_calls: int
    tool_failures: int
    aborted_reason: Optional[str] = None   # None | 'max_steps' | 'llm_error'


class AgentLoop:
    """One conversation turn of one agent against one sandbox."""

    def __init__(self, client: PolicyClient, tools: ToolsService, *,
                 collector: Optional[TraceCollector] = None,
                 thread_id: str = "rollout",
                 sleep: Callable[[float], None] = time.sleep,
                 prune: Optional[Callable[[List[ChatMessage], int],
                                          List[ChatMessage]]] = None,
                 max_tokens: Optional[int] = None):
        self.client = client
        self.tools = tools
        self.collector = collector
        self.thread_id = thread_id
        self.sleep = sleep
        self.prune = prune or self._default_prune
        self.max_tokens = max_tokens

    # The 'progressive pruning' ladder: stage 1 drops oldest tool results,
    # stage 2 drops oldest non-system messages, stage 3 = ultimate fallback
    # (system + last user message only).
    @staticmethod
    def _default_prune(messages: List[ChatMessage],
                       stage: int) -> List[ChatMessage]:
        if stage == 1:
            out, dropped = [], 0
            for m in messages:
                if m.role == "tool" and dropped < max(
                        1, sum(x.role == "tool" for x in messages) // 2):
                    dropped += 1
                    continue
                out.append(m)
            return out
        if stage == 2:
            system = [m for m in messages if m.role == "system"]
            rest = [m for m in messages if m.role != "system"]
            return system + rest[len(rest) // 2:]
        system = [m for m in messages if m.role == "system"]
        last_user = next((m for m in reversed(messages)
                          if m.role == "user"), None)
        return system + ([last_user] if last_user else [])

    def _call_with_retries(
            self, agent: AgentDefinition, messages: List[ChatMessage]
    ) -> tuple[LLMResponse, List[ChatMessage]]:
        """Returns (response, possibly-pruned message list) — the caller
        must adopt the returned list so a successful prune sticks for the
        rest of the rollout instead of replaying the overflow every step."""
        msgs = messages
        prune_stage = 0
        last_err: Optional[Exception] = None
        for attempt in range(1, CHAT_RETRIES + 1):
            try:
                resp = self.client.chat(msgs,
                                        temperature=agent.temperature,
                                        max_tokens=self.max_tokens)
                return resp, msgs
            except ContextLengthError as e:
                last_err = e
                prune_stage += 1
                if prune_stage > PRUNE_STAGES:
                    break
                msgs = self.prune(msgs, prune_stage)
            except RateLimitError as e:
                last_err = e
                if attempt == CHAT_RETRIES:
                    break
                wait = (e.retry_after_s if e.retry_after_s is not None
                        else retry_delay_s(attempt, is_tpm=True))
                self.sleep(min(wait, MAX_RETRY_DELAY_S))
            except PermissionError:
                # Access gating (e.g. services.config.GatedPolicyClient's
                # live allowed_models check) is a policy decision, not a
                # transient fault — retrying cannot change the verdict.
                raise
            except Exception as e:                      # generic retry path
                last_err = e
                if attempt == CHAT_RETRIES:
                    break
                self.sleep(retry_delay_s(attempt, is_tpm=False))
        raise last_err if last_err else RuntimeError("llm call failed")

    def run(self, agent_id: str, user_message: str, *,
            system_message: str = "",
            history: Optional[List[ChatMessage]] = None) -> AgentLoopResult:
        with get_tracer().span("agent.turn", agent=agent_id,
                               thread=self.thread_id):
            return self._run_impl(agent_id, user_message,
                                  system_message=system_message,
                                  history=history)

    def _run_impl(self, agent_id: str, user_message: str, *,
                  system_message: str = "",
                  history: Optional[List[ChatMessage]] = None
                  ) -> AgentLoopResult:
        agent = get_agent(agent_id)
        if agent is None:
            raise KeyError(f"unknown agent: {agent_id}")
        tc, tid = self.collector, self.thread_id
        messages: List[ChatMessage] = []
        sysmsg = system_message or agent.system_prompt or ""
        if sysmsg:
            messages.append(ChatMessage("system", sysmsg))
        messages.extend(history or [])
        messages.append(ChatMessage("user", user_message))
        if tc:
            tc.record_user_message(tid, 0, user_message)

        max_steps = agent.max_steps or 50
        llm_calls = tool_calls = tool_failures = steps = 0
        final_text = ""
        aborted: Optional[str] = None

        while True:
            steps += 1
            if steps > max_steps:
                aborted = "max_steps"
                break
            try:
                with get_tracer().span("agent.llm_call", step=steps):
                    resp, messages = self._call_with_retries(agent,
                                                             messages)
            except Exception as e:
                if tc:
                    tc.record_error(tid, steps, str(e))
                aborted = "llm_error"
                final_text = f"(agent error: {e})"
                break
            llm_calls += 1
            if tc:
                tc.record_llm_call(tid, steps, model=resp.model,
                                   input_tokens=resp.usage.input_tokens,
                                   output_tokens=resp.usage.output_tokens,
                                   temperature=agent.temperature)
                if resp.text:
                    tc.record_assistant_message(tid, steps, resp.text,
                                                model=resp.model)
            # History keeps the raw tool-call XML the policy emitted — the
            # next turn (and RL traces) must condition on what was actually
            # generated, not the stripped display text.
            assistant_turn = resp.text
            if resp.tool_call is not None and resp.tool_call.raw:
                assistant_turn = (assistant_turn + "\n"
                                  + resp.tool_call.raw).strip()
            messages.append(ChatMessage("assistant", assistant_turn))

            if resp.tool_call is None:
                final_text = resp.text
                break

            call = resp.tool_call
            tool_calls += 1
            if not can_agent_use_tool(agent_id, call.name):
                result_str = (f"Error: agent '{agent_id}' is not permitted "
                              f"to use tool '{call.name}'")
                ok, duration_ms = False, 0.0
            else:
                with get_tracer().span("agent.tool", tool=call.name,
                                       step=steps):
                    tr = self.tools.call_tool(call.name, dict(call.params))
                result_str = self.tools.string_of_result(tr)
                ok, duration_ms = tr.ok, tr.duration_ms
            if not ok:
                tool_failures += 1
            if tc:
                tc.record_tool_call(tid, steps, tool_name=call.name,
                                    tool_params=str(call.params),
                                    tool_result=result_str,
                                    tool_success=ok,
                                    duration_ms=duration_ms)
            messages.append(ChatMessage("tool", result_str,
                                        tool_name=call.name,
                                        tool_params=call.params))

        return AgentLoopResult(final_text=final_text, steps=steps,
                               llm_calls=llm_calls, tool_calls=tool_calls,
                               tool_failures=tool_failures,
                               aborted_reason=aborted)
