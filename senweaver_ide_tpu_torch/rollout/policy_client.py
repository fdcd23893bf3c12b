"""PolicyClient over the TPU rollout engine.

This is the seam where the reference's remote LLM transport
(`sendLLMMessage.impl.ts` → provider HTTPS) becomes a local TPU policy:
chat messages are rendered to the policy's chat template, tokenized
host-side, decoded on the engine's continuous-batching pool, and the output
is passed through grammar extraction (think-tags + XML tool calls,
prompts/grammar.py) — exactly the pipeline a provider without a native tool
API gets in the reference.

``EnginePolicyClient.chat`` drives engine.step() until its own request
finishes; other agent loops' requests interleave on the same pool, which is
how many concurrent rollouts share one chip.

Context-window errors are raised as ``ContextLengthError`` so the agent
loop's progressive-pruning path engages (chatThreadService.ts:1437-1559).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from ..agents.llm import (ChatMessage, ContextLengthError, LLMResponse,
                          LLMUsage, ToolCallRequest)
from ..prompts.grammar import extract_reasoning_and_tool_call
from .engine import RolloutEngine

# Minimal ChatML-style template (Qwen2.5 family convention); the byte
# tokenizer renders it verbatim, an HF tokenizer would too.
_ROLE_OPEN = "<|im_start|>"
_ROLE_CLOSE = "<|im_end|>"


def render_chat_template(messages: Sequence[ChatMessage]) -> str:
    parts: List[str] = []
    for m in messages:
        role = m.role if m.role != "tool" else "user"
        content = m.content
        if m.role == "tool":
            content = (f"[{m.tool_name or 'tool'} result]\n{content}")
        parts.append(f"{_ROLE_OPEN}{role}\n{content}{_ROLE_CLOSE}")
    parts.append(f"{_ROLE_OPEN}assistant\n")
    return "\n".join(parts)


class EnginePolicyClient:
    """PolicyClient backed by a RolloutEngine + tokenizer."""

    def __init__(self, engine: RolloutEngine, tokenizer, *,
                 model_name: str = "",
                 default_max_new_tokens: int = 512,
                 tool_names: Optional[Sequence[str]] = None,
                 record_calls: bool = False,
                 auto_prefix: bool = False,
                 continue_turns: bool = False):
        self.engine = engine
        self.tokenizer = tokenizer
        self.model_name = model_name
        self.default_max_new_tokens = default_max_new_tokens
        self.tool_names = tool_names
        # Shared-prefix acceleration: register each distinct system
        # message's rendered/tokenized form with the engine ONCE and
        # submit later turns with its prefix_id — every agent episode
        # in a GRPO group repeats the same big system prompt, and the
        # engine then installs its KV by HBM copy instead of prefill.
        self.auto_prefix = auto_prefix
        self._prefix_ids: dict = {}
        # Multi-turn KV continuation: hold the decode slot between chat
        # calls and, when the next rendered prompt byte-exactly EXTENDS
        # the previous turn's token stream, prefill only the delta
        # (engine.submit(continue_from=...)). Re-rendering often breaks
        # exact extension (extraction, eos markers) — then we release
        # and fall back to a full prefill, which is always correct.
        self.continue_turns = continue_turns
        self._held_turn: Optional[tuple] = None   # (rid, full_ids)
        # When recording, every chat() appends (prompt_ids, output_ids) —
        # the exact token streams GRPO trains on (no re-tokenization
        # drift between rollout and training).
        self.record_calls = record_calls
        # (prompt_ids, output_ids, behavior_logps) per call
        self.call_log: List[tuple] = []

    def _system_prefix_id(self, system_msg: ChatMessage,
                          prompt_ids: List[int]) -> Optional[int]:
        """prefix_id for this system message, registering on first use.

        The cached prefix is the rendered system block alone (the turn
        boundary "\n" that follows it belongs to the prefix so the
        suffix split is exact). Returns None when the current prompt
        does not start with it (e.g. the tokenizer merged across the
        boundary) or when it doesn't fit the engine pool."""
        key = system_msg.content
        if key not in self._prefix_ids:
            rendered = render_chat_template([system_msg])
            # drop the trailing assistant-open stub the template appends
            stub = f"{_ROLE_OPEN}assistant\n"
            if not rendered.endswith(stub):
                # template drift: disable prefix caching for this
                # system message rather than mis-splitting the prompt
                self._prefix_ids[key] = None
                return None
            prefix_text = rendered[:-len(stub)]
            ids = self.tokenizer.encode(prefix_text, add_bos=True)
            try:
                self._prefix_ids[key] = (
                    self.engine.register_prefix(ids), ids)
            except ValueError:          # longer than the pool: skip
                self._prefix_ids[key] = None
        entry = self._prefix_ids[key]
        if entry is None:
            return None
        pid, ids = entry
        return pid if prompt_ids[:len(ids)] == ids else None

    def release_held_slot(self) -> None:
        """Free the engine slot held for turn continuation (call when
        the conversation ends — RolloutSession.close does)."""
        if self._held_turn is not None:
            self.engine.release_slot(self._held_turn[0])
            self._held_turn = None

    def chat(self, messages: List[ChatMessage], *,
             temperature: Optional[float] = None,
             max_tokens: Optional[int] = None,
             on_text=None) -> LLMResponse:
        prompt_text = render_chat_template(messages)
        prompt_ids = self.tokenizer.encode(prompt_text, add_bos=True)
        budget = max_tokens or self.default_max_new_tokens
        # Ring engines (sliding-window models) accept prompts past the
        # pool size via chunked prefill; context_bound is the engine's
        # public contract for the longest servable context.
        bound = self.engine.context_bound
        if len(prompt_ids) + budget >= bound:
            raise ContextLengthError(
                f"prompt of {len(prompt_ids)} tokens + {budget} output "
                f"exceeds engine window {bound}")
        rid = None
        if self.continue_turns and self._held_turn is not None:
            prev_rid, prev_ids = self._held_turn
            if (len(prompt_ids) > len(prev_ids)
                    and prompt_ids[:len(prev_ids)] == prev_ids):
                try:
                    rid = self.engine.submit(
                        prompt_ids, max_new_tokens=budget,
                        continue_from=prev_rid, hold_slot=True,
                        eos_id=self.tokenizer.eos_id)
                except ValueError:
                    rid = None
            if rid is None:           # not an extension: free the slot
                self.engine.release_slot(prev_rid)
                self._held_turn = None
        if rid is None:
            prefix_id = None
            if (self.auto_prefix and messages
                    and messages[0].role == "system"):
                prefix_id = self._system_prefix_id(messages[0], prompt_ids)
            try:
                rid = self.engine.submit(prompt_ids, max_new_tokens=budget,
                                         prefix_id=prefix_id,
                                         hold_slot=self.continue_turns,
                                         eos_id=self.tokenizer.eos_id)
            except KeyError:
                # The engine dropped registered prefixes (weight sync
                # invalidates their KV — engine.update_params). Forget
                # ours and re-register against the new policy.
                self._prefix_ids.clear()
                prefix_id = self._system_prefix_id(messages[0], prompt_ids)
                rid = self.engine.submit(prompt_ids, max_new_tokens=budget,
                                         prefix_id=prefix_id,
                                         hold_slot=self.continue_turns,
                                         eos_id=self.tokenizer.eos_id)
        if on_text is None:
            while not self.engine.is_done(rid):
                self.engine.step()
        else:
            # Streaming (the reference's onText contract,
            # sendLLMMessageService.ts). Three hazards, all handled by
            # re-reading the AUTHORITATIVE engine.result(rid) each
            # iteration and emitting only safe suffixes:
            # - concurrent chat() loops share the engine, and step()'s
            #   return drains other requests' emits — result(rid) is
            #   complete regardless of who stepped;
            # - a partial UTF-8 tail decodes to U+FFFD and would
            #   retro-change, so trailing replacement chars are held
            #   back (up to 3 bytes) until resolved;
            # - the chat-template end marker arrives one token at a
            #   time, so a trailing PREFIX of it is held back until it
            #   completes (cut) or diverges (streamed).
            sent = ""

            def _safe_text(ids, final):
                for hold in range(0, min(3, len(ids)) + 1):
                    view = ids[:len(ids) - hold] if hold else ids
                    text = self.tokenizer.decode(view)
                    if final or not text.endswith("\ufffd"):
                        break
                end = text.find(_ROLE_CLOSE)
                if end != -1:
                    return text[:end]
                if not final:
                    for k in range(len(_ROLE_CLOSE) - 1, 0, -1):
                        if text.endswith(_ROLE_CLOSE[:k]):
                            return text[:len(text) - k]
                return text

            def _push(final=False):
                nonlocal sent
                text = _safe_text(self.engine.result(rid), final)
                if text.startswith(sent) and len(text) > len(sent):
                    on_text(text[len(sent):])
                    sent = text

            seen = 0
            while not self.engine.is_done(rid):
                self.engine.step()
                n = len(self.engine.result(rid))
                if n > seen:      # skip re-decoding when queued/no emit
                    seen = n
                    _push()
            _push(final=True)                 # flush held-back tail
        out_ids = self.engine.result(rid)
        if self.continue_turns:
            self._held_turn = (rid, list(prompt_ids) + list(out_ids))
        if self.record_calls:
            self.call_log.append((list(prompt_ids), list(out_ids),
                                  self.engine.result_logps(rid)))
        raw = self.tokenizer.decode(out_ids)
        # Cut at the chat-template end marker if the model emitted one.
        end = raw.find(_ROLE_CLOSE)
        if end != -1:
            raw = raw[:end]
        text, reasoning, call = extract_reasoning_and_tool_call(
            raw, tool_names=self.tool_names)
        tool_call = None
        if call is not None and call.is_done:
            tool_call = ToolCallRequest(name=call.name,
                                        params=dict(call.params),
                                        raw=call.raw)
        return LLMResponse(
            text=text, reasoning=reasoning, tool_call=tool_call,
            usage=LLMUsage(input_tokens=len(prompt_ids),
                           output_tokens=len(out_ids)),
            model=self.model_name)
