"""Policy-client interface the agent loop drives.

The reference's agent loop calls ILLMMessageService.sendLLMMessage over IPC
to 20 remote providers (sendLLMMessage.impl.ts:927). The TPU build replaces
that transport with a local policy served by the rollout engine; this module
defines the seam so the loop is backend-agnostic:

- ``ChatMessage`` — role/content (+ optional tool linkage), the common
  message shape of `common/sendLLMMessageTypes.ts`.
- ``ToolCallRequest`` — a parsed tool call (name + raw string params), the
  output of XML tool-call extraction (extractGrammar.ts:324).
- ``LLMResponse`` — final text, optional reasoning, optional tool call,
  token usage.
- ``PolicyClient`` — the callable protocol; implementations: the TPU
  sampler (rollout/policy_client.py) and scripted fakes in tests.

Errors: ``ContextLengthError`` and ``RateLimitError`` drive the loop's
progressive-pruning and backoff paths (chatThreadService.ts:1437-1588).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Protocol


@dataclasses.dataclass
class ChatMessage:
    role: str                      # 'system' | 'user' | 'assistant' | 'tool'
    content: str
    tool_name: Optional[str] = None
    tool_params: Optional[Dict[str, str]] = None


@dataclasses.dataclass
class ToolCallRequest:
    name: str
    params: Dict[str, str]
    raw: str = ""


@dataclasses.dataclass
class LLMUsage:
    input_tokens: int = 0
    output_tokens: int = 0


@dataclasses.dataclass
class LLMResponse:
    text: str
    reasoning: str = ""
    tool_call: Optional[ToolCallRequest] = None
    usage: LLMUsage = dataclasses.field(default_factory=LLMUsage)
    model: str = ""


class ContextLengthError(RuntimeError):
    """Prompt exceeded the model context window — triggers the 3-stage
    progressive prune (chatThreadService.ts:1437-1559)."""


class RateLimitError(RuntimeError):
    """429-equivalent — triggers TPM backoff (chatThreadService.ts:1563-88).

    ``retry_after_s`` mirrors retry-after extraction
    (tpmRateLimiter.handleRateLimitError)."""

    def __init__(self, msg: str, retry_after_s: Optional[float] = None):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


class PolicyClient(Protocol):
    def chat(self, messages: List[ChatMessage], *,
             temperature: Optional[float] = None,
             max_tokens: Optional[int] = None,
             on_text=None) -> LLMResponse:
        """One model call. Must raise ContextLengthError / RateLimitError
        for those failure classes; any other exception is retried
        generically. ``on_text`` (optional) streams incremental text
        (the reference's onText contract); implementations without true
        streaming call it once with the final text before returning."""
        ...
