"""Native provider clients: anthropic-messages and gemini-generateContent.

The reference speaks two non-openai wire formats natively — the Anthropic
SDK (``sendAnthropicChat``, sendLLMMessage.impl.ts:529) and Google GenAI
(``sendGeminiChat``, :786); every other provider consolidates onto the
openai-compatible client. The registry once listed both styles
but shipped no client for them (dead entries); these stdlib-urllib
implementations make the entries live. Both are PolicyClient-shaped, so
the agent loop / distillation rollouts can drive them interchangeably
with the local TPU engine.
"""

from __future__ import annotations

import json
import os
import urllib.error
import urllib.request
from typing import Dict, List, Optional, Tuple

from ..agents.llm import (ChatMessage, ContextLengthError, LLMResponse,
                          LLMUsage, RateLimitError)
from ..context.rate_limiter import TPMRateLimiter, tpm_rate_limiter
from .http_client import OpenAICompatClient, TransportUnavailable
from .providers import ProviderSettings, get_provider

ANTHROPIC_VERSION = "2023-06-01"


def _post_json(url: str, body: dict, headers: Dict[str, str],
               timeout_s: float, provider: str,
               limiter: TPMRateLimiter) -> dict:
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **headers},
        method="POST")
    limiter.record_request_start(provider)
    try:
        with urllib.request.urlopen(req, timeout=timeout_s) as resp:
            payload = json.loads(resp.read())
    except urllib.error.HTTPError as e:
        detail = ""
        try:
            detail = e.read().decode(errors="replace")[:500]
        except Exception:
            pass
        if e.code == 429:
            retry_after = None
            ra = e.headers.get("retry-after") if e.headers else None
            if ra:
                try:
                    retry_after = float(ra)
                except ValueError:
                    pass
            limiter.record_rate_limit_error(provider, retry_after)
            raise RateLimitError(f"{provider}: 429 {detail}",
                                 retry_after_s=retry_after)
        low = detail.lower()
        if e.code in (400, 413) and ("context" in low or "token" in low
                                     or "too long" in low):
            raise ContextLengthError(f"{provider}: {detail}")
        raise RuntimeError(f"{provider}: HTTP {e.code} {detail}")
    except (urllib.error.URLError, OSError, TimeoutError) as e:
        raise TransportUnavailable(f"{provider} unreachable at {url}: {e}")
    limiter.record_success(provider)
    return payload


def _split_system(messages: List[ChatMessage]
                  ) -> Tuple[str, List[ChatMessage]]:
    system = "\n\n".join(m.content for m in messages if m.role == "system")
    return system, [m for m in messages if m.role != "system"]


class AnthropicMessagesClient:
    """PolicyClient over POST /v1/messages (the anthropic-native style the
    reference reaches through @anthropic-ai/sdk)."""

    def __init__(self, *, model: Optional[str] = None,
                 base_url: Optional[str] = None,
                 api_key: Optional[str] = None,
                 timeout_s: float = 120.0,
                 max_tokens_default: int = 4096,
                 rate_limiter: Optional[TPMRateLimiter] = None):
        settings = get_provider("anthropic")
        self.model = model or settings.default_model
        self.base_url = (base_url or settings.base_url).rstrip("/")
        self.api_key = api_key or os.environ.get(settings.api_key_env, "")
        self.timeout_s = timeout_s
        self.max_tokens_default = max_tokens_default
        self.limiter = rate_limiter or tpm_rate_limiter

    def chat(self, messages: List[ChatMessage], *,
             temperature: Optional[float] = None,
             max_tokens: Optional[int] = None,
             on_text=None) -> LLMResponse:
        system, rest = _split_system(messages)
        body = {
            "model": self.model,
            # max_tokens is REQUIRED by the messages API.
            "max_tokens": max_tokens or self.max_tokens_default,
            "messages": [
                {"role": "assistant" if m.role == "assistant" else "user",
                 "content": m.content if m.role != "tool"
                 else f"[{m.tool_name or 'tool'} result]\n{m.content}"}
                for m in rest],
        }
        if system:
            body["system"] = system
        if temperature is not None:
            body["temperature"] = temperature
        payload = _post_json(
            f"{self.base_url}/v1/messages", body,
            {"x-api-key": self.api_key,
             "anthropic-version": ANTHROPIC_VERSION},
            self.timeout_s, "anthropic", self.limiter)
        text = "".join(block.get("text", "")
                       for block in payload.get("content", [])
                       if block.get("type") == "text")
        usage = payload.get("usage") or {}
        resp = LLMResponse(
            text=text,
            usage=LLMUsage(input_tokens=int(usage.get("input_tokens", 0)),
                           output_tokens=int(usage.get("output_tokens", 0))),
            model=payload.get("model", self.model))
        if on_text is not None and resp.text:
            on_text(resp.text)      # end-flush: non-streaming transport
        return resp


class GeminiClient:
    """PolicyClient over POST /v1beta/models/{model}:generateContent (the
    gemini-native style of sendGeminiChat)."""

    def __init__(self, *, model: Optional[str] = None,
                 base_url: Optional[str] = None,
                 api_key: Optional[str] = None,
                 timeout_s: float = 120.0,
                 rate_limiter: Optional[TPMRateLimiter] = None):
        settings = get_provider("gemini")
        self.model = model or settings.default_model
        self.base_url = (base_url or settings.base_url).rstrip("/")
        self.api_key = api_key or os.environ.get(settings.api_key_env, "")
        self.timeout_s = timeout_s
        self.limiter = rate_limiter or tpm_rate_limiter

    def chat(self, messages: List[ChatMessage], *,
             temperature: Optional[float] = None,
             max_tokens: Optional[int] = None,
             on_text=None) -> LLMResponse:
        system, rest = _split_system(messages)
        contents = []
        for m in rest:
            role = "model" if m.role == "assistant" else "user"
            text = (m.content if m.role != "tool"
                    else f"[{m.tool_name or 'tool'} result]\n{m.content}")
            contents.append({"role": role, "parts": [{"text": text}]})
        body: dict = {"contents": contents}
        if system:
            body["systemInstruction"] = {"parts": [{"text": system}]}
        gen_cfg = {}
        if temperature is not None:
            gen_cfg["temperature"] = temperature
        if max_tokens is not None:
            gen_cfg["maxOutputTokens"] = max_tokens
        if gen_cfg:
            body["generationConfig"] = gen_cfg
        payload = _post_json(
            f"{self.base_url}/v1beta/models/{self.model}:generateContent",
            body, {"x-goog-api-key": self.api_key}, self.timeout_s,
            "gemini", self.limiter)
        cands = payload.get("candidates") or [{}]
        parts = ((cands[0].get("content") or {}).get("parts")) or []
        text = "".join(p.get("text", "") for p in parts)
        meta = payload.get("usageMetadata") or {}
        resp = LLMResponse(
            text=text,
            usage=LLMUsage(
                input_tokens=int(meta.get("promptTokenCount", 0)),
                output_tokens=int(meta.get("candidatesTokenCount", 0))),
            model=payload.get("modelVersion", self.model))
        if on_text is not None and resp.text:
            on_text(resp.text)      # end-flush: non-streaming transport
        return resp


def make_client(provider: str, **kwargs):
    """Instantiate the right transport for a registry provider — the
    dispatch table of sendLLMMessageToProviderImplementation
    (sendLLMMessage.impl.ts:927), minus the local engine (built via
    rollout.EnginePolicyClient)."""
    settings = get_provider(provider) or ProviderSettings(
        provider, "openai-compat")
    style = settings.endpoint_style
    if style == "anthropic":
        return AnthropicMessagesClient(**kwargs)
    if style == "gemini":
        return GeminiClient(**kwargs)
    if style == "openai-compat":
        return OpenAICompatClient(provider, **kwargs)
    raise ValueError(
        f"provider {provider!r} has endpoint style {style!r}; use the "
        f"rollout engine for the local policy")
