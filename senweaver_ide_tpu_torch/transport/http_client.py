"""OpenAI-compatible HTTP chat client (PolicyClient-shaped).

The remote half of the transport layer: one client covers every
openai-compatible provider in the registry, exactly as the reference
consolidates 18 of its 20 providers onto `_sendOpenAICompatibleChat`
(sendLLMMessage.impl.ts:338 + newOpenAICompatibleSDK :94-181). Built on
urllib (no SDK deps); rate limiting is the reactive TPM limiter
(context/rate_limiter.py) and errors map onto the agent loop's retry
classes (RateLimitError / ContextLengthError).

Hermetic environments have zero egress: calls fail fast with a clear
TransportUnavailable unless the environment provides connectivity — the
registry + client still define the full API surface.
"""

from __future__ import annotations

import json
import os
import urllib.error
import urllib.request
from typing import List, Optional

from ..agents.llm import (ChatMessage, ContextLengthError, LLMResponse,
                          LLMUsage, RateLimitError)
from ..context.rate_limiter import TPMRateLimiter, tpm_rate_limiter
from .providers import ProviderSettings, get_provider


class TransportUnavailable(RuntimeError):
    pass


class OpenAICompatClient:
    """PolicyClient over an openai-compatible /chat/completions endpoint."""

    def __init__(self, provider: str, *, model: Optional[str] = None,
                 base_url: Optional[str] = None,
                 api_key: Optional[str] = None,
                 timeout_s: float = 120.0,
                 rate_limiter: Optional[TPMRateLimiter] = None):
        settings = get_provider(provider) or ProviderSettings(
            provider, "openai-compat")
        self.settings = settings
        self.provider = settings.name
        self.model = model or settings.default_model
        self.base_url = (base_url or settings.base_url).rstrip("/")
        if not self.base_url:
            raise ValueError(f"provider {provider} needs a base_url")
        self.api_key = api_key or (os.environ.get(settings.api_key_env)
                                   if settings.api_key_env else None)
        self.timeout_s = timeout_s
        self.limiter = rate_limiter or tpm_rate_limiter

    def chat(self, messages: List[ChatMessage], *,
             temperature: Optional[float] = None,
             max_tokens: Optional[int] = None,
             on_text=None) -> LLMResponse:
        body = {
            "model": self.model,
            "messages": [{"role": m.role if m.role != "tool" else "user",
                          "content": m.content} for m in messages],
        }
        if temperature is not None:
            body["temperature"] = temperature
        if max_tokens is not None:
            body["max_tokens"] = max_tokens
        payload = self._post("/chat/completions", body)
        choice = (payload.get("choices") or [{}])[0]
        usage = payload.get("usage") or {}
        resp = LLMResponse(
            text=(choice.get("message") or {}).get("content") or "",
            usage=LLMUsage(
                input_tokens=int(usage.get("prompt_tokens", 0)),
                output_tokens=int(usage.get("completion_tokens", 0))),
            model=payload.get("model", self.model))
        if on_text is not None and resp.text:
            on_text(resp.text)      # end-flush: no HTTP streaming here
        return resp

    def fim_complete(self, prefix: str, suffix: str = "", *,
                     max_tokens: int = 64,
                     temperature: float = 0.0) -> str:
        """Remote fill-in-the-middle completion.

        The reference exposes FIM for exactly two remote providers
        (sendLLMMessage.impl.ts): mistral via its dedicated
        ``/fim/completions`` endpoint and deepseek via the beta
        prompt+suffix ``/completions`` shape (:174). Everything else
        raises — callers fall back to pseudo-FIM chat or the local policy
        (editor/autocomplete.py).
        """
        if not self.settings.supports_fim:
            # Unregistered providers get the __init__ fallback settings
            # (supports_fim=False), so they raise here too — no silent
            # POST to an endpoint that likely doesn't exist.
            raise TransportUnavailable(
                f"provider {self.provider} does not support remote FIM")
        body = {"model": self.model, "prompt": prefix, "suffix": suffix,
                "max_tokens": max_tokens, "temperature": temperature}
        if self.provider == "mistral":
            payload = self._post("/fim/completions", body)
        elif self.provider == "deepseek" and self.base_url.endswith("/v1"):
            # deepseek serves prompt+suffix completions only under the
            # /beta base, not /v1 (the beta API of
            # sendLLMMessage.impl.ts:174)
            payload = self._post("/completions", body,
                                 base=self.base_url[:-len("v1")] + "beta")
        else:
            payload = self._post("/completions", body)
        choice = (payload.get("choices") or [{}])[0]
        # mistral replies chat-shaped, deepseek completion-shaped
        return (choice.get("text")
                or (choice.get("message") or {}).get("content") or "")

    def _post(self, path: str, body: dict,
              base: Optional[str] = None) -> dict:
        """POST with rate limiting + the reference's error taxonomy."""
        wait = self.limiter.get_wait_time(self.provider)
        if wait > 0:
            import time
            time.sleep(wait)
        req = urllib.request.Request(
            f"{base or self.base_url}{path}",
            data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json",
                     **({"Authorization": f"Bearer {self.api_key}"}
                        if self.api_key else {})},
            method="POST")
        self.limiter.record_request_start(self.provider)
        try:
            with urllib.request.urlopen(req,
                                        timeout=self.timeout_s) as resp:
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
                self.limiter.record_rate_limit_error(self.provider,
                                                     retry_after)
                raise RateLimitError(f"{self.provider}: 429 {detail}",
                                     retry_after_s=retry_after)
            if e.code == 400 and ("context" in detail.lower()
                                  or "token" in detail.lower()):
                raise ContextLengthError(f"{self.provider}: {detail}")
            raise RuntimeError(f"{self.provider}: HTTP {e.code} {detail}")
        except (urllib.error.URLError, OSError, TimeoutError) as e:
            raise TransportUnavailable(
                f"{self.provider} unreachable at {self.base_url}: {e}")
        self.limiter.record_success(self.provider)
        return payload
