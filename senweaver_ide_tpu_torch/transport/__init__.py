"""LLM transport: provider registry + openai-compatible HTTP client.

The TPU-build analogue of L1/L2 (SURVEY.md §2.3): the local TPU sampler
is the primary provider; the registry keeps the reference's 20-provider
surface for distillation/eval rollouts, consolidated onto one
openai-compatible client the way sendLLMMessage.impl.ts consolidates 18
providers onto _sendOpenAICompatibleChat.
"""

from .http_client import OpenAICompatClient, TransportUnavailable
from .native_clients import (AnthropicMessagesClient, GeminiClient,
                             make_client)
from .providers import (PROVIDERS, ProviderSettings, get_provider,
                        resolve_model)

__all__ = ["OpenAICompatClient", "TransportUnavailable",
           "AnthropicMessagesClient", "GeminiClient", "make_client",
           "PROVIDERS", "ProviderSettings", "get_provider", "resolve_model"]
