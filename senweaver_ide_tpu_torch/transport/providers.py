"""Provider registry: remote LLM endpoints the rollout layer can drive.

Mirrors `electron-main/llmMessage/sendLLMMessage.impl.ts` (:927
sendLLMMessageToProviderImplementation, 20 providers) and
`common/modelCapabilities.ts:17-90` (defaultProviderSettings): each
provider is an endpoint style + base URL + capability flags. In this
framework the LOCAL policy is the primary provider (rollouts and
training); remote providers exist for distillation/eval rollouts and
keep the reference's full registry shape. All remote calls go through
``transport.http_client.OpenAICompatClient`` (every provider below except
the local engine speaks the openai-compatible chat schema, exactly the
reference's `_sendOpenAICompatibleChat` consolidation :338).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ProviderSettings:
    name: str
    # 'local' | 'openai-compat' | 'anthropic' | 'gemini'
    endpoint_style: str
    base_url: str = ""
    api_key_env: str = ""          # env var carrying the key
    supports_fim: bool = False
    supports_system_message: bool = True
    default_model: str = ""


PROVIDERS: Dict[str, ProviderSettings] = {p.name: p for p in [
    # The primary provider: the in-tree TPU sampler.
    ProviderSettings("local", "local",
                     default_model="qwen2.5-coder-1.5b"),
    ProviderSettings("anthropic", "anthropic",
                     base_url="https://api.anthropic.com",
                     api_key_env="ANTHROPIC_API_KEY",
                     default_model="claude-3-5-sonnet"),
    ProviderSettings("openai", "openai-compat",
                     base_url="https://api.openai.com/v1",
                     api_key_env="OPENAI_API_KEY",
                     default_model="gpt-4o"),
    ProviderSettings("gemini", "gemini",
                     base_url="https://generativelanguage.googleapis.com",
                     api_key_env="GEMINI_API_KEY",
                     default_model="gemini-2.0-flash"),
    ProviderSettings("deepseek", "openai-compat",
                     base_url="https://api.deepseek.com/v1",
                     api_key_env="DEEPSEEK_API_KEY", supports_fim=True,
                     default_model="deepseek-chat"),
    ProviderSettings("mistral", "openai-compat",
                     base_url="https://api.mistral.ai/v1",
                     api_key_env="MISTRAL_API_KEY", supports_fim=True,
                     default_model="codestral-latest"),
    ProviderSettings("xai", "openai-compat",
                     base_url="https://api.x.ai/v1",
                     api_key_env="XAI_API_KEY", default_model="grok-2"),
    ProviderSettings("groq", "openai-compat",
                     base_url="https://api.groq.com/openai/v1",
                     api_key_env="GROQ_API_KEY",
                     default_model="llama-3.3-70b"),
    ProviderSettings("openrouter", "openai-compat",
                     base_url="https://openrouter.ai/api/v1",
                     api_key_env="OPENROUTER_API_KEY"),
    ProviderSettings("ollama", "openai-compat",
                     base_url="http://localhost:11434/v1",
                     default_model="qwen2.5-coder"),
    ProviderSettings("vllm", "openai-compat",
                     base_url="http://localhost:8000/v1"),
    ProviderSettings("lmstudio", "openai-compat",
                     base_url="http://localhost:1234/v1"),
    ProviderSettings("litellm", "openai-compat",
                     base_url="http://localhost:4000"),
    ProviderSettings("moonshot", "openai-compat",
                     base_url="https://api.moonshot.cn/v1",
                     api_key_env="MOONSHOT_API_KEY"),
    ProviderSettings("zai", "openai-compat",
                     base_url="https://open.bigmodel.cn/api/paas/v4",
                     api_key_env="ZAI_API_KEY"),
    ProviderSettings("alibailian", "openai-compat",
                     base_url="https://dashscope.aliyuncs.com"
                              "/compatible-mode/v1",
                     api_key_env="DASHSCOPE_API_KEY"),
    ProviderSettings("openai-compatible", "openai-compat"),
    ProviderSettings("own-provider", "openai-compat",
                     base_url="https://api.newpoc.com/v1",
                     api_key_env="SENWEAVER_API_KEY"),
]}


def get_provider(name: str) -> Optional[ProviderSettings]:
    return PROVIDERS.get(name)


def resolve_model(provider: str,
                  model: Optional[str] = None) -> Tuple[str, str]:
    """(provider, model) with registry defaults applied."""
    p = PROVIDERS.get(provider) or PROVIDERS["local"]
    return p.name, model or p.default_model
