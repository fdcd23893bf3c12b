"""Model capability database.

The analogue of `common/modelCapabilities.ts` (2211 LoC): a static table of
per-model capabilities — context window, reserved output space, FIM
support, reasoning/think-tag behavior — keyed by model-name substring. The
reference's table covers 20 remote providers; this build's table covers
the local policy families it trains/serves (Qwen2.5-Coder, DeepSeek-Coder)
plus the remote families rollouts may call for distillation, with the same
lookup semantics (substring match, specific-first, default fallback).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelCapabilities:
    """Schema mirror of modelCapabilities.ts:214-263."""
    context_window: int
    reserved_output_token_space: int = 4096
    supports_fim: bool = False
    fim_tokens: Optional[Tuple[str, str, str]] = None   # prefix/suffix/middle
    supports_system_message: bool = True
    reasoning_think_tags: Optional[Tuple[str, str]] = None
    max_output_tokens: int = 4096


_QWEN_FIM = ("<|fim_prefix|>", "<|fim_suffix|>", "<|fim_middle|>")
_DEEPSEEK_FIM = ("<｜fim▁begin｜>", "<｜fim▁hole｜>", "<｜fim▁end｜>")

_THINK = ("<think>", "</think>")

# Ordered: first substring match wins (specific before generic) — the
# reference's lookup discipline (modelCapabilities.ts substring families,
# specific keys above family keys). One entry per flagship family of
# every registered provider (transport/providers.py), so the 18-provider
# surface resolves real capabilities instead of the fallback.
_CAPABILITIES: Tuple[Tuple[str, ModelCapabilities], ...] = (
    # --- local policy ladder (BASELINE configs) --------------------------
    # deepseek keys sort ABOVE the qwen family: R1 qwen-distill ids
    # ("deepseek-r1-distill-qwen-7b") contain BOTH substrings and must
    # resolve the reasoning entry, not generic qwen.
    ("deepseek-coder", ModelCapabilities(
        context_window=16_384, supports_fim=True,
        fim_tokens=_DEEPSEEK_FIM)),
    ("deepseek-r1", ModelCapabilities(
        context_window=65_536, reasoning_think_tags=_THINK)),
    ("deepseek-reasoner", ModelCapabilities(
        context_window=65_536, reasoning_think_tags=_THINK,
        max_output_tokens=8192)),
    ("deepseek", ModelCapabilities(context_window=65_536,
                                   max_output_tokens=8192)),
    ("qwen2.5-coder", ModelCapabilities(
        context_window=32_768, supports_fim=True, fim_tokens=_QWEN_FIM)),
    ("qwen3", ModelCapabilities(context_window=131_072,
                                reasoning_think_tags=_THINK)),
    ("qwq", ModelCapabilities(context_window=131_072,
                              reasoning_think_tags=_THINK)),
    ("qwen", ModelCapabilities(context_window=131_072)),
    # --- mistral family --------------------------------------------------
    ("codestral", ModelCapabilities(
        context_window=262_144, supports_fim=True)),
    # Mistral-7B (the local SWA policy preset, models/config.py
    # mistral_7b): 32k context via the 4096-token sliding window. Keyed
    # on the full preset name — a bare "mistral" key would also match
    # remote API models (mistral-large: 128k) and cap them wrongly.
    ("mistral-7b", ModelCapabilities(context_window=32_768)),
    ("mixtral-8x7b", ModelCapabilities(context_window=32_768)),
    ("mistral-large", ModelCapabilities(context_window=131_072)),
    ("devstral", ModelCapabilities(context_window=131_072)),
    # --- anthropic -------------------------------------------------------
    ("claude", ModelCapabilities(context_window=200_000,
                                 reserved_output_token_space=8192,
                                 max_output_tokens=8192)),
    # --- openai ----------------------------------------------------------
    ("gpt-4o", ModelCapabilities(context_window=128_000,
                                 max_output_tokens=16_384)),
    ("gpt-4.1", ModelCapabilities(context_window=1_047_576,
                                  max_output_tokens=32_768)),
    ("gpt-4", ModelCapabilities(context_window=128_000)),
    ("o1", ModelCapabilities(context_window=200_000,
                             supports_system_message=False,
                             max_output_tokens=100_000)),
    ("o3", ModelCapabilities(context_window=200_000,
                             max_output_tokens=100_000)),
    ("o4-mini", ModelCapabilities(context_window=200_000,
                                  max_output_tokens=100_000)),
    # --- google ----------------------------------------------------------
    ("gemini", ModelCapabilities(context_window=1_048_576,
                                 max_output_tokens=8192)),
    ("gemma", ModelCapabilities(context_window=131_072)),
    # --- xai / groq / meta ----------------------------------------------
    ("grok", ModelCapabilities(context_window=131_072)),
    ("llama-3.3", ModelCapabilities(context_window=131_072)),
    ("llama-3", ModelCapabilities(context_window=131_072)),
    ("llama-4", ModelCapabilities(context_window=1_048_576)),
    ("llama", ModelCapabilities(context_window=131_072)),
    # --- moonshot / zai / alibaba ---------------------------------------
    ("kimi-k2", ModelCapabilities(context_window=131_072)),
    ("kimi", ModelCapabilities(context_window=131_072)),
    ("moonshot", ModelCapabilities(context_window=131_072)),
    ("glm-4", ModelCapabilities(context_window=131_072)),
    ("glm", ModelCapabilities(context_window=131_072)),
    # --- local test config ----------------------------------------------
    ("tiny-test", ModelCapabilities(context_window=2_048,
                                    reserved_output_token_space=256,
                                    max_output_tokens=256)),
    ("tiny-moe-test", ModelCapabilities(context_window=2_048,
                                        reserved_output_token_space=256,
                                        max_output_tokens=256)),
)

_DEFAULT = ModelCapabilities(context_window=128_000)


def get_model_capabilities(model_name: str) -> ModelCapabilities:
    lower = model_name.lower()
    for key, caps in _CAPABILITIES:
        if key in lower:
            return caps
    return _DEFAULT


def get_reserved_output_token_space(model_name: str) -> int:
    return get_model_capabilities(model_name).reserved_output_token_space
