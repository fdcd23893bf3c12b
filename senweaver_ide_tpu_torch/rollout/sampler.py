"""Prefill + KV-cache autoregressive decode over the contiguous cache.

Two decode loops share one decode step:

- :func:`generate` — host loop with per-sequence early stop and a
  streaming callback (the agent loop's path).
- :func:`generate_scan` — a fixed-shape loop with no host round trip per
  token (the benchmark and batch-rollout path): eos overwrites later
  tokens instead of stopping the loop.

Randomness comes from a ``torch.Generator`` where the JAX version takes a
key, so sampled streams differ between the two; greedy decoding
(temperature 0) is identical. The cache's tensors are updated in place
(``models/transformer.py::forward``); every function returns the cache
to use next.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from ..models.config import ModelConfig
from ..models.transformer import KVCache, Params, forward, init_kv_cache
from ..ops.sampling import sample_token


class SampleParams(NamedTuple):
    temperature: float = 0.8
    top_k: int = 0
    top_p: float = 0.95


def _sample(logits: torch.Tensor, generator, sample: SampleParams):
    return sample_token(logits, generator, temperature=sample.temperature,
                        top_k=sample.top_k, top_p=sample.top_p)


@torch.no_grad()
def prefill(params: Params, config: ModelConfig, tokens: torch.Tensor,
            cache: KVCache, *,
            fresh_cache: bool = False,
            mesh=None) -> Tuple[torch.Tensor, KVCache]:
    """Run ``tokens`` (B, S) through the model into ``cache``; returns
    (last-token logits (B, V), cache). ``fresh_cache`` promises the cache
    holds nothing yet, so a ring-cache chunk skips the empty cache
    half. ``mesh``: the tensor-parallel cache forward
    (``models.transformer.forward``)."""
    return forward(params, config, tokens, cache=cache,
                   fresh_cache=fresh_cache, mesh=mesh,
                   logits_at=tokens.shape[1] - 1)


def prefill_chunked(params: Params, config: ModelConfig,
                    prompt: torch.Tensor,
                    cache: KVCache) -> Tuple[torch.Tensor, KVCache]:
    """Prefill a prompt of any length into a FRESH cache. A ring
    (sliding-window) cache bounds a chunk by its capacity, so a longer
    prompt streams through in capacity-sized chunks: mistral-7b takes a
    32k prompt while holding 4096 KV slots."""
    cap = cache.k.shape[2]
    s = prompt.shape[1]
    if s <= cap:
        return prefill(params, config, prompt, cache, fresh_cache=True)
    logits = None
    for lo in range(0, s, cap):
        logits, cache = prefill(params, config, prompt[:, lo:lo + cap],
                                cache, fresh_cache=(lo == 0))
    return logits, cache


@torch.no_grad()
def decode_step(params: Params, config: ModelConfig, token: torch.Tensor,
                cache: KVCache, generator: Optional[torch.Generator],
                sample: SampleParams
                ) -> Tuple[torch.Tensor, torch.Tensor, KVCache]:
    """One decode step. token: (B, 1). Returns (next_token (B,), logits
    (B, V), cache)."""
    logits, cache = forward(params, config, token, cache=cache)
    logits = logits[:, -1, :]
    return _sample(logits, generator, sample), logits, cache


def _device_of(params: Params) -> torch.device:
    return params["embed"].device


def generate(
    params: Params,
    config: ModelConfig,
    prompt: torch.Tensor,                 # (B, S) int
    *,
    max_new_tokens: int = 128,
    eos_id: Optional[int] = None,
    sample: SampleParams = SampleParams(),
    generator: Optional[torch.Generator] = None,
    max_len: Optional[int] = None,
    on_token: Optional[Callable[[int, torch.Tensor], None]] = None,
) -> torch.Tensor:
    """Host-driven generation with early stop. Returns (B, ≤max_new_tokens)
    token ids on the params' device. Rows that hit ``eos_id`` repeat it
    until every row has; the loop stops then (one host check a step)."""
    dev = _device_of(params)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    prompt = prompt.to(dev)
    b, s = prompt.shape
    max_len = max_len or min(config.max_seq_len, s + max_new_tokens)
    cache = init_kv_cache(config, b, max_len, device=dev)
    logits, cache = prefill_chunked(params, config, prompt, cache)
    tok = _sample(logits, generator, sample)
    out = [tok]
    done = (tok == eos_id) if eos_id is not None else torch.zeros(
        b, dtype=torch.bool, device=dev)
    for i in range(1, max_new_tokens):
        if bool(done.all()):
            break
        tok, _, cache = decode_step(params, config, tok[:, None], cache,
                                    generator, sample)
        if eos_id is not None:
            tok = torch.where(done, eos_id, tok)
            done = done | (tok == eos_id)
        out.append(tok)
        if on_token is not None:
            on_token(i, tok)
    return torch.stack(out, dim=1)


def generate_scan(
    params: Params,
    config: ModelConfig,
    prompt: torch.Tensor,
    cache: KVCache,
    generator: Optional[torch.Generator] = None,
    *,
    max_new_tokens: int = 128,
    sample: SampleParams = SampleParams(),
    eos_id: int = -1,
) -> Tuple[torch.Tensor, KVCache]:
    """Prefill + exactly ``max_new_tokens - 1`` decode steps, with no host
    round trip per token. ``cache`` must be freshly initialised (nothing
    prefilled). Shapes stay fixed: once a row samples ``eos_id`` every
    later token of that row is ``eos_id`` (``torch.where``, never a host
    check). A ring cache prefills a prompt longer than its capacity in
    capacity-sized chunks. Returns ((B, max_new_tokens) tokens, cache)."""
    dev = cache.k.device
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    prompt = prompt.to(dev)
    logits, cache = prefill_chunked(params, config, prompt, cache)
    tok = _sample(logits, generator, sample)
    done = tok == eos_id
    toks = [tok]
    for _ in range(max_new_tokens - 1):
        tok, _, cache = decode_step(params, config, tok[:, None], cache,
                                    generator, sample)
        tok = torch.where(done, eos_id, tok)
        done = done | (tok == eos_id)
        toks.append(tok)
    return torch.stack(toks, dim=1), cache
