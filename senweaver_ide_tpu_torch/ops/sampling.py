"""Token sampling: temperature, top-k, top-p.

Randomness comes from an explicit ``torch.Generator`` (the JAX version
takes a ``jax.random`` key). The two give different streams from the
same seed, so parity with the JAX package is checked greedily
(temperature 0) and by invariants otherwise.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def apply_temperature(logits: torch.Tensor,
                      temperature: float) -> torch.Tensor:
    return logits / max(temperature, 1e-6)


def apply_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Mask all but the k highest logits. A k past the vocabulary keeps
    every logit, as the JAX version's clamped sort index does."""
    if k <= 0:
        return logits
    k = min(k, logits.shape[-1])
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, NEG_INF, logits)


def apply_top_p(logits: torch.Tensor, p: float,
                cutoff: Optional[int] = None) -> torch.Tensor:
    """Nucleus mask: keep the smallest set of tokens with cumulative
    probability ≥ p.

    ``cutoff`` bounds the candidates to the top-``cutoff`` tokens
    (``torch.topk``) instead of sorting the whole vocabulary.
    Probabilities come from the full-vocab softmax, so the mask is exact
    whenever the nucleus fits inside the cutoff; a wider nucleus is
    clipped to it."""
    if cutoff is None:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        sorted_probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(sorted_probs, dim=-1)
        keep_sorted = (cum - sorted_probs) < p
        kth = torch.where(keep_sorted, sorted_logits, torch.inf).amin(
            dim=-1, keepdim=True)
        return torch.where(logits < kth, NEG_INF, logits)
    probs = torch.softmax(logits, dim=-1)
    top_probs = torch.topk(probs, min(cutoff, probs.shape[-1]),
                           dim=-1).values                 # desc-sorted
    cum = torch.cumsum(top_probs, dim=-1)
    keep = (cum - top_probs) < p
    pth = torch.where(keep, top_probs, torch.inf).amin(dim=-1, keepdim=True)
    return torch.where(probs < pth, NEG_INF, logits)


def categorical(logits: torch.Tensor,
                generator: Optional[torch.Generator]) -> torch.Tensor:
    """One draw per row from softmax(logits) by the Gumbel-max trick
    (what ``jax.random.categorical`` does), with uniforms from
    ``generator``."""
    u = torch.rand(logits.shape, generator=generator,
                   device=logits.device, dtype=torch.float32)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    gumbel = -torch.log(-torch.log(u))
    return torch.argmax(logits.float() + gumbel, dim=-1)


def sample_token(
    logits: torch.Tensor,                   # (..., vocab)
    generator: Optional[torch.Generator] = None,
    *,
    temperature: float = 1.0,
    top_k: int = 0,
    top_p: float = 1.0,
    top_p_cutoff: Optional[int] = 128,
) -> torch.Tensor:
    """Sample token ids from logits. temperature == 0 → greedy argmax
    (ties break on the first index, as ``jnp.argmax`` does).

    top_k <= 0 and top_p outside (0, 1) mean disabled. ``top_p_cutoff``
    selects the bounded-candidate nucleus path (see apply_top_p); None
    takes the exact full sort."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    x = apply_temperature(logits, temperature)
    if top_k > 0:
        x = apply_top_k(x, top_k)
    if 0.0 < top_p < 1.0:
        x = apply_top_p(x, top_p, cutoff=top_p_cutoff)
    return categorical(x, generator)


def sampled_logprob(logits: torch.Tensor,
                    token: torch.Tensor) -> torch.Tensor:
    """Model log-prob of ``token`` under the unmodified distribution:
    logits (..., V), token (...) int → (...) fp32. This is the behaviour
    log-prob GRPO's importance ratio needs, not the temperature/top-k/
    top-p-shaped sampling distribution."""
    logz = torch.log_softmax(logits.float(), dim=-1)
    return torch.gather(logz, -1, token[..., None].long())[..., 0]
