"""GRPO: group-relative policy optimization (PyTorch port).

The JAX package's ``training/grpo.py`` function for function: group-
relative advantages over response groups per prompt (no critic), optional
leave-one-out baseline, per-token gamma-decay and branch-point credit,
and the PPO-style clipped token-level objective with the k3 KL penalty
and the sampled-surprisal entropy bonus. ``jax.ops.segment_sum`` becomes
``index_add_``; the metric names are unchanged.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class GRPOConfig(NamedTuple):
    clip_eps: float = 0.2
    kl_coef: float = 0.04        # KL penalty vs the reference (frozen) policy
    entropy_coef: float = 0.0
    normalize_std: bool = True
    min_group_std: float = 1e-4
    moe_aux_coef: float = 0.01   # MoE load-balance weight (num_experts > 0)
    # RLOO leave-one-out baseline (returned unnormalized).
    leave_one_out: bool = False
    # Per-token gamma-decay credit toward the reward, mean 1 per sequence.
    token_level_advantages: bool = False
    token_adv_gamma: float = 0.98
    # Credit boost (1 + boost) at recorded tree branch points, mean 1.
    branch_credit_boost: float = 0.0


def _segment_sum(x: torch.Tensor, ids: torch.Tensor,
                 n: int) -> torch.Tensor:
    return torch.zeros(n, dtype=x.dtype, device=x.device).index_add_(
        0, ids, x)


def group_relative_advantages(
    rewards: torch.Tensor,       # (B,) finalReward per trajectory
    group_ids: torch.Tensor,     # (B,) int — same id = same prompt
    num_groups: int,
    *,
    normalize_std: bool = True,
    min_std: float = 1e-4,
    leave_one_out: bool = False,
) -> torch.Tensor:
    """Center (and optionally scale) rewards within each prompt group.
    ``leave_one_out=True`` is the RLOO baseline ``(n/(n-1)) * (r_i -
    mean)``, returned unnormalized."""
    ids = group_ids.long()
    rewards = rewards.float()
    counts = _segment_sum(torch.ones_like(rewards), ids, num_groups)
    counts = torch.clamp_min(counts, 1.0)
    means = _segment_sum(rewards, ids, num_groups) / counts
    centered = rewards - means[ids]
    if leave_one_out:
        factor = counts / torch.clamp_min(counts - 1.0, 1.0)
        return centered * factor[ids]
    if not normalize_std:
        return centered
    sq = _segment_sum(centered * centered, ids, num_groups)
    std = torch.sqrt(sq / counts)
    return centered / torch.clamp_min(std[ids], min_std)


def token_credit_weights(mask: torch.Tensor, gamma: float) -> torch.Tensor:
    """(B, S) gamma-decay credit from the last masked token backward,
    normalized to mean 1 over each row's masked tokens (zeros for rows
    without masked tokens; ``gamma=1`` returns the mask)."""
    m = mask.float()
    n_tok = m.sum(dim=-1, keepdim=True)
    pos = torch.cumsum(m, dim=-1) - 1.0
    w = torch.pow(torch.tensor(gamma, dtype=torch.float32, device=m.device),
                  torch.clamp_min(n_tok - 1.0 - pos, 0.0)) * m
    norm = w.sum(dim=-1, keepdim=True)
    return w * n_tok / torch.clamp_min(norm, 1e-30)


def branch_credit_weights(mask: torch.Tensor, branch_mask: torch.Tensor, *,
                          gamma: float, boost: float) -> torch.Tensor:
    """:func:`token_credit_weights` with tokens at recorded branch
    positions scaled by ``1 + boost``, renormalized to mean 1."""
    base = token_credit_weights(mask, gamma)
    m = mask.float()
    b = branch_mask.float() * m
    w = base * (1.0 + boost * b)
    n_tok = m.sum(dim=-1, keepdim=True)
    norm = w.sum(dim=-1, keepdim=True)
    return w * n_tok / torch.clamp_min(norm, 1e-30)


def token_logprobs(logits: torch.Tensor,
                   targets: torch.Tensor) -> torch.Tensor:
    """(B, S, V) fp32 logits + (B, S) targets → (B, S) log p(target)."""
    logz = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    return tgt - logz


def grpo_objective(
    logp: torch.Tensor,          # (B, S) current-policy completion logprobs
    old_logp: torch.Tensor,      # (B, S) behavior-policy logprobs
    advantages: torch.Tensor,    # (B,) per-trajectory, or (B, S) per-token
    mask: torch.Tensor,          # (B, S) True on completion tokens
    config: GRPOConfig = GRPOConfig(),
    ref_logp: Optional[torch.Tensor] = None,   # (B, S) frozen reference
    branch_mask: Optional[torch.Tensor] = None,  # (B, S) 1 at branch points
) -> tuple:
    """Clipped surrogate + KL penalty − entropy bonus. Returns (loss,
    metrics dict of 0-d tensors), with the JAX metric names."""
    mask = mask.float()
    denom = torch.clamp_min(mask.sum(), 1.0)
    if advantages.ndim == 2:
        adv = advantages
    else:
        adv = advantages[:, None]
        if branch_mask is not None and config.branch_credit_boost > 0.0:
            adv = adv * branch_credit_weights(
                mask, branch_mask,
                gamma=(config.token_adv_gamma
                       if config.token_level_advantages else 1.0),
                boost=config.branch_credit_boost)
        elif config.token_level_advantages:
            adv = adv * token_credit_weights(mask, config.token_adv_gamma)

    ratio = torch.exp(logp - old_logp)
    unclipped = ratio * adv
    clipped = torch.clamp(ratio, 1.0 - config.clip_eps,
                          1.0 + config.clip_eps) * adv
    pg_loss = -(torch.minimum(unclipped, clipped) * mask).sum() / denom

    kl = torch.zeros((), dtype=torch.float32, device=logp.device)
    if ref_logp is not None and config.kl_coef > 0.0:
        # k3 estimator (Schulman): unbiased, positive
        log_ratio = ref_logp - logp
        kl = ((torch.exp(log_ratio) - log_ratio - 1.0) * mask).sum() / denom

    # sampled-surprisal entropy estimate E[-log p(x)]
    entropy = -(logp * mask).sum() / denom
    loss = (pg_loss + config.kl_coef * kl - config.entropy_coef * entropy)

    # share of examples whose closed-form surrogate gradient is ~0
    clip_active = torch.where(adv >= 0.0, ratio <= 1.0 + config.clip_eps,
                              ratio >= 1.0 - config.clip_eps)
    g_tok = ratio * adv * clip_active.float() * mask
    tok_counts = mask.sum(dim=-1)
    ex_norm = torch.sqrt((g_tok * g_tok).sum(dim=-1)
                         / torch.clamp_min(tok_counts, 1.0))
    has_tok = (tok_counts > 0.0).float()
    near_zero = (ex_norm < 1e-6).float() * has_tok
    grad_sparsity = near_zero.sum() / torch.clamp_min(has_tok.sum(), 1.0)

    metrics = {
        "pg_loss": pg_loss,
        "kl": kl,
        "entropy": entropy,
        "ratio_mean": (ratio * mask).sum() / denom,
        "clip_frac": (((ratio - 1.0).abs() > config.clip_eps) * mask).sum()
        / denom,
        "grad_sparsity": grad_sparsity,
    }
    if branch_mask is not None:
        metrics["branch_token_frac"] = (branch_mask.float() * mask).sum() \
            / denom
    return loss, metrics
