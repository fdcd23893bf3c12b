"""GRPO training-health diagnostics on the device (PyTorch port).

The counterpart of the JAX package's ``training/diagnostics.py``: the
same statistics under the same names, per round, on the device that
holds the batch:

- **advantage rank spectrum** — singular values of the group-by-position
  advantage matrix ``M[g, s] = mean over group g of adv_b * mask[b, s]``;
  reported as effective rank ``exp(H(sigma/sum sigma))``, its fraction of
  the attainable rank, and the participation ratio
  ``(sum s^2)^2 / sum s^4``;
- **per-token credit entropy** — normalized entropy of the |per-token
  advantage| mass over the response mask (1 = credit spread evenly,
  0 = all credit on one token);
- **zero/degenerate-group fraction** — groups whose finite rewards all
  tie (no learning signal), counted over groups actually PRESENT in the
  batch (group ids are task indices and survive group drops
  non-contiguously);
- **NaN safety** — non-finite rewards are excluded from every statistic
  and surfaced as ``nonfinite_reward_fraction``.

``jax.ops.segment_sum`` becomes ``index_add_`` and ``segment_max``
becomes ``scatter_reduce(reduce="amax", include_self=False)`` over a
zero start, with empty segments counted as absent as the JAX head does;
the spectrum is ``torch.linalg.svdvals``.

Host-sync contract: :func:`dispatch_round_health` only LAUNCHES the
work on ``device`` and returns device tensors (it overlaps with batch
placement); :func:`finalize_round_health` performs the round's single
device→host copy of the whole stats dict.

Gradient sparsity and the policy-entropy / KL-to-anchor drift signals
ride in the train step's own metrics (training/grpo.py
``grad_sparsity``; ``entropy`` / ``kl``) — ``rl_loop`` merges them into
the same health dict after the update, so the telemetry consumer
(obs/training_health.py) sees one flat record per round.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from ..device import resolve_device
from .grpo import GRPOConfig


class DiagnosticsConfig(NamedTuple):
    """Knobs of the head. Mirror of the advantage transform actually fed
    to the loss, so the spectrum the detectors see is the spectrum the
    optimizer sees."""

    normalize_std: bool = True
    min_group_std: float = 1e-4
    leave_one_out: bool = False
    # A group is "zero-advantage" when its centered rewards all fall
    # within this RELATIVE tolerance of zero (scaled by 1 + |group
    # mean|, so reward magnitude doesn't change what counts as a tie).
    zero_adv_rtol: float = 1e-8

    @classmethod
    def from_grpo(cls, config: GRPOConfig) -> "DiagnosticsConfig":
        return cls(normalize_std=config.normalize_std,
                   min_group_std=config.min_group_std,
                   leave_one_out=config.leave_one_out)


def _segment_sum(x: torch.Tensor, ids: torch.Tensor,
                 n: int) -> torch.Tensor:
    out = torch.zeros((n,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    return out.index_add_(0, ids, x)


@torch.no_grad()
def _diagnostics_head(rewards: torch.Tensor, group_ids: torch.Tensor,
                      mask: torch.Tensor, num_groups: int,
                      config: DiagnosticsConfig) -> Dict[str, torch.Tensor]:
    """NaN-safe advantage stats + rank spectrum + credit entropy, as f32
    0-d tensors on the inputs' device (no host sync)."""
    eps = 1e-30
    rewards = rewards.float()
    finite = torch.isfinite(rewards)
    fin = finite.float()
    r = torch.where(finite, rewards, torch.zeros_like(rewards))
    n = max(float(rewards.shape[0]), 1.0)
    # the summed 0/1 indicator keeps the fraction exactly 0.0 on clean
    # batches
    nonfinite_fraction = (1.0 - fin).sum() / n

    counts_all = _segment_sum(torch.ones_like(r), group_ids, num_groups)
    counts_fin = _segment_sum(fin, group_ids, num_groups)
    present = counts_all > 0.0
    n_present = torch.clamp_min(present.float().sum(), 1.0)

    sums = _segment_sum(r * fin, group_ids, num_groups)
    means = sums / torch.clamp_min(counts_fin, 1.0)
    centered = (r - means[group_ids]) * fin

    # Zero-advantage groups: every FINITE member ties (relative tol).
    absmax = torch.zeros(num_groups, dtype=torch.float32,
                         device=r.device).scatter_reduce(
        0, group_ids, centered.abs(), reduce="amax", include_self=False)
    absmax = torch.where(present, absmax, torch.zeros_like(absmax))
    tie_tol = config.zero_adv_rtol * (1.0 + means.abs())
    zero_group = present & (absmax <= tie_tol)
    zero_group_fraction = zero_group.float().sum() / n_present

    # The advantages actually fed to the loss (same transform chain as
    # training/grpo.py group_relative_advantages, over finite members).
    if config.leave_one_out:
        factor = counts_fin / torch.clamp_min(counts_fin - 1.0, 1.0)
        adv = centered * factor[group_ids]
    elif config.normalize_std:
        sq = _segment_sum(centered * centered, group_ids, num_groups)
        std = torch.sqrt(sq / torch.clamp_min(counts_fin, 1.0))
        adv = centered / torch.clamp_min(std[group_ids],
                                         config.min_group_std)
    else:
        adv = centered
    n_fin = torch.clamp_min(fin.sum(), 1.0)
    adv_mean = adv.sum() / n_fin
    adv_std = torch.sqrt((fin * (adv - adv_mean) ** 2).sum() / n_fin)

    # Group-by-position advantage matrix -> singular spectrum.
    m = mask.float()
    tok_adv = adv[:, None] * m                                   # (B, S)
    gsum = _segment_sum(tok_adv, group_ids, num_groups)          # (G, S)
    mat = gsum / torch.clamp_min(counts_all, 1.0)[:, None]
    sv = torch.linalg.svdvals(mat)
    ssum = sv.sum()
    p = sv / torch.clamp_min(ssum, eps)
    spec_entropy = -(p * torch.log(torch.clamp_min(p, eps))).sum()
    one = torch.ones((), dtype=torch.float32, device=r.device)
    # An all-zero matrix (no advantage signal at all) is maximally
    # collapsed: pin it to the 1-direction floor rather than NaN.
    effective_rank = torch.where(ssum > eps, torch.exp(spec_entropy), one)
    sv2 = (sv * sv).sum()
    participation = torch.where(
        sv2 > eps, (sv2 * sv2) / torch.clamp_min((sv ** 4).sum(), eps), one)
    # Attainable rank: present groups x positions any trajectory masks.
    s_active = torch.clamp_min((m > 0.0).any(dim=0).float().sum(), 1.0)
    rank_fraction = effective_rank / torch.clamp_min(
        torch.minimum(n_present, s_active), 1.0)

    # Credit entropy: where does |advantage| mass sit across the batch's
    # masked tokens? Normalized by log(n_masked) to [0, 1].
    w = tok_adv.abs()
    wsum = w.sum()
    pw = w / torch.clamp_min(wsum, eps)
    credit_h = -(pw * torch.log(torch.clamp_min(pw, eps))).sum()
    n_masked = m.sum()
    credit_entropy = torch.where(
        (wsum > eps) & (n_masked > 1.0),
        credit_h / torch.log(torch.clamp_min(n_masked, 2.0)),
        torch.zeros_like(one))

    return {
        "nonfinite_reward_fraction": nonfinite_fraction,
        "zero_advantage_group_fraction": zero_group_fraction,
        "groups_present": n_present,
        "advantage_mean": adv_mean,
        "advantage_std": adv_std,
        "effective_rank": effective_rank,
        "rank_fraction": rank_fraction,
        "participation_ratio": participation,
        "top_singular_value": sv.max(),
        "credit_entropy": credit_entropy,
    }


def _to(x, device, dtype) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(np.asarray(x)))
    return t.to(device=device, dtype=dtype)


def dispatch_round_health(rewards, group_ids, mask, *,
                          num_groups: Optional[int] = None,
                          config: DiagnosticsConfig = DiagnosticsConfig(),
                          device="cuda") -> Dict[str, torch.Tensor]:
    """Launch the head on ``device`` over host (numpy) or tensor batch
    arrays; returns the dict of device tensors — hand it to
    :func:`finalize_round_health` for the round's single sync. Group ids
    must be dense codes ``0 .. num_groups - 1`` (``np.unique``'s
    inverse)."""
    dev = resolve_device(device)
    g = _to(group_ids, "cpu", torch.int64) if not isinstance(
        group_ids, torch.Tensor) else group_ids.long()
    if num_groups is None:
        num_groups = int(g.max()) + 1 if g.numel() else 1
    return _diagnostics_head(
        _to(rewards, dev, torch.float32), g.to(dev),
        _to(mask, dev, torch.bool), num_groups=int(num_groups),
        config=config)


def finalize_round_health(device_stats: Dict[str, torch.Tensor]
                          ) -> Dict[str, float]:
    """The round's ONE device→host sync: stack the whole stats dict and
    copy it in one transfer; returns plain floats."""
    keys = list(device_stats)
    if not keys:
        return {}
    host = torch.stack([device_stats[k].float().reshape(())
                        for k in keys]).cpu().tolist()
    return dict(zip(keys, (float(v) for v in host)))


def advantage_stats(rewards, group_ids, *,
                    device="cuda") -> Dict[str, float]:
    """NaN-safe GRPO advantage diagnostics from host reward/group
    arrays — the implementation behind ``obs.advantage_stats`` (same
    three historical keys, plus the non-finite fraction), computed on
    ``device``.

    Group ids may be arbitrary ints (non-contiguous after group drops);
    they are densified before the head runs. ``advantage_std`` is the
    spread of the plain centered advantages."""
    r = np.asarray(rewards, dtype=np.float64).reshape(-1)
    g = np.asarray(group_ids).reshape(-1)
    if r.size == 0 or g.size != r.size:
        return {"zero_advantage_group_fraction": 0.0,
                "advantage_std": 0.0, "groups": 0,
                "nonfinite_reward_fraction": 0.0}
    uniq, codes = np.unique(g, return_inverse=True)
    out = finalize_round_health(dispatch_round_health(
        r, codes, np.ones((r.size, 1), dtype=bool),
        num_groups=len(uniq),
        config=DiagnosticsConfig(normalize_std=False), device=device))
    return {
        "zero_advantage_group_fraction":
            out["zero_advantage_group_fraction"],
        "advantage_std": out["advantage_std"],
        "groups": int(len(uniq)),
        "nonfinite_reward_fraction": out["nonfinite_reward_fraction"],
    }
