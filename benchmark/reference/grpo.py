"""Plain PyTorch reference of the GRPO update the training cell times.

On-policy GRPO (the behaviour log-probs are the current policy's, so the
importance ratio is 1 and the clip never binds): advantages are the
rewards centred and scaled by the population standard deviation within
each prompt's group (floored at 1e-4), the loss is minus the advantage-
weighted sum of the completion tokens' log-probabilities over the
batch's completion tokens (its value at ratio 1 is minus the token-
weighted mean advantage), and the update is AdamW after clipping the
gradients' global norm. Gradients are computed in float32 with TF32 off,
one sequence at a time. The parameters and both moments are stored in
the configuration's dtype (bfloat16) between steps, as the configuration
states; the arithmetic of each update is float32.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from ..weights import leaves
from .model import _mm, _rms, head_weight, layer, rope_tables


def advantages(rewards: Sequence[float], groups: Sequence[int],
               min_std: float = 1e-4) -> List[float]:
    by: Dict[int, List[float]] = {}
    for r, g in zip(rewards, groups):
        by.setdefault(g, []).append(float(r))
    stats = {}
    for g, rs in by.items():
        m = sum(rs) / len(rs)
        sd = (sum((r - m) ** 2 for r in rs) / len(rs)) ** 0.5
        stats[g] = (m, max(sd, min_std))
    return [(float(r) - stats[g][0]) / stats[g][1]
            for r, g in zip(rewards, groups)]


def _tree(flat: Dict[str, torch.Tensor]):
    out: Dict[str, object] = {}
    for name, t in flat.items():
        if "/" in name:
            a, b = name.split("/", 1)
            out.setdefault(a, {})[b] = t
        else:
            out[name] = t
    return out


def _seq_loss(cfg, p, tokens: Sequence[int], prompt_len: int, weight: float,
              quant: Optional[str]) -> torch.Tensor:
    """``weight`` times the sum of the completion tokens' log-probs."""
    dev = p["embed"].device
    n = len(tokens)
    ids = torch.tensor(list(tokens), dtype=torch.long, device=dev)
    x = p["embed"][ids]
    cos, sin = rope_tables(cfg, n, dev)
    for i in range(cfg["num_hidden_layers"]):
        lw = {name: per_layer[i] for name, per_layer in p["layers"].items()}
        x = layer(cfg, lw, x, cos, sin, quant, rows=n)
    h = _rms(x[prompt_len - 1:n - 1], p["final_norm"], cfg["rms_norm_eps"])
    logp = torch.log_softmax(_mm(h, head_weight(p), quant), dim=-1)
    return weight * logp.gather(1, ids[prompt_len:, None]).sum()


def train(cfg, params, batches, opt: dict, quant: Optional[str] = None):
    """Follow the program's first ``len(batches)`` updates from the weight
    tree ``params`` (bfloat16; not modified). Each batch is a list of
    ``(tokens, prompt_len, reward, group_id)``. Returns each step's loss,
    each leaf's norm of the first step's clipped gradient, and each
    leaf's norm of its change over all the steps."""
    stored = {k: t.detach().clone() for k, t in leaves(params).items()}
    start = {k: t.clone() for k, t in stored.items()}
    mu = {k: torch.zeros_like(t) for k, t in stored.items()}
    nu = {k: torch.zeros_like(t) for k, t in stored.items()}
    b1, b2, eps, lr = opt["b1"], opt["b2"], opt["eps"], opt["learning_rate"]
    losses, g1 = [], {}
    for step, batch in enumerate(batches, start=1):
        # one float32 leaf per layer, so each layer's gradient lands in a
        # tensor of its own
        live = {k: [u.float().requires_grad_() for u in t]
                if k.startswith("layers/") else t.float().requires_grad_()
                for k, t in stored.items()}
        tree = _tree(live)
        adv = advantages([b[2] for b in batch], [b[3] for b in batch])
        denom = sum(len(b[0]) - b[1] for b in batch)
        for (tokens, plen, _r, _g), a in zip(batch, adv):
            _seq_loss(cfg, tree, tokens, plen, -a / denom, quant).backward()
        # the clipped surrogate's value at ratio 1
        losses.append(-sum(a * (len(b[0]) - b[1])
                           for b, a in zip(batch, adv)) / denom)
        with torch.no_grad():
            grads = {k: torch.stack([u.grad for u in t])
                     if isinstance(t, list) else t.grad
                     for k, t in live.items()}
            norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
            clip = float(opt["max_grad_norm"])
            scale = 1.0 if float(norm) < clip else clip / float(norm)
            for k, g in grads.items():
                g = g * scale
                if step == 1:
                    g1[k] = float(g.norm())
                m = b1 * mu[k].float() + (1 - b1) * g
                v = b2 * nu[k].float() + (1 - b2) * g * g
                mu[k], nu[k] = m.to(mu[k].dtype), v.to(nu[k].dtype)
                u = (m / (1 - b1 ** step)) / (
                    torch.sqrt(v / (1 - b2 ** step)) + eps)
                stored[k] = (stored[k].float() - lr * u).to(stored[k].dtype)
        del live, tree, grads
    change = {k: float((stored[k].float() - start[k].float()).norm())
              for k in stored}
    return {"loss": losses, "grad_norm": g1, "change_norm": change}
