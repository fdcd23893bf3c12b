"""Plain PyTorch reference of the benchmark's decoder-only models.

A Llama / Qwen2 decoder written from the published architecture: RMSNorm
before attention and MLP, q/k/v projections (with biases for Qwen2),
rotary embeddings on the rotate-half layout, causal grouped-query
attention, a SiLU-gated MLP, a final RMSNorm and the output head (the
embedding table when tied). It runs in float32 with TF32 off, one
sequence at a time and one layer at a time, so that it fits beside the
weights; it has no cache, no batching and no kernel.

``quant="fp8"`` is the control: every matmul's weight (per output column)
and input (per row) rounded to float8 e4m3 with an absmax scale, the
precision one step below the configurations' bfloat16.

It imports nothing of the program and takes nothing the program made:
only the weights and the token ids the benchmark made.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

FP8_MAX = 448.0


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to e4m3 with one absmax scale per slice along ``dim``;
    gradients pass straight through."""
    scale = x.detach().abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    scale = scale / FP8_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32)
    return x + (q * scale - x).detach()


def _mm(x: torch.Tensor, w: torch.Tensor, quant: Optional[str]
        ) -> torch.Tensor:
    """x (S, in) @ w (in, out) in float32, or in the control's fp8."""
    if quant == "fp8":
        return _fp8(x, -1) @ _fp8(w, 0)
    if quant is not None:
        raise ValueError(f"unknown quant {quant!r}")
    return x @ w


def _rms(x, g, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * g


def _rope(x, cos, sin):
    half = x.shape[-1] // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos + rot * sin


def rope_tables(cfg, n: int, device):
    d = cfg["head_dim"]
    inv = 1.0 / (cfg["rope_theta"] ** (torch.arange(0, d, 2, device=device,
                                                     dtype=torch.float64)
                                       / d))
    ang = torch.arange(n, device=device, dtype=torch.float64)[:, None] * inv
    ang = torch.cat([ang, ang], dim=-1)
    return (ang.cos().float()[:, None, :], ang.sin().float()[:, None, :])


def _attention(q, k, v, rows: int):
    """Causal attention, q (S, Hq, D), k/v (S, Hkv, D), queries in blocks
    of ``rows`` so that the (H, rows, S) scores stay small."""
    s, hq, d = q.shape
    rep = hq // k.shape[1]
    k = k.repeat_interleave(rep, dim=1).transpose(0, 1)     # (H, S, D)
    v = v.repeat_interleave(rep, dim=1).transpose(0, 1)
    qt = q.transpose(0, 1) * d ** -0.5
    outs = []
    for a in range(0, s, rows):
        b = min(s, a + rows)
        sc = qt[:, a:b] @ k[:, :b].transpose(1, 2)          # (H, r, b)
        mask = (torch.arange(b, device=q.device)[None, :]
                > torch.arange(a, b, device=q.device)[:, None])
        sc = sc.masked_fill(mask, float("-inf"))
        outs.append(torch.softmax(sc, dim=-1) @ v[:, :b])
    return torch.cat(outs, dim=1).transpose(0, 1)            # (S, H, D)


def layer(cfg, lw: Dict[str, torch.Tensor], x, cos, sin, quant=None,
          rows: int = 1024):
    """One decoder block on x (S, D), float32 weights ``lw``."""
    s = x.shape[0]
    eps = cfg["rms_norm_eps"]
    hq, hkv, d = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                  cfg["head_dim"])
    h = _rms(x, lw["attn_norm"], eps)
    q, k, v = (_mm(h, lw["wq"], quant), _mm(h, lw["wk"], quant),
               _mm(h, lw["wv"], quant))
    if cfg["attention_bias"]:
        q, k, v = q + lw["bq"], k + lw["bk"], v + lw["bv"]
    q = _rope(q.reshape(s, hq, d), cos, sin)
    k = _rope(k.reshape(s, hkv, d), cos, sin)
    v = v.reshape(s, hkv, d)
    a = _attention(q, k, v, rows).reshape(s, hq * d)
    x = x + _mm(a, lw["wo"], quant)
    h = _rms(x, lw["mlp_norm"], eps)
    act = torch.nn.functional.silu(_mm(h, lw["w_gate"], quant)) \
        * _mm(h, lw["w_up"], quant)
    return x + _mm(act, lw["w_down"], quant)


def head_weight(params) -> torch.Tensor:
    """(D, V) output head: ``lm_head``, or the embedding table when tied."""
    return params["lm_head"] if "lm_head" in params else params["embed"].T


@torch.no_grad()
def token_logprobs(cfg, params, tokens: Sequence[int], start: int,
                   quant: Optional[str] = None, spread: bool = False):
    """log p(tokens[t] | tokens[:t]) for t in [start, len(tokens)), in
    float32, from the (bfloat16) weight tree ``params``; each layer's
    weights are upcast just before that layer runs. With ``spread`` also
    each position's entropy and the variance of log p under p, as
    ``(logp, entropy, variance)``."""
    dev = params["embed"].device
    n = len(tokens)
    ids = torch.tensor(list(tokens), dtype=torch.long, device=dev)
    x = params["embed"][ids].float()
    cos, sin = rope_tables(cfg, n, dev)
    lay = params["layers"]
    for i in range(cfg["num_hidden_layers"]):
        lw = {name: t[i].float() for name, t in lay.items()}
        x = layer(cfg, lw, x, cos, sin, quant)
        del lw
    h = _rms(x[start - 1:n - 1], params["final_norm"].float(),
             cfg["rms_norm_eps"])
    logits = _mm(h, head_weight(params).float(), quant)
    logp = torch.log_softmax(logits, dim=-1)
    tok = logp.gather(1, ids[start:, None])[:, 0]
    if not spread:
        return tok
    p = logp.exp()
    ent = -(p * logp).sum(-1)
    var = (p * logp * logp).sum(-1) - ent * ent
    return tok, ent, var
