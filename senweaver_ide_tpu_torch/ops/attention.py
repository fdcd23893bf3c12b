"""Attention ops: GQA causal attention with fp32 softmax.

The plain reference the port holds its kernels against: the no-cache
forward uses it directly, and the paged path's plain branch
(``ops/paged_attention.py::paged_flash_decode_plain``) gathers the block
pool into contiguous sequences and calls it.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30  # large-but-finite: -inf breaks softmax rows that are fully masked
MASKED_THRESHOLD = NEG_INF * 0.5  # scores at/below this count as fully masked


def causal_mask(q_len: int, kv_len: int, q_offset,
                window: Optional[int] = None,
                device=None) -> torch.Tensor:
    """Boolean mask, True = attend. ``q_offset`` is the absolute position
    of the first query: a scalar giving a (q_len, kv_len) mask, or a (B,)
    tensor of per-row offsets giving (B, q_len, kv_len). ``window`` bounds
    each query to its trailing ``window`` positions: kv ∈ (q - window, q]."""
    if isinstance(q_offset, torch.Tensor):
        device = q_offset.device
    q_offset = torch.as_tensor(q_offset, device=device)
    q_idx = torch.arange(q_len, device=device)
    k_idx = torch.arange(kv_len, device=device)
    if q_offset.ndim == 1:
        q_pos = q_offset[:, None, None] + q_idx[None, :, None]
        k_pos = k_idx[None, None, :]
    else:
        q_pos = q_offset + q_idx[:, None]
        k_pos = k_idx[None, :]
    mask = k_pos <= q_pos
    if window is not None:
        mask = mask & (k_pos > q_pos - window)
    return mask


def attention(
    q: torch.Tensor,            # (B, Sq, Hq, D)
    k: torch.Tensor,            # (B, Skv, Hkv, D)
    v: torch.Tensor,            # (B, Skv, Hkv, D)
    *,
    q_offset=0,
    kv_mask: Optional[torch.Tensor] = None,   # (B, Skv) or (B, Sq, Skv),
                                              # True = valid
    causal: bool = True,
    window: Optional[int] = None,             # sliding-window width
) -> torch.Tensor:
    """Grouped-query causal attention. Returns (B, Sq, Hq, D).

    The GQA group folds into the products (q reshaped to (Hkv, rep)): K/V
    are never repeated to Hq heads. Scores and softmax are fp32. fp32
    inputs stay fp32 throughout; low-precision inputs take the scores in
    fp32 and round the probabilities to the value dtype before the PV
    product, which then sums in fp32, as the JAX reference does with
    ``preferred_element_type=float32``."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    rep = hq // hkv
    qg = q.reshape(b, sq, hkv, rep, d)

    scale = 1.0 / torch.sqrt(torch.tensor(d, dtype=torch.float32))
    scores = torch.einsum("bqgrd,bkgd->bgrqk", qg.float(), k.float())
    scores = scores * scale.to(scores.device)  # (B, Hkv, rep, Sq, Skv)

    if window is not None and not causal:
        raise ValueError("sliding window requires causal attention")
    if causal:
        mask = causal_mask(sq, k.shape[1], q_offset, window,
                           device=q.device)
        # (q, kv) → (1, 1, 1, q, kv); (B, q, kv) → (B, 1, 1, q, kv)
        mask = mask[None, None, None] if mask.ndim == 2 \
            else mask[:, None, None]
        scores = torch.where(mask, scores, NEG_INF)
    if kv_mask is not None:
        if kv_mask.ndim == 3:     # per-query validity
            km = kv_mask[:, None, None, :, :]
        else:
            km = kv_mask[:, None, None, None, :]
        scores = torch.where(km, scores, NEG_INF)

    probs = torch.softmax(scores, dim=-1)
    if q.dtype != torch.float32:
        probs = probs.to(v.dtype)
    out = torch.einsum("bgrqk,bkgd->bqgrd", probs.float(), v.float())
    return out.reshape(b, sq, hq, d).to(q.dtype)
