"""Sequence parallelism: ring attention and Ulysses all-to-all (PyTorch
port).

The sequence axis is split over the mesh's ``sp`` axis: rank i holds
queries, keys and values at absolute positions ``[i·S_local,
(i+1)·S_local)``. Every function here takes and returns this rank's
chunk (JAX's ``make_*`` callables take global arrays inside
``shard_map``; here each rank calls them on its local tensors).

- **Ring attention** (:func:`ring_attention`): each rank attends its
  query chunk to the K/V chunk it holds, merges the partial result with
  a running log-sum-exp, and passes K/V (and the kv mask) to the next
  rank with ``batch_isend_irecv``. The backward is autograd's: each step's
  shift is a :func:`~.comm.ring_shift`, whose backward sends the K/V
  gradient back the way the chunk came, so the dK/dV of a chunk reach
  its owner over the same ring run in reverse.
- **Ulysses** (:func:`ulysses_attention`): an all-to-all swaps the split
  from sequence to heads, full-sequence attention runs on 1/sp of the
  heads, and a second all-to-all swaps back; both are differentiable.
  Head counts must divide by the axis size.

As in the JAX package, both compute in plain ops (fp32 scores).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from ..ops.attention import MASKED_THRESHOLD as _MASKED
from ..ops.attention import NEG_INF, attention
from .comm import all_to_all, ring_shift
from .mesh import Mesh


def chunk_attention_lse(
    q: torch.Tensor,                  # (B, Sq, Hq, D)
    k: torch.Tensor,                  # (B, Skv, Hkv, D)
    v: torch.Tensor,                  # (B, Skv, Hkv, D)
    *,
    q_offset=0,
    kv_offset=0,
    kv_mask: Optional[torch.Tensor] = None,
    causal: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention over one KV chunk, returning the pieces the ring merge
    needs: out (B,Sq,Hq,D) fp32, softmax-normalized within this chunk,
    and lse (B,Hq,Sq) fp32. Fully-masked rows give out = 0,
    lse = NEG_INF."""
    b, sq, hq, d = q.shape
    rep = hq // k.shape[2]
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    scale = 1.0 / torch.sqrt(torch.tensor(d, dtype=torch.float32))
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        * scale.to(q.device)
    if causal:
        q_pos = q_offset + torch.arange(sq, device=q.device)
        k_pos = kv_offset + torch.arange(k.shape[1], device=q.device)
        mask = k_pos[None, :] <= q_pos[:, None]
        s = torch.where(mask[None, None], s, NEG_INF)
    if kv_mask is not None:
        s = torch.where(kv_mask[:, None, None, :].bool(), s, NEG_INF)
    m = s.amax(dim=-1)                                  # (B, Hq, Sq)
    m_safe = torch.clamp_min(m, _MASKED)
    p = torch.where(s > _MASKED, torch.exp(s - m_safe[..., None]), 0.0)
    l = p.sum(dim=-1)                                   # (B, Hq, Sq)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    l_safe = torch.where(l > 0.0, l, 1.0)
    o = o / l_safe.transpose(1, 2)[..., None]
    lse = torch.where(l > 0.0, m_safe + torch.log(l_safe), NEG_INF)
    return o, lse


def merge_partials(o_a, lse_a, o_b, lse_b):
    """Log-sum-exp merge of two chunk-normalized partial attentions.
    o: (B, S, H, D) fp32; lse: (B, H, S) fp32. NEG_INF lse = empty chunk."""
    lse_max = torch.maximum(lse_a, lse_b)
    lse_max_safe = torch.clamp_min(lse_max, _MASKED)
    w_a = torch.where(lse_a > _MASKED, torch.exp(lse_a - lse_max_safe), 0.0)
    w_b = torch.where(lse_b > _MASKED, torch.exp(lse_b - lse_max_safe), 0.0)
    tot = w_a + w_b
    tot_safe = torch.where(tot > 0.0, tot, 1.0)
    wa = (w_a / tot_safe).transpose(1, 2)[..., None]    # (B, S, H, 1)
    wb = (w_b / tot_safe).transpose(1, 2)[..., None]
    o = o_a * wa + o_b * wb
    lse = torch.where(tot > 0.0, lse_max_safe + torch.log(tot_safe),
                      NEG_INF)
    return o, lse


def ring_attention(
    q: torch.Tensor,                  # (B, S_local, Hq, D)
    k: torch.Tensor,                  # (B, S_local, Hkv, D)
    v: torch.Tensor,                  # (B, S_local, Hkv, D)
    *,
    mesh: Mesh,
    axis_name: str = "sp",
    causal: bool = True,
    kv_mask: Optional[torch.Tensor] = None,   # (B, S_local) local validity
) -> torch.Tensor:
    """Ring attention of this rank's chunk over the ``axis_name`` ring."""
    n = mesh.axis_size(axis_name)
    idx = mesh.coord(axis_name)
    s_local = q.shape[1]
    dk = k.shape[-1]
    o = torch.zeros(q.shape[:3] + (v.shape[-1],), dtype=torch.float32,
                    device=q.device)
    lse = torch.full((q.shape[0], q.shape[2], s_local), NEG_INF,
                     dtype=torch.float32, device=q.device)
    # K and V travel as one tensor: one exchange per step
    kv = torch.cat([k, v], dim=-1)
    mask = (kv_mask if kv_mask is not None
            else torch.ones((q.shape[0], s_local), dtype=torch.bool,
                            device=q.device))
    for t in range(n):
        src = (idx - t) % n                    # chunk id currently held
        o_t, lse_t = chunk_attention_lse(
            q, kv[..., :dk], kv[..., dk:], q_offset=idx * s_local,
            kv_offset=src * s_local, kv_mask=mask, causal=causal)
        o, lse = merge_partials(o, lse, o_t, lse_t)
        if t < n - 1:
            kv = ring_shift(kv, mesh, axis_name)
            mask = ring_shift(mask, mesh, axis_name)
    return o.to(q.dtype)


def _seq_to_heads(x: torch.Tensor, mesh: Mesh, axis_name: str
                  ) -> torch.Tensor:
    """(B, S_local, H, D) → (B, n·S_local, H/n, D) over the axis."""
    b, s, h, d = x.shape
    n = mesh.axis_size(axis_name)
    parts = x.reshape(b, s, n, h // n, d).permute(2, 0, 1, 3, 4)
    got = all_to_all(parts.contiguous(), mesh, axis_name)
    return got.permute(1, 0, 2, 3, 4).reshape(b, n * s, h // n, d)


def _heads_to_seq(x: torch.Tensor, mesh: Mesh, axis_name: str
                  ) -> torch.Tensor:
    """(B, n·S_local, H/n, D) → (B, S_local, H, D) over the axis."""
    b, s_full, hn, d = x.shape
    n = mesh.axis_size(axis_name)
    s = s_full // n
    parts = x.reshape(b, n, s, hn, d).permute(1, 0, 2, 3, 4)
    got = all_to_all(parts.contiguous(), mesh, axis_name)
    return got.permute(1, 2, 0, 3, 4).reshape(b, s, n * hn, d)


def ulysses_attention(
    q: torch.Tensor,                  # (B, S_local, Hq, D)
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    mesh: Mesh,
    axis_name: str = "sp",
    causal: bool = True,
) -> torch.Tensor:
    """Ulysses: all-to-all seq→head reshard, full-sequence attention on
    Hq/sp heads, reshard back."""
    n = mesh.axis_size(axis_name)
    if q.shape[2] % n or k.shape[2] % n:
        raise ValueError(
            f"ulysses needs head counts divisible by |{axis_name}|={n}; "
            f"got Hq={q.shape[2]}, Hkv={k.shape[2]}")
    q_full, k_full, v_full = (_seq_to_heads(t, mesh, axis_name)
                              for t in (q, k, v))
    out = attention(q_full, k_full, v_full, causal=causal)
    return _heads_to_seq(out, mesh, axis_name)


def make_ring_attention(mesh: Mesh, *, axis_name: str = "sp",
                        causal: bool = True, with_mask: bool = False):
    """Ring attention bound to ``mesh``: ``fn(q, k, v)`` on local chunks,
    or ``fn(q, k, v, kv_mask)`` with ``with_mask`` (the mask's local
    chunk rotates around the ring with its K/V)."""
    fn = functools.partial(ring_attention, mesh=mesh, axis_name=axis_name,
                           causal=causal)
    if with_mask:
        return lambda q, k, v, m: fn(q, k, v, kv_mask=m)
    return lambda q, k, v: fn(q, k, v)


def make_ulysses_attention(mesh: Mesh, *, axis_name: str = "sp",
                           causal: bool = True):
    """Ulysses attention bound to ``mesh``: ``fn(q, k, v)`` on local
    chunks."""
    return functools.partial(ulysses_attention, mesh=mesh,
                             axis_name=axis_name, causal=causal)
