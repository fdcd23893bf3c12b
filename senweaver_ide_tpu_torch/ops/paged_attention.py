"""Paged flash-decode: attention that reads KV through block tables.

The paged engine (rollout/paged_kv.py) stores KV in a fixed pool of
``(block_size, Hkv, D)`` blocks; each token's sequence is a list of
physical block ids. :func:`paged_flash_decode` computes, for every entry
of a flat token batch, Sq=1 attention over its sequence's first
``lengths[t]`` positions, straight from the pool.

Two versions of one function:

* :func:`paged_flash_decode_plain` gathers each entry's blocks into a
  contiguous ``(T, MB*BS, Hkv, D)`` copy and runs ``ops.attention`` over
  it, as ``models/transformer.py::_paged_layer``'s gather branch does.
  The CPU tests and the kernel checks on the card hold the kernel
  against it.
* :func:`paged_flash_decode` launches the hand-written CUDA kernel
  (``csrc/paged_attention.cu``) for CUDA tensors and takes the plain
  version for CPU tensors. A CUDA tensor never falls back: the kernel
  launches or the call raises.

``lengths[t]`` counts valid positions including the freshly written
current token (write-then-attend). A row with length 0 yields zeros.
With ``k_scale``/``v_scale`` ``(NB, BS, Hkv)`` f32 the pool holds int8
or fp8-e4m3 payloads, dequantized as they are read.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build
from .attention import attention

_FP8 = torch.float8_e4m3fn
_Q_CODES = {torch.float32: 0, torch.bfloat16: 1}
_KV_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2, _FP8: 3}
_QUANT_DTYPES = (torch.int8, _FP8)
_MAX_HEAD_DIM = 256        # the kernel's register prefetch bound
_MAX_SMEM = 227 * 1024


def _lengths_vector(lengths, t: int, device) -> torch.Tensor:
    lengths = torch.as_tensor(lengths, device=device)
    return torch.broadcast_to(lengths.to(torch.int32), (t,))


def paged_flash_decode_plain(
    q: torch.Tensor,              # (T, Hq, D)
    k_pool: torch.Tensor,         # (NB, BS, Hkv, D)
    v_pool: torch.Tensor,         # (NB, BS, Hkv, D)
    tables: torch.Tensor,         # (T, MB) physical block per logical block
    lengths,                      # (T,) or scalar: valid positions
    k_scale: Optional[torch.Tensor] = None,   # (NB, BS, Hkv) f32
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Gather + ``attention`` reference. Returns (T, Hq, D) in q's dtype.
    Quantized payloads dequantize to q's dtype before attention, as the
    engine's plain branch does."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale must be passed together")
    t, hq, d = q.shape
    _, bs, hkv, _ = k_pool.shape
    mb = tables.shape[1]
    lengths = _lengths_vector(lengths, t, q.device)
    tbl = tables.long()
    k_seq = k_pool[tbl].reshape(t, mb * bs, hkv, d)
    v_seq = v_pool[tbl].reshape(t, mb * bs, hkv, d)
    if k_scale is not None:
        k_seq = (k_seq.float() * k_scale[tbl].reshape(t, mb * bs, hkv,
                                                      1)).to(q.dtype)
        v_seq = (v_seq.float() * v_scale[tbl].reshape(t, mb * bs, hkv,
                                                      1)).to(q.dtype)
    valid = torch.arange(mb * bs, device=q.device)[None, :] \
        < lengths[:, None]
    out = attention(q[:, None], k_seq.to(q.dtype), v_seq.to(q.dtype),
                    q_offset=lengths.long() - 1, kv_mask=valid,
                    causal=True)[:, 0]
    # The kernels (this port's and the TPU one) return zeros for an
    # empty row; a fully masked softmax would average the dead slots.
    return torch.where((lengths > 0)[:, None, None], out,
                       torch.zeros((), dtype=out.dtype, device=out.device))


def _check(q, k_pool, v_pool, tables, lengths, k_scale, v_scale):
    dev = q.device
    tensors = {"q": q, "k_pool": k_pool, "v_pool": v_pool,
               "tables": tables, "lengths": lengths}
    if k_scale is not None:
        tensors.update(k_scale=k_scale, v_scale=v_scale)
    for name, x in tensors.items():
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, q on {dev}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if q.ndim != 3 or k_pool.ndim != 4:
        raise ValueError(f"expected q (T, Hq, D) and pools (NB, BS, Hkv, D), "
                         f"got {tuple(q.shape)} and {tuple(k_pool.shape)}")
    t, hq, d = q.shape
    nb, bs, hkv, dk = k_pool.shape
    if v_pool.shape != k_pool.shape or dk != d:
        raise ValueError(f"pool shapes {tuple(k_pool.shape)}/"
                         f"{tuple(v_pool.shape)} do not match q head dim {d}")
    if hq % hkv:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={hkv}")
    if q.dtype not in _Q_CODES:
        raise ValueError(f"q dtype {q.dtype} not supported (f32, bf16)")
    if k_pool.dtype not in _KV_CODES or v_pool.dtype != k_pool.dtype:
        raise ValueError(f"pool dtypes {k_pool.dtype}/{v_pool.dtype} not "
                         f"supported (f32, bf16, int8, fp8-e4m3)")
    quant = k_pool.dtype in _QUANT_DTYPES
    if quant != (k_scale is not None):
        raise ValueError("int8/fp8 pools need k_scale and v_scale; "
                         "full-width pools take none")
    if quant:
        for x in (k_scale, v_scale):
            if x.dtype != torch.float32 or tuple(x.shape) != (nb, bs, hkv):
                raise ValueError(f"scales must be f32 {(nb, bs, hkv)}, got "
                                 f"{x.dtype} {tuple(x.shape)}")
    if d > _MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} exceeds the kernel's {_MAX_HEAD_DIM}")
    if (d * k_pool.element_size()) % 16:
        raise ValueError(f"head dim {d} x {k_pool.element_size()} bytes is "
                         f"not a multiple of the 16-byte load")
    if tables.dtype != torch.int32 or tables.ndim != 2 \
            or tables.shape[0] != t:
        raise ValueError(f"tables must be int32 (T={t}, MB), got "
                         f"{tables.dtype} {tuple(tables.shape)}")
    if lengths.dtype != torch.int32 or tuple(lengths.shape) != (t,):
        raise ValueError(f"lengths must be int32 ({t},), got "
                         f"{lengths.dtype} {tuple(lengths.shape)}")
    if t > 65535:
        raise ValueError(f"T={t} exceeds the launch grid's y limit")
    return t, hq, d, bs, hkv, tables.shape[1], quant


def paged_flash_decode(
    q: torch.Tensor,              # (T, Hq, D) — one query per token entry
    k_pool: torch.Tensor,         # (NB, BS, Hkv, D) — one layer's pool
    v_pool: torch.Tensor,         # (NB, BS, Hkv, D)
    tables: torch.Tensor,         # (T, MB) int32; dead entries may hold
                                  # any id
    lengths,                      # (T,) int32 (or a scalar)
    k_scale: Optional[torch.Tensor] = None,   # (NB, BS, Hkv) f32 absmax
    v_scale: Optional[torch.Tensor] = None,   # scales for int8/fp8 pools
) -> torch.Tensor:
    """Block-table Sq=1 attention for the flat paged token batch. Returns
    (T, Hq, D) in q's dtype. CUDA tensors launch the kernel (counted in
    ``paged_flash_decode.launches``) on the current stream without
    synchronising; CPU tensors take :func:`paged_flash_decode_plain`."""
    if q.device.type == "cpu":
        return paged_flash_decode_plain(q, k_pool, v_pool, tables, lengths,
                                        k_scale, v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_flash_decode: unsupported device "
                         f"{q.device}")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale must be passed together")
    lengths = _lengths_vector(lengths, q.shape[0], q.device).contiguous()
    t, hq, d, bs, hkv, mb, quant = _check(q, k_pool, v_pool, tables,
                                          lengths, k_scale, v_scale)
    out = torch.empty_like(q)
    if t == 0:
        return out
    lib = _build.library("paged_attention")
    smem = lib.swi_paged_flash_decode_smem(hq, hkv, d)
    if smem > _MAX_SMEM:
        raise ValueError(f"paged_flash_decode needs {smem} bytes of shared "
                         f"memory at Hq={hq} Hkv={hkv} D={d} BS={bs}; the "
                         f"card gives a block at most {_MAX_SMEM}")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.swi_paged_flash_decode(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            k_scale.data_ptr() if quant else None,
            v_scale.data_ptr() if quant else None,
            tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            t, hq, hkv, d, bs, mb,
            _Q_CODES[q.dtype], _KV_CODES[k_pool.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"paged_flash_decode kernel launch failed with "
                           f"cudaError {rc}")
    paged_flash_decode.launches += 1
    return out


paged_flash_decode.launches = 0
