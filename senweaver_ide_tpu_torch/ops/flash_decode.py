"""Flash-decode: single-token attention over a contiguous KV cache.

The slot-layout decode step attends one query per sequence against its
row of the ``(B, Smax, Hkv, D)`` cache, where every slot has its own
fill level. :func:`flash_decode` computes it for the whole batch.

Two versions of one function:

* :func:`flash_decode_plain` is ``ops.attention`` with the query at
  position ``lengths - 1`` (the einsum reference the JAX tests hold the
  TPU kernel against). The CPU tests and the kernel checks on the card
  hold the kernel against it.
* :func:`flash_decode` launches the hand-written CUDA kernel
  (``csrc/flash_decode.cu``) for CUDA tensors and takes the plain version
  for CPU tensors. A CUDA tensor never falls back: the kernel launches or
  the call raises.

In bf16 the kernel splits each slot's positions into chunks over several
blocks and merges their partial softmax states in a second pass;
:func:`split_plan` picks the chunks on the host from the shapes alone, so
no length is read back from the device.

``lengths[b]`` counts valid cache positions including the current
token's freshly written k/v (the transformer writes, then attends). A
slot with length 0 yields zeros, as the TPU kernel's ``safe_l`` does.
"""

from __future__ import annotations

import functools

import torch

from . import _build
from .attention import attention

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HEAD_DIM = 256        # the kernel's register prefetch bound
_MAX_SMEM = 227 * 1024
FD_TILE = 64               # positions a K/V tile of the split kernel holds
BLOCKS_PER_SM = 4          # split blocks a plan asks for, per SM
H100_SMS = 132
# The CUDA kernels behind flash_decode, for attributing profiler time: the
# split design's two passes and the serial design.
KERNEL_NAMES = ("fd_split_kernel", "fd_merge_kernel", "fd_serial_kernel")


def split_plan(b: int, hkv: int, smax: int,
               sms: int = H100_SMS) -> tuple:
    """(splits, chunk) of the split kernel for a (B, Smax, Hkv, D) cache:
    ``chunk`` positions (a multiple of :data:`FD_TILE`) per block, block
    s covering positions ``[s * chunk, (s + 1) * chunk)``, so that ``B *
    Hkv * splits`` asks for about :data:`BLOCKS_PER_SM` blocks per SM.
    Shapes only: the lengths stay on the device, and a block whose chunk
    starts at or past its slot's length exits at once."""
    tiles = max(1, -(-smax // FD_TILE))
    want = max(1, -(-(BLOCKS_PER_SM * sms) // max(1, b * hkv)))
    chunk = -(-tiles // min(tiles, want)) * FD_TILE
    return -(-max(smax, 1) // chunk), chunk


def _prepare(q, lengths):
    """(q as (B, 1, Hq, D), whether it came in 3-D, lengths (B,) int32)."""
    squeeze = q.ndim == 3
    if squeeze:
        q = q[:, None]
    b, sq = q.shape[:2]
    if sq != 1:
        raise ValueError(f"flash_decode is Sq=1 only, got Sq={sq}")
    lengths = torch.as_tensor(lengths, device=q.device)
    lengths = torch.broadcast_to(lengths.to(torch.int32), (b,))
    return q, squeeze, lengths


def flash_decode_plain(q: torch.Tensor, k_cache: torch.Tensor,
                       v_cache: torch.Tensor, lengths) -> torch.Tensor:
    """Einsum reference: causal attention with the query at position
    ``lengths - 1``. q (B, 1, Hq, D) or (B, Hq, D); returns q's shape."""
    q, squeeze, lengths = _prepare(q, lengths)
    out = attention(q, k_cache, v_cache, q_offset=lengths.long() - 1,
                    causal=True)
    out = torch.where((lengths > 0)[:, None, None, None], out,
                      torch.zeros((), dtype=out.dtype, device=out.device))
    return out[:, 0] if squeeze else out


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check(q, k_cache, v_cache, lengths):
    dev = q.device
    for name, x in (("k_cache", k_cache), ("v_cache", v_cache),
                    ("lengths", lengths)):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, q on {dev}")
    if k_cache.ndim != 4 or v_cache.shape != k_cache.shape:
        raise ValueError(f"expected caches (B, Smax, Hkv, D), got "
                         f"{tuple(k_cache.shape)} and "
                         f"{tuple(v_cache.shape)}")
    b, _, hq, d = q.shape
    bc, smax, hkv, dk = k_cache.shape
    if bc != b or dk != d:
        raise ValueError(f"cache {tuple(k_cache.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if hq % hkv:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={hkv}")
    if q.dtype not in _DTYPE_CODES or k_cache.dtype != q.dtype \
            or v_cache.dtype != q.dtype:
        raise ValueError(f"dtypes q {q.dtype}, caches {k_cache.dtype}/"
                         f"{v_cache.dtype}: the kernel takes f32 or bf16, "
                         f"the same for all three")
    if d > _MAX_HEAD_DIM or d % 4:
        raise ValueError(f"head dim {d} must be a multiple of 4 and at "
                         f"most {_MAX_HEAD_DIM}")
    el = q.element_size()
    for name, x in (("k_cache", k_cache), ("v_cache", v_cache)):
        if x.stride() != k_cache.stride():
            raise ValueError("k_cache and v_cache must share strides")
        if x.stride(3) != 1 or x.stride(2) != d:
            raise ValueError(f"{name}'s (Hkv, D) tail must be contiguous, "
                             f"strides {x.stride()}")
        if x.data_ptr() % 16 or (x.stride(0) * el) % 16 \
                or (x.stride(1) * el) % 16 or (d * el) % 16:
            raise ValueError(f"{name} rows must be 16-byte aligned")
    if b > 65535:
        raise ValueError(f"B={b} exceeds the launch grid's y limit")
    return b, hq, hkv, d, smax


def flash_decode(q: torch.Tensor,          # (B, 1, Hq, D) or (B, Hq, D)
                 k_cache: torch.Tensor,    # (B, Smax, Hkv, D)
                 v_cache: torch.Tensor,    # (B, Smax, Hkv, D)
                 lengths,                  # (B,) int or a scalar
                 *, block_kv: int = 128,
                 allow_pad_copy: bool = False) -> torch.Tensor:
    """Single-step cache attention. Returns q's shape, in q's dtype.

    ``Smax`` must be a multiple of ``block_kv`` unless
    ``allow_pad_copy=True``: the contract of the TPU kernel, whose padding
    would copy both caches every step. The CUDA kernel masks a ragged
    tail itself and never copies. CUDA tensors launch the kernel (counted
    in ``flash_decode.launches``) on the current stream without
    synchronising; CPU tensors take :func:`flash_decode_plain`."""
    smax = k_cache.shape[1]
    if smax % block_kv and not allow_pad_copy:
        raise ValueError(
            f"Smax={smax} is not a multiple of block_kv={block_kv}; "
            f"padding would copy the whole KV cache per decode step. "
            f"Allocate the cache block-aligned, or pass "
            f"allow_pad_copy=True to accept the copy.")
    if q.device.type == "cpu":
        return flash_decode_plain(q, k_cache, v_cache, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode: unsupported device {q.device}")
    q4, squeeze, lengths = _prepare(q, lengths)
    q4 = q4.contiguous()
    lengths = lengths.contiguous()
    b, hq, hkv, d, smax = _check(q4, k_cache, v_cache, lengths)
    out = torch.empty_like(q4)
    if b == 0:
        return out[:, 0] if squeeze else out
    lib = _build.library("flash_decode")
    code = _DTYPE_CODES[q4.dtype]
    smem = lib.swi_flash_decode_smem(hq, hkv, d, code)
    if smem > _MAX_SMEM:
        raise ValueError(f"flash_decode needs {smem} bytes of shared memory "
                         f"at Hq={hq} Hkv={hkv} D={d}; the card gives a "
                         f"block at most {_MAX_SMEM}")
    splits, chunk, scratch = 0, 0, None
    if lib.swi_flash_decode_splits(hq, hkv, d, code):
        splits, chunk = split_plan(b, hkv, smax, _sm_count(q.device))
        # fp32 partials: acc (B, Hkv, splits, rep, D), then (m, l) per row
        scratch = torch.empty(b * hq * splits * (d + 2),
                              dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.swi_flash_decode(
            q4.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            lengths.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(), b, hq, hkv, d,
            smax, k_cache.stride(0), k_cache.stride(1), splits, chunk, code,
            stream)
    if rc != 0:
        raise RuntimeError(f"flash_decode kernel launch failed with "
                           f"cudaError {rc}")
    flash_decode.launches += 1
    return out[:, 0] if squeeze else out


flash_decode.launches = 0
