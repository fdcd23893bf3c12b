"""Flash attention: GQA attention that never holds the (Sq, Skv) matrix.

The training and scoring forward (``attn_impl="flash"``) and its
backward. Same semantics as the JAX package's ``flash_attention``: the
public layout is ``(B, S, H, D)``; ``q_offset``/``kv_offset`` give the
absolute positions of the first query and key (rotated KV chunks);
``kv_mask`` (B, Skv) becomes an additive fp32 bias (0 or ``NEG_INF``);
``window`` is the sliding-window band ``kv in (q - window, q]``. Scores
and the softmax run in fp32; a row with no visible key gets output 0 and
logsumexp ``NEG_INF``.

Each of the three pieces has a plain PyTorch version beside its kernel
(``csrc/flash_attention.cu``):

* :func:`flash_attention_fwd_plain` — one einsum over the GQA-folded
  layout, returning out and lse;
* :func:`flash_attention_bwd_plain` — a blockwise recompute from the lse,
  mirroring the JAX ``_fa_backward_blockwise``.

The wrappers :func:`flash_attention_fwd`, :func:`flash_attention_bwd_dkdv`
and :func:`flash_attention_bwd_dq` launch the kernels for CUDA tensors
(each counts its launches in ``.launches``) and take the plain version
for CPU tensors. A CUDA tensor never falls back: the kernel launches or
the call raises. :func:`flash_attention` ties them together in a
``torch.autograd.Function``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build
from .attention import MASKED_THRESHOLD, NEG_INF

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)          # the kernels' template instances
_INT32_MAX = 2 ** 31 - 1
# The CUDA kernels behind each wrapper, for attributing profiler time:
# f32 and bf16 instances, and dK/dV's fold pass.
KERNEL_NAMES = {
    "fwd": ("fa_fwd_kernel", "fa_fwd_mma_kernel"),
    "dkdv": ("fa_bwd_dkdv_kernel", "fa_bwd_dkdv_mma_kernel",
             "fa_bwd_dkdv_fold_kernel"),
    "dq": ("fa_bwd_dq_kernel", "fa_bwd_dq_mma_kernel"),
}


def _bias_of(kv_mask: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """(B, Skv) bool validity → (B, Skv) fp32 additive bias."""
    if kv_mask is None:
        return None
    zero = torch.zeros((), dtype=torch.float32, device=kv_mask.device)
    return torch.where(kv_mask.bool(), zero, NEG_INF).contiguous()


def _visible(sq: int, skv: int, q_offset: int, kv_offset: int,
             window: Optional[int], device) -> torch.Tensor:
    """(Sq, Skv) bool: key j is causally visible (and inside the window)
    from query i, at absolute positions ``q_offset + i``, ``kv_offset +
    j``."""
    q_pos = q_offset + torch.arange(sq, device=device)[:, None]
    k_pos = kv_offset + torch.arange(skv, device=device)[None, :]
    mask = k_pos <= q_pos
    if window is not None:
        mask = mask & (k_pos > q_pos - window)
    return mask


def flash_attention_fwd_plain(
    q: torch.Tensor,                    # (B, Sq, Hq, D)
    k: torch.Tensor,                    # (B, Skv, Hkv, D)
    v: torch.Tensor,                    # (B, Skv, Hkv, D)
    bias: Optional[torch.Tensor] = None,  # (B, Skv) fp32 additive
    *,
    q_offset: int = 0,
    kv_offset: int = 0,
    causal: bool = True,
    window: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain forward: returns (out (B, Sq, Hq, D) in q's dtype, lse
    (B, Hq, Sq) fp32), what the JAX ``_fa_kernel`` computes, in one pass
    over the whole score matrix (the GQA group folded, K/V never
    repeated)."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    rep = hq // hkv
    qg = q.float().reshape(b, sq, hkv, rep, d) * (1.0 / d ** 0.5)
    s = torch.einsum("bqgrd,bkgd->bgrqk", qg, k.float())
    if bias is not None:
        s = s + bias[:, None, None, None, :]
    if causal:
        s = torch.where(_visible(sq, skv, q_offset, kv_offset, window,
                                 q.device), s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(s > MASKED_THRESHOLD, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)                      # (B,Hkv,rep,Sq,1)
    safe_l = torch.where(l > 0.0, l, 1.0)
    o = torch.einsum("bgrqk,bkgd->bqgrd", p, v.float())
    o = o / safe_l.permute(0, 3, 1, 2, 4)
    lse = torch.where(l > 0.0, m + torch.log(safe_l), NEG_INF)[..., 0]
    return (o.reshape(b, sq, hq, d).to(q.dtype),
            lse.reshape(b, hq, sq))


def _bwd_plain(q, k, v, bias, g, lse, delta, *, q_offset, kv_offset,
               causal, window, block_kv=128):
    """Blockwise backward from the lse, fp32 throughout: the JAX
    ``_fa_backward_blockwise`` with the KV scan as a Python loop over
    (possibly ragged) blocks. ``delta`` is rowsum(dO * O), (B, Hq, Sq).
    Returns (dq, dk, dv) in the input dtypes."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    rep = hq // hkv
    scale = 1.0 / d ** 0.5
    qf = q.float().reshape(b, sq, hkv, rep, d)
    gf = g.float().reshape(b, sq, hkv, rep, d)
    lse_g = lse.reshape(b, hkv, rep, sq)[..., None]
    delta_g = delta.reshape(b, hkv, rep, sq)[..., None]
    kf, vf = k.float(), v.float()
    dq = torch.zeros_like(qf)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    for k0 in range(0, skv, block_kv):
        k1 = min(skv, k0 + block_kv)
        if causal:
            # the forward's block skip: a block after the last query, or
            # (SWA) before every window, contributes nothing
            if kv_offset + k0 > q_offset + sq - 1:
                continue
            if window is not None and \
                    kv_offset + k1 - 1 < q_offset - window + 1:
                continue
        kb, vb = kf[:, k0:k1], vf[:, k0:k1]
        s = torch.einsum("bqgrd,bkgd->bgrqk", qf, kb) * scale
        if bias is not None:
            s = s + bias[:, None, None, None, k0:k1]
        if causal:
            vis = _visible(sq, k1 - k0, q_offset, kv_offset + k0, window,
                           q.device)
            s = torch.where(vis, s, NEG_INF)
        p = torch.where(s > MASKED_THRESHOLD, torch.exp(s - lse_g), 0.0)
        dv[:, k0:k1] = torch.einsum("bgrqk,bqgrd->bkgd", p, gf)
        dp = torch.einsum("bqgrd,bkgd->bgrqk", gf, vb)
        ds = p * (dp - delta_g)
        dq += torch.einsum("bgrqk,bkgd->bqgrd", ds, kb) * scale
        dk[:, k0:k1] = torch.einsum("bgrqk,bqgrd->bkgd", ds, qf) * scale
    return (dq.reshape(b, sq, hq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def _delta(g: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """rowsum(dO * O) in fp32, (B, Hq, Sq): what JAX computes outside
    any kernel before its backward scan."""
    return (g.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def flash_attention_bwd_plain(q, k, v, bias, out, lse, g, *, q_offset=0,
                              kv_offset=0, causal=True, window=None):
    """Plain backward: (dq, dk, dv) for upstream gradient ``g`` of
    ``out``."""
    return _bwd_plain(q, k, v, bias, g, lse, _delta(g, out),
                      q_offset=q_offset, kv_offset=kv_offset,
                      causal=causal, window=window)


# -- the kernels' wrappers ---------------------------------------------------


def _check(tensors, *, q, k, v, bias, lse=None, delta=None, q_offset,
           kv_offset, causal, window):
    """Refuse anything the kernels do not take, before launching."""
    dev = q.device
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"expected q (B, Sq, Hq, D), k/v (B, Skv, Hkv, D); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    if v.shape != k.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if hq % hkv:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={hkv}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"head dim {d} not supported by the kernels "
                         f"(one of {_HEAD_DIMS})")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"dtype {q.dtype} not supported (f32, bf16)")
    for name, x in tensors.items():
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, q on {dev}")
        if x.dtype != q.dtype:
            raise ValueError(f"{name} is {x.dtype}, q is {q.dtype}: the "
                             f"kernels take one dtype for all operands")
        if x.stride(-1) != 1:
            raise ValueError(f"{name} must have a contiguous head dim")
        if x.data_ptr() % 16 or any((s * x.element_size()) % 16
                                    for s in x.stride()[:3]):
            raise ValueError(f"{name} rows must be 16-byte aligned "
                             f"(data pointer and strides)")
    for name, x, shape in (("bias", bias, (b, skv)),
                           ("lse", lse, (b, hq, sq)),
                           ("delta", delta, (b, hq, sq))):
        if x is None:
            continue
        if x.device != dev or x.dtype != torch.float32 \
                or tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous f32 {shape} "
                             f"tensor on {dev}, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
    if window is not None and (not causal or window <= 0):
        raise ValueError("sliding window requires causal attention and "
                         "window > 0")
    for name, val in (("q_offset", q_offset), ("kv_offset", kv_offset)):
        if not isinstance(val, int):
            raise ValueError(f"{name} must be a Python int for the kernel, "
                             f"got {type(val).__name__}")
    if max(b * sq * hq * d, b * skv * hkv * d, abs(q_offset),
           abs(kv_offset)) > _INT32_MAX or max(b, hq) > 65535:
        raise ValueError("shape exceeds the kernels' index range")
    return b, sq, skv, hq, hkv, d


def _dims(b, sq, skv, hq, hkv, d, q_offset, kv_offset, causal, window):
    vals = (b, sq, skv, hq, hkv, d, q_offset, kv_offset, int(causal),
            0 if window is None else int(window))
    return (ctypes.c_longlong * len(vals))(*vals)


def _strides(*tensors):
    vals = [s for x in tensors for s in x.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def _launch(fn_name: str, q: torch.Tensor, *args) -> None:
    lib = _build.library("flash_attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = getattr(lib, fn_name)(*args, _DTYPE_CODES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"{fn_name} kernel launch failed with cudaError "
                           f"{rc}")


def _ptr(x: Optional[torch.Tensor]):
    return None if x is None else x.data_ptr()


def _cuda_or_raise(q: torch.Tensor, who: str) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"{who}: unsupported device {q.device}")


def flash_attention_fwd(q, k, v, bias=None, *, q_offset: int = 0,
                        kv_offset: int = 0, causal: bool = True,
                        window: Optional[int] = None):
    """(out, lse) of :func:`flash_attention_fwd_plain`. CUDA tensors
    launch the forward kernel (counted in ``flash_attention_fwd.launches``)
    on the current stream without synchronising; CPU tensors take the
    plain version."""
    kw = dict(q_offset=q_offset, kv_offset=kv_offset, causal=causal,
              window=window)
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, bias, **kw)
    _cuda_or_raise(q, "flash_attention_fwd")
    dims = _check({"q": q, "k": k, "v": v}, q=q, k=k, v=v, bias=bias, **kw)
    b, sq, skv, hq, hkv, d = dims
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    _launch("swi_flash_attention_fwd", q, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), _ptr(bias), out.data_ptr(), lse.data_ptr(),
            _dims(*dims, q_offset, kv_offset, causal, window),
            _strides(q, k, v, out))
    flash_attention_fwd.launches += 1
    return out, lse


def dkdv_scratch(q: torch.Tensor,
                 k: torch.Tensor) -> Optional[torch.Tensor]:
    """The bf16 dK/dV kernel's fp32 scratch on q's device: the per-q-head
    partial dK and dV, (2, B, Skv, Hq, D), which its second pass folds over
    each GQA group into (B, Skv, Hkv, D). None for f32, whose kernel folds
    the group inside one block."""
    if q.dtype != torch.bfloat16:
        return None
    b, _, hq, d = q.shape
    return torch.empty((2, b, k.shape[1], hq, d), dtype=torch.float32,
                       device=q.device)


def kernel_resources(d: int = 128) -> dict:
    """Registers per thread, dynamic shared bytes and threads per block,
    and resident blocks per SM of the bf16 kernels at head dim ``d``, as
    the card's runtime reports them (``fwd``, ``dkdv`` (its first pass),
    ``dq``). Needs a CUDA device."""
    lib = _build.library("flash_attention")
    res = {}
    for which, name in enumerate(("fwd", "dkdv", "dq")):
        out = (ctypes.c_int * 4)()
        rc = lib.swi_flash_attention_occupancy(which, d, out)
        if rc != 0:
            raise RuntimeError(f"occupancy query for {name} failed with "
                               f"cudaError {rc}")
        res[name] = dict(zip(("registers", "smem_bytes", "threads",
                              "blocks_per_sm"), list(out)))
    return res


def flash_attention_bwd_dkdv(q, k, v, bias, g, lse, delta, *,
                             q_offset: int = 0, kv_offset: int = 0,
                             causal: bool = True,
                             window: Optional[int] = None):
    """(dk, dv) for upstream gradient ``g`` of the output, from the
    forward's ``lse`` and ``delta = rowsum(g * out)`` (B, Hq, Sq). CUDA
    tensors launch the dK/dV kernel (counted in
    ``flash_attention_bwd_dkdv.launches``); CPU tensors take the plain
    blockwise backward."""
    kw = dict(q_offset=q_offset, kv_offset=kv_offset, causal=causal,
              window=window)
    if q.device.type == "cpu":
        return _bwd_plain(q, k, v, bias, g, lse, delta, **kw)[1:]
    _cuda_or_raise(q, "flash_attention_bwd_dkdv")
    dims = _check({"q": q, "k": k, "v": v, "g": g}, q=q, k=k, v=v,
                  bias=bias, lse=lse, delta=delta, **kw)
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    if dk.numel() == 0:
        return dk, dv
    scratch = dkdv_scratch(q, k)
    _launch("swi_flash_attention_bwd_dkdv", q, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), _ptr(bias), g.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), _ptr(scratch),
            _dims(*dims, q_offset, kv_offset, causal, window),
            _strides(q, k, v, g, dk, dv))
    flash_attention_bwd_dkdv.launches += 1
    return dk, dv


def flash_attention_bwd_dq(q, k, v, bias, g, lse, delta, *,
                           q_offset: int = 0, kv_offset: int = 0,
                           causal: bool = True,
                           window: Optional[int] = None):
    """dq for upstream gradient ``g``, from ``lse`` and ``delta`` as in
    :func:`flash_attention_bwd_dkdv`. CUDA tensors launch the dQ kernel
    (counted in ``flash_attention_bwd_dq.launches``); CPU tensors take the
    plain blockwise backward."""
    kw = dict(q_offset=q_offset, kv_offset=kv_offset, causal=causal,
              window=window)
    if q.device.type == "cpu":
        return _bwd_plain(q, k, v, bias, g, lse, delta, **kw)[0]
    _cuda_or_raise(q, "flash_attention_bwd_dq")
    dims = _check({"q": q, "k": k, "v": v, "g": g}, q=q, k=k, v=v,
                  bias=bias, lse=lse, delta=delta, **kw)
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    if dq.numel() == 0:
        return dq
    _launch("swi_flash_attention_bwd_dq", q, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), _ptr(bias), g.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(),
            _dims(*dims, q_offset, kv_offset, causal, window),
            _strides(q, k, v, g, dq))
    flash_attention_bwd_dq.launches += 1
    return dq


flash_attention_fwd.launches = 0
flash_attention_bwd_dkdv.launches = 0
flash_attention_bwd_dq.launches = 0


def flash_attention_bwd(q, k, v, bias, out, lse, g, *, q_offset=0,
                        kv_offset=0, causal=True, window=None):
    """(dq, dk, dv): the plain blockwise backward for CPU tensors, the
    dK/dV and dQ kernels for CUDA tensors."""
    kw = dict(q_offset=q_offset, kv_offset=kv_offset, causal=causal,
              window=window)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, bias, out, lse, g, **kw)
    delta = _delta(g, out)
    dk, dv = flash_attention_bwd_dkdv(q, k, v, bias, g, lse, delta, **kw)
    dq = flash_attention_bwd_dq(q, k, v, bias, g, lse, delta, **kw)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """The JAX ``_make_flash_fn`` custom VJP: the forward saves (q, k, v,
    bias, out, lse); the backward recomputes p from the lse. The bias
    (built from a boolean mask) and the offsets get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, bias, q_offset, kv_offset, causal, window):
        out, lse = flash_attention_fwd(q, k, v, bias, q_offset=q_offset,
                                       kv_offset=kv_offset, causal=causal,
                                       window=window)
        ctx.save_for_backward(q, k, v, bias, out, lse)
        ctx.opts = dict(q_offset=q_offset, kv_offset=kv_offset,
                        causal=causal, window=window)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, bias, out, lse,
                                         g.contiguous(), **ctx.opts)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(
    q: torch.Tensor,                    # (B, Sq, Hq, D)
    k: torch.Tensor,                    # (B, Skv, Hkv, D)
    v: torch.Tensor,                    # (B, Skv, Hkv, D)
    *,
    q_offset: int = 0,
    kv_offset: int = 0,
    kv_mask: Optional[torch.Tensor] = None,  # (B, Skv) True = valid
    causal: bool = True,
    window: Optional[int] = None,            # SWA: kv in (q-window, q]
) -> torch.Tensor:
    """Drop-in for ``ops.attention.attention`` plus ``kv_offset`` and
    block skipping under causality and the window; differentiable in q, k
    and v. Returns (B, Sq, Hq, D) in q's dtype. Offsets are Python ints."""
    if window is not None and not causal:
        raise ValueError("sliding window requires causal attention")
    return _FlashAttention.apply(q, k, v, _bias_of(kv_mask), int(q_offset),
                                 int(kv_offset), causal, window)
