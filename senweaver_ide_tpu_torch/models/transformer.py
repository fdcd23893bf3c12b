"""Decoder-only transformer in PyTorch: the no-cache forward, the
contiguous KV-cache forward of the slot layout, and the paged forward the
serving engine runs by default.

Parameters keep the JAX package's layout so the two can be held against
each other on the same weights: a plain dict of layer-STACKED tensors
(leading axis L) with ``(in, out)`` projection matrices, so ``x @ W``
is the JAX ``einsum("bsd,de->bse")``. The layer loop is a Python loop
over views of the stacked tensors (the JAX version scans).

The no-cache forward is also the training forward: ``attn_impl="flash"``
runs the flash-attention kernels (``ops/flash_attention.py``, forward and
backward), ``remat`` recomputes each layer in the backward, and merged
LoRA adapters (``training/lora.py``) ride in the layer dict.

The cache forward (``forward(cache=KVCache)``) writes each token's k/v
into a pre-allocated ``(L, B, Smax, Hkv, D)`` cache (bf16/f32, or int8
with per-vector scales when ``config.kv_quant``), at a scalar length or
per-slot lengths, as absolute positions or, for sliding-window models,
into a ring of ``ring_capacity`` slots. Its single-token steps attend
through the flash-decode kernel (``ops/flash_decode.py``) when
``config.decode_attn_impl == "flash"`` and the step qualifies.

Out of the port so far, and raising ``NotImplementedError`` where
reached: mixture-of-experts FFNs, int8 weights (later slices) and the
ring/ulysses attention (the parallel-layout slice).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..ops.attention import attention
from ..ops.flash_attention import flash_attention
from ..ops.flash_decode import flash_decode
from ..ops.norms import rms_norm
from ..ops.paged_attention import (paged_flash_decode,
                                   paged_flash_decode_plain, query_tiles)
from ..ops.rotary import apply_rope, rope_cos_sin
from .config import ModelConfig

Params = Dict[str, object]

_FP8 = torch.float8_e4m3fn


def pool_qmax(dtype) -> float:
    """Clip magnitude of a quantized paged-KV payload dtype (the scale
    denominator: scale = absmax / qmax)."""
    if dtype == torch.int8:
        return 127.0
    if dtype == _FP8:
        return 448.0
    raise ValueError(f"not a quantized KV payload dtype: {dtype}")


def quantize_pool_kv(x: torch.Tensor,
                     dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-vector absmax quantization over the trailing head_dim axis:
    ``(..., D)`` full-width → (payload in ``dtype``, ``(...)`` f32
    scales). int8 rounds half to even, as ``jnp.round`` does."""
    qmax = pool_qmax(dtype)
    xf = x.float()
    absmax = xf.abs().amax(dim=-1)
    scale = torch.clamp_min(absmax, 1e-8) / qmax
    y = xf / scale[..., None]
    if dtype == torch.int8:
        q = torch.clamp(torch.round(y), -qmax, qmax).to(torch.int8)
    else:
        q = torch.clamp(y, -qmax, qmax).to(dtype)
    return q, scale


def dequantize_pool_kv(q: torch.Tensor, scale: torch.Tensor,
                       dtype) -> torch.Tensor:
    """Inverse of :func:`quantize_pool_kv`: ``(..., D)`` payload +
    ``(...)`` scales → ``dtype`` values."""
    return (q.float() * scale[..., None]).to(dtype)


class KVCache(NamedTuple):
    """The contiguous ("slot layout") KV cache.

    ``k``/``v`` are ``(L, B, Smax, Hkv, D)`` in the model dtype, or int8
    with ``k_scale``/``v_scale`` ``(L, B, Smax, Hkv)`` f32 absmax/127
    scales when quantized. ``length`` is a () int32 tensor (tokens in
    every row) or (B,) int32 per-slot lengths (continuous batching); on a
    ring cache it keeps counting past the capacity."""

    k: torch.Tensor
    v: torch.Tensor
    length: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None


def ring_capacity(config: ModelConfig, max_len: int) -> int:
    """KV capacity allocated for ``max_len`` requested positions.

    Sliding-window configs keep only the trailing window (a ring written
    at ``pos % capacity``): a mistral-7b decode holds 4096 slots at any
    context. The window rounds up to a multiple of 8, as in the JAX
    package, so a window that is itself a multiple of 128 keeps the
    capacity equal to it and the flash-decode path eligible."""
    if config.sliding_window is None:
        return max_len
    return min(max_len, -(-config.sliding_window // 8) * 8)


def _is_ring(c: ModelConfig, cap: int) -> bool:
    """Ring (modular-write) semantics apply only when the cache holds the
    whole window: a smaller cache would overwrite keys still inside the
    window on every wrap. A short sliding-window cache (cap below the
    aligned window) is a plain bounded cache with the positional window
    mask, never wrapping."""
    return (c.sliding_window is not None
            and cap >= -(-c.sliding_window // 8) * 8)


def init_kv_cache(config: ModelConfig, batch: int, max_len: int, *,
                  device="cuda") -> KVCache:
    """Zeroed cache for ``batch`` rows of ``ring_capacity(config,
    max_len)`` positions, with a () length of 0: int8 with scales when
    ``config.kv_quant``, else in the model dtype."""
    dev = resolve_device(device)
    max_len = ring_capacity(config, max_len)
    shape = (config.num_layers, batch, max_len, config.num_kv_heads,
             config.head_dim)
    length = torch.zeros((), dtype=torch.int32, device=dev)
    if config.kv_quant:
        return KVCache(
            k=torch.zeros(shape, dtype=torch.int8, device=dev),
            v=torch.zeros(shape, dtype=torch.int8, device=dev),
            length=length,
            k_scale=torch.zeros(shape[:-1], dtype=torch.float32, device=dev),
            v_scale=torch.zeros(shape[:-1], dtype=torch.float32, device=dev))
    return KVCache(k=torch.zeros(shape, dtype=config.dtype, device=dev),
                   v=torch.zeros(shape, dtype=config.dtype, device=dev),
                   length=length)


def _quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, S, H, D) → int8 values + (B, S, H) f32 absmax/127 scales."""
    return quantize_pool_kv(x, torch.int8)


def init_params(config: ModelConfig, generator: torch.Generator, *,
                device="cuda") -> Params:
    """Random init (normal / sqrt(fan_in)); layer params stacked on axis
    0. Draws directly in the target dtype on the target device: an fp32
    transient of every stacked tensor would not fit beside the bf16
    weights of the larger presets. ``generator`` must live on
    ``device``."""
    c = config
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"generator is on {generator.device}, params on "
                         f"{dev}; create it with torch.Generator("
                         f"device={dev.type!r})")

    def normal(shape, std):
        w = torch.randn(shape, generator=generator, dtype=c.dtype,
                        device=dev)
        return w.mul_(torch.tensor(std, dtype=c.dtype))

    def dense(shape, fan_in):
        return normal(shape, 1.0 / float(fan_in) ** 0.5)

    L, D, F = c.num_layers, c.hidden_size, c.intermediate_size
    if c.num_experts > 0:
        raise NotImplementedError(
            "mixture-of-experts layers arrive with the parallel-layout "
            "slice of the PyTorch port")

    def ones(*shape):
        return torch.ones(shape, dtype=c.dtype, device=dev)

    embed = normal((c.vocab_size, D), 0.02)
    layers = {
        "attn_norm": ones(L, D),
        "wq": dense((L, D, c.q_dim), D),
        "wk": dense((L, D, c.kv_dim), D),
        "wv": dense((L, D, c.kv_dim), D),
        "wo": dense((L, c.q_dim, D), c.q_dim),
        "mlp_norm": ones(L, D),
        "w_gate": dense((L, D, F), D),
        "w_up": dense((L, D, F), D),
        "w_down": dense((L, F, D), F),
    }
    if c.qkv_bias:
        layers["bq"] = torch.zeros((L, c.q_dim), dtype=c.dtype, device=dev)
        layers["bk"] = torch.zeros((L, c.kv_dim), dtype=c.dtype, device=dev)
        layers["bv"] = torch.zeros((L, c.kv_dim), dtype=c.dtype, device=dev)
    if c.qk_norm:
        layers["q_norm"] = ones(L, c.head_dim)
        layers["k_norm"] = ones(L, c.head_dim)
    params: Params = {"embed": embed, "layers": layers,
                      "final_norm": ones(D)}
    if not c.tie_word_embeddings:
        params["lm_head"] = dense((D, c.vocab_size), D)
    return params


def _layer_params(params: Params, i: int) -> Dict[str, torch.Tensor]:
    """Views of layer ``i`` of every stacked tensor."""
    return {k: v[i] for k, v in params["layers"].items()}


def _dense(h: torch.Tensor, lp: Dict[str, torch.Tensor],
           name: str) -> torch.Tensor:
    """``h @ lp[name]`` for an ``(in, out)`` weight, plus ``(h @ A) @ B``
    when a merged LoRA adapter (``name + "_lora_a"``/``"_lora_b"``) is
    present: the factored order never materialises the (in, out) delta,
    and the alpha/rank scale is already baked into A."""
    w = lp[name]
    if w.dtype == torch.int8:
        raise NotImplementedError(
            "int8 weights (models/quantize.py) arrive with a later slice "
            "of the PyTorch port")
    out = h @ w
    la = lp.get(name + "_lora_a")
    if la is not None:
        out = out + (h @ la) @ lp[name + "_lora_b"]
    return out


def _qkv(c: ModelConfig, lp: Dict[str, torch.Tensor], h: torch.Tensor,
         cos: torch.Tensor, sin: torch.Tensor):
    """Project + rotate. h (B, S, D) → q (B,S,Hq,Dh), k/v (B,S,Hkv,Dh)."""
    b, s, _ = h.shape
    q = _dense(h, lp, "wq")
    k = _dense(h, lp, "wk")
    v = _dense(h, lp, "wv")
    if c.qkv_bias:
        q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
    q = q.reshape(b, s, c.num_heads, c.head_dim)
    k = k.reshape(b, s, c.num_kv_heads, c.head_dim)
    if c.qk_norm:
        # Qwen3: per-head RMSNorm over head_dim BEFORE RoPE
        q = rms_norm(q, lp["q_norm"], c.rms_norm_eps)
        k = rms_norm(k, lp["k_norm"], c.rms_norm_eps)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    v = v.reshape(b, s, c.num_kv_heads, c.head_dim)
    return q, k, v


def _mlp(c: ModelConfig, lp: Dict[str, torch.Tensor],
         x: torch.Tensor) -> torch.Tensor:
    """x + silu-gated FFN(norm(x)); SiLU in fp32, then cast."""
    if c.num_experts > 0:
        raise NotImplementedError(
            "mixture-of-experts FFNs arrive with the parallel-layout "
            "slice of the PyTorch port")
    h = rms_norm(x, lp["mlp_norm"], c.rms_norm_eps)
    gate = _dense(h, lp, "w_gate")
    up = _dense(h, lp, "w_up")
    act = torch.nn.functional.silu(gate.float()).to(x.dtype) * up
    return x + _dense(act, lp, "w_down")


def _logits(params: Params, c: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"], c.rms_norm_eps)
    if "tied_head_q8" in params:
        raise NotImplementedError(
            "the int8 tied head arrives with a later slice of the "
            "PyTorch port")
    head = params.get("lm_head")
    if head is None:  # tied embeddings
        logits = x @ params["embed"].T
    else:
        logits = x @ head
    return logits.float()


def _self_attention(c: ModelConfig, q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor,
                    kv_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """No-cache attention per ``c.attn_impl``. q (B,S,Hq,Dh), k/v
    (B,S,Hkv,Dh) → (B,S,Hq,Dh)."""
    if c.attn_impl == "einsum":
        return attention(q, k, v, q_offset=0, kv_mask=kv_mask, causal=True,
                         window=c.sliding_window)
    if c.attn_impl == "flash":
        return flash_attention(q, k, v, q_offset=0, kv_mask=kv_mask,
                               causal=True, window=c.sliding_window)
    if c.attn_impl in ("ring", "ulysses"):
        raise NotImplementedError(
            f"attn_impl={c.attn_impl!r} shards the sequence over a mesh; it "
            f"arrives with the parallel-layout slice of the PyTorch port")
    raise ValueError(f"unknown attn_impl {c.attn_impl!r}; expected "
                     f"einsum|flash|ring|ulysses")


def _layer(c: ModelConfig, lp: Dict[str, torch.Tensor], x: torch.Tensor,
           cos: torch.Tensor, sin: torch.Tensor,
           attn_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """One no-cache transformer block. x: (B, S, D)."""
    b, s, _ = x.shape
    h = rms_norm(x, lp["attn_norm"], c.rms_norm_eps)
    q, k, v = _qkv(c, lp, h, cos, sin)
    out = _self_attention(c, q, k, v, attn_mask)
    x = x + _dense(out.reshape(b, s, c.q_dim), lp, "wo")
    return _mlp(c, lp, x)


def _write_cache(dst: torch.Tensor, new: torch.Tensor, length: torch.Tensor,
                 ring: bool) -> None:
    """Write ``new`` (B, s, ...) into one layer's ``dst`` (B, cap, ...) IN
    PLACE at ``length``, as the JAX scatters do, with no host sync.

    A scalar length on an absolute cache is ``dynamic_update_slice``,
    whose start clamps to ``cap - s`` so the update fits; a ring writes
    at ``(length + j) % cap``. Per-slot lengths scatter each row at its
    own length; on an absolute cache the positions at or past ``cap``
    are dropped (JAX ``mode="drop"``): such a write is redirected to
    position ``cap - 1`` of its own row carrying the value that position
    ends with (the row's own write there, if it has one, else the old
    value), so every write landing there agrees and no live position
    changes."""
    new = new.to(dst.dtype)
    b, cap = dst.shape[:2]
    s = new.shape[1]
    steps = torch.arange(s, device=dst.device)
    if length.ndim == 0:
        if ring:
            idx = (length.long() + steps) % cap
        else:
            if s > cap:
                raise ValueError(f"a chunk of {s} tokens does not fit a "
                                 f"cache of {cap} positions")
            idx = torch.clamp(length.long(), 0, cap - s) + steps
        dst.index_copy_(1, idx, new)
        return
    length = length.long()
    pos = length[:, None] + steps[None, :]                  # (B, s)
    rows = torch.arange(b, device=dst.device)[:, None].expand(b, s)
    if ring:
        dst[rows, pos % cap] = new
        return
    keep = pos < cap
    last = cap - 1 - length                                 # chunk index
    hits = (last >= 0) & (last < s)                         # writing cap-1
    own = new[torch.arange(b, device=dst.device), last.clamp(0, s - 1)]
    tail_shape = (b,) + (1,) * (new.ndim - 2)
    end = torch.where(hits.view(tail_shape), own, dst[:, cap - 1])
    vals = torch.where(keep.view(keep.shape + (1,) * (new.ndim - 2)), new,
                       end[:, None])
    dst[rows, pos.clamp(max=cap - 1)] = vals


def _cache_attention(c: ModelConfig, q: torch.Tensor, k_full: torch.Tensor,
                     v_full: torch.Tensor, length: torch.Tensor,
                     kv_mask: torch.Tensor,
                     flash_decode_ok: bool) -> torch.Tensor:
    """Cache-path attention: the flash-decode kernel when the step allows
    it, else the plain attention over the whole cache.

    Ring caches receive the full per-query validity mask (fill, causality
    and window in ring coordinates), so the positional mask is off there.
    Flash-decode is valid on a ring whose capacity equals the window: the
    live entries are exactly indices < min(length + 1, cap), and online
    softmax does not depend on their order."""
    if flash_decode_ok:
        smax = k_full.shape[1]
        blk = 128 if smax % 128 == 0 else smax
        # post-write valid count: the current token's k/v is in the cache
        valid_count = torch.clamp(length + 1, max=smax)
        return flash_decode(q, k_full, v_full, valid_count, block_kv=blk)
    if _is_ring(c, k_full.shape[1]):
        return attention(q, k_full, v_full, kv_mask=kv_mask, causal=False)
    return attention(q, k_full, v_full, q_offset=length, kv_mask=kv_mask,
                     causal=True, window=c.sliding_window)


def _cache_layer(c: ModelConfig, lp: Dict[str, torch.Tensor],
                 x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                 kv: Tuple[torch.Tensor, ...], length: torch.Tensor,
                 kv_mask: torch.Tensor, flash_decode_ok: bool
                 ) -> torch.Tensor:
    """One transformer block over one layer of the contiguous cache.

    ``kv`` is ``(k_cache, v_cache)`` or, for the int8 cache, ``(k_cache,
    v_cache, k_scale, v_scale)``; the block's new k/v (quantized, for the
    int8 cache) are written IN PLACE at ``length``, then the block attends
    over the cache (dequantized to the compute dtype for the int8 cache).
    A ring chunk of s > 1 tokens attends BEFORE writing, over [pre-write
    cache ‖ chunk] (the chunk's own k/v unquantized), since a wrapping
    chunk's writes would destroy keys still inside earlier queries'
    windows; with a chunk-width mask (fresh cache) it attends over the
    chunk alone."""
    b, s, _ = x.shape
    h = rms_norm(x, lp["attn_norm"], c.rms_norm_eps)
    q, k, v = _qkv(c, lp, h, cos, sin)
    k_cache, v_cache = kv[0], kv[1]
    quant = len(kv) == 4
    cap = k_cache.shape[1]
    ring = _is_ring(c, cap)

    def full(i):
        if quant:
            return dequantize_pool_kv(kv[i], kv[i + 2], x.dtype)
        return kv[i]

    out = None
    if ring and s > 1:
        if kv_mask.shape[-1] == s:
            out = attention(q, k, v, kv_mask=kv_mask, causal=False)
        else:
            k_all = torch.cat([full(0).to(x.dtype), k], dim=1)
            v_all = torch.cat([full(1).to(x.dtype), v], dim=1)
            out = attention(q, k_all, v_all, kv_mask=kv_mask, causal=False)
    if quant:
        (kq, ks), (vq, vs) = _quantize_kv(k), _quantize_kv(v)
        writes = zip(kv, (kq, vq, ks, vs))
    else:
        writes = zip(kv, (k, v))
    for dst, new in writes:
        _write_cache(dst, new, length, ring)
    if out is None:
        out = _cache_attention(c, q, full(0), full(1), length, kv_mask,
                               flash_decode_ok)
    x = x + _dense(out.reshape(b, s, c.q_dim), lp, "wo")
    return _mlp(c, lp, x)


def _cache_mask(c: ModelConfig, cache: KVCache, b: int, s: int,
                attn_mask: Optional[torch.Tensor], fresh_cache: bool):
    """The cache forward's kv validity mask and whether its attention may
    take the flash-decode kernel.

    Absolute caches: (B, Smax), positions below ``length + s`` (and
    ``attn_mask``). Ring caches (capacity ``cap``, written at
    ``pos % cap``): for a single-token step, written first, index i holds
    the latest position p ≡ i (mod cap) and the query attends iff
    0 ≤ p ≤ qp and p > qp − window, a (B, 1, cap) mask; for a chunk,
    attended before writing, a (B, s, cap + s) mask (old slots valid by
    their pre-chunk positions, causal + window inside the chunk), or
    (B, s, s) when ``fresh_cache`` promises nothing old to read."""
    max_len = cache.k.shape[2]
    length = cache.length
    dev = cache.k.device
    if _is_ring(c, max_len):
        cap = max_len
        if s > cap:
            raise ValueError(
                f"chunk of {s} tokens exceeds the ring capacity {cap} "
                f"(window {c.sliding_window}); prefill in chunks of at most "
                f"the window size")
        base = length[:, None, None] if length.ndim == 1 else length
        base = base.long()
        i = torch.arange(cap, device=dev)[None, None, :]
        qp = base + torch.arange(s, device=dev)[None, :, None]
        if s == 1:
            if attn_mask is not None:
                raise NotImplementedError(
                    "attn_mask on a ring-cache decode step: ring indices are "
                    "modular positions; combine masks upstream instead")
            total = base + 1                              # after the write
            p = (total - 1) - ((total - 1 - i) % cap)     # position per slot
            valid = (p >= 0) & (p <= qp) & (p > qp - c.sliding_window)
            valid = torch.broadcast_to(valid, (b, 1, cap))
        else:
            t = torch.arange(s, device=dev)[None, None, :]    # chunk kv idx
            j = torch.arange(s, device=dev)[None, :, None]    # chunk q idx
            valid_new = (t <= j) & (j - t < c.sliding_window)
            if attn_mask is not None:
                # only meaningful on a fresh row, where positions coincide
                # with chunk indices (the engine's padded prefill)
                valid_new = valid_new & attn_mask[:, None, :s]
            if fresh_cache:
                valid = torch.broadcast_to(valid_new, (b, s, s))
            else:
                p_old = (base - 1) - ((base - 1 - i) % cap)   # pre-chunk
                valid_old = (p_old >= 0) & (p_old > qp - c.sliding_window)
                valid = torch.cat(
                    [torch.broadcast_to(valid_old, (b, s, cap)),
                     torch.broadcast_to(valid_new, (b, s, s))], dim=-1)
    else:
        kv_pos = torch.arange(max_len, device=dev)[None, :]
        bound = (length[:, None] if length.ndim == 1 else length) + s
        valid = torch.broadcast_to(kv_pos < bound, (b, max_len))
        if attn_mask is not None:
            valid = valid & attn_mask
    # Flash-decode needs the mask to be exactly "pos < valid_count" (one
    # new token, no extra mask) and a cache that splits into KV blocks,
    # the JAX package's rules: 128-aligned, or small and 8-aligned. A ring
    # qualifies when its capacity equals the window; a short absolute
    # sliding-window cache when every position it holds is in the window.
    tileable = (max_len % 128 == 0
                or (max_len % 8 == 0 and max_len <= 512))
    if c.sliding_window is None:
        swa_flash = True
    elif _is_ring(c, max_len):
        swa_flash = max_len == c.sliding_window
    else:
        swa_flash = max_len <= c.sliding_window
    flash_ok = (c.decode_attn_impl == "flash" and s == 1
                and attn_mask is None and tileable and swa_flash)
    return valid, flash_ok


def forward(params: Params, config: ModelConfig, tokens: torch.Tensor, *,
            positions: Optional[torch.Tensor] = None,
            attn_mask: Optional[torch.Tensor] = None,
            with_aux: bool = False, cache: Optional[KVCache] = None,
            fresh_cache: bool = False):
    """Run the model over ``tokens`` (B, S).

    Without a cache: full causal self-attention → fp32 logits (B, S, V)
    (the JAX ``forward`` returns ``(logits, None)`` there; the port
    returns the logits alone). ``positions`` (B, S) are the absolute RoPE
    positions (default ``0..S-1``); ``attn_mask`` (B, S) marks valid keys.
    ``with_aux=True`` returns ``(logits, None, aux)`` as JAX does, ``aux``
    being the MoE load-balance loss, a zero scalar for dense models. A
    truthy ``config.remat`` recomputes each layer in the backward
    (``torch.utils.checkpoint``, non-reentrant) instead of holding its
    activations; ``"dots"`` behaves as ``True`` (the port keeps no per-op
    save policy). The recompute runs the layer's attention forward a
    second time.

    With ``cache`` (a :class:`KVCache`): the tokens are appended at
    ``cache.length`` (positions default to ``length + 0..S-1``) and attend
    to everything up to them; prefill and decode take the same path.
    Returns ``(logits, new_cache)``, or ``(logits, new_cache, aux)`` with
    ``with_aux``, as JAX does. The cache's k/v (and scale) tensors are
    updated IN PLACE (the JAX version donates them and returns new ones):
    ``new_cache`` holds the same tensors with ``length + S``. ``attn_mask``
    is then (B, Smax) over the cache, and ``fresh_cache`` promises the
    cache holds nothing yet, so a ring-cache chunk attends over itself
    alone."""
    c = config
    b, s = tokens.shape
    x = params["embed"][tokens]
    if positions is None:
        base = torch.zeros((), dtype=torch.int32, device=tokens.device)
        if cache is not None:
            base = cache.length.to(tokens.device)
            if base.ndim == 1:
                base = base[:, None]                   # per-slot lengths
        positions = base + torch.arange(s, dtype=torch.int32,
                                        device=tokens.device)[None, :]
        positions = positions.expand(b, s)
    cos, sin = rope_cos_sin(positions, c.head_dim, c.rope_theta,
                            scaling=c.rope_scaling)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    if cache is not None:
        valid, flash_ok = _cache_mask(c, cache, b, s, attn_mask, fresh_cache)
        for i in range(c.num_layers):
            kv = (cache.k[i], cache.v[i])
            if cache.quantized:
                kv += (cache.k_scale[i], cache.v_scale[i])
            x = _cache_layer(c, _layer_params(params, i), x, cos, sin, kv,
                             cache.length, valid, flash_ok)
        new_cache = cache._replace(length=cache.length + s)
        logits = _logits(params, c, x)
        return (logits, new_cache, zero) if with_aux else (logits, new_cache)
    remat = bool(c.remat) and torch.is_grad_enabled()
    # One unbind per stacked tensor: its backward stacks the L per-layer
    # gradients once, where a view per layer (v[i]) would have autograd
    # build and add a full (L, ...) zero-padded gradient for every layer.
    layers = {k: torch.unbind(v) for k, v in params["layers"].items()}
    for i in range(c.num_layers):
        lp = {k: v[i] for k, v in layers.items()}
        if remat:
            x = checkpoint(_layer, c, lp, x, cos, sin, attn_mask,
                           use_reentrant=False)
        else:
            x = _layer(c, lp, x, cos, sin, attn_mask)
    logits = _logits(params, c, x)
    if with_aux:
        return logits, None, zero
    return logits


def count_params(params: Params) -> int:
    """Total element count of a (nested) parameter dict."""
    if isinstance(params, torch.Tensor):
        return params.numel()
    return sum(count_params(v) for v in params.values())


def _paged_layer(c: ModelConfig, lp: Dict[str, torch.Tensor],
                 x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                 k_pool: torch.Tensor, v_pool: torch.Tensor,
                 tables_tok: torch.Tensor, lengths: torch.Tensor,
                 keep: torch.Tensor, write_block: torch.Tensor,
                 write_off: torch.Tensor, use_kernel: bool,
                 k_scale_pool: Optional[torch.Tensor] = None,
                 v_scale_pool: Optional[torch.Tensor] = None,
                 q_tiles: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """One transformer block over one layer's paged pool.

    ``x`` is the flat token batch ``(T, 1, D)``. Every kept entry
    (``keep``: indices whose ``write_block`` is a real block) scatters
    its new k/v into the pool IN PLACE at ``(write_block, write_off)``
    (the JAX version returns an updated, donated pool); dropped entries
    (padding, the ``num_blocks`` sentinel) write nothing. All writes land
    before the attention read, so a prefill chunk's later tokens see its
    earlier ones within the same step. ``tables_tok`` is each entry's
    table row ``(T, MB)`` int32 and ``lengths`` its valid count
    ``positions + 1``; ``q_tiles`` the kernel's query tiles
    (``ops.paged_attention.query_tiles``), or None."""
    t = x.shape[0]
    h = rms_norm(x, lp["attn_norm"], c.rms_norm_eps)
    q, k, v = _qkv(c, lp, h, cos, sin)       # q (T,1,Hq,Dh), k/v (T,1,Hkv,Dh)
    k_new, v_new = k[keep, 0], v[keep, 0]
    if k_scale_pool is not None:
        # quantize-at-write: payload and scale land through the SAME
        # indices, so a dropped write leaves both untouched
        kq, ks = quantize_pool_kv(k_new, k_pool.dtype)
        vq, vs = quantize_pool_kv(v_new, v_pool.dtype)
        k_pool[write_block, write_off] = kq
        v_pool[write_block, write_off] = vq
        k_scale_pool[write_block, write_off] = ks
        v_scale_pool[write_block, write_off] = vs
    else:
        k_pool[write_block, write_off] = k_new.to(k_pool.dtype)
        v_pool[write_block, write_off] = v_new.to(v_pool.dtype)
    attend = paged_flash_decode if use_kernel else paged_flash_decode_plain
    out = attend(q[:, 0], k_pool, v_pool, tables_tok, lengths,
                 k_scale_pool, v_scale_pool, q_tiles=q_tiles)
    x = x + _dense(out.reshape(t, 1, c.q_dim), lp, "wo")
    return _mlp(c, lp, x)


def forward_paged(
    params: Params,
    config: ModelConfig,
    tokens: torch.Tensor,         # (T,) int — flat token batch
    *,
    pool,                         # rollout.paged_kv.PagedKVPool, updated
                                  # in place
    tables: torch.Tensor,         # (R, MB) int — physical block per
                                  # (row, logical block)
    seq_row: torch.Tensor,        # (T,) int — table row per token
    positions: torch.Tensor,      # (T,) int — absolute position
    write_block: torch.Tensor,    # (T,) int — pool block to write
                                  # (num_blocks = drop)
    write_off: torch.Tensor,      # (T,) int — offset within block
    use_kernel: bool = False,     # CUDA paged-attention kernel
    adapters=None,
    adapter_ids=None,
):
    """Run the model over a paged KV pool: every entry of the flat
    ``(T,)`` batch is one (sequence, position) pair, a decode step or
    one token of a chunked-prefill segment, reading KV through the
    ``(row, logical_block) -> physical_block`` table. Returns
    ``(logits (T, V) fp32, pool)``; the pool's tensors are updated in
    place (the JAX version donates them and returns new ones).

    The integer inputs may live on the host or on the pool's device.
    Which entries write is decided from ``write_block`` on the host (a
    host copy costs a device sync when it was passed on the card), then
    the kept indices move to the device with the rest."""
    c = config
    if adapters is not None or adapter_ids is not None:
        raise NotImplementedError(
            "multi-tenant LoRA adapters arrive with a later slice of the "
            "PyTorch port")
    dev = pool.k.device
    nb = pool.num_blocks
    wb_host = write_block.to("cpu", torch.int64)
    keep_host = torch.nonzero(wb_host < nb).squeeze(1)
    keep = keep_host.to(dev)
    wb = wb_host[keep_host].to(dev)
    wo = write_off.to("cpu", torch.int64)[keep_host].to(dev)
    q_tiles = None
    if use_kernel and seq_row.device.type == "cpu" \
            and positions.device.type == "cpu":
        # one KV read per chunked-prefill tile, built on the host (no
        # device sync; well-formed by construction) and moved to the card
        # once for every layer's call, which takes device tiles unchecked
        q_tiles = query_tiles(seq_row, positions,
                              c.num_heads // c.num_kv_heads).to(
                                  dev, non_blocking=True)
    tokens = tokens.to(dev, torch.int64)
    positions = positions.to(dev, torch.int64)
    tables_tok = tables.to(dev, torch.int64)[seq_row.to(dev, torch.int64)]
    tables_tok = tables_tok.to(torch.int32).contiguous()
    lengths = (positions + 1).to(torch.int32)

    x = params["embed"][tokens][:, None, :]            # (T, 1, D)
    cos, sin = rope_cos_sin(positions[:, None], c.head_dim, c.rope_theta,
                            scaling=c.rope_scaling)
    n_hi = pool.hi_layers
    for i in range(c.num_layers):
        lp = _layer_params(params, i)
        if i < n_hi:
            kv = (pool.k_hi[i], pool.v_hi[i], None, None)
        elif pool.quantized:
            j = i - n_hi
            kv = (pool.k[j], pool.v[j], pool.k_scale[j], pool.v_scale[j])
        else:
            kv = (pool.k[i], pool.v[i], None, None)
        x = _paged_layer(c, lp, x, cos, sin, kv[0], kv[1], tables_tok,
                         lengths, keep, wb, wo, use_kernel,
                         k_scale_pool=kv[2], v_scale_pool=kv[3],
                         q_tiles=q_tiles)
    return _logits(params, c, x)[:, 0], pool
