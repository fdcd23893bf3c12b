"""Decoder-only transformer in PyTorch: the no-cache forward and the
paged forward the serving engine runs.

Parameters keep the JAX package's layout so the two can be held against
each other on the same weights: a plain dict of layer-STACKED tensors
(leading axis L) with ``(in, out)`` projection matrices, so ``x @ W``
is the JAX ``einsum("bsd,de->bse")``. The layer loop is a Python loop
over views of the stacked tensors (the JAX version scans).

The no-cache forward is also the training forward: ``attn_impl="flash"``
runs the flash-attention kernels (``ops/flash_attention.py``, forward and
backward), ``remat`` recomputes each layer in the backward, and merged
LoRA adapters (``training/lora.py``) ride in the layer dict.

Out of this slice, and raising ``NotImplementedError`` where reached:
mixture-of-experts FFNs, int8 weights (later slices), the contiguous
KV-cache path (the slot-layout slice) and the ring/ulysses attention
(the parallel-layout slice).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..ops.attention import attention
from ..ops.flash_attention import flash_attention
from ..ops.norms import rms_norm
from ..ops.paged_attention import (paged_flash_decode,
                                   paged_flash_decode_plain)
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


def forward(params: Params, config: ModelConfig, tokens: torch.Tensor, *,
            positions: Optional[torch.Tensor] = None,
            attn_mask: Optional[torch.Tensor] = None,
            with_aux: bool = False, cache=None):
    """Full causal self-attention over ``tokens`` (B, S) → fp32 logits
    (B, S, V): the no-cache path of the JAX ``forward`` (which returns
    ``(logits, None)`` there). ``positions`` (B, S) are the absolute
    RoPE positions (default ``0..S-1``); ``attn_mask`` (B, S) marks valid
    keys. ``with_aux=True`` returns ``(logits, None, aux)`` as JAX does,
    ``aux`` being the MoE load-balance loss, a zero scalar for dense
    models.

    A truthy ``config.remat`` recomputes each layer in the backward
    (``torch.utils.checkpoint``, non-reentrant) instead of holding its
    activations; ``"dots"`` behaves as ``True`` (the port keeps no
    per-op save policy). The recompute runs the layer's attention
    forward a second time."""
    c = config
    if cache is not None:
        raise NotImplementedError(
            "the contiguous KV-cache forward belongs to the slot-layout "
            "slice of the PyTorch port; serve through forward_paged")
    b, s = tokens.shape
    x = params["embed"][tokens]
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=tokens.device)[None, :].expand(b, s)
    cos, sin = rope_cos_sin(positions, c.head_dim, c.rope_theta,
                            scaling=c.rope_scaling)
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
        return logits, None, torch.zeros((), dtype=torch.float32,
                                         device=logits.device)
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
                 v_scale_pool: Optional[torch.Tensor] = None
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
    ``positions + 1``."""
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
                 k_scale_pool, v_scale_pool)
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
                         k_scale_pool=kv[2], v_scale_pool=kv[3])
    return _logits(params, c, x)[:, 0], pool
