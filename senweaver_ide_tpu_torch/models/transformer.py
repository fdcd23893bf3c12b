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

The paged forward also serves many LoRA tenants in one batch: with an
adapter pool's banks (``rollout/adapter_pool.py``) each entry of the flat
batch adds its own adapter's delta to the q/k/v/o projections
(:func:`_adapter_plan`).

Weight-only int8 params (``models/quantize.py``) run through the same
code: ``_dense`` upcasts an int8 matrix to the activation dtype and
scales the output per channel, and a tied model's head reads the int8
shadow ``tied_head_q8``. Mixture-of-experts configs route each layer's
FFN through ``parallel/expert.py::moe_ffn``; the no-cache forward returns
the summed load-balance loss with ``with_aux=True``.

On a mesh (``forward(mesh=)``, ``parallel/mesh.py``) each rank runs on
its local shards (``parallel/sharding.py::shard_params``) with explicit
collectives that carry their own backward (``parallel/comm.py``): fsdp
weights are all-gathered layer by layer, q/k/v and gate/up are
column-parallel over ``tp`` (``Hq/tp`` and ``Hkv/tp`` local heads, which
the attention kernels take as they are), wo and w_down row-parallel with
an all-reduce, the embedding vocab-parallel, the head's logits
vocab-sharded (:func:`vocab_parallel_logprobs` reduces them), the
sequence split over ``sp`` (ring or Ulysses attention, or K/V gathered
for einsum/flash), MoE experts over ``ep`` and each MoE layer routing
the global batch over the data axes. Pipeline stages over ``pp`` run
this module's layer function from ``parallel/pipeline.py``.
"""

from __future__ import annotations

import dataclasses
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
from ..parallel.comm import (all_gather, all_reduce, copy_to, gather_weight,
                             reduce_from)
from ..parallel.expert import MoEConfig, moe_ffn
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
    }
    if c.num_experts > 0:
        E = c.num_experts
        layers["router"] = dense((L, D, E), D)
        layers["w_gate"] = dense((L, E, D, F), D)
        layers["w_up"] = dense((L, E, D, F), D)
        layers["w_down"] = dense((L, E, F, D), F)
    else:
        layers["w_gate"] = dense((L, D, F), D)
        layers["w_up"] = dense((L, D, F), D)
        layers["w_down"] = dense((L, F, D), F)
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


_COLUMN = ("wq", "wk", "wv", "w_gate", "w_up")
_ROW = ("wo", "w_down")


def tp_local_config(config: ModelConfig, tp: int) -> ModelConfig:
    """The config of one tp rank's slice: ``Hq/tp`` query and ``Hkv/tp``
    KV heads (what its projections, attention and KV cache hold)."""
    if tp == 1:
        return config
    for name, n in (("num_heads", config.num_heads),
                    ("num_kv_heads", config.num_kv_heads),
                    ("vocab_size", config.vocab_size),
                    ("intermediate_size", config.intermediate_size)):
        if n % tp:
            raise ValueError(f"{name}={n} does not split over tp={tp}")
    return dataclasses.replace(config, num_heads=config.num_heads // tp,
                               num_kv_heads=config.num_kv_heads // tp)


class _MeshCtx:
    """One forward's view of the mesh: the local config, which dims to
    all-gather over fsdp, the tp/sp coordinates, and whether the rows are
    this rank's part of the batch over the data axes (``rows_split``: the
    no-cache forward) or the whole batch replicated over them (the cache
    forward)."""

    def __init__(self, mesh, config: ModelConfig, params: Params, *,
                 gather_fsdp: bool = True, rows_split: bool = True):
        from ..parallel.sharding import restrict_spec, spec_for_path
        if mesh.shape.get("pp", 1) > 1:
            raise NotImplementedError(
                "forward(mesh=) does not run pipeline stages (a 'pp' "
                "axis): use parallel.pipeline (pipeline_forward, "
                "pp_train_step)")
        self.mesh = mesh
        self.rows_split = rows_split
        self.tp = mesh.axis_size("tp")
        self.tp_idx = mesh.coord("tp")
        self.sp = mesh.axis_size("sp")
        self.sp_idx = mesh.coord("sp")
        self.config = tp_local_config(config, self.tp)
        gather_fsdp = gather_fsdp and mesh.axis_size("fsdp") > 1

        def fsdp_dim(path, t):
            if not gather_fsdp:
                return None
            spec = restrict_spec(spec_for_path(path, t.ndim), mesh)
            return spec.index("fsdp") if "fsdp" in spec else None

        self.top = {n: fsdp_dim(n, t) for n, t in params.items()
                    if n != "layers"}
        self.layer_dims = {}
        for n, t in params["layers"].items():
            d = fsdp_dim("layers/" + n, t)
            if d is not None:
                self.layer_dims[n] = d - 1        # a layer's slice

    def top_params(self, params: Params) -> Params:
        """The top-level tensors (embed, heads, final norm), gathered."""
        out = dict(params)
        for n, d in self.top.items():
            if d is not None:
                out[n] = gather_weight(params[n], self.mesh, "fsdp", d)
        return out

    def layer(self, lp: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One layer's tensors gathered over fsdp, LoRA factors cut to
        this tp rank's part (B's columns of a column-parallel target, A's
        rows of a row-parallel one)."""
        out = {}
        for n, t in lp.items():
            d = self.layer_dims.get(n)
            if d is not None:
                t = gather_weight(t, self.mesh, "fsdp", d)
            if self.tp > 1 and "_lora_" in n:
                target, leaf = n.rsplit("_lora_", 1)
                if leaf == "b" and target in _COLUMN:
                    part = t.shape[-1] // self.tp
                    t = t.narrow(-1, self.tp_idx * part, part)
                elif leaf == "a" and target in _ROW:
                    part = t.shape[0] // self.tp
                    t = t.narrow(0, self.tp_idx * part, part)
            out[n] = t
        return out

    def embed(self, emb: torch.Tensor, tokens: torch.Tensor
              ) -> torch.Tensor:
        """Vocab-parallel lookup: each rank looks up the tokens of its
        vocab rows (zeros elsewhere), then an all-reduce over tp."""
        if self.tp == 1:
            return emb[tokens]
        rows = emb.shape[0]
        local = tokens - self.tp_idx * rows
        ok = (local >= 0) & (local < rows)
        x = emb[local.clamp(0, rows - 1)] * ok[..., None].to(emb.dtype)
        return reduce_from(x, self.mesh, "tp")


def _tp_in(h, ctx):
    """The input of a column-parallel matmul (its gradient sums over tp)."""
    return h if ctx is None else copy_to(h, ctx.mesh, "tp")


def _tp_out(y, ctx):
    """The output of a row-parallel matmul, summed over tp."""
    return y if ctx is None else reduce_from(y, ctx.mesh, "tp")


def vocab_parallel_logprobs(logits: torch.Tensor, targets: torch.Tensor,
                            mesh=None) -> torch.Tensor:
    """log p(target) from vocab-sharded fp32 logits (B, S, V/tp): the max
    and the sum of exponentials are all-reduced over tp, and the target's
    logit comes from the rank whose rows hold it. The (B, S, V) logits
    are never gathered. Without tp it is ``training.grpo.token_logprobs``."""
    tp = 1 if mesh is None else mesh.axis_size("tp")
    if tp == 1:
        logz = torch.logsumexp(logits, dim=-1)
        tgt = torch.gather(logits, -1, targets[..., None].long())[..., 0]
        return tgt - logz
    v_local = logits.shape[-1]
    m = all_reduce(logits.detach().amax(dim=-1), mesh, "tp", op="max")
    sumexp = reduce_from(torch.exp(logits - m[..., None]).sum(-1), mesh,
                         "tp")
    local = targets.long() - mesh.coord("tp") * v_local
    ok = (local >= 0) & (local < v_local)
    tgt = torch.gather(logits, -1,
                       local.clamp(0, v_local - 1)[..., None])[..., 0]
    tgt = reduce_from(torch.where(ok, tgt, 0.0), mesh, "tp")
    return tgt - (m + torch.log(sumexp))


def _dense(h: torch.Tensor, lp: Dict[str, torch.Tensor],
           name: str) -> torch.Tensor:
    """``h @ lp[name]`` for an ``(in, out)`` weight, plus ``(h @ A) @ B``
    when a merged LoRA adapter (``name + "_lora_a"``/``"_lora_b"``) is
    present: the factored order never materialises the (in, out) delta,
    and the alpha/rank scale is already baked into A.

    An int8 weight (``models/quantize.py``) is upcast to ``h``'s dtype
    for the matmul and its per-output-channel scale (``name +
    "_scale"``) multiplies the fp32 output; the adapter term rides over
    the int8 base (QLoRA)."""
    w = lp[name]
    if w.dtype == torch.int8:
        out = h @ w.to(h.dtype)
        out = (out.float() * lp[name + "_scale"]).to(h.dtype)
    else:
        out = h @ w
    la = lp.get(name + "_lora_a")
    if la is not None:
        out = out + (h @ la) @ lp[name + "_lora_b"]
    return out


class _AdapterTarget(NamedTuple):
    """One target's adapter factors for one paged forward: every rung's
    tenant slots side by side as ``C`` columns, and each entry's column
    mask."""

    a: torch.Tensor          # (L, d_in, C)
    b: torch.Tensor          # (L, C, d_out)
    mask: torch.Tensor       # (T, 1, C): 1 on the entry's slot's columns


def _adapter_plan(adapters, adapter_ids, dev) -> Optional[Dict[str,
                                                              _AdapterTarget]]:
    """Per-target factors and masks for the multi-LoRA delta of one paged
    forward, or None when no entry carries an adapter.

    ``adapters`` is the pool's rank ladder, one bank dict per rung with
    leaves ``(L, slots+1, d_in, r)`` / ``(L, slots+1, r, d_out)``, and
    ``adapter_ids`` the per-rung ``(T,)`` slot ids (0 = the null slot).
    The JAX version gathers ``A[ids]`` and ``B[ids]`` per token (a ``(T,
    d_in, r)`` copy per target, layer and rung); here the tenant slots of
    every rung that this batch uses become the columns of one ``(d_in,
    C)`` matrix, so the delta is two matmuls and a mask: ``((h @ A) *
    mask) @ B``. An entry's mask selects its own slot's ``r`` columns in
    its rung, and nothing for the null slot, so a base row adds exact
    zeros. The ids are read on the host."""
    ids = [torch.as_tensor(x).to("cpu", torch.int64).reshape(-1)
           for x in adapter_ids]
    if len(ids) != len(adapters):
        raise ValueError(f"{len(ids)} adapter id vectors for "
                         f"{len(adapters)} rungs")
    live = [j for j, i in enumerate(ids) if bool((i > 0).any())]
    if not live:
        return None
    t = ids[0].shape[0]
    # one (T, slots * r) column mask a live rung; its leaves share a shape
    rung_mask = {}
    for j in live:
        a = next(v for n, v in adapters[j].items() if n.endswith("_lora_a"))
        slots1, r = a.shape[1], a.shape[3]
        m = torch.zeros((t, slots1 - 1, r), dtype=a.dtype)
        sel = ids[j] > 0
        m[sel, ids[j][sel] - 1] = 1
        rung_mask[j] = m.reshape(t, (slots1 - 1) * r)
    names = sorted({n[:-len("_lora_a")] for bank in adapters for n in bank
                    if n.endswith("_lora_a")})
    plan, masks = {}, {}
    for name in names:
        rungs = tuple(j for j in live if name + "_lora_a" in adapters[j])
        if not rungs:
            continue
        if rungs not in masks:
            masks[rungs] = torch.cat([rung_mask[j] for j in rungs],
                                     dim=-1)[:, None].to(dev)
        a_cols, b_rows = [], []
        for j in rungs:
            a = adapters[j][name + "_lora_a"]
            b = adapters[j][name + "_lora_b"]
            n_layers, slots1, d_in, r = a.shape
            n = (slots1 - 1) * r
            a_cols.append(a[:, 1:].permute(0, 2, 1, 3).reshape(
                n_layers, d_in, n))
            b_rows.append(b[:, 1:].reshape(n_layers, n, b.shape[-1]))
        plan[name] = _AdapterTarget(a=torch.cat(a_cols, dim=-1),
                                    b=torch.cat(b_rows, dim=1),
                                    mask=masks[rungs])
    return plan or None


def _with_adapter(out: torch.Tensor, h: torch.Tensor, ad,
                  name: str) -> torch.Tensor:
    """``out`` plus the entries' adapter deltas for target ``name``;
    ``ad`` is ``(plan, layer)`` from :func:`_adapter_plan`, or None."""
    if ad is None:
        return out
    plan, i = ad
    tgt = plan.get(name)
    if tgt is None:
        return out
    return out + ((h @ tgt.a[i]) * tgt.mask) @ tgt.b[i]


def _qkv(c: ModelConfig, lp: Dict[str, torch.Tensor], h: torch.Tensor,
         cos: torch.Tensor, sin: torch.Tensor, ad=None):
    """Project + rotate. h (B, S, D) → q (B,S,Hq,Dh), k/v (B,S,Hkv,Dh).
    Per-entry adapter deltas (``ad``, paged forward only) land where the
    merged-LoRA hook of ``_dense`` does: after the base matmul, before
    bias, norm and rope."""
    b, s, _ = h.shape
    q = _with_adapter(_dense(h, lp, "wq"), h, ad, "wq")
    k = _with_adapter(_dense(h, lp, "wk"), h, ad, "wk")
    v = _with_adapter(_dense(h, lp, "wv"), h, ad, "wv")
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


_MOE_KEYS = ("router", "w_gate", "w_up", "w_down", "w_gate_scale",
             "w_up_scale", "w_down_scale")


def _mlp(c: ModelConfig, lp: Dict[str, torch.Tensor],
         x: torch.Tensor, ctx=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x + FFN(norm(x)), the layer's MoE load-balance loss). The FFN is
    silu-gated with SiLU in fp32, dense or routed over experts (the loss
    is a zero scalar for a dense layer). On a mesh (``ctx``) gate/up are
    column- and w_down row-parallel over tp; experts split over ep."""
    h = rms_norm(x, lp["mlp_norm"], c.rms_norm_eps)
    if c.num_experts > 0:
        moe_cfg = MoEConfig(hidden_size=c.hidden_size,
                            intermediate_size=c.intermediate_size,
                            num_experts=c.num_experts,
                            top_k=c.num_experts_per_tok,
                            capacity_factor=c.expert_capacity_factor,
                            dtype=c.dtype)
        out, aux = moe_ffn({n: lp[n] for n in _MOE_KEYS if n in lp},
                           moe_cfg, h,
                           mesh=None if ctx is None else ctx.mesh,
                           rows_split=ctx is not None and ctx.rows_split)
        return x + out, aux
    h = _tp_in(h, ctx)
    gate = _dense(h, lp, "w_gate")
    up = _dense(h, lp, "w_up")
    act = torch.nn.functional.silu(gate.float()).to(x.dtype) * up
    return (x + _tp_out(_dense(act, lp, "w_down"), ctx),
            torch.zeros((), dtype=torch.float32, device=x.device))


def _logits(params: Params, c: ModelConfig, x: torch.Tensor,
            ctx=None) -> torch.Tensor:
    """fp32 logits; on a tp mesh this rank's vocab columns."""
    x = _tp_in(rms_norm(x, params["final_norm"], c.rms_norm_eps), ctx)
    head = params.get("lm_head")
    if head is not None:
        logits = _dense(x, params, "lm_head")
    elif "tied_head_q8" in params:
        # int8 shadow of the tied embed table (models/quantize.py), one
        # scale per vocab row: the head's output channel
        w = params["tied_head_q8"]
        logits = ((x @ w.to(x.dtype).T).float()
                  * params["tied_head_q8_scale"]).to(x.dtype)
    else:  # tied embeddings
        logits = x @ params["embed"].T
    return logits.float()


def _self_attention(c: ModelConfig, q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor, kv_mask: Optional[torch.Tensor],
                    ctx=None) -> torch.Tensor:
    """No-cache attention per ``c.attn_impl``. q (B,S,Hq,Dh), k/v
    (B,S,Hkv,Dh) → (B,S,Hq,Dh): this rank's sequence chunk on an sp
    mesh, where ring/ulysses shard the attention and einsum/flash attend
    the chunk's queries to K/V (and the mask) gathered over sp."""
    sp = 1 if ctx is None else ctx.sp
    if c.attn_impl in ("einsum", "flash"):
        q_offset = 0
        if sp > 1:
            q_offset = ctx.sp_idx * q.shape[1]
            k = gather_weight(k, ctx.mesh, "sp", 1)
            v = gather_weight(v, ctx.mesh, "sp", 1)
            if kv_mask is not None:
                kv_mask = all_gather(kv_mask, ctx.mesh, "sp", 1)
        fn = attention if c.attn_impl == "einsum" else flash_attention
        return fn(q, k, v, q_offset=q_offset, kv_mask=kv_mask, causal=True,
                  window=c.sliding_window)
    if c.sliding_window is not None:
        raise NotImplementedError(
            f"sliding_window is implemented for attn_impl='einsum'/'flash' "
            f"only (got {c.attn_impl!r}); the ring kernels would silently "
            f"attend outside the window")
    if c.attn_impl in ("ring", "ulysses"):
        from ..parallel.ring_attention import (ring_attention,
                                               ulysses_attention)
        mesh = None if ctx is None else ctx.mesh
        if mesh is None or "sp" not in mesh.axis_names:
            raise ValueError(
                f"attn_impl={c.attn_impl!r} needs forward(mesh=...) with an "
                f"'sp' axis; got {mesh}")
        if c.attn_impl == "ulysses":
            if kv_mask is not None:
                raise NotImplementedError(
                    "ulysses attention does not take a kv mask; pre-mask "
                    "k/v or use attn_impl='ring'")
            return ulysses_attention(q, k, v, mesh=mesh)
        return ring_attention(q, k, v, mesh=mesh, kv_mask=kv_mask)
    raise ValueError(f"unknown attn_impl {c.attn_impl!r}; expected "
                     f"einsum|flash|ring|ulysses")


def _layer(c: ModelConfig, lp: Dict[str, torch.Tensor], x: torch.Tensor,
           cos: torch.Tensor, sin: torch.Tensor,
           attn_mask: Optional[torch.Tensor], ctx=None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One no-cache transformer block. x: (B, S, D) → (x', MoE aux). On a
    mesh, ``c`` is the tp-local config and ``lp`` the local shards."""
    if ctx is not None:
        lp = ctx.layer(lp)
    b, s, _ = x.shape
    h = rms_norm(x, lp["attn_norm"], c.rms_norm_eps)
    q, k, v = _qkv(c, lp, _tp_in(h, ctx), cos, sin)
    out = _self_attention(c, q, k, v, attn_mask, ctx)
    x = x + _tp_out(_dense(out.reshape(b, s, c.q_dim), lp, "wo"), ctx)
    return _mlp(c, lp, x, ctx)


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
                 kv_mask: torch.Tensor, flash_decode_ok: bool, ctx=None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One transformer block over one layer of the contiguous cache →
    (x', MoE aux).

    ``kv`` is ``(k_cache, v_cache)`` or, for the int8 cache, ``(k_cache,
    v_cache, k_scale, v_scale)``; the block's new k/v (quantized, for the
    int8 cache) are written IN PLACE at ``length``, then the block attends
    over the cache (dequantized to the compute dtype for the int8 cache).
    A ring chunk of s > 1 tokens attends BEFORE writing, over [pre-write
    cache ‖ chunk] (the chunk's own k/v unquantized), since a wrapping
    chunk's writes would destroy keys still inside earlier queries'
    windows; with a chunk-width mask (fresh cache) it attends over the
    chunk alone. On a tp mesh (``ctx``) the cache holds this rank's KV
    heads."""
    b, s, _ = x.shape
    h = rms_norm(x, lp["attn_norm"], c.rms_norm_eps)
    q, k, v = _qkv(c, lp, _tp_in(h, ctx), cos, sin)
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
    x = x + _tp_out(_dense(out.reshape(b, s, c.q_dim), lp, "wo"), ctx)
    return _mlp(c, lp, x, ctx)


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
            fresh_cache: bool = False, mesh=None,
            logits_at: Optional[torch.Tensor] = None):
    """Run the model over ``tokens`` (B, S).

    Without a cache: full causal self-attention → fp32 logits (B, S, V)
    (the JAX ``forward`` returns ``(logits, None)`` there; the port
    returns the logits alone). ``positions`` (B, S) are the absolute RoPE
    positions (default ``0..S-1``); ``attn_mask`` (B, S) marks valid keys.
    ``with_aux=True`` returns ``(logits, None, aux)`` as JAX does, ``aux``
    being the MoE load-balance loss summed over layers, a zero scalar for
    dense models. A truthy ``config.remat`` recomputes each layer in the
    backward (``torch.utils.checkpoint``, non-reentrant) instead of
    holding its activations; ``"dots"`` behaves as ``True`` (the port
    keeps no per-op save policy). The recompute runs the layer's
    attention forward a second time.

    With ``cache`` (a :class:`KVCache`): the tokens are appended at
    ``cache.length`` (positions default to ``length + 0..S-1``) and attend
    to everything up to them; prefill and decode take the same path.
    Returns ``(logits, new_cache)``, or ``(logits, new_cache, aux)`` with
    ``with_aux``, as JAX does. The cache's k/v (and scale) tensors are
    updated IN PLACE (the JAX version donates them and returns new ones):
    ``new_cache`` holds the same tensors with ``length + S``. ``attn_mask``
    is then (B, Smax) over the cache, and ``fresh_cache`` promises the
    cache holds nothing yet, so a ring-cache chunk attends over itself
    alone.

    With a ``mesh`` (``parallel/mesh.py``) every argument is this rank's
    part: ``params`` its shards (``shard_params``), ``tokens`` and
    ``attn_mask`` its rows (over dp/fsdp) and sequence chunk (over sp;
    positions default to the chunk's absolute ones), and the no-cache
    logits its (B_local, S_local, V/tp) block of JAX's global logits.
    The cache forward on a mesh is the tensor-parallel serving path: the
    params are sharded over tp alone, the cache holds this rank's KV
    heads (``tp_local_config``), rows are replicated (an MoE layer routes
    them as one batch, as one rank would), and the logits are
    all-gathered over tp to the full vocabulary for sampling.

    ``logits_at`` (cache forward only; an int or a (B,) tensor of
    positions) returns each row's logits at that position alone, (B, V):
    only those rows go through the head (and, on a tp mesh, the
    all-gather)."""
    c = config
    b, s = tokens.shape
    ctx = None
    if mesh is not None:
        ctx = _MeshCtx(mesh, config, params, gather_fsdp=cache is None,
                       rows_split=cache is None)
        if cache is not None and ctx.sp > 1:
            raise ValueError("the cache forward does not split the "
                             "sequence over sp")
        c = ctx.config
        params = ctx.top_params(params)
        x = ctx.embed(params["embed"], tokens)
    else:
        x = params["embed"][tokens]
    if positions is None:
        base = torch.zeros((), dtype=torch.int32, device=tokens.device)
        if ctx is not None and ctx.sp > 1:
            base = base + ctx.sp_idx * s
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
        aux = zero
        for i in range(c.num_layers):
            kv = (cache.k[i], cache.v[i])
            if cache.quantized:
                kv += (cache.k_scale[i], cache.v_scale[i])
            x, layer_aux = _cache_layer(c, _layer_params(params, i), x, cos,
                                        sin, kv, cache.length, valid,
                                        flash_ok, ctx)
            aux = aux + layer_aux
        new_cache = cache._replace(length=cache.length + s)
        if logits_at is not None:
            at = torch.as_tensor(logits_at, device=x.device).long()
            x = x[torch.arange(b, device=x.device),
                  at.reshape(-1).expand(b)][:, None]
        logits = _logits(params, c, x, ctx)
        if ctx is not None and ctx.tp > 1:
            logits = all_gather(logits, mesh, "tp", -1)
        if logits_at is not None:
            logits = logits[:, 0]
        return (logits, new_cache, aux) if with_aux else (logits, new_cache)
    remat = bool(c.remat) and torch.is_grad_enabled()
    # One unbind per stacked tensor: its backward stacks the L per-layer
    # gradients once, where a view per layer (v[i]) would have autograd
    # build and add a full (L, ...) zero-padded gradient for every layer.
    layers = {k: torch.unbind(v) for k, v in params["layers"].items()}
    aux = zero
    for i in range(c.num_layers):
        lp = {k: v[i] for k, v in layers.items()}
        if remat:
            x, layer_aux = checkpoint(_layer, c, lp, x, cos, sin, attn_mask,
                                      ctx, use_reentrant=False)
        else:
            x, layer_aux = _layer(c, lp, x, cos, sin, attn_mask, ctx)
        aux = aux + layer_aux
    logits = _logits(params, c, x, ctx)
    if with_aux:
        return logits, None, aux
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
                 q_tiles: Optional[torch.Tensor] = None,
                 ad=None) -> torch.Tensor:
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
    (``ops.paged_attention.query_tiles``), or None; ``ad`` the entries'
    adapter deltas (:func:`_with_adapter`), or None. An MoE layer routes
    the whole flat batch, padding entries included, and its aux loss is
    dropped, as the JAX paged forward drops it."""
    t = x.shape[0]
    h = rms_norm(x, lp["attn_norm"], c.rms_norm_eps)
    q, k, v = _qkv(c, lp, h, cos, sin, ad)   # q (T,1,Hq,Dh), k/v (T,1,Hkv,Dh)
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
    attn_in = out.reshape(t, 1, c.q_dim)
    x = x + _with_adapter(_dense(attn_in, lp, "wo"), attn_in, ad, "wo")
    return _mlp(c, lp, x)[0]


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
    adapters=None,                # per-rung LoRA bank dicts, leading L
    adapter_ids=None,             # per-rung (T,) int slot ids (0 = none)
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
    the kept indices move to the device with the rest.

    With an adapter pool (``rollout/adapter_pool.py``), ``adapters`` is
    its tuple of per-rung bank dicts (``AdapterPool.banks()``) and
    ``adapter_ids`` the per-rung ``(T,)`` slot id of every entry; each
    entry adds its own adapter's delta to q/k/v/o (see
    :func:`_adapter_plan`), a null-slot entry exactly nothing."""
    c = config
    if (adapters is None) != (adapter_ids is None):
        raise ValueError("pass adapters and adapter_ids together")
    dev = pool.k.device
    plan = (None if adapters is None
            else _adapter_plan(adapters, adapter_ids, dev))
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
                         q_tiles=q_tiles,
                         ad=None if plan is None else (plan, i))
    return _logits(params, c, x)[:, 0], pool
