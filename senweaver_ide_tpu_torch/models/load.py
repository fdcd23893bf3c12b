"""Weights in and out: HF-layout safetensors and the numpy bridge.

:func:`load_hf_params` reads a locally downloaded HuggingFace model
directory (one ``model.safetensors`` or an index-sharded set) into the
layer-stacked param dict ``models/transformer.py`` consumes, and
:func:`export_hf_params` writes that dict back as one
``model.safetensors`` with the HF key set. The conventions bridged:

- torch ``nn.Linear`` stores (out_features, in_features); the port's
  weights are (in, out), so every projection transposes;
- per-layer HF tensors (``model.layers.{i}.…``) stack on a leading L
  axis, on the device, one layer at a time (no host-side stack of the
  whole tree);
- RoPE: both sides use the rotate_half layout, so q/k need no row
  permutation.

Families: Qwen2/Qwen2.5 (GQA + QKV bias, tied or untied head), Qwen3
(QK-norm), LLaMA-architecture DeepSeek-Coder, Llama-3.x (rope scaling),
Mistral, and both MoE layouts (Mixtral ``block_sparse_moe`` and
Qwen3-MoE ``mlp.experts``; the port's forward has no MoE yet, so those
trees are for storage). Files go through the port's own codec
(``models/safetensors_io.py``).

:func:`params_from_numpy` takes the JAX ``init_params`` tree as host
arrays (``jax.device_get``) and returns the dict of stacked tensors that
``models/transformer.py`` consumes; a LoRA adapter tree from the JAX
``init_lora`` (``{"layers": {"wq_lora_a": (L, in, r), ...}}``) converts
the same way, for ``training/lora.py``. The layout is unchanged: projection
weights stay ``(in, out)`` and layer tensors keep their leading L axis,
so no transpose happens and ``x @ W`` computes what the JAX einsums do.
"""

from __future__ import annotations

import os
from typing import Dict, List, Mapping, Optional

import numpy as np
import torch

from ..device import resolve_device
from .config import ModelConfig
from .safetensors_io import SafetensorsReader, safetensor_files, save_file
from .transformer import Params

__all__ = ["available_hf_keys", "export_hf_params", "load_hf_params",
           "params_from_numpy"]

# numpy extension dtypes (ml_dtypes) torch.from_numpy cannot take:
# reinterpret their bits as a same-width integer array, then view back.
_BIT_VIEWS = {
    "bfloat16": (np.uint16, torch.bfloat16),
    "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
}


def _to_tensor(a, device, dtype) -> torch.Tensor:
    # a private, writable, contiguous copy: the source may be a read-only
    # view of another framework's buffer
    a = np.array(a, order="C", copy=True)
    view = _BIT_VIEWS.get(a.dtype.name)
    if view is not None:
        t = torch.from_numpy(a.view(view[0])).view(view[1])
    else:
        t = torch.from_numpy(a)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_numpy(tree: Mapping, *, device="cuda",
                      dtype: Optional[torch.dtype] = None) -> Params:
    """Convert a nested mapping of numpy arrays to torch tensors on
    ``device``. ``dtype`` casts every floating tensor (None keeps each
    array's own dtype)."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, Mapping):
            return {k: conv(v) for k, v in node.items()}
        return _to_tensor(node, dev, dtype)

    return conv(tree)


def available_hf_keys(model_dir: str) -> List[str]:
    """Tensor names present in the checkpoint (from the headers)."""
    with SafetensorsReader(safetensor_files(model_dir)) as r:
        return sorted(r.keys())


class _Source:
    """The checkpoint's tensors not yet consumed, read one at a time onto
    ``device`` in ``dtype``."""

    def __init__(self, reader: SafetensorsReader, device, dtype):
        self.reader, self.device, self.dtype = reader, device, dtype
        self.remaining = dict.fromkeys(reader.keys())

    def take(self, key: str, shape) -> torch.Tensor:
        if key not in self.remaining:
            close = [k for k in self.remaining
                     if key.rsplit(".", 2)[-2] in k][:5]
            raise KeyError(f"checkpoint is missing {key!r}; nearby keys: "
                           f"{close}")
        del self.remaining[key]
        got = self.reader.shape(key)
        if got != tuple(shape):
            raise ValueError(f"{key}: checkpoint shape {got} != expected "
                             f"{tuple(shape)} for this ModelConfig")
        return self.reader.get(key, self.device).to(self.dtype)

    def stacked(self, fmt: str, shape, transpose: bool, n: int
                ) -> torch.Tensor:
        """``fmt.format(i=i)`` for i < n, each transposed if asked, into
        one (n, ...) tensor filled row by row on the device."""
        out = None
        for i in range(n):
            t = self.take(fmt.format(i=i), shape)
            t = t.T if transpose else t
            if out is None:
                out = torch.empty((n,) + tuple(t.shape), dtype=self.dtype,
                                  device=self.device)
            out[i].copy_(t)
        return out


# Expert-bank key wiring per HF MoE family: (module base, gate, up, down).
_MOE_LAYOUTS = {
    "mixtral": ("block_sparse_moe", "w1", "w3", "w2"),
    "qwen3": ("mlp", "gate_proj", "up_proj", "down_proj"),
}


def load_hf_params(model_dir: str, config: ModelConfig, *,
                   dtype: Optional[torch.dtype] = None, strict: bool = True,
                   device="cuda") -> Params:
    """Read an HF-layout safetensors dir into the stacked param dict, on
    ``device`` in ``dtype`` (default ``config.dtype``).

    ``strict`` rejects leftover (unconsumed) checkpoint tensors, which
    catches weights silently ignored on an architecture mismatch;
    ``rotary_emb.inv_freq`` buffers are derived, not parameters, and are
    never counted as leftovers."""
    c = config
    dev = resolve_device(device)
    with SafetensorsReader(safetensor_files(model_dir)) as reader:
        src = _Source(reader, dev, dtype or c.dtype)
        D, F, L, V = (c.hidden_size, c.intermediate_size, c.num_layers,
                      c.vocab_size)

        def stacked(fmt, shape, transpose):
            return src.stacked(fmt, shape, transpose, L)

        p = "model.layers.{i}."
        layers: Dict[str, torch.Tensor] = {
            "attn_norm": stacked(p + "input_layernorm.weight", (D,), False),
            "wq": stacked(p + "self_attn.q_proj.weight", (c.q_dim, D), True),
            "wk": stacked(p + "self_attn.k_proj.weight", (c.kv_dim, D),
                          True),
            "wv": stacked(p + "self_attn.v_proj.weight", (c.kv_dim, D),
                          True),
            "wo": stacked(p + "self_attn.o_proj.weight", (D, c.q_dim), True),
            "mlp_norm": stacked(p + "post_attention_layernorm.weight", (D,),
                                False),
        }
        if c.num_experts > 0:
            # Two HF MoE layouts, detected from the checkpoint keys:
            #   mixtral: block_sparse_moe.gate + experts.N.{w1,w3,w2}
            #   qwen3-moe: mlp.gate + experts.N.{gate,up,down}_proj
            # Router is (E, D) in both; expert matrices (F, D)/(D, F).
            E = c.num_experts
            qwen3_moe = "model.layers.0.mlp.gate.weight" in reader
            base, g_key, u_key, d_key = _MOE_LAYOUTS[
                "qwen3" if qwen3_moe else "mixtral"]
            layers["router"] = stacked(p + base + ".gate.weight", (E, D),
                                       True)

            def experts(sub: str, shape) -> torch.Tensor:
                # per layer, its E experts stacked the way layers are
                return torch.stack([src.stacked(
                    f"model.layers.{i}.{base}.experts.{{i}}.{sub}.weight",
                    shape, True, E) for i in range(L)])  # (L, E, in, out)

            layers["w_gate"] = experts(g_key, (F, D))
            layers["w_up"] = experts(u_key, (F, D))
            layers["w_down"] = experts(d_key, (D, F))
        else:
            layers["w_gate"] = stacked(p + "mlp.gate_proj.weight", (F, D),
                                       True)
            layers["w_up"] = stacked(p + "mlp.up_proj.weight", (F, D), True)
            layers["w_down"] = stacked(p + "mlp.down_proj.weight", (D, F),
                                       True)
        if c.qkv_bias:
            layers["bq"] = stacked(p + "self_attn.q_proj.bias", (c.q_dim,),
                                   False)
            layers["bk"] = stacked(p + "self_attn.k_proj.bias", (c.kv_dim,),
                                   False)
            layers["bv"] = stacked(p + "self_attn.v_proj.bias", (c.kv_dim,),
                                   False)
        if c.qk_norm:
            layers["q_norm"] = stacked(p + "self_attn.q_norm.weight",
                                       (c.head_dim,), False)
            layers["k_norm"] = stacked(p + "self_attn.k_norm.weight",
                                       (c.head_dim,), False)

        params: Params = {
            "embed": src.take("model.embed_tokens.weight", (V, D)),
            "layers": layers,
            "final_norm": src.take("model.norm.weight", (D,)),
        }
        if not c.tie_word_embeddings:
            # Some tied-embedding exports still materialize lm_head; only
            # consume it when the config expects a separate head.
            params["lm_head"] = src.take("lm_head.weight",
                                         (V, D)).T.contiguous()
        else:
            src.remaining.pop("lm_head.weight", None)
        leftover = [k for k in src.remaining
                    if not k.endswith("rotary_emb.inv_freq")]
    if leftover and strict:
        raise ValueError(
            f"{len(leftover)} unconsumed checkpoint tensors (architecture "
            f"mismatch?): {leftover[:8]}")
    return params


def _is_quantized(params: Params) -> bool:
    w = params.get("layers", {}).get("wq")
    return w is not None and w.dtype == torch.int8


def export_hf_params(params: Params, config: ModelConfig,
                     out_dir: str) -> str:
    """Write the stacked dict back as one HF-layout ``model.safetensors``:
    the round-trip partner of :func:`load_hf_params` (a GRPO-tuned policy
    served by any HF-ecosystem runtime). Each tensor is copied to the
    host on its own while the file is written."""
    if _is_quantized(params):
        # transposing the +/-127 codes without their scales would write a
        # garbage checkpoint that loads cleanly elsewhere
        raise TypeError("export_hf_params received int8-quantized params "
                        "(quantization is a serving transform); export the "
                        "full-precision train-state params")
    c = config
    if c.num_experts > 0 and c.moe_layout not in _MOE_LAYOUTS:
        raise ValueError(f"unknown moe_layout {c.moe_layout!r}; "
                         f"available: {sorted(_MOE_LAYOUTS)}")
    os.makedirs(out_dir, exist_ok=True)
    lp = params["layers"]
    tt = lambda x: x.T                               # noqa: E731
    out: Dict[str, torch.Tensor] = {
        "model.embed_tokens.weight": params["embed"],
        "model.norm.weight": params["final_norm"],
    }
    if "lm_head" in params:
        out["lm_head.weight"] = tt(params["lm_head"])
    for i in range(c.num_layers):
        p = f"model.layers.{i}."
        out[p + "input_layernorm.weight"] = lp["attn_norm"][i]
        out[p + "self_attn.q_proj.weight"] = tt(lp["wq"][i])
        out[p + "self_attn.k_proj.weight"] = tt(lp["wk"][i])
        out[p + "self_attn.v_proj.weight"] = tt(lp["wv"][i])
        out[p + "self_attn.o_proj.weight"] = tt(lp["wo"][i])
        out[p + "post_attention_layernorm.weight"] = lp["mlp_norm"][i]
        if c.num_experts > 0:
            base, g_key, u_key, d_key = _MOE_LAYOUTS[c.moe_layout]
            out[p + base + ".gate.weight"] = tt(lp["router"][i])
            for e in range(c.num_experts):
                ep = p + f"{base}.experts.{e}."
                out[ep + g_key + ".weight"] = tt(lp["w_gate"][i, e])
                out[ep + u_key + ".weight"] = tt(lp["w_up"][i, e])
                out[ep + d_key + ".weight"] = tt(lp["w_down"][i, e])
        else:
            out[p + "mlp.gate_proj.weight"] = tt(lp["w_gate"][i])
            out[p + "mlp.up_proj.weight"] = tt(lp["w_up"][i])
            out[p + "mlp.down_proj.weight"] = tt(lp["w_down"][i])
        if c.qkv_bias:
            out[p + "self_attn.q_proj.bias"] = lp["bq"][i]
            out[p + "self_attn.k_proj.bias"] = lp["bk"][i]
            out[p + "self_attn.v_proj.bias"] = lp["bv"][i]
        if c.qk_norm:
            out[p + "self_attn.q_norm.weight"] = lp["q_norm"][i]
            out[p + "self_attn.k_norm.weight"] = lp["k_norm"][i]
    path = os.path.join(out_dir, "model.safetensors")
    save_file(out, path)
    return path
