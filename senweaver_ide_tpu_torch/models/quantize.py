"""Weight-only int8 quantization for serving (PyTorch port).

The dense matmul weights are stored as int8 with one fp32 scale per
OUTPUT channel (absmax over the contraction axis, ``max(absmax, 1e-8) /
127``, rounded half to even and clipped to ±127): the values equal the JAX
package's bit for bit. ``transformer._dense`` upcasts the int8 matrix to
the activation dtype at use and applies the scale to the output.

Scope: the seven stacked per-layer dense matrices, ``lm_head`` and the
4-D MoE expert banks (per-expert per-output-channel scales). Left out on
purpose: norms and biases (tiny, precision-critical), the MoE router
(routing decisions are precision-sensitive and the matrix is tiny) and
``embed`` (a gather; a tied model keeps it and gains an int8 shadow,
``tied_head_q8``, for the head matmul).

This is a SERVING transform: quantized params are not differentiable and
must never enter ``train_step`` as trained params (an int8 LoRA base is
fine: QLoRA). ``RolloutEngine.update_params`` re-applies it on publish
when the engine serves int8 weights.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

# Stacked (L, in, out) layer matrices + the 2-D head; in all of them the
# contraction axis is -2, so per-output-channel absmax is over axis=-2.
QUANTIZABLE = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def dense_family_shapes(config) -> Dict[str, tuple]:
    """(fan_in, out) per dense family for a NON-MoE config."""
    c = config
    if c.num_experts > 0:
        raise ValueError("dense_family_shapes: MoE configs carry (L, E, "
                         "in, out) expert banks — size those explicitly")
    D, F = c.hidden_size, c.intermediate_size
    q_dim, kv_dim = c.q_dim, c.kv_dim
    return {"wq": (D, q_dim), "wk": (D, kv_dim), "wv": (D, kv_dim),
            "wo": (q_dim, D), "w_gate": (D, F), "w_up": (D, F),
            "w_down": (F, D)}


def _quantize_block(w: torch.Tensor, dim: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Absmax int8 over ``dim`` of one block: fp32 math as JAX does it
    (``round`` is half to even on both sides)."""
    wf = w.to(torch.float32, copy=True)      # divided in place below
    scale = torch.clamp_min(wf.abs().amax(dim=dim), 1e-8) / 127.0
    q = wf.div_(scale.unsqueeze(dim)).round_().clamp_(-127, 127)
    return q.to(torch.int8), scale


def _quantize_matrix(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(…, in, out) → int8 values + fp32 (…, out) per-channel scales.

    Works one layer (with its experts) at a time, so the fp32 transient
    is one layer's slice (the JAX version upcasts the whole tensor: for
    Qwen3-30B-A3B's stacked ``w_gate`` that would be 38.65 GB). The absmax
    is taken within each matrix, so chunking changes no value."""
    if w.ndim == 2:
        return _quantize_block(w, -2)
    q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
    scale = torch.empty(w.shape[:-2] + w.shape[-1:], dtype=torch.float32,
                        device=w.device)
    for i in range(w.shape[0]):
        q[i], scale[i] = _quantize_block(w[i], -2)
    return q, scale


def quantize_weights_int8(params: Dict) -> Dict:
    """Return a new param dict with the dense weights int8-quantized.

    Idempotent (int8 tensors pass through); anything outside QUANTIZABLE
    (router, norms, biases, embed) is left untouched. The input's tensors
    are not modified."""
    out = dict(params)
    layers = dict(params["layers"])
    for name in QUANTIZABLE:
        w = layers.get(name)
        # 3-D: stacked dense (L, in, out); 4-D: stacked MoE expert banks
        # (L, E, in, out)
        if w is None or w.dtype == torch.int8 or w.ndim not in (3, 4):
            continue
        layers[name], layers[name + "_scale"] = _quantize_matrix(w)
    out["layers"] = layers
    head = params.get("lm_head")
    if head is not None and head.dtype != torch.int8:
        out["lm_head"], out["lm_head_scale"] = _quantize_matrix(head)
    elif head is None and "tied_head_q8" not in params:
        # Tied embeddings: keep the full-width embed for the gather and
        # store an int8 SHADOW with per-vocab-row scales (absmax over D)
        # for the head matmul, read as (D, V) by _dense
        out["tied_head_q8"], out["tied_head_q8_scale"] = _quantize_rows(
            params["embed"])
    return out


def _quantize_rows(emb: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(V, D) → int8 (V, D) + fp32 (V,) per-row scales, in row chunks."""
    q = torch.empty(emb.shape, dtype=torch.int8, device=emb.device)
    scale = torch.empty(emb.shape[:1], dtype=torch.float32,
                        device=emb.device)
    step = 16384
    for i in range(0, emb.shape[0], step):
        q[i:i + step], scale[i:i + step] = _quantize_block(
            emb[i:i + step], -1)
    return q, scale


def is_quantized(params: Dict) -> bool:
    w = params.get("layers", {}).get("wq")
    return w is not None and w.dtype == torch.int8


def quantized_bytes(params: Dict) -> int:
    """Bytes of every tensor of a (nested) param dict."""
    if isinstance(params, torch.Tensor):
        return params.numel() * params.element_size()
    return sum(quantized_bytes(v) for v in params.values())
