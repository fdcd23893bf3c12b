"""LoRA adapters for GRPO fine-tuning (PyTorch port).

The adapter tree is shaped like the layer stack, ``{"layers":
{"wq_lora_a": (L, in, r), "wq_lora_b": (L, r, out), ...}}``; B starts at
zero, so the adapted model equals the base at init, and the alpha/rank
scale is baked into A. ``merge_lora`` is a dict union that
``models/transformer.py::_dense`` reads as ``y += (h @ A) @ B``;
``train_step(..., lora_base=base)`` trains the adapters only.

bf16 and fp32 bases only: an int8 base (QLoRA) and the PEFT adapter
export/import arrive with later slices of the port.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from ..device import resolve_device
from ..models.config import ModelConfig

# (in_dim, out_dim) per supported target matrix
_TARGET_DIMS = {
    "wq": lambda c: (c.hidden_size, c.q_dim),
    "wk": lambda c: (c.hidden_size, c.kv_dim),
    "wv": lambda c: (c.hidden_size, c.kv_dim),
    "wo": lambda c: (c.q_dim, c.hidden_size),
    "w_gate": lambda c: (c.hidden_size, c.intermediate_size),
    "w_up": lambda c: (c.hidden_size, c.intermediate_size),
    "w_down": lambda c: (c.intermediate_size, c.hidden_size),
}

DEFAULT_TARGETS: Tuple[str, ...] = ("wq", "wk", "wv", "wo")


def _refuse_int8(params: Dict, what: str) -> None:
    if any(t.dtype == torch.int8 for t in params["layers"].values()):
        raise NotImplementedError(
            f"{what} over an int8 base (QLoRA) arrives with the quantized-"
            f"weights slice of the PyTorch port; pass a bf16 or fp32 base")


def init_lora(config: ModelConfig, generator: torch.Generator, *,
              rank: int = 16, alpha: float = None,
              targets: Sequence[str] = DEFAULT_TARGETS,
              device="cuda") -> Dict:
    """Adapter tree with a zero function delta at init (B = 0); A ~
    N(0, 1/in) * alpha / rank, drawn from ``generator`` (which must live
    on ``device``)."""
    if config.num_experts > 0:
        bad = {"w_gate", "w_up", "w_down"} & set(targets)
        if bad:
            raise ValueError(f"MoE expert banks are not LoRA targets "
                             f"(got {sorted(bad)}); use attention targets")
    dev = resolve_device(device)
    alpha = 2.0 * rank if alpha is None else alpha
    L = config.num_layers
    layers: Dict[str, torch.Tensor] = {}
    for t in targets:
        if t not in _TARGET_DIMS:
            raise ValueError(f"unknown LoRA target {t!r}; "
                             f"available: {sorted(_TARGET_DIMS)}")
        d_in, d_out = _TARGET_DIMS[t](config)
        scale = (alpha / rank) / float(d_in) ** 0.5
        a = torch.randn((L, d_in, rank), generator=generator,
                        dtype=config.dtype, device=dev)
        layers[t + "_lora_a"] = a.mul_(torch.tensor(scale,
                                                    dtype=config.dtype))
        layers[t + "_lora_b"] = torch.zeros((L, rank, d_out),
                                            dtype=config.dtype, device=dev)
    return {"layers": layers}


def merge_lora(base_params: Dict, lora: Dict) -> Dict:
    """Params view with the adapter leaves beside the base layer stack:
    a dict union, no tensor math."""
    out = dict(base_params)
    out["layers"] = {**base_params["layers"], **lora["layers"]}
    return out


def split_lora(params: Dict) -> Tuple[Dict, Dict]:
    """Inverse of merge_lora: (base_params, lora)."""
    base, adapters = {}, {}
    for name, leaf in params["layers"].items():
        (adapters if "_lora_" in name else base)[name] = leaf
    out = {k: v for k, v in params.items() if k != "layers"}
    out["layers"] = base
    return out, {"layers": adapters}


def materialize_lora(base_params: Dict, lora: Dict,
                     config: ModelConfig) -> Dict:
    """Fold A·B into the dense weights (fp32 product, cast back) → a
    plain param dict for publishing to an engine."""
    _refuse_int8(base_params, "materialize_lora")
    out = dict(base_params)
    layers = dict(base_params["layers"])
    for name in list(lora["layers"]):
        if not name.endswith("_lora_a"):
            continue
        target = name[: -len("_lora_a")]
        a = lora["layers"][name].float()
        b = lora["layers"][target + "_lora_b"].float()
        w = layers[target]
        layers[target] = (w.float() + torch.bmm(a, b)).to(w.dtype)
    out["layers"] = layers
    return out


def lora_param_count(lora: Dict) -> int:
    return sum(int(x.numel()) for x in lora["layers"].values())


def export_peft_adapter(*args, **kwargs):
    raise NotImplementedError(
        "PEFT adapter export arrives with the checkpoint slice of the "
        "PyTorch port")


def load_peft_adapter(*args, **kwargs):
    raise NotImplementedError(
        "PEFT adapter import arrives with the checkpoint slice of the "
        "PyTorch port")
