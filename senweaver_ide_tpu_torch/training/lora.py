"""LoRA adapters for GRPO fine-tuning (PyTorch port).

The adapter tree is shaped like the layer stack, ``{"layers":
{"wq_lora_a": (L, in, r), "wq_lora_b": (L, r, out), ...}}``; B starts at
zero, so the adapted model equals the base at init, and the alpha/rank
scale is baked into A. ``merge_lora`` is a dict union that
``models/transformer.py::_dense`` reads as ``y += (h @ A) @ B``;
``train_step(..., lora_base=base)`` trains the adapters only.

:func:`export_peft_adapter` and :func:`load_peft_adapter` write and read
the HF-PEFT layout (``adapter_model.safetensors`` + ``adapter_config.json``)
through the port's safetensors codec.

bf16 and fp32 bases only: an int8 base (QLoRA) arrives with a later slice
of the port.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Sequence, Tuple

import torch

from ..device import resolve_device
from ..models.config import ModelConfig
from ..models.safetensors_io import SafetensorsReader, save_file

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


# HF module names for each target (PEFT adapter layout).
_PEFT_MODULES = {
    "wq": "self_attn.q_proj", "wk": "self_attn.k_proj",
    "wv": "self_attn.v_proj", "wo": "self_attn.o_proj",
    "w_gate": "mlp.gate_proj", "w_up": "mlp.up_proj",
    "w_down": "mlp.down_proj",
}

# Hub repo ids for the local presets: what a PEFT runtime needs in
# adapter_config.json to resolve the base checkpoint.
_HF_REPO_IDS = {
    "qwen2.5-coder-0.5b": "Qwen/Qwen2.5-Coder-0.5B",
    "qwen2.5-coder-1.5b": "Qwen/Qwen2.5-Coder-1.5B",
    "qwen2.5-coder-7b": "Qwen/Qwen2.5-Coder-7B",
    "qwen3-1.7b": "Qwen/Qwen3-1.7B",
    "qwen3-8b": "Qwen/Qwen3-8B",
    "deepseek-coder-1.3b": "deepseek-ai/deepseek-coder-1.3b-base",
    "deepseek-coder-6.7b": "deepseek-ai/deepseek-coder-6.7b-base",
    "mistral-7b": "mistralai/Mistral-7B-v0.1",
    "mixtral-8x7b": "mistralai/Mixtral-8x7B-v0.1",
    "llama-3.2-1b": "meta-llama/Llama-3.2-1B",
    "llama-3.1-8b": "meta-llama/Llama-3.1-8B",
}


def export_peft_adapter(lora: Dict, config: ModelConfig, out_dir: str, *,
                        base_model: Optional[str] = None) -> str:
    """Write adapters in the HF-PEFT layout so a GRPO-trained adapter
    drops into any PEFT runtime over the matching base checkpoint.

    The alpha/rank scale is baked into A at init, so the exported config
    pins ``lora_alpha == r`` (scaling 1.0): the product A·B is the same
    either way. PEFT stores lora_A as (r, in) and lora_B as (out, r)
    (torch Linear layout); the port's are (in, r) and (r, out). Tensors
    are written in fp32."""
    tensors: Dict[str, torch.Tensor] = {}
    rank = None
    targets = []
    for name, leaf in lora["layers"].items():
        if not name.endswith("_lora_a"):
            continue
        target = name[: -len("_lora_a")]
        targets.append(_PEFT_MODULES[target].rsplit(".", 1)[-1])
        a = leaf.float()
        b = lora["layers"][target + "_lora_b"].float()
        rank = int(a.shape[-1])
        for i in range(a.shape[0]):
            prefix = (f"base_model.model.model.layers.{i}."
                      f"{_PEFT_MODULES[target]}")
            tensors[prefix + ".lora_A.weight"] = a[i].T      # (r, in)
            tensors[prefix + ".lora_B.weight"] = b[i].T      # (out, r)
    if not tensors:
        # an empty safetensors file and a config with r=null load in no
        # PEFT runtime, and would fail only at load time
        raise ValueError("export_peft_adapter: no LoRA adapter leaves "
                         "found in lora['layers'] (expected *_lora_a/"
                         "*_lora_b pairs)")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "adapter_model.safetensors")
    save_file(tensors, path)
    with open(os.path.join(out_dir, "adapter_config.json"), "w") as f:
        json.dump({"peft_type": "LORA", "r": rank, "lora_alpha": rank,
                   "lora_dropout": 0.0, "bias": "none",
                   "base_model_name_or_path": (
                       base_model or _HF_REPO_IDS.get(config.name,
                                                      config.name)),
                   "target_modules": sorted(set(targets)),
                   "task_type": "CAUSAL_LM"}, f, indent=1)
    return path


def load_peft_adapter(adapter_dir: str, config: ModelConfig, *,
                      device="cuda") -> Dict:
    """Read a PEFT-layout adapter dir into the stacked adapter tree on
    ``device``, in ``config.dtype``.

    Scaling: PEFT applies ``lora_alpha / r`` (``alpha / sqrt(r)`` under
    rsLoRA) at run time; the port bakes it into A, so A is multiplied by
    that factor on load. Keys outside ``…layers.{i}.<module>.lora_{A,B}``
    (``modules_to_save`` tensors, modules this architecture lacks) are
    skipped; a file with nothing loadable raises."""
    dev = resolve_device(device)
    with open(os.path.join(adapter_dir, "adapter_config.json")) as f:
        meta = json.load(f)
    r = float(meta["r"])
    alpha = float(meta.get("lora_alpha", r))
    scaling = alpha / (r ** 0.5) if meta.get("use_rslora") else alpha / r
    module_to_target = {v: k for k, v in _PEFT_MODULES.items()}
    path = os.path.join(adapter_dir, "adapter_model.safetensors")
    with SafetensorsReader([path]) as reader:
        per_target: Dict[str, Dict[int, Dict[str, str]]] = {}
        skipped = []
        for key in reader.keys():
            parts = key.split(".")
            if "layers" not in parts or parts[-2] not in ("lora_A",
                                                          "lora_B"):
                skipped.append(key)
                continue
            li = parts.index("layers")
            target = module_to_target.get(".".join(parts[li + 2:-2]))
            if target is None:
                skipped.append(key)
                continue
            per_target.setdefault(target, {}).setdefault(
                int(parts[li + 1]), {})[parts[-2]] = key
        if not per_target:
            raise ValueError(
                f"no loadable LoRA tensors in {adapter_dir!r} (skipped "
                f"{len(skipped)} keys, e.g. {skipped[:3]}); supported "
                f"modules: {sorted(module_to_target)}")
        layers: Dict[str, torch.Tensor] = {}
        L = config.num_layers
        for target, rows in per_target.items():
            if sorted(rows) != list(range(L)):
                raise ValueError(f"adapter covers layers {sorted(rows)} but "
                                 f"config {config.name!r} has {L}")
            d_in, _ = _TARGET_DIMS[target](config)
            got = tuple(reversed(reader.shape(rows[0]["lora_A"])))
            if got != (d_in, int(r)):
                raise ValueError(
                    f"adapter {target} lora_A shape {got} does not match "
                    f"config {config.name!r} expectation ({d_in}, {int(r)})")
            a = torch.stack([reader.get(rows[i]["lora_A"], dev).T
                             for i in range(L)])
            b = torch.stack([reader.get(rows[i]["lora_B"], dev).T
                             for i in range(L)])
            layers[target + "_lora_a"] = (a * scaling).to(config.dtype)
            layers[target + "_lora_b"] = b.to(config.dtype)
    return {"layers": layers}
