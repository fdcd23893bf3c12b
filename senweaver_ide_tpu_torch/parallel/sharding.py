"""Parameter and activation sharding rules (Megatron/FSDP layout).

The JAX package's tables, entry by entry, as plain tuples in place of
``PartitionSpec``s: one entry per tensor dim, an axis name, a tuple of
names, or None.

- column-parallel projections (wq/wk/wv, w_gate/w_up): output dim on
  ``tp``, input dim on ``fsdp``
- row-parallel projections (wo, w_down): input dim on ``tp``, output dim
  on ``fsdp`` (the forward all-reduces over tp after the matmul)
- embedding: vocab on ``tp``, hidden on ``fsdp``; lm_head hidden on
  ``fsdp``, vocab on ``tp``
- norms: replicated; the leading layer axis is unsharded

Where JAX places a global array with ``device_put``, the port keeps on
each rank only its block: :func:`shard_params` returns this rank's local
shards, and :func:`gather_params` rebuilds the full tensors (checkpoints,
HF export, publishing from a sharded trainer, tests). fsdp-sharded
weights are all-gathered layer by layer in the forward
(``models/transformer.py``) and their gradients reduce-scattered.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Optional

import torch

from .comm import all_gather
from .mesh import Mesh, NamedSharding

PARAM_SPECS: Dict[str, tuple] = {
    "embed": ("tp", "fsdp"),
    "final_norm": (None,),
    "lm_head": ("fsdp", "tp"),
    "layers/attn_norm": (None, None),
    "layers/wq": (None, "fsdp", "tp"),
    "layers/wk": (None, "fsdp", "tp"),
    "layers/wv": (None, "fsdp", "tp"),
    "layers/bq": (None, "tp"),
    "layers/bk": (None, "tp"),
    "layers/bv": (None, "tp"),
    "layers/wo": (None, "tp", "fsdp"),
    "layers/mlp_norm": (None, None),
    "layers/q_norm": (None, None),     # (L, head_dim) — replicated
    "layers/k_norm": (None, None),
    "layers/w_gate": (None, "fsdp", "tp"),
    "layers/w_up": (None, "fsdp", "tp"),
    "layers/w_down": (None, "tp", "fsdp"),
    "layers/router": (None, "fsdp", None),
    # int8 weight-only serving (models/quantize.py): per-output-channel
    # scales shard like their weight's OUTPUT axis
    "lm_head_scale": ("tp",),
    # int8 shadow of the tied-embedding head: shards like embed
    "tied_head_q8": ("tp", "fsdp"),
    "tied_head_q8_scale": ("tp",),
    "layers/wq_scale": (None, "tp"),
    "layers/wk_scale": (None, "tp"),
    "layers/wv_scale": (None, "tp"),
    "layers/wo_scale": (None, "fsdp"),
    "layers/w_gate_scale": (None, "tp"),
    "layers/w_up_scale": (None, "tp"),
    "layers/w_down_scale": (None, "fsdp"),
}

# LoRA adapter leaves (training/lora.py): replicated. On a tp mesh the
# forward slices B's columns (column-parallel targets) or A's rows
# (row-parallel targets) to the local part.
for _t in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
    PARAM_SPECS[f"layers/{_t}_lora_a"] = (None, None, None)
    PARAM_SPECS[f"layers/{_t}_lora_b"] = (None, None, None)

# MoE variants: expert banks carry an extra (E,) axis after the layer
# axis, sharded over 'ep'.
MOE_PARAM_SPECS: Dict[str, tuple] = {
    "layers/w_gate": (None, "ep", "fsdp", "tp"),
    "layers/w_up": (None, "ep", "fsdp", "tp"),
    "layers/w_down": (None, "ep", "tp", "fsdp"),
}

# int8 MoE banks: (L, E, out) scales follow the bank's expert + OUTPUT
# axes (told from the 2-axis dense scales by ndim).
MOE_SCALE_SPECS: Dict[str, tuple] = {
    "layers/w_gate_scale": (None, "ep", "tp"),
    "layers/w_up_scale": (None, "ep", "tp"),
    "layers/w_down_scale": (None, "ep", "fsdp"),
}

# Activation specs.
ACT_SPEC = (("dp", "fsdp"), "sp", None)          # (B, S, D)
LOGITS_SPEC = (("dp", "fsdp"), "sp", "tp")       # (B, S, V)
# KV cache (L, B, S, Hkv, D): batch on data axes, heads on tp.
KV_CACHE_SPEC = (None, ("dp", "fsdp"), None, "tp", None)


def restrict_spec(spec: tuple, mesh: Mesh) -> tuple:
    """Drop axes the mesh does not have (a tp-only serving mesh must not
    reject the canonical specs that also name dp/fsdp/sp)."""
    names = set(mesh.axis_names)

    def keep(entry):
        if entry is None:
            return None
        if isinstance(entry, tuple):
            kept = tuple(a for a in entry if a in names)
            return kept if len(kept) > 1 else (kept[0] if kept else None)
        return entry if entry in names else None

    return tuple(keep(e) for e in spec)


def spec_for_path(path: str, ndim: int = -1) -> tuple:
    if path in MOE_PARAM_SPECS and ndim == 4:
        return MOE_PARAM_SPECS[path]
    if path in MOE_SCALE_SPECS and ndim == 3:
        return MOE_SCALE_SPECS[path]
    if path in PARAM_SPECS:
        return PARAM_SPECS[path]
    raise KeyError(f"no sharding rule for param path {path!r}")


def _walk(tree: Any, fn, prefix: str = "") -> Any:
    if isinstance(tree, dict):
        return {k: _walk(v, fn, f"{prefix}/{k}" if prefix else k)
                for k, v in tree.items()}
    return fn(prefix, tree)


def param_specs(params: Any) -> Any:
    """Tree of specs matching a transformer param tree."""
    return _walk(params, lambda p, t: spec_for_path(p, getattr(t, "ndim",
                                                               -1)))


def param_shardings(params: Any, mesh: Mesh) -> Any:
    """Tree of :class:`NamedSharding` (mesh + restricted spec)."""
    return _walk(params, lambda p, t: NamedSharding(
        mesh, restrict_spec(spec_for_path(p, t.ndim), mesh)))


def spec_axes(spec: tuple) -> tuple:
    """Every axis a (restricted) spec names, in dim order."""
    out = []
    for entry in spec:
        if entry is None:
            continue
        out.extend(entry if isinstance(entry, tuple) else (entry,))
    return tuple(out)


def _keep_only(spec: tuple, axes: Optional[Iterable[str]]) -> tuple:
    if axes is None:
        return spec
    axes = set(axes)

    def keep(entry):
        if entry is None:
            return None
        if isinstance(entry, tuple):
            kept = tuple(a for a in entry if a in axes)
            return kept if len(kept) > 1 else (kept[0] if kept else None)
        return entry if entry in axes else None

    return tuple(keep(e) for e in spec)


def shard_params(params: Any, mesh: Mesh, *,
                 axes: Optional[Iterable[str]] = None) -> Any:
    """This rank's block of every tensor of a FULL param tree under
    PARAM_SPECS (restricted to the mesh's axes, and to ``axes`` when
    given: a serving engine shards over tp only). Each block is a copy,
    so the full tree can be freed."""
    def shard(path, t):
        spec = _keep_only(restrict_spec(spec_for_path(path, t.ndim), mesh),
                          axes)
        return NamedSharding(mesh, spec).local(t).contiguous().clone()

    return _walk(params, shard)


def gather_params(params: Any, mesh: Mesh, *,
                  axes: Optional[Iterable[str]] = None) -> Any:
    """The full tensors of a tree of local shards (the inverse of
    :func:`shard_params` with the same ``axes``): one all-gather per
    sharded dim. Every rank of the mesh must call it."""
    def gather(path, t):
        spec = _keep_only(restrict_spec(spec_for_path(path, t.ndim), mesh),
                          axes)
        with torch.no_grad():
            for dim, entry in enumerate(spec):
                if entry is not None:
                    t = all_gather(t, mesh, entry, dim)
        return t

    return _walk(params, gather)
