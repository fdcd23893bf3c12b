"""Parallel layouts (PyTorch port) on ``torch.distributed``.

Meshes of ranks with JAX's axis names (``mesh``, ``distributed``), the
Megatron/FSDP sharding tables and per-rank shards (``sharding``), the
collectives and their autograd pairs (``comm``), ring and Ulysses
sequence parallelism (``ring_attention``) and the routed MoE FFN with its
expert-parallel path (``expert``), and pipeline stages over a 'pp' axis,
GPipe and 1F1B (``pipeline``).
"""

from .distributed import (AXIS_ORDER, DistributedConfig, initialize,
                          make_named_mesh)
from .expert import MoEConfig, init_moe_params, moe_ffn, moe_ffn_sharded
from .mesh import (AXES, Mesh, MeshConfig, data_sharding, make_hybrid_mesh,
                   make_mesh, replicated, single_device_mesh)
from .pipeline import (make_pp_train_state, pipeline_forward,
                       pipeline_train_grads_1f1b, place_pipeline_params,
                       pp_train_step, split_layers_for_stages,
                       stage_param_specs)
from .ring_attention import (chunk_attention_lse, make_ring_attention,
                             make_ulysses_attention, merge_partials,
                             ring_attention, ulysses_attention)
from .sharding import (ACT_SPEC, KV_CACHE_SPEC, LOGITS_SPEC, PARAM_SPECS,
                       gather_params, param_shardings, param_specs,
                       shard_params)

__all__ = [
    "ACT_SPEC", "AXES", "AXIS_ORDER", "DistributedConfig", "KV_CACHE_SPEC",
    "LOGITS_SPEC", "Mesh", "MeshConfig", "MoEConfig", "PARAM_SPECS",
    "chunk_attention_lse", "data_sharding", "gather_params", "initialize",
    "init_moe_params", "make_hybrid_mesh", "make_mesh", "make_named_mesh",
    "make_pp_train_state", "make_ring_attention", "make_ulysses_attention",
    "merge_partials", "moe_ffn", "moe_ffn_sharded", "param_shardings",
    "param_specs", "pipeline_forward", "pipeline_train_grads_1f1b",
    "place_pipeline_params", "pp_train_step", "replicated",
    "ring_attention", "shard_params", "single_device_mesh",
    "split_layers_for_stages", "stage_param_specs", "ulysses_attention",
]
