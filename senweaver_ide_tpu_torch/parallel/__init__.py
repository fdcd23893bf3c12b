"""Parallel layouts (PyTorch port).

Of the JAX package's ``parallel/`` the port so far takes the routed
mixture-of-experts FFN on one device (``expert.moe_ffn``). Meshes,
sharding, ring/ulysses attention, pipelines and the expert-parallel
``moe_ffn_sharded`` arrive with the parallel-layout slice.
"""

from .expert import MoEConfig, init_moe_params, moe_ffn, moe_ffn_sharded

__all__ = ["MoEConfig", "init_moe_params", "moe_ffn", "moe_ffn_sharded"]
