"""Model configurations for the policy LLM families (PyTorch port).

A copy of the JAX package's ``models/config.py`` presets with torch
dtypes. Both families are decoder-only pre-norm transformers with RoPE +
SwiGLU; Qwen2 uses GQA + QKV biases, DeepSeek-Coder is
LLaMA-architecture. Every preset is kept; the paged serving path of this
port serves the dense, full-attention ones (MoE and sliding-window
presets raise where the path would need them).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class RopeScaling:
    """Llama-3-style NTK-by-parts RoPE scaling (HF ``rope_type: llama3``).
    Fields mirror the HF ``rope_scaling`` dict of Llama-3.1+ checkpoints."""
    factor: float = 8.0
    low_freq_factor: float = 1.0
    high_freq_factor: float = 4.0
    original_max_position: int = 8192


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    vocab_size: int
    hidden_size: int
    intermediate_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    max_seq_len: int
    rope_theta: float = 10000.0
    # Llama-3.1+ long-context frequency scaling; None = plain RoPE.
    rope_scaling: Optional[RopeScaling] = None
    rms_norm_eps: float = 1e-6
    tie_word_embeddings: bool = False
    qkv_bias: bool = False
    # Qwen3-style per-head RMSNorm on q and k (over head_dim, before RoPE).
    qk_norm: bool = False
    # int8 contiguous slot cache (per-vector absmax scales); a paged
    # engine falls back to the slot layout for it.
    kv_quant: bool = False
    dtype: torch.dtype = torch.bfloat16
    # Sliding-window attention width (None = full causal).
    sliding_window: Optional[int] = None
    # No-cache attention implementation. The port implements "einsum"
    # (ops/attention.py); "flash" (kernel K2) and "ring"/"ulysses"
    # (parallel layouts) arrive with later slices and raise until then.
    attn_impl: str = "einsum"
    # Contiguous-cache (slot layout) decode attention: "flash" runs the
    # flash-decode kernel (ops/flash_decode.py) on single-token steps that
    # qualify, anything else the plain attention. The paged engine chooses
    # its kernel through EngineConfig.paged_kernel instead.
    decode_attn_impl: str = "einsum"
    scan_unroll: int = 1
    remat: object = False
    # Kept for parity. fp32 matmuls on the card run in full fp32 as long
    # as torch.backends.cuda.matmul.allow_tf32 stays False (the default).
    matmul_precision: Optional[str] = None
    # Mixture-of-experts FFN: 0 = dense (MoE is a later slice).
    num_experts: int = 0
    num_experts_per_tok: int = 2
    expert_capacity_factor: float = 1.25
    moe_layout: str = "mixtral"

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim


def qwen2_5_coder_0_5b() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-coder-0.5b", vocab_size=151_936, hidden_size=896,
        intermediate_size=4864, num_layers=24, num_heads=14, num_kv_heads=2,
        head_dim=64, max_seq_len=32_768, rope_theta=1_000_000.0,
        tie_word_embeddings=True, qkv_bias=True)


def qwen2_5_coder_1_5b() -> ModelConfig:
    """The flagship serving model."""
    return ModelConfig(
        name="qwen2.5-coder-1.5b", vocab_size=151_936, hidden_size=1536,
        intermediate_size=8960, num_layers=28, num_heads=12, num_kv_heads=2,
        head_dim=128, max_seq_len=32_768, rope_theta=1_000_000.0,
        tie_word_embeddings=True, qkv_bias=True)


def qwen2_5_coder_7b() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-coder-7b", vocab_size=152_064, hidden_size=3584,
        intermediate_size=18_944, num_layers=28, num_heads=28, num_kv_heads=4,
        head_dim=128, max_seq_len=131_072, rope_theta=1_000_000.0,
        qkv_bias=True)


def mistral_7b() -> ModelConfig:
    """Mistral-7B-v0.1: GQA with a 4096-token sliding window."""
    return ModelConfig(
        name="mistral-7b", vocab_size=32_000, hidden_size=4096,
        intermediate_size=14_336, num_layers=32, num_heads=32,
        num_kv_heads=8, head_dim=128, max_seq_len=32_768,
        rope_theta=10_000.0, rms_norm_eps=1e-5, sliding_window=4096)


def mixtral_8x7b() -> ModelConfig:
    """Mixtral-8x7B-v0.1: full attention, 8-expert top-2 routed FFN."""
    return ModelConfig(
        name="mixtral-8x7b", vocab_size=32_000, hidden_size=4096,
        intermediate_size=14_336, num_layers=32, num_heads=32,
        num_kv_heads=8, head_dim=128, max_seq_len=32_768,
        rope_theta=1_000_000.0, rms_norm_eps=1e-5, sliding_window=None,
        num_experts=8, num_experts_per_tok=2)


def deepseek_coder_1_3b() -> ModelConfig:
    return ModelConfig(
        name="deepseek-coder-1.3b", vocab_size=32_256, hidden_size=2048,
        intermediate_size=5504, num_layers=24, num_heads=16, num_kv_heads=16,
        head_dim=128, max_seq_len=16_384, rope_theta=100_000.0)


def deepseek_coder_6_7b() -> ModelConfig:
    return ModelConfig(
        name="deepseek-coder-6.7b", vocab_size=32_256, hidden_size=4096,
        intermediate_size=11_008, num_layers=32, num_heads=32, num_kv_heads=32,
        head_dim=128, max_seq_len=16_384, rope_theta=100_000.0)


def tiny_moe_test() -> ModelConfig:
    """MoE policy variant for unit tests."""
    return ModelConfig(
        name="tiny-moe-test", vocab_size=512, hidden_size=64,
        intermediate_size=128, num_layers=2, num_heads=4, num_kv_heads=2,
        head_dim=16, max_seq_len=128, qkv_bias=True,
        dtype=torch.float32, matmul_precision="highest",
        num_experts=4, num_experts_per_tok=2)


def tiny_test() -> ModelConfig:
    """Small fp32 config for unit tests."""
    return ModelConfig(
        name="tiny-test", vocab_size=512, hidden_size=64,
        intermediate_size=128, num_layers=2, num_heads=4, num_kv_heads=2,
        head_dim=16, max_seq_len=128, qkv_bias=True,
        dtype=torch.float32, matmul_precision="highest")


def qwen3_1_7b() -> ModelConfig:
    """Qwen3-1.7B: QK-norm GQA, no attention biases, tied embeddings."""
    return ModelConfig(
        name="qwen3-1.7b", vocab_size=151_936, hidden_size=2048,
        intermediate_size=6144, num_layers=28, num_heads=16, num_kv_heads=8,
        head_dim=128, max_seq_len=32_768, rope_theta=1_000_000.0,
        tie_word_embeddings=True, qk_norm=True)


def qwen3_8b() -> ModelConfig:
    return ModelConfig(
        name="qwen3-8b", vocab_size=151_936, hidden_size=4096,
        intermediate_size=12_288, num_layers=36, num_heads=32,
        num_kv_heads=8, head_dim=128, max_seq_len=32_768,
        rope_theta=1_000_000.0, qk_norm=True)


def qwen3_30b_a3b() -> ModelConfig:
    """Qwen3-30B-A3B: 128 experts, 8 active, QK-norm."""
    return ModelConfig(
        name="qwen3-30b-a3b", vocab_size=151_936, hidden_size=2048,
        intermediate_size=768, num_layers=48, num_heads=32, num_kv_heads=4,
        head_dim=128, max_seq_len=32_768, rope_theta=1_000_000.0,
        qk_norm=True, num_experts=128, num_experts_per_tok=8,
        moe_layout="qwen3")


def llama_3_2_1b() -> ModelConfig:
    """Llama-3.2-1B: GQA, tied embeddings, llama3 RoPE scaling."""
    return ModelConfig(
        name="llama-3.2-1b", vocab_size=128_256, hidden_size=2048,
        intermediate_size=8192, num_layers=16, num_heads=32, num_kv_heads=8,
        head_dim=64, max_seq_len=131_072, rope_theta=500_000.0,
        rope_scaling=RopeScaling(factor=32.0), rms_norm_eps=1e-5,
        tie_word_embeddings=True)


def llama_3_1_8b() -> ModelConfig:
    return ModelConfig(
        name="llama-3.1-8b", vocab_size=128_256, hidden_size=4096,
        intermediate_size=14_336, num_layers=32, num_heads=32,
        num_kv_heads=8, head_dim=128, max_seq_len=131_072,
        rope_theta=500_000.0, rope_scaling=RopeScaling(factor=8.0),
        rms_norm_eps=1e-5)


def small_test() -> ModelConfig:
    """Between tiny-test and the real presets (fp32)."""
    return ModelConfig(
        name="small-test", vocab_size=512, hidden_size=128,
        intermediate_size=384, num_layers=4, num_heads=8, num_kv_heads=4,
        head_dim=32, max_seq_len=4096, qkv_bias=True,
        dtype=torch.float32, matmul_precision="highest")


PRESETS = {
    "qwen2.5-coder-0.5b": qwen2_5_coder_0_5b,
    "qwen2.5-coder-1.5b": qwen2_5_coder_1_5b,
    "qwen2.5-coder-7b": qwen2_5_coder_7b,
    "mistral-7b": mistral_7b,
    "mixtral-8x7b": mixtral_8x7b,
    "deepseek-coder-1.3b": deepseek_coder_1_3b,
    "deepseek-coder-6.7b": deepseek_coder_6_7b,
    "llama-3.2-1b": llama_3_2_1b,
    "llama-3.1-8b": llama_3_1_8b,
    "qwen3-1.7b": qwen3_1_7b,
    "qwen3-8b": qwen3_8b,
    "qwen3-30b-a3b": qwen3_30b_a3b,
    "tiny-test": tiny_test,
    "tiny-moe-test": tiny_moe_test,
    "small-test": small_test,
}


def get_config(name: str) -> ModelConfig:
    if name not in PRESETS:
        raise KeyError(f"unknown model {name!r}; available: {sorted(PRESETS)}")
    return PRESETS[name]()
