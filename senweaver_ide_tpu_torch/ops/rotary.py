"""Rotary position embeddings (RoPE), half-rotation layout.

Frequencies are computed in fp32 and applied in fp32 before casting back:
bf16 phase accumulation visibly degrades long-context quality.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


def rope_frequencies(head_dim: int, theta: float = 10000.0,
                     device=None) -> torch.Tensor:
    """(head_dim/2,) inverse frequencies."""
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)


def scale_frequencies_llama3(inv_freq: torch.Tensor, *, factor: float,
                             low_freq_factor: float, high_freq_factor: float,
                             original_max_position: int) -> torch.Tensor:
    """Llama-3 NTK-by-parts frequency scaling (HF ``rope_type: llama3``):
    wavelengths longer than ``original_max_position / low_freq_factor``
    slow by ``factor``, those shorter than ``original / high_freq_factor``
    stay, and the band between interpolates in 1/wavelength."""
    wavelen = 2.0 * math.pi / inv_freq
    smooth = ((original_max_position / wavelen) - low_freq_factor) / (
        high_freq_factor - low_freq_factor)
    smooth = torch.clamp(smooth, 0.0, 1.0)
    return (1.0 - smooth) * inv_freq / factor + smooth * inv_freq


def rope_cos_sin(positions: torch.Tensor, head_dim: int,
                 theta: float = 10000.0,
                 scaling: Optional[object] = None,
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for integer ``positions`` of any shape →
    (..., head_dim/2). ``scaling`` is a ``RopeScaling`` (or any object
    with its fields) enabling Llama-3-style frequency scaling."""
    inv_freq = rope_frequencies(head_dim, theta, device=positions.device)
    if scaling is not None:
        inv_freq = scale_frequencies_llama3(
            inv_freq, factor=scaling.factor,
            low_freq_factor=scaling.low_freq_factor,
            high_freq_factor=scaling.high_freq_factor,
            original_max_position=scaling.original_max_position)
    angles = positions.float()[..., None] * inv_freq
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Rotate ``x`` of shape (..., seq, heads, head_dim) by per-position
    tables of shape (..., seq, head_dim/2) (broadcast over heads)."""
    dtype = x.dtype
    xf = x.float()
    half = x.shape[-1] // 2
    x1, x2 = xf[..., :half], xf[..., half:]
    c = cos[..., None, :]  # add heads axis
    s = sin[..., None, :]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(dtype)
