"""The benchmark's yardstick: published peaks, the operations and bytes
that a step's work needs, and the statistics the metrics are taken with.

Everything here is computed from shapes the harness recorded, never read
from the program, so a change to the program cannot move the yardstick.
"""

from __future__ import annotations

import math
from typing import Iterable, Optional, Sequence

# Published dense peaks of one card, keyed by torch.cuda.get_device_name():
# bf16 FLOP/s without sparsity and HBM bytes/s (NVIDIA H100 SXM data sheet,
# at the card's full 700 W).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "hbm_bytes": 3.35e12},
}


def peak(device_name: str) -> Optional[dict]:
    """The card's peaks, or None for a card the table does not know (its
    roofline and mfu metrics are then left out, never reported as 0)."""
    return PEAKS.get(device_name)


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between order
    statistics (numpy's default method)."""
    if not values:
        raise ValueError("percentile of no values")
    xs = sorted(values)
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


# -- model FLOPs ----------------------------------------------------------

def matmul_params(cfg) -> int:
    """Weights that every token multiplies: q/k/v/o, the gated MLP and the
    output head. The embedding gather is not a matmul and is left out."""
    d, f = cfg["hidden_size"], cfg["intermediate_size"]
    q = cfg["num_attention_heads"] * cfg["head_dim"]
    kv = cfg["num_key_value_heads"] * cfg["head_dim"]
    per_layer = d * q + 2 * d * kv + q * d + 3 * d * f
    return cfg["num_hidden_layers"] * per_layer + d * cfg["vocab_size"]


def attention_flops(cfg, context_sum: int) -> float:
    """Forward FLOPs of causal attention, all layers, for tokens whose
    visible contexts (keys attended, itself included) sum to
    ``context_sum``: q·k and p·v, 2 FLOPs a multiply-add each."""
    return (4.0 * cfg["num_hidden_layers"] * cfg["num_attention_heads"]
            * cfg["head_dim"] * context_sum)


def forward_flops(cfg, tokens: int, context_sum: int) -> float:
    """Model FLOPs of a forward pass over ``tokens`` tokens."""
    return 2.0 * matmul_params(cfg) * tokens + attention_flops(cfg,
                                                              context_sum)


def train_flops(cfg, seq_lens: Iterable[int]) -> float:
    """Model FLOPs of one training step over sequences of these lengths:
    forward and backward (3x the forward), no recomputation."""
    lens = list(seq_lens)
    ctx = sum(n * (n + 1) // 2 for n in lens)
    return 3.0 * forward_flops(cfg, sum(lens), ctx)


# -- kernel work ----------------------------------------------------------

def k1_work(cfg, distinct_positions: int, tokens: int, context_sum: int,
            live_blocks: int, kv_bytes: int = 2, q_bytes: int = 2):
    """(flops, bytes) of paged attention over one flat step, all layers:
    each distinct stored (block, position) of K and V read once at its
    stored width, q read and out written once, the live table entries and
    the lengths (one int32 each); q·k and p·v over every visible key."""
    hkv, hq, d = (cfg["num_key_value_heads"], cfg["num_attention_heads"],
                  cfg["head_dim"])
    per_layer = (distinct_positions * hkv * 2 * d * kv_bytes
                 + 2 * tokens * hq * d * q_bytes
                 + live_blocks * 4 + tokens * 4)
    flops = 4.0 * hq * d * context_sum * cfg["num_hidden_layers"]
    return flops, per_layer * cfg["num_hidden_layers"]


def k2_work(cfg, seq_lens: Iterable[int]):
    """(flops, bytes) that causal attention needs in one training step over
    sequences of these lengths, all layers, bf16: the forward (q·k, p·v)
    and the backward (dP, dV, dQ, dK), with q, k, v, out, the log-sum-exp
    and the gradients each read or written once per kernel. Padding is
    not work the step needs."""
    hq, hkv, d, n_layers = (cfg["num_attention_heads"],
                            cfg["num_key_value_heads"], cfg["head_dim"],
                            cfg["num_hidden_layers"])
    flops = nbytes = 0.0
    for s in seq_lens:
        pairs = s * (s + 1) // 2
        qb, kvb, rowb = s * hq * d * 2, s * hkv * d * 2, s * hq * 4
        flops += (4 + 8) * hq * d * pairs
        nbytes += ((qb + 2 * kvb + qb + rowb)                 # forward
                   + (2 * qb + 2 * kvb + 2 * rowb + 2 * kvb)  # dK, dV
                   + (2 * qb + 2 * kvb + 2 * rowb + qb))      # dQ
    return flops * n_layers, nbytes * n_layers


def bound_seconds(flops: float, nbytes: float, pk: dict) -> float:
    """The least time the work can take on the card."""
    return max(flops / pk["bf16_flops"], nbytes / pk["hbm_bytes"])
