"""The yardstick's counts against hand-worked cases."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest

from benchmark import core, serving, traffic, yardstick
from benchmark.tests import tiny

DS = json.load(open(os.path.join(core.BENCH, "configs",
                                 "deepseek-coder-6.7b.json")))
QWEN = json.load(open(os.path.join(core.BENCH, "configs",
                                   "qwen2.5-coder-1.5b.json")))


def test_matmul_params():
    # q, k, v, o at 4096 x 4096 each, the gated MLP 3 x 4096 x 11008,
    # 32 layers, and the 4096 x 32256 head
    assert yardstick.matmul_params(DS) == (
        32 * (4 * 4096 * 4096 + 3 * 4096 * 11008) + 4096 * 32256)
    assert yardstick.matmul_params(DS) == 6_608_125_952
    # 12/2 heads of 128: q and o 1536 x 1536, k and v 1536 x 256
    assert yardstick.matmul_params(QWEN) == (
        28 * (2 * 1536 * 1536 + 2 * 1536 * 256 + 3 * 1536 * 8960)
        + 1536 * 151936)


def test_forward_and_train_flops():
    n = yardstick.matmul_params(tiny.TINY)
    # two tokens at positions 0 and 1 see 1 and 2 keys: contexts sum to 3;
    # 4 FLOPs a (head, dim, key) for q.k and p.v, 2 layers, 4 heads of 16
    attn = 4 * 2 * 4 * 16 * 3
    assert yardstick.forward_flops(tiny.TINY, 2, 3) == 2 * n * 2 + attn
    assert yardstick.train_flops(tiny.TINY, [2]) == 3 * (2 * n * 2 + attn)


def test_k1_work():
    # per layer: 10 distinct positions x 2 heads x (K and V) x 16 x 2 B,
    # q read and out written (3 tokens x 4 heads x 16 x 2 B each), 2 table
    # entries and 3 lengths of 4 B; 2 layers
    flops, nbytes = yardstick.k1_work(tiny.TINY, 10, 3, 12, 2)
    assert nbytes == 2 * (1280 + 768 + 8 + 12)
    assert flops == 4 * 4 * 16 * 12 * 2


def test_k2_work():
    # one sequence of 2: 3 causal pairs; forward 4 and backward 8 FLOPs a
    # (pair, head, dim); q 256 B, k and v 128 B each, lse 32 B
    flops, nbytes = yardstick.k2_work(tiny.TINY, [2])
    assert flops == 12 * 4 * 16 * 3 * 2
    fwd = 256 + 2 * 128 + 256 + 32
    dkdv = 2 * 256 + 2 * 128 + 2 * 32 + 2 * 128
    dq = 2 * 256 + 2 * 128 + 2 * 32 + 256
    assert nbytes == 2 * (fwd + dkdv + dq)


def test_bound_takes_the_slower_side():
    pk = {"bf16_flops": 1e12, "hbm_bytes": 1e9}
    assert yardstick.bound_seconds(2e12, 1e9, pk) == 2.0
    assert yardstick.bound_seconds(1e12, 3e9, pk) == 3.0


def test_statistics():
    xs = [5.0, 1.0, 4.0, 2.0, 3.0, 10.0]
    for q in (0, 50, 95, 100):
        assert yardstick.percentile(xs, q) == pytest.approx(
            float(np.percentile(xs, q)))


def test_strata_are_the_distributions_quantiles():
    rng = np.random.default_rng(0)
    assert sorted(traffic.strata(rng, 4, [100, 500, "uniform"])) == [
        150, 250, 350, 450]
    lu = sorted(traffic.strata(rng, 2, [16, 256, "log_uniform"]))
    assert lu == [32, 128]


def test_distinct_positions_of_a_step():
    # three rows read 100, 120 and 40 positions; every prompt begins with
    # the same 50: rows 1 and 2 read all 50, row 3 its 40, so 90 of the
    # common reads are repeats; rows 1 and 2 are one group whose prompt
    # runs 30 past the common part, read once more than needed
    step = {"reads": [40, 100, 120]}
    serving.note_sharing(step, 50, within=30)
    assert step["distinct"] == 260 - (140 - 50) - 30 == 140
    # no common part and no group: every read is the row's own
    step = {"reads": [3, 5]}
    serving.note_sharing(step, 0)
    assert step["distinct"] == 8
