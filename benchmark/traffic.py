"""The general traffic generator: every traffic file's sizes are drawn
here from ``--seed``.

Sizes are stratified: ``n`` draws of a distribution are its quantiles at
``(i + 0.5) / n``, in an order the seed shuffles. Every seed so gets the
same set of sizes in another order, and the work of a run depends on the
seed only through that order and the token ids.
"""

from __future__ import annotations

import math
from typing import List

import numpy as np


def strata(rng: np.random.Generator, n: int, spec) -> List[int]:
    """``n`` integer sizes of ``spec`` (``[lo, hi, "uniform"]`` or
    ``[lo, hi, "log_uniform"]``), stratified and shuffled."""
    lo, hi, dist = spec
    if not 1 <= lo <= hi:
        raise ValueError(f"bad size range {spec!r}")
    u = (np.arange(n) + 0.5) / n
    if dist == "uniform":
        x = lo + u * (hi - lo)
    elif dist == "log_uniform":
        x = np.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))
    else:
        raise ValueError(f"unknown distribution {dist!r}")
    out = [int(round(v)) for v in x]
    rng.shuffle(out)
    return out


class Stream:
    """An endless stream of sizes of one spec: blocks of ``n`` stratified
    draws, each block in its own shuffled order."""

    def __init__(self, rng: np.random.Generator, spec, n: int):
        self.rng, self.spec, self.n = rng, spec, n
        self._buf: List[int] = []

    def next(self) -> int:
        if not self._buf:
            self._buf = strata(self.rng, self.n, self.spec)
        return self._buf.pop()


def token_ids(rng: np.random.Generator, n: int, vocab: int) -> List[int]:
    return rng.integers(0, vocab, size=n).tolist()
