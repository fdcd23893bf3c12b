"""Sampling parameters shared by the engine and its clients.

Only the parameter tuple is ported so far: the contiguous-cache
``generate``/``generate_scan`` drivers wait for the slot-layout slice.
"""

from __future__ import annotations

from typing import NamedTuple


class SampleParams(NamedTuple):
    temperature: float = 0.8
    top_k: int = 0
    top_p: float = 0.95
