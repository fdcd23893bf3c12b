"""Concurrency-adaptive speculation depth control.

Speculative decoding trades verify-batch FLOPs for latency: at low
concurrency the target model is memory-bound and verifying ``k`` draft
tokens per step is nearly free, so deep speculation wins; at high
concurrency the fused step is already compute-saturated and every
rejected draft token is wasted work stolen from other requests'
decode/prefill budget. :class:`SpecController` maps per-replica load —
the router's remaining-decode-token gauge plus KV pool pressure — onto
a small ladder of depths (default ``(0, 2, 4, 8)``).

Two properties matter more than the exact mapping:

* **Every depth is a pre-compiled bucket.** The engine pads its fused
  verify batch per depth, so each ladder rung is one jit signature.
  A controller that picked arbitrary depths would mint a retrace per
  step; the ladder keeps the compile ledger bounded at one entry per
  (occupancy-bucket, depth) pair.
* **Hysteresis makes changes rare.** A depth change invalidates the
  draft lockstep for in-flight rows and lands on a different compiled
  bucket, so the controller only moves after the load signal has asked
  for the same rung ``hysteresis_steps`` times in a row.

The controller is host-only (no device work) and thread-safe; the
engine calls :meth:`observe` once per fused step under its own lock.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Optional, Sequence, Tuple

from ..obs.incidents import emit_event


@dataclasses.dataclass(frozen=True)
class SpecControllerConfig:
    """Knobs for the depth ladder and its hysteresis.

    ``low_load``/``high_load`` bound the proportional band: at or below
    ``low_load`` the deepest rung is requested, at or above
    ``high_load`` speculation turns off, and the rungs in between are
    assigned to equal slices of the band (deeper ⇒ lighter load).
    """
    ladder: Tuple[int, ...] = (0, 2, 4, 8)
    low_load: float = 0.35
    high_load: float = 0.80
    # Consecutive observe() calls that must request the same rung
    # before the applied depth moves.
    hysteresis_steps: int = 8
    # Normaliser for the remaining-decode-token signal: full load when
    # the backlog reaches this many tokens per slot.
    decode_tokens_per_slot: float = 64.0

    def __post_init__(self):
        if not self.ladder or sorted(set(self.ladder)) != sorted(self.ladder):
            raise ValueError("ladder must be sorted and duplicate-free")
        if self.ladder[0] != 0:
            raise ValueError("ladder must include depth 0 (speculation off)")
        if any(d < 0 for d in self.ladder):
            raise ValueError("depths must be non-negative")
        if not (0.0 <= self.low_load < self.high_load):
            raise ValueError("need 0 <= low_load < high_load")
        if self.hysteresis_steps < 1:
            raise ValueError("hysteresis_steps must be >= 1")


class SpecController:
    """Hysteretic load → speculation-depth ladder.

    ``observe`` ingests the load signals and returns the applied depth;
    ``depth`` re-reads it without observing. Load is the max of the
    normalised signals (any saturated resource is enough to throttle
    speculation).
    """

    def __init__(self, config: Optional[SpecControllerConfig] = None, *,
                 registry=None):
        self.config = config or SpecControllerConfig()
        self._lock = threading.RLock()
        ladder = self.config.ladder
        self._depth = ladder[-1]        # guarded-by: _lock (idle ⇒ deepest)
        self._pending = self._depth     # guarded-by: _lock
        self._streak = 0                # guarded-by: _lock
        self._changes = 0               # guarded-by: _lock
        self._last_load = 0.0           # guarded-by: _lock
        if registry is None:
            from ..obs import get_registry
            registry = get_registry()
        self._depth_gauge = registry.gauge(
            "senweaver_spec_depth",
            "Applied speculation depth of the most recently stepped "
            "engine (0 = speculation off).")
        self._load_gauge = registry.gauge(
            "senweaver_spec_controller_load",
            "Combined load signal (0..1) the depth controller last saw.")
        self._change_total = registry.counter(
            "senweaver_spec_depth_changes_total",
            "Applied speculation-depth transitions (post-hysteresis).")
        self._depth_gauge.set(self._depth)

    # -- load mapping ----------------------------------------------------
    def _target_rung(self, load: float) -> int:
        c = self.config
        if load >= c.high_load:
            return 0
        deep = [d for d in c.ladder if d > 0]
        if load <= c.low_load or len(deep) == 1:
            return deep[-1]
        # Equal slices of (low_load, high_load), deepest first.
        frac = (load - c.low_load) / (c.high_load - c.low_load)
        idx = min(int(frac * len(deep)), len(deep) - 1)
        return sorted(deep, reverse=True)[idx]

    @staticmethod
    def combine_load(*, occupancy: float = 0.0,
                     kv_pressure: float = 0.0,
                     decode_backlog: float = 0.0) -> float:
        """Max of the normalised signals, clamped to [0, 1]."""
        load = max(occupancy, kv_pressure, decode_backlog)
        return min(1.0, max(0.0, load))

    # -- control loop ----------------------------------------------------
    def observe(self, *, occupancy: float = 0.0,
                kv_pressure: float = 0.0,
                decode_tokens: Optional[float] = None,
                num_slots: int = 1) -> int:
        """Ingest one step's load signals; returns the applied depth.

        ``occupancy``: active rows / slots (0..1). ``kv_pressure``:
        allocated fraction of the KV block pool (0..1).
        ``decode_tokens``: the router's remaining-decode-token gauge for
        this replica (normalised by ``decode_tokens_per_slot * slots``).
        """
        backlog = 0.0
        if decode_tokens is not None and num_slots > 0:
            cap = self.config.decode_tokens_per_slot * num_slots
            backlog = decode_tokens / cap if cap > 0 else 0.0
        load = self.combine_load(occupancy=occupancy,
                                 kv_pressure=kv_pressure,
                                 decode_backlog=backlog)
        rung = self._target_rung(load)
        with self._lock:
            self._last_load = load
            self._load_gauge.set(load)
            if rung == self._depth:
                self._pending, self._streak = rung, 0
            elif rung == self._pending:
                self._streak += 1
                if self._streak >= self.config.hysteresis_steps:
                    old = self._depth
                    self._depth = rung
                    self._streak = 0
                    self._changes += 1
                    self._change_total.inc()
                    self._depth_gauge.set(self._depth)
                    emit_event("spec_depth_change", depth=rung,
                               from_depth=old, load=load)
            else:
                self._pending, self._streak = rung, 1
            return self._depth

    @property
    def depth(self) -> int:
        with self._lock:
            return self._depth

    @property
    def last_load(self) -> float:
        with self._lock:
            return self._last_load

    @property
    def changes(self) -> int:
        with self._lock:
            return self._changes

    def force_depth(self, depth: int) -> None:
        """Pin the applied depth (tests, manual override). The depth
        must be a ladder rung so it lands on a compiled bucket."""
        if depth not in self.config.ladder:
            raise ValueError(f"depth {depth} not on ladder "
                             f"{self.config.ladder}")
        with self._lock:
            if depth != self._depth:
                self._changes += 1
                self._change_total.inc()
                emit_event("spec_depth_change", depth=depth,
                           from_depth=self._depth, forced=True)
            self._depth = self._pending = depth
            self._streak = 0
            self._depth_gauge.set(depth)


@dataclasses.dataclass
class FixedDepth:
    """Degenerate controller: always the same depth. Lets the engine
    treat 'fixed depth' and 'adaptive depth' uniformly, and gives the
    bench a fixed-depth arm to compare the adaptive controller against."""
    value: int = 4

    def observe(self, **_kw) -> int:
        return self.value

    @property
    def depth(self) -> int:
        return self.value
