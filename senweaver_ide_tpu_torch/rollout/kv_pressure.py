"""KV memory-pressure policy: eviction scoring, host tiering, watermarks.

The paged pool (``rollout/paged_kv.py``) turns exhaustion into typed
``BlocksExhausted`` backpressure; this module decides what to *do*
about pressure before that point. Three pure-host pieces, shared by the
engine's reclaim ladder and the serving admission plane:

* **victim scoring** — rank resident prefix entries by how cheap they
  are to lose: unshared before shared (a grafted prefix saves prefill
  for every consumer), then by recompute-cost × recency. The engine
  evicts (or tiers) the minimum-key candidate, so a hot shared prefix
  is never dropped to rerun a cold tail.
* **tier-or-evict decision** — warm or shared prefixes are worth the
  host round-trip (swap to pinned host numpy, restore later with the
  same install scatter the import path uses); cold one-shot prefixes
  are cheaper to re-prefill than to swap, so they are simply dropped.
* **watermark hysteresis** — the admission/autoscale planes gate on
  pool utilization with separate high/low thresholds so backpressure
  engages *before* exhaustion and does not flap at the boundary.

Everything here is host-side integer/float bookkeeping: no jax import,
no device sync, safe inside the engine lock and the jit-lint hot set.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np


class PrefixCandidate(NamedTuple):
    """One resident prefix entry, as the reclaim ladder sees it.

    ``consumers`` counts active grafts beyond the entry's own reference
    (any block with refcount > 1); ``last_use`` and ``use_count`` come
    from the engine's prefix LRU bookkeeping."""

    pid: int
    num_tokens: int
    num_blocks: int
    consumers: int
    last_use: int
    use_count: int

    @property
    def shared(self) -> bool:
        return self.consumers > 0


def victim_key(cand: PrefixCandidate, now_seq: int) -> Tuple:
    """Sort key: the MINIMUM is the next victim.

    Lexicographic ``(shared, score, pid)``: an unshared prefix always
    loses to the pool before any shared one (evicting a shared prefix
    forces recompute for every consumer — the one inversion the blind
    LRU ladder allowed). Within a tier, ``score`` is recompute-cost
    weighted by recency: cheap-to-rebuild and cold sorts first.
    ``pid`` breaks ties deterministically (oldest registration first).
    """
    age = max(0, now_seq - cand.last_use)
    score = (1 + cand.consumers) * cand.num_tokens / (1.0 + age)
    return (cand.shared, score, cand.pid)


def pick_victim(candidates: Sequence[PrefixCandidate],
                now_seq: int) -> Optional[PrefixCandidate]:
    """The candidate the pool can best afford to lose, or None."""
    if not candidates:
        return None
    return min(candidates, key=lambda c: victim_key(c, now_seq))


def should_tier(cand: PrefixCandidate, *, host_tier: bool,
                tier_min_uses: int) -> bool:
    """Tier (swap to host) instead of evicting (drop + re-prefill)?

    Shared prefixes are always worth keeping — every consumer's prefill
    rides on them. Unshared ones must have proven reuse
    (``use_count >= tier_min_uses``) to pay for the host round-trip.
    With the host tier disabled the answer is always no: the engine
    degrades to the PR-10 behaviour (evict, then preempt)."""
    if not host_tier:
        return False
    return cand.shared or cand.use_count >= tier_min_uses


class HostPrefix(NamedTuple):
    """A prefix swapped out to the host tier: block-layout numpy
    buffers ``(L, nblk, block_size, Hkv, Dh)`` ready to feed the
    ``install_blocks`` scatter directly (pjit ingests host numpy
    without a staging copy — the PR-10 plan-vector trick).

    On a quantized KV ladder (``EngineConfig.kv_dtype``) the payload
    stays quantized end to end: ``k``/``v`` hold int8/fp8 bytes for the
    quantized layers, ``k_scale``/``v_scale`` the per-(block, position,
    head) f32 absmax scales ``(Lq, nblk, block_size, Hkv)``, and
    ``k_hi``/``v_hi`` the optional full-width early-layer prefix — so
    the host-RAM tier footprint halves alongside the device pool.
    All-None trailing fields mean a full-width (bf16-ladder) payload."""

    k: np.ndarray
    v: np.ndarray
    num_tokens: int
    k_scale: Optional[np.ndarray] = None
    v_scale: Optional[np.ndarray] = None
    k_hi: Optional[np.ndarray] = None
    v_hi: Optional[np.ndarray] = None

    @property
    def num_blocks(self) -> int:
        return int(self.k.shape[1])

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def nbytes(self) -> int:
        """Host-RAM footprint of this entry (the byte ledger feeding
        ``senweaver_kv_bytes_host``)."""
        return sum(a.nbytes for a in self[:2] + self[3:]
                   if a is not None)


def blockify_host(k: np.ndarray, v: np.ndarray, nblk: int,
                  block_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """Reshape contiguous host buffers ``(L, T, Hkv, Dh)`` into the
    block layout ``(L, nblk, block_size, Hkv, Dh)``, zero-padding the
    partial last block (the validity window masks the pad)."""
    l, t, hkv, dh = k.shape
    cap = nblk * block_size
    if t < cap:
        pad = np.zeros((l, cap - t, hkv, dh), dtype=k.dtype)
        k = np.concatenate([k, pad], axis=1)
        v = np.concatenate([v, pad], axis=1)
    k = k[:, :cap].reshape(l, nblk, block_size, hkv, dh)
    v = v[:, :cap].reshape(l, nblk, block_size, hkv, dh)
    return np.ascontiguousarray(k), np.ascontiguousarray(v)


def unblockify_host(hp: HostPrefix) -> Tuple[np.ndarray, np.ndarray]:
    """Contiguous ``(L, num_tokens_padded, Hkv, Dh)`` view of a host
    prefix — the export shape (caller pads/crops to its cache cap).
    Raw payload view: quantized entries come back still quantized (use
    :func:`dequantize_host` for full-width exports)."""
    l, nblk, bs, hkv, dh = hp.k.shape
    k = hp.k.reshape(l, nblk * bs, hkv, dh)
    v = hp.v.reshape(l, nblk * bs, hkv, dh)
    return k, v


def dequantize_host(hp: HostPrefix,
                    dtype: np.dtype) -> Tuple[np.ndarray, np.ndarray]:
    """Full-width ``(L, num_tokens_padded, Hkv, Dh)`` buffers from a
    host prefix, dequantizing quantized layers (payload × scale) and
    re-stacking the full-width early-layer prefix in layer order — all
    numpy, no device traffic (``dtype`` may be an ml_dtypes extended
    type like bfloat16; the caller passes the model dtype)."""

    def flat(a):
        return a.reshape(a.shape[0], a.shape[1] * a.shape[2],
                         *a.shape[3:])

    if hp.k_scale is None:
        k, v = unblockify_host(hp)
        return k.astype(dtype, copy=False), v.astype(dtype, copy=False)
    k = (flat(hp.k).astype(np.float32)
         * flat(hp.k_scale)[..., None]).astype(dtype)
    v = (flat(hp.v).astype(np.float32)
         * flat(hp.v_scale)[..., None]).astype(dtype)
    if hp.k_hi is not None:
        k = np.concatenate([flat(hp.k_hi).astype(dtype), k], axis=0)
        v = np.concatenate([flat(hp.v_hi).astype(dtype), v], axis=0)
    return k, v


class WatermarkGate:
    """Two-threshold hysteresis on a 0..1 pressure signal.

    Engages at ``pressure >= high``, releases at ``pressure <= low``;
    between the two it holds its last state, so admission shedding and
    autoscale triggers do not flap as decodes free and re-take blocks
    around a single boundary. Pure state machine — callers provide the
    signal and synchronization."""

    def __init__(self, high: float, low: float):
        if not (0.0 <= low <= high <= 1.0):
            raise ValueError(
                f"watermarks need 0 <= low <= high <= 1, got "
                f"low={low} high={high}")
        self.high = high
        self.low = low
        self._gated = False

    @property
    def gated(self) -> bool:
        return self._gated

    def update(self, pressure: float) -> bool:
        """Feed the latest pressure sample; returns the gate state."""
        if pressure >= self.high:
            self._gated = True
        elif pressure <= self.low:
            self._gated = False
        return self._gated
