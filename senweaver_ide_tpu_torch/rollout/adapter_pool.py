"""Device-resident LoRA adapter pool for batched multi-tenant decode
(PyTorch port).

One base model, many lightweight policies over it: the pool keeps a
fixed-capacity stacked tensor of LoRA A/B factors per target matrix, one
bank per rank rung (adapters are zero-padded up to the smallest rung that
fits), and hands the engine a per-row slot id so the ONE paged step
computes

    base(x) + B[ids[i]] @ (A[ids[i]] @ x)

(``models/transformer.py::_adapter_delta``). Bank shapes are fixed at
construction and slot ids ride beside the flat token batch, so tenant
churn changes no tensor shape the step sees.

Slot 0 of every rung is the permanent NULL adapter (A = B = 0): rows
with no tenant adapter contribute exact zeros, so mixed batches need no
branching. Device slots 1..slots_per_rank are tenant-assignable.

Publish/acquire protocol (the hot-swap contract):

  - ``publish(key, lora)`` validates and zero-pads the adapter, bumps the
    tenant's monotonic ``adapter_version`` and stores a HOST copy.
    Nothing on the device changes: in-flight requests keep decoding
    against the binding they acquired at submit time.
  - ``acquire(key)`` resolves (rung, slot, version) at submit time: a
    resident current-version slot is refcounted, otherwise the host copy
    is uploaded into a free slot (evicting the least recently used slot
    with refs == 0). The binding is held for the request's whole life,
    preemption included, so a mid-decode publish is picked up only by the
    NEXT request.
  - ``release(binding)`` drops the refcount; a stale slot (its tenant has
    since republished or been dropped) frees at refs == 0.

Host copies are stored zero-padded for EVERY pool target (zeros where the
adapter has none), so an upload overwrites every bank of the slot, in
place: no stale weights leak when a slot is reused.

The ``senweaver_serve_adapter_*`` metrics are registered against the
process-global registry at construction, under the JAX package's names.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..models.config import ModelConfig
from ..obs import get_registry

# (in_dim, out_dim) per supported target. Attention only: these are the
# matmuls the paged layer hooks (models/transformer.py ``_qkv`` and
# ``_paged_layer``).
_ATTN_TARGET_DIMS = {
    "wq": lambda c: (c.hidden_size, c.q_dim),
    "wk": lambda c: (c.hidden_size, c.kv_dim),
    "wv": lambda c: (c.hidden_size, c.kv_dim),
    "wo": lambda c: (c.q_dim, c.hidden_size),
}


class AdapterPoolFull(RuntimeError):
    """Every tenant-assignable slot in the rung is pinned by in-flight
    requests; the caller should shed or retry after a release."""


class StaleAdapterVersion(ValueError):
    """Explicit version did not advance the tenant's watermark."""


@dataclasses.dataclass(frozen=True)
class AdapterPoolConfig:
    """Capacity knobs. ``rank_ladder`` must be strictly increasing;
    adapters of rank r land in the smallest rung >= r."""

    rank_ladder: Tuple[int, ...] = (8, 16)
    slots_per_rank: int = 4
    targets: Tuple[str, ...] = ("wq", "wk", "wv", "wo")

    def __post_init__(self):
        if not self.rank_ladder or list(self.rank_ladder) != sorted(
                set(self.rank_ladder)):
            raise ValueError(f"rank_ladder must be strictly increasing, "
                             f"got {self.rank_ladder}")
        if self.slots_per_rank < 1:
            raise ValueError("slots_per_rank must be >= 1")
        bad = set(self.targets) - set(_ATTN_TARGET_DIMS)
        if bad:
            raise ValueError(
                f"unsupported pool targets {sorted(bad)}; the paged "
                f"layer hooks only {sorted(_ATTN_TARGET_DIMS)}")


@dataclasses.dataclass
class _Slot:
    key: Optional[str] = None
    version: int = -1
    refs: int = 0
    tick: int = 0  # LRU stamp (pool-wide monotonic counter)


@dataclasses.dataclass(frozen=True)
class AdapterBinding:
    """Resolved (rung, slot, version) for one request's lifetime.
    ``slot_ids[j]`` is the row's slot id in rung j: its slot in the rung
    it lives in, the null slot 0 everywhere else."""

    key: str
    version: int
    rung: int
    slot: int
    slot_ids: Tuple[int, ...]


def _host_f32(x) -> np.ndarray:
    """An adapter leaf as an fp32 host array: torch tensors on any device
    and dtype (bf16 included), numpy arrays, or anything ``np.asarray``
    reads."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32).numpy()
    return np.asarray(x, np.float32)


class AdapterPool:
    """Fixed-capacity device bank of rank-padded LoRA factors."""

    def __init__(self, config: ModelConfig,
                 pool_config: Optional[AdapterPoolConfig] = None, *,
                 device="cuda"):
        self.config = config
        self.pool_config = pool_config or AdapterPoolConfig()
        self.device = resolve_device(device)
        pc = self.pool_config
        self._lock = threading.RLock()
        self._tick = 0
        L = config.num_layers
        # One bank dict per rung, leading L: forward_paged slices layer i
        # of every leaf, (slots+1, d_in, r) / (slots+1, r, d_out).
        self._banks: List[Dict[str, torch.Tensor]] = []
        for r in pc.rank_ladder:
            bank: Dict[str, torch.Tensor] = {}
            for t in pc.targets:
                d_in, d_out = _ATTN_TARGET_DIMS[t](config)
                bank[t + "_lora_a"] = torch.zeros(
                    (L, pc.slots_per_rank + 1, d_in, r), dtype=config.dtype,
                    device=self.device)
                bank[t + "_lora_b"] = torch.zeros(
                    (L, pc.slots_per_rank + 1, r, d_out), dtype=config.dtype,
                    device=self.device)
            self._banks.append(bank)
        # Device slot i+1 in rung j <-> self._slots[j][i] (slot 0 is the
        # permanent null adapter and has no bookkeeping entry).
        self._slots: List[List[_Slot]] = [
            [_Slot() for _ in range(pc.slots_per_rank)]
            for _ in pc.rank_ladder]
        # key -> (version, rung, {name: fp32 host array}); the padded host
        # copy survives eviction so cold tenants re-upload.
        self._host: Dict[str, Tuple[int, int, Dict[str, np.ndarray]]] = {}

        reg = get_registry()
        self._m_slots = reg.gauge(
            "senweaver_serve_adapter_pool_slots",
            "Tenant-assignable adapter slots per rank rung", ("rank",))
        self._m_resident = reg.gauge(
            "senweaver_serve_adapter_pool_resident",
            "Occupied adapter slots per rank rung", ("rank",))
        self._m_publishes = reg.counter(
            "senweaver_serve_adapter_publishes_total",
            "Adapter host-copy publishes accepted by the pool")
        self._m_installs = reg.counter(
            "senweaver_serve_adapter_installs_total",
            "Adapter uploads into a device slot")
        self._m_evictions = reg.counter(
            "senweaver_serve_adapter_evictions_total",
            "Cold adapter slots reclaimed for another tenant")
        self._m_skew = reg.gauge(
            "senweaver_serve_adapter_version_skew",
            "Max (published - in-flight) adapter version lag")
        self._m_overhead = reg.gauge(
            "senweaver_serve_adapter_gather_overhead_ratio",
            "Gathered multi-LoRA step time over base-only step time")
        for r in pc.rank_ladder:
            self._m_slots.set(pc.slots_per_rank, rank=r)
            self._m_resident.set(0, rank=r)
        self._m_skew.set(0)

    # ------------------------------------------------------------------
    # device side

    @property
    def num_rungs(self) -> int:
        return len(self.pool_config.rank_ladder)

    def banks(self) -> Tuple[Dict[str, torch.Tensor], ...]:
        """The per-rung bank dicts passed to every fused step. Uploads
        write into these tensors in place; their shapes and dtypes are
        fixed at construction."""
        with self._lock:
            return tuple(self._banks)

    def bank_bytes(self) -> int:
        """Device bytes of every bank of every rung."""
        with self._lock:
            return sum(a.numel() * a.element_size()
                       for bank in self._banks for a in bank.values())

    def null_ids(self) -> Tuple[int, ...]:
        return (0,) * self.num_rungs

    # ------------------------------------------------------------------
    # publish / acquire / release

    def publish(self, key: str, lora: Dict[str, Any], *,
                version: Optional[int] = None) -> int:
        """Accept a tenant adapter (``init_lora``-shaped tree or its bare
        layers dict), zero-pad it to its rung, bump the tenant's monotonic
        version and store the host copy. Device state is untouched:
        in-flight bindings keep their slot."""
        pc = self.pool_config
        layers = lora.get("layers", lora) if isinstance(lora, dict) else None
        if not isinstance(layers, dict) or not layers:
            raise ValueError("adapter must be a non-empty lora tree")
        names = sorted(layers)
        targets = sorted({n.split("_lora_")[0] for n in names
                          if "_lora_" in n})
        if len(targets) * 2 != len(names) or not targets:
            raise ValueError(f"malformed adapter leaves: {names}")
        bad = set(targets) - set(pc.targets)
        if bad:
            raise ValueError(
                f"adapter targets {sorted(bad)} not in pool targets "
                f"{sorted(pc.targets)}")
        ranks = {int(tuple(layers[t + "_lora_a"].shape)[-1])
                 for t in targets}
        if len(ranks) != 1:
            raise ValueError(f"mixed adapter ranks {sorted(ranks)}")
        rank = ranks.pop()
        rung = next((j for j, r in enumerate(pc.rank_ladder) if r >= rank),
                    None)
        if rung is None:
            raise ValueError(f"adapter rank {rank} exceeds ladder "
                             f"{pc.rank_ladder}")
        R = pc.rank_ladder[rung]
        L = self.config.num_layers
        # Padded fp32 host copies for EVERY pool target (zeros where the
        # adapter has none) so an install overwrites the whole slot.
        host: Dict[str, np.ndarray] = {}
        for t in pc.targets:
            d_in, d_out = _ATTN_TARGET_DIMS[t](self.config)
            a = np.zeros((L, d_in, R), np.float32)
            b = np.zeros((L, R, d_out), np.float32)
            if t in targets:
                src_a = _host_f32(layers[t + "_lora_a"])
                src_b = _host_f32(layers[t + "_lora_b"])
                if src_a.shape != (L, d_in, rank) or \
                        src_b.shape != (L, rank, d_out):
                    raise ValueError(
                        f"{t}: expected A (L={L},{d_in},{rank}) / "
                        f"B (L={L},{rank},{d_out}), got "
                        f"{src_a.shape} / {src_b.shape}")
                a[:, :, :rank] = src_a
                b[:, :rank, :] = src_b
            host[t + "_lora_a"] = a
            host[t + "_lora_b"] = b
        with self._lock:
            cur = self._host.get(key)
            cur_version = cur[0] if cur is not None else 0
            new_version = cur_version + 1 if version is None else int(version)
            if new_version <= cur_version:
                raise StaleAdapterVersion(
                    f"adapter {key!r} version {new_version} <= "
                    f"published {cur_version}")
            self._host[key] = (new_version, rung, host)
            self._m_publishes.inc()
            # A now-stale resident slot with no readers frees eagerly; one
            # with in-flight readers stays until the last release.
            for rung_slots in self._slots:
                for s in rung_slots:
                    if s.key == key and s.version != new_version \
                            and s.refs == 0:
                        s.key, s.version = None, -1
            self._refresh_gauges_locked()
            return new_version

    def drop(self, key: str) -> bool:
        """Forget a tenant's host copy; resident slots with no readers
        free immediately, pinned slots free at their last release."""
        with self._lock:
            if key not in self._host:
                return False
            del self._host[key]
            for rung_slots in self._slots:
                for s in rung_slots:
                    if s.key == key and s.refs == 0:
                        s.key, s.version = None, -1
            self._refresh_gauges_locked()
            return True

    def has(self, key: Optional[str]) -> bool:
        if key is None:
            return False
        with self._lock:
            return key in self._host

    def version(self, key: str) -> Optional[int]:
        with self._lock:
            entry = self._host.get(key)
            return entry[0] if entry is not None else None

    def resident(self, key: str) -> bool:
        """True when the tenant's CURRENT version occupies a slot."""
        with self._lock:
            entry = self._host.get(key)
            if entry is None:
                return False
            version, rung, _ = entry
            return any(s.key == key and s.version == version
                       for s in self._slots[rung])

    def acquire(self, key: str) -> AdapterBinding:
        """Resolve the tenant's current version to a refcounted device
        slot, uploading on demand. Raises ``KeyError`` for unknown tenants
        and ``AdapterPoolFull`` when every slot of the rung is pinned."""
        with self._lock:
            entry = self._host.get(key)
            if entry is None:
                raise KeyError(f"no adapter published for {key!r}")
            version, rung, host = entry
            self._tick += 1
            rung_slots = self._slots[rung]
            for i, s in enumerate(rung_slots):
                if s.key == key and s.version == version:
                    s.refs += 1
                    s.tick = self._tick
                    return self._binding_locked(key, version, rung, i + 1)
            # Miss: a free slot first, else evict the LRU unpinned one.
            idx = next((i for i, s in enumerate(rung_slots)
                        if s.key is None), None)
            if idx is None:
                idle = [(s.tick, i) for i, s in enumerate(rung_slots)
                        if s.refs == 0]
                if not idle:
                    raise AdapterPoolFull(
                        f"rank-{self.pool_config.rank_ladder[rung]} rung: "
                        f"all {len(rung_slots)} slots pinned by in-flight "
                        f"requests")
                idx = min(idle)[1]
                self._m_evictions.inc()
            slot = idx + 1
            # in place: the step reads these very tensors (an upload is
            # queued after every earlier launch that read the slot)
            for name, arr in host.items():
                self._banks[rung][name][:, slot].copy_(torch.from_numpy(arr))
            self._m_installs.inc()
            st = rung_slots[idx]
            st.key, st.version, st.refs, st.tick = key, version, 1, self._tick
            self._refresh_gauges_locked()
            return self._binding_locked(key, version, rung, slot)

    def retain(self, binding: AdapterBinding) -> AdapterBinding:
        """Pin ANOTHER reference to an existing binding's exact (key,
        version, slot): the version-exact sibling of :meth:`acquire`. A
        forked child (group follower, tree branch) must decode under its
        parent's pinned adapter version even if a newer publish has
        landed. Raises ``KeyError`` when the slot was recycled past the
        binding (the parent already released it)."""
        with self._lock:
            s = self._slots[binding.rung][binding.slot - 1]
            if s.key != binding.key or s.version != binding.version:
                raise KeyError(
                    f"adapter slot recycled past binding {binding.key!r} "
                    f"v{binding.version}")
            self._tick += 1
            s.refs += 1
            s.tick = self._tick
            self._refresh_gauges_locked()
            return binding

    def release(self, binding: AdapterBinding) -> None:
        with self._lock:
            s = self._slots[binding.rung][binding.slot - 1]
            if s.key != binding.key or s.version != binding.version:
                return  # slot already recycled past this binding
            s.refs = max(0, s.refs - 1)
            if s.refs == 0:
                entry = self._host.get(binding.key)
                if entry is None or entry[0] != s.version:
                    s.key, s.version = None, -1  # stale: free now
            self._refresh_gauges_locked()

    def _binding_locked(self, key: str, version: int, rung: int,
                        slot: int) -> AdapterBinding:
        ids = [0] * self.num_rungs
        ids[rung] = slot
        return AdapterBinding(key=key, version=version, rung=rung,
                              slot=slot, slot_ids=tuple(ids))

    # ------------------------------------------------------------------
    # introspection

    def note_gather_overhead(self, ratio: float) -> None:
        """Bench hook: adapter step time over base-only step time."""
        self._m_overhead.set(float(ratio))

    def _skew_locked(self) -> int:
        skew = 0
        for rung_slots in self._slots:
            for s in rung_slots:
                entry = self._host.get(s.key) if s.key is not None else None
                if entry is not None:
                    skew = max(skew, entry[0] - s.version)
        return skew

    def _refresh_gauges_locked(self) -> None:
        for j, rung_slots in enumerate(self._slots):
            self._m_resident.set(
                sum(s.key is not None for s in rung_slots),
                rank=self.pool_config.rank_ladder[j])
        self._m_skew.set(self._skew_locked())

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            rungs = []
            for j, rung_slots in enumerate(self._slots):
                occupied = [
                    {"slot": i + 1, "key": s.key, "version": s.version,
                     "refs": s.refs}
                    for i, s in enumerate(rung_slots) if s.key is not None]
                rungs.append({
                    "rank": self.pool_config.rank_ladder[j],
                    "slots": len(rung_slots),
                    "resident": len(occupied),
                    "occupants": occupied,
                })
            return {
                "adapters": {k: v[0] for k, v in self._host.items()},
                "rungs": rungs,
                "version_skew": self._skew_locked(),
                "publishes": self._m_publishes.value(),
                "installs": self._m_installs.value(),
                "evictions": self._m_evictions.value(),
            }
