"""Paged KV cache: block pool, free-list allocator, copy-on-write tables.

KV lives in a fixed device pool of fixed-size blocks

    pool.k / pool.v : (L, num_blocks, block_size, Hkv, Dh)

and each request owns a host-side block table, one physical block id per
``block_size`` span of its sequence. Attention reads through the
``(request, logical_block) -> physical_block`` indirection
(``models.transformer.forward_paged``); capacity is governed by the
:class:`BlockAllocator`: O(1) free-list alloc/release of whole blocks,
refcounted sharing (``fork``), copy-on-write (``cow_target`` +
:func:`copy_blocks`) and typed backpressure (:class:`BlocksExhausted`).

The allocator is pure host bookkeeping behind its own reentrant lock (lock
order engine → allocator). It publishes no metrics yet: the metrics
registry comes with the observability slice.

**Quantized KV ladder** (``EngineConfig.kv_dtype``): the pool can store
int8/fp8 payloads plus per-(block, position, head) f32 absmax scales,
quantized at write time inside the engine's fused step. A
``kv_dtype_per_layer`` override keeps a full-width prefix of layers in
``k_hi``/``v_hi``.
"""

from __future__ import annotations

import threading
from typing import Dict, List, NamedTuple, Optional, Sequence

import torch

from ..device import resolve_device
from ..models.config import ModelConfig

# The serving-wide KV precision ladder. "bf16" means "full width": the
# pool stores the model dtype (bf16 for the real presets, f32 in the test
# configs). int8/fp8 store quantized payloads plus f32 absmax scales.
KV_DTYPES = ("bf16", "int8", "fp8")


def kv_payload_dtype(name: str) -> torch.dtype:
    """Payload dtype for one quantized rung of the ladder."""
    if name == "int8":
        return torch.int8
    if name == "fp8":
        return torch.float8_e4m3fn
    raise ValueError(f"unknown quantized kv_dtype {name!r}; "
                     f"expected one of {KV_DTYPES}")


def resolve_kv_dtypes(num_layers: int, kv_dtype: str,
                      kv_dtype_per_layer=None):
    """Validate the precision ladder → ``(payload_dtype | None, hi_layers)``.

    ``payload_dtype`` is None for a full-width pool. A per-layer override
    must be a contiguous "bf16" PREFIX (the ``hi_layers`` full-width
    layers) followed by one uniform quantized dtype."""
    if kv_dtype not in KV_DTYPES:
        raise ValueError(f"kv_dtype must be one of {KV_DTYPES}, "
                         f"got {kv_dtype!r}")
    if kv_dtype_per_layer is None:
        if kv_dtype == "bf16":
            return None, 0
        return kv_payload_dtype(kv_dtype), 0
    per = tuple(kv_dtype_per_layer)
    if len(per) != num_layers:
        raise ValueError(
            f"kv_dtype_per_layer has {len(per)} entries for "
            f"{num_layers} layers")
    for name in per:
        if name not in KV_DTYPES:
            raise ValueError(f"kv_dtype_per_layer entry {name!r} not "
                             f"in {KV_DTYPES}")
    n_hi = 0
    while n_hi < num_layers and per[n_hi] == "bf16":
        n_hi += 1
    tail = set(per[n_hi:])
    if not tail:
        return None, 0          # all-bf16 override → plain pool
    if len(tail) != 1:
        raise ValueError(
            "kv_dtype_per_layer must be a contiguous 'bf16' prefix "
            f"followed by one uniform quantized dtype, got {per}")
    (qname,) = tail
    if kv_dtype != "bf16" and qname != kv_dtype:
        raise ValueError(
            f"kv_dtype_per_layer tail {qname!r} contradicts "
            f"kv_dtype={kv_dtype!r}")
    return kv_payload_dtype(qname), n_hi


class BlocksExhausted(RuntimeError):
    """The block pool cannot satisfy an allocation. Typed so the engine
    can preempt and requeue on it."""

    def __init__(self, requested: int, free: int, num_blocks: int):
        super().__init__(
            f"KV block pool exhausted: requested {requested} block(s), "
            f"{free} free of {num_blocks}")
        self.requested = requested
        self.free = free
        self.num_blocks = num_blocks


class PagedKVPool(NamedTuple):
    """The device-side block pool. ``k``/``v`` are
    ``(L, num_blocks, block_size, Hkv, Dh)``; writers address "drop this
    write" as block id ``num_blocks``.

    A quantized pool stores the payload in ``k``/``v`` at reduced width
    plus f32 scales ``k_scale``/``v_scale`` ``(Lq, num_blocks,
    block_size, Hkv)``; with a ``kv_dtype_per_layer`` override the first
    ``hi_layers`` layers live full-width in ``k_hi``/``v_hi`` and the
    payload holds only the quantized tail (``Lq = L - hi_layers``)."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None
    k_hi: Optional[torch.Tensor] = None
    v_hi: Optional[torch.Tensor] = None

    @property
    def num_blocks(self) -> int:
        return self.k.shape[1]

    @property
    def block_size(self) -> int:
        return self.k.shape[2]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def hi_layers(self) -> int:
        return 0 if self.k_hi is None else self.k_hi.shape[0]

    @property
    def num_layers(self) -> int:
        return self.hi_layers + self.k.shape[0]


def init_paged_pool(config: ModelConfig, num_blocks: int,
                    block_size: int, kv_dtype: str = "bf16",
                    kv_dtype_per_layer=None, *,
                    device="cuda") -> PagedKVPool:
    """Zeroed pool sized for ``config`` on ``device``. ``kv_dtype``
    selects the precision ladder rung; ``kv_dtype_per_layer`` optionally
    keeps a bf16 prefix of layers full-width."""
    dev = resolve_device(device)
    hkv, dh = config.num_kv_heads, config.head_dim
    num_layers = config.num_layers
    payload, n_hi = resolve_kv_dtypes(num_layers, kv_dtype,
                                      kv_dtype_per_layer)

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)

    if payload is None:
        shape = (num_layers, num_blocks, block_size, hkv, dh)
        return PagedKVPool(k=zeros(shape, config.dtype),
                           v=zeros(shape, config.dtype))
    lq = num_layers - n_hi
    qshape = (lq, num_blocks, block_size, hkv, dh)
    sshape = qshape[:-1]
    hi_shape = (n_hi, num_blocks, block_size, hkv, dh)
    return PagedKVPool(
        k=zeros(qshape, payload), v=zeros(qshape, payload),
        k_scale=zeros(sshape, torch.float32),
        v_scale=zeros(sshape, torch.float32),
        k_hi=zeros(hi_shape, config.dtype) if n_hi else None,
        v_hi=zeros(hi_shape, config.dtype) if n_hi else None)


def pool_bytes_per_block(pool: PagedKVPool) -> int:
    """Device bytes one block occupies across every pool tensor
    (payload + scales + full-width prefix)."""
    total = 0
    for a in pool:
        if a is not None:
            total += a.numel() * a.element_size()
    return total // pool.num_blocks


def copy_blocks(pool: PagedKVPool, src: Sequence[int],
                dst: Sequence[int]) -> PagedKVPool:
    """Copy pool blocks ``src[i] -> dst[i]`` in place, across every pool
    tensor (payload, scales, full-width prefix): the COW copy. A copied
    block carries its scales with it."""
    dev = pool.k.device
    src_t = torch.as_tensor(list(src), dtype=torch.int64, device=dev)
    dst_t = torch.as_tensor(list(dst), dtype=torch.int64, device=dev)
    for a in pool:
        if a is not None:
            a[:, dst_t] = a[:, src_t]
    return pool


class BlockAllocator:
    """Host-side free-list + refcount bookkeeping for one
    :class:`PagedKVPool`. All methods are O(blocks touched); none touches
    the device. Thread-safe behind its own reentrant lock (the engine
    calls it under the engine lock; lock order is always engine →
    allocator)."""

    def __init__(self, num_blocks: int, block_size: int, *,
                 bytes_per_block: int = 0):
        if num_blocks <= 0 or block_size <= 0:
            raise ValueError("num_blocks and block_size must be positive")
        self.num_blocks = num_blocks
        self.block_size = block_size
        # Device bytes per block (see pool_bytes_per_block); 0 = unknown.
        self.bytes_per_block = int(bytes_per_block)
        self._lock = threading.RLock()
        # LIFO free list: recently freed blocks are reused first.
        self._free: List[int] = list(range(num_blocks - 1, -1, -1))  # guarded-by: _lock
        self._ref: List[int] = [0] * num_blocks  # guarded-by: _lock
        self._counters: Dict[str, int] = {  # guarded-by: _lock
            "allocs": 0, "releases": 0, "grafts": 0, "cow_copies": 0,
            "exhaustions": 0}

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return self.num_blocks - len(self._free)

    @property
    def used_bytes(self) -> int:
        """Device bytes held by allocated blocks (0 when the allocator
        was built without a ``bytes_per_block``)."""
        return self.used_blocks * self.bytes_per_block

    def refcount(self, block: int) -> int:
        return self._ref[block]

    def counters(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counters)

    def blocks_for(self, num_tokens: int) -> int:
        """Blocks needed to hold ``num_tokens`` positions."""
        return -(-num_tokens // self.block_size)

    def check_leaks(self) -> None:
        """Raise when any block is still referenced (every table must be
        released): the refcount-leak tripwire the tests use."""
        with self._lock:
            if len(self._free) != self.num_blocks:
                held = [i for i, r in enumerate(self._ref) if r > 0]
                shared = [(i, r) for i, r in enumerate(self._ref) if r > 1]
                detail = (f"; {len(shared)} shared (block, refs): "
                          f"{shared[:8]}" if shared else "")
                raise AssertionError(
                    f"KV block leak: {len(held)} block(s) still "
                    f"referenced: {held[:16]}{detail}")

    def alloc(self, n: int) -> List[int]:
        """``n`` fresh blocks at refcount 1, or :class:`BlocksExhausted`
        (all-or-nothing: a partial grant would deadlock two requests each
        holding half the pool)."""
        with self._lock:
            if n > len(self._free):
                self._counters["exhaustions"] += 1
                raise BlocksExhausted(n, len(self._free), self.num_blocks)
            blocks = [self._free.pop() for _ in range(n)]
            for b in blocks:
                self._ref[b] = 1
            self._counters["allocs"] += n
            return blocks

    def retain(self, blocks: Sequence[int]) -> None:
        """Refcount bump for every block (sharing, not ownership
        transfer)."""
        with self._lock:
            for b in blocks:
                if self._ref[b] <= 0:
                    raise ValueError(f"retain of free block {b}")
                self._ref[b] += 1

    def release(self, blocks: Sequence[int]) -> None:
        """Drop one reference per block; blocks reaching refcount 0
        return to the free list. Ids at/above ``num_blocks`` are the
        dropped-write sentinel and are skipped."""
        with self._lock:
            for b in blocks:
                if b >= self.num_blocks:
                    continue                    # dropped-write sentinel
                if self._ref[b] <= 0:
                    raise ValueError(f"release of free block {b}")
                self._ref[b] -= 1
                if self._ref[b] == 0:
                    self._free.append(b)
                    self._counters["releases"] += 1

    def fork(self, table: Sequence[int]) -> List[int]:
        """A new table aliasing every block of ``table`` (the graft:
        zero device bytes move). Sentinel ids are kept but never
        refcounted."""
        return self.fork_n(table, 1)[0]

    def fork_n(self, table: Sequence[int], n: int) -> List[List[int]]:
        """``n`` independent aliases of ``table`` in one lock pass; each
        carries one reference per real block. All-or-nothing: a free
        block anywhere in the table raises before any refcount moves."""
        if n <= 0:
            return []
        with self._lock:
            real = [b for b in table if b < self.num_blocks]
            for b in real:
                if self._ref[b] <= 0:
                    raise ValueError(f"fork of free block {b}")
            for b in real:
                self._ref[b] += n
            self._counters["grafts"] += n
            return [list(table) for _ in range(n)]

    def cow_target(self, block: int) -> Optional[int]:
        """Copy-on-write check before writing into ``block``: None when
        the caller owns it exclusively (write in place), else a fresh
        block the caller must :func:`copy_blocks` into and point its table
        at (the old reference is released here). May raise
        :class:`BlocksExhausted`; the shared block is untouched then."""
        with self._lock:
            if self._ref[block] <= 0:
                raise ValueError(f"cow_target of free block {block}")
            if self._ref[block] == 1:
                return None
            fresh = self.alloc(1)[0]
            # drop our reference only after the fresh block is granted
            self.release([block])
            self._counters["cow_copies"] += 1
            return fresh
