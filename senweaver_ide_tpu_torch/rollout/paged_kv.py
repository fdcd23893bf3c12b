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
Blocks move in and out of the pool as whole sets: :func:`install_blocks`
/ :func:`install_blocks_quant` write a prefix's KV into pool blocks IN
PLACE (the JAX version returns a new, donated pool), and
:func:`gather_blocks` / :func:`gather_blocks_quant` return NEW tensors,
never views of the pool, so a later write into a reused block cannot
change what was gathered (exports, the host tier).

The allocator is pure host bookkeeping behind its own reentrant lock (lock
order engine → allocator). It publishes the ``senweaver_kv_*`` gauges and
counters the JAX package's allocator does into the metrics registry
(``obs``).

**Quantized KV ladder** (``EngineConfig.kv_dtype``): the pool can store
int8/fp8 payloads plus per-(block, position, head) f32 absmax scales,
quantized at write time inside the engine's fused step. A
``kv_dtype_per_layer`` override keeps a full-width prefix of layers in
``k_hi``/``v_hi``.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, NamedTuple, Optional, Sequence

import torch

from ..device import resolve_device
from ..models.config import ModelConfig
from ..models.transformer import dequantize_pool_kv, quantize_pool_kv
from ..obs.runtime_profile import ProfiledFunction

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

    @property
    def full_dtype(self) -> torch.dtype:
        """The full-width dtype this pool dequantizes to."""
        if self.k_hi is not None:
            return self.k_hi.dtype
        return self.k.dtype if self.k_scale is None else torch.bfloat16


class BlockPayload(NamedTuple):
    """Pool-native payload of a set of blocks: the quantization-preserving
    unit of KV movement (host-RAM tier, quantized prefix export). Fields
    mirror :class:`PagedKVPool` with the pool axis replaced by the
    gathered block axis ``(·, n, block_size, ...)``; tensors may live on
    the card or the host (both sides of a swap)."""

    k: Any
    v: Any
    k_scale: Any = None
    v_scale: Any = None
    k_hi: Any = None
    v_hi: Any = None


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
                 registry=None, bytes_per_block: int = 0):
        if num_blocks <= 0 or block_size <= 0:
            raise ValueError("num_blocks and block_size must be positive")
        self.num_blocks = num_blocks
        self.block_size = block_size
        # Device bytes per block (see pool_bytes_per_block); 0 = unknown,
        # and the byte gauges then publish 0.
        self.bytes_per_block = int(bytes_per_block)
        # blocks resident only in the host-RAM tier
        self._swapped_blocks = 0
        self._lock = threading.RLock()
        # LIFO free list: recently freed blocks are reused first.
        self._free: List[int] = list(range(num_blocks - 1, -1, -1))  # guarded-by: _lock
        self._ref: List[int] = [0] * num_blocks  # guarded-by: _lock
        self._counters: Dict[str, int] = {  # guarded-by: _lock
            "allocs": 0, "releases": 0, "grafts": 0, "cow_copies": 0,
            "exhaustions": 0, "install_copies": 0, "evictions": 0,
            "swap_outs": 0, "swap_ins": 0}
        if registry is None:
            from ..obs import get_registry
            registry = get_registry()
        self._blocks_total_gauge = registry.gauge(
            "senweaver_kv_blocks_total",
            "KV block-pool capacity of the most recently updated engine.")
        self._blocks_free_gauge = registry.gauge(
            "senweaver_kv_blocks_free",
            "Free KV blocks in the pool.")
        self._util_gauge = registry.gauge(
            "senweaver_kv_pool_utilization",
            "Fraction of KV blocks currently allocated (0..1).")
        self._frag_gauge = registry.gauge(
            "senweaver_kv_fragmentation",
            "Internal fragmentation: fraction of allocated KV-block "
            "capacity holding no token (partial last blocks).")
        self._cow_total = registry.counter(
            "senweaver_kv_cow_copies_total",
            "Copy-on-write block copies (first divergent write into a "
            "shared block).")
        self._graft_total = registry.counter(
            "senweaver_kv_prefix_grafts_total",
            "Prefix installs served by block-table graft (refcount bump, "
            "zero KV bytes copied).")
        self._install_copy_total = registry.counter(
            "senweaver_kv_install_copies_total",
            "Prefix installs that copied KV buffers into place (slot "
            "layout, or paged cross-engine import scatter).")
        self._exhaustion_total = registry.counter(
            "senweaver_kv_exhaustion_rejections_total",
            "Allocations refused because the block pool was exhausted "
            "(preemptions + admission rejections).")
        self._eviction_total = registry.counter(
            "senweaver_kv_evictions_total",
            "Prefix entries dropped by scored eviction (cold, unshared: "
            "cheapest to recompute).")
        self._swap_out_total = registry.counter(
            "senweaver_kv_swaps_out_total",
            "KV blocks swapped from the device pool to the host-RAM "
            "tier (warm prefixes under pressure).")
        self._swap_in_total = registry.counter(
            "senweaver_kv_swaps_in_total",
            "KV blocks restored from the host-RAM tier into the device "
            "pool (on-demand prefix reuse).")
        self._swapped_gauge = registry.gauge(
            "senweaver_kv_swapped_blocks",
            "KV blocks currently resident only in the host-RAM tier.")
        # byte twins of the block gauges: a quantized pool's block holds
        # fewer bytes, so capacity math happens in bytes
        self._bytes_device_gauge = registry.gauge(
            "senweaver_kv_bytes_device",
            "Device bytes held by allocated KV blocks (payload + "
            "scales + full-width prefix layers).")
        self._bytes_host_gauge = registry.gauge(
            "senweaver_kv_bytes_host",
            "Host-RAM bytes held by KV blocks swapped to the host "
            "tier.")
        self._publish_gauges()

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

    @property
    def swapped_bytes(self) -> int:
        """Host-tier bytes held by swapped-out blocks."""
        return self._swapped_blocks * self.bytes_per_block

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
                self._exhaustion_total.inc()
                raise BlocksExhausted(n, len(self._free), self.num_blocks)
            blocks = [self._free.pop() for _ in range(n)]
            for b in blocks:
                self._ref[b] = 1
            self._counters["allocs"] += n
            self._publish_gauges()
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
            self._publish_gauges()

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
            self._graft_total.inc(n)
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
            self._cow_total.inc()
            return fresh

    def count_install_copy(self, n: int = 1) -> None:
        """Account a buffer-copy prefix install (the non-graft path)."""
        with self._lock:
            self._counters["install_copies"] += n
            self._install_copy_total.inc(n)

    def count_eviction(self, n: int = 1) -> None:
        """Account ``n`` prefix entries dropped by scored eviction."""
        with self._lock:
            self._counters["evictions"] += n
            self._eviction_total.inc(n)

    def count_swap_out(self, nblk: int) -> None:
        """Account ``nblk`` blocks tiered device → host."""
        with self._lock:
            self._counters["swap_outs"] += nblk
            self._swap_out_total.inc(nblk)

    def count_swap_in(self, nblk: int) -> None:
        """Account ``nblk`` blocks restored host → device."""
        with self._lock:
            self._counters["swap_ins"] += nblk
            self._swap_in_total.inc(nblk)

    def set_swapped_blocks(self, n: int) -> None:
        """Publish how many blocks live only in the host tier (block
        count and bytes)."""
        with self._lock:
            self._swapped_blocks = n
            self._swapped_gauge.set(n)
            self._bytes_host_gauge.set(n * self.bytes_per_block)

    # -- gauges ----------------------------------------------------------
    def _publish_gauges(self) -> None:
        # guarded-by: caller
        free = len(self._free)
        self._blocks_total_gauge.set(self.num_blocks)
        self._blocks_free_gauge.set(free)
        used = self.num_blocks - free
        self._util_gauge.set(used / self.num_blocks)
        self._bytes_device_gauge.set(used * self.bytes_per_block)

    def publish_fragmentation(self, used_tokens: int) -> None:
        """Internal-fragmentation gauge: ``used_tokens`` positions live
        across ``used_blocks * block_size`` allocated capacity; the
        difference is stranded tail space in partial last blocks."""
        with self._lock:
            cap = self.used_blocks * self.block_size
            frac = 0.0 if cap == 0 else 1.0 - (used_tokens / cap)
            self._frag_gauge.set(max(0.0, frac))


class PagedSeqKV:
    """One sequence's paged cache: a private pool + allocator + table.

    The speculative decoder's verify path uses this instead of a
    contiguous ``KVCache``: each verify round writes up to ``k`` draft
    tokens past the accepted prefix, and a rejection must ROLL BACK —
    :meth:`truncate` releases every block past the accepted length, so
    rejected drafts can never leak pool capacity (checked by
    ``allocator.check_leaks``). The pool lives on ``device`` (the card
    unless the caller asks for the CPU) and takes the kv-dtype ladder of
    :func:`init_paged_pool`."""

    def __init__(self, config: ModelConfig, *, max_len: int,
                 block_size: int = 16, num_blocks: Optional[int] = None,
                 registry=None, kv_dtype: str = "bf16",
                 kv_dtype_per_layer=None, device="cuda"):
        if num_blocks is None:
            num_blocks = -(-max_len // block_size)
        self.pool = init_paged_pool(config, num_blocks, block_size,
                                    kv_dtype=kv_dtype,
                                    kv_dtype_per_layer=kv_dtype_per_layer,
                                    device=device)
        self.allocator = BlockAllocator(
            num_blocks, block_size, registry=registry,
            bytes_per_block=pool_bytes_per_block(self.pool))
        self.max_blocks = -(-max_len // block_size)
        self.table: List[int] = []
        self.length = 0

    def ensure(self, new_len: int) -> None:
        """Grow the table to cover positions ``< new_len``."""
        need = self.allocator.blocks_for(new_len)
        if need > len(self.table):
            self.table.extend(self.allocator.alloc(need - len(self.table)))

    def truncate(self, length: int) -> None:
        """Roll back to ``length`` valid tokens, RELEASING every block
        past the boundary; stale data inside the kept partial block lies
        past ``length`` and is never read."""
        keep = self.allocator.blocks_for(length)
        if keep < len(self.table):
            self.allocator.release(self.table[keep:])
            del self.table[keep:]
        self.length = length

    def free(self) -> None:
        """Release the whole table (end of generation)."""
        self.truncate(0)

    def tables_array(self) -> torch.Tensor:
        """Dense (1, max_blocks) int32 table row for forward_paged, on the
        host (forward_paged moves it)."""
        row = self.table + [0] * (self.max_blocks - len(self.table))
        return torch.tensor([row], dtype=torch.int32)


def _index(idx, device) -> torch.Tensor:
    return torch.as_tensor(idx, dtype=torch.int64).to(device)


def install_blocks(pool: PagedKVPool, k_buf: torch.Tensor,
                   v_buf: torch.Tensor, dst) -> PagedKVPool:
    """Write FULL-WIDTH buffers ``(L, n, block_size, Hkv, Dh)`` into pool
    blocks ``dst`` ``(n,)``, in place: the prefix install. A quantized
    pool quantizes here with the fused step's absmax rule, so installed
    and decoded blocks hold the same payloads; the ``hi_layers`` prefix
    stays full width."""
    dev = pool.k.device
    dst = _index(dst, dev)
    k_buf, v_buf = k_buf.to(dev), v_buf.to(dev)
    if pool.k_scale is None:
        pool.k[:, dst] = k_buf.to(pool.k.dtype)
        pool.v[:, dst] = v_buf.to(pool.v.dtype)
        return pool
    n_hi = pool.hi_layers
    if n_hi:
        pool.k_hi[:, dst] = k_buf[:n_hi].to(pool.k_hi.dtype)
        pool.v_hi[:, dst] = v_buf[:n_hi].to(pool.v_hi.dtype)
    kq, ks = quantize_pool_kv(k_buf[n_hi:], pool.k.dtype)
    vq, vs = quantize_pool_kv(v_buf[n_hi:], pool.v.dtype)
    pool.k[:, dst] = kq
    pool.v[:, dst] = vq
    pool.k_scale[:, dst] = ks
    pool.v_scale[:, dst] = vs
    return pool


def install_blocks_quant(pool: PagedKVPool, payload: BlockPayload,
                         dst) -> PagedKVPool:
    """Write a pool-native :class:`BlockPayload` into blocks ``dst``, in
    place: the inverse of :func:`gather_blocks_quant` (host-tier restore,
    quantized prefix import). The payload must come from a pool on the
    same ladder rung."""
    if ((payload.k_scale is None) != (pool.k_scale is None)
            or (payload.k_hi is None) != (pool.k_hi is None)):
        raise ValueError(
            "BlockPayload quantization layout does not match the pool "
            "(payload must come from a pool on the same kv_dtype rung)")
    dev = pool.k.device
    dst = _index(dst, dev)
    for name in BlockPayload._fields:
        src = getattr(payload, name)
        if src is not None:
            a = getattr(pool, name)
            a[:, dst] = torch.as_tensor(src).to(dev, a.dtype)
    return pool


def gather_blocks(pool: PagedKVPool, idx, dtype=None):
    """FULL-WIDTH ``(L, n*block_size, Hkv, Dh)`` copies of pool blocks
    ``idx`` ``(n,)``: the prefix export. Quantized pools dequantize here
    (and re-stack the full-width prefix layers). ``dtype`` defaults to
    the pool's full-width dtype."""
    idx = _index(idx, pool.k.device)
    bs, n = pool.block_size, idx.shape[0]
    if dtype is None:
        dtype = pool.full_dtype

    def flat(a):
        return a[:, idx].reshape(a.shape[0], n * bs, *a.shape[3:])

    if pool.k_scale is None:
        return flat(pool.k).to(dtype), flat(pool.v).to(dtype)
    k = dequantize_pool_kv(flat(pool.k), flat(pool.k_scale), dtype)
    v = dequantize_pool_kv(flat(pool.v), flat(pool.v_scale), dtype)
    if pool.k_hi is not None:
        k = torch.cat([flat(pool.k_hi).to(dtype), k], dim=0)
        v = torch.cat([flat(pool.v_hi).to(dtype), v], dim=0)
    return k, v


def gather_blocks_quant(pool: PagedKVPool, idx) -> BlockPayload:
    """Raw block-layout copies of pool blocks ``idx``: quantized payloads
    stay quantized (int8/fp8 bytes + scales), half the host-tier bytes of
    :func:`gather_blocks`."""
    idx = _index(idx, pool.k.device)
    return BlockPayload(*(None if a is None else a[:, idx] for a in pool))


# Runtime observatory wiring (obs/runtime_profile.py): block movement is
# profiled under the JAX package's names.
copy_blocks = ProfiledFunction(copy_blocks, "paged_kv.copy",
                               storm_threshold=32)
install_blocks = ProfiledFunction(install_blocks, "paged_kv.install",
                                  storm_threshold=32)
install_blocks_quant = ProfiledFunction(
    install_blocks_quant, "paged_kv.install_quant", storm_threshold=32)
gather_blocks = ProfiledFunction(gather_blocks, "paged_kv.gather",
                                 storm_threshold=32)
gather_blocks_quant = ProfiledFunction(
    gather_blocks_quant, "paged_kv.gather_quant", storm_threshold=32)
