"""Continuous-batching rollout engine (PyTorch port).

The engine keeps ONE resident batch on the device: ``num_slots`` rows
over one of two KV layouts.

**Paged** (the default, rollout/paged_kv.py): each row has a host-side
block table into a shared KV block pool. Every :meth:`RolloutEngine.step`
runs one fused forward over a flat token batch: one decode entry per
active row, then exact-size chunked-prefill segments under the
``step_tokens`` budget. Tokens are sampled in the same step for every
entry, and the host keeps the rows it marked as samplers (decode rows and
the final token of a completing prefill), with each token's behaviour
log-prob. One device→host transfer per step brings tokens and log-probs
back together. When the pool runs dry the engine preempts by
recomputation: the youngest other row under the preemption cap loses its
blocks and is requeued at the front; it later re-prefills prompt +
emitted tokens and resumes, losing work but never tokens.

**Slots** (``kv_layout="slots"``, and the fallback for what the pool has
no equivalent for: the int8 ``kv_quant`` cache and sliding-window ring
caches): one contiguous ``(L, num_slots, max_len, Hkv, D)`` cache with
per-slot lengths (``models/transformer.py::KVCache``). Queued requests are
prefilled into free slots when a step begins, same-bucket requests at the
queue front in one batched forward, a ring pool's long prompts as an
exact-size chunk chain; each prefill samples its request's first token.
Then one decode step runs every slot at once (inactive slots keep their
token and length), with the flash-decode kernel on the card when
``config.decode_attn_impl == "flash"``.

Shared prefixes, held-slot continuations, speculation, adapters, groups,
migration and tensor-parallel meshes belong to later slices and raise
where requested.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import deque
from typing import Deque, Dict, List, Optional

import torch

from ..device import resolve_device
from ..models.config import ModelConfig
from ..models.transformer import (KVCache, Params, _is_ring, forward,
                                  forward_paged, init_kv_cache,
                                  ring_capacity)
from ..ops.sampling import sample_token, sampled_logprob
from .paged_kv import (BlockAllocator, BlocksExhausted, copy_blocks,
                       init_paged_pool, pool_bytes_per_block,
                       resolve_kv_dtypes)
from .sampler import SampleParams


class QueueFull(RuntimeError):
    """submit() refused: the engine's bounded queue is at ``max_queue``."""


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Engine KV knobs, separate from the model's ModelConfig.

    ``kv_layout="paged"`` (the default) serves from the block pool;
    ``"slots"`` from the contiguous slot cache. A paged request falls back
    to slots, with the reason in ``RolloutEngine.kv_layout_fallback``, for
    the int8 ``config.kv_quant`` cache and for sliding-window ring caches.
    The quantized ``kv_dtype`` ladder and ``paged_kernel`` are paged-only
    knobs (a quantized ladder on slots raises)."""

    kv_layout: str = "paged"
    # tokens per KV block; the partial last block of each sequence is the
    # only internal fragmentation
    block_size: int = 16
    # pool capacity in blocks; None = (num_slots + 4) rows' worth
    num_blocks: Optional[int] = None
    # per-step token budget for the fused decode+prefill batch; None =
    # max(4 * num_slots, 64). Decode rows are always admitted; the
    # remainder fills with exact-size prefill segments.
    step_tokens: Optional[int] = None
    # None = the CUDA paged-attention kernel when the engine runs on the
    # card, the plain gather path on the CPU. False forces the plain path
    # (for comparisons); True on the CPU raises.
    paged_kernel: Optional[bool] = None
    # A request preempted this many times becomes non-preemptible (it
    # finishes or, when even the whole pool cannot fit it,
    # truncate-finishes).
    max_preempts: int = 3
    # Quantized KV ladder: "bf16" stores blocks at full model width;
    # "int8"/"fp8" store quantized payloads + per-(block, position, head)
    # absmax scales, quantized at write time inside the fused step.
    kv_dtype: str = "bf16"
    # Per-layer override: a contiguous "bf16" prefix followed by one
    # uniform quantized run (rollout/paged_kv.resolve_kv_dtypes).
    kv_dtype_per_layer: Optional[tuple] = None


@dataclasses.dataclass
class _PrefillJob:
    """Host cursor for one request's token-level chunked prefill: the step
    assembler feeds ``toks`` in exact-size segments; ``pos`` is the
    absolute position of ``toks[0]``."""

    toks: List[int]
    pos: int
    # sample the request's first output from the LAST fed token's row
    sample_last: bool
    # when not sampling (preemption resume), restore this token as the
    # row's decode cursor instead of emitting anything
    after_tok: Optional[int] = None


class _RowPreempted(Exception):
    """Internal: the row being assembled lost its blocks to reclamation
    and was requeued; skip it for this step."""


@dataclasses.dataclass
class _Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int
    eos_id: Optional[int]
    tokens: List[int] = dataclasses.field(default_factory=list)
    # model log-prob of each emitted token AT SAMPLE TIME (the behaviour
    # log-prob for GRPO importance ratios), parallel to `tokens`
    logps: List[float] = dataclasses.field(default_factory=list)
    done: bool = False
    slot: Optional[int] = None
    # times this request lost its blocks to preempt-by-recomputation; at
    # EngineConfig.max_preempts it becomes non-preemptible
    preempt_count: int = 0


def _bucket(n: int, minimum: int = 16) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


def _slice_slot(cache: KVCache, slot: int, length: torch.Tensor) -> KVCache:
    """One slot of the pool as a B=1 sub-cache VIEW at ``length``: the
    forward's in-place writes land in the pool itself."""
    sl = slice(slot, slot + 1)
    if cache.quantized:
        return KVCache(k=cache.k[:, sl], v=cache.v[:, sl], length=length,
                       k_scale=cache.k_scale[:, sl],
                       v_scale=cache.v_scale[:, sl])
    return KVCache(k=cache.k[:, sl], v=cache.v[:, sl], length=length)


def _writeback_slot(cache: KVCache, slot: int, new_len) -> KVCache:
    """Set a slot's length after its view (:func:`_slice_slot`) was
    written through."""
    length = cache.length.clone()
    length[slot] = new_len
    return cache._replace(length=length)


@torch.no_grad()
def _prefill_slot(params: Params, config: ModelConfig, tokens: torch.Tensor,
                  true_len: int, cache: KVCache,
                  slot: int) -> tuple:
    """Prefill one slot. tokens: (1, S_bucket) right-padded; returns
    (last-real-token logits (V,), pool cache). Padding is masked out of
    the prompt's attention; decode overwrites it before it is read."""
    max_len = cache.k.shape[2]
    dev = cache.k.device
    sub = _slice_slot(cache, slot, torch.zeros((), dtype=torch.int32,
                                               device=dev))
    attn_mask = torch.arange(max_len, device=dev)[None, :] < true_len
    logits, _ = forward(params, config, tokens, cache=sub,
                        attn_mask=attn_mask, fresh_cache=True)
    return logits[0, true_len - 1, :], _writeback_slot(cache, slot,
                                                       true_len)


@torch.no_grad()
def _prefill_slots_batched(params: Params, config: ModelConfig,
                           tokens: torch.Tensor, true_lens: torch.Tensor,
                           cache: KVCache, slots: torch.Tensor) -> tuple:
    """Prefill N fresh slots in ONE forward. tokens: (N, S_bucket)
    right-padded; true_lens/slots: (N,) on the cache's device. The rows
    run in a zeroed N-row sub-cache (fresh slots need nothing gathered),
    which is then scattered into the pool's slots. Returns ((N, V)
    last-real-token logits, pool cache)."""
    cap = cache.k.shape[2]
    n = tokens.shape[0]
    dev = cache.k.device
    sub = init_kv_cache(config, n, cap, device=dev)
    attn_mask = torch.arange(cap, device=dev)[None, :] < true_lens[:, None]
    logits, sub = forward(params, config, tokens, cache=sub,
                          attn_mask=attn_mask, fresh_cache=True)
    last = logits[torch.arange(n, device=dev), true_lens.long() - 1]
    cache.k[:, slots] = sub.k
    cache.v[:, slots] = sub.v
    if cache.quantized:
        cache.k_scale[:, slots] = sub.k_scale
        cache.v_scale[:, slots] = sub.v_scale
    length = cache.length.clone()
    length[slots] = true_lens.to(length.dtype)
    return last, cache._replace(length=length)


@torch.no_grad()
def _prefill_slot_chunk(params: Params, config: ModelConfig,
                        tokens: torch.Tensor, cache: KVCache, slot: int, *,
                        fresh: bool) -> tuple:
    """One EXACT-SIZE prefill chunk into a slot at its current length:
    the ring pool's long-prompt path. A pad token written into a ring
    would get a real position from the modular mask, so long prompts are
    cut into exact chunks (capacity-sized, then a powers-of-two ladder,
    :func:`_chunk_sizes`). ``fresh`` marks the first chunk of a reset
    slot."""
    start = cache.length[slot].clone()
    logits, _ = forward(params, config, tokens,
                        cache=_slice_slot(cache, slot, start),
                        fresh_cache=fresh)
    return (logits[0, -1, :],
            _writeback_slot(cache, slot, start + tokens.shape[1]))


def _chunk_sizes(n: int, cap: int) -> list:
    """n = (n // cap) full chunks + a descending powers-of-two ladder."""
    sizes = [cap] * (n // cap)
    r = n % cap
    p = 1
    while p * 2 <= max(r, 1):
        p *= 2
    while r > 0:
        while p > r:
            p //= 2
        sizes.append(p)
        r -= p
    return sizes


@torch.no_grad()
def _pool_decode_step(params: Params, config: ModelConfig,
                      cur_tok: torch.Tensor, active: torch.Tensor,
                      cache: KVCache, generator: torch.Generator,
                      sample: SampleParams) -> tuple:
    """One decode step over the whole pool. cur_tok/active:
    (num_slots,). Inactive slots compute values that are discarded; they
    keep their token and their length. Also returns each sampled token's
    model log-prob (the behaviour log-prob GRPO trains against)."""
    logits, new_cache = forward(params, config, cur_tok[:, None],
                                cache=cache)
    logits = logits[:, -1, :]
    next_tok = sample_token(logits, generator,
                            temperature=sample.temperature,
                            top_k=sample.top_k, top_p=sample.top_p)
    next_tok = torch.where(active, next_tok, cur_tok)
    logp = sampled_logprob(logits, next_tok)
    length = torch.where(active, new_cache.length, cache.length)
    return next_tok, logp, new_cache._replace(length=length)


class RolloutEngine:
    """Continuous batching on one device, over a paged KV pool or the
    contiguous slot cache."""

    def __init__(self, params: Params, config: ModelConfig, *,
                 num_slots: int = 8, max_len: int = 2048,
                 sample: SampleParams = SampleParams(),
                 eos_id: Optional[int] = None, seed: int = 0,
                 mesh=None, max_queue: Optional[int] = None,
                 engine_config: Optional[EngineConfig] = None,
                 adapter_pool=None, device="cuda"):
        self.device = resolve_device(device)
        self.engine_config = ec = engine_config or EngineConfig()
        if ec.kv_layout not in ("paged", "slots"):
            raise ValueError(f"unknown kv_layout {ec.kv_layout!r}")
        if mesh is not None:
            raise NotImplementedError(
                "tensor-parallel meshes arrive with the parallel-layout "
                "slice of the PyTorch port")
        if adapter_pool is not None:
            raise NotImplementedError(
                "multi-tenant LoRA adapters arrive with a later slice of "
                "the PyTorch port")
        embed = params["embed"]
        if embed.device.type != self.device.type:
            raise ValueError(f"params live on {embed.device}, engine on "
                             f"{self.device}")
        self.config = config
        self.num_slots = num_slots
        # Sliding-window configs serve from a ring: the pool holds
        # ring_capacity positions per sequence (the SWA memory win), and
        # decode past the window goes on indefinitely (modular writes).
        self.max_len = max_len = ring_capacity(config, max_len)
        self._ring = _is_ring(config, max_len)
        # Longest context this engine can serve: the model's position
        # budget on a ring (long prompts prefill in chunks), the pool row
        # size otherwise.
        self.context_bound = config.max_seq_len if self._ring else max_len
        self.sample = sample
        self.eos_id = eos_id
        self.params = params
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        # KV layout: the paged pool unless asked for slots, or the pool
        # has no equivalent yet (the int8 cache, ring caches).
        fallback = None
        if ec.kv_layout == "paged":
            if config.kv_quant:
                fallback = "kv_quant int8 cache"
            elif self._ring:
                fallback = "sliding-window ring cache"
        self.kv_layout = ("slots" if ec.kv_layout == "slots" or fallback
                          else "paged")
        self.kv_layout_fallback = fallback
        # A quantized ladder silently ignored on slots would serve at
        # twice the memory the operator budgeted for.
        payload, _ = resolve_kv_dtypes(config.num_layers, ec.kv_dtype,
                                       ec.kv_dtype_per_layer)
        if payload is not None and self.kv_layout != "paged":
            raise ValueError(
                "EngineConfig.kv_dtype quantized ladder needs the paged "
                "KV layout"
                + (f" (fell back to slots: {fallback})" if fallback
                   else " (kv_layout='slots' has its own kv_quant knob)"))
        if self.kv_layout == "slots":
            cache = init_kv_cache(config, num_slots, max_len,
                                  device=self.device)
            self.cache = cache._replace(length=torch.zeros(
                num_slots, dtype=torch.int32, device=self.device))
            self.cur_tok = torch.zeros(num_slots, dtype=torch.long,
                                       device=self.device)
        else:
            self._init_paged(ec)
        self._slot_req: List[Optional[_Request]] = [None] * num_slots  # guarded-by: _lock
        self._stats = {"prefills": 0, "prefill_tokens": 0,  # guarded-by: _lock
                       "batched_prefills": 0, "batched_prefill_slots": 0,
                       "decode_steps": 0, "tokens_emitted": 0,
                       "kv_preemptions": 0, "kv_preemption_storms": 0}
        # Bounded admission (None = unbounded): submit() raises QueueFull
        # past this many QUEUED requests.
        self.max_queue = max_queue
        self._queue: Deque[_Request] = deque()  # guarded-by: _lock
        self._requests: Dict[int, _Request] = {}  # guarded-by: _lock
        self._next_rid = 0                      # guarded-by: _lock
        # Slot layout: tokens sampled during prefill, surfaced by the next
        # step().
        self._pending_emits: Dict[int, List[int]] = {}  # guarded-by: _lock
        # Preemption-storm latch: rids already counted as storm-capped.
        self._storm_rids: set = set()           # guarded-by: _lock
        # Many agent loops may drive one engine: all state mutation is
        # serialized.
        self._lock = threading.RLock()

    def _init_paged(self, ec: EngineConfig) -> None:
        """The block pool, its allocator and the host-side row state."""
        num_slots, max_len = self.num_slots, self.max_len
        bs = max(1, int(ec.block_size))
        self._blocks_per_row = -(-max_len // bs)
        nb = ec.num_blocks
        if nb is None:
            nb = (num_slots + 4) * self._blocks_per_row
        self.pool = init_paged_pool(self.config, nb, bs,
                                    kv_dtype=ec.kv_dtype,
                                    kv_dtype_per_layer=ec.kv_dtype_per_layer,
                                    device=self.device)
        self._alloc = BlockAllocator(
            nb, bs, bytes_per_block=pool_bytes_per_block(self.pool))
        # host-side block table + fill level + decode cursor per row
        self._tables: List[List[int]] = [[] for _ in range(num_slots)]  # guarded-by: _lock
        self._row_len: List[int] = [0] * num_slots  # guarded-by: _lock
        self._cur_tok_host: List[int] = [0] * num_slots  # guarded-by: _lock
        self._prefill_jobs: Dict[int, _PrefillJob] = {}  # guarded-by: _lock
        st = ec.step_tokens
        self._step_tokens = max(
            num_slots, int(st) if st else max(4 * num_slots, 64))
        pk = ec.paged_kernel
        on_card = self.device.type == "cuda"
        if pk is None:
            pk = on_card
        elif pk and not on_card:
            raise ValueError("EngineConfig.paged_kernel=True needs the CUDA "
                             "device; the CPU runs the plain path")
        self._use_paged_kernel = bool(pk)

    def update_params(self, params: Params) -> None:
        """On-policy weight sync between rounds. The KV pool and
        in-flight requests are untouched; callers sync at round
        boundaries."""
        embed = params["embed"]
        if embed.device.type != self.device.type:
            raise ValueError(f"params live on {embed.device}, engine on "
                             f"{self.device}")
        with self._lock:
            self.params = params

    # -- public API ---------------------------------------------------------

    def submit(self, prompt: List[int], *, max_new_tokens: int = 128,
               eos_id: Optional[int] = None,
               prefix_id: Optional[int] = None, hold_slot: bool = False,
               continue_from: Optional[int] = None,
               adapter_id: Optional[str] = None) -> int:
        if prefix_id is not None:
            raise NotImplementedError(
                "shared prefixes arrive with a later slice of the PyTorch "
                "port")
        if hold_slot or continue_from is not None:
            raise NotImplementedError(
                "held-slot continuations arrive with a later slice of the "
                "PyTorch port")
        if adapter_id is not None:
            raise NotImplementedError(
                "multi-tenant LoRA adapters arrive with a later slice of "
                "the PyTorch port")
        with self._lock:
            if not prompt:
                raise ValueError("empty prompt")
            if len(prompt) >= self.context_bound:
                raise ValueError(
                    f"prompt length {len(prompt)} ≥ engine max_len bound "
                    f"{self.context_bound}")
            if (self.max_queue is not None
                    and len(self._queue) >= self.max_queue):
                raise QueueFull(
                    f"engine queue at max_queue={self.max_queue} "
                    f"({len(self._queue)} queued)")
            rid = self._next_rid
            self._next_rid += 1
            req = _Request(rid=rid, prompt=list(prompt),
                           max_new_tokens=max_new_tokens,
                           eos_id=self.eos_id if eos_id is None else eos_id)
            self._requests[rid] = req
            # enqueue only: scheduling happens at the next step()
            self._queue.append(req)
            return rid

    @property
    def has_work(self) -> bool:
        with self._lock:
            return bool(self._queue) or any(r is not None
                                            for r in self._slot_req)

    def step(self) -> Dict[int, List[int]]:
        """Advance the pool by one fused step. Returns {rid: [tokens]} for
        every token emitted by it."""
        with self._lock:
            if self.kv_layout == "paged":
                return self._step_paged()
            return self._step_slots()

    def run(self) -> Dict[int, List[int]]:
        """Drive until all submitted requests finish."""
        while self.has_work:
            self.step()
        return {rid: r.tokens for rid, r in self._requests.items()}

    def stats(self) -> Dict[str, object]:
        """Serving counters: prefill volume, decode throughput inputs,
        pool occupancy and preemptions."""
        with self._lock:
            out = dict(self._stats)
            out["queue_depth"] = len(self._queue)
            out["slots_active"] = sum(r is not None for r in self._slot_req)
            out["kv_paged"] = int(self.kv_layout == "paged")
            if self.kv_layout != "paged":
                return out
            for name, val in self._alloc.counters().items():
                out[f"kv_{name}"] = val
            out["kv_blocks_total"] = self._alloc.num_blocks
            out["kv_blocks_free"] = self._alloc.free_blocks
            out["kv_pressure"] = (self._alloc.used_blocks
                                  / self._alloc.num_blocks)
            out["kv_dtype"] = self.engine_config.kv_dtype
            out["kv_bytes_per_block"] = self._alloc.bytes_per_block
            out["kv_bytes_device"] = self._alloc.used_bytes
            out["paged_kernel"] = int(self._use_paged_kernel)
            return out

    def result(self, rid: int) -> List[int]:
        with self._lock:
            return list(self._requests[rid].tokens)

    def result_logps(self, rid: int) -> List[float]:
        """Behaviour log-prob of each emitted token (parallel to
        result()), captured at sample time."""
        with self._lock:
            return list(self._requests[rid].logps)

    def is_done(self, rid: int) -> bool:
        with self._lock:
            return self._requests[rid].done

    # -- row lifecycle ------------------------------------------------------

    def _finish_request(self, req: _Request, slot: int) -> None:
        # guarded-by: caller
        req.done = True
        self._slot_req[slot] = None
        req.slot = None
        if self.kv_layout == "paged":
            self._prefill_jobs.pop(req.rid, None)
            self._release_row(slot)

    def _free_slots(self) -> List[int]:
        return [s for s in range(self.num_slots) if self._slot_req[s] is None]

    def _release_row(self, row: int) -> None:
        # guarded-by: caller
        """Drop the row's reference on every block of its table."""
        if self._tables[row]:
            self._alloc.release(self._tables[row])
        self._tables[row] = []
        self._row_len[row] = 0

    def _preempt_row(self, row: int) -> None:
        # guarded-by: caller
        """Preemption by recomputation: release the row's blocks and
        requeue its request at the FRONT. Rescheduling re-prefills prompt
        + emitted tokens and resumes decode from the last sampled token."""
        req = self._slot_req[row]
        self._slot_req[row] = None
        req.slot = None
        self._prefill_jobs.pop(req.rid, None)
        self._release_row(row)
        self._queue.appendleft(req)
        self._stats["kv_preemptions"] += 1
        req.preempt_count += 1
        if (req.preempt_count >= self.engine_config.max_preempts
                and req.rid not in self._storm_rids):
            # starvation latch: this request is now non-preemptible
            self._storm_rids.add(req.rid)
            self._stats["kv_preemption_storms"] += 1

    def _reclaim_blocks(self, row: int, committed) -> bool:
        # guarded-by: caller
        """Free pool capacity by preempting the youngest other active row
        still under the preemption cap. Returns False when nothing further
        can be reclaimed for ``row``, including after preempting ``row``
        itself or truncate-finishing it."""
        cap = self.engine_config.max_preempts
        victims = [s for s in range(self.num_slots)
                   if s != row and s not in committed
                   and self._slot_req[s] is not None
                   and self._slot_req[s].preempt_count < cap]
        if victims:
            youngest = max(victims, key=lambda s: self._slot_req[s].rid)
            self._preempt_row(youngest)
            return True
        if row >= 0 and self._slot_req[row] is not None:
            req = self._slot_req[row]
            need = self._alloc.blocks_for(
                len(req.prompt) + len(req.tokens) + 1)
            if need > self._alloc.num_blocks or req.preempt_count >= cap:
                # could never fit, or out of preemption budget with every
                # other row capped too: truncate-finish (the request
                # completes short, it is never lost)
                self._finish_request(req, row)
            else:
                self._preempt_row(row)
        return False

    def _ensure_block(self, row: int, pos: int, committed) -> int:
        # guarded-by: caller
        """Make position ``pos`` writable in ``row``'s table: append a
        fresh block at the table boundary, or COW-split a shared block.
        Reclaims capacity on exhaustion; raises :class:`_RowPreempted`
        once ``row`` itself had to yield its blocks."""
        table = self._tables[row]
        lb = pos // self._alloc.block_size
        while True:
            try:
                if lb == len(table):
                    table.append(self._alloc.alloc(1)[0])
                elif lb < len(table):
                    tgt = self._alloc.cow_target(table[lb])
                    if tgt is not None:
                        copy_blocks(self.pool, [table[lb]], [tgt])
                        table[lb] = tgt
                else:
                    raise AssertionError(
                        f"non-contiguous write: pos {pos} into table "
                        f"of {len(table)} block(s)")
                return table[lb]
            except BlocksExhausted:
                if not self._reclaim_blocks(row, committed):
                    raise _RowPreempted(row)

    def _tables_device(self) -> torch.Tensor:
        # guarded-by: caller
        """Dense (num_slots, mb) int32 block-table array, trimmed to the
        widest resident table and rounded up to a power of two (as the JAX
        engine does), so the plain path's gather tracks the longest live
        sequence. Unused entries hold 0 and are never read past a row's
        fill level. Returned on the host; forward_paged moves it."""
        widest = max((len(t) for t in self._tables), default=0)
        mb = 1
        while mb < widest:
            mb *= 2
        mb = min(self._blocks_per_row, mb)
        arr = torch.zeros((self.num_slots, mb), dtype=torch.int32)
        for s, tbl in enumerate(self._tables):
            if tbl:
                arr[s, :len(tbl)] = torch.tensor(tbl, dtype=torch.int32)
        return arr

    # -- scheduling and the fused step ---------------------------------------

    def _schedule_paged(self) -> None:
        # guarded-by: caller
        """Assign queued requests to free rows and turn their prompts into
        chunked-prefill jobs. No device work happens here."""
        while self._queue:
            free = self._free_slots()
            if not free:
                return
            req = self._queue.popleft()
            self._schedule_paged_row(req, free[0])

    def _schedule_paged_row(self, req: _Request, row: int) -> None:
        # guarded-by: caller
        req.slot = row
        self._slot_req[row] = req
        self._stats["prefills"] += 1
        if req.tokens:
            # preemption resume: recompute prompt + everything emitted
            # except the last token (whose k/v is written when it is
            # fed), then decode from that token — no re-emission
            stream = list(req.prompt) + req.tokens[:-1]
            self._stats["prefill_tokens"] += len(stream)
            self._prefill_jobs[req.rid] = _PrefillJob(
                toks=stream, pos=0, sample_last=False,
                after_tok=req.tokens[-1])
            return
        self._stats["prefill_tokens"] += len(req.prompt)
        self._prefill_jobs[req.rid] = _PrefillJob(
            toks=list(req.prompt), pos=0, sample_last=True)

    def _assemble_paged_plan(self):
        # guarded-by: caller
        """Build the flat token batch for one fused step: one decode entry
        per active row, then exact-size chunked-prefill segments
        round-robined in row order under the remaining token budget.
        Returns None when there is nothing to run. No padding entries are
        added (eager PyTorch does not recompile per batch width)."""
        bs = self._alloc.block_size
        toks_l: List[int] = []
        rows_l: List[int] = []
        pos_l: List[int] = []
        wb_l: List[int] = []
        wo_l: List[int] = []
        decode_rows = []           # (entry_idx, row, req)
        job_rows = []              # (row, req, job, n, last_idx)
        committed: set = set()
        for row in range(self.num_slots):
            req = self._slot_req[row]
            if req is None or req.rid in self._prefill_jobs:
                continue
            p = self._row_len[row]
            try:
                wb = self._ensure_block(row, p, committed)
            except _RowPreempted:
                continue
            decode_rows.append((len(toks_l), row, req))
            toks_l.append(self._cur_tok_host[row])
            rows_l.append(row)
            pos_l.append(p)
            wb_l.append(wb)
            wo_l.append(p % bs)
            committed.add(row)
        budget = max(0, self._step_tokens - len(toks_l))
        for row in range(self.num_slots):
            req = self._slot_req[row]
            if req is None or budget <= 0:
                continue
            job = self._prefill_jobs.get(req.rid)
            if job is None:
                continue
            n = min(len(job.toks), budget)
            staged = []
            try:
                for j in range(n):
                    p = job.pos + j
                    wb = self._ensure_block(row, p, committed)
                    staged.append((job.toks[j], p, wb, p % bs))
            except _RowPreempted:
                continue
            base = len(toks_l)
            for tok, p, wb, wo in staged:
                toks_l.append(tok)
                rows_l.append(row)
                pos_l.append(p)
                wb_l.append(wb)
                wo_l.append(wo)
            job_rows.append((row, req, job, n, base + n - 1))
            committed.add(row)
            budget -= n
        if not toks_l:
            return None
        if len(job_rows) >= 2:
            # several requests' prefill segments shared one forward
            self._stats["batched_prefills"] += 1
            self._stats["batched_prefill_slots"] += len(job_rows)
        return toks_l, rows_l, pos_l, wb_l, wo_l, decode_rows, job_rows

    def _fused_step(self, toks_l, rows_l, pos_l, wb_l, wo_l):
        # guarded-by: caller
        """forward_paged + in-step sampling over the flat batch; returns
        host (tokens, log-probs) lists from ONE device→host copy."""
        as_t = lambda xs: torch.tensor(xs, dtype=torch.int64)   # noqa: E731
        logits, self.pool = forward_paged(
            self.params, self.config, as_t(toks_l), pool=self.pool,
            tables=self._tables_device(), seq_row=as_t(rows_l),
            positions=as_t(pos_l), write_block=as_t(wb_l),
            write_off=as_t(wo_l), use_kernel=self._use_paged_kernel)
        s = self.sample
        next_tok = sample_token(logits, self._gen,
                                temperature=s.temperature, top_k=s.top_k,
                                top_p=s.top_p)
        logp = sampled_logprob(logits, next_tok)
        # token ids (< 2**24) and f32 log-probs are both exact in f64
        host = torch.stack([next_tok.double(), logp.double()]).cpu()
        return [int(x) for x in host[0].tolist()], host[1].tolist()

    def _step_paged(self) -> Dict[int, List[int]]:
        # guarded-by: caller
        self._schedule_paged()
        emitted: Dict[int, List[int]] = {}
        plan = self._assemble_paged_plan()
        if plan is None:
            return emitted
        toks_l, rows_l, pos_l, wb_l, wo_l, decode_rows, job_rows = plan
        toks, logps = self._fused_step(toks_l, rows_l, pos_l, wb_l, wo_l)
        self._stats["decode_steps"] += 1
        for idx, row, req in decode_rows:
            tok = toks[idx]
            req.tokens.append(tok)
            req.logps.append(logps[idx])
            self._stats["tokens_emitted"] += 1
            emitted.setdefault(req.rid, []).append(tok)
            self._row_len[row] += 1
            self._cur_tok_host[row] = tok
            hit_eos = req.eos_id is not None and tok == req.eos_id
            out_of_budget = len(req.tokens) >= req.max_new_tokens
            out_of_cache = self._row_len[row] >= self.context_bound - 1
            if hit_eos or out_of_budget or out_of_cache:
                self._finish_request(req, row)
        for row, req, job, n, last_idx in job_rows:
            self._row_len[row] += n
            job.toks = job.toks[n:]
            job.pos += n
            if job.toks:
                continue
            self._prefill_jobs.pop(req.rid, None)
            if job.sample_last:
                tok = toks[last_idx]
                req.tokens.append(tok)
                req.logps.append(logps[last_idx])
                self._stats["tokens_emitted"] += 1
                emitted.setdefault(req.rid, []).append(tok)
                self._cur_tok_host[row] = tok
                if ((req.eos_id is not None and tok == req.eos_id)
                        or req.max_new_tokens <= 1):
                    self._finish_request(req, row)
            else:
                self._cur_tok_host[row] = job.after_tok
        self._schedule_paged()
        return emitted

    # -- slot layout (the contiguous KVCache) ------------------------------

    def _step_slots(self) -> Dict[int, List[int]]:
        # guarded-by: caller
        """Prefill what the queue can place, then ONE decode step for
        every active slot. Returns the tokens emitted since the previous
        step, prefill-sampled first tokens included (a request that ends
        at its first token never appears in a later step)."""
        self._schedule_slots()
        emitted = self._pending_emits
        self._pending_emits = {}
        active_list = [r is not None for r in self._slot_req]
        if not any(active_list):
            return emitted
        active = torch.tensor(active_list, device=self.device)
        next_tok, logp, self.cache = _pool_decode_step(
            self.params, self.config, self.cur_tok, active, self.cache,
            self._gen, self.sample)
        self.cur_tok = next_tok
        self._stats["decode_steps"] += 1
        # ONE device→host copy for tokens, log-probs and lengths (token ids
        # < 2**24, f32 log-probs and int32 lengths are exact in f64)
        host = torch.stack([next_tok.double(), logp.double(),
                            self.cache.length.double()]).cpu()
        toks = [int(x) for x in host[0].tolist()]
        logps, lengths = host[1].tolist(), host[2].tolist()
        for slot, req in enumerate(self._slot_req):
            if req is None:
                continue
            tok = toks[slot]
            req.tokens.append(tok)
            req.logps.append(logps[slot])
            self._stats["tokens_emitted"] += 1
            emitted.setdefault(req.rid, []).append(tok)
            hit_eos = req.eos_id is not None and tok == req.eos_id
            out_of_budget = len(req.tokens) >= req.max_new_tokens
            out_of_cache = int(lengths[slot]) >= self.context_bound - 1
            if hit_eos or out_of_budget or out_of_cache:
                self._finish_request(req, slot)
        self._schedule_slots()
        return emitted

    def _schedule_slots(self) -> None:
        # guarded-by: caller
        """Prefill queued requests into free slots. Same-bucket requests
        at the queue front batch into ONE forward; a ring pool's long
        prompts and odd-bucket singles take the single-slot paths. FIFO
        order holds: a batch is a CONSECUTIVE run of compatible
        requests."""
        while self._queue:
            free = self._free_slots()
            if not free:
                return
            req = self._queue[0]
            if self._ring and len(req.prompt) >= self.max_len:
                self._queue.popleft()
                self._schedule_single(req, free[0])
                continue
            bucket = min(_bucket(len(req.prompt)), self.max_len)
            group = [req]
            for r in list(self._queue)[1:len(free)]:
                if (not (self._ring and len(r.prompt) >= self.max_len)
                        and min(_bucket(len(r.prompt)), self.max_len)
                        == bucket):
                    group.append(r)
                else:
                    break
            for _ in group:
                self._queue.popleft()
            if len(group) == 1:
                self._schedule_single(group[0], free[0])
            else:
                self._schedule_batch(group, free[:len(group)], bucket)

    def _prefill_chunks(self, slot: int, tokens: List[int],
                        fresh_first: bool) -> torch.Tensor:
        # guarded-by: caller
        """Exact-size chunk chain into a slot at its current length;
        returns the last chunk's final-token logits."""
        last_logits = None
        pos = 0
        for i, size in enumerate(_chunk_sizes(len(tokens), self.max_len)):
            chunk = torch.tensor(tokens[pos:pos + size], dtype=torch.long,
                                 device=self.device)[None, :]
            last_logits, self.cache = _prefill_slot_chunk(
                self.params, self.config, chunk, self.cache, slot,
                fresh=(fresh_first and i == 0))
            pos += size
        return last_logits

    def _schedule_single(self, req: _Request, slot: int) -> None:
        # guarded-by: caller
        req.slot = slot
        self._slot_req[slot] = req
        true_len = len(req.prompt)
        self._stats["prefills"] += 1
        self._stats["prefill_tokens"] += true_len
        if self._ring and true_len >= self.max_len:
            # Long prompt on a ring pool: reset the slot's stale length
            # (the chain's write cursor), then an exact-size chunk chain.
            self.cache = _writeback_slot(self.cache, slot, 0)
            last_logits = self._prefill_chunks(slot, req.prompt,
                                               fresh_first=True)
        else:
            bucket = min(_bucket(true_len), self.max_len)
            tokens = torch.tensor(req.prompt + [0] * (bucket - true_len),
                                  dtype=torch.long, device=self.device)
            last_logits, self.cache = _prefill_slot(
                self.params, self.config, tokens[None, :], true_len,
                self.cache, slot)
        self._emit_first_token(req, slot, last_logits)

    def _schedule_batch(self, group: List[_Request], slots: List[int],
                        bucket: int) -> None:
        # guarded-by: caller
        """One batched forward prefills the whole group (no row padding:
        eager PyTorch does not recompile per batch size)."""
        rows = []
        for req, slot in zip(group, slots):
            req.slot = slot
            self._slot_req[slot] = req
            rows.append(req.prompt + [0] * (bucket - len(req.prompt)))
            self._stats["prefills"] += 1
            self._stats["prefill_tokens"] += len(req.prompt)
        dev = self.device
        last, self.cache = _prefill_slots_batched(
            self.params, self.config,
            torch.tensor(rows, dtype=torch.long, device=dev),
            torch.tensor([len(r.prompt) for r in group], dtype=torch.int32,
                         device=dev), self.cache,
            torch.tensor(slots, dtype=torch.long, device=dev))
        self._stats["batched_prefills"] += 1
        self._stats["batched_prefill_slots"] += len(group)
        for i, (req, slot) in enumerate(zip(group, slots)):
            self._emit_first_token(req, slot, last[i])

    def _emit_first_token(self, req: _Request, slot: int,
                          last_logits: torch.Tensor) -> None:
        # guarded-by: caller
        """Sample and book-keep a request's first token after its prefill,
        with its log-prob, in one device→host copy."""
        s = self.sample
        tok0 = sample_token(last_logits[None, :], self._gen,
                            temperature=s.temperature, top_k=s.top_k,
                            top_p=s.top_p)[0]
        host = torch.stack([tok0.double(), sampled_logprob(
            last_logits, tok0).double()]).cpu().tolist()
        tok0_i = int(host[0])
        req.tokens.append(tok0_i)
        req.logps.append(host[1])
        self._stats["tokens_emitted"] += 1
        self._pending_emits.setdefault(req.rid, []).append(tok0_i)
        self.cur_tok[slot] = tok0_i
        if ((req.eos_id is not None and tok0_i == req.eos_id)
                or req.max_new_tokens <= 1):
            self._finish_request(req, slot)
