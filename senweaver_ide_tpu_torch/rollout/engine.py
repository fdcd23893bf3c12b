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

**Reuse paths.** :meth:`RolloutEngine.register_prefix` prefills a shared
prompt prefix (the agent system prompt) once. On paged it lives in
dedicated pool blocks that every consumer grafts into its table (a
refcount bump; the shared boundary block is copied on the first write);
on slots it is a one-slot cache copied into the slot. Prefixes export
to and import from other engines, and under pool pressure warm ones
swap to a host-RAM tier (pinned host tensors) and come back on demand.
``submit(hold_slot=True)`` keeps a finished request's KV resident so the
next turn (``continue_from=``) prefills only its new tokens.
``update_params`` drops every prefix and every hold: their KV belongs to
the old policy.

**Weights.** The engine serves int8 weights (``models/quantize.py``) as
it serves full-precision ones, and quantizes a full-precision publish
again. Mixture-of-experts models serve on both layouts; since an MoE
layer's capacity counts the whole batch, their fused steps and batched
prefills are padded to the JAX engine's widths (:meth:`_pad_moe_batch`).

**Speculation** (:meth:`RolloutEngine.enable_speculation`, paged and
greedy only): a draft model with its own block pool proposes up to
``depth`` tokens per decoding row (``k`` draft forwards whose argmax
stays on the device, one device→host copy of the proposals), the target
verifies each row's window in the same fused step as everything else,
and both caches roll back to the verified prefix. The depth comes from a
:class:`~.spec_controller.SpecController` (load → ladder) or is pinned.

**Groups and trees** (:meth:`RolloutEngine.submit_group`,
:meth:`RolloutEngine.fork_request`): a GRPO group pays one prefill; the
followers graft the donor's prompt spine (refcount bumps) and rescore
its last token with the write dropped; a fork shares its parent's whole
spine, copy-on-write.

**Tenants** (``RolloutEngine(adapter_pool=...)``, paged only): many LoRA
adapters over one base model in one batch. ``submit(adapter_id=)``
binds the tenant's current adapter version to the request for its whole
life (``rollout/adapter_pool.py``); every fused step passes the pool's
banks and each entry's slot id to ``forward_paged``.
:meth:`RolloutEngine.publish_adapter` changes only what the tenant's
NEXT request decodes under.

**Migration** (:meth:`RolloutEngine.checkpoint_request`,
:meth:`RolloutEngine.restore_request`, ``rollout/migration.py``): an
in-flight decode is frozen, its KV blocks and host state leave as a
portable checkpoint, and another engine resumes it token-exactly.

**Tensor parallel** (``RolloutEngine(mesh=)``, ``parallel/mesh.py``):
every rank of the mesh runs this engine on the same submits, in lockstep.
As in JAX, a mesh engine serves from the slot layout
(``kv_layout_fallback = "tensor-parallel KV sharding"``): the params are
sharded over ``tp`` alone (Megatron columns and rows), each rank's cache
holds its ``Hkv/tp`` KV heads and the flash-decode kernel runs over
them, and the forward all-gathers the logits over tp. Slots are
REPLICATED over the data axes (dp, fsdp): every rank runs every slot.
Every token is decided once: rank 0 samples, and the ids and their
log-probs are broadcast over the mesh each step, so float differences
between ranks cannot fork the streams. Prefixes export with all KV heads
(gathered over tp) and install this rank's heads.

Observability is the JAX engine's, under its names: the step bodies run
under the runtime ledger entries ``engine.fused_step`` (paged) and
``engine.decode_step`` (slots), the draft's under ``engine.spec_propose``
and ``engine.spec_feed``, each step's one device→host copy goes
through ``profiled_device_get``, the spans ``engine.decode_step``,
``engine.prefill`` and ``engine.prefill_batch`` and the
``senweaver_engine_*`` counters record while tracing is on, and the
allocator publishes the ``senweaver_kv_*`` gauges.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import deque
from typing import Deque, Dict, List, Optional

import torch

from ..device import resolve_device
from ..models.config import ModelConfig
from ..models.quantize import is_quantized, quantize_weights_int8
from ..models.transformer import (KVCache, Params, _is_ring,
                                  dequantize_pool_kv, forward,
                                  forward_paged, init_kv_cache,
                                  ring_capacity, tp_local_config)
from ..obs import get_registry, get_tracer
from ..obs.runtime_profile import (ProfiledFunction, get_profiler,
                                   profiled_device_get)
from ..ops.sampling import sample_token, sampled_logprob
from ..parallel.comm import all_gather, broadcast
from .kv_pressure import HostPrefix, PrefixCandidate, pick_victim, should_tier
from .paged_kv import (BlockAllocator, BlockPayload, BlocksExhausted,
                       copy_blocks, gather_blocks, gather_blocks_quant,
                       init_paged_pool, install_blocks, install_blocks_quant,
                       pool_bytes_per_block, resolve_kv_dtypes)
from .sampler import SampleParams, prefill
from .spec_controller import FixedDepth, SpecController


class QueueFull(RuntimeError):
    """submit() refused: the engine's bounded queue is at ``max_queue``."""


class PrefixImportError(ValueError):
    """import_prefix() refused a foreign KV buffer: shape, dtype,
    quantization flavour or recorded length does not match this engine's
    pool layout."""


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
    # Host-RAM tier for warm prefixes (rollout/kv_pressure.py): under
    # pool pressure, warm or shared prefixes swap to pinned host tensors
    # and are restored on demand; False makes reclamation evict-only.
    host_tier: bool = True
    # An unshared prefix must have been used this many times before it is
    # worth the host round trip; colder entries are dropped.
    tier_min_uses: int = 2


@dataclasses.dataclass
class _PrefillJob:
    """Host cursor for one request's token-level chunked prefill: the step
    assembler feeds ``toks`` in exact-size segments; ``pos`` is the
    absolute position of ``toks[0]``."""

    toks: List[int]
    pos: int
    # sample the request's first output from the LAST fed token's row
    sample_last: bool
    # rescore-only job: the positions already hold this k/v (an imported
    # prefix without logits); its writes go to the dropped-write sentinel
    # so a SHARED boundary block is not copied just to recompute logits
    drop_writes: bool = False
    # when not sampling (preemption resume), restore this token as the
    # row's decode cursor instead of emitting anything
    after_tok: Optional[int] = None


class _RowPreempted(Exception):
    """Internal: the row being assembled lost its blocks to reclamation
    and was requeued; skip it for this step."""


class _DraftMetricsView:
    """Registry adapter for the draft block allocator: re-prefixes the
    ``senweaver_kv_*`` series to ``senweaver_spec_draft_kv_*`` so the
    draft pool's bookkeeping doesn't overwrite the target pool's
    gauges."""

    def __init__(self, registry):
        self._registry = registry

    @staticmethod
    def _rename(name: str) -> str:
        return name.replace("senweaver_kv_", "senweaver_spec_draft_kv_")

    def gauge(self, name, desc=""):
        return self._registry.gauge(     # metric-name: senweaver_spec_draft_kv_*
            self._rename(name), desc)

    def counter(self, name, desc=""):
        return self._registry.counter(   # metric-name: senweaver_spec_draft_kv_*
            self._rename(name), desc)


@dataclasses.dataclass
class _SpecState:
    """Host-side state for fused speculative decoding (one per engine,
    created by :meth:`RolloutEngine.enable_speculation`). All fields are
    guarded by the engine lock."""

    params: Params
    config: ModelConfig
    controller: object          # SpecController / FixedDepth duck type
    alloc: BlockAllocator       # draft KV block pool bookkeeping
    version: int = 0            # draft weight version
    # target publishes seen vs. the target version the draft was last
    # installed against: staleness = target_version - draft_synced_at
    target_version: int = 0
    draft_synced_at: int = 0
    # a fleet publisher already stamped the in-flight publish
    # (spec_note_publish_begin); the install consumes the stamp instead
    # of double-counting
    publish_pending: bool = False
    ema: float = 0.0            # acceptance-rate EMA (reset on publish)
    ema_init: bool = False
    depth_applied: int = 0      # controller depth used by the last step
    # verification outcomes for the online distiller (training/
    # draft_distill.py): bounded ring of {context, targets, accepted}
    ctx_window: int = 64
    outcomes: Deque = dataclasses.field(
        default_factory=lambda: deque(maxlen=512))
    depth_gauge: object = None
    accept_gauge: object = None
    staleness_gauge: object = None
    wasted_total: object = None
    # draft forwards run: the propose loop's (k a proposal step) and the
    # catch-up's (one a feed step)
    propose_forwards: int = 0
    feed_forwards: int = 0


@dataclasses.dataclass
class _GroupShare:
    """Shared-prefill bookkeeping for one GRPO group (guarded by the
    engine lock). The donor request prefills the group's prompt ONCE;
    when that prefill completes (before the donor's first sampled token
    is written, so the block table is the pure prompt spine) the engine
    captures an engine-retained fork of the table and enqueues the
    waiting followers. Each follower grafts the spine with a refcount
    bump and rescores only the last prompt token. ``degraded`` flips if
    the donor dies before capture (preemption after emitting, a release):
    followers fall back to plain unshared prefills, slower, never
    inexact."""

    gid: int
    donor_rid: int
    spine: Optional[List[int]] = None    # engine-retained table fork
    spine_len: int = 0
    waiters: List["_Request"] = dataclasses.field(default_factory=list)
    pending: int = 0                     # followers not yet grafted
    degraded: bool = False


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
    prefix_id: Optional[int] = None
    # keep the slot (and its KV) after finishing so the next turn can
    # continue from it (submit(continue_from=rid))
    hold_slot: bool = False
    # the token history resident in the held slot's KV, EXCLUDING the
    # last sampled token (whose k/v is written only when it is fed)
    held_history: Optional[List[int]] = None
    # times this request lost its blocks to preempt-by-recomputation; at
    # EngineConfig.max_preempts it becomes non-preemptible
    preempt_count: int = 0
    # Group-shared rollout (submit_group): followers graft the donor's
    # prefilled prompt spine instead of paying their own prefill.
    # `group_grafted` latches once so a preempted follower cannot
    # double-decrement the group's pending count on reschedule.
    group: Optional["_GroupShare"] = None
    group_grafted: bool = False
    # Tree-structured rollout lineage (fork_request): the rid this request
    # branched from, the parent's emitted-token count at the branch point,
    # and the branch depth (root submits are depth 0).
    parent_rid: Optional[int] = None
    branch_pos: Optional[int] = None
    branch_depth: int = 0
    # live-migration freeze (rollout/migration.py): a paused request is
    # skipped by the step assembler, the speculation planner and the
    # scheduler, so its state cannot advance between a checkpoint and
    # the release or resume
    paused: bool = False
    # multi-tenant LoRA: the tenant and the (rung, slot, version) binding
    # acquired at submit, held for the request's life
    adapter: Optional[str] = None
    adapter_binding: Optional[object] = None


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
                  slot: int, mesh=None) -> tuple:
    """Prefill one slot. tokens: (1, S_bucket) right-padded; returns
    (last-real-token logits (V,), pool cache). Padding is masked out of
    the prompt's attention; decode overwrites it before it is read."""
    max_len = cache.k.shape[2]
    dev = cache.k.device
    sub = _slice_slot(cache, slot, torch.zeros((), dtype=torch.int32,
                                               device=dev))
    attn_mask = torch.arange(max_len, device=dev)[None, :] < true_len
    logits, _ = forward(params, config, tokens, cache=sub,
                        attn_mask=attn_mask, fresh_cache=True, mesh=mesh,
                        logits_at=true_len - 1)
    return logits[0], _writeback_slot(cache, slot, true_len)


@torch.no_grad()
def _prefill_slots_batched(params: Params, config: ModelConfig,
                           tokens: torch.Tensor, true_lens: torch.Tensor,
                           cache: KVCache, slots: torch.Tensor,
                           mesh=None) -> tuple:
    """Prefill N fresh slots in ONE forward. tokens: (N, S_bucket)
    right-padded; true_lens/slots: (N,) on the cache's device. The rows
    run in a zeroed N-row sub-cache (fresh slots need nothing gathered),
    which is then scattered into the pool's slots. Returns ((N, V)
    last-real-token logits, pool cache)."""
    cap = cache.k.shape[2]
    n = tokens.shape[0]
    dev = cache.k.device
    tp = 1 if mesh is None else mesh.axis_size("tp")
    sub = init_kv_cache(tp_local_config(config, tp), n, cap, device=dev)
    attn_mask = torch.arange(cap, device=dev)[None, :] < true_lens[:, None]
    last, sub = forward(params, config, tokens, cache=sub,
                        attn_mask=attn_mask, fresh_cache=True, mesh=mesh,
                        logits_at=true_lens - 1)
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
                        fresh: bool, mesh=None) -> tuple:
    """One EXACT-SIZE prefill chunk into a slot at its current length:
    the ring pool's long-prompt path. A pad token written into a ring
    would get a real position from the modular mask, so long prompts are
    cut into exact chunks (capacity-sized, then a powers-of-two ladder,
    :func:`_chunk_sizes`). ``fresh`` marks the first chunk of a reset
    slot."""
    start = cache.length[slot].clone()
    logits, _ = forward(params, config, tokens,
                        cache=_slice_slot(cache, slot, start),
                        fresh_cache=fresh, mesh=mesh,
                        logits_at=tokens.shape[1] - 1)
    return logits[0], _writeback_slot(cache, slot, start + tokens.shape[1])


def _install_prefix(cache: KVCache, prefix: KVCache, slot: int) -> KVCache:
    """Copy a one-slot prefix cache into ``slot`` of the pool and set the
    slot's length: a device copy in place of recomputing the prefix."""
    cache.k[:, slot] = prefix.k[:, 0]
    cache.v[:, slot] = prefix.v[:, 0]
    if cache.quantized:
        cache.k_scale[:, slot] = prefix.k_scale[:, 0]
        cache.v_scale[:, slot] = prefix.v_scale[:, 0]
    length = cache.length.clone()
    length[slot] = prefix.length.reshape(-1)[0]
    return cache._replace(length=length)


def _decide_on_rank0(tok: torch.Tensor, logp: torch.Tensor,
                     mesh) -> tuple:
    """Rank 0's sampled ids and log-probs, broadcast over the mesh: a
    token is decided once (ids < 2**24 are exact in f32)."""
    both = broadcast(torch.stack([tok.float(), logp.float()]), mesh,
                     mesh.axis_names)
    return both[0].to(tok.dtype), both[1].to(logp.dtype)


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
                      sample: SampleParams, mesh=None) -> tuple:
    """One decode step over the whole pool. cur_tok/active:
    (num_slots,). Inactive slots compute values that are discarded; they
    keep their token and their length. Also returns each sampled token's
    model log-prob (the behaviour log-prob GRPO trains against). On a
    mesh, rank 0's tokens and log-probs are every rank's."""
    logits, new_cache = forward(params, config, cur_tok[:, None],
                                cache=cache, mesh=mesh)
    logits = logits[:, -1, :]
    next_tok = sample_token(logits, generator,
                            temperature=sample.temperature,
                            top_k=sample.top_k, top_p=sample.top_p)
    next_tok = torch.where(active, next_tok, cur_tok)
    logp = sampled_logprob(logits, next_tok)
    if mesh is not None:
        next_tok, logp = _decide_on_rank0(next_tok, logp, mesh)
    length = torch.where(active, new_cache.length, cache.length)
    return next_tok, logp, new_cache._replace(length=length)


@torch.no_grad()
def _paged_fused_step(params: Params, config: ModelConfig,
                      toks: torch.Tensor, tables: torch.Tensor,
                      seq_row: torch.Tensor, positions: torch.Tensor,
                      write_block: torch.Tensor, write_off: torch.Tensor,
                      pool, generator: torch.Generator,
                      sample: SampleParams, use_kernel: bool,
                      adapters=None, adapter_ids=None) -> tuple:
    """forward_paged + in-step sampling over one flat token batch;
    returns (next tokens, their log-probs, pool) on the device. With an
    adapter pool, ``adapters`` (its banks, fixed shapes) and
    ``adapter_ids`` (per-rung (T,) slot ids, 0 for base rows) ride every
    call."""
    logits, pool = forward_paged(
        params, config, toks, pool=pool, tables=tables, seq_row=seq_row,
        positions=positions, write_block=write_block, write_off=write_off,
        use_kernel=use_kernel, adapters=adapters, adapter_ids=adapter_ids)
    next_tok = sample_token(logits, generator,
                            temperature=sample.temperature,
                            top_k=sample.top_k, top_p=sample.top_p)
    return next_tok, sampled_logprob(logits, next_tok), pool


@torch.no_grad()
def _draft_propose(params: Params, config: ModelConfig,
                   cur_tok: torch.Tensor, base_pos: torch.Tensor,
                   tables: torch.Tensor, pool, k: int,
                   use_kernel: bool) -> tuple:
    """Greedy draft proposals for the speculating rows: ``k`` draft
    decode steps over all of them at once, each feeding its own argmax
    back in. ``cur_tok`` / ``base_pos`` (R,) and ``tables`` (R, mb) are
    the rows' pending tokens, fill levels and draft block tables, on the
    host; write blocks and positions come from ``base_pos + i`` on the
    host, the argmax stays on the device and feeds the next call, and
    nothing is copied to the host here (the JAX version runs the same
    loop as one on-device scan). Returns ``(proposals (R, k) on the
    device, pool)``."""
    bs = pool.block_size
    seq_row = torch.arange(cur_tok.shape[0])
    tbl = tables.long()
    tok = cur_tok
    props = []
    for i in range(k):
        pos = base_pos + i
        logits, pool = forward_paged(
            params, config, tok, pool=pool, tables=tables, seq_row=seq_row,
            positions=pos, write_block=tbl[seq_row, pos // bs],
            write_off=pos % bs, use_kernel=use_kernel)
        tok = torch.argmax(logits, dim=-1)
        props.append(tok)
    return torch.stack(props, dim=1), pool


@torch.no_grad()
def _draft_feed_step(params: Params, config: ModelConfig,
                     toks: torch.Tensor, tables: torch.Tensor,
                     seq_row: torch.Tensor, positions: torch.Tensor,
                     write_block: torch.Tensor, write_off: torch.Tensor,
                     pool, use_kernel: bool):
    """Draft-cache catch-up: run the draft model over a flat token batch
    purely for its KV writes (logits discarded, no transfer). This is how
    the draft reaches lockstep with the target after prefill,
    continuations, preemption resume, rollback or a depth-0 stretch: the
    host replays the already-known token stream."""
    _logits, pool = forward_paged(
        params, config, toks, pool=pool, tables=tables, seq_row=seq_row,
        positions=positions, write_block=write_block, write_off=write_off,
        use_kernel=use_kernel)
    return pool


# Runtime observatory wiring (obs/runtime_profile.py): the step functions
# keep their ledgers and device-time histograms under the JAX engine's
# names. Params/config (args 0-1) are skipped from the per-call signature
# scan. The fused step takes exact-size token batches (eager PyTorch
# needs no padding ladder), so its signatures span every token count up
# to the step budget times the table-width buckets; the storm threshold
# sits above that, and only an unbounded stream trips it. The draft
# steps' signatures span the speculating rows x depths and the catch-up
# widths.
_pool_decode_step = ProfiledFunction(
    _pool_decode_step, "engine.decode_step", skip_args=(0, 1))
_paged_fused_step = ProfiledFunction(
    _paged_fused_step, "engine.fused_step", skip_args=(0, 1),
    storm_threshold=1024)
_draft_propose = ProfiledFunction(
    _draft_propose, "engine.spec_propose", skip_args=(0, 1),
    storm_threshold=1024)
_draft_feed_step = ProfiledFunction(
    _draft_feed_step, "engine.spec_feed", skip_args=(0, 1),
    storm_threshold=1024)


class RolloutEngine:
    """Continuous batching on one device, over a paged KV pool or the
    contiguous slot cache."""

    def __init__(self, params: Params, config: ModelConfig, *,
                 num_slots: int = 8, max_len: int = 2048,
                 sample: SampleParams = SampleParams(),
                 eos_id: Optional[int] = None, seed: int = 0,
                 mesh=None, max_prefixes: int = 8,
                 max_queue: Optional[int] = None,
                 engine_config: Optional[EngineConfig] = None,
                 adapter_pool=None, device="cuda"):
        self.device = resolve_device(device)
        self.engine_config = ec = engine_config or EngineConfig()
        if ec.kv_layout not in ("paged", "slots"):
            raise ValueError(f"unknown kv_layout {ec.kv_layout!r}")
        from ..training.trainer import check_mesh
        check_mesh(mesh)
        self.mesh = mesh
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
        self.params = self._place_params(params)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        # KV layout: the paged pool unless asked for slots, or the pool
        # has no equivalent yet (the int8 cache, ring caches, meshes).
        fallback = None
        if ec.kv_layout == "paged":
            if config.kv_quant:
                fallback = "kv_quant int8 cache"
            elif self._ring:
                fallback = "sliding-window ring cache"
            elif mesh is not None:
                fallback = "tensor-parallel KV sharding"
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
        # Multi-tenant LoRA (rollout/adapter_pool.py): the pool's banks and
        # per-entry slot ids ride the paged step. Paged only: the slot
        # path has no flat token batch to hook.
        if adapter_pool is not None:
            if self.kv_layout != "paged":
                raise ValueError(
                    "adapter_pool needs the paged KV layout"
                    + (f" (fell back to slots: {fallback})" if fallback
                       else ""))
            if adapter_pool.device.type != self.device.type:
                raise ValueError(f"adapter_pool lives on "
                                 f"{adapter_pool.device}, engine on "
                                 f"{self.device}")
        self.adapter_pool = adapter_pool
        if self.kv_layout == "slots":
            cache = init_kv_cache(self._cache_config(), num_slots, max_len,
                                  device=self.device)
            self.cache = cache._replace(length=torch.zeros(
                num_slots, dtype=torch.int32, device=self.device))
            self.cur_tok = torch.zeros(num_slots, dtype=torch.long,
                                       device=self.device)
        else:
            self._init_paged(ec)
            # host-side block table + fill level + decode cursor per row
            self._tables: List[List[int]] = [[] for _ in range(num_slots)]  # guarded-by: _lock
            self._row_len: List[int] = [0] * num_slots  # guarded-by: _lock
            self._cur_tok_host: List[int] = [0] * num_slots  # guarded-by: _lock
            self._prefill_jobs: Dict[int, _PrefillJob] = {}  # guarded-by: _lock
        self._slot_req: List[Optional[_Request]] = [None] * num_slots  # guarded-by: _lock
        # rid holding each slot's KV across turns (hold_slot), or None
        self._slot_held: List[Optional[int]] = [None] * num_slots  # guarded-by: _lock
        # monotonic hold sequence per slot: eviction drops the OLDEST
        self._hold_seq = 0                      # guarded-by: _lock
        self._slot_hold_seq: List[int] = [0] * num_slots  # guarded-by: _lock
        # The JAX engine's counters, under its names.
        self._stats = {"prefills": 0, "prefill_tokens": 0,  # guarded-by: _lock
                       "batched_prefills": 0, "batched_prefill_slots": 0,
                       "prefix_installs": 0, "prefix_tokens_reused": 0,
                       "prefix_evictions": 0, "prefix_prefills": 0,
                       "prefix_imports": 0, "prefix_exports": 0,
                       "prefix_cache_hits": 0, "prefix_cache_misses": 0,
                       "continuations": 0, "continuation_delta_tokens": 0,
                       "decode_steps": 0, "tokens_emitted": 0,
                       "hold_evictions": 0, "kv_preemptions": 0,
                       "prefix_swap_outs": 0, "prefix_swap_ins": 0,
                       "kv_preemption_storms": 0,
                       "prefix_host_exports": 0,
                       "spec_rounds": 0, "spec_proposed": 0,
                       "spec_accepted": 0, "spec_wasted": 0,
                       "spec_feed_tokens": 0, "spec_rollbacks": 0,
                       "migrations_out": 0, "migrations_in": 0,
                       "group_prefills": 0, "group_forks": 0,
                       "group_prefill_tokens_avoided": 0,
                       "group_degrades": 0, "branch_forks": 0}
        # Live migration (rollout/migration.py): with a migrating
        # coordinator attached (it sets this flag), the pressure ladder
        # OFFERS a request at the preemption cap for migration (one
        # preemption, its rid surfaced by take_pressure_migrations) before
        # falling back to truncate-finish. Off for a standalone engine.
        self.migrate_on_pressure = False
        self._pressure_migrations: List[int] = []  # guarded-by: _lock
        self._migration_offered: set = set()    # guarded-by: _lock
        # Bounded admission (None = unbounded): submit() raises QueueFull
        # past this many QUEUED requests.
        self.max_queue = max_queue
        self._queue: Deque[_Request] = deque()  # guarded-by: _lock
        self._requests: Dict[int, _Request] = {}  # guarded-by: _lock
        self._next_rid = 0                      # guarded-by: _lock
        # Group-shared rollout (submit_group): live groups by gid; entries
        # drop once the last follower grafts or the group degrades.
        self._groups: Dict[int, _GroupShare] = {}  # guarded-by: _lock
        self._next_gid = 0                      # guarded-by: _lock
        # Fused speculation (enable_speculation): draft model + its own
        # block pool, in lockstep with the target rows. None = off.
        self._spec: Optional[_SpecState] = None  # guarded-by: _lock
        self._draft_tables: List[List[int]] = []  # guarded-by: _lock
        self._draft_len: List[int] = []         # guarded-by: _lock
        self._draft_pool = None                 # guarded-by: _lock
        # fleet load signal (remaining decode tokens) pushed by a serving
        # replica for the depth controller; None = standalone
        self._spec_fleet_tokens: Optional[float] = None  # guarded-by: _lock
        # Slot layout: tokens sampled during prefill, surfaced by the next
        # step().
        self._pending_emits: Dict[int, List[int]] = {}  # guarded-by: _lock
        # Preemption-storm latch: rids already counted as storm-capped.
        self._storm_rids: set = set()           # guarded-by: _lock
        # Prefix cache: pid -> (tokens, entry, last-token logits). The
        # entry is the prefix's pool blocks on paged (None while the
        # prefix lives in the host tier) and a one-slot KVCache on slots.
        self._prefixes: Dict[int, tuple] = {}   # guarded-by: _lock
        self._prefix_by_tokens: Dict[tuple, int] = {}  # guarded-by: _lock
        self._next_prefix_id = 0                # guarded-by: _lock
        # LRU budget in entries; an evicted prefix falls back to a full
        # prefill (auto_prefix clients re-register on the KeyError)
        self.max_prefixes = max(1, int(max_prefixes))
        self._prefix_last_use: Dict[int, int] = {}  # guarded-by: _lock
        self._prefix_use_seq = 0                # guarded-by: _lock
        # grafts + exports per prefix: the tier-or-evict signal
        self._prefix_use_count: Dict[int, int] = {}  # guarded-by: _lock
        # host tier: pid -> HostPrefix (host tensors) for swapped-out
        # prefixes
        self._prefix_host: Dict[int, HostPrefix] = {}  # guarded-by: _lock
        # Many agent loops may drive one engine: all state mutation is
        # serialized.
        self._lock = threading.RLock()

    def _place_params(self, params: Params) -> Params:
        """Full params as this engine serves them: this rank's tp shards
        on a mesh (replicated over every other axis)."""
        if self.mesh is None:
            return params
        from ..parallel.sharding import shard_params
        return shard_params(params, self.mesh, axes=("tp",))

    def _cache_config(self) -> ModelConfig:
        """The config of this rank's KV cache (its Hkv/tp heads)."""
        if self.mesh is None:
            return self.config
        return tp_local_config(self.config, self.mesh.axis_size("tp"))

    def _decide(self, tok: torch.Tensor, logp: torch.Tensor) -> tuple:
        return (_decide_on_rank0(tok, logp, self.mesh)
                if self.mesh is not None else (tok, logp))

    def _init_paged(self, ec: EngineConfig) -> None:
        """The block pool, its allocator, the step's token budget and the
        attention path (the host-side row state is set in ``__init__``)."""
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
            nb, bs, registry=get_registry(),
            bytes_per_block=pool_bytes_per_block(self.pool))
        self._storm_total = get_registry().counter(
            "senweaver_kv_preemption_storms_total",
            "Requests preempted EngineConfig.max_preempts times and "
            "latched non-preemptible (starvation guard).")
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
        """On-policy weight sync between rounds. In-flight requests are
        untouched; callers sync at round boundaries.

        Registered prefixes are DROPPED (their KV was computed by the old
        policy): clients holding a prefix_id get a KeyError on next use
        and re-register (EnginePolicyClient does so). Held conversations
        are dropped for the same reason; their next turn re-prefills. With
        speculation on, the draft is stamped stale and the acceptance EMA
        restarts (unless a fleet publisher already stamped this publish
        through :meth:`spec_note_publish_begin`). An engine serving int8
        weights (``models/quantize.py``) quantizes a full-precision
        publish again."""
        embed = params["embed"]
        if embed.device.type != self.device.type:
            raise ValueError(f"params live on {embed.device}, engine on "
                             f"{self.device}")
        if is_quantized(self.params) and not is_quantized(params):
            # an int8 engine keeps its serving representation across a
            # trainer's full-precision publish
            params = quantize_weights_int8(params)
        params = self._place_params(params)
        with self._lock:
            self.params = params
            # release_prefix, not .clear(): paged prefixes hand their
            # block references back to the pool
            for pid in list(self._prefixes):
                self.release_prefix(pid)
            for slot in range(self.num_slots):
                self._drop_hold(slot)
            if self._spec is not None:
                if self._spec.publish_pending:
                    self._spec.publish_pending = False
                else:
                    self._spec_mark_stale()

    # -- fused speculative decoding ----------------------------------------

    def enable_speculation(self, draft_params: Params,
                           draft_config: ModelConfig, *,
                           controller=None, depth: Optional[int] = None,
                           num_blocks: Optional[int] = None,
                           version: int = 0) -> None:
        """Turn on fused speculative decoding: a draft model proposes up
        to ``depth`` tokens per row and the target verifies them inside
        the engine's fused step, sharing the ``step_tokens`` budget with
        chunked prefill and continuous batching. Greedy acceptance
        (proposal == target argmax) keeps outputs identical to
        non-speculative decode.

        ``controller`` picks the depth per step from load
        (spec_controller.SpecController, the default); ``depth`` pins a
        fixed depth instead. The draft serves from its own block pool
        (``num_blocks``; default (num_slots + 2) rows' worth) on the
        engine's device, whose gauges publish under
        ``senweaver_spec_draft_kv_*``."""
        if self.kv_layout != "paged":
            raise ValueError(
                "fused speculation needs the paged KV layout (engine "
                f"fell back to slots: {self.kv_layout_fallback})")
        if self.sample.temperature > 0:
            raise ValueError(
                "fused speculation is greedy-only: construct the "
                "engine with sample.temperature == 0")
        if draft_config.vocab_size != self.config.vocab_size:
            raise ValueError(
                f"draft vocab {draft_config.vocab_size} != target "
                f"vocab {self.config.vocab_size}")
        embed = draft_params["embed"]
        if embed.device.type != self.device.type:
            raise ValueError(f"draft params live on {embed.device}, engine "
                             f"on {self.device}")
        with self._lock:
            if controller is None:
                controller = (FixedDepth(int(depth)) if depth is not None
                              else SpecController())
            bs = self._alloc.block_size
            nb = int(num_blocks) if num_blocks else (
                (self.num_slots + 2) * self._blocks_per_row)
            reg = get_registry()
            self._spec = _SpecState(
                params=draft_params, config=draft_config,
                controller=controller, version=int(version),
                alloc=BlockAllocator(nb, bs,
                                     registry=_DraftMetricsView(reg)),
                depth_gauge=reg.gauge(
                    "senweaver_spec_depth",
                    "Applied speculation depth of the most recently "
                    "stepped engine (0 = speculation off)."),
                accept_gauge=reg.gauge(
                    "senweaver_spec_acceptance_rate",
                    "EMA of the draft-token acceptance rate (reset on "
                    "weight publish)."),
                staleness_gauge=reg.gauge(
                    "senweaver_spec_draft_staleness",
                    "Target weight publishes since the draft was last "
                    "republished (0 = draft tracks the policy)."),
                wasted_total=reg.counter(
                    "senweaver_spec_wasted_draft_tokens_total",
                    "Draft tokens proposed but rejected by "
                    "verification (pure wasted draft+verify work)."))
            self._draft_pool = init_paged_pool(draft_config, nb, bs,
                                               device=self.device)
            self._draft_tables = [[] for _ in range(self.num_slots)]
            self._draft_len = [0] * self.num_slots
            self._spec.staleness_gauge.set(0.0)

    def update_draft_params(self, params: Params, *,
                            version: Optional[int] = None) -> None:
        """Install republished draft weights (the online distiller's
        output). Draft rows are dropped (their KV came from the old
        draft) and re-fed from the host token stream by catch-up; the
        acceptance EMA restarts. Never blocks on in-flight requests:
        draft weights cannot affect output correctness, only the
        acceptance rate."""
        with self._lock:
            sp = self._spec
            if sp is None:
                raise RuntimeError("enable_speculation() first")
            sp.params = params
            sp.version = sp.version + 1 if version is None else int(version)
            sp.draft_synced_at = sp.target_version
            for row in range(self.num_slots):
                self._draft_release_row(row)
            self._spec_reset_ema()
            sp.staleness_gauge.set(0.0)

    # -- multi-tenant adapters ----------------------------------------------

    def publish_adapter(self, adapter_id: str, lora, *,
                        version: Optional[int] = None) -> int:
        """No-drain per-tenant adapter publish: hand the pool a new host
        copy under the tenant's monotonic ``adapter_version``. Nothing
        resident changes: in-flight requests finish on the binding they
        acquired at submit, and the tenant's next submit uploads the new
        version on demand. Unlike :meth:`update_params` this drops no
        prefix and stamps no draft stale: the base policy is untouched."""
        if self.adapter_pool is None:
            raise RuntimeError("engine has no adapter_pool")
        return self.adapter_pool.publish(adapter_id, lora, version=version)

    def has_adapter(self, adapter_id: Optional[str]) -> bool:
        """True when a tenant adapter is published (host copy held);
        ``submit(adapter_id=...)`` will decode under it."""
        return (self.adapter_pool is not None
                and self.adapter_pool.has(adapter_id))

    def adapter_resident(self, adapter_id: str) -> bool:
        """True when the tenant's CURRENT version occupies a device slot
        (a router's warm-affinity signal)."""
        return (self.adapter_pool is not None
                and self.adapter_pool.resident(adapter_id))

    def adapter_stats(self) -> Dict[str, object]:
        return ({} if self.adapter_pool is None
                else self.adapter_pool.stats())

    def spec_note_publish_begin(self) -> None:
        """Fleet hook: the policy is about to change, so stamp the draft
        stale and reset the acceptance EMA now, instead of trusting
        stats from a draft that no longer matches the policy being
        rolled out."""
        with self._lock:
            if self._spec is None:
                return
            self._spec.publish_pending = True
            self._spec_mark_stale()

    def _spec_mark_stale(self) -> None:
        # guarded-by: caller
        sp = self._spec
        sp.target_version += 1
        self._spec_reset_ema()
        sp.staleness_gauge.set(sp.target_version - sp.draft_synced_at)

    def _spec_reset_ema(self) -> None:
        # guarded-by: caller
        sp = self._spec
        sp.ema = 0.0
        sp.ema_init = False
        sp.accept_gauge.set(0.0)

    def set_spec_depth(self, depth: int) -> None:
        """Pin the speculation depth (tests, manual override)."""
        with self._lock:
            sp = self._spec
            if sp is None:
                raise RuntimeError("enable_speculation() first")
            if hasattr(sp.controller, "force_depth"):
                sp.controller.force_depth(depth)
            else:
                sp.controller.value = int(depth)

    def note_decode_load(self, remaining_tokens: float) -> None:
        """Serving-replica hook: push the router's remaining-decode-token
        gauge for this replica so the depth controller sees fleet load,
        not just local occupancy."""
        with self._lock:
            self._spec_fleet_tokens = float(remaining_tokens)

    def drain_spec_outcomes(self) -> List[dict]:
        """Hand the buffered verification outcomes (context, the
        target-chosen tokens, accepted count) to the online distiller and
        clear the ring."""
        with self._lock:
            if self._spec is None:
                return []
            out = list(self._spec.outcomes)
            self._spec.outcomes.clear()
            return out

    def spec_stats(self) -> Dict[str, object]:
        """Speculation snapshot: depth, acceptance EMA, staleness,
        proposal/acceptance counters."""
        with self._lock:
            sp = self._spec
            if sp is None:
                return {"enabled": False}
            return {
                "enabled": True,
                "depth": sp.depth_applied,
                "acceptance_ema": sp.ema if sp.ema_init else None,
                "draft_version": sp.version,
                "draft_staleness": sp.target_version - sp.draft_synced_at,
                "rounds": self._stats["spec_rounds"],
                "proposed": self._stats["spec_proposed"],
                "accepted": self._stats["spec_accepted"],
                "wasted_draft_tokens": self._stats["spec_wasted"],
                "draft_feed_tokens": self._stats["spec_feed_tokens"],
                "draft_blocks_free": sp.alloc.free_blocks,
            }

    def spec_check_leaks(self) -> None:
        """Tripwire for tests: after all rows release, the DRAFT pool
        must be fully free too (rollback, preemption and finish paths)."""
        with self._lock:
            if self._spec is not None:
                self._spec.alloc.check_leaks()

    # -- public API ---------------------------------------------------------

    def submit(self, prompt: List[int], *, max_new_tokens: int = 128,
               prefix_id: Optional[int] = None,
               eos_id: Optional[int] = None,
               hold_slot: bool = False,
               continue_from: Optional[int] = None,
               adapter_id: Optional[str] = None) -> int:
        with self._lock:
            return self._submit(prompt, max_new_tokens=max_new_tokens,
                                prefix_id=prefix_id, eos_id=eos_id,
                                hold_slot=hold_slot,
                                continue_from=continue_from,
                                adapter_id=adapter_id)

    def _submit(self, prompt: List[int], *, max_new_tokens: int,
                eos_id: Optional[int], prefix_id: Optional[int] = None,
                hold_slot: bool = False,
                continue_from: Optional[int] = None,
                adapter_id: Optional[str] = None) -> int:
        # guarded-by: caller
        if not prompt:
            raise ValueError("empty prompt")
        if continue_from is not None:
            if adapter_id is not None:
                raise ValueError("continuations inherit the held slot's "
                                 "KV; submit adapter decodes fresh")
            return self._submit_continuation(
                prompt, max_new_tokens=max_new_tokens, eos_id=eos_id,
                hold_slot=hold_slot, continue_from=continue_from)
        if adapter_id is not None and self.adapter_pool is None:
            raise ValueError("engine has no adapter_pool")
        if len(prompt) >= self.context_bound:
            raise ValueError(
                f"prompt length {len(prompt)} ≥ engine max_len bound "
                f"{self.context_bound}")
        if (self.max_queue is not None
                and len(self._queue) >= self.max_queue):
            raise QueueFull(
                f"engine queue at max_queue={self.max_queue} "
                f"({len(self._queue)} queued)")
        if prefix_id is not None:
            if prefix_id not in self._prefixes:
                raise KeyError(f"unknown prefix_id {prefix_id}")
            p_tokens = self._prefixes[prefix_id][0]
            if list(prompt[:len(p_tokens)]) != p_tokens:
                raise ValueError(
                    "prompt does not start with the registered prefix "
                    f"(prefix_id {prefix_id}, {len(p_tokens)} tokens)")
        binding = None
        if adapter_id is not None:
            # Resolve the tenant's CURRENT adapter version to a device slot
            # now and hold it for the request's whole life: a publish that
            # lands mid-decode is picked up only by the next request.
            # Raises KeyError (unpublished tenant) or AdapterPoolFull
            # before any engine state is touched.
            binding = self.adapter_pool.acquire(adapter_id)
        rid = self._next_rid
        self._next_rid += 1
        req = _Request(rid=rid, prompt=list(prompt),
                       max_new_tokens=max_new_tokens,
                       eos_id=self.eos_id if eos_id is None else eos_id,
                       prefix_id=prefix_id, hold_slot=hold_slot,
                       adapter=adapter_id, adapter_binding=binding)
        self._requests[rid] = req
        # enqueue only: scheduling happens at the next step(), so a burst
        # of submissions lands in the queue together
        self._queue.append(req)
        return rid

    def submit_group(self, prompt: List[int], group_size: int, *,
                     max_new_tokens: int = 128,
                     eos_id: Optional[int] = None,
                     adapter_id: Optional[str] = None) -> List[int]:
        """Submit a GRPO group of ``group_size`` decodes of one shared
        ``prompt``, paying exactly ONE prefill. The first member (the
        donor) takes the normal chunked prefill; when it completes,
        before the donor's first sampled token is written (so the table
        is the pure prompt spine), the engine captures a fork of the
        table and each follower grafts it (refcount bump, zero KV bytes
        moved) plus a one-token dropped-write rescore of the last prompt
        token: the same logits the donor sampled its first token from, so
        greedy outputs equal ``group_size`` independent submits.
        Divergence into the shared boundary block copies it on first
        write. If the donor dies before capture (preemption with emitted
        tokens, a release), followers degrade to plain unshared
        prefills: exactness is never traded for sharing.

        Followers pin the donor's adapter binding (``retain``), so a
        publish landing mid-group cannot mix adapter versions across the
        group. Requires the paged KV layout. Returns the group's rids,
        donor first."""
        if group_size < 1:
            raise ValueError(f"group_size {group_size} < 1")
        if self.kv_layout != "paged":
            raise ValueError("submit_group requires the paged KV layout")
        with self._lock:
            donor_rid = self._submit(prompt,
                                     max_new_tokens=max_new_tokens,
                                     eos_id=eos_id, adapter_id=adapter_id)
            if group_size == 1:
                return [donor_rid]
            donor = self._requests[donor_rid]
            gid = self._next_gid
            self._next_gid += 1
            group = _GroupShare(gid=gid, donor_rid=donor_rid,
                                pending=group_size - 1)
            self._groups[gid] = group
            donor.group = group
            rids = [donor_rid]
            for _ in range(group_size - 1):
                binding = None
                if donor.adapter_binding is not None:
                    # version-exact pin of the donor's binding: the donor's
                    # reference keeps the slot alive under the engine lock,
                    # so this cannot miss
                    binding = self.adapter_pool.retain(
                        donor.adapter_binding)
                rid = self._next_rid
                self._next_rid += 1
                req = _Request(rid=rid, prompt=list(prompt),
                               max_new_tokens=max_new_tokens,
                               eos_id=(self.eos_id if eos_id is None
                                       else eos_id),
                               adapter=adapter_id, adapter_binding=binding,
                               group=group)
                self._requests[rid] = req
                # NOT queued: a follower waits on the spine capture so its
                # scheduling can never race the donor's prefill
                group.waiters.append(req)
                rids.append(rid)
            return rids

    def fork_request(self, rid: int, *, token: Optional[int] = None,
                     max_new_tokens: Optional[int] = None) -> int:
        """Branch a new decode off an in-flight request's current
        position (tree-structured rollout). The child shares the parent's
        KV spine through a refcounted table fork (zero bytes copied);
        either side's next write into the shared boundary block copies
        it. Two modes:

        * ``token=None``: sampled continuation. The child adopts the
          parent's last sampled token as its own first emission and
          decodes an alternative suffix after it.
        * ``token=T``: forced branch. ``T`` REPLACES the parent's last
          sampled token in the child's stream; the child's first sampled
          token comes from feeding ``T``.

        Either way the child decodes under the parent's PINNED adapter
        version, and its greedy output equals an independent submit of
        the same stream as a fresh prompt. Without a free row the child
        enters the queue and builds its context through the standard
        recompute path (unshared but exact). Raises ``KeyError`` for
        unknown rids and ``ValueError`` for requests that are done,
        paused or still prefilling."""
        if self.kv_layout != "paged":
            raise ValueError("fork_request requires the paged KV layout")
        with self._lock:
            parent = self._requests.get(rid)
            if parent is None:
                raise KeyError(f"unknown rid {rid}")
            if parent.done or parent.paused:
                raise ValueError(
                    f"rid {rid} is not an active decode (done/paused)")
            if rid in self._prefill_jobs or not parent.tokens:
                raise ValueError(f"rid {rid} is still prefilling")
            binding = None
            if parent.adapter_binding is not None:
                binding = self.adapter_pool.retain(parent.adapter_binding)
            budget = (max_new_tokens if max_new_tokens is not None
                      else parent.max_new_tokens)
            crid = self._next_rid
            self._next_rid += 1
            # the shared spine is everything whose k/v is resident: prompt
            # + tokens[:-1] (the last sampled token is written only when
            # it is fed)
            spine = list(parent.prompt) + parent.tokens[:-1]
            lineage = dict(parent_rid=rid, branch_pos=len(parent.tokens),
                           branch_depth=parent.branch_depth + 1,
                           adapter=parent.adapter, adapter_binding=binding)
            if token is None:
                child = _Request(rid=crid, prompt=spine,
                                 max_new_tokens=budget,
                                 eos_id=parent.eos_id,
                                 tokens=[parent.tokens[-1]],
                                 logps=[parent.logps[-1]], **lineage)
            else:
                child = _Request(rid=crid, prompt=spine + [int(token)],
                                 max_new_tokens=budget,
                                 eos_id=parent.eos_id, **lineage)
            self._requests[crid] = child
            row = parent.slot
            free = self._free_slots()
            if row is not None and self._tables[row] and free:
                crow = free[0]
                plen = self._row_len[row]
                nblk = self._alloc.blocks_for(plen)
                child.slot = crow
                self._slot_req[crow] = child
                self._tables[crow] = self._alloc.fork(
                    self._tables[row][:nblk])
                self._row_len[crow] = plen
                self._stats["branch_forks"] += 1
                self._stats["group_prefill_tokens_avoided"] += plen
                if token is None:
                    # a decode row at once: feed the adopted token next
                    # step (its write copies the shared boundary block)
                    self._cur_tok_host[crow] = child.tokens[-1]
                else:
                    # rescore with REAL writes: feed the forced token at
                    # the branch position and sample from it
                    self._stats["prefill_tokens"] += 1
                    self._prefill_jobs[crid] = _PrefillJob(
                        toks=[int(token)], pos=plen, sample_last=True)
            else:
                # no shareable row: queue the child; tokens non-empty takes
                # the preemption-resume replay, a forced token a plain full
                # prefill (both unshared and exact)
                self._queue.append(child)
            return crid

    # -- live migration (rollout/migration.py) -------------------------------

    def checkpoint_request(self, rid: int, *, pause: bool = True):
        """Snapshot an in-flight request into a portable
        :class:`~.migration.DecodeCheckpoint` (non-destructive; the
        request is left PAUSED so its state cannot advance between the
        snapshot and the coordinator's release or resume). Freeze and
        snapshot happen together under the engine lock."""
        from .migration import checkpoint_from_engine
        with self._lock:
            return checkpoint_from_engine(self, rid, pause=pause)

    def restore_request(self, ckpt) -> int:
        """Install a peer's checkpoint under a fresh rid and return it:
        one in-place install when a free row and a matching block layout
        exist, otherwise a front-of-queue requeue that resumes through the
        preemption-recompute replay. Either way the resumed output is
        token-exact against never migrating."""
        from .migration import restore_into_engine
        with self._lock:
            rid = restore_into_engine(self, ckpt)
            self._schedule()
            return rid

    def release_request(self, rid: int) -> bool:
        """Forget a request (the post-handoff cleanup of a migration):
        drop its row and blocks, adapter binding, queue entry and pending
        emits. A group donor released before the spine capture degrades
        its followers to plain prefills; a released follower surrenders
        its graft slot so the retained spine cannot strand. Idempotent:
        unknown rids return False."""
        from .migration import release_from_engine
        with self._lock:
            req = self._requests.get(rid)
            if req is not None:
                self._group_degrade_if_uncaptured(req)
                self._group_forget_follower(req)
            out = release_from_engine(self, rid)
            self._schedule()
            return out

    def pause_request(self, rid: int) -> None:
        """Freeze one request (migration prepare): skipped by the step
        assembler, the speculation planner and the scheduler."""
        from .migration import set_paused
        with self._lock:
            set_paused(self, rid, True)

    def resume_request(self, rid: int) -> None:
        """Unfreeze a paused request (migration aborted: the fence
        tripped, the install failed, or the target died): it resumes
        decoding HERE, token-exactly, as if never frozen."""
        from .migration import set_paused
        with self._lock:
            set_paused(self, rid, False)

    def take_pressure_migrations(self) -> List[int]:
        """Drain the rids the pressure ladder offered for migration
        instead of truncate-finishing (paused, blocks already freed). The
        coordinator either migrates each or resumes it locally; a resumed
        request that caps out again truncates."""
        with self._lock:
            out = [rid for rid in self._pressure_migrations
                   if rid in self._requests
                   and not self._requests[rid].done]
            self._pressure_migrations = []
            return out

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
            out["weight_quant"] = int(is_quantized(self.params))
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
            out["kv_swapped_blocks"] = self._swapped_blocks_total()
            out["kv_dtype"] = self.engine_config.kv_dtype
            out["kv_bytes_per_block"] = self._alloc.bytes_per_block
            out["kv_bytes_device"] = self._alloc.used_bytes
            out["kv_bytes_host"] = self._alloc.swapped_bytes
            out["paged_kernel"] = int(self._use_paged_kernel)
            if self.adapter_pool is not None:
                ap = self.adapter_pool.stats()
                out["adapters_published"] = len(ap["adapters"])
                out["adapter_installs"] = int(ap["installs"])
                out["adapter_evictions"] = int(ap["evictions"])
            return out

    @property
    def kv_pressure(self) -> float:
        """Pool utilization 0..1, the backpressure signal admission and
        autoscale planes watermark on (0.0 on the slot layout, which has
        no block pool to exhaust)."""
        if self.kv_layout != "paged":
            return 0.0
        return self._alloc.used_blocks / self._alloc.num_blocks

    @property
    def queue_depth(self) -> int:
        """Requests submitted but not yet scheduled into a slot."""
        with self._lock:
            return len(self._queue)

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

    # -- held-slot continuations --------------------------------------------

    def _submit_continuation(self, prompt: List[int], *,
                             max_new_tokens: int, eos_id: Optional[int],
                             hold_slot: bool, continue_from: int) -> int:
        # guarded-by: caller
        """Multi-turn continuation: append only the NEW tokens to a held
        slot's resident KV. ``prompt`` is the FULL token stream; it must
        extend the held history exactly."""
        prev = self._requests.get(continue_from)
        if prev is None or not prev.done or prev.held_history is None:
            raise ValueError(
                f"continue_from={continue_from}: request not finished "
                f"while holding a slot")
        try:
            slot = self._slot_held.index(continue_from)
        except ValueError:
            raise ValueError(
                f"continue_from={continue_from}: slot already released")
        history = prev.held_history
        if (len(prompt) <= len(history)
                or list(prompt[:len(history)]) != history):
            raise ValueError(
                "prompt does not extend the held conversation "
                f"({len(history)} resident tokens); release the slot "
                "and submit a full prefill instead")
        if len(prompt) >= self.context_bound:
            raise ValueError(
                f"prompt length {len(prompt)} ≥ engine max_len bound "
                f"{self.context_bound}")
        delta = list(prompt[len(history):])
        rid = self._next_rid
        self._next_rid += 1
        req = _Request(rid=rid, prompt=list(prompt),
                       max_new_tokens=max_new_tokens,
                       eos_id=self.eos_id if eos_id is None else eos_id,
                       hold_slot=hold_slot, slot=slot)
        # The held KV was computed under prev's adapter binding, so the
        # continuation inherits it (ownership transfers; released when
        # this request finishes without holding).
        req.adapter = prev.adapter
        req.adapter_binding = prev.adapter_binding
        prev.adapter_binding = None
        self._requests[rid] = req
        self._slot_held[slot] = None
        self._slot_req[slot] = req
        self._stats["continuations"] += 1
        self._stats["continuation_delta_tokens"] += len(delta)
        if self.kv_layout == "paged":
            # the held row's blocks stay resident; the delta becomes a
            # chunked-prefill job (a boundary block still shared with a
            # prefix is copied on the delta's first write)
            self._prefill_jobs[rid] = _PrefillJob(
                toks=delta, pos=len(history), sample_last=True)
            return rid
        with get_tracer().span("engine.prefill_continuation", slot=slot,
                               delta_tokens=len(delta)):
            last_logits = self._prefill_chunks(slot, delta,
                                               fresh_first=False)
        self._emit_first_token(req, slot, last_logits)
        return rid

    def release_slot(self, rid: int) -> None:
        """Free a slot held by a finished hold_slot request."""
        with self._lock:
            try:
                slot = self._slot_held.index(rid)
            except ValueError:
                return
            self._drop_hold(slot)
            self._schedule()

    # -- shared prefixes ----------------------------------------------------

    def register_prefix(self, tokens: List[int]) -> int:
        """Prefill ``tokens`` once; return a prefix_id for submit().

        The prefix prefills on a one-slot cache (the slot path, as the
        JAX engine does). On paged its KV is then written into dedicated
        pool blocks that every consumer grafts; on slots the one-slot
        cache is the entry and each consumer copies it into its slot.
        ``submit(prompt, prefix_id=...)`` requires the prompt to START
        with these tokens and prefills only the rest. Identical token
        lists dedup to one entry; past ``max_prefixes`` the least
        recently used entry is released."""
        with self._lock:
            if not tokens:
                raise ValueError("empty prefix")
            if len(tokens) >= self.max_len:
                raise ValueError(
                    f"prefix length {len(tokens)} ≥ pool capacity "
                    f"{self.max_len}")
            key = tuple(tokens)
            if key in self._prefix_by_tokens:
                pid = self._prefix_by_tokens[key]
                self._touch_prefix(pid)
                return pid
            self._make_prefix_room()
            sub = init_kv_cache(self._cache_config(), 1, self.max_len,
                                device=self.device)
            last = None
            pos = 0
            for i, size in enumerate(_chunk_sizes(len(tokens),
                                                  self.max_len)):
                chunk = torch.tensor(tokens[pos:pos + size],
                                     dtype=torch.long, device=self.device)
                last, sub = prefill(self.params, self.config, chunk[None, :],
                                    sub, fresh_cache=(i == 0),
                                    mesh=self.mesh)
                pos += size
            if self.kv_layout == "paged":
                nblk = self._alloc.blocks_for(len(tokens))
                blocks = self._alloc_blocks_evicting(nblk)
                k_buf, v_buf = self._blockify(sub, nblk)
                install_blocks(self.pool, k_buf, v_buf, blocks)
                entry = blocks
            else:
                entry = sub
            # a copy: the row is a view of the whole prefill's logits
            pid = self._add_prefix(list(tokens), entry, last[0].clone())
            self._stats["prefix_prefills"] += 1
            return pid

    def export_prefix(self, prefix_id: int):
        """A registered prefix for installation into ANOTHER engine:
        ``(tokens, kv, last_logits)``, with ``kv`` a one-slot KVCache
        ``(L, 1, max_len, Hkv, Dh)`` and ``last_logits`` the final
        token's logits (or None). Every tensor is a COPY: later writes
        into this engine's pool cannot change it. A host-tiered prefix
        exports from the host tier (host tensors, no device traffic).
        Raises KeyError for an evicted or invalidated prefix."""
        with self._lock:
            if prefix_id not in self._prefixes:
                raise KeyError(f"unknown prefix_id {prefix_id}")
            tokens, entry, last = self._prefixes[prefix_id]
            self._touch_prefix(prefix_id)
            self._stats["prefix_exports"] += 1
            if self.kv_layout != "paged" and self.mesh is not None:
                # every KV head: this rank's gathered with the others'
                kv = KVCache(*(None if a is None else a.clone() if a.ndim < 4
                               else all_gather(a, self.mesh, "tp", 3)
                               for a in entry))
            elif self.kv_layout != "paged":
                kv = KVCache(*(None if a is None else a.clone()
                               for a in entry))
            elif entry is None:
                kv = self._export_host(prefix_id)
                self._stats["prefix_host_exports"] += 1
            else:
                kv = self._export_blocks(tokens, entry)
            return (list(tokens), kv,
                    None if last is None else last.clone())

    def prefix_in_host_tier(self, prefix_id: int) -> bool:
        """True when the prefix's KV lives only in the host-RAM tier."""
        with self._lock:
            return prefix_id in self._prefix_host

    def import_prefix(self, tokens: List[int], kv: KVCache,
                      last_logits=None) -> int:
        """Adopt a prefix KV computed by a peer engine (its
        :meth:`export_prefix`) under a fresh prefix_id, LRU-accounted like
        a local one. The buffer must match this pool's slot layout: shape
        ``(L, 1, max_len, Hkv, Dh)``, dtype, quantization flavour and a
        recorded length of ``len(tokens)``; anything else raises
        :class:`PrefixImportError`. On a uniformly quantized paged pool a
        matching quantized buffer is written as it is (payload and
        scales) and a full-width one is quantized at install; a
        mixed-ladder pool takes full width and dequantizes a quantized
        buffer at the door. Without ``last_logits`` a zero-suffix submit
        rescores the last prefix token (writes dropped) on first use."""
        with self._lock:
            if not tokens:
                raise ValueError("empty prefix")
            if len(tokens) >= self.max_len:
                raise ValueError(
                    f"prefix length {len(tokens)} ≥ pool capacity "
                    f"{self.max_len}")
            key = tuple(tokens)
            if key in self._prefix_by_tokens:
                pid = self._prefix_by_tokens[key]
                self._touch_prefix(pid)
                return pid
            kv = KVCache(*(None if a is None else torch.as_tensor(a)
                           for a in kv))
            if self.mesh is not None and kv.k.shape[3] \
                    == self.config.num_kv_heads:
                # a prefix with every KV head: install this rank's
                tp = self.mesh.axis_size("tp")
                part = self.config.num_kv_heads // tp
                h0 = self.mesh.coord("tp") * part
                kv = KVCache(*(None if a is None else a if a.ndim < 4
                               else a[:, :, :, h0:h0 + part]
                               for a in kv))
            if self.kv_layout == "paged":
                pool = self.pool
                num_layers = pool.num_layers
                hkv, dh = pool.k.shape[3], pool.k.shape[4]
                if kv.quantized and pool.quantized and pool.hi_layers == 0:
                    pool_dtype, pool_quant = pool.k.dtype, True
                else:
                    pool_dtype, pool_quant = self.config.dtype, False
                    if kv.quantized:
                        kv = KVCache(
                            k=dequantize_pool_kv(kv.k, kv.k_scale,
                                                 pool_dtype),
                            v=dequantize_pool_kv(kv.v, kv.v_scale,
                                                 pool_dtype),
                            length=kv.length)
            else:
                num_layers, _, _, hkv, dh = self.cache.k.shape
                pool_dtype = self.cache.k.dtype
                pool_quant = bool(self.cache.quantized)
            want = (num_layers, 1, self.max_len, hkv, dh)
            if tuple(kv.k.shape) != want or tuple(kv.v.shape) != want:
                raise PrefixImportError(
                    f"prefix KV shape {tuple(kv.k.shape)}/"
                    f"{tuple(kv.v.shape)} != pool slot layout {want}")
            if kv.k.dtype != pool_dtype:
                raise PrefixImportError(
                    f"prefix KV dtype {kv.k.dtype} != pool dtype "
                    f"{pool_dtype}")
            if bool(kv.quantized) != pool_quant:
                raise PrefixImportError(
                    f"prefix quantization {kv.quantized} != pool "
                    f"quantization {pool_quant}")
            if pool_quant:
                want_s = want[:-1]
                if (tuple(kv.k_scale.shape) != want_s
                        or tuple(kv.v_scale.shape) != want_s):
                    raise PrefixImportError(
                        f"prefix KV scale shape {tuple(kv.k_scale.shape)}/"
                        f"{tuple(kv.v_scale.shape)} != {want_s}")
            kv_len = int(kv.length.reshape(-1)[0])
            if kv_len != len(tokens):
                raise PrefixImportError(
                    f"prefix KV records length {kv_len} but "
                    f"{len(tokens)} tokens were declared")
            self._make_prefix_room()
            if self.kv_layout == "paged":
                # the one buffer copy of the paged prefix plane: foreign
                # KV lands in pool blocks once; consumers graft after that
                nblk = self._alloc.blocks_for(len(tokens))
                blocks = self._alloc_blocks_evicting(nblk)
                if pool_quant:
                    install_blocks_quant(self.pool, BlockPayload(
                        k=self._blockify_arr(kv.k, nblk),
                        v=self._blockify_arr(kv.v, nblk),
                        k_scale=self._blockify_arr(kv.k_scale, nblk),
                        v_scale=self._blockify_arr(kv.v_scale, nblk)),
                        blocks)
                else:
                    k_buf, v_buf = self._blockify(kv, nblk)
                    install_blocks(self.pool, k_buf, v_buf, blocks)
                self._alloc.count_install_copy(nblk)
                entry = blocks
            else:
                # a copy on this engine's device: the caller keeps its
                # buffer and may write it
                entry = KVCache(*(None if a is None
                                  else a.to(self.device, copy=True)
                                  for a in kv))
            last = (None if last_logits is None
                    else torch.as_tensor(last_logits).to(self.device,
                                                         copy=True))
            pid = self._add_prefix(list(tokens), entry, last)
            self._stats["prefix_imports"] += 1
            return pid

    def _make_prefix_room(self) -> None:
        # guarded-by: caller
        """Release least-recently-used prefixes down to the budget."""
        while len(self._prefixes) >= self.max_prefixes:
            lru = min(self._prefix_last_use, key=self._prefix_last_use.get)
            self.release_prefix(lru)
            self._stats["prefix_evictions"] += 1

    def _add_prefix(self, tokens: List[int], entry, last) -> int:
        # guarded-by: caller
        pid = self._next_prefix_id
        self._next_prefix_id += 1
        self._prefixes[pid] = (tokens, entry, last)
        self._prefix_by_tokens[tuple(tokens)] = pid
        self._touch_prefix(pid)
        return pid

    def _touch_prefix(self, pid: int) -> None:
        # guarded-by: caller
        self._prefix_use_seq += 1
        self._prefix_last_use[pid] = self._prefix_use_seq
        self._prefix_use_count[pid] = self._prefix_use_count.get(pid, 0) + 1

    def release_prefix(self, prefix_id: int) -> None:
        """Free a registered prefix. On paged this drops the prefix's own
        reference on each of its blocks: consumers that grafted them keep
        theirs, so an in-flight request outlives its prefix. A
        host-tiered prefix just drops its host tensors."""
        with self._lock:
            entry = self._prefixes.pop(prefix_id, None)
            self._prefix_last_use.pop(prefix_id, None)
            self._prefix_use_count.pop(prefix_id, None)
            hp = self._prefix_host.pop(prefix_id, None)
            if entry is not None:
                self._prefix_by_tokens.pop(tuple(entry[0]), None)
                if self.kv_layout == "paged" and entry[1] is not None:
                    self._alloc.release(entry[1])
            if hp is not None:
                self._alloc.set_swapped_blocks(self._swapped_blocks_total())

    # -- row lifecycle ------------------------------------------------------

    def _group_degrade_if_uncaptured(self, req: _Request) -> None:
        # guarded-by: caller
        """A group donor died before the spine was captured (preemption
        with emitted tokens, a storm truncate-finish, a release): enqueue
        the waiting followers as plain unshared prefills. Slower, never
        inexact. No-op for non-donors and for groups whose spine already
        landed (followers hold their own forks)."""
        g = req.group
        if (g is None or req.rid != g.donor_rid or g.degraded
                or g.spine is not None or not g.waiters):
            return
        g.degraded = True
        self._stats["group_degrades"] += 1
        for w in g.waiters:
            if not w.done:
                self._queue.append(w)
        g.waiters = []
        self._groups.pop(g.gid, None)

    def _group_forget_follower(self, req: _Request) -> None:
        # guarded-by: caller
        """A follower left the group without grafting (released while
        queued or waiting, finished early): count its graft slot down so
        the engine-retained spine fork cannot be stranded, and drop it
        from the waiter list so a later capture cannot re-enqueue a dead
        request."""
        g = req.group
        if g is None or req.rid == g.donor_rid or req.group_grafted:
            return
        req.group_grafted = True
        g.waiters = [w for w in g.waiters if w.rid != req.rid]
        g.pending -= 1
        if g.pending <= 0:
            if g.spine is not None:
                self._alloc.release(g.spine)
                g.spine = None
            self._groups.pop(g.gid, None)

    def _finish_request(self, req: _Request, slot: int) -> None:
        # guarded-by: caller
        """Mark a request done and either hold or free its slot."""
        req.done = True
        self._group_degrade_if_uncaptured(req)
        self._group_forget_follower(req)
        self._slot_req[slot] = None
        if self.kv_layout == "paged":
            self._prefill_jobs.pop(req.rid, None)
        # Held conversations keep their adapter binding (the resident KV
        # was computed under it; a continuation inherits it).
        if (req.adapter_binding is not None and not req.hold_slot
                and self.adapter_pool is not None):
            self.adapter_pool.release(req.adapter_binding)
            req.adapter_binding = None
        if req.hold_slot:
            # the last sampled token's k/v is not written yet (a token is
            # fed the step after it is sampled), so the resident history
            # excludes it: a continuation's delta begins with it
            req.held_history = list(req.prompt) + req.tokens[:-1]
            self._slot_held[slot] = req.rid
            self._hold_seq += 1
            self._slot_hold_seq[slot] = self._hold_seq
            return
        req.slot = None
        if self.kv_layout == "paged":
            self._release_row(slot)

    def _drop_hold(self, slot: int) -> None:
        # guarded-by: caller
        """Invalidate a held conversation and free its slot."""
        rid = self._slot_held[slot]
        if rid is None:
            return
        prev = self._requests[rid]
        prev.held_history = None
        prev.slot = None
        if prev.adapter_binding is not None and self.adapter_pool is not None:
            self.adapter_pool.release(prev.adapter_binding)
            prev.adapter_binding = None
        self._slot_held[slot] = None
        if self.kv_layout == "paged":
            self._release_row(slot)

    def _evict_oldest_hold_if_stuck(self) -> None:
        # guarded-by: caller
        """Every slot held and work queued: nothing would ever free a
        slot, so run() would livelock. Held KV is droppable cache: evict
        the oldest hold (its next turn re-prefills)."""
        if self._queue and all(self._slot_held[s] is not None
                               for s in range(self.num_slots)):
            oldest = min(range(self.num_slots),
                         key=lambda s: self._slot_hold_seq[s])
            self._drop_hold(oldest)
            self._stats["hold_evictions"] += 1

    def _take_prefix_or_miss(self, req: _Request) -> None:
        # guarded-by: caller
        """A queued request whose prefix was invalidated meanwhile (a
        weight sync, the LRU budget) falls back to a full prefill."""
        if req.prefix_id is not None and req.prefix_id not in self._prefixes:
            req.prefix_id = None
            self._stats["prefix_cache_misses"] += 1

    def _schedule(self) -> None:
        # guarded-by: caller
        if self.kv_layout == "paged":
            self._schedule_paged()
        else:
            self._schedule_slots()

    def _free_slots(self) -> List[int]:
        return [s for s in range(self.num_slots)
                if self._slot_req[s] is None and self._slot_held[s] is None]

    def _release_row(self, row: int) -> None:
        # guarded-by: caller
        """Drop the row's reference on every block of its table (and the
        draft pool's mirror row when speculation is on)."""
        if self._tables[row]:
            self._alloc.release(self._tables[row])
        self._tables[row] = []
        self._row_len[row] = 0
        if self._spec is not None:
            self._draft_release_row(row)

    # -- fused-speculation internals ----------------------------------------

    def _draft_release_row(self, row: int) -> None:
        # guarded-by: caller
        sp = self._spec
        if sp is None or not self._draft_tables:
            return
        if self._draft_tables[row]:
            sp.alloc.release(self._draft_tables[row])
        self._draft_tables[row] = []
        self._draft_len[row] = 0

    def _draft_ensure_range(self, row: int, pos: int, n: int) -> bool:
        # guarded-by: caller
        """Make positions ``pos .. pos+n-1`` writable in the draft row's
        table (append-only: the draft pool has no sharing, so no
        copy-on-write). Returns False on draft-pool exhaustion: the row
        simply doesn't speculate this step (never preempts: the draft
        pool must not disturb target scheduling)."""
        sp = self._spec
        bs = sp.alloc.block_size
        table = self._draft_tables[row]
        for j in range(n):
            lb = (pos + j) // bs
            if lb < len(table):
                continue
            if lb > len(table):
                return False
            try:
                table.append(sp.alloc.alloc(1)[0])
            except BlocksExhausted:
                return False
        return True

    def _draft_tables_device(self, rows=None) -> torch.Tensor:
        # guarded-by: caller
        """Dense draft block-table array for ``rows`` (default every
        row), power-of-two bucketed like :meth:`_tables_device`, on the
        host."""
        tables = [self._draft_tables[r] for r in (
            range(self.num_slots) if rows is None else rows)]
        return self._dense_tables(tables)

    def _spec_observe_depth(self) -> int:
        # guarded-by: caller
        """Feed the controller this step's load signals; returns the
        applied (hysteresis-filtered) ladder depth."""
        sp = self._spec
        active = sum(r is not None for r in self._slot_req)
        occupancy = min(1.0, (active + len(self._queue)) / self.num_slots)
        kv_pressure = self._alloc.used_blocks / self._alloc.num_blocks
        k = sp.controller.observe(
            occupancy=occupancy, kv_pressure=kv_pressure,
            decode_tokens=self._spec_fleet_tokens,
            num_slots=self.num_slots)
        sp.depth_applied = k
        sp.depth_gauge.set(k)
        return k

    def _spec_catch_up(self) -> None:
        # guarded-by: caller
        """Replay already-known tokens into draft rows that fell behind
        the target (fresh prefill, continuation delta, preemption resume,
        rollback, depth-0 stretch), under the step-token budget. One
        draft forward for all lagging rows."""
        sp = self._spec
        bs = sp.alloc.block_size
        budget = self._step_tokens
        entries = []                    # (tok, row, pos, wb, wo)
        advanced = []                   # (row, n)
        for row in range(self.num_slots):
            req = self._slot_req[row]
            if req is None or req.paused or req.rid in self._prefill_jobs:
                continue
            if budget <= 0:
                break
            gap = self._row_len[row] - self._draft_len[row]
            if gap < 0:
                # the target rolled behind the draft outside a spec round
                # (not expected): resync by dropping the draft row
                self._draft_release_row(row)
                gap = self._row_len[row]
            if gap == 0:
                continue
            stream = req.prompt + req.tokens[:-1]
            start = self._draft_len[row]
            n = min(gap, budget)
            if not self._draft_ensure_range(row, start, n):
                continue
            table = self._draft_tables[row]
            for j in range(n):
                p = start + j
                entries.append((stream[p], row, p, table[p // bs], p % bs))
            advanced.append((row, n))
            budget -= n
        if not entries:
            return
        # exact width, no sentinel padding (eager PyTorch does not
        # recompile per batch width)
        cols = list(zip(*entries))
        as_t = lambda xs: torch.tensor(xs, dtype=torch.int64)   # noqa: E731
        self._draft_pool = _draft_feed_step(
            sp.params, sp.config, as_t(cols[0]), self._draft_tables_device(),
            as_t(cols[1]), as_t(cols[2]), as_t(cols[3]), as_t(cols[4]),
            self._draft_pool, self._use_paged_kernel)
        sp.feed_forwards += 1
        for row, n in advanced:
            self._draft_len[row] += n
        self._stats["spec_feed_tokens"] += len(entries)

    def _spec_begin_step(self) -> tuple:
        # guarded-by: caller
        """Pre-step speculation phase: observe load → depth, catch the
        draft cache up, then run the draft proposal loop for every
        speculating row in lockstep, with one device→host copy of the
        proposals. Returns ``(depth, {row: proposals})``, an empty plan
        when speculation is off or the depth is 0."""
        sp = self._spec
        if sp is None:
            return 0, {}
        k = self._spec_observe_depth()
        self._spec_catch_up()
        if k <= 0:
            return 0, {}
        rows = []
        for row in range(self.num_slots):
            req = self._slot_req[row]
            if (req is None or req.paused
                    or req.rid in self._prefill_jobs
                    or not req.tokens):
                continue
            p = self._row_len[row]
            if self._draft_len[row] != p:
                continue        # draft not in lockstep yet
            if p + k > self.max_len or p + 1 >= self.context_bound - 1:
                continue        # would finish this step anyway
            if not self._draft_ensure_range(row, p, k):
                continue        # draft pool pressure: skip, don't block
            rows.append(row)
        if not rows:
            return k, {}
        # only the speculating rows run (the JAX scan runs every row and
        # drops the others' writes)
        props_dev, self._draft_pool = _draft_propose(
            sp.params, sp.config,
            torch.tensor([self._cur_tok_host[r] for r in rows],
                         dtype=torch.int64),
            torch.tensor([self._row_len[r] for r in rows],
                         dtype=torch.int64),
            self._draft_tables_device(rows), self._draft_pool, k,
            self._use_paged_kernel)
        sp.propose_forwards += k
        props = profiled_device_get(props_dev,
                                    fn="engine.spec_propose").numpy()
        plan = {}
        for i, row in enumerate(rows):
            plan[row] = [int(x) for x in props[i]]
            self._draft_len[row] = self._row_len[row] + k
        return k, plan

    def _spec_rollback(self, row: int, new_len: int) -> None:
        # guarded-by: caller
        """Truncate both the target row and its draft mirror to the
        verified prefix: blocks past ``blocks_for(new_len)`` go back to
        their pools (stale entries in the kept partial block sit at
        positions the validity mask never reads and the next write
        overwrites)."""
        keep = self._alloc.blocks_for(new_len)
        table = self._tables[row]
        if len(table) > keep:
            self._alloc.release(table[keep:])
            del table[keep:]
        self._row_len[row] = new_len
        sp = self._spec
        dtable = self._draft_tables[row]
        dkeep = sp.alloc.blocks_for(new_len)
        if len(dtable) > dkeep:
            sp.alloc.release(dtable[dkeep:])
            del dtable[dkeep:]
        self._draft_len[row] = min(self._draft_len[row], new_len)
        self._stats["spec_rollbacks"] += 1

    def _preempt_row(self, row: int) -> None:
        # guarded-by: caller
        """Preemption by recomputation: release the row's blocks and
        requeue its request at the FRONT. Rescheduling re-prefills prompt
        + emitted tokens and resumes decode from the last sampled token."""
        req = self._slot_req[row]
        self._slot_req[row] = None
        req.slot = None
        # the prefix reuse was credited once; a resume re-prefills the
        # whole stream
        req.prefix_id = None
        self._prefill_jobs.pop(req.rid, None)
        self._release_row(row)
        self._queue.appendleft(req)
        self._stats["kv_preemptions"] += 1
        req.preempt_count += 1
        if req.tokens:
            # an uncaptured group donor preempted AFTER emitting resumes
            # through the recompute replay and can never again present a
            # pure-prompt spine: degrade the followers now (a donor
            # preempted mid-prefill redoes its prefill and still captures)
            self._group_degrade_if_uncaptured(req)
        if (req.preempt_count >= self.engine_config.max_preempts
                and req.rid not in self._storm_rids):
            # starvation latch: this request is now non-preemptible
            self._storm_rids.add(req.rid)
            self._stats["kv_preemption_storms"] += 1
            self._storm_total.inc()

    def _prefix_candidates(self) -> List[PrefixCandidate]:
        # guarded-by: caller
        """Resident prefix entries as reclamation candidates (host-tiered
        ones hold no pool blocks)."""
        out = []
        for pid, (tokens, blocks, _last) in self._prefixes.items():
            if blocks is None:
                continue
            consumers = max((self._alloc.refcount(b) - 1 for b in blocks),
                            default=0)
            out.append(PrefixCandidate(
                pid=pid, num_tokens=len(tokens), num_blocks=len(blocks),
                consumers=consumers,
                last_use=self._prefix_last_use.get(pid, 0),
                use_count=self._prefix_use_count.get(pid, 0)))
        return out

    def _evict_or_tier_prefix(self) -> bool:
        # guarded-by: caller
        """Scored prefix reclamation (kv_pressure.pick_victim): host-tier
        a warm or shared victim, evict a cold unshared one."""
        victim = pick_victim(self._prefix_candidates(), self._prefix_use_seq)
        if victim is None:
            return False
        ec = self.engine_config
        if should_tier(victim, host_tier=ec.host_tier,
                       tier_min_uses=ec.tier_min_uses):
            try:
                self._swap_out_prefix(victim.pid)
                return True
            except Exception:
                # a torn swap leaves the prefix fully resident: fall
                # through to plain eviction so reclamation progresses
                pass
        self.release_prefix(victim.pid)
        self._stats["prefix_evictions"] += 1
        self._alloc.count_eviction()
        return True

    def _swapped_blocks_total(self) -> int:
        # guarded-by: caller
        return sum(hp.num_blocks for hp in self._prefix_host.values())

    def _swap_out_prefix(self, pid: int) -> None:
        # guarded-by: caller
        """Tier a resident prefix to host RAM: gather its blocks (new
        tensors, in the pool's storage flavour), copy them into pinned
        host tensors, wait until the copies have LANDED, and only then
        flip the bookkeeping and release the blocks. The next allocation
        may overwrite those blocks at once, so a release before the copy
        completed would tear the host copy; a failure before the flip
        leaves the prefix fully resident."""
        tokens, blocks, last = self._prefixes[pid]
        nblk = len(blocks)
        payload = gather_blocks_quant(self.pool, blocks)
        host = BlockPayload(*(None if a is None else self._to_host(a)
                              for a in payload))
        if self.device.type == "cuda":
            done = torch.cuda.Event()
            done.record()
            done.synchronize()
        prof = get_profiler()
        if prof.enabled:
            prof.account_transfer(
                "engine.swap_out",
                sum(a.nbytes for a in host if a is not None),
                direction="d2h")
        # -- point of no return: host bookkeeping only from here ---------
        self._prefix_host[pid] = HostPrefix(
            k=host.k, v=host.v, num_tokens=len(tokens),
            k_scale=host.k_scale, v_scale=host.v_scale,
            k_hi=host.k_hi, v_hi=host.v_hi)
        self._prefixes[pid] = (tokens, None, last)
        self._alloc.release(blocks)
        self._alloc.count_swap_out(nblk)
        self._alloc.set_swapped_blocks(self._swapped_blocks_total())
        self._stats["prefix_swap_outs"] += 1

    def _to_host(self, a: torch.Tensor) -> torch.Tensor:
        """A host copy of ``a``: pinned and asynchronous from the card
        (the caller waits for it), a plain clone on the CPU."""
        if a.device.type != "cuda":
            return a.clone()
        out = torch.empty(a.shape, dtype=a.dtype, pin_memory=True)
        out.copy_(a, non_blocking=True)
        return out

    def _restore_prefix(self, pid: int) -> bool:
        # guarded-by: caller
        """Swap a host-tiered prefix back into the pool. False when the
        pool cannot grant the blocks even after reclamation: the caller
        degrades to a full prefill and the host copy is KEPT."""
        tokens, _blocks, last = self._prefixes[pid]
        hp = self._prefix_host[pid]
        nblk = hp.num_blocks
        try:
            blocks = self._alloc_blocks_evicting(nblk)
        except BlocksExhausted:
            return False
        try:
            install_blocks_quant(self.pool, BlockPayload(
                k=hp.k, v=hp.v, k_scale=hp.k_scale, v_scale=hp.v_scale,
                k_hi=hp.k_hi, v_hi=hp.v_hi), blocks)
            if self.device.type == "cuda":
                # the host tensors must outlive their copies to the card
                done = torch.cuda.Event()
                done.record()
                done.synchronize()
        except Exception:
            self._alloc.release(blocks)
            raise
        self._prefixes[pid] = (tokens, blocks, last)
        del self._prefix_host[pid]
        self._alloc.count_swap_in(nblk)
        self._alloc.set_swapped_blocks(self._swapped_blocks_total())
        self._stats["prefix_swap_ins"] += 1
        return True

    def _reclaim_blocks(self, row: int, committed,
                        allow_preempt: bool = True) -> bool:
        # guarded-by: caller
        """Free pool capacity, cheapest casualty first: held
        conversations (their next turn re-prefills), then scored prefix
        eviction or tiering, then the youngest other active row still
        under the preemption cap. Returns False when nothing further can
        be reclaimed for ``row``, including after preempting ``row``
        itself or truncate-finishing it."""
        held = [s for s in range(self.num_slots)
                if self._slot_held[s] is not None]
        if held:
            oldest = min(held, key=lambda s: self._slot_hold_seq[s])
            self._drop_hold(oldest)
            self._stats["hold_evictions"] += 1
            return True
        if self._evict_or_tier_prefix():
            return True
        if not allow_preempt:
            return False
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
                # completes short, it is never lost). With a migrating
                # coordinator attached, offer the request for migration
                # FIRST (one preemption frees the blocks, the tokens
                # survive); a second trip here, when no engine took it,
                # truncates as before, so nothing livelocks.
                if (self.migrate_on_pressure
                        and req.rid not in self._migration_offered):
                    self._migration_offered.add(req.rid)
                    self._pressure_migrations.append(req.rid)
                    # paused so the scheduler cannot put it straight back
                    # into the freed row (and cap it again) before the
                    # coordinator decides; it resumes the request when no
                    # engine has room
                    req.paused = True
                    self._preempt_row(row)
                else:
                    self._finish_request(req, row)
            else:
                self._preempt_row(row)
        return False

    def _alloc_blocks_evicting(self, n: int) -> List[int]:
        # guarded-by: caller
        """``n`` blocks for a prefix install, dropping holds and
        reclaiming prefixes (never preempting an active request) until
        the pool can grant them."""
        while True:
            try:
                return self._alloc.alloc(n)
            except BlocksExhausted:
                if not self._reclaim_blocks(-1, frozenset(),
                                            allow_preempt=False):
                    raise

    def _blockify_arr(self, a: torch.Tensor, nblk: int) -> torch.Tensor:
        # guarded-by: caller
        """One-slot ``(L, 1, cap, ...)`` → block layout ``(L, nblk,
        block_size, ...)``, zero-padded past the cache."""
        bs = self._alloc.block_size
        need = nblk * bs
        a = a[:, 0]
        if need > a.shape[1]:
            pad = a.new_zeros((a.shape[0], need - a.shape[1],
                               *a.shape[2:]))
            a = torch.cat([a, pad], dim=1)
        return a[:, :need].reshape(a.shape[0], nblk, bs, *a.shape[2:])

    def _blockify(self, kv: KVCache, nblk: int):
        # guarded-by: caller
        return self._blockify_arr(kv.k, nblk), self._blockify_arr(kv.v, nblk)

    @staticmethod
    def _unblockify_to(a: torch.Tensor, cap: int) -> torch.Tensor:
        """Block layout ``(L, nblk, bs, ...)`` → one-slot ``(L, 1, cap,
        ...)``, zero-padded past the blocks."""
        n_layers, nblk, bs = a.shape[:3]
        a = a.reshape(n_layers, nblk * bs, *a.shape[3:])
        if a.shape[1] < cap:
            a = torch.cat([a, a.new_zeros((n_layers, cap - a.shape[1],
                                           *a.shape[2:]))], dim=1)
        return a[:, None, :cap]

    def _export_blocks(self, tokens: List[int],
                       blocks: List[int]) -> KVCache:
        # guarded-by: caller
        """A prefix's blocks as the one-slot buffer exports speak. A
        uniformly quantized pool exports the quantized flavour (payload +
        scales); a mixed ladder dequantizes to the model dtype."""
        cap = self.max_len
        length = torch.full((1,), len(tokens), dtype=torch.int32,
                            device=self.device)
        pool = self.pool
        if pool.quantized and pool.hi_layers == 0:
            p = gather_blocks_quant(pool, blocks)
            return KVCache(k=self._unblockify_to(p.k, cap),
                           v=self._unblockify_to(p.v, cap),
                           k_scale=self._unblockify_to(p.k_scale, cap),
                           v_scale=self._unblockify_to(p.v_scale, cap),
                           length=length)
        k, v = gather_blocks(pool, blocks, dtype=self.config.dtype)
        return KVCache(k=self._unblockify_to(k[:, None], cap),
                       v=self._unblockify_to(v[:, None], cap),
                       length=length)

    def _export_host(self, pid: int) -> KVCache:
        # guarded-by: caller
        """The export buffer built from a host-tiered prefix on the host
        (no device traffic); same flavour rule as :meth:`_export_blocks`."""
        hp = self._prefix_host[pid]
        cap = self.max_len
        length = torch.full((1,), hp.num_tokens, dtype=torch.int32)
        if hp.k_scale is not None and hp.k_hi is None:
            return KVCache(k=self._unblockify_to(hp.k, cap),
                           v=self._unblockify_to(hp.v, cap),
                           k_scale=self._unblockify_to(hp.k_scale, cap),
                           v_scale=self._unblockify_to(hp.v_scale, cap),
                           length=length)
        dtype = self.config.dtype

        def full(q, scale, hi):
            x = q.to(dtype) if scale is None else dequantize_pool_kv(
                q, scale, dtype)
            if hi is not None:
                x = torch.cat([hi.to(dtype), x], dim=0)
            return self._unblockify_to(x, cap)

        return KVCache(k=full(hp.k, hp.k_scale, hp.k_hi),
                       v=full(hp.v, hp.v_scale, hp.v_hi), length=length)

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
        return self._dense_tables(self._tables)

    def _dense_tables(self, tables: List[List[int]]) -> torch.Tensor:
        """``tables`` as one zero-padded host int32 array whose width is
        the widest table rounded up to a power of two (at most a row's
        blocks)."""
        widest = max((len(t) for t in tables), default=0)
        mb = 1
        while mb < widest:
            mb *= 2
        mb = min(self._blocks_per_row, mb)
        arr = torch.zeros((len(tables), mb), dtype=torch.int32)
        for s, tbl in enumerate(tables):
            if tbl:
                arr[s, :len(tbl)] = torch.tensor(tbl, dtype=torch.int32)
        return arr

    # -- scheduling and the fused step ---------------------------------------

    def _schedule_paged(self) -> None:
        # guarded-by: caller
        """Assign queued requests to free rows and turn their prompts into
        chunked-prefill jobs. No device work happens here apart from a
        host-tier restore: prefix installs are table grafts. Paused
        (migration-frozen) requests are lifted out of the queue for the
        duration and put back at the front: they keep their place but
        cannot be scheduled."""
        paused = None
        if any(r.paused for r in self._queue):
            paused = [r for r in self._queue if r.paused]
            self._queue = deque(r for r in self._queue if not r.paused)
        try:
            self._schedule_paged_queue()
        finally:
            if paused:
                self._queue.extendleft(reversed(paused))

    def _schedule_paged_queue(self) -> None:
        # guarded-by: caller
        self._evict_oldest_hold_if_stuck()
        while self._queue:
            free = self._free_slots()
            if not free:
                return
            req = self._queue.popleft()
            self._take_prefix_or_miss(req)
            self._schedule_paged_row(req, free[0])

    def _schedule_paged_row(self, req: _Request, row: int) -> None:
        # guarded-by: caller
        req.slot = row
        self._slot_req[row] = req
        g = req.group
        if (g is not None and g.spine is not None and not g.degraded
                and req.rid != g.donor_rid and not req.tokens):
            self._graft_group_spine(req, row, g)
            return
        self._stats["prefills"] += 1
        if req.adapter_binding is not None and req.prefix_id is not None:
            # Shared prefixes are BASE-policy KV: any adapter target
            # perturbs the residual stream and so every later layer's
            # k/v, and grafting a base prefix under an adapter would
            # silently mix policies. Adapter rows take the full prefill.
            req.prefix_id = None
            self._stats["prefix_cache_misses"] += 1
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
        if req.prefix_id is not None and self._graft_prefix(req, row):
            return
        self._stats["prefill_tokens"] += len(req.prompt)
        self._prefill_jobs[req.rid] = _PrefillJob(
            toks=list(req.prompt), pos=0, sample_last=True)

    def _graft_group_spine(self, req: _Request, row: int,
                           g: _GroupShare) -> None:
        # guarded-by: caller
        """Group-shared rollout: graft the donor's pure-prompt spine
        (refcount bump, zero KV bytes moved) and rescore ONLY the last
        prompt token with its write DROPPED: its k/v is resident, and
        these are the logits the donor sampled its first token from, so
        greedy decode equals an unshared prefill. The follower's first
        real write copies the shared boundary block."""
        self._tables[row] = self._alloc.fork(g.spine)
        self._row_len[row] = g.spine_len
        self._stats["group_forks"] += 1
        self._stats["group_prefill_tokens_avoided"] += g.spine_len - 1
        self._stats["prefill_tokens"] += 1
        self._prefill_jobs[req.rid] = _PrefillJob(
            toks=[req.prompt[-1]], pos=g.spine_len - 1, sample_last=True,
            drop_writes=True)
        if not req.group_grafted:
            # a preempted-then-rescheduled follower re-grafts but must not
            # count down twice
            req.group_grafted = True
            g.pending -= 1
            if g.pending <= 0 and g.spine is not None:
                # last follower grafted: drop the engine's retained fork;
                # the followers' own forks keep the blocks alive
                self._alloc.release(g.spine)
                g.spine = None
                self._groups.pop(g.gid, None)

    def _graft_prefix(self, req: _Request, row: int) -> bool:
        # guarded-by: caller
        """Install ``req``'s prefix into ``row`` by graft: a refcount bump
        on the prefix's blocks, zero KV bytes moved. The first write into
        a shared boundary block copies it (``_ensure_block``). A
        host-tiered prefix is restored first; False (a full prefill
        follows) when the pool cannot take it back."""
        pid = req.prefix_id
        if self._prefixes[pid][1] is None and not self._restore_prefix(pid):
            req.prefix_id = None
            self._stats["prefix_cache_misses"] += 1
            return False
        p_tokens, p_blocks, p_last = self._prefixes[pid]
        self._touch_prefix(pid)
        self._tables[row] = self._alloc.fork(p_blocks)
        self._row_len[row] = len(p_tokens)
        self._stats["prefix_installs"] += 1
        self._stats["prefix_cache_hits"] += 1
        self._stats["prefix_tokens_reused"] += len(p_tokens)
        suffix = req.prompt[len(p_tokens):]
        self._stats["prefill_tokens"] += len(suffix)
        if suffix:
            self._prefill_jobs[req.rid] = _PrefillJob(
                toks=list(suffix), pos=len(p_tokens), sample_last=True)
        elif p_last is not None:
            self._emit_first_token(req, row, p_last)
        else:
            # an imported prefix without logits: rescore its last token
            # in place with writes DROPPED (the k/v is resident; a write
            # would copy the shared boundary block for nothing)
            self._stats["prefill_tokens"] += 1
            self._prefill_jobs[req.rid] = _PrefillJob(
                toks=[req.prompt[-1]], pos=len(p_tokens) - 1,
                sample_last=True, drop_writes=True)
        return True

    def _assemble_paged_plan(self, spec_plan=None):
        # guarded-by: caller
        """Build the flat token batch for one fused step: one decode entry
        per active row, or a verify window for rows with draft proposals
        (``spec_plan``), then exact-size chunked-prefill segments
        round-robined in row order under the remaining token budget.
        Returns None when there is nothing to run. No padding entries are
        added (eager PyTorch does not recompile per batch width), so the
        JAX engine's padded-width ladder (``num_slots * depth`` with
        speculation, ``step_tokens`` with prefill) has no counterpart."""
        nb = self._alloc.num_blocks
        bs = self._alloc.block_size
        toks_l: List[int] = []
        rows_l: List[int] = []
        pos_l: List[int] = []
        wb_l: List[int] = []
        wo_l: List[int] = []
        decode_rows = []           # (entry_idx, row, req)
        spec_rows = []             # (entry_idx, row, req, proposals, start)
        job_rows = []              # (row, req, job, n, last_idx, wrote)
        committed: set = set()
        for row in range(self.num_slots):
            req = self._slot_req[row]
            if req is None or req.paused or req.rid in self._prefill_jobs:
                continue
            p = self._row_len[row]
            props = spec_plan.get(row) if spec_plan else None
            if props:
                # verify window: [pending] + proposals[:-1]; entry i's
                # logits are the target's argmax judging proposal i
                feed = [self._cur_tok_host[row]] + list(props[:-1])
                staged = []
                try:
                    for j, ftok in enumerate(feed):
                        wb = self._ensure_block(row, p + j, committed)
                        staged.append((ftok, p + j, wb, (p + j) % bs))
                except _RowPreempted:
                    continue
                spec_rows.append((len(toks_l), row, req, list(props), p))
                for ftok, fp, wb, wo in staged:
                    toks_l.append(ftok)
                    rows_l.append(row)
                    pos_l.append(fp)
                    wb_l.append(wb)
                    wo_l.append(wo)
                committed.add(row)
                continue
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
            if req is None or req.paused or budget <= 0:
                continue
            job = self._prefill_jobs.get(req.rid)
            if job is None:
                continue
            n = min(len(job.toks), budget)
            staged = []
            try:
                for j in range(n):
                    p = job.pos + j
                    if job.drop_writes:
                        wb, wo = nb, 0
                    else:
                        wb = self._ensure_block(row, p, committed)
                        wo = p % bs
                    staged.append((job.toks[j], p, wb, wo))
            except _RowPreempted:
                continue
            base = len(toks_l)
            for tok, p, wb, wo in staged:
                toks_l.append(tok)
                rows_l.append(row)
                pos_l.append(p)
                wb_l.append(wb)
                wo_l.append(wo)
            job_rows.append((row, req, job, n, base + n - 1,
                             0 if job.drop_writes else n))
            committed.add(row)
            budget -= n
        if not toks_l:
            return None
        if len(job_rows) >= 2:
            # several requests' prefill segments shared one forward
            self._stats["batched_prefills"] += 1
            self._stats["batched_prefill_slots"] += len(job_rows)
        return (toks_l, rows_l, pos_l, wb_l, wo_l, decode_rows, spec_rows,
                job_rows)

    def _pad_moe_batch(self, toks_l, rows_l, pos_l, wb_l, wo_l,
                       depth: int, spec: bool, prefill: bool) -> None:
        # guarded-by: caller
        """Pad an MoE model's flat batch IN PLACE to the JAX engine's
        width ladder: ``num_slots``, ``step_tokens`` with a prefill
        segment, ``num_slots * depth`` with verify windows. An MoE layer's
        capacity counts every entry and earlier entries win its slots, so
        the streams equal the JAX engine's only at the same width. The
        padding entries (token 0 of row 0 at position 0) write nothing and
        come last, so they change the capacity and nothing else."""
        if spec:
            t = self.num_slots * max(1, depth)
            if prefill:
                t = max(t, self._step_tokens)
        else:
            t = self._step_tokens if prefill else self.num_slots
        nb = self._alloc.num_blocks
        for _ in range(t - len(toks_l)):
            toks_l.append(0)
            rows_l.append(0)
            pos_l.append(0)
            wb_l.append(nb)
            wo_l.append(0)

    def _fused_step(self, toks_l, rows_l, pos_l, wb_l, wo_l):
        # guarded-by: caller
        """The fused step over the flat batch; returns host (tokens,
        log-probs) lists from ONE device→host copy."""
        as_t = lambda xs: torch.tensor(xs, dtype=torch.int64)   # noqa: E731
        adapters = adapter_ids = None
        if self.adapter_pool is not None:
            # Per-rung slot ids beside the token batch: each entry takes
            # its request's bound slot (the null slot 0 for base rows).
            # Built on every step, prefill, decode and verify entries
            # alike; the banks' shapes never change.
            aid = [[0] * len(toks_l)
                   for _ in range(self.adapter_pool.num_rungs)]
            for i, row in enumerate(rows_l):
                req = self._slot_req[row]
                b = req.adapter_binding if req is not None else None
                if b is not None:
                    for j, s in enumerate(b.slot_ids):
                        aid[j][i] = s
            adapters = self.adapter_pool.banks()
            adapter_ids = tuple(as_t(g) for g in aid)
        next_tok, logp, self.pool = _paged_fused_step(
            self.params, self.config, as_t(toks_l), self._tables_device(),
            as_t(rows_l), as_t(pos_l), as_t(wb_l), as_t(wo_l), self.pool,
            self._gen, self.sample, self._use_paged_kernel,
            adapters=adapters, adapter_ids=adapter_ids)
        # token ids (< 2**24) and f32 log-probs are both exact in f64
        host = profiled_device_get(
            torch.stack([next_tok.double(), logp.double()]),
            fn="engine.fused_step").numpy()
        return [int(x) for x in host[0]], [float(x) for x in host[1]]

    def _step_paged(self) -> Dict[int, List[int]]:
        # guarded-by: caller
        self._schedule_paged()
        # first tokens sampled at scheduling (a zero-suffix prefix graft)
        emitted = self._pending_emits
        self._pending_emits = {}
        depth, spec_plan = self._spec_begin_step()
        plan = self._assemble_paged_plan(spec_plan)
        if plan is None:
            return emitted
        (toks_l, rows_l, pos_l, wb_l, wo_l, decode_rows, spec_rows,
         job_rows) = plan
        if self.config.num_experts > 0:
            self._pad_moe_batch(toks_l, rows_l, pos_l, wb_l, wo_l, depth,
                                bool(spec_rows), bool(job_rows))
        tracer = get_tracer()
        n_active = len(decode_rows) + len(spec_rows) + len(job_rows)
        with tracer.span("engine.decode_step", active=n_active):
            toks, logps = self._fused_step(toks_l, rows_l, pos_l, wb_l,
                                           wo_l)
            self._stats["decode_steps"] += 1
        n_emitted = 0
        for idx, row, req in decode_rows:
            tok = toks[idx]
            req.tokens.append(tok)
            req.logps.append(logps[idx])
            self._stats["tokens_emitted"] += 1
            n_emitted += 1
            emitted.setdefault(req.rid, []).append(tok)
            self._row_len[row] += 1
            self._cur_tok_host[row] = tok
            hit_eos = req.eos_id is not None and tok == req.eos_id
            out_of_budget = len(req.tokens) >= req.max_new_tokens
            out_of_cache = self._row_len[row] >= self.context_bound - 1
            if hit_eos or out_of_budget or out_of_cache:
                self._finish_request(req, row)
        n_emitted += self._accept_spec_rows(spec_rows, toks, logps, emitted)
        for row, req, job, n, last_idx, wrote in job_rows:
            self._row_len[row] += wrote
            job.toks = job.toks[n:]
            job.pos += n
            if job.toks:
                continue
            self._prefill_jobs.pop(req.rid, None)
            g = req.group
            if (g is not None and req.rid == g.donor_rid
                    and g.spine is None and not g.degraded
                    and job.sample_last and not req.tokens):
                # The donor's prefill just completed and its first sampled
                # token is NOT written yet (tokens are fed the step after
                # sampling): the table is the pure prompt spine. Capture an
                # engine-retained fork (released when the last follower
                # grafts) and wake the waiters; the donor's own next write
                # copies the boundary block.
                g.spine = self._alloc.fork(self._tables[row])
                g.spine_len = self._row_len[row]
                self._stats["group_prefills"] += 1
                for w in g.waiters:
                    if not w.done:
                        self._queue.append(w)
                g.waiters = []
            if job.sample_last:
                tok = toks[last_idx]
                req.tokens.append(tok)
                req.logps.append(logps[last_idx])
                self._stats["tokens_emitted"] += 1
                n_emitted += 1
                emitted.setdefault(req.rid, []).append(tok)
                self._cur_tok_host[row] = tok
                if ((req.eos_id is not None and tok == req.eos_id)
                        or req.max_new_tokens <= 1):
                    self._finish_request(req, row)
            else:
                self._cur_tok_host[row] = job.after_tok
        if tracer.enabled:
            self._count_step(n_emitted)
        used_tokens = sum(self._row_len[s] for s in range(self.num_slots)
                          if self._tables[s])
        used_tokens += sum(len(p_tokens) for p_tokens, p_blocks, _
                           in self._prefixes.values() if p_blocks is not None)
        self._alloc.publish_fragmentation(used_tokens)
        self._schedule_paged()
        return emitted

    def _accept_spec_rows(self, spec_rows, toks, logps, emitted) -> int:
        # guarded-by: caller
        """Greedy acceptance of every verify window: walk it until the
        target's argmax disagrees with the proposal (the disagreeing
        argmax IS the correction, so every round emits at least one token
        and the output equals non-speculative greedy decode), record the
        outcome for the distiller, roll both caches back to the emitted
        stream and fold the round's acceptance into the EMA. Returns the
        tokens emitted."""
        sp = self._spec
        n_emitted = total_proposed = total_accepted = 0
        for base, row, req, props, start in spec_rows:
            k = len(props)
            window = []
            for i in range(k):
                tok = toks[base + i]
                window.append((tok, logps[base + i]))
                if tok != props[i]:
                    break
            accepted = sum(1 for (tok, _), pr in zip(window, props)
                           if tok == pr)
            total_proposed += k
            total_accepted += accepted
            self._stats["spec_rounds"] += 1
            self._stats["spec_proposed"] += k
            self._stats["spec_accepted"] += accepted
            self._stats["spec_wasted"] += k - accepted
            sp.wasted_total.inc(k - accepted)
            # distillation harvest: the target-chosen continuation of the
            # pre-round stream (accepted run + the correction)
            stream_before = req.prompt + req.tokens
            sp.outcomes.append({
                "context": stream_before[-sp.ctx_window:],
                "targets": [tok for tok, _ in window],
                "accepted": accepted,
                "proposed": k,
            })
            finish = False
            emitted_row = 0
            for tok, lp in window:
                req.tokens.append(tok)
                req.logps.append(lp)
                self._stats["tokens_emitted"] += 1
                n_emitted += 1
                emitted.setdefault(req.rid, []).append(tok)
                emitted_row += 1
                hit_eos = req.eos_id is not None and tok == req.eos_id
                out_of_budget = len(req.tokens) >= req.max_new_tokens
                out_of_cache = start + emitted_row >= self.context_bound - 1
                if hit_eos or out_of_budget or out_of_cache:
                    finish = True
                    break
            self._cur_tok_host[row] = req.tokens[-1]
            # roll BOTH caches back to the verified prefix: the fed window
            # is exactly the emitted stream, so the new length is start +
            # tokens actually emitted
            self._spec_rollback(row, start + emitted_row)
            if finish:
                self._finish_request(req, row)
        if total_proposed:
            rate = total_accepted / total_proposed
            sp.ema = (rate if not sp.ema_init
                      else 0.9 * sp.ema + 0.1 * rate)
            sp.ema_init = True
            sp.accept_gauge.set(sp.ema)
        return n_emitted

    @staticmethod
    def _count_step(n_emitted: int) -> None:
        reg = get_registry()
        reg.counter("senweaver_engine_decode_steps_total",
                    "Pool decode steps executed.").inc()
        reg.counter("senweaver_engine_tokens_total",
                    "Tokens emitted by the rollout engine.").inc(n_emitted)

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
        tracer = get_tracer()
        with tracer.span("engine.decode_step", active=sum(active_list)):
            active = torch.tensor(active_list, device=self.device)
            next_tok, logp, self.cache = _pool_decode_step(
                self.params, self.config, self.cur_tok, active, self.cache,
                self._gen, self.sample, mesh=self.mesh)
            self.cur_tok = next_tok
            self._stats["decode_steps"] += 1
            # ONE device→host copy for tokens, log-probs and lengths
            # (token ids < 2**24, f32 log-probs and int32 lengths are exact
            # in f64)
            host = profiled_device_get(
                torch.stack([next_tok.double(), logp.double(),
                             self.cache.length.double()]),
                fn="engine.decode_step").numpy()
        if tracer.enabled:
            self._count_step(sum(active_list))
        toks = [int(x) for x in host[0]]
        logps = [float(x) for x in host[1]]
        lengths = [float(x) for x in host[2]]
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
        requests; prefix installs take the single-slot path."""
        self._evict_oldest_hold_if_stuck()
        while self._queue:
            free = self._free_slots()
            if not free:
                return
            req = self._queue[0]
            self._take_prefix_or_miss(req)
            if req.prefix_id is not None or (
                    self._ring and len(req.prompt) >= self.max_len):
                self._queue.popleft()
                self._schedule_single(req, free[0])
                continue
            bucket = min(_bucket(len(req.prompt)), self.max_len)
            group = [req]
            for r in list(self._queue)[1:len(free)]:
                if (r.prefix_id is None
                        and not (self._ring and len(r.prompt) >= self.max_len)
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
                fresh=(fresh_first and i == 0), mesh=self.mesh)
            pos += size
        return last_logits

    def _schedule_single(self, req: _Request, slot: int) -> None:
        # guarded-by: caller
        with get_tracer().span("engine.prefill", slot=slot,
                               tokens=len(req.prompt),
                               prefix=req.prefix_id is not None):
            self._schedule_single_impl(req, slot)

    def _schedule_single_impl(self, req: _Request, slot: int) -> None:
        # guarded-by: caller
        req.slot = slot
        self._slot_req[slot] = req
        true_len = len(req.prompt)
        self._stats["prefills"] += 1
        if req.prefix_id is not None:
            # shared prefix: copy its one-slot cache into the slot, then
            # prefill only the suffix in exact-size chunks
            p_tokens, p_cache, p_last = self._prefixes[req.prefix_id]
            self._touch_prefix(req.prefix_id)
            self.cache = _install_prefix(self.cache, p_cache, slot)
            self._stats["prefix_installs"] += 1
            self._stats["prefix_cache_hits"] += 1
            self._stats["prefix_tokens_reused"] += len(p_tokens)
            suffix = req.prompt[len(p_tokens):]
            self._stats["prefill_tokens"] += len(suffix)
            if suffix:
                last_logits = self._prefill_chunks(slot, suffix,
                                                   fresh_first=False)
            elif p_last is not None:
                last_logits = p_last
            else:
                # imported prefix without logits: re-feed the last prefix
                # token at its own position (the rewritten k/v is the same)
                self.cache = _writeback_slot(self.cache, slot, true_len - 1)
                last_logits = self._prefill_chunks(
                    slot, [req.prompt[-1]], fresh_first=False)
                self._stats["prefill_tokens"] += 1
            self._emit_first_token(req, slot, last_logits)
            return
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
                self.cache, slot, mesh=self.mesh)
        self._emit_first_token(req, slot, last_logits)

    def _schedule_batch(self, group: List[_Request], slots: List[int],
                        bucket: int) -> None:
        # guarded-by: caller
        """One batched forward prefills the whole group (no row padding:
        eager PyTorch does not recompile per batch size)."""
        with get_tracer().span("engine.prefill_batch", slots=len(group),
                               bucket=bucket):
            self._schedule_batch_impl(group, slots, bucket)

    def _schedule_batch_impl(self, group: List[_Request], slots: List[int],
                             bucket: int) -> None:
        # guarded-by: caller
        rows, lens, slot_ids = [], [], list(slots[:len(group)])
        for req, slot in zip(group, slots):
            req.slot = slot
            self._slot_req[slot] = req
            rows.append(req.prompt + [0] * (bucket - len(req.prompt)))
            lens.append(len(req.prompt))
            self._stats["prefills"] += 1
            self._stats["prefill_tokens"] += len(req.prompt)
        if self.config.num_experts > 0:
            # An MoE layer's capacity counts every row of the batch, so
            # the group routes like the JAX engine's only at its width: a
            # power of two, padded by repeating row 0 (same slot, same
            # data: a benign duplicate write)
            n_pad = 1 << (len(group) - 1).bit_length()
            for _ in range(n_pad - len(group)):
                rows.append(rows[0])
                lens.append(lens[0])
                slot_ids.append(slot_ids[0])
        dev = self.device
        last, self.cache = _prefill_slots_batched(
            self.params, self.config,
            torch.tensor(rows, dtype=torch.long, device=dev),
            torch.tensor(lens, dtype=torch.int32, device=dev), self.cache,
            torch.tensor(slot_ids, dtype=torch.long, device=dev),
            mesh=self.mesh)
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
        tok0, logp0 = self._decide(tok0, sampled_logprob(last_logits, tok0))
        host = torch.stack([tok0.double(), logp0.double()]).cpu().tolist()
        tok0_i = int(host[0])
        req.tokens.append(tok0_i)
        req.logps.append(host[1])
        self._stats["tokens_emitted"] += 1
        self._pending_emits.setdefault(req.rid, []).append(tok0_i)
        if self.kv_layout == "paged":
            self._cur_tok_host[slot] = tok0_i
        else:
            self.cur_tok[slot] = tok0_i
        if ((req.eos_id is not None and tok0_i == req.eos_id)
                or req.max_new_tokens <= 1):
            self._finish_request(req, slot)
