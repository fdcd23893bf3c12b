"""Live migration of in-flight decodes, the rollout half (PyTorch port).

An in-flight decode can MOVE: checkpoint its block table and sampler
state here, install it on another engine, resume token-exactly there.
:class:`DecodeCheckpoint` is the portable unit, everything a peer engine
needs to continue the decode:

- the request's host state (prompt, emitted tokens, behaviour log-probs,
  budget and eos, preemption accounting);
- the KV block contents gathered to the host in the blockified layout
  and the storage flavour of the source pool (a quantized ladder ships
  int8/fp8 bytes plus scales, format v2), so restore is one install;
- the engine's generator state and sampler params (restore refuses a
  sampler mismatch: a migrated greedy decode must stay greedy);
- the adapter binding as ``(tenant id, adapter version)``: restore
  re-acquires on the target and REFUSES if the tenant's current version
  moved (a cross-version splice would silently mix policies);
- the ``(epoch, version)`` weight fence a serving layer stamps, so a
  publish landing between snapshot and restore is detected before any KV
  is spliced across policies.

On the wire every payload is a numpy array. numpy has no bfloat16 or
float8 type, so 2- and 1-byte float payloads travel as their raw bits
(``uint16`` / ``uint8``), with ``kv_dtype`` and the target pool's dtype
naming the flavour; restore also takes a float array of the pool's own
dtype name (a checkpoint made by the JAX package carries ``ml_dtypes``
arrays) and reinterprets the bits. fp32, fp16 and int8 payloads and the
f32 scales cross as they are.

Speculative draft state is deliberately DROPPED: the target's draft pool
resyncs through the engine's catch-up replay, which re-feeds ``prompt +
tokens[:-1]``.

Two restore paths, both token-exact:

- **fast path**: a free row and a matching block layout: allocate blocks
  (evicting holds and prefixes, never preempting), install the payload
  into them IN PLACE (the JAX version reassigns a new pool), and flip the
  row's bookkeeping to resume decode from the checkpointed cursor;
- **recompute path**: anything else (no KV payload, no free row, pool
  exhausted, another block size or ladder): requeue at the FRONT; the
  scheduler's preemption-resume replay re-prefills ``prompt +
  tokens[:-1]`` and decodes from ``tokens[-1]``, emitting nothing twice.

Every function here takes the engine with its lock already held, through
the ``RolloutEngine.checkpoint_request`` / ``restore_request`` /
``release_request`` / ``pause_request`` / ``resume_request`` wrappers.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..obs.runtime_profile import profiled_device_get
from .paged_kv import (BlockPayload, BlocksExhausted, gather_blocks_quant,
                       install_blocks_quant)

# Bump when the checkpoint schema changes; restore refuses a foreign
# format instead of guessing. v2 added the quantized-KV ladder fields
# (kv_dtype, hi_layers, scale and full-width-prefix payloads); v1
# checkpoints still decode, their defaults meaning "full-width payload".
CHECKPOINT_FORMAT = 2
_ACCEPTED_FORMATS = (1, 2)

# payload fields that hold arrays (the rest are scalars and lists)
_ARRAY_FIELDS = ("rng_key", "kv_k", "kv_v", "kv_k_scale", "kv_v_scale",
                 "kv_k_hi", "kv_v_hi")

# torch dtypes numpy cannot hold, carried as raw bits of the same width
_RAW_BITS = {torch.bfloat16: (np.uint16, torch.int16),
             torch.float8_e4m3fn: (np.uint8, torch.uint8)}


class MigrationError(RuntimeError):
    """A checkpoint or restore was refused: unknown or finished rid, a
    non-paged layout, a sampler or model mismatch, a moved adapter
    version, or a foreign checkpoint format. The coordinator responds by
    resuming the request where it already lives (never lost)."""


@dataclasses.dataclass
class DecodeCheckpoint:
    """Portable, versioned snapshot of one in-flight decode."""

    format_version: int
    rid: int
    prompt: List[int]
    tokens: List[int]
    logps: List[float]
    max_new_tokens: int
    eos_id: Optional[int]
    preempt_count: int
    # engine-wide sampler params at snapshot time; restore validates
    # equality (token-exactness is meaningless across samplers)
    temperature: float
    top_k: int
    top_p: float
    # the source engine's generator state (torch.Generator.get_state()
    # as a uint8 array); carried for completeness, greedy decode (the
    # token-exact contract) never consults it
    rng_key: Optional[np.ndarray] = None
    # multi-tenant LoRA binding: restore re-acquires and refuses a
    # version drift (no cross-version adapter splice)
    adapter_id: Optional[str] = None
    adapter_version: Optional[int] = None
    # (epoch, version) weight fence, stamped by the serving layer at
    # snapshot
    weight_epoch: int = 0
    weight_version: int = 0
    # serving-layer deadline accounting rides along untouched
    deadline: Optional[float] = None
    # KV payload: positions 0..kv_len-1 of the row, blockified
    # (L, nblk, block_size, Hkv, Dh) host arrays; None when the request
    # was queued or mid-prefill (restore recomputes instead)
    kv_len: int = 0
    block_size: int = 0
    kv_k: Optional[np.ndarray] = None
    kv_v: Optional[np.ndarray] = None
    # Quantized-KV ladder (format v2): the payload is in the SOURCE
    # pool's flavour. ``kv_dtype`` names the rung, ``hi_layers`` how many
    # early layers ride full width, the scale planes are (Lq, nblk,
    # block_size, Hkv) f32. A target on another ladder recomputes.
    kv_dtype: str = "bf16"
    hi_layers: int = 0
    kv_k_scale: Optional[np.ndarray] = None
    kv_v_scale: Optional[np.ndarray] = None
    kv_k_hi: Optional[np.ndarray] = None
    kv_v_hi: Optional[np.ndarray] = None

    def with_fence(self, *, epoch: int, version: int,
                   deadline: Optional[float] = None) -> "DecodeCheckpoint":
        """Serving-layer stamp: the weight fence (and optionally the
        request deadline) recorded against the SOURCE at snapshot
        time."""
        return dataclasses.replace(self, weight_epoch=int(epoch),
                                   weight_version=int(version),
                                   deadline=deadline)

    def to_wire(self) -> Dict[str, Any]:
        """Plain dict for an rpc codec; ``from_wire`` round-trips it. The
        arrays are the checkpoint's own (no deep copy)."""
        out = {f.name: getattr(self, f.name)
               for f in dataclasses.fields(self)
               if f.name not in _ARRAY_FIELDS}
        out["prompt"] = list(self.prompt)
        out["tokens"] = list(self.tokens)
        out["logps"] = list(self.logps)
        for name in _ARRAY_FIELDS:
            out[name] = getattr(self, name)
        return out

    @classmethod
    def from_wire(cls, wire: Dict[str, Any]) -> "DecodeCheckpoint":
        if not isinstance(wire, dict):
            raise MigrationError(
                f"checkpoint wire payload is {type(wire).__name__}, "
                "not a dict")
        fmt = wire.get("format_version")
        if fmt not in _ACCEPTED_FORMATS:
            raise MigrationError(
                f"checkpoint format {fmt!r} not in supported "
                f"{_ACCEPTED_FORMATS}; refusing to guess")
        names = {f.name for f in dataclasses.fields(cls)}
        unknown = set(wire) - names
        if unknown:
            raise MigrationError(
                f"checkpoint carries unknown fields {sorted(unknown)}")
        kw = dict(wire)
        kw["prompt"] = [int(t) for t in kw["prompt"]]
        kw["tokens"] = [int(t) for t in kw["tokens"]]
        kw["logps"] = [float(x) for x in kw["logps"]]
        return cls(**kw)


def _wire_array(t: Optional[torch.Tensor]) -> Optional[np.ndarray]:
    """A host tensor as its wire array: raw bits for bf16 / fp8."""
    if t is None:
        return None
    bits = _RAW_BITS.get(t.dtype)
    if bits is None:
        return t.numpy()
    return t.view(bits[1]).numpy().view(bits[0])


def _pool_tensor(a, dtype: torch.dtype, what: str) -> torch.Tensor:
    """A wire array as a host tensor of the pool's ``dtype``: raw bits,
    or a float array whose dtype has the pool dtype's name, reinterpreted
    by view; arrays of numpy's own dtypes must match exactly. A tensor
    (the wire codec decodes a bfloat16 or float8 frame to one) must have
    the pool's dtype."""
    if isinstance(a, torch.Tensor):
        if a.dtype != dtype:
            raise MigrationError(
                f"checkpoint {what} dtype {a.dtype} != target pool dtype "
                f"{dtype}")
        return a.contiguous()
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:
        a = a.copy()            # torch tensors cannot wrap read-only arrays
    bits = _RAW_BITS.get(dtype)
    if bits is not None:
        name = str(dtype).split(".")[-1]
        if a.dtype.itemsize != np.dtype(bits[0]).itemsize or not (
                a.dtype.kind in "ui" or a.dtype.name == name):
            raise MigrationError(
                f"checkpoint {what} dtype {a.dtype} != target pool dtype "
                f"{dtype} (raw {np.dtype(bits[0])} bits or {name})")
        raw = a.view(np.dtype(bits[0]))
        return torch.from_numpy(raw.view(
            np.int16 if bits[0] is np.uint16 else np.uint8)).view(dtype)
    want = torch.empty((), dtype=dtype).numpy().dtype
    if a.dtype != want:
        raise MigrationError(
            f"checkpoint {what} dtype {a.dtype} != target pool dtype "
            f"{dtype}")
    return torch.from_numpy(a)


def checkpoint_from_engine(engine, rid: int, *,
                           pause: bool = True) -> DecodeCheckpoint:
    """Snapshot one in-flight request (engine lock held by the caller).

    Non-destructive: the source keeps the request (paused when ``pause``)
    until the coordinator releases or resumes it, the retain-until-ack
    half of an exactly-once handoff. An actively decoding row has its KV
    gathered to the host (one batched device→host transfer, under the
    profiler name ``engine.migrate_out``); a queued or mid-prefill
    request snapshots host state only and restores by recomputation."""
    if engine.kv_layout != "paged":
        raise MigrationError(
            "live migration needs the paged KV layout (engine fell "
            f"back to slots: {engine.kv_layout_fallback})")
    req = engine._requests.get(rid)
    if req is None:
        raise MigrationError(f"unknown rid {rid}")
    if req.done:
        raise MigrationError(f"rid {rid} already finished")
    if req.hold_slot:
        raise MigrationError(
            f"rid {rid} holds its slot for a continuation; held KV "
            "is bound to this engine and cannot migrate")
    if pause:
        req.paused = True
    row = req.slot
    kv_rows = (row is not None and rid not in engine._prefill_jobs
               and bool(req.tokens) and bool(engine._tables[row]))
    bs = engine._alloc.block_size
    kv_len = 0
    host = BlockPayload(None, None)
    if kv_rows:
        # Gather ONLY the blocks covering live positions. The gather
        # makes new tensors, so a row whose table shares forked blocks
        # (group follower, tree branch) checkpoints an UNSHARED copy:
        # restoring it elsewhere can never see a sibling's later
        # copy-on-write writes. The source row's refcounts are untouched
        # until the coordinator's release.
        kv_len = engine._row_len[row]
        nblk = min(len(engine._tables[row]),
                   engine._alloc.blocks_for(kv_len))
        blocks = engine._tables[row][:nblk]
        # blockified and still in the pool's storage flavour: a quantized
        # ladder ships int8/fp8 bytes + scales (half the transfer)
        host = profiled_device_get(gather_blocks_quant(engine.pool, blocks),
                                   fn="engine.migrate_out")
    sample = engine.sample
    engine._stats["migrations_out"] += 1
    return DecodeCheckpoint(
        format_version=CHECKPOINT_FORMAT, rid=rid,
        prompt=list(req.prompt), tokens=list(req.tokens),
        logps=list(req.logps), max_new_tokens=req.max_new_tokens,
        eos_id=req.eos_id, preempt_count=req.preempt_count,
        temperature=float(sample.temperature), top_k=int(sample.top_k),
        top_p=float(sample.top_p),
        rng_key=engine._gen.get_state().numpy().copy(),
        adapter_id=req.adapter,
        adapter_version=(None if req.adapter_binding is None
                         else int(req.adapter_binding.version)),
        kv_len=kv_len, block_size=bs,
        kv_k=_wire_array(host.k), kv_v=_wire_array(host.v),
        kv_dtype=engine.engine_config.kv_dtype,
        hi_layers=engine.pool.hi_layers,
        kv_k_scale=_wire_array(host.k_scale),
        kv_v_scale=_wire_array(host.v_scale),
        kv_k_hi=_wire_array(host.k_hi), kv_v_hi=_wire_array(host.v_hi))


def _validate_pool_layout(engine, ckpt: DecodeCheckpoint) -> BlockPayload:
    """Model-level compatibility, then the payload as host tensors of the
    pool's dtypes. A KV payload whose layer / head / dim layout or dtype
    differs came from a DIFFERENT model: always an error, never a silent
    recompute. (The kv_dtype LADDER fence is the caller's: a ladder
    mismatch is a legal recompute fallback, so this runs once the
    flavours already agree.)"""
    pool = engine.pool
    l, _nblk, _bs, hkv, dh = np.shape(ckpt.kv_k)
    l += 0 if ckpt.kv_k_hi is None else int(np.shape(ckpt.kv_k_hi)[0])
    phkv, pdh = pool.k.shape[3:]
    pl = pool.num_layers
    if (l, hkv, dh) != (pl, phkv, pdh):
        raise MigrationError(
            f"checkpoint KV layout (L={l}, Hkv={hkv}, Dh={dh}) != "
            f"target pool (L={pl}, Hkv={phkv}, Dh={pdh})")
    return BlockPayload(*(
        None if src is None else _pool_tensor(src, getattr(pool, name).dtype,
                                              "kv_" + name)
        for name, src in zip(BlockPayload._fields, (
            ckpt.kv_k, ckpt.kv_v, ckpt.kv_k_scale, ckpt.kv_v_scale,
            ckpt.kv_k_hi, ckpt.kv_v_hi))))


def restore_into_engine(engine, ckpt: DecodeCheckpoint) -> int:
    """Install a checkpoint under a FRESH rid (engine lock held by the
    caller) and return it. Fast path: a free row and a matching block
    size → one in-place install; otherwise requeue at the front and let
    the preemption-resume replay recompute. Both are token-exact."""
    if not isinstance(ckpt, DecodeCheckpoint):
        ckpt = DecodeCheckpoint.from_wire(ckpt)
    if ckpt.format_version not in _ACCEPTED_FORMATS:
        raise MigrationError(
            f"checkpoint format {ckpt.format_version} not in supported "
            f"{_ACCEPTED_FORMATS}")
    if engine.kv_layout != "paged":
        raise MigrationError(
            "live migration needs the paged KV layout (engine fell "
            f"back to slots: {engine.kv_layout_fallback})")
    sample = engine.sample
    ours = (float(sample.temperature), int(sample.top_k),
            float(sample.top_p))
    theirs = (float(ckpt.temperature), int(ckpt.top_k),
              float(ckpt.top_p))
    if ours != theirs:
        raise MigrationError(
            f"sampler mismatch: checkpoint {theirs} != engine {ours}; "
            "resumed output could not be token-exact")
    if len(ckpt.prompt) >= engine.context_bound:
        raise MigrationError(
            f"prompt length {len(ckpt.prompt)} ≥ target context bound "
            f"{engine.context_bound}")
    binding = None
    if ckpt.adapter_id is not None:
        if engine.adapter_pool is None:
            raise MigrationError(
                f"checkpoint bound to adapter {ckpt.adapter_id!r} but "
                "target engine has no adapter_pool")
        try:
            binding = engine.adapter_pool.acquire(ckpt.adapter_id)
        except Exception as e:
            raise MigrationError(
                f"adapter {ckpt.adapter_id!r} unavailable on target: "
                f"{e}")
        if int(binding.version) != int(ckpt.adapter_version):
            engine.adapter_pool.release(binding)
            raise MigrationError(
                f"adapter {ckpt.adapter_id!r} moved to version "
                f"{binding.version} (checkpoint bound v"
                f"{ckpt.adapter_version}); no cross-version splice")
    ladder_ok = (ckpt.kv_dtype == engine.engine_config.kv_dtype
                 and int(ckpt.hi_layers) == engine.pool.hi_layers)
    expect_len = len(ckpt.prompt) + len(ckpt.tokens) - 1
    fast = (ckpt.kv_k is not None and ckpt.kv_len > 0 and ckpt.tokens
            and ckpt.kv_len == expect_len and ladder_ok)
    try:
        # refusals first: a foreign model's payload fails before the
        # engine holds any new state
        payload = _validate_pool_layout(engine, ckpt) if fast else None
    except Exception:
        if binding is not None:
            engine.adapter_pool.release(binding)
        raise
    from .engine import _Request
    rid = engine._next_rid
    engine._next_rid += 1
    req = _Request(rid=rid, prompt=list(ckpt.prompt),
                   max_new_tokens=ckpt.max_new_tokens,
                   eos_id=ckpt.eos_id, adapter=ckpt.adapter_id,
                   adapter_binding=binding)
    req.tokens = list(ckpt.tokens)
    req.logps = list(ckpt.logps)
    req.preempt_count = ckpt.preempt_count
    engine._requests[rid] = req
    installed = False
    if fast:
        nblk = int(np.shape(ckpt.kv_k)[1])
        free = engine._free_slots()
        if (free and ckpt.block_size == engine._alloc.block_size
                and nblk >= engine._alloc.blocks_for(ckpt.kv_len)):
            try:
                blocks = engine._alloc_blocks_evicting(nblk)
            except BlocksExhausted:
                blocks = None   # pool full even after reclaim: recompute
            if blocks is not None:
                try:
                    install_blocks_quant(engine.pool, payload, blocks)
                except Exception:
                    engine._alloc.release(blocks)
                    del engine._requests[rid]
                    if binding is not None:
                        engine.adapter_pool.release(binding)
                    raise
                engine._alloc.count_install_copy(nblk)
                row = free[0]
                req.slot = row
                engine._slot_req[row] = req
                engine._tables[row] = list(blocks)
                engine._row_len[row] = int(ckpt.kv_len)
                engine._cur_tok_host[row] = req.tokens[-1]
                installed = True
    if not installed:
        # Recompute path: front of the queue (the request already did
        # work); the scheduler's tokens-nonempty resume replays prompt +
        # tokens[:-1] and decodes from tokens[-1].
        engine._queue.appendleft(req)
    engine._stats["migrations_in"] += 1
    return rid


def release_from_engine(engine, rid: int) -> bool:
    """Forget a request after its handoff (engine lock held by the
    caller): drop its row and blocks, adapter binding, queue entry and
    pending emits. Idempotent: an unknown rid returns False (the release
    may race a retry or a completion)."""
    req = engine._requests.pop(rid, None)
    if req is None:
        return False
    try:
        engine._queue.remove(req)
    except ValueError:
        pass
    if engine.kv_layout == "paged":
        engine._prefill_jobs.pop(rid, None)
    engine._pending_emits.pop(rid, None)
    if req.adapter_binding is not None and engine.adapter_pool is not None:
        engine.adapter_pool.release(req.adapter_binding)
        req.adapter_binding = None
    row = req.slot
    if (row is not None and engine.kv_layout == "paged"
            and engine._slot_req[row] is req):
        engine._slot_req[row] = None
        engine._release_row(row)
    req.slot = None
    req.done = True
    return True


def set_paused(engine, rid: int, paused: bool) -> None:
    """Freeze or unfreeze one request (engine lock held by the caller): a
    paused request is skipped by the step assembler, the speculation
    planner and the scheduler, so its state cannot advance between
    snapshot and release or resume."""
    req = engine._requests.get(rid)
    if req is None:
        raise MigrationError(f"unknown rid {rid}")
    if req.done:
        raise MigrationError(f"rid {rid} already finished")
    req.paused = bool(paused)
