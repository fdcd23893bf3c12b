#!/usr/bin/env python3
"""Smoke check of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

Phases, each fatal on failure:

1. Device: the card's name and power limit (nvidia-smi); TF32 off.
2. Build: compile every CUDA kernel library with nvcc (one process per
   source, in parallel) and print nvcc's register / shared-memory report.
3. Kernel vs plain, K1: paged_flash_decode at Qwen2.5-Coder-1.5B attention
   shapes on bf16, int8 and fp8 pools: ragged lengths, aliased tables
   and poisoned dead blocks against the plain PyTorch version; lengths
   on the split plan's chunk and tile edges (and 0: exact zeros); the
   mixed step, prefill segments across chunk edges and segments whose
   tiles' shorter row ends on a warp's 16-position step, in query tiles
   and untiled; NaN past every length (or tile's reach) and a second
   launch must leave the output bit-identical. Then kernel / plain
   times with CUDA events beside the bytes bound at the decode step (16
   rows, lengths 128..2048) and the mixed step (those 16 rows plus a
   40-token and an 8-token prefill segment, T = 64, in query tiles).
4. Serving: RolloutEngine at full qwen2.5-coder-1.5b width (random
   weights from --seed) answers 32 sampled requests on the bf16 pool,
   then short greedy runs on the int8 and fp8 ladders; the kernel's
   launch count must equal layers x fused steps in every run.
5. Logits: one fused step's logits with the kernel are held against the
   plain path and against the no-cache forward over each entry's whole
   sequence.
6. Kernel vs plain, K2: the flash-attention forward, dK/dV and dQ
   kernels at the model's attention shapes (Hq 12, Hkv 2, D 128, bf16):
   causal at S=1024, a ragged S=1000, kv_mask padding and a sliding
   window, out / lse / dq / dk / dv against the plain versions; then
   kernel, plain and SDPA (yardstick only) times at the training shape
   beside the flop and byte bounds.
7. Training: one GRPO round at full width with attn_impl="flash" and
   remat: the engine samples 4 prompts x 4 completions with behaviour
   log-probs, a stand-in reward, make_batch / make_batch_logps, three
   train_steps (accum_steps 4), update_params, one more served group.
   Checks finite metrics, |ratio_mean - 1| at the first step, moved
   params and engine logits, and each K2 launch count against layers x
   accum x steps (x2 for the remat recompute of the forward). Prints
   step seconds, trained tokens/s, peak memory and an analytic
   model-FLOPs share, as smoke figures.
8. Kernel vs plain, K3 (runs in phase 3's slot, before serving):
   flash_decode over the contiguous slot cache at the head shapes of
   qwen2.5-coder-1.5b (12/2, D 128), mistral-7b (32/8, D 128) and
   qwen2.5-coder-0.5b (14/2, D 64), bf16 and f32, lengths 0..Smax on a
   tile-aligned, a ragged and a strided cache, then bf16 lengths at the
   split kernel's chunk and tile edges and short grids (heads 12/2 at
   B=1 and B=2); poisoned positions past each length must leave the
   output bit-identical, and so must a second launch; kernel, plain and
   SDPA (yardstick only) times at 16 slots x 4096 at the Mistral and
   the Qwen-1.5B heads beside the bytes bound.
9. The int8 slot cache (kv_quant) at full qwen2.5-coder-1.5b width: 8
   greedy requests, K3 launches = layers x decode steps; greedy token
   match vs the bf16 paged engine printed (runs before phase 6).
10. Slot serving at full mistral-7b width (random weights from --seed,
    after the 1.5B weights are freed): the 4096-position ring cache, 16
    slots, 24 sampled requests (short prompts, prompts that decode past
    the window, prompts longer than the ring); every request finishes
    with finite log-probs <= 0 and K3 launches = layers x (decode steps
    + one-token chunks).
11. Mistral logits: one ring decode step, K3 vs einsum; prefill_chunked
    of 4096 tokens then 64 decode steps past the window vs the no-cache
    forward with the window.
12. The online GRPO round (after phase 7, on its trained 1.5B weights,
    tracing on): one shared paged engine (8 slots, max_len 4096,
    SampleParams()), 2 tasks x 4 agent-mode RolloutSessions (ByteTokenizer,
    64 new tokens a call, the assembled system message without tool
    definitions), grpo_round with max_parallel 8, attn_impl="flash", remat,
    accum 4 and no reward override: the trace reward head on the card
    scores every episode. Fails on an episode without a scored trace, a
    card head more than 1e-6 from the host head over the round's feature
    rows, K1 launches != layers x fused steps, K2 launches != layers x
    accum x epochs (x2 forward under remat), a non-finite metric,
    |ratio_mean - 1| past phase 7's tolerance, a missing span or runtime
    ledger entry, or a stats() key of the JAX engine missing. Then
    update_params, one more session and check_leaks. Random weights at
    this vocabulary decode to mostly empty text, so groups tie on the
    trace reward and the update is a zero-advantage step: the phase
    prints zero_advantage_group_fraction and the round's collect /
    batch_build / train seconds.
13. HF weights out and in (``phase_hf``, after phase 12, on its trained
    1.5B weights): export_hf_params writes one model.safetensors (338
    tensors, 3.09 GB bf16) into a temp dir, available_hf_keys must list
    exactly the dense Qwen2 key set, load_hf_params reads it onto the
    card; every tensor and one 256-token prompt's logits must be
    bit-identical to the source. Prints export and load seconds and GB/s,
    then removes the dir.
14. The online improvement loop (``phase_online``, on the loaded
    weights): phase 12's engine and sessions under an
    OnlineImprovementLoop with kl_coef 0.05 and the anchor refreshed every
    round, outcome_feedback as the judge, accum 4, and APO from
    make_local_apo over the same engine (gates at 4 traces / 4 feedbacks,
    a one-round beam of width 2 and branch factor 2, candidates scored by
    re-rolling one task). Two rounds: round 0 must analyze and run the
    beam; every trace scored on the card equals the host head; K1 = layers
    x fused steps and K2 = phase 12's counts plus one forward a layer and
    microbatch for the anchor's log-probs, per round. Then loop.checkpoint
    into a CheckpointManager(keep_last=1) and OnlineImprovementLoop.resume
    into a new loop on the same engine: round 2, the rules, the session
    cursor and the weight version restored, params, both moments and the
    anchor bit-identical, the engine serving the restored params, and a
    16-token greedy request identical before and after; check_leaks. Prints
    each round's wall seconds and split, the APO seconds, the checkpoint
    and resume seconds and bytes, and peak memory.
15. A JSON line with every kernel's numbers (``launches_round`` and
    ``launches_online`` on K1 bf16 and K2: the round's and the two online
    rounds' counts), the card line, and last the JSON ok line.

Exits non-zero, printing no result, without CUDA or without the
``senweaver_ide_tpu_torch`` package beside this file.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
# Kernel vs plain: both accumulate in fp32; a bf16 output rounds at
# 2**-9 relative, so |kernel - plain_fp32| <= ATOL + RTOL * |plain_fp32|.
KERNEL_ATOL = KERNEL_RTOL = 1e-2
# One fused step's logits, kernel vs plain path (or vs the no-cache
# forward), bf16 model: the plain paths round softmax probabilities to bf16
# before the PV product while the kernel keeps them in fp32, bf16 matmuls
# of different shapes round differently, and the difference rides 28
# layers. Logits of this random-weight model reach about 4.
LOGITS_ATOL = 0.25
BF16_FLOPS = 989e12            # H100 SXM dense bf16 tensor-core peak
# K2 kernels vs their plain versions on fp32 copies of the same bf16
# inputs. Per element |kernel - plain| <= atol + rtol*|plain| +
# scaled*max|plain|, and the whole tensor's RMS error <= FA_RMS_TOL of its
# RMS (a misplaced element breaks this at once). The bf16 kernels run on
# the tensor cores: out, dq, dk and dv round to bf16 (2**-9 relative), and
# P and dS round to bf16 before the second products, as SDPA's and
# FlashAttention-2's do, so one gradient element can carry ~2**-8 of the
# largest terms that meet in it (observed: RMS error 0.25%, worst element
# 0.027 where max|dk| is 6.6); lse stays fp32. (atol, rtol, scaled).
FA_TOL = {"out": (1e-2, 1e-2, 0.0), "lse": (1e-3, 1e-4, 0.0),
          "dq": (1e-2, 1e-2, 5e-3), "dk": (1e-2, 1e-2, 5e-3),
          "dv": (1e-2, 1e-2, 5e-3)}
FA_TOL_F32 = (1e-4, 1e-4, 0.0)  # f32 instances: summation order only
FA_RMS_TOL = 1e-2
FA_ERR_OF = {"fwd": ("out", "lse"), "dkdv": ("dk", "dv"), "dq": ("dq",)}
# The GRPO round (phase 7)
TRAIN_PROMPTS, TRAIN_GROUP, TRAIN_NEW_TOKENS = 4, 4, 128
TRAIN_STEPS, TRAIN_ACCUM, TRAIN_REMAT = 3, 4, True
# The trainer's default rate. On bf16 params most Adam steps of 1e-5 round
# away (an ulp at the weights' typical 0.025 is 1.2e-4); the weights
# below ~2.5e-3 in magnitude still move, which the phase checks.
TRAIN_LR = 1e-5
# First step, mean importance ratio over the completion tokens: behaviour
# log-probs from the serving path (paged K1, bf16 matmuls over the flat
# token batch) against the trainer's (no-cache forward, K2) on the same
# weights. Per-token log-prob differences of a few 1e-2 from bf16
# rounding average out; E[exp(d)] - 1 ~ E[d] + var(d) / 2.
RATIO_TOL = 0.02
# The slot layout's main path (mistral-7b, ring cache): 16 slots, max_len
# 8192 clamps to the 4096-position ring. Traffic: (min prompt, max prompt,
# count, new tokens): short prompts; prompts just under the window that
# decode past it (the ring wraps in decode); prompts longer than the ring
# (the chunk chain, chunks that wrap).
SLOTS_NUM, SLOTS_MAX_LEN = 16, 8192
SLOTS_TRAFFIC = ((256, 1024, 20, 128), (3900, 4000, 2, 256),
                 (5000, 6000, 2, 64))
LOGITS_PAST = 64          # ring decode steps past the window, phase 11


# The online GRPO round (phase_round): sessions on one shared engine
ROUND_TASKS = ("Add a function `add(a, b)` to utils.py that returns a + b.",
               "Write a README.md that explains how to run the tests.")
ROUND_GROUP, ROUND_NEW_TOKENS, ROUND_SLOTS, ROUND_MAX_LEN = 4, 64, 8, 4096
ROUND_ACCUM, ROUND_EPOCHS = 4, 1
# card head vs the plain head on the host, per dim and final reward
HEAD_TOL = 1e-6
# every key the JAX engine's stats() returns on the paged layout; the
# port's must hold them all (tests/test_torch_rl_loop.py holds this list
# against the JAX engine)
JAX_STATS_KEYS_PAGED = (
    "batched_prefill_slots", "batched_prefills", "branch_forks",
    "continuation_delta_tokens", "continuations", "decode_steps",
    "group_degrades", "group_forks", "group_prefill_tokens_avoided",
    "group_prefills", "hold_evictions", "kv_allocs", "kv_blocks_free",
    "kv_blocks_total", "kv_bytes_device", "kv_bytes_host",
    "kv_bytes_per_block", "kv_cow_copies", "kv_dtype", "kv_evictions",
    "kv_exhaustions", "kv_grafts", "kv_install_copies", "kv_paged",
    "kv_preemption_storms", "kv_preemptions", "kv_pressure",
    "kv_releases", "kv_swap_ins", "kv_swap_outs", "kv_swapped_blocks",
    "migrations_in", "migrations_out", "prefill_tokens", "prefills",
    "prefix_cache_hits", "prefix_cache_misses", "prefix_evictions",
    "prefix_exports", "prefix_host_exports", "prefix_imports",
    "prefix_installs", "prefix_prefills", "prefix_swap_ins",
    "prefix_swap_outs", "prefix_tokens_reused", "queue_depth",
    "slots_active", "spec_accepted", "spec_feed_tokens", "spec_proposed",
    "spec_rollbacks", "spec_rounds", "spec_wasted", "tokens_emitted",
    "weight_quant")
# The online loop across rounds (phase_online): phase_round's engine and
# sessions, the KL anchor refreshed every round, APO's gates lowered so
# that round 0 analyzes and runs a one-round beam of width 2
ONLINE_ROUNDS, ONLINE_KL, ONLINE_ANCHOR_EVERY = 2, 0.05, 1
ONLINE_APO = dict(min_traces_for_analysis=4, min_feedbacks_for_analysis=4,
                  gradient_min_feedbacks=4, beam_rounds=1, beam_width=2,
                  branch_factor=2)
PROBE_NEW_TOKENS = 16
ROUND_SPANS = ("grpo_round", "collect", "batch_build", "train_step",
               "trainer.grpo_step", "agent.turn", "engine.decode_step")
ROUND_LEDGER = ("engine.fused_step", "trainer.grpo_step")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_device(torch):
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if res.returncode != 0 or not res.stdout.strip():
        fail(f"nvidia-smi failed: {res.stderr.strip()}")
    smi = res.stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[device] nvidia-smi: {smi}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    log("[device] set torch.backends.cuda.matmul.allow_tf32=False and "
        "torch.backends.cudnn.allow_tf32=False")
    return smi


def phase_build():
    from senweaver_ide_tpu_torch.ops import _build
    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f"[build] {len(libs)} kernel librar{'y' if len(libs) == 1 else 'ies'}"
        f" built in {time.perf_counter() - t0:.1f} s")
    for lib in libs:
        log(f"[build] {lib.name}: {lib.path} ({lib.build_seconds:.1f} s)")
        for line in lib.ptxas_log.splitlines():
            if any(w in line for w in ("Compiling entry", "registers",
                                       "spill", "smem")):
                log(f"[build]   {line.strip()}")


class Timer:
    """Per-launch CUDA-event timing with the 50 MB L2 flushed before
    each launch: between two calls of one layer the engine streams the
    other layers' weights and KV through the cache, so the kernel finds
    it cold. After the flush the card spins for SPIN_MS in a busy-wait
    kernel before the start event, while the host runs the call's Python
    (a wrapper's checks, allocations and ctypes launch take tens of
    microseconds): the events then time the device's work, not the
    host's launch latency."""

    SPIN_MS = 0.5

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(96 * 2 ** 20, dtype=torch.uint8,
                                 device="cuda")
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1000)          # load the busy-wait kernel
        s.record()
        torch.cuda._sleep(10 ** 6)
        e.record()
        torch.cuda.synchronize()
        self.spin = int(10 ** 6 * self.SPIN_MS / s.elapsed_time(e))

    def ms(self, fn, iters=30, warmup=3):
        torch = self.torch
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(iters):
            self.flush.zero_()
            torch.cuda._sleep(self.spin)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            torch.cuda.synchronize()
            times.append(s.elapsed_time(e))
        return statistics.median(times)


def _pool(torch, variant, nb, bs, hkv, d, g):
    from senweaver_ide_tpu_torch.models.transformer import quantize_pool_kv
    kf = torch.randn(nb, bs, hkv, d, generator=g, device="cuda")
    vf = torch.randn(nb, bs, hkv, d, generator=g, device="cuda")
    if variant == "bf16":
        return kf.bfloat16(), vf.bfloat16(), None, None
    dt = torch.int8 if variant == "int8" else torch.float8_e4m3fn
    (kq, ks), (vq, vs) = quantize_pool_kv(kf, dt), quantize_pool_kv(vf, dt)
    return kq, vq, ks, vs


def _poison(torch, pool, tables, lengths, bs, poison_block):
    """Copies of the pool and tables where every position a row must
    not read holds huge values: the tail of each row's last live block
    and every dead table entry (pointed at ``poison_block``)."""
    k, v, ks, vs = (None if a is None else a.clone() for a in pool)
    tables = tables.clone()
    big = 127 if k.dtype == torch.int8 else 448.0 if k.is_floating_point() \
        and k.element_size() == 1 else 1e4
    for t, length in enumerate(lengths.tolist()):
        nblk = -(-length // bs)
        last, off = int(tables[t, nblk - 1]), length - (nblk - 1) * bs
        for a in (k, v):
            a[last, off:] = big
            a[poison_block] = big
        for s in (ks, vs):
            if s is not None:
                s[last, off:] = 1e4
                s[poison_block] = 1e4
        tables[t, nblk:] = poison_block
    return (k, v, ks, vs), tables


# K1's mixed timing step: a 16-row decode batch plus two chunked-prefill
# segments, as the engine's flat batch lays them out (decode rows first),
# T = 64, the step budget: (first position, tokens) of each segment.
K1_SEGMENTS = ((984, 40), (0, 8))
K1_BS, K1_MB = 16, 128


def _k1_err(out, ref):
    """(max |kernel - plain|, whether every element is in tolerance)"""
    diff = (out.float() - ref).abs()
    within = diff <= KERNEL_ATOL + KERNEL_RTOL * ref.abs()
    return float(diff.max()), bool(within.all())


def _k1_nan_poison(torch, pool, tables, lengths, bs, q_tiles=None):
    """Copies of the pool and tables where every (block, position) that no
    entry's tile reaches holds NaN (an int8 payload 127 with a NaN scale)
    and every table entry past a tile's reach points at an all-NaN block
    appended to the pool. A tile reaches its longest entry's length."""
    k, v, ks, vs = pool
    lens = lengths.tolist()
    reach = list(lens)
    if q_tiles is not None:
        for first, count in q_tiles.tolist():
            reach[first:first + count] = [max(lens[first:first + count])] \
                * count
    nb, bs_ = k.shape[0], k.shape[1]
    live = torch.zeros(nb + 1, bs_, dtype=torch.bool)
    tbl = tables.cpu().clone()
    for t, n in enumerate(reach):
        nblk = -(-n // bs)
        if nblk:
            live[tbl[t, :nblk - 1].long()] = True
            live[int(tbl[t, nblk - 1]), :n - (nblk - 1) * bs] = True
        tbl[t, nblk:] = nb
    dead = (~live).to(k.device)
    out = []
    for a in (k, v):
        a = torch.cat([a, a[:1]])
        if a.dtype == torch.int8:
            a[dead] = 127
        elif a.element_size() == 1:               # fp8 e4m3fn: NaN 0x7f
            a.view(torch.uint8)[dead] = 0x7F
        else:
            a[dead] = float("nan")
        out.append(a)
    for s in (ks, vs):
        if s is None:
            out.append(None)
            continue
        s = torch.cat([s, s[:1]])
        s[dead] = float("nan")
        out.append(s)
    return tuple(out), tbl.to(tables.device).contiguous()


def _k1_check(torch, label, q, pool, tables, lengths, q_tiles=None):
    """The kernel against its plain version on one batch: within
    tolerance, exact zeros for length 0, bit-identical across two launches
    and with NaN in every position no tile reaches. Returns the max
    error."""
    from senweaver_ide_tpu_torch.ops.paged_attention import (
        paged_flash_decode, paged_flash_decode_plain)
    bs = pool[0].shape[1]
    out = paged_flash_decode(q, *pool[:2], tables, lengths, *pool[2:],
                             q_tiles=q_tiles)
    again = paged_flash_decode(q, *pool[:2], tables, lengths, *pool[2:],
                               q_tiles=q_tiles)
    torch.cuda.synchronize()
    ref = paged_flash_decode_plain(q.float(), *pool[:2], tables, lengths,
                                   *pool[2:])
    e, ok = _k1_err(out, ref)
    if not ok:
        fail(f"paged_flash_decode {label}: kernel vs plain max err {e}")
    if bool(out[lengths == 0].ne(0).any()):
        fail(f"paged_flash_decode {label}: a length-0 row is not 0")
    if not torch.equal(out, again):
        fail(f"paged_flash_decode {label}: two launches on the same inputs "
             f"differ")
    ppool, ptables = _k1_nan_poison(torch, pool, tables, lengths, bs,
                                    q_tiles)
    out_p = paged_flash_decode(q, *ppool[:2], ptables, lengths, *ppool[2:],
                               q_tiles=q_tiles)
    torch.cuda.synchronize()
    if not torch.equal(out_p, out):
        fail(f"paged_flash_decode {label}: NaN past the lengths moved the "
             f"output")
    return e


def _k1_seq_batch(torch, g, variant, cfg, seq_lens, entries):
    """A flat batch over sequences of ``seq_lens`` tokens, each with its
    own table row of K1_MB random blocks: ``entries`` lists (sequence,
    position) pairs. Returns (q, pool, tables per entry, lengths, seq_row,
    positions as host tensors)."""
    hq, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    n = len(seq_lens)
    nb = n * K1_MB
    pool = _pool(torch, variant, nb, K1_BS, hkv, d, g)
    seq_tables = torch.randperm(nb, generator=g, device="cuda").view(
        n, K1_MB).to(torch.int32)
    seq_row = torch.tensor([s for s, _ in entries])
    positions = torch.tensor([p for _, p in entries])
    tables = seq_tables[seq_row.cuda()].contiguous()
    lengths = (positions + 1).to(torch.int32).cuda()
    q = torch.randn(len(entries), hq, d, generator=g,
                    device="cuda").bfloat16()
    return q, pool, tables, lengths, seq_row, positions


def k1_mixed_entries(decode_lengths):
    """(sequence lengths, entries) of the mixed step: one decode entry per
    decode length, then K1_SEGMENTS' prefill segments of two more
    sequences."""
    seq_lens = list(decode_lengths) + [p + n for p, n in K1_SEGMENTS]
    entries = [(i, n - 1) for i, n in enumerate(decode_lengths)]
    for j, (p0, n) in enumerate(K1_SEGMENTS):
        entries += [(len(decode_lengths) + j, p) for p in range(p0, p0 + n)]
    return seq_lens, entries


def _k1_bound(pool, q, lengths, reach, n_tiles=0):
    """(bytes, flops): the KV of every distinct (block, position) read
    once at its stored width with its scales (``reach``: the positions
    read in each table row), q read and out written once, the live table
    entries, the lengths and the tiles."""
    hkv, d = pool[0].shape[2], pool[0].shape[3]
    per_pos = hkv * 2 * (d * pool[0].element_size()
                         + (4 if pool[2] is not None else 0))
    live_blocks = sum(-(-n // K1_BS) for n in reach)
    nbytes = (sum(reach) * per_pos + 2 * q.numel() * 2 + live_blocks * 4
              + lengths.numel() * 4 + n_tiles * 8)
    flops = 4 * q.shape[1] * d * int(lengths.sum())
    return nbytes, flops


def phase_kernel(torch, cfg, timer):
    """paged_flash_decode (K1) against its plain version on the card, then
    its times at the decode and the mixed step shape beside the bound."""
    from senweaver_ide_tpu_torch.ops.paged_attention import (
        TILE_ROWS, kernel_resources, paged_flash_decode,
        paged_flash_decode_plain, query_tiles)
    from senweaver_ide_tpu_torch.ops.flash_decode import split_plan
    hq, hkv, d, bs = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, K1_BS)
    rep = hq // hkv
    mb = K1_MB
    cap = mb * bs
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    g = torch.Generator(device="cuda").manual_seed(1)
    results = {}
    res = kernel_resources(d)
    for name, r in res.items():
        log(f"[kernel] split pass, {name} pool, D={d}: {r['registers']} "
            f"registers/thread, {r['smem_bytes']} dynamic smem bytes, "
            f"{r['threads']} threads, {r['blocks_per_sm']} blocks/SM "
            f"resident")

    for variant in ("bf16", "int8", "fp8"):
        worst = 0.0
        # ragged lengths through distinct tables
        lengths = torch.tensor([1, 15, 16, 17, 1000, 2048], device="cuda",
                               dtype=torch.int32)
        t = lengths.numel()
        nb = t * mb + 1
        pool = _pool(torch, variant, nb, bs, hkv, d, g)
        tables = torch.randperm(nb - 1, generator=g, device="cuda")[
            :t * mb].view(t, mb).to(torch.int32).contiguous()
        q = torch.randn(t, hq, d, generator=g, device="cuda").bfloat16()
        out = paged_flash_decode(q, pool[0], pool[1], tables, lengths,
                                 pool[2], pool[3])
        torch.cuda.synchronize()
        ref = paged_flash_decode_plain(q.float(), pool[0], pool[1], tables,
                                       lengths, pool[2], pool[3])
        e, ok = _k1_err(out, ref)
        if not ok:
            fail(f"{variant} ragged: kernel vs plain max err {e}")
        worst = max(worst, e)
        # poisoned dead blocks: the output must not move at all
        ppool, ptables = _poison(torch, pool, tables, lengths, bs, nb - 1)
        out_p = paged_flash_decode(q, ppool[0], ppool[1], ptables, lengths,
                                   ppool[2], ppool[3])
        torch.cuda.synchronize()
        if not torch.equal(out_p, out):
            fail(f"{variant}: poisoned dead positions moved the output")
        # aliased tables: several entries read through the same blocks
        lengths_a = torch.tensor([700, 650, 641, 1000], device="cuda",
                                 dtype=torch.int32)
        tables_a = tables[:4].clone()
        tables_a[1:, :40] = tables_a[0, :40]
        qa = torch.randn(4, hq, d, generator=g, device="cuda").bfloat16()
        out_a = paged_flash_decode(qa, pool[0], pool[1], tables_a,
                                   lengths_a, pool[2], pool[3])
        torch.cuda.synchronize()
        ref_a = paged_flash_decode_plain(qa.float(), pool[0], pool[1],
                                         tables_a, lengths_a, pool[2],
                                         pool[3])
        e, ok = _k1_err(out_a, ref_a)
        if not ok:
            fail(f"{variant} aliased: kernel vs plain max err {e}")
        worst = max(worst, e)

        # lengths on the split plan's chunk and tile edges (the batch's
        # own plan), and 0
        _, chunk = split_plan(11, hkv, cap, sms)
        lens = [0, 1, 63, 64, 65, chunk - 1, chunk, chunk + 1,
                2 * chunk + 1, cap - 1, cap]
        q_e, pool_e, tables_e, lengths_e, _, _ = _k1_seq_batch(
            torch, g, variant, cfg, lens, [(i, max(n, 1) - 1)
                                           for i, n in enumerate(lens)])
        lengths_e[0] = 0
        e = _k1_check(torch, f"{variant} edges (chunk {chunk})", q_e,
                      pool_e, tables_e, lengths_e)
        worst = max(worst, e)
        log(f"[kernel] {variant} lengths {lens} (chunk {chunk}): max "
            f"|kernel - plain| {e:.3g}; length 0 exact zeros, NaN past each "
            f"length and a second launch bit-identical")
        # tiled against untiled against plain: the mixed step; segments
        # across the chunk edges of their tiles' plan; and segments from
        # positions 15, 31 and chunk + 47, whose first tile's shorter row
        # ends on a warp's 16-position step (c0 + 16, 32, 48) inside a
        # live split, so that step is wholly past that row's length
        decode = torch.linspace(128, 2048, 16).round().int().tolist()
        seq_lens, entries = k1_mixed_entries(decode)
        per_tile = TILE_ROWS // rep
        seg_tiles = 16 + 2 * -(-10 // per_tile)   # decode + 2 x 10 entries
        _, chunk_t = split_plan(seg_tiles, hkv, cap, sms)
        _, chunk_w = split_plan(seg_tiles + -(-10 // per_tile), hkv, cap,
                                sms)
        starts = {"edges": (chunk_t - 4, 2 * chunk_t - 7),
                  "steps": (15, 31, chunk_w + 47)}
        for p0s in starts.values():
            for p0 in p0s:
                seq_lens.append(p0 + 10)
                entries += [(len(seq_lens) - 1, p)
                            for p in range(p0, p0 + 10)]
        cases = (("mixed step", entries[:64]),
                 ("segments across chunk edges",
                  entries[:16] + entries[64:84]),
                 ("segments from warp-step edges",
                  entries[:16] + entries[84:]))
        for label, ents in cases:
            q_m, pool_m, tables_m, lengths_m, seq_row, pos = _k1_seq_batch(
                torch, g, variant, cfg, seq_lens, ents)
            errs = []
            for tiled in (True, False):
                tiles = query_tiles(seq_row, pos, rep) if tiled else None
                name = f"{TILE_ROWS}-row tiles" if tiled else "untiled"
                e = _k1_check(torch, f"{variant} {label} {name}", q_m,
                              pool_m, tables_m, lengths_m, tiles)
                worst = max(worst, e)
                errs.append(f"{name} {e:.3g}")
            log(f"[kernel] {variant} {label}: T={len(ents)}, max |kernel - "
                f"plain| " + ", ".join(errs) + "; NaN past the tiles' reach "
                f"and a second launch bit-identical")

        # timing 1: one decode-shaped batch, 16 rows spread to 2048
        tt = 16
        lengths_t = torch.linspace(128, 2048, tt, device="cuda").round().to(
            torch.int32)
        nb_t = tt * mb
        pool_t = _pool(torch, variant, nb_t, bs, hkv, d, g)
        tables_t = torch.randperm(nb_t, generator=g, device="cuda").view(
            tt, mb).to(torch.int32).contiguous()
        q_t = torch.randn(tt, hq, d, generator=g, device="cuda").bfloat16()
        args = (q_t, pool_t[0], pool_t[1], tables_t, lengths_t, pool_t[2],
                pool_t[3])
        kernel_ms = timer.ms(lambda: paged_flash_decode(*args))
        plain_ms = timer.ms(lambda: paged_flash_decode_plain(*args))
        ref_t = paged_flash_decode_plain(q_t.float(), *args[1:])
        e, ok = _k1_err(paged_flash_decode(*args), ref_t)
        if not ok:
            fail(f"{variant} timing batch: kernel vs plain max err {e}")
        worst = max(worst, e)
        # the bound: distinct KV positions the tables reach (distinct
        # tables here, so the sum of lengths) x heads x (K + V payload
        # + scales), plus q, out, the live table entries and lengths
        nbytes, flops = _k1_bound(pool_t, q_t, lengths_t,
                                  lengths_t.tolist())
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = flops / BF16_FLOPS * 1e3
        # reference only, never called by the port: SDPA over K/V that
        # were gathered out of the pool beforehand
        sdpa_ms = _sdpa_pregathered_ms(torch, timer, args, hkv, bs)
        splits, chunk = split_plan(tt, hkv, cap, sms)

        # timing 2: the mixed step, T = 64 in query tiles
        q_m, pool_m, tables_m, lengths_m, seq_row, pos = _k1_seq_batch(
            torch, g, variant, cfg, *k1_mixed_entries(
                lengths_t.tolist()))
        tiles = query_tiles(seq_row, pos, rep)
        margs = (q_m, pool_m[0], pool_m[1], tables_m, lengths_m, pool_m[2],
                 pool_m[3])
        tiles_dev = tiles.cuda()          # as forward_paged passes them
        mixed_ms = timer.ms(lambda: paged_flash_decode(
            *margs, q_tiles=tiles_dev))
        untiled_ms = timer.ms(lambda: paged_flash_decode(*margs))
        mixed_plain_ms = timer.ms(lambda: paged_flash_decode_plain(*margs))
        e, ok = _k1_err(paged_flash_decode(*margs, q_tiles=tiles),
                        paged_flash_decode_plain(q_m.float(), *margs[1:]))
        if not ok:
            fail(f"{variant} mixed timing batch: kernel vs plain max err "
                 f"{e}")
        worst = max(worst, e)
        reach = lengths_t.tolist() + [p + n for p, n in K1_SEGMENTS]
        m_bytes, m_flops = _k1_bound(pool_m, q_m, lengths_m, reach,
                                     tiles.shape[0])
        m_bound = max(m_bytes / HBM_BYTES_PER_S, m_flops / BF16_FLOPS) * 1e3
        m_splits, m_chunk = split_plan(tiles.shape[0], hkv, cap, sms)
        results[variant] = {
            "max_abs_err": worst, "kernel_ms": kernel_ms,
            "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "flops": flops, "splits": splits,
            "chunk": chunk, "sdpa_pregathered_ms": sdpa_ms,
            "mixed_ms": mixed_ms, "mixed_untiled_ms": untiled_ms,
            "mixed_plain_ms": mixed_plain_ms, "mixed_bound_ms": m_bound,
            "mixed_bound_by": "bytes" if m_bytes / HBM_BYTES_PER_S >=
            m_flops / BF16_FLOPS else "operations",
            "mixed_bytes": m_bytes, "mixed_tiles": int(tiles.shape[0]),
            "mixed_splits": m_splits, "mixed_chunk": m_chunk,
            "resources": res[variant]}
        log(f"[kernel] {variant}: max_abs_err {worst:.3g} (tol "
            f"{KERNEL_ATOL}+{KERNEL_RTOL}*|ref|); decode T={tt} lengths "
            f"128..2048, {splits} splits of {chunk}: kernel "
            f"{kernel_ms:.4f} ms = {nbytes / kernel_ms / 1e9:.3f} TB/s, "
            f"{max(bytes_ms, ops_ms) / kernel_ms:.3f} of the bound; plain "
            f"{plain_ms:.4f} ms, bound {max(bytes_ms, ops_ms):.4f} ms "
            f"({nbytes} bytes, {flops} flops); SDPA on pre-gathered K/V "
            f"(reference only) {sdpa_ms:.4f} ms")
        log(f"[kernel] {variant}: mixed step T={q_m.shape[0]} (16 decode "
            f"rows, segments {K1_SEGMENTS}) in {tiles.shape[0]} tiles, "
            f"{m_splits} splits of {m_chunk}: kernel {mixed_ms:.4f} ms = "
            f"{m_bound / mixed_ms:.3f} of the bound, untiled "
            f"{untiled_ms:.4f} ms; plain "
            f"{mixed_plain_ms:.4f} ms, bound "
            f"{m_bound:.4f} ms ({m_bytes} bytes: each distinct (block, "
            f"position) once)")
    return results


def _sdpa_pregathered_ms(torch, timer, args, hkv, bs):
    import torch.nn.functional as F
    q, k_pool, v_pool, tables, lengths, ks, vs = args
    t, hq, d = q.shape
    smax = int(lengths.max())
    tbl = tables.long()[:, :-(-smax // bs)]
    k = k_pool[tbl].reshape(t, -1, hkv, d)[:, :smax]
    v = v_pool[tbl].reshape(t, -1, hkv, d)[:, :smax]
    if ks is not None:
        k = (k.float() * ks[tbl].reshape(t, -1, hkv, 1)[:, :smax])
        v = (v.float() * vs[tbl].reshape(t, -1, hkv, 1)[:, :smax])
    rep = hq // hkv
    k = k.bfloat16().repeat_interleave(rep, 2).transpose(1, 2).contiguous()
    v = v.bfloat16().repeat_interleave(rep, 2).transpose(1, 2).contiguous()
    mask = (torch.arange(smax, device="cuda")[None, :]
            < lengths[:, None])[:, None, None, :]
    qq = q[:, :, None, :]
    return timer.ms(lambda: F.scaled_dot_product_attention(
        qq, k, v, attn_mask=mask))


# K3 (flash_decode) head shapes: (Hq, Hkv, D) of the models that decode
# from the slot cache, and what the timing runs at.
FD_HEADS = {"qwen2.5-coder-1.5b": (12, 2, 128), "mistral-7b": (32, 8, 128),
            "qwen2.5-coder-0.5b": (14, 2, 64)}
# K3 vs plain on fp32 copies of the same inputs: bf16 output rounds at
# 2**-9 relative (K1's tolerance and reason); f32 differs by summation
# order only. (atol, rtol)
FD_TOL = {"bf16": (1e-2, 1e-2), "f32": (1e-4, 1e-4)}
# The timing rows: 16 slots x 4096 positions, lengths 512..4096, at the
# Mistral-7B heads (B * Hkv = 128 blocks without split-KV) and the
# Qwen2.5-Coder-1.5B heads (32), the first row the JSON line's main one.
FD_TIMINGS = (dict(b=16, smax=4096, heads="mistral-7b", lo=512, hi=4096),
              dict(b=16, smax=4096, heads="qwen2.5-coder-1.5b", lo=512,
                   hi=4096))


def _fd_check(torch, label, q, k, v, lengths, tol, **kw):
    """flash_decode against its plain version on one batch: within ``tol``,
    exact zeros for length 0, bit-identical across two launches and with
    NaN in every position at or past each length. Returns the max error."""
    from senweaver_ide_tpu_torch.ops.flash_decode import (flash_decode,
                                                          flash_decode_plain)
    out = flash_decode(q, k, v, lengths, **kw)
    again = flash_decode(q, k, v, lengths, **kw)
    torch.cuda.synchronize()
    ref = flash_decode_plain(q.float(), k.float(), v.float(), lengths)
    diff = (out.float() - ref).abs()
    e = float(diff.max())
    atol, rtol = tol
    if not bool((diff <= atol + rtol * ref.abs()).all()):
        fail(f"flash_decode {label}: kernel vs plain max err {e} (tol "
             f"{atol} + {rtol} * |plain|)")
    if bool(out[lengths == 0].ne(0).any()):
        fail(f"flash_decode {label}: a length-0 slot is not 0")
    if not torch.equal(out, again):
        fail(f"flash_decode {label}: two launches on the same inputs "
             f"differ")
    kp, vp = k.clone(), v.clone()
    for i, n in enumerate(lengths.tolist()):
        kp[i, n:] = float("nan")
        vp[i, n:] = float("nan")
    out_p = flash_decode(q, kp, vp, lengths, **kw)
    torch.cuda.synchronize()
    if not torch.equal(out_p, out):
        fail(f"flash_decode {label}: poisoned positions past the lengths "
             f"moved the output")
    return e


def _fd_split_cases(torch, split_plan, sms):
    """bf16 batches at the split kernel's edges: (label, (Hq, Hkv, D), Smax,
    strided, lengths). Lengths 1, chunk - 1, chunk, chunk + 1 and Smax for
    the batch's own plan, and one past a tile; a short grid (heads 12/2 at
    B=1 and B=2: many splits); a strided view."""
    cases = []
    for model, smax, strided in (("mistral-7b", 4096, False),
                                 ("qwen2.5-coder-1.5b", 3000, True),
                                 ("qwen2.5-coder-0.5b", 1024, False)):
        heads = FD_HEADS[model]
        b = 8
        _, chunk = split_plan(b, heads[1], smax, sms)
        lens = [1, 65, chunk - 1, chunk, chunk + 1, 2 * chunk + 1,
                smax - 1, smax]
        cases.append((f"{model} split edges", heads, smax, strided, lens))
    heads = FD_HEADS["qwen2.5-coder-1.5b"]
    cases.append(("short grid B=1", heads, 4096, False, [4096]))
    _, chunk = split_plan(2, heads[1], 4096, sms)
    cases.append(("short grid B=2", heads, 4096, True, [chunk + 1, 4095]))
    return cases


def phase_flash_decode(torch, timer):
    """K3 (flash_decode over the contiguous slot cache) against its plain
    version on the card: three head shapes, bf16 and f32, lengths
    0..Smax on a tile-aligned and a ragged Smax and a strided cache view,
    then bf16 batches at the split kernel's chunk and tile edges and on
    short grids; poisoned positions at or past each length must leave the
    output bit-identical, and two launches must agree bit for bit. Then
    kernel / plain / SDPA times at 16 slots x 4096 positions at the
    Mistral-7B and the Qwen2.5-Coder-1.5B heads beside the bytes bound."""
    from senweaver_ide_tpu_torch.ops.flash_decode import split_plan
    g = torch.Generator(device="cuda").manual_seed(5)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    worst = {"bf16": 0.0, "f32": 0.0}

    def batch(hq, hkv, d, dtype, smax, strided, lens):
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        b = len(lens)
        q = torch.randn(b, hq, d, generator=g, device="cuda").to(dtype)
        rows = smax + 64 if strided else smax
        k = torch.randn(b, rows, hkv, d, generator=g,
                        device="cuda").to(dtype)[:, :smax]
        v = torch.randn(b, rows, hkv, d, generator=g,
                        device="cuda").to(dtype)[:, :smax]
        return q, k, v, lengths

    for model, (hq, hkv, d) in FD_HEADS.items():
        for dname, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            for smax, strided in ((2048, False), (1111, False), (640, True)):
                lens = sorted({0, 1, 127, 128, 129, min(1000, smax), smax})
                args = batch(hq, hkv, d, dtype, smax, strided, lens)
                label = (f"{model} heads {hq}/{hkv} D={d} {dname} Smax={smax}"
                         f"{' (strided view)' if strided else ''}")
                e = _fd_check(torch, label, *args, FD_TOL[dname],
                              allow_pad_copy=smax % 128 != 0)
                worst[dname] = max(worst[dname], e)
                log(f"[flash_decode] {label}, lengths {lens}: max |kernel - "
                    f"plain| {e:.3g}; poisoned tail and a second launch "
                    f"bit-identical")
    for label, (hq, hkv, d), smax, strided, lens in _fd_split_cases(
            torch, split_plan, sms):
        splits, chunk = split_plan(len(lens), hkv, smax, sms)
        args = batch(hq, hkv, d, torch.bfloat16, smax, strided, lens)
        label = (f"{label} heads {hq}/{hkv} D={d} bf16 Smax={smax}"
                 f"{' (strided view)' if strided else ''}, {splits} splits "
                 f"of {chunk}")
        e = _fd_check(torch, label, *args, FD_TOL["bf16"],
                      allow_pad_copy=smax % 128 != 0)
        worst["bf16"] = max(worst["bf16"], e)
        log(f"[flash_decode] {label}, lengths {lens}: max |kernel - plain| "
            f"{e:.3g}; poisoned tail and a second launch bit-identical")
    log(f"[flash_decode] worst max |kernel - plain|: bf16 {worst['bf16']:.3g}"
        f" (tol {FD_TOL['bf16'][0]} + {FD_TOL['bf16'][1]} * |plain|), f32 "
        f"{worst['f32']:.3g} (tol {FD_TOL['f32'][0]} + {FD_TOL['f32'][1]} * "
        f"|plain|)")
    rows = [_fd_time(torch, timer, g, t, sms) for t in FD_TIMINGS]
    worst["bf16"] = max([worst["bf16"]] + [r["max_abs_err"] for r in rows])
    return {**rows[0], "max_abs_err": worst["bf16"],
            "max_abs_err_f32": worst["f32"], "shapes": rows}


def _fd_time(torch, timer, g, t, sms):
    """Kernel, plain and SDPA times of one FD_TIMINGS row beside the
    bytes bound."""
    import torch.nn.functional as F
    from senweaver_ide_tpu_torch.ops.flash_decode import (flash_decode,
                                                          flash_decode_plain,
                                                          split_plan)
    hq, hkv, d = FD_HEADS[t["heads"]]
    b, smax = t["b"], t["smax"]
    lengths = torch.linspace(t["lo"], t["hi"], b, device="cuda").round().to(
        torch.int32)
    q = torch.randn(b, hq, d, generator=g, device="cuda").bfloat16()
    k = torch.randn(b, smax, hkv, d, generator=g, device="cuda").bfloat16()
    v = torch.randn(b, smax, hkv, d, generator=g, device="cuda").bfloat16()
    kernel_ms = timer.ms(lambda: flash_decode(q, k, v, lengths))
    plain_ms = timer.ms(lambda: flash_decode_plain(q, k, v, lengths),
                        iters=10)
    ref = flash_decode_plain(q.float(), k.float(), v.float(), lengths)
    diff = (flash_decode(q, k, v, lengths).float() - ref).abs()
    atol, rtol = FD_TOL["bf16"]
    if not bool((diff <= atol + rtol * ref.abs()).all()):
        fail(f"flash_decode timing batch {t['heads']}: kernel vs plain max "
             f"err {float(diff.max())}")
    positions = int(lengths.sum())
    # each live K and V element read once, q read and out written once,
    # the lengths read once
    nbytes = positions * hkv * d * 2 * 2 + 2 * q.numel() * 2 + b * 4
    flops = 4 * hq * d * positions
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / BF16_FLOPS * 1e3
    # yardstick only, never called by the port: SDPA over the cache's
    # (B, Hkv, S, D) strided view with a length mask
    qq = q[:, :, None, :]
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    mask = (torch.arange(smax, device="cuda")[None, :]
            < lengths[:, None])[:, None, None, :]
    try:
        F.scaled_dot_product_attention(qq, kt, vt, attn_mask=mask,
                                       enable_gqa=True)
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qq, kt, vt, attn_mask=mask, enable_gqa=True)
        sdpa_note = ("enable_gqa=True on the cache's strided (B, Hkv, S, D) "
                     "view with a boolean length mask; no copy made here")
    except TypeError:
        ke = kt.repeat_interleave(hq // hkv, 1)
        ve = vt.repeat_interleave(hq // hkv, 1)
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qq, ke, ve, attn_mask=mask)
        sdpa_note = ("K/V copied out to Hq heads beforehand (no enable_gqa),"
                     " boolean length mask")
    sdpa_ms = timer.ms(sdpa)
    splits, chunk = split_plan(b, hkv, smax, sms)
    bound = max(bytes_ms, ops_ms)
    log(f"[flash_decode] {t['heads']} B={b} Smax={smax} heads {hq}/{hkv} "
        f"D={d} bf16, lengths {t['lo']}..{t['hi']} (sum {positions}), "
        f"{splits} splits of {chunk} ({splits * hkv * b} blocks): kernel "
        f"{kernel_ms:.4f} ms = {nbytes / kernel_ms / 1e9:.3f} TB/s, "
        f"{bound / kernel_ms:.3f} of the bound; plain {plain_ms:.4f} ms, "
        f"bound {bound:.4f} ms ({nbytes} bytes at {HBM_BYTES_PER_S:.3g}/s, "
        f"{flops} flops at {BF16_FLOPS:.3g}/s), SDPA (yardstick only; "
        f"{sdpa_note}) {sdpa_ms:.4f} ms")
    return {"heads": t["heads"], "b": b, "smax": smax,
            "lengths": f"{t['lo']}..{t['hi']}", "splits": splits,
            "chunk": chunk, "max_abs_err": float(diff.max()),
            "kernel_ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "flops": flops, "library_ms": sdpa_ms,
            "library_note": "torch.nn.functional.scaled_dot_product_"
                            f"attention ({sdpa_note})"}


def _fa_err(out, ref, atol, rtol, scaled):
    """(max |kernel - plain_fp32|, whether every element is within atol +
    rtol * |plain| + scaled * max|plain| and the RMS error within
    FA_RMS_TOL of the plain version's RMS)"""
    diff = (out.float() - ref).abs()
    bound = atol + rtol * ref.abs() + scaled * ref.abs().max()
    rms_ok = diff.pow(2).mean().sqrt() <= FA_RMS_TOL * ref.pow(2).mean(
    ).sqrt() + 1e-12
    return float(diff.max()), bool((diff <= bound).all() and rms_ok)


def _fa_tol_text(tol):
    atol, rtol, scaled = tol
    text = f"{atol} + {rtol} * |plain|"
    if scaled:
        text += f" + {scaled} * max|plain|"
    return text + f", RMS error <= {FA_RMS_TOL} * RMS(plain)"


def _fa_case(torch, fa, g, b, s, hq, hkv, d, window=None, pad_from=None,
             dtype=None, skv=None, causal=True, q_offset=0, kv_offset=0):
    """q, k, v, dO (std 1, bf16 unless ``dtype``) and an optional kv_mask
    whose positions at or past ``pad_from[row]`` are invalid."""
    dtype = dtype or torch.bfloat16
    skv = skv or s

    def rnd(n, h):
        return torch.randn(b, n, h, d, generator=g, device="cuda").to(dtype)
    q, k, v, gout = rnd(s, hq), rnd(skv, hkv), rnd(skv, hkv), rnd(s, hq)
    bias = None
    if pad_from is not None:
        valid = (torch.arange(skv, device="cuda")[None, :]
                 < torch.tensor(pad_from, device="cuda")[:, None])
        bias = fa._bias_of(valid)
    return q, k, v, gout, bias, dict(q_offset=q_offset, kv_offset=kv_offset,
                                     causal=causal, window=window)


def _fa_run(fa, q, k, v, gout, bias, kw):
    """The three kernels on one case: (out, lse, dq, dk, dv)."""
    out, lse = fa.flash_attention_fwd(q, k, v, bias, **kw)
    delta = fa._delta(gout, out)
    dk, dv = fa.flash_attention_bwd_dkdv(q, k, v, bias, gout, lse, delta,
                                         **kw)
    dq = fa.flash_attention_bwd_dq(q, k, v, bias, gout, lse, delta, **kw)
    return out, lse, dq, dk, dv


def _fa_plain(fa, q, k, v, gout, bias, kw):
    """The plain versions on fp32 copies of the same inputs."""
    qf, kf, vf, gf = (x.float() for x in (q, k, v, gout))
    out, lse = fa.flash_attention_fwd_plain(qf, kf, vf, bias, **kw)
    dq, dk, dv = fa._bwd_plain(qf, kf, vf, bias, gf, lse,
                               fa._delta(gf, out), **kw)
    return out, lse, dq, dk, dv


def _visible_pairs(s, window=None):
    """(query, key) pairs a causal (windowed) S x S attention computes."""
    if window is None:
        return s * (s + 1) // 2
    w = min(window, s)
    return w * (w + 1) // 2 + (s - w) * w


def phase_flash(torch, cfg, timer):
    """The K2 kernels (flash-attention forward, dK/dV, dQ) against their
    plain versions at qwen2.5-coder-1.5b attention shapes, bf16, then
    their times at the training path's shape beside the bounds and SDPA."""
    import torch.nn.functional as F
    from senweaver_ide_tpu_torch.ops import flash_attention as fa
    hq, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    g = torch.Generator(device="cuda").manual_seed(3)
    names = ("out", "lse", "dq", "dk", "dv")
    worst = dict.fromkeys(names, 0.0)
    cases = [("causal B=4 S=1024", dict(b=4, s=1024)),
             ("ragged B=2 S=1000", dict(b=2, s=1000)),
             ("kv_mask padding B=2 S=768", dict(b=2, s=768,
                                                pad_from=[768, 517])),
             ("window 256 B=2 S=1000", dict(b=2, s=1000, window=256))]
    # the other instances the kernels build, off the training path: f32
    # (exact products: summation order only, so 1e-4), D=64
    # (qwen2.5-coder-0.5b heads 14/2), offsets and the non-causal path
    f32 = torch.float32
    others = [
        ("f32 causal B=2 S=300", dict(b=2, s=300, dtype=f32)),
        ("f32 offsets q 40 kv -25, Skv 333", dict(
            b=1, s=300, skv=333, q_offset=40, kv_offset=-25, dtype=f32)),
        ("f32 non-causal kv_mask", dict(b=2, s=200, causal=False,
                                        pad_from=[200, 77], dtype=f32)),
        ("bf16 D=64 window 37", dict(b=2, s=500, hq=14, hkv=2, d=64,
                                     window=37))]
    # bf16 edge paths of the tiled kernels (64-row / 64-position tiles):
    # a sequence under one tile, one past a tile boundary, offsets with
    # Skv != Sq, MHA (rep 1), the non-causal masked-tile branch with a
    # fully masked batch row
    others += [
        ("bf16 S=17 (under one tile)", dict(b=2, s=17)),
        ("bf16 S=65 (one past a tile)", dict(b=2, s=65)),
        ("bf16 S=1025 (one past a tile)", dict(b=1, s=1025)),
        ("bf16 offsets q 40 kv -25, Skv 333", dict(
            b=1, s=300, skv=333, q_offset=40, kv_offset=-25)),
        ("bf16 MHA heads 16/16 S=512", dict(b=1, s=512, hq=16, hkv=16)),
        ("bf16 non-causal kv_mask, batch row 1 fully masked", dict(
            b=2, s=200, causal=False, pad_from=[77, 0]))]
    path_cases = {label for label, _ in cases}
    for label, spec in cases + others:
        spec = {"hq": hq, "hkv": hkv, "d": d, **spec}
        args = _fa_case(torch, fa, g, **spec)
        got = _fa_run(fa, *args)
        torch.cuda.synchronize()
        if spec.get("dtype") is None:    # bf16: no atomics, fixed sums
            again = _fa_run(fa, *args)
            torch.cuda.synchronize()
            for name, a, b2 in zip(names, got, again):
                if not torch.equal(a, b2):
                    fail(f"flash {label}: {name} differs between two "
                         f"launches on the same inputs")
        ref = _fa_plain(fa, *args)
        errs = []
        for name, a, r in zip(names, got, ref):
            tol = FA_TOL_F32 if spec.get("dtype") == f32 else FA_TOL[name]
            e, ok = _fa_err(a, r, *tol)
            if not ok:
                fail(f"flash {label}: {name} kernel vs plain max err {e} "
                     f"(tol {_fa_tol_text(tol)})")
            if label in path_cases:      # the JSON line's max_abs_err
                worst[name] = max(worst[name], e)
            errs.append(f"{name} {e:.3g}")
        log(f"[flash] {label}: max |kernel - plain| " + ", ".join(errs)
            + ("" if spec.get("dtype") else "; two launches bit-identical"))

    # timing at the training path's shape: microbatch 4 x (1024 - 1)
    b, s = 4, 1023
    q, k, v, gout, bias, kw = _fa_case(torch, fa, g, b, s, hq, hkv, d)
    out, lse = fa.flash_attention_fwd(q, k, v, bias, **kw)
    delta = fa._delta(gout, out)
    t = {
        "fwd": timer.ms(lambda: fa.flash_attention_fwd(q, k, v, **kw)),
        "dkdv": timer.ms(lambda: fa.flash_attention_bwd_dkdv(
            q, k, v, None, gout, lse, delta, **kw)),
        "dq": timer.ms(lambda: fa.flash_attention_bwd_dq(
            q, k, v, None, gout, lse, delta, **kw)),
        "plain_fwd": timer.ms(lambda: fa.flash_attention_fwd_plain(
            q, k, v, **kw), iters=10),
        "plain_bwd": timer.ms(lambda: fa._bwd_plain(
            q, k, v, None, gout, lse, delta, **kw), iters=5),
    }
    # yardstick only, never called by the port: SDPA on (B, H, S, D)
    qt, kt_, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                   for x in (q, k, v))
    try:
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt_, vt, is_causal=True, enable_gqa=True)
        sdpa()
        gqa_note = "enable_gqa=True"
    except TypeError:
        kt_, vt = (x.detach().repeat_interleave(hq // hkv, 1)
                   .requires_grad_() for x in (kt_, vt))
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt_, vt, is_causal=True)
        gqa_note = "K/V expanded to Hq heads"
    with torch.no_grad():
        t["sdpa_fwd"] = timer.ms(sdpa)
    o_lib = sdpa()
    gt = gout.transpose(1, 2).contiguous()
    t["sdpa_bwd"] = timer.ms(lambda: torch.autograd.grad(
        o_lib, (qt, kt_, vt), gt, retain_graph=True))
    t["sdpa_fwd_bwd"] = timer.ms(lambda: torch.autograd.grad(
        sdpa(), (qt, kt_, vt), gt))

    pairs = _visible_pairs(s)
    el = 2                                     # bf16 bytes
    qb = b * s * hq * d * el
    kvb = b * s * hkv * d * el
    rowb = b * hq * s * 4                      # one f32 (B, Hq, S) array
    work = {   # flops the function needs on this run's data, and bytes
        "fwd": (4 * b * hq * d * pairs, qb + 2 * kvb + qb + rowb),
        "dkdv": (8 * b * hq * d * pairs, 2 * qb + 2 * kvb + 2 * rowb
                 + 2 * kvb),
        "dq": (6 * b * hq * d * pairs, 2 * qb + 2 * kvb + 2 * rowb + qb),
    }
    res = fa.kernel_resources(d)
    n_kt = -(-s // 64)
    grid = {"fwd": -(-s // 128) * hq * b, "dkdv": n_kt * hq * b,
            "dq": n_kt * hq * b}
    for kname, r in res.items():
        warps = r["threads"] // 32
        resident = r["blocks_per_sm"]
        log(f"[flash] {kname} bf16 D={d}: {r['registers']} registers/thread, "
            f"{r['smem_bytes']} dynamic smem bytes, {r['threads']} threads; "
            f"{resident} blocks/SM resident ({resident * warps} warps/SM); "
            f"grid {grid[kname]} blocks = {grid[kname] * warps} warps at "
            f"B={b} S={s}")
    log(f"[flash] dkdv longest serial walk at B={b} S={s}: {n_kt} (head, "
        f"64-row q tile) steps, KV tile 0 of each (q head, batch) block")
    log(f"[flash] dq grid at B={b} S={s}: 1-D, {grid['dq']} blocks of one "
        f"warpgroup (64 q rows), q tile slowest and reversed, so the causal "
        f"tiles that walk the most KV tiles ({n_kt}) start first")
    results = {}
    for kname, (flops, nbytes) in work.items():
        ops_ms = flops / BF16_FLOPS * 1e3
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        lib = t["sdpa_fwd"] if kname == "fwd" else t["sdpa_bwd"]
        plain = t["plain_fwd"] if kname == "fwd" else t["plain_bwd"]
        results[kname] = {
            "max_abs_err": max(worst[n] for n in FA_ERR_OF[kname]),
            "kernel_ms": t[kname], "plain_ms": plain,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "flops": flops, "bytes": nbytes, "library_ms": lib}
        log(f"[flash] {kname} at B={b} S={s} Hq={hq} Hkv={hkv} D={d} bf16 "
            f"causal: kernel {t[kname]:.4f} ms = "
            f"{flops / t[kname] / 1e9:.1f} TFLOP/s, "
            f"{max(ops_ms, bytes_ms) / t[kname]:.3f} of the bound; plain "
            f"{plain:.4f} ms, bound "
            f"{max(ops_ms, bytes_ms):.4f} ms ({flops} flops at "
            f"{BF16_FLOPS:.3g}/s, {nbytes} bytes at {HBM_BYTES_PER_S:.3g}/s)"
            f", SDPA {'fwd' if kname == 'fwd' else 'bwd'} {lib:.4f} ms")
    log(f"[flash] SDPA yardstick ({gqa_note}; reference only): fwd "
        f"{t['sdpa_fwd']:.4f} ms, bwd {t['sdpa_bwd']:.4f} ms, fwd+bwd "
        f"{t['sdpa_fwd_bwd']:.4f} ms; plain bwd (all three grads) "
        f"{t['plain_bwd']:.4f} ms")
    return results


def _drive(torch, engine, launches_of):
    """Run the engine to completion; returns (wall s, per-step ms,
    launches) with the launch count zeroed just before."""
    launches_of(0)
    torch.cuda.synchronize()
    step_ms = []
    t0 = time.perf_counter()
    while engine.has_work:
        s = time.perf_counter()
        engine.step()           # ends in the step's device→host copy
        step_ms.append((time.perf_counter() - s) * 1e3)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, step_ms, launches_of(None)


def phase_serve(torch, cfg, params, seed, smi):
    import numpy as np
    from senweaver_ide_tpu_torch.ops.paged_attention import \
        paged_flash_decode
    from senweaver_ide_tpu_torch.rollout import (EngineConfig,
                                                 RolloutEngine,
                                                 SampleParams)

    def launches_of(reset):
        if reset is not None:
            paged_flash_decode.launches = reset
        return paged_flash_decode.launches

    rng = np.random.default_rng(seed)
    layers = cfg.num_layers
    out = {}

    # -- the main path: 32 sampled requests on the default bf16 pool -----
    engine = RolloutEngine(params, cfg, num_slots=16, max_len=2048,
                           seed=seed, device="cuda")
    if engine.stats()["paged_kernel"] != 1:
        fail("engine on CUDA did not select the paged kernel")
    lens = rng.integers(128, 1025, size=32)
    rids = [engine.submit(rng.integers(0, cfg.vocab_size,
                                       size=int(n)).tolist(),
                          max_new_tokens=128) for n in lens]
    torch.cuda.reset_peak_memory_stats()
    wall, step_ms, launches = _drive(torch, engine, launches_of)
    st = engine.stats()
    steps = st["decode_steps"]
    for rid, n in zip(rids, lens):
        toks, logps = engine.result(rid), engine.result_logps(rid)
        if not engine.is_done(rid):
            fail(f"request {rid} did not finish")
        if len(toks) != 128 and n + len(toks) < engine.context_bound - 1:
            fail(f"request {rid} stopped at {len(toks)} tokens")
        if not all(np.isfinite(logps)) or max(logps) > 0:
            fail(f"request {rid} has a non-finite or positive log-prob")
    if launches != layers * steps:
        fail(f"kernel launches {launches} != {layers} layers x {steps} "
             f"fused steps")
    engine._alloc.check_leaks()
    gen = st["tokens_emitted"]
    out["bf16"] = launches
    log(f"[serve] {cfg.name} bf16 pool, 32 requests (prompts "
        f"{int(lens.min())}..{int(lens.max())}, 128 new tokens, "
        f"SampleParams()), {smi}: wall {wall:.2f} s, {steps} fused steps, "
        f"{gen} tokens generated = {gen / wall:.1f} tok/s, "
        f"{st['prefill_tokens']} prefill tokens, "
        f"p50 step {statistics.median(step_ms):.2f} ms, "
        f"p90 step {statistics.quantiles(step_ms, n=10)[-1]:.2f} ms, "
        f"max_memory_allocated {torch.cuda.max_memory_allocated()} bytes, "
        f"kernel launches {launches} = {layers} x {steps}")
    del engine

    # -- short greedy runs on every ladder rung --------------------------
    greedy = SampleParams(0.0, 0, 1.0)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).tolist()
               for n in rng.integers(128, 513, size=8)]
    streams = {}
    for rung in ("bf16", "int8", "fp8"):
        eng = RolloutEngine(params, cfg, num_slots=8, max_len=2048,
                            sample=greedy, seed=seed, device="cuda",
                            engine_config=EngineConfig(kv_dtype=rung))
        rids = [eng.submit(p, max_new_tokens=32) for p in prompts]
        wall, step_ms, launches = _drive(torch, eng, launches_of)
        steps = eng.stats()["decode_steps"]
        if launches != layers * steps or launches == 0:
            fail(f"{rung} ladder: launches {launches} != {layers} x {steps}")
        streams[rung] = [eng.result(r) for r in rids]
        if any(len(s) != 32 for s in streams[rung]):
            fail(f"{rung} ladder: a greedy request stopped early")
        eng._alloc.check_leaks()
        if rung != "bf16":
            out[rung] = launches
        match = np.mean([a == b for sa, sb in zip(streams["bf16"],
                                                  streams[rung])
                         for a, b in zip(sa, sb)])
        log(f"[serve] greedy {rung} ladder, 8 requests x 32 tokens: "
            f"{steps} fused steps, wall {wall:.2f} s, launches {launches}, "
            f"greedy token match vs bf16 pool {match:.3f}")
        del eng
    return out


def phase_logits(torch, cfg, params):
    """One fused step on the same pool state, kernel vs plain path, and
    the kernel path vs the no-cache forward over each entry's whole
    sequence (prefill then a step through the paged cache must give the
    full forward's logits)."""
    from senweaver_ide_tpu_torch.models import forward, forward_paged
    from senweaver_ide_tpu_torch.rollout import init_paged_pool
    bs, mb = 16, 128
    lens = [300, 700, 1500, 40]
    pool = init_paged_pool(cfg, len(lens) * mb, bs, device="cuda")
    tables = torch.arange(len(lens) * mb, dtype=torch.int32).view(-1, mb)
    g = torch.Generator().manual_seed(7)
    seqs = [torch.randint(0, cfg.vocab_size, (n + 32,), generator=g)
            for n in lens]

    def batch(entries):
        cols = list(zip(*entries))
        return dict(tokens=torch.tensor(cols[0]), seq_row=torch.tensor(
            cols[1]), positions=torch.tensor(cols[2]),
            write_block=torch.tensor(cols[3]),
            write_off=torch.tensor(cols[4]))

    def entry(row, pos, drop=False):
        wb = pool.num_blocks if drop else int(tables[row, pos // bs])
        return (int(seqs[row][pos]), row, pos, wb, pos % bs)

    # prefill every row with the kernel path, 256 tokens a call
    flat = [entry(r, p) for r, n in enumerate(lens) for p in range(n)]
    for i in range(0, len(flat), 256):
        forward_paged(params, cfg, pool=pool, tables=tables,
                      use_kernel=True, **batch(flat[i:i + 256]))
    # the compared step: decodes, a 32-token prefill chunk, a dropped write
    step = ([entry(r, lens[r]) for r in range(3)]
            + [entry(3, p) for p in range(lens[3], lens[3] + 32)]
            + [entry(0, 10, drop=True)])
    pools = [type(pool)(*(None if a is None else a.clone() for a in pool))
             for _ in range(2)]
    logits = [forward_paged(params, cfg, pool=p, tables=tables,
                            use_kernel=k, **batch(step))[0]
              for p, k in zip(pools, (True, False))]
    torch.cuda.synchronize()
    diff = (logits[0] - logits[1]).abs().max().item()
    agree = (logits[0].argmax(-1) == logits[1].argmax(-1)).float().mean()
    scale = logits[1].abs().max().item()
    log(f"[logits] one fused step ({len(step)} entries), kernel vs plain: "
        f"max |dlogit| {diff:.4g} (tol {LOGITS_ATOL}; max |logit| "
        f"{scale:.3g}), argmax agreement {float(agree):.3f}")
    if not diff <= LOGITS_ATOL:
        fail(f"kernel vs plain fused-step logits differ by {diff}")
    kv_diff = max((a.float() - b.float()).abs().max().item()
                  for a, b in zip(pools[0].k, pools[1].k))
    log(f"[logits] pools after the step, kernel vs plain path: max |dk| "
        f"{kv_diff:.4g}")
    ref_diff = 0.0
    for i, (_, row, pos, _, _) in enumerate(step):
        ref = forward(params, cfg, seqs[row][None, :pos + 1].cuda())[0, -1]
        ref_diff = max(ref_diff, (logits[0][i] - ref).abs().max().item())
    log(f"[logits] same step through the paged cache and kernel vs the "
        f"no-cache forward over each entry's sequence: max |dlogit| "
        f"{ref_diff:.4g} (tol {LOGITS_ATOL})")
    if not ref_diff <= LOGITS_ATOL:
        fail(f"paged step vs no-cache forward logits differ by {ref_diff}")


def _engine_logits(torch, engine, prompt):
    """Last-position logits of ``prompt`` through the engine's params and
    the paged path it serves with (a private pool, kernel K1)."""
    from senweaver_ide_tpu_torch.models import forward_paged
    from senweaver_ide_tpu_torch.rollout import init_paged_pool
    bs, n = 16, len(prompt)
    nb = -(-n // bs)
    pool = init_paged_pool(engine.config, nb, bs, device="cuda")
    pos = torch.arange(n)
    with torch.no_grad():
        logits, _ = forward_paged(
            engine.params, engine.config, torch.tensor(prompt), pool=pool,
            tables=torch.arange(nb, dtype=torch.int32)[None],
            seq_row=torch.zeros(n, dtype=torch.long), positions=pos,
            write_block=pos // bs, write_off=pos % bs, use_kernel=True)
    return logits[-1].clone()


def _stand_in_reward(tokens):
    """Stand-in for the trace reward head (sessions slice): the share of
    even token ids in the completion."""
    return sum(1 for t in tokens if t % 2 == 0) / max(len(tokens), 1)


def phase_train(torch, cfg, params, seed, smi):
    """One GRPO round at full width with attn_impl="flash": the engine
    samples 4 prompts x 4 completions with behaviour log-probs (K1), three
    train_steps run the flash-attention kernels forward and backward (K2),
    update_params publishes the weights and the engine serves again."""
    import dataclasses

    import numpy as np
    from senweaver_ide_tpu_torch.models.transformer import count_params
    from senweaver_ide_tpu_torch.ops import flash_attention as fa
    from senweaver_ide_tpu_torch.ops.paged_attention import \
        paged_flash_decode
    from senweaver_ide_tpu_torch.rollout import RolloutEngine
    from senweaver_ide_tpu_torch.training import (Trajectory, make_batch,
                                                  make_batch_logps,
                                                  make_optimizer,
                                                  make_train_state,
                                                  train_step)
    tcfg = dataclasses.replace(cfg, attn_impl="flash", remat=TRAIN_REMAT)
    layers = tcfg.num_layers
    rng = np.random.default_rng(seed + 1)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).tolist()
               for n in rng.integers(256, 769, size=TRAIN_PROMPTS)]

    # 1. rollout: a group of completions per prompt, behaviour log-probs
    engine = RolloutEngine(params, tcfg, num_slots=16, max_len=2048,
                           seed=seed, device="cuda")
    probe_before = _engine_logits(torch, engine, prompts[0])
    subs = [(gi, engine.submit(p, max_new_tokens=TRAIN_NEW_TOKENS))
            for gi, p in enumerate(prompts) for _ in range(TRAIN_GROUP)]
    paged_flash_decode.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.run()
    torch.cuda.synchronize()
    roll_s = time.perf_counter() - t0
    k1 = paged_flash_decode.launches
    steps = engine.stats()["decode_steps"]
    if k1 != layers * steps:
        fail(f"rollout: K1 launches {k1} != {layers} x {steps} fused steps")
    # 2. stand-in reward; 3. the batch
    trajs = []
    for gi, rid in subs:
        toks, logps = engine.result(rid), engine.result_logps(rid)
        if len(toks) != TRAIN_NEW_TOKENS or not np.all(np.isfinite(logps)):
            fail(f"rollout request {rid}: {len(toks)} tokens, finite "
                 f"log-probs {bool(np.all(np.isfinite(logps)))}")
        trajs.append(Trajectory(prompt_ids=prompts[gi], completion_ids=toks,
                                reward=_stand_in_reward(toks), group_id=gi,
                                behavior_logp=logps))
    tokens, mask, rewards, gids = make_batch(trajs, pad_id=0)
    old_logp = make_batch_logps(trajs, tokens, mask)
    b, s = tokens.shape
    log(f"[train] rollout: {len(subs)} completions ({TRAIN_PROMPTS} prompts "
        f"x {TRAIN_GROUP}, prompts {min(map(len, prompts))}.."
        f"{max(map(len, prompts))} tokens, {TRAIN_NEW_TOKENS} new, "
        f"SampleParams()) in {roll_s:.2f} s, {steps} fused steps, K1 "
        f"launches {k1} = {layers} x {steps}; stand-in reward (share of "
        f"even token ids, not the trace reward head) mean "
        f"{float(rewards.mean()):.4f}; batch tokens {b} x {s}")

    # 4. three train_steps with the flash kernels
    state = make_train_state(tcfg, params=params,
                             optimizer=make_optimizer(TRAIN_LR))
    watch = {k: params["layers"][k].clone() for k in ("wq", "w_down")}
    for w in (fa.flash_attention_fwd, fa.flash_attention_bwd_dkdv,
              fa.flash_attention_bwd_dq):
        w.launches = 0
    torch.cuda.reset_peak_memory_stats()
    step_s, hist = [], []
    for i in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = train_step(state, tcfg, None, tokens, mask,
                                    rewards, gids, old_logp=old_logp,
                                    num_groups=TRAIN_PROMPTS,
                                    accum_steps=TRAIN_ACCUM)
        m = {k: float(v) for k, v in metrics.items()}   # syncs the step
        step_s.append(time.perf_counter() - t0)
        hist.append(m)
        bad = [k for k, v in m.items() if not np.isfinite(v)]
        if bad:
            fail(f"train step {i + 1}: non-finite {bad}")
        log(f"[train] step {i + 1}: {step_s[-1]:.3f} s, " + ", ".join(
            f"{k} {v:.6g}" for k, v in sorted(m.items())))
    launches = {"fwd": fa.flash_attention_fwd.launches,
                "dkdv": fa.flash_attention_bwd_dkdv.launches,
                "dq": fa.flash_attention_bwd_dq.launches}
    per_pass = layers * TRAIN_ACCUM * TRAIN_STEPS
    expect = {"fwd": per_pass * (2 if TRAIN_REMAT else 1),
              "dkdv": per_pass, "dq": per_pass}
    if launches != expect:
        fail(f"K2 launches {launches} != expected {expect} ({layers} layers "
             f"x accum {TRAIN_ACCUM} x {TRAIN_STEPS} steps, forward x2 "
             f"under remat)")
    ratio_err = abs(hist[0]["ratio_mean"] - 1.0)
    if not ratio_err < RATIO_TOL:
        fail(f"first step |ratio_mean - 1| = {ratio_err} >= {RATIO_TOL}: "
             f"behaviour log-probs (K1 serving path) and training log-probs "
             f"(K2) disagree")
    moved = {k: float((params["layers"][k].float() - v.float()).abs().max())
             for k, v in watch.items()}
    if not all(d > 0 for d in moved.values()):
        fail(f"params did not change: max |delta| {moved}")
    peak = torch.cuda.max_memory_allocated()

    # 5. publish, check the engine's logits moved, serve one more group
    engine.update_params(state.params)
    probe_after = _engine_logits(torch, engine, prompts[0])
    dlogit = float((probe_after - probe_before).abs().max())
    if not dlogit > 0:
        fail("engine logits did not change after update_params")
    rids = [engine.submit(prompts[0], max_new_tokens=TRAIN_NEW_TOKENS)
            for _ in range(TRAIN_GROUP)]
    engine.run()
    for rid in rids:
        lp = engine.result_logps(rid)
        if len(lp) != TRAIN_NEW_TOKENS or not np.all(np.isfinite(lp)):
            fail(f"post-update request {rid} did not finish cleanly")
    engine._alloc.check_leaks()

    n_params = count_params(params)
    tok = b * (s - 1)
    comp = int(mask[:, 1:].sum())
    pairs = _visible_pairs(s - 1)
    attn = 12 * b * tcfg.num_heads * tcfg.head_dim * pairs * layers
    model_flops = 6 * n_params * tok + attn
    med = statistics.median(step_s)
    log(f"[train] {tcfg.name}, {layers} layers, {tcfg.dtype}, attn_impl=flash, "
        f"remat={TRAIN_REMAT}, accum_steps {TRAIN_ACCUM}, lr {TRAIN_LR}, "
        f"{smi}. Smoke figures, not a benchmark: step seconds "
        f"{', '.join(f'{x:.3f}' for x in step_s)} (median {med:.3f}), "
        f"{tok / med:.0f} trained tokens/s ({tok} positions a step, {comp} "
        f"of them completion tokens), peak max_memory_allocated {peak} "
        f"bytes, analytic model-FLOPs share {model_flops / med / BF16_FLOPS:.4f}"
        f" (6 x {n_params} params x {tok} tokens + {attn} attention flops "
        f"a step, over {BF16_FLOPS:.3g} FLOP/s bf16)")
    log(f"[train] first step |ratio_mean - 1| {ratio_err:.3g} (tol "
        f"{RATIO_TOL}); params moved (max |delta| {moved}); engine logits "
        f"max |delta| after update_params {dlogit:.4g}; K2 launches "
        f"{launches} = expected")
    return launches


def phase_round(torch, cfg, params, seed, smi):
    """The online GRPO round at full width: 2 tasks x 4 agent sessions on
    one shared engine (K1), every episode scored by the trace reward
    head on the card, grpo_round's update with the flash kernels (K2),
    then the publish and one more session."""
    import dataclasses
    import functools
    import tempfile

    import numpy as np
    from senweaver_ide_tpu_torch import obs
    from senweaver_ide_tpu_torch.models import ByteTokenizer
    from senweaver_ide_tpu_torch.ops import flash_attention as fa
    from senweaver_ide_tpu_torch.ops.paged_attention import \
        paged_flash_decode
    from senweaver_ide_tpu_torch.rollout import (EnginePolicyClient,
                                                 RolloutEngine,
                                                 RolloutSession,
                                                 SampleParams)
    from senweaver_ide_tpu_torch.training import (grpo_round,
                                                  make_optimizer,
                                                  make_train_state)
    tcfg = dataclasses.replace(cfg, attn_impl="flash", remat=TRAIN_REMAT)
    layers = tcfg.num_layers
    tok = ByteTokenizer()
    # tracing on, and a fresh runtime ledger: the checks below read only
    # what this phase recorded
    obs.set_profiler(obs.RuntimeProfiler())
    tracer = obs.enable()
    tracer.clear()
    engine = RolloutEngine(params, tcfg, num_slots=ROUND_SLOTS,
                           max_len=ROUND_MAX_LEN, sample=SampleParams(),
                           eos_id=tok.eos_id, seed=seed, device="cuda")
    work = tempfile.mkdtemp(prefix="chip_smoke_round_")
    sessions = []

    def make_session():
        client = EnginePolicyClient(
            engine, tok, model_name=tcfg.name,
            default_max_new_tokens=ROUND_NEW_TOKENS, record_calls=True)
        sess = RolloutSession(client, os.path.join(work, f"ws{len(sessions)}"),
                              include_tool_definitions=False)
        sessions.append(sess)
        return sess

    state = make_train_state(tcfg, params=params,
                             optimizer=make_optimizer(TRAIN_LR))
    steps0 = engine.stats()["decode_steps"]
    k2 = (fa.flash_attention_fwd, fa.flash_attention_bwd_dkdv,
          fa.flash_attention_bwd_dq)
    paged_flash_decode.launches = 0
    for w in k2:
        w.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = grpo_round(state, tcfg, None, make_session, list(ROUND_TASKS),
                     group_size=ROUND_GROUP, pad_id=tok.pad_id,
                     max_len=ROUND_MAX_LEN, max_parallel=ROUND_SLOTS,
                     accum_steps=ROUND_ACCUM, ppo_epochs=ROUND_EPOCHS,
                     engine=engine)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"k1": paged_flash_decode.launches,
                "fwd": fa.flash_attention_fwd.launches,
                "dkdv": fa.flash_attention_bwd_dkdv.launches,
                "dq": fa.flash_attention_bwd_dq.launches}
    spans = {}
    for rec in tracer.spans():
        spans.setdefault(rec.name, []).append(rec.duration_ms / 1e3)
    ledger = obs.get_profiler().ledger()
    obs.disable()

    # every episode traced and scored by the card head
    n_eps = len(ROUND_TASKS) * ROUND_GROUP
    if len(out.episodes) != n_eps or len(sessions) != n_eps:
        fail(f"round: {len(out.episodes)} episodes from {len(sessions)} "
             f"sessions, expected {n_eps}")
    traces = []
    for i, sess in enumerate(sessions):
        trs = sess.collector.get_all_traces()
        if len(trs) != 1:
            fail(f"episode {i}: {len(trs)} traces")
        traces.append(trs[0])
    head_err = _check_trace_head(torch, traces, "round")
    rewards = [e.reward for e in out.episodes]
    if [e.task_idx for e in out.episodes] != sorted(
            e.task_idx for e in out.episodes):
        fail("round episodes are not in (task_idx, g) order")

    # launches: K1 per fused step of the collection, K2 per microbatch
    steps = engine.stats()["decode_steps"] - steps0
    if launches["k1"] != layers * steps:
        fail(f"round: K1 launches {launches['k1']} != {layers} x {steps} "
             f"fused steps")
    per_pass = layers * ROUND_ACCUM * ROUND_EPOCHS
    expect = {"fwd": per_pass * (2 if TRAIN_REMAT else 1),
              "dkdv": per_pass, "dq": per_pass}
    got = {k: launches[k] for k in expect}
    if got != expect:
        fail(f"round: K2 launches {got} != expected {expect}")
    m = out.metrics
    bad = [k for k, v in list(m.items()) + list(out.health.items())
           if not np.isfinite(v)]
    if bad or not m:
        fail(f"round: non-finite or missing metrics {bad or m}")
    ratio_err = abs(m["ratio_mean"] - 1.0)
    if not ratio_err < RATIO_TOL:
        fail(f"round: |ratio_mean - 1| = {ratio_err} >= {RATIO_TOL}")
    missing = [n for n in ROUND_SPANS if n not in spans]
    if missing:
        fail(f"round: spans missing {missing} (have {sorted(spans)})")
    missing = [n for n in ROUND_LEDGER if n not in ledger]
    if missing:
        fail(f"round: runtime ledger entries missing {missing}")
    stats = engine.stats()
    missing = [k for k in JAX_STATS_KEYS_PAGED if k not in stats]
    if missing:
        fail(f"engine stats() lacks JAX keys {missing}")

    # publish, one more session, no leaked blocks
    engine.update_params(out.state.params)
    more = make_session()
    try:
        turn = more.run_turn(ROUND_TASKS[0])
    finally:
        more.close()
    if turn.trace is None or turn.trace.summary.final_reward is None:
        fail("post-publish session produced no scored trace")
    engine._alloc.check_leaks()

    gen = sum(len(t.completion_ids) for t in out.trajectories)
    collect_s = sum(spans["collect"])
    calls = sum(e.n_calls for e in out.episodes)
    log(f"[round] {tcfg.name}, {layers} layers, {tcfg.dtype}: "
        f"{len(ROUND_TASKS)} tasks x {ROUND_GROUP} agent sessions on one "
        f"paged engine ({ROUND_SLOTS} slots, max_len {ROUND_MAX_LEN}, "
        f"SampleParams(), ByteTokenizer, include_tool_definitions=False), "
        f"{calls} LLM calls, {len(out.trajectories)} trajectories, prompts "
        f"{min(len(t.prompt_ids) for t in out.trajectories)}.."
        f"{max(len(t.prompt_ids) for t in out.trajectories)} tokens, "
        f"{gen} generated; K1 launches {launches['k1']} = {layers} x "
        f"{steps} fused steps; K2 {got} = expected")
    log(f"[round] {smi}. Smoke figures, not a benchmark: round wall "
        f"{wall:.3f} s; collect_s {collect_s:.3f}, batch_build_s "
        f"{sum(spans['batch_build']):.3f}, train_s "
        f"{sum(spans['train_step']):.3f}; {gen / collect_s:.1f} generated "
        f"tokens/s over the collection")
    log(f"[round] rewards from the trace reward head on the card over "
        f"random weights (not a learning signal): {sorted(set(rewards))}; "
        f"zero_advantage_group_fraction "
        f"{out.health.get('zero_advantage_group_fraction')}; card vs host "
        f"head max |diff| {head_err:.3g} (tol {HEAD_TOL}); |ratio_mean - 1| "
        f"{ratio_err:.3g} (tol {RATIO_TOL}); loss {m['loss']:.6g}, "
        f"grad_norm {m['grad_norm']:.6g}; update_skipped "
        f"{out.update_skipped}")
    return launches


def _check_trace_head(torch, traces, where):
    """Every trace scored by the head on the card (per-trace scores in its
    summary, then the batched head) against the plain head on the host:
    the same dims, values within HEAD_TOL. Returns the worst |diff|."""
    from senweaver_ide_tpu_torch.rewards import reward_head, score_traces
    from senweaver_ide_tpu_torch.rewards.head import DIM_NAMES
    from senweaver_ide_tpu_torch.traces import batch_features
    for i, t in enumerate(traces):
        if t.summary.final_reward is None or not t.summary.reward_dimensions:
            fail(f"{where}: trace {i} is unscored (final_reward "
                 f"{t.summary.final_reward})")
    host = reward_head(torch.from_numpy(batch_features(traces)))
    head_err = 0.0
    for i, t in enumerate(traces):
        dims = {d["name"]: d["value"] for d in t.summary.reward_dimensions}
        want = {DIM_NAMES[j]: float(host.dims[i, j])
                for j in range(len(DIM_NAMES)) if host.mask[i, j] > 0.5}
        if set(want) != set(dims):
            fail(f"{where}: trace {i}: card head dims {sorted(dims)} != "
                 f"host head dims {sorted(want)}")
        head_err = max([head_err, abs(t.summary.final_reward
                                      - float(host.final_reward[i]))]
                       + [abs(dims[k] - v) for k, v in want.items()])
    batch = score_traces(traces).cpu()      # the batched head on the card
    head_err = max(head_err, float((batch - host.final_reward).abs().max()))
    if not head_err <= HEAD_TOL:
        fail(f"{where}: trace reward head, card vs host differ by "
             f"{head_err} (tol {HEAD_TOL})")
    return head_err


def _scratch_dir(need_bytes, prefix):
    """A new directory under whichever of the temp dir and the checkout's
    git-ignored build dir has the most free space; fails below
    ``need_bytes``."""
    import shutil
    import tempfile
    here = os.path.dirname(os.path.abspath(__file__))
    roots = [tempfile.gettempdir(),
             os.path.join(here, "senweaver_ide_tpu_torch", "_build")]
    for r in roots:
        os.makedirs(r, exist_ok=True)
    free = {r: shutil.disk_usage(r).free for r in roots}
    root = max(roots, key=free.get)
    log(f"[disk] free bytes {free}; {prefix} needs {need_bytes}, under "
        f"{root}")
    if free[root] < need_bytes:
        fail(f"{prefix}: {free[root]} bytes free under {root}, need "
             f"{need_bytes}")
    return tempfile.mkdtemp(prefix=prefix, dir=root)


def _tree_bytes(tree):
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def _leaves(tree):
    from senweaver_ide_tpu_torch.training.trainer import flatten_params
    return [t for _, t in flatten_params(tree)]


def _bits_equal(torch, a, b):
    """Two param dicts hold the same names and the same bits."""
    from senweaver_ide_tpu_torch.training.trainer import flatten_params
    fa, fb = dict(flatten_params(a)), dict(flatten_params(b))
    if sorted(fa) != sorted(fb):
        return False
    return all(fa[k].dtype == fb[k].dtype and fa[k].shape == fb[k].shape
               and torch.equal(fa[k].view(torch.uint8),
                               fb[k].view(torch.uint8))
               for k in fa)


def hf_key_set(cfg):
    """The HF names of a dense checkpoint of ``cfg``, as JAX's
    ``export_hf_params`` writes them."""
    keys = ["model.embed_tokens.weight", "model.norm.weight"]
    if not cfg.tie_word_embeddings:
        keys.append("lm_head.weight")
    per = ["input_layernorm.weight", "post_attention_layernorm.weight"]
    per += [f"self_attn.{m}_proj.weight" for m in "qkvo"]
    per += [f"mlp.{m}_proj.weight" for m in ("gate", "up", "down")]
    if cfg.qkv_bias:
        per += [f"self_attn.{m}_proj.bias" for m in "qkv"]
    if cfg.qk_norm:
        per += ["self_attn.q_norm.weight", "self_attn.k_norm.weight"]
    keys += [f"model.layers.{i}.{k}" for i in range(cfg.num_layers)
             for k in per]
    return sorted(keys)


def phase_hf(torch, cfg, params, smi):
    """HF safetensors out and back in at full width: export the trained
    weights, list the keys, load them onto the card, hold every tensor and
    one prompt's logits bit for bit against the source."""
    import shutil

    from senweaver_ide_tpu_torch.models import (available_hf_keys,
                                                export_hf_params, forward,
                                                load_hf_params)
    nbytes = _tree_bytes(params)
    out_dir = _scratch_dir(int(nbytes * 1.1), "chip_smoke_hf_")
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = export_hf_params(params, cfg, out_dir)
        export_s = time.perf_counter() - t0
        file_bytes = os.path.getsize(path)
        keys = available_hf_keys(out_dir)
        want = hf_key_set(cfg)
        if keys != want:
            fail(f"hf: {len(keys)} keys in the export, expected "
                 f"{len(want)}; missing {sorted(set(want) - set(keys))[:5]}"
                 f", extra {sorted(set(keys) - set(want))[:5]}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loaded = load_hf_params(out_dir, cfg, device="cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    if not _bits_equal(torch, loaded, params):
        fail("hf: the loaded tree is not bit-identical to the exported one")
    g = torch.Generator().manual_seed(12)
    prompt = torch.randint(0, cfg.vocab_size, (1, 256), generator=g).cuda()
    with torch.no_grad():
        a = forward(params, cfg, prompt)
        b = forward(loaded, cfg, prompt)
    if not torch.equal(a, b):
        fail(f"hf: logits of the loaded weights differ from the source's "
             f"(max |diff| {float((a - b).abs().max())})")
    n = sum(t.numel() for t in _leaves(params))
    log(f"[hf] {cfg.name}: {n} params, {len(keys)} tensors "
        f"(= {cfg.num_layers} x {(len(keys) - 2) // cfg.num_layers} + "
        f"embed_tokens + norm, tied head), model.safetensors "
        f"{file_bytes} bytes; every loaded tensor and one 256-token "
        f"prompt's logits bit-identical to the source")
    log(f"[hf] {smi}: export {export_s:.3f} s "
        f"({file_bytes / export_s / 1e9:.3f} GB/s), load onto the card "
        f"{load_s:.3f} s ({file_bytes / load_s / 1e9:.3f} GB/s)")
    return loaded, {"export_s": export_s, "load_s": load_s,
                    "bytes": file_bytes}


def phase_online(torch, cfg, params, seed, smi):
    """The online improvement loop at full width on the loaded weights:
    two rounds (APO and GRPO both firing, the KL anchor refreshed each
    round), a checkpoint, a resume into a new loop on the same engine, and
    a greedy request before and after that must agree."""
    import dataclasses
    import shutil

    import numpy as np
    from senweaver_ide_tpu_torch import obs
    from senweaver_ide_tpu_torch.apo import APOConfig, make_local_apo
    from senweaver_ide_tpu_torch.apo.eval import outcome_feedback
    from senweaver_ide_tpu_torch.models import ByteTokenizer
    from senweaver_ide_tpu_torch.ops import flash_attention as fa
    from senweaver_ide_tpu_torch.ops.paged_attention import \
        paged_flash_decode
    from senweaver_ide_tpu_torch.rollout import (EnginePolicyClient,
                                                 RolloutEngine,
                                                 RolloutSession,
                                                 SampleParams)
    from senweaver_ide_tpu_torch.traces import TraceCollector
    from senweaver_ide_tpu_torch.training import (CheckpointManager,
                                                  GRPOConfig,
                                                  OnlineImprovementLoop,
                                                  make_optimizer,
                                                  make_train_state)
    from senweaver_ide_tpu_torch.training.online import ANCHOR_FILE
    tcfg = dataclasses.replace(cfg, attn_impl="flash", remat=TRAIN_REMAT)
    layers = tcfg.num_layers
    tok = ByteTokenizer()
    obs.set_profiler(obs.RuntimeProfiler())
    tracer = obs.enable()
    tracer.clear()
    engine = RolloutEngine(params, tcfg, num_slots=ROUND_SLOTS,
                           max_len=ROUND_MAX_LEN, sample=SampleParams(),
                           eos_id=tok.eos_id, seed=seed, device="cuda")
    collector = TraceCollector()            # scores on the card
    work = _scratch_dir(0, "chip_smoke_online_ws_")
    n_sessions = [0]

    def make_session(rules=None, thread_id=None):
        n_sessions[0] += 1
        client = EnginePolicyClient(
            engine, tok, model_name=tcfg.name,
            default_max_new_tokens=ROUND_NEW_TOKENS, record_calls=True)
        return RolloutSession(
            client, os.path.join(work, f"ws{n_sessions[0]}"),
            apo_rules=list(rules or []),
            thread_id=thread_id or f"apo-eval-{n_sessions[0]}",
            collector=collector, include_tool_definitions=False)

    optimizer = _CountingClient(
        EnginePolicyClient(engine, tok, model_name=tcfg.name))

    def make_apo():
        return make_local_apo(
            collector, optimizer, config=APOConfig(**ONLINE_APO),
            make_session=make_session, eval_tasks=ROUND_TASKS[:1],
            max_tokens=ROUND_NEW_TOKENS, device="cuda")

    loop_kw = dict(collector=collector, engine=engine,
                   group_size=ROUND_GROUP, pad_id=tok.pad_id,
                   max_len=ROUND_MAX_LEN,
                   grpo_config=GRPOConfig(kl_coef=ONLINE_KL),
                   max_parallel=ROUND_SLOTS, feedback_fn=outcome_feedback,
                   anchor_every=ONLINE_ANCHOR_EVERY, checkpoint_every=0,
                   accum_steps=ROUND_ACCUM)
    ck_root = None
    try:
        state = make_train_state(tcfg, params=params,
                                 optimizer=make_optimizer(TRAIN_LR))
        need = 4 * _tree_bytes(params) + (1 << 30)  # params, mu, nu, anchor
        ck_root = _scratch_dir(need, "chip_smoke_ckpt_")
        mgr = CheckpointManager(ck_root, keep_last=1)
        loop = OnlineImprovementLoop(state, tcfg, None, make_session,
                                     list(ROUND_TASKS), apo=make_apo(),
                                     checkpoint_manager=mgr, **loop_kw)
        if loop._anchor is None or loop._anchor["embed"].data_ptr() == \
                params["embed"].data_ptr():
            fail("online: the KL anchor is not a copy of the params")
        k2 = {"fwd": fa.flash_attention_fwd,
              "dkdv": fa.flash_attention_bwd_dkdv,
              "dq": fa.flash_attention_bwd_dq}
        launches = {"k1": 0, "fwd": 0, "dkdv": 0, "dq": 0}
        torch.cuda.reset_peak_memory_stats()
        results, per_round = [], []
        for r in range(ONLINE_ROUNDS):
            tracer.clear()
            steps0 = engine.stats()["decode_steps"]
            paged_flash_decode.launches = 0
            for w in k2.values():
                w.launches = 0
            n_before = len(collector.get_all_traces())
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = loop.run_round()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = {"k1": paged_flash_decode.launches,
                   **{k: w.launches for k, w in k2.items()}}
            for k, v in got.items():
                launches[k] += v
            steps = engine.stats()["decode_steps"] - steps0
            spans = {}
            for rec in tracer.spans():
                spans[rec.name] = spans.get(rec.name, 0.0) + \
                    rec.duration_ms / 1e3
            traces = collector.get_all_traces()[n_before:]
            head_err = _check_trace_head(torch, traces, f"online round {r}")
            if got["k1"] != layers * steps:
                fail(f"online round {r}: K1 launches {got['k1']} != "
                     f"{layers} x {steps} fused steps")
            per_pass = layers * ROUND_ACCUM
            want = {"fwd": per_pass * ((2 if TRAIN_REMAT else 1) + 1),
                    "dkdv": per_pass, "dq": per_pass}
            if {k: got[k] for k in want} != want:
                fail(f"online round {r}: K2 launches "
                     f"{ {k: got[k] for k in want} } != {want} (the "
                     f"phase_round counts plus {per_pass} forward launches "
                     f"for the anchor's log-probs)")
            bad = [k for k, v in res.train_metrics.items()
                   if not np.isfinite(v)]
            if bad or not res.train_metrics or res.episodes != \
                    len(ROUND_TASKS) * ROUND_GROUP:
                fail(f"online round {r}: {res.episodes} episodes, metrics "
                     f"{res.train_metrics}")
            results.append(res)
            per_round.append(dict(wall=wall, steps=steps, spans=spans,
                                  traces=len(traces), head_err=head_err,
                                  launches=got))
        beam = loop.apo.beam_state
        r0 = results[0]
        if not (r0.analyzed and r0.beam_ran):
            fail(f"online round 0: APO analyzed {r0.analyzed}, beam ran "
                 f"{r0.beam_ran}")
        if engine.params is not loop.state.params:
            fail("online: the engine does not serve the loop's params")
        peak = torch.cuda.max_memory_allocated()

        # a greedy request before the checkpoint ...
        probe = tok.encode(ROUND_TASKS[1], add_bos=True)
        before = _greedy(engine, probe)
        saved_rules = loop.current_rules()
        saved_cursor = loop._session_ids.peek()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step_dir = loop.checkpoint()
        save_s = time.perf_counter() - t0
        ck_bytes = sum(os.path.getsize(os.path.join(step_dir, f))
                       for f in os.listdir(step_dir))
        anchor_bytes = os.path.getsize(os.path.join(step_dir, ANCHOR_FILE))
        # ... and after a resume into a new loop on the same engine
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loop2 = OnlineImprovementLoop.resume(
            mgr, loop.state, tcfg, None, make_session, list(ROUND_TASKS),
            apo=make_apo(), **loop_kw)
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t0
        # the resume holds a second state and anchor beside the old loop's
        peak_resume = torch.cuda.max_memory_allocated()
        problems = []
        if loop2._round != ONLINE_ROUNDS:
            problems.append(f"round {loop2._round}")
        if loop2.current_rules() != saved_rules:
            problems.append("rules")
        if loop2._session_ids.peek() != saved_cursor:
            problems.append("session cursor")
        if loop2._published_version != loop._published_version:
            problems.append("weight version")
        if int(loop2.state.step) != int(loop.state.step) or \
                loop2.state.opt_state.count != loop.state.opt_state.count:
            problems.append("step")
        for name, a, b in (("params", loop2.state.params, loop.state.params),
                           ("mu", loop2.state.opt_state.mu,
                            loop.state.opt_state.mu),
                           ("nu", loop2.state.opt_state.nu,
                            loop.state.opt_state.nu),
                           ("anchor", loop2._anchor, loop._anchor)):
            if not _bits_equal(torch, a, b):
                problems.append(name)
        if engine.params is not loop2.state.params:
            problems.append("the engine does not serve the restored params")
        after = _greedy(engine, probe)
        if after != before:
            problems.append(f"greedy tokens {after} != {before}")
        if problems:
            fail(f"online resume: {', '.join(problems)} not restored")
        engine._alloc.check_leaks()
    finally:
        obs.disable()
        shutil.rmtree(work, ignore_errors=True)
        if ck_root is not None:
            shutil.rmtree(ck_root, ignore_errors=True)

    for r, (res, pr) in enumerate(zip(results, per_round)):
        sp = pr["spans"]
        apo_s = sp.get("online.apo", 0.0)
        rounds_s = sp.get("apo.beam_round", 0.0)
        log(f"[online] round {r}: wall {pr['wall']:.3f} s = collect "
            f"{sp.get('collect', 0.0):.3f} + batch_build "
            f"{sp.get('batch_build', 0.0):.3f} + ref_logp "
            f"{sp.get('ref_logp', 0.0):.3f} + train_step "
            f"{sp.get('train_step', 0.0):.3f} + APO {apo_s:.3f} (analyze, "
            f"its textual gradient and the beam's seed scoring "
            f"{apo_s - rounds_s:.3f}; beam rounds {rounds_s:.3f}: propose "
            f"{sp.get('apo.propose', 0.0):.3f}, score "
            f"{sp.get('apo.score', 0.0):.3f}); {pr['steps']} fused steps, "
            f"K1 {pr['launches']['k1']} = {layers} x {pr['steps']}, K2 "
            f"{ {k: pr['launches'][k] for k in ('fwd', 'dkdv', 'dq')} }; "
            f"{res.episodes} episodes, {pr['traces']} traces scored (card "
            f"vs host head max |diff| {pr['head_err']:.3g}); reward_mean "
            f"{res.reward_mean:.6f}, analyzed {res.analyzed}, beam "
            f"{res.beam_ran}, rules {len(res.rules)} active; kl "
            f"{res.train_metrics.get('kl', float('nan')):.6g}, loss "
            f"{res.train_metrics['loss']:.6g}, grad_norm "
            f"{res.train_metrics['grad_norm']:.6g}")
    log(f"[online] {smi}. Smoke figures, not a benchmark: {tcfg.name}, "
        f"{layers} layers, on the HF-loaded weights; {ONLINE_ROUNDS} rounds "
        f"of {len(ROUND_TASKS)} tasks x {ROUND_GROUP} agent sessions on one "
        f"paged engine ({ROUND_SLOTS} slots, max_len {ROUND_MAX_LEN}), "
        f"kl_coef {ONLINE_KL}, anchor_every {ONLINE_ANCHOR_EVERY}, accum "
        f"{ROUND_ACCUM}; APO {ONLINE_APO}; peak max_memory_allocated "
        f"{peak} bytes over the rounds, {peak_resume} bytes through the "
        f"checkpoint and the resume (the restored state and anchor beside "
        f"the old loop's)")
    log(f"[online] APO optimizer calls {optimizer.calls}, "
        f"{optimizer.too_long} of them past the {ROUND_MAX_LEN}-position "
        f"window (answered \"\", as the reference does for a failed "
        f"call); final beam {len(beam.beam) if beam else 0} prompt(s), best "
        f"score {beam.history_best_score if beam else None}")
    log(f"[online] checkpoint {ck_bytes} bytes (anchor {anchor_bytes}) in "
        f"{save_s:.3f} s ({ck_bytes / save_s / 1e9:.3f} GB/s); resume "
        f"(restore state + anchor, republish) {resume_s:.3f} s "
        f"({ck_bytes / resume_s / 1e9:.3f} GB/s); round {loop2._round}, "
        f"{len(saved_rules)} rules, session cursor {saved_cursor}, params, "
        f"moments and anchor bit-identical; greedy {PROBE_NEW_TOKENS} tokens "
        f"identical before and after")
    return launches, {"rounds": per_round, "save_s": save_s,
                      "resume_s": resume_s, "ckpt_bytes": ck_bytes}


class _CountingClient:
    """A PolicyClient that counts its calls and those refused for a
    prompt past the engine's window."""

    def __init__(self, inner):
        self.inner, self.calls, self.too_long = inner, 0, 0

    def chat(self, messages, **kw):
        from senweaver_ide_tpu_torch.agents.llm import ContextLengthError
        self.calls += 1
        try:
            return self.inner.chat(messages, **kw)
        except ContextLengthError:
            self.too_long += 1
            raise


def _greedy(engine, prompt):
    """One greedy request through the engine's current params."""
    from senweaver_ide_tpu_torch.rollout import SampleParams
    sample = engine.sample
    engine.sample = SampleParams(0.0, 0, 1.0)
    try:
        rid = engine.submit(prompt, max_new_tokens=PROBE_NEW_TOKENS)
        engine.run()
        return list(engine.result(rid))
    finally:
        engine.sample = sample


def _k3_launches(reset):
    from senweaver_ide_tpu_torch.ops.flash_decode import flash_decode
    if reset is not None:
        flash_decode.launches = reset
    return flash_decode.launches


def _ones_in_chains(engine, prompt_lens):
    """1-token chunks of the ring pool's long-prompt chains: each is a
    single-token forward, so it runs K3 once per layer."""
    from senweaver_ide_tpu_torch.rollout.engine import _chunk_sizes
    if not engine._ring:
        return 0
    return sum(_chunk_sizes(n, engine.max_len).count(1)
               for n in prompt_lens if n >= engine.max_len)


def _check_finished(engine, rids, budgets):
    import numpy as np
    for rid, want in zip(rids, budgets):
        toks, logps = engine.result(rid), engine.result_logps(rid)
        if not engine.is_done(rid):
            fail(f"slot request {rid} did not finish")
        if len(toks) != want:
            fail(f"slot request {rid} stopped at {len(toks)} of {want} "
                 f"tokens")
        if not all(np.isfinite(logps)) or max(logps) > 0:
            fail(f"slot request {rid} has a non-finite or positive log-prob")


def slots_requests(rng, ring):
    """The slot mix as (prompt length, new tokens) in submission order. A
    prompt longer than the ring gets an odd length, so its chunk chain
    ends in a one-token chunk (a single-token forward, through K3)."""
    reqs = [(int(n) | 1 if n > ring else int(n), new)
            for lo, hi, count, new in SLOTS_TRAFFIC
            for n in rng.integers(lo, hi + 1, size=count)]
    return [reqs[i] for i in rng.permutation(len(reqs))]


def phase_slots_serve(torch, cfg, params, seed, smi):
    """The slot layout's main path at full mistral-7b width: the ring
    cache (window 4096) serves 24 sampled requests through K3, long
    prompts through the chunk chain, decode past the window."""
    import dataclasses

    import numpy as np
    from senweaver_ide_tpu_torch.rollout import RolloutEngine
    scfg = dataclasses.replace(cfg, decode_attn_impl="flash")
    engine = RolloutEngine(params, scfg, num_slots=SLOTS_NUM,
                           max_len=SLOTS_MAX_LEN, seed=seed, device="cuda")
    if (engine.kv_layout, engine.kv_layout_fallback, engine.max_len) != (
            "slots", "sliding-window ring cache", cfg.sliding_window):
        fail(f"mistral engine: layout {engine.kv_layout!r}, fallback "
             f"{engine.kv_layout_fallback!r}, ring {engine.max_len}")
    rng = np.random.default_rng(seed + 2)
    reqs = slots_requests(rng, engine.max_len)
    rids = [engine.submit(rng.integers(0, cfg.vocab_size, size=n).tolist(),
                          max_new_tokens=new) for n, new in reqs]
    torch.cuda.reset_peak_memory_stats()
    wall, step_ms, launches = _drive(torch, engine, _k3_launches)
    st = engine.stats()
    steps = st["decode_steps"]
    _check_finished(engine, rids, [new for _, new in reqs])
    ones = _ones_in_chains(engine, [n for n, _ in reqs])
    expect = cfg.num_layers * (steps + ones)
    if launches != expect or launches == 0:
        fail(f"mistral slots: K3 launches {launches} != {cfg.num_layers} "
             f"layers x ({steps} decode steps + {ones} one-token chunks)")
    gen = st["tokens_emitted"]
    peak = torch.cuda.max_memory_allocated()
    log(f"[slots] {cfg.name} ring slot cache ({engine.max_len} positions x "
        f"{SLOTS_NUM} slots, decode_attn_impl=flash), {len(reqs)} requests "
        f"(prompts {min(n for n, _ in reqs)}..{max(n for n, _ in reqs)}, "
        f"SampleParams()), {smi}: wall {wall:.2f} s, {steps} decode steps, "
        f"{gen} tokens generated = {gen / wall:.1f} tok/s, "
        f"{st['prefill_tokens']} prefill tokens in {st['prefills']} "
        f"prefills ({st['batched_prefills']} batched forwards), p50 step "
        f"{statistics.median(step_ms):.2f} ms, p90 step "
        f"{statistics.quantiles(step_ms, n=10)[-1]:.2f} ms, "
        f"max_memory_allocated {peak} bytes, K3 launches {launches} = "
        f"{cfg.num_layers} x ({steps} + {ones})")
    return launches


def phase_slots_int8(torch, cfg, params, seed):
    """The int8 slot cache (kv_quant) at full qwen2.5-coder-1.5b width:
    8 greedy requests through K3 over the dequantized cache; the greedy
    token match against the bf16 paged engine is printed, not checked."""
    import dataclasses

    import numpy as np
    from senweaver_ide_tpu_torch.rollout import RolloutEngine, SampleParams
    greedy = SampleParams(0.0, 0, 1.0)
    qcfg = dataclasses.replace(cfg, kv_quant=True, decode_attn_impl="flash")
    rng = np.random.default_rng(seed + 3)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).tolist()
               for n in rng.integers(128, 513, size=8)]
    eng = RolloutEngine(params, qcfg, num_slots=8, max_len=1024,
                        sample=greedy, seed=seed, device="cuda")
    if (eng.kv_layout, eng.kv_layout_fallback) != ("slots",
                                                   "kv_quant int8 cache"):
        fail(f"int8 engine: layout {eng.kv_layout!r}, fallback "
             f"{eng.kv_layout_fallback!r}")
    rids = [eng.submit(p, max_new_tokens=32) for p in prompts]
    wall, _, launches = _drive(torch, eng, _k3_launches)
    steps = eng.stats()["decode_steps"]
    _check_finished(eng, rids, [32] * len(rids))
    if launches != cfg.num_layers * steps or launches == 0:
        fail(f"int8 slots: K3 launches {launches} != {cfg.num_layers} x "
             f"{steps} decode steps")
    streams = [eng.result(r) for r in rids]
    del eng
    ref = RolloutEngine(params, cfg, num_slots=8, max_len=1024,
                        sample=greedy, seed=seed, device="cuda")
    rrids = [ref.submit(p, max_new_tokens=32) for p in prompts]
    ref.run()
    match = np.mean([a == b for r, sa in zip(rrids, streams)
                     for a, b in zip(ref.result(r), sa)])
    log(f"[slots] {cfg.name} int8 slot cache (kv_quant, flash), 8 greedy "
        f"requests x 32 tokens: {steps} decode steps, wall {wall:.2f} s, K3 "
        f"launches {launches} = {cfg.num_layers} x {steps}; greedy token "
        f"match vs the bf16 paged engine {match:.3f} (information)")
    return launches


def phase_slots_logits(torch, cfg, params):
    """Mistral-width logits through the ring: one decode step with K3 vs
    the same step with decode_attn_impl="einsum", and a 4096 + 64 token
    sequence (prefill_chunked, then one token at a time past the window)
    vs the no-cache forward with the window over the whole sequence."""
    import dataclasses

    from senweaver_ide_tpu_torch.models import forward, init_kv_cache
    from senweaver_ide_tpu_torch.rollout import prefill_chunked
    fcfg = dataclasses.replace(cfg, decode_attn_impl="flash")
    ecfg = dataclasses.replace(cfg, decode_attn_impl="einsum")
    win = cfg.sliding_window
    g = torch.Generator().manual_seed(11)
    seq = torch.randint(0, cfg.vocab_size, (1, win + LOGITS_PAST),
                        generator=g).cuda()
    with torch.no_grad():
        ref = forward(params, cfg, seq)[0, win:]          # (64, V)
        cache = init_kv_cache(fcfg, 1, SLOTS_MAX_LEN, device="cuda")
        _, cache = prefill_chunked(params, fcfg, seq[:, :win], cache)
        snap = cache._replace(k=cache.k.clone(), v=cache.v.clone(),
                              length=cache.length.clone())
        lf, cache = forward(params, fcfg, seq[:, win:win + 1], cache=cache)
        le, _ = forward(params, ecfg, seq[:, win:win + 1], cache=snap)
        del snap
        step_diff = float((lf - le).abs().max())
        steps = [lf[0, -1]]
        for p in range(win + 1, win + LOGITS_PAST):
            lf, cache = forward(params, fcfg, seq[:, p:p + 1], cache=cache)
            steps.append(lf[0, -1])
        got = torch.stack(steps)
    torch.cuda.synchronize()
    scale = float(ref.abs().max())
    seq_diff = float((got - ref).abs().max())
    agree = float((got.argmax(-1) == ref.argmax(-1)).float().mean())
    log(f"[slots] {cfg.name} ring decode step at position {win}, K3 vs "
        f"einsum: max |dlogit| {step_diff:.4g} (tol {LOGITS_ATOL}; max "
        f"|logit| {scale:.3g})")
    log(f"[slots] {cfg.name} prefill_chunked({win}) + {LOGITS_PAST} ring "
        f"decode steps past the window (K3) vs the no-cache forward with "
        f"window {win}: max |dlogit| {seq_diff:.4g} (tol {LOGITS_ATOL}), "
        f"argmax agreement {agree:.3f}")
    if not step_diff <= LOGITS_ATOL:
        fail(f"ring decode step, K3 vs einsum, logits differ by {step_diff}")
    if not seq_diff <= LOGITS_ATOL:
        fail(f"ring decode vs no-cache forward logits differ by {seq_diff}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kernels-only", action="store_true",
                    help="build the kernels and hold them against their "
                         "plain versions, then stop: no serving or "
                         "training run and no ok line")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this check needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    try:
        import senweaver_ide_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the senweaver_ide_tpu_torch package is not "
              f"beside this script ({e})", file=sys.stderr)
        return 2
    from senweaver_ide_tpu_torch.models import (init_params, mistral_7b,
                                                qwen2_5_coder_1_5b)
    t_start = time.perf_counter()
    smi = phase_device(torch)
    phase_build()
    cfg = qwen2_5_coder_1_5b()
    timer = Timer(torch)
    kern = phase_kernel(torch, cfg, timer)
    fd = phase_flash_decode(torch, timer)
    if args.kernels_only:
        phase_flash(torch, cfg, timer)
        log(f"[done] kernels only, {time.perf_counter() - t_start:.1f} s")
        return 0
    g = torch.Generator(device="cuda").manual_seed(args.seed)
    params = init_params(cfg, g, device="cuda")
    log(f"[serve] {cfg.name}: {cfg.num_layers} layers, hidden "
        f"{cfg.hidden_size}, heads {cfg.num_heads}/{cfg.num_kv_heads}, "
        f"vocab {cfg.vocab_size}, {cfg.dtype}, tied head, random weights "
        f"(seed {args.seed})")
    launches = phase_serve(torch, cfg, params, args.seed, smi)
    phase_logits(torch, cfg, params)
    int8_launches = phase_slots_int8(torch, cfg, params, args.seed)
    flash = phase_flash(torch, cfg, timer)
    train_launches = phase_train(torch, cfg, params, args.seed, smi)
    round_launches = phase_round(torch, cfg, params, args.seed, smi)
    loaded, _ = phase_hf(torch, cfg, params, smi)
    online_launches, _ = phase_online(torch, cfg, loaded, args.seed, smi)
    # the 1.5B weights (trained in place) make way for mistral-7b
    del params, loaded
    gc.collect()
    torch.cuda.empty_cache()
    mcfg = mistral_7b()
    params = init_params(mcfg, torch.Generator(device="cuda").manual_seed(
        args.seed), device="cuda")
    log(f"[slots] {mcfg.name}: {mcfg.num_layers} layers, hidden "
        f"{mcfg.hidden_size}, heads {mcfg.num_heads}/{mcfg.num_kv_heads}, "
        f"window {mcfg.sliding_window}, vocab {mcfg.vocab_size}, "
        f"{mcfg.dtype}, random weights (seed {args.seed})")
    slot_launches = phase_slots_serve(torch, mcfg, params, args.seed, smi)
    phase_slots_logits(torch, mcfg, params)
    del params
    kernels = []
    for variant, r in kern.items():
        kernels.append({
            "name": "paged_flash_decode", "variant": variant,
            "route": "cuda",
            "source": "senweaver_ide_tpu_torch/csrc/paged_attention.cu",
            "replaces": "senweaver_ide_tpu/ops/paged_attention.py:53",
            "launches": launches[variant],
            "launches_round": (round_launches["k1"] if variant == "bf16"
                               else None),
            "launches_online": (online_launches["k1"] if variant == "bf16"
                                else None),
            "max_abs_err": r["max_abs_err"],
            "tolerance": f"{KERNEL_ATOL} + {KERNEL_RTOL} * |plain|",
            "ms": r["kernel_ms"], "kernel_ms": r["kernel_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "bytes": r["bytes"],
            "library_ms": None,
            "library_note": "no single PyTorch call reads KV through a "
                            "block table",
            "sdpa_pregathered_ms": r["sdpa_pregathered_ms"],
            "splits": r["splits"], "chunk": r["chunk"],
            "mixed_ms": r["mixed_ms"],
            "mixed_untiled_ms": r["mixed_untiled_ms"],
            "mixed_plain_ms": r["mixed_plain_ms"],
            "mixed_bound_ms": r["mixed_bound_ms"],
            "mixed_bound_by": r["mixed_bound_by"],
            "mixed_bytes": r["mixed_bytes"],
            "mixed_tiles": r["mixed_tiles"],
            "mixed_splits": r["mixed_splits"],
            "mixed_chunk": r["mixed_chunk"],
            "resources": r["resources"]})
    replaces = {"fwd": "senweaver_ide_tpu/ops/flash_attention.py:48",
                "dkdv": "senweaver_ide_tpu/ops/flash_attention.py:177",
                "dq": "senweaver_ide_tpu/ops/flash_attention.py:177"}
    for kname, r in flash.items():
        kernels.append({
            "name": {"fwd": "flash_attention_fwd",
                     "dkdv": "flash_attention_bwd_dkdv",
                     "dq": "flash_attention_bwd_dq"}[kname],
            "route": "cuda",
            "source": "senweaver_ide_tpu_torch/csrc/flash_attention.cu",
            "replaces": replaces[kname],
            "launches": train_launches[kname],
            "launches_round": round_launches[kname],
            "launches_online": online_launches[kname],
            "max_abs_err": r["max_abs_err"],
            "tolerance": _fa_tol_text(FA_TOL[FA_ERR_OF[kname][0]]),
            "ms": r["kernel_ms"], "kernel_ms": r["kernel_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "flops": r["flops"],
            "bytes": r["bytes"], "library_ms": r["library_ms"],
            "library_note": ("torch.nn.functional.scaled_dot_product_"
                             "attention(is_causal=True) " +
                             ("forward" if kname == "fwd" else
                              "backward (all three gradients)"))})
    kernels.append({
        "name": "flash_decode", "route": "cuda",
        "source": "senweaver_ide_tpu_torch/csrc/flash_decode.cu",
        "replaces": "senweaver_ide_tpu/ops/flash_decode.py:44",
        "launches": slot_launches,
        "launches_int8_slots_qwen": int8_launches,
        "max_abs_err": fd["max_abs_err"],
        "max_abs_err_f32": fd["max_abs_err_f32"],
        "tolerance": f"{FD_TOL['bf16'][0]} + {FD_TOL['bf16'][1]} * |plain|",
        "ms": fd["kernel_ms"], "kernel_ms": fd["kernel_ms"],
        "plain_ms": fd["plain_ms"], "bound_ms": fd["bound_ms"],
        "bound_by": fd["bound_by"], "flops": fd["flops"],
        "bytes": fd["bytes"], "library_ms": fd["library_ms"],
        "library_note": fd["library_note"], "shapes": fd["shapes"]})
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
