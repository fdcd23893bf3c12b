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
   Then at the draft's heads (qwen2.5-coder-0.5b, 14/2, D 64, bf16 pool):
   ragged lengths, chunk and tile edges and 0, segments in two-entry
   tiles and untiled, NaN past every reach and a second launch; its
   decode-step time and the 1.5B verify step's (16 rows x depth 4 in 32
   tiles), each beside its bytes bound.
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
15. The engine's reuse paths (``phase_reuse``, on the same weights): the
    round's 2 tasks x 4 sessions on fresh engines with auto_prefix on and
    off (one prefix prefill, a hit and a graft per call, the boundary
    block copied at each consumer's first write, prefill_tokens short by
    calls x prefix length); one prompt's grafted row in the engine (the
    prefix's blocks, the copied boundary block, the suffix) against a
    plain engine's row, prefix and suffix apart (REUSE_KV_RTOL), and its
    first-token log-prob against a plain prefill's (LOGITS_ATOL); K1 =
    layers x the fused steps of the phase's engines, bf16 and int8
    apart, K2 none; a held-slot
    continuation (counters, release, logits against a full re-prefill);
    the host tier (a warm prefix swaps out under a request the pool
    cannot otherwise hold and is restored bit for bit for its next
    consumer; a forced torn swap leaves it resident); export/import
    between engines on bf16 and int8 pools, bit-identical; a prefix and a
    continuation on the int8 slot cache (K3 = layers x (decode steps +
    one-token chunks)); update_params dropping prefixes and holds and an
    auto_prefix client re-registering. check_leaks after each part.
16. The streaming learner (``phase_async``): AsyncGRPOTrainer for
    ASYNC_ROUNDS rounds (prefetch 1, importance correction, auto_prefix
    sessions, publish_params = engine.update_params, spread rewards): K1
    = layers x fused steps, K2 = phase 12's counts per round, K3 none, every
    cached behaviour version bit-identical to what the engine served,
    the params moved; then one OnlineImprovementLoop round streaming into
    an ExperienceQueue (an episode per LLM call) and a
    StreamingTrainerAdapter step on its batch, whose recorded old_logp is
    held against behavior_logp_batched on the card (STREAM_LOGP_TOL) and
    whose ratio_mean is held against the one those log-probs give under
    the params it trains (ADAPTER_RATIO_TOL).
17. Speculative decoding (``phase_spec``, on the same weights, with a
    qwen2.5-coder-0.5b draft from --seed + 1): first the largest logit
    difference between the paths a token can take (a verify window on
    the pool and on a slot cache, single decode entries alone and
    batched, a chunked prefill, the plain forward), capped at
    TIE_DIFF_MAX; TIE_FACTOR times that is SPEC_TIE_ATOL. Then the
    serving engine (16 slots, greedy) on 16 requests of 128-1024 tokens,
    32 new, without speculation (the reference) and at FixedDepth 4 (the
    distiller's harvest); on the first 4 of them at FixedDepth 2 and 8,
    under the default SpecController and with a self-draft at depths 2, 4
    and 8 (acceptance at 4 >= SPEC_SELF_ACCEPT_MIN, fewer rounds at 8
    than at 2). Every token of every stream is held by teacher forcing:
    one plain forward over prompt + stream, each token the argmax at its
    own position or within SPEC_TIE_ATOL of it; K1 = 28 x fused steps +
    24 x draft forwards exactly; check_leaks and spec_check_leaks after
    each run; update_params stamps the draft stale. Then DraftDistiller
    harvests the depth-4 run's outcomes and takes DRAFT_DISTILL_STEPS
    steps with attn_impl="flash" (K2 = 24 x steps each; finite loss; CE
    on a fixed harvested batch falls), installs the draft, and a depth-4
    run on 4 requests is held again; then SpeculativeDecoder (512-token
    prompt, 64 new, k=4) on the paged layout (every block freed) and the
    slot cache with decode_attn_impl="flash" (K3 = 24 x the draft's
    one-token feeds). Prints tok/s, fused steps, acceptance, wasted draft
    tokens and the runtime ledger's propose / feed / fused-step seconds
    per run, and each stream's first index off the reference.
18. Group/tree rollout (``phase_group``): submit_group of 8 on a
    1,000-token prompt (one prefill, 7 forks, 7 one-token rescores),
    every token of the group's and of 8 independent submits' streams
    held by teacher forcing, K1 = 28 x fused steps; then
    grpo_round(planner=GroupRollout(...)) over 2 token-list tasks x 4
    with speculation at depth 4, accum 4, remat and attn_impl="flash":
    every root branches once; finite metrics; K1 = 28 x fused steps + 24
    x draft forwards, K2 224/112/112 and K3 0 (read over the whole phase)
    exactly; check_leaks and spec_check_leaks.
19. Multi-tenant LoRA (``phase_tenants``): an AdapterPool (ranks 8 and
    16, 4 slots a rung) on the serving engine (16 slots, block 16, step
    budget 64, greedy), six tenants (three at rank 8, three at 16, B
    random from a seed each), 16 requests of 128-1024 tokens, 64 new, two
    per tenant and four base; every token of every stream held by teacher
    forcing against the plain forward over merge_lora(base, adapter) (or
    the base), under SPEC_TIE_ATOL widened to TIE_FACTOR x the measured
    difference between the adapter's paged and plain paths if that is
    larger (both capped); the same traffic on a base-only engine beside
    it (tok/s, p50 / p90 step ms); the pool's bank bytes and
    adapter_stats(). Then one lora_base GRPO step of a rank-16 tenant
    (4 x 512, flash, remat: K2 = 56 / 28 / 28), published mid-decode: the
    in-flight request keeps v1 and its stream is held against v1, the
    next request against v2. Then two waves of four tenants through two
    slots a rung on the same prompts: 8 installs, 4 evictions, and the
    fused-step signatures, compiles and kernel builds the same after
    both waves; the second wave teacher-forced. K1 = 28 x the fused steps
    of every engine, K3 0.
20. Live migration (``phase_migrate``): engines A and B (8 rows, block 16,
    greedy, an adapter pool each with the same tenant), 8 requests of
    512-1536 tokens, 128 new (a group of 2, a tenant request, 5 base);
    once every row has 32 tokens, 2 base rows, the tenant row and the
    group follower are checkpointed on A, round-tripped through
    to_wire / from_wire, restored on B through the fast path (the
    installed blocks, gathered again on B, bit-identical to the payload)
    and released on A; a fifth row restores on a block-32 engine through
    the recompute path; an int8-pool row moves to an int8 engine and must
    finish equal to a never-migrated int8 run. Every stream held by
    teacher forcing; K1 = 28 x the fused steps of every engine, K2 and K3
    0. Prints checkpoint bytes, gather and install ms and GB/s, and the
    recompute restore's ms.
21. The serving fleet (``phase_fleet``, on the first FLEET_LAYERS (4)
    layers of the 1.5B weights of phases 12-20, full width): one engine at phase_serve's settings (16 slots, max_len 2048,
    block 16, step budget 64, greedy) on 32 requests of 128-1024 tokens,
    64 new (half INTERACTIVE, 8 on a 512-token prefix, a group of 4) for
    tok/s and TTFT; then a ServingFleet of two local engines sharing one
    params tree and a third behind serve_engine_http on 127.0.0.1 in this
    process, whose weights cross the socket first (its own bit-equal
    copy): the same traffic with the prefix broadcast to every replica
    (over HTTP to the remote), a local replica killed mid-decode, a
    dropped response on the remote's first submit replayed from its
    idempotency cache, the other local replica's pool squeezed by a
    MemoryPressurePlan until a decode migrates to the remote, then a
    rolling publish of a perturbed copy (drain, swap, resume; the remote's
    weights over the socket). Fails on a ticket without a terminal
    outcome, a Completed whose weight version moved, a stream off its
    version's plain forward's argmax by more than SPEC_TIE_ATOL, K1 !=
    layers x the fused steps of the three engines (K2 and K3 0), a
    captured fused step's logits K1 vs plain past SPEC_TIE_ATOL, no
    migration, no replay, a replica not bit-equal to the published tree,
    a missing senweaver_serve_* name, or a leak after release. Prints the
    fleet's and the engine's tok/s and TTFT p50 / p90, the frames' bytes
    and GB/s, the roll's seconds, the prefix install over HTTP, the
    migrations, peak memory and K1.
22. The disaggregated learner (``phase_learner``, at phase 21's depth): a
    StreamingLearnerService over a StreamingTrainerAdapter (flash, remat,
    accum 4, lr 1e-5), two GRPO steps a streamed batch, behind
    serve_fleet_http (FleetRpcHandler, a LeaseStore) and
    serve_experience_http; its fleet is one local sampling engine and
    phase_fleet's HTTP replica. A round (2 prompts x 4 completions of 64
    from that fleet, phase_async's stand-in reward) streams over HTTP;
    the learner trains (the first step's |ratio_mean - 1| within
    RATIO_TOL: the streamed log-probs are the served weights' own) and
    publishes with its (epoch, version) fence;
    both replicas must hold the learner's snapshot bit for bit, and
    still after its next in-place step; a second holder steals the lease,
    and the first holder's next step must raise LeaseLost and its publish
    at its own fence StalePublishError. K1 = layers x fused steps, K2 =
    672 / 336 / 336 (three steps), K3 0. Prints the steps' loss and
    ratio, the publish's staging and roll seconds and frame bytes, the
    lease epochs and peak memory.
23. The control plane (``phase_control``, on the same weights): the
    package's native library and senweaver-ctl built with g++ from
    ``senweaver_ide_tpu_torch/native/`` into its ``_build/`` (no fallback
    taken); a ControlServer on a unix socket in a temp dir and a JobRunner
    over a TrainState of the weights (flash, remat, accum 2, lr 1e-5,
    spread rewards), its sessions on one paged engine as in phase 12, every span
    of their shared TraceCollector sunk into a TraceRing. Through the
    binary: a grpo job of 2 tasks x 2 sessions (``watch``, then ``call
    job_result``: done, one round, the step advanced by one, finite
    metrics, |ratio_mean - 1| within RATIO_TOL, K1 = layers x fused
    steps, K2 112 / 56 / 56); an eval_rules job (a finite final_reward);
    a grpo job stopped while it waits behind it (never runs) and a
    malformed job (failed, its error filled in). The ring must read back
    every span the collector holds. DashboardService on 127.0.0.1:0:
    ``/api/state`` lists the four jobs with their statuses, its runtime
    tile the engine's fused steps, ``/api/action`` reads the same over the
    socket, ``/metrics`` serves the round (senweaver_rounds_total one up).
    OnboardingService's probe (a subprocess round-tripping a CUDA tensor)
    passes and the accelerator step takes 'gpu'. SCMService writes a
    commit message for a staged change in a temp git repository through
    the same engine, greedy, 64 new tokens (a message, or the error for a
    reply without ``<output>``). K3 0. Prints the job, round and eval
    seconds, launches, spans in the ring, the dashboard's latency and
    peak memory.
24. Weight-only int8 (``phase_int8``) on the 1.5B weights of phases
    12-20: ``quantize_weights_int8`` (bytes computed and measured), one
    fused step's logits on int8 weights, K1 vs the plain path and vs the
    no-cache forward, within the tie tolerance; 16 greedy requests of
    128-1024 tokens, 64 new, on int8 and on bf16 weights (tok/s, p50 /
    p90 step ms, device ms a step from a profiled window each); a bf16
    publish into the int8 engine is quantized again (weight_quant 1) and
    serves. K1 = 28 x fused steps of every engine, K2 and K3 0.
25. Mixture-of-experts (``phase_moe``) at full Qwen3-30B-A3B width,
    MOE_LAYERS of its 48 layers deep (128 experts, top-8; a time cut:
    the weights and every step scale with the depth) after the Mistral
    weights are
    freed: K1 (two-entry tiles at rep 8) and K2 (2 x 511) at its 32/4
    heads against their plain versions, timed beside their bounds and
    (K2) beside SDPA with enable_gqa=True;
    random bf16 weights (61.06 GB at 48 layers); the serving engine (16
    slots, max_len 2048, block 16, budget 64) on 8 greedy requests of
    128-1024 tokens, 32 new, K1 = layers x fused steps, and the last routed
    layer of its first fused step against a per-expert loop on that
    step's own flat batch (dropped share, expert load); the same traffic
    under a dropless copy of the config (capacity factor E/k: no batch
    dependence), every token teacher-forced against the plain forward;
    int8 in place, one stacked tensor at a time (peak printed), the
    traffic again on int8 weights (tok/s, p50, token agreement as a
    figure); one QLoRA GRPO step on the int8 base under the dropless
    copy (rank 16 on wq/wk/wv/wo, flash, remat, accum 4, 2 prompts x 4
    sampled completions of 64 from an int8 engine): only the adapters
    move, finite metrics, first-step |ratio_mean - 1|, K2 = layers x 4 x
    (2 / 1 / 1); materialize_lora re-quantizes, update_params into the int8
    engine and one more request.
26. The parallel layouts (``phase_parallel``, after phase 23): two ranks
    started once (``multiprocessing``'s spawn context) on the one card,
    on one gloo group over CUDA tensors (named explicitly; a collective
    gloo lacks for CUDA goes through pinned host memory, and each rank
    prints which), fresh random 1.5B weights from --seed in each. (a)
    Rank 0 first joins a one-rank NCCL group: a one-rank mesh's train
    step (4 layers at full width, 2 x 256, flash, remat) is bit-equal to
    mesh=None. (b) tp=2 and fsdp=2 steps on 4 x 1024 (flash, remat,
    accum 2): the ranks' metrics equal, the gathered gradient within
    PAR_GRAD_TOL relative RMS and the loss within PAR_LOSS_RTOL of rank
    0's one-rank step, K2 = layers x accum x (2, 1, 1) a rank. (c) K2 and
    K3 at the local heads 6/1 against their plain versions, timed beside
    their bounds. (d) A tp=2 slot engine (8 slots, greedy, one KV head a
    rank) serves 8 requests of 128-1024 tokens, 32 new: the ranks'
    streams equal, K3 = layers x decode steps, every stream (and a
    one-rank engine's) teacher-forced within SPEC_TIE_ATOL. (e) Ring and
    Ulysses attention at sp=2, 2 x 4096, 12/2 heads, bf16, forward and
    gradients within PAR_SP_RMS_TOL relative RMS of the one-rank flash
    path. (f) moe_ffn_sharded at ep=2 on one Qwen3-30B-A3B layer (128
    experts, top-8, hidden 2048, FFN 768; 4 x 512 tokens) against
    moe_ffn on each rank's rows, at capacity 1.25 and dropless; then
    moe_ffn on a dp=2 mesh (each rank its 2 rows, routed as the global
    batch) against one rank's moe_ffn over all 4 rows, at capacity 1.25
    and 1.0 (drops present): outputs, dropped count and aux. (g)
    Pipeline stages at pp=2 (14 layers a stage, the (b) weights and
    batch): one GPipe step at M=2 and one 1F1B step at M=4, each rank's
    stage gradients (and the replicated ones) held per tensor to the
    one-rank step's as in (b) without a gather (rank 1 recomputes the
    one-rank gradients), the loss to rank 0's, 1F1B against GPipe, K2
    exact per rank and schedule (GPipe layers/2 x M x (2, 1, 1) under
    remat; 1F1B layers/2 x M x (2 on stage 0 for its no-grad forward
    and the recompute, 1 on the last stage), 1, 1)), step seconds,
    bytes a tick, the send route and each rank's peak memory. Prints
    each rank's peak memory, collective routes and phase seconds.
27. A JSON line with every kernel's numbers (``launches_round``,
    ``launches_online``, ``launches_reuse``, ``launches_async``,
    ``launches_spec``, ``launches_group``, ``launches_tenants``,
    ``launches_migrate``, ``launches_fleet``, ``launches_learner``,
    ``launches_control``,
    ``launches_int8``, ``launches_moe``, ``launches_qlora``,
    ``launches_parallel`` and ``launches_pp``: the counts of those phases' runs (a rank's, in
    ``phase_parallel``; K2's and K3's ``local_heads`` give their checks
    and times at the tp=2 heads); K1's entry
    also its times at the draft's heads, ``d64_*``, at the verify step,
    ``verify_*``, and at Qwen3-30B-A3B's heads, ``rep8_*``; K2's at
    those heads, ``rep8_*``), the card line, and last the JSON ok line.

Exits non-zero, printing no result, without CUDA or without the
``senweaver_ide_tpu_torch`` package beside this file.
"""

from __future__ import annotations

import argparse
import dataclasses
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
# The engine's reuse paths (phase_reuse): the prefix's KV (slot-path
# prefill, plain attention) against a chunked prefill's (K1), bf16: the
# worst per-layer RMS of the difference over the RMS of the plain KV. The
# two routes round differently at every layer (~2**-8 relative); over 28
# layers that walks to sqrt(28) * 2**-8 ~ 0.02 at the last ones (0.0178
# measured on seed-0 weights, NVIDIA H100): twice that.
REUSE_KV_RTOL = 4e-2
# The streaming learner (phase_async)
ASYNC_ROUNDS, ASYNC_PREFETCH = 3, 1
# Recorded behaviour log-probs (the engine's, at sample time) against
# behavior_logp_batched on the same params (K2's forward), bf16: mean
# |diff| over the completion tokens (phase 7's ratio tolerance reads the
# same per-token differences, a few 1e-2)
STREAM_LOGP_TOL = 0.05
# The adapter's step after the sink round: the loop has already trained on
# that round, so the adapter's ratio_mean is not 1 (it read 0.997-1.021);
# it must equal exp(logp - recorded old_logp) averaged over the completion
# tokens, logp from behavior_logp_batched on the adapter's params: the same
# K2 forward at the same shapes as the adapter's own
ADAPTER_RATIO_TOL = 2e-3
ROUND_SPANS = ("grpo_round", "collect", "batch_build", "train_step",
               "trainer.grpo_step", "agent.turn", "engine.decode_step")
ROUND_LEDGER = ("engine.fused_step", "trainer.grpo_step")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


_T0 = time.perf_counter()


def log(msg: str) -> None:
    """One progress line, stamped with the seconds since the script
    started (a phase's cost is the difference of two stamps)."""
    print(f"[{time.perf_counter() - _T0:7.1f} s] {msg}", flush=True)


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


# K1 on the speculation path: the draft's heads (qwen2.5-coder-0.5b,
# 14/2, D 64, rep 7) and the target's verify step (16 rows x depth 4 at
# the 1.5B heads, each row's window in two-entry tiles).
K1_SPEC_DEPTH = 4


def _k1_head_checks(torch, g, hcfg, tag):
    """K1 against its plain version at ``hcfg``'s heads: ragged lengths,
    the split plan's chunk and tile edges and 0, decode rows plus prefill
    segments in query tiles (TILE_ROWS // rep entries) and untiled, NaN
    past every reach and a second launch bit-identical. Returns the
    worst |kernel - plain|."""
    from senweaver_ide_tpu_torch.ops.flash_decode import split_plan
    from senweaver_ide_tpu_torch.ops.paged_attention import (TILE_ROWS,
                                                             query_tiles)
    hq, hkv, d, bs = hcfg.num_heads, hcfg.num_kv_heads, hcfg.head_dim, K1_BS
    rep = hq // hkv
    cap = K1_MB * bs
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    worst = 0.0
    # ragged lengths, one table row each
    ragged = [1, 15, 16, 17, 1000, 2048]
    q_r, pool_r, tables_r, lengths_r, _, _ = _k1_seq_batch(
        torch, g, "bf16", hcfg, ragged,
        [(i, n - 1) for i, n in enumerate(ragged)])
    worst = max(worst, _k1_check(torch, f"{tag} ragged", q_r, pool_r,
                                 tables_r, lengths_r))
    # lengths on the batch's split-plan chunk and tile edges, and 0
    _, chunk = split_plan(11, hkv, cap, sms)
    lens = [0, 1, 63, 64, 65, chunk - 1, chunk, chunk + 1, 2 * chunk + 1,
            cap - 1, cap]
    q_e, pool_e, tables_e, lengths_e, _, _ = _k1_seq_batch(
        torch, g, "bf16", hcfg, lens,
        [(i, max(n, 1) - 1) for i, n in enumerate(lens)])
    lengths_e[0] = 0
    worst = max(worst, _k1_check(torch, f"{tag} edges (chunk {chunk})",
                                 q_e, pool_e, tables_e, lengths_e))
    # decode rows plus prefill segments, from a block edge, across the
    # tiles' chunk edge and from a warp's 16-position step
    decode = torch.linspace(128, 2048, 16).round().int().tolist()
    seq_lens = list(decode)
    entries = [(i, n - 1) for i, n in enumerate(decode)]
    _, chunk_t = split_plan(16 + 3 * 5, hkv, cap, sms)
    for p0 in (16, chunk_t - 5, 31):
        seq_lens.append(p0 + 10)
        entries += [(len(seq_lens) - 1, p) for p in range(p0, p0 + 10)]
    q_m, pool_m, tables_m, lengths_m, seq_row, pos = _k1_seq_batch(
        torch, g, "bf16", hcfg, seq_lens, entries)
    errs = []
    for tiled in (True, False):
        tiles = query_tiles(seq_row, pos, rep) if tiled else None
        if tiled and int(tiles[:, 1].max()) != TILE_ROWS // rep:
            fail(f"{tag} tiles hold {int(tiles[:, 1].max())} entries, "
                 f"expected {TILE_ROWS // rep}")
        e = _k1_check(torch, f"{tag} segments " + ("tiled" if tiled
                                                   else "untiled"),
                      q_m, pool_m, tables_m, lengths_m, tiles)
        worst = max(worst, e)
        errs.append(e)
    log(f"[kernel] {tag} heads {hq}/{hkv} D {d} (rep {rep}), bf16 pool: "
        f"ragged {ragged}, edges {lens} (chunk {chunk}), T={len(entries)} "
        f"with three 10-token segments in {TILE_ROWS // rep}-entry tiles "
        f"(max |kernel - plain| {errs[0]:.3g}) and untiled ({errs[1]:.3g}); "
        f"length 0 exact zeros, NaN past every reach and a second launch "
        f"bit-identical; worst {worst:.3g}")
    return worst


def _k1_decode_time(torch, g, hcfg, timer):
    """K1 at ``hcfg``'s heads on a decode step of 16 rows, lengths
    128..2048, on a bf16 pool: (kernel ms, plain ms, bound ms, bytes)."""
    from senweaver_ide_tpu_torch.ops.paged_attention import (
        paged_flash_decode, paged_flash_decode_plain)
    lengths_t = torch.linspace(128, 2048, 16).round().int().tolist()
    q_t, pool_t, tables_t, len_t, _, _ = _k1_seq_batch(
        torch, g, "bf16", hcfg, lengths_t,
        [(i, n - 1) for i, n in enumerate(lengths_t)])
    args = (q_t, pool_t[0], pool_t[1], tables_t, len_t)
    e, ok = _k1_err(paged_flash_decode(*args),
                    paged_flash_decode_plain(q_t.float(), *args[1:]))
    if not ok:
        fail(f"K1 decode timing batch at heads {hcfg.num_heads}/"
             f"{hcfg.num_kv_heads}: kernel vs plain max err {e}")
    nbytes, flops = _k1_bound(pool_t, q_t, len_t, lengths_t)
    bound = max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3
    return (timer.ms(lambda: paged_flash_decode(*args)),
            timer.ms(lambda: paged_flash_decode_plain(*args), iters=10),
            bound, nbytes)


def phase_kernel_spec(torch, cfg, dcfg, timer):
    """K1 at the draft's heads against its plain version (ragged lengths,
    the split plan's chunk and tile edges and 0, segments in two-entry
    tiles and untiled, NaN past every reach, a second launch
    bit-identical), then its times beside the bytes bound: the draft's
    decode step (16 rows, lengths 128..2048) and the 1.5B verify step
    (16 rows x depth K1_SPEC_DEPTH in query tiles)."""
    from senweaver_ide_tpu_torch.ops.paged_attention import (
        paged_flash_decode, paged_flash_decode_plain, query_tiles)
    g = torch.Generator(device="cuda").manual_seed(2)
    worst = _k1_head_checks(torch, g, dcfg, "D=64")
    out = {"max_abs_err_d64": worst}
    # timing 1: the draft's decode step, 16 rows spread to 2048
    ms, plain_ms, bound, nbytes = _k1_decode_time(torch, g, dcfg, timer)
    out.update(d64_ms=ms, d64_plain_ms=plain_ms, d64_bound_ms=bound,
               d64_bytes=nbytes)
    hq, hkv, d = dcfg.num_heads, dcfg.num_kv_heads, dcfg.head_dim
    log(f"[kernel] draft decode step, heads {hq}/{hkv} D {d}, T=16 lengths "
        f"128..2048: kernel {out['d64_ms']:.4f} ms = "
        f"{bound / out['d64_ms']:.3f} of the bound, plain "
        f"{out['d64_plain_ms']:.4f} ms, bound {bound:.4f} ms ({nbytes} "
        f"bytes)")
    # timing 2: the target's verify step, each row's depth-4 window ending
    # at its length
    lengths_t = torch.linspace(128, 2048, 16).round().int().tolist()
    entries = [(i, n - K1_SPEC_DEPTH + j) for i, n in enumerate(lengths_t)
               for j in range(K1_SPEC_DEPTH)]
    q_v, pool_v, tables_v, len_v, seq_row, pos = _k1_seq_batch(
        torch, g, "bf16", cfg, lengths_t, entries)
    rep_t = cfg.num_heads // cfg.num_kv_heads
    tiles = query_tiles(seq_row, pos, rep_t)
    vargs = (q_v, pool_v[0], pool_v[1], tables_v, len_v)
    worst_v = _k1_check(torch, "verify step", q_v, pool_v, tables_v, len_v,
                        tiles)
    tiles_dev = tiles.cuda()
    nbytes, flops = _k1_bound(pool_v, q_v, len_v, lengths_t,
                              tiles.shape[0])
    bound = max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3
    out.update(verify_ms=timer.ms(lambda: paged_flash_decode(
                   *vargs, q_tiles=tiles_dev)),
               verify_untiled_ms=timer.ms(lambda: paged_flash_decode(*vargs)),
               verify_plain_ms=timer.ms(
                   lambda: paged_flash_decode_plain(*vargs), iters=10),
               verify_bound_ms=bound, verify_bytes=nbytes,
               verify_tiles=int(tiles.shape[0]),
               max_abs_err_verify=worst_v)
    log(f"[kernel] verify step, heads {cfg.num_heads}/{cfg.num_kv_heads} D "
        f"{cfg.head_dim}: 16 rows x depth {K1_SPEC_DEPTH} = T={len(entries)} "
        f"in {out['verify_tiles']} tiles: kernel {out['verify_ms']:.4f} ms "
        f"= {bound / out['verify_ms']:.3f} of the bound, untiled "
        f"{out['verify_untiled_ms']:.4f} ms, plain "
        f"{out['verify_plain_ms']:.4f} ms, bound {bound:.4f} ms ({nbytes} "
        f"bytes); max |kernel - plain| {worst_v:.3g}, NaN past every reach "
        f"and a second launch bit-identical")
    return out


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


def _fa_work(b, s, hq, hkv, d):
    """(flops, bytes) of each K2 kernel on a causal bf16 (B, S) batch:
    the operations the function needs on this data, each input read and
    each output written once."""
    pairs = _visible_pairs(s)
    el = 2                                     # bf16 bytes
    qb = b * s * hq * d * el
    kvb = b * s * hkv * d * el
    rowb = b * hq * s * 4                      # one f32 (B, Hq, S) array
    return {
        "fwd": (4 * b * hq * d * pairs, qb + 2 * kvb + qb + rowb),
        "dkdv": (8 * b * hq * d * pairs, 2 * qb + 2 * kvb + 2 * rowb
                 + 2 * kvb),
        "dq": (6 * b * hq * d * pairs, 2 * qb + 2 * kvb + 2 * rowb + qb),
    }


def _sdpa_times(torch, timer, q, k, v, gout, t):
    """Yardstick only, never called by the port: causal SDPA on (B, H, S,
    D) copies of q, k, v; its forward, backward (all three gradients, from
    a saved output) and forward + backward times go into ``t``. Returns
    how the heads were grouped."""
    import torch.nn.functional as F
    hq, hkv = q.shape[2], k.shape[2]
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
    return gqa_note


def phase_flash(torch, cfg, timer):
    """The K2 kernels (flash-attention forward, dK/dV, dQ) against their
    plain versions at qwen2.5-coder-1.5b attention shapes, bf16, then
    their times at the training path's shape beside the bounds and SDPA."""
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
    gqa_note = _sdpa_times(torch, timer, q, k, v, gout, t)

    work = _fa_work(b, s, hq, hkv, d)
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


def _paged_logits(torch, params, cfg, tokens, start=0, payload=None):
    """Last-token logits of ``tokens`` fed at positions ``start..`` on a
    private pool through K1: with ``payload`` (blocks gathered from an
    engine, positions ``< start``) installed first, this is the graft or
    continuation route; with ``start`` 0 it is a plain prefill."""
    from senweaver_ide_tpu_torch.models import forward_paged
    from senweaver_ide_tpu_torch.rollout import init_paged_pool
    from senweaver_ide_tpu_torch.rollout.paged_kv import install_blocks_quant
    bs, n = 16, len(tokens)
    nb = -(-(start + n) // bs)
    pool = init_paged_pool(cfg, nb, bs, device="cuda")
    if payload is not None:
        install_blocks_quant(pool, payload, list(range(payload.k.shape[1])))
    pos = torch.arange(start, start + n)
    with torch.no_grad():
        logits, _ = forward_paged(
            params, cfg, torch.tensor(tokens), pool=pool,
            tables=torch.arange(nb, dtype=torch.int32)[None],
            seq_row=torch.zeros(n, dtype=torch.long), positions=pos,
            write_block=pos // bs, write_off=pos % bs, use_kernel=True)
    return logits[-1].float()


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
    probe_before = _paged_logits(torch, engine.params, engine.config,
                                 prompts[0])
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
    probe_after = _paged_logits(torch, engine.params, engine.config,
                                prompts[0])
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


def _kv_rel_err(torch, got, want, n, start=0):
    """Per-layer RMS of (got - want) over RMS(want), positions
    ``start..n-1``, of block payloads (L, nblk, bs, Hkv, D); the worst
    layer of k and v."""
    worst = 0.0
    for a, b in ((got.k, want.k), (got.v, want.v)):
        a = a.float().reshape(a.shape[0], -1, *a.shape[3:])[:, start:n]
        b = b.float().reshape(b.shape[0], -1, *b.shape[3:])[:, start:n]
        num = (a - b).pow(2).mean(dim=(1, 2, 3)).sqrt()
        den = b.pow(2).mean(dim=(1, 2, 3)).sqrt()
        worst = max(worst, float((num / den).max()))
    return worst


def _payload_equal(torch, a, b):
    return all((x is None) == (y is None) and (x is None or (
        x.dtype == y.dtype and x.shape == y.shape
        and torch.equal(x.contiguous().view(torch.uint8),
                        y.contiguous().view(torch.uint8))))
        for x, y in zip(a, b))


def _timed(torch, fn, out):
    """``fn`` wrapped to append its synchronized wall seconds to ``out``."""
    def run(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            return fn(*args, **kw)
        finally:
            torch.cuda.synchronize()
            out.append(time.perf_counter() - t0)
    return run


def phase_reuse(torch, cfg, params, seed, smi):
    """The engine's reuse paths at full width: the round's sessions with
    and without a shared system prefix, a held-slot continuation, the
    host tier under pressure, export/import between engines on bf16 and
    int8 pools, a prefix and a continuation on the int8 slot cache (K3),
    and a publish dropping prefixes and holds. Returns the phase's
    launches: K1 on bf16 pools (``k1``) and on the int8 pool
    (``k1_int8``), each layers x its engines' fused steps, with the
    reference forwards the checks run through K1 left out; K3; and K2's
    three kernels, which nothing in the phase runs (every forward here
    reads a cache or the pool)."""
    import dataclasses
    import shutil

    from senweaver_ide_tpu_torch.agents.llm import ChatMessage
    from senweaver_ide_tpu_torch.models import ByteTokenizer
    from senweaver_ide_tpu_torch.ops import flash_attention as fa
    from senweaver_ide_tpu_torch.ops.flash_decode import flash_decode
    from senweaver_ide_tpu_torch.ops.paged_attention import \
        paged_flash_decode
    from senweaver_ide_tpu_torch.rollout import (EngineConfig,
                                                 EnginePolicyClient,
                                                 RolloutEngine,
                                                 RolloutSession,
                                                 SampleParams)
    from senweaver_ide_tpu_torch.rollout.engine import _chunk_sizes
    from senweaver_ide_tpu_torch.rollout.paged_kv import gather_blocks_quant
    from senweaver_ide_tpu_torch.training import collect_group_trajectories
    tok = ByteTokenizer()
    greedy = SampleParams(0.0, 0, 1.0)
    layers = cfg.num_layers
    k2 = {"fwd": fa.flash_attention_fwd,
          "dkdv": fa.flash_attention_bwd_dkdv,
          "dq": fa.flash_attention_bwd_dq}
    paged_flash_decode.launches = 0
    flash_decode.launches = 0
    for w in k2.values():
        w.launches = 0
    # each paged engine's fused steps, by pool dtype, credited before the
    # engine goes: K1's count must come to layers x these
    k1_steps = {"bf16": 0, "int8": 0}

    def retire(engine, dtype="bf16"):
        k1_steps[dtype] += engine.stats()["decode_steps"]

    def reference_logits(*args):
        """``_paged_logits`` (a forward through K1 on a private pool),
        kept out of the phase's launch count: it checks the path and is
        not part of it."""
        n = paged_flash_decode.launches
        try:
            return _paged_logits(torch, params, cfg, *args)
        finally:
            paged_flash_decode.launches = n

    def engine_for(**kw):
        kw.setdefault("num_slots", ROUND_SLOTS)
        return RolloutEngine(params, kw.pop("config", cfg),
                             max_len=ROUND_MAX_LEN, eos_id=tok.eos_id,
                             seed=seed, device="cuda", **kw)

    # 1. the round's sessions with a shared system prefix, then without
    runs = {}
    for auto in (True, False):
        engine = engine_for(sample=SampleParams())
        work = _scratch_dir(0, "chip_smoke_reuse_ws_")
        clients, systems = [], []

        def make_session(engine=engine, work=work, clients=clients,
                         systems=systems, auto=auto):
            client = EnginePolicyClient(
                engine, tok, model_name=cfg.name,
                default_max_new_tokens=ROUND_NEW_TOKENS, record_calls=True,
                auto_prefix=auto)
            clients.append(client)
            sess = RolloutSession(client,
                                  os.path.join(work, f"ws{len(clients)}"),
                                  include_tool_definitions=False)
            systems.append(sess.system_message())
            return sess

        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            collect_group_trajectories(make_session, list(ROUND_TASKS),
                                       group_size=ROUND_GROUP,
                                       max_parallel=ROUND_SLOTS)
            torch.cuda.synchronize()
            collect_s = time.perf_counter() - t0
        finally:
            shutil.rmtree(work, ignore_errors=True)
        calls = [c for cl in clients for c in cl.call_log]
        runs[auto] = dict(engine=engine, stats=engine.stats(), calls=calls,
                          collect_s=collect_s, system=systems[0],
                          clients=clients)
    pre, plain = runs[True], runs[False]
    peng, st = pre["engine"], pre["stats"]
    if len(peng._prefixes) != 1:
        fail(f"reuse: {len(peng._prefixes)} prefixes registered, want 1")
    pid = next(iter(peng._prefixes))
    prefix_ids, p_blocks, _ = peng._prefixes[pid]
    n_pre, n_calls = len(prefix_ids), len(pre["calls"])
    consumers = sum(1 for p, out, _ in pre["calls"]
                    if len(p) > n_pre or len(out) > 1)
    bs = peng._alloc.block_size
    want = {"prefix_prefills": 1, "prefix_cache_hits": n_calls,
            "prefix_installs": n_calls, "prefix_cache_misses": 0,
            "kv_preemptions": 0,
            "prefix_tokens_reused": n_calls * n_pre,
            "prefill_tokens": sum(len(p) - n_pre for p, _, _ in pre["calls"]),
            "kv_cow_copies": consumers if n_pre % bs else 0}
    got = {k: st[k] for k in want}
    if got != want:
        fail(f"reuse: prefix run counters {got} != {want}")
    want_plain = sum(len(p) for p, _, _ in plain["calls"])
    if plain["stats"]["prefill_tokens"] != want_plain or \
            plain["stats"]["prefix_installs"] != 0:
        fail(f"reuse: plain run prefill_tokens "
             f"{plain['stats']['prefill_tokens']} != {want_plain}")
    # the engine's own grafted row (the prefix's blocks, the copied
    # boundary block and the suffix K1 wrote through the forked table)
    # against a plain engine's row for the same prompt (chunked prefill
    # through K1); then the engine's first-token log-prob against a plain
    # prefill's logits at that token
    prompt = pre["calls"][0][0]
    nblk, n_all = -(-n_pre // bs), len(prompt)
    peng.sample = greedy
    veng = plain["engine"]
    veng.sample = greedy
    rows = {}
    for eng, kw in ((peng, {"prefix_id": pid}), (veng, {})):
        cow0 = eng.stats()["kv_cow_copies"]
        rid = eng.submit(prompt, max_new_tokens=1, hold_slot=True, **kw)
        eng.run()
        row = eng._slot_held.index(rid)
        rows[eng is peng] = dict(
            rid=rid, cow=eng.stats()["kv_cow_copies"] - cow0,
            kv=gather_blocks_quant(eng.pool,
                                   eng._tables[row][:-(-n_all // bs)]))
    graft, full = rows[True], rows[False]
    if graft["cow"] != (1 if n_pre % bs else 0) or full["cow"] != 0:
        fail(f"reuse: the grafted row copied {graft['cow']} boundary "
             f"blocks, the plain row {full['cow']}")
    kv_err = _kv_rel_err(torch, graft["kv"], full["kv"], n_pre)
    sfx_err = _kv_rel_err(torch, graft["kv"], full["kv"], n_all, n_pre)
    if not max(kv_err, sfx_err) <= REUSE_KV_RTOL:
        fail(f"reuse: the grafted row's KV vs a plain prefill's: worst "
             f"per-layer relative RMS error {kv_err} over the prefix, "
             f"{sfx_err} over the suffix > {REUSE_KV_RTOL}")
    lg_plain = reference_logits(prompt)
    first = peng.result(graft["rid"])[0]
    lp_err = abs(peng.result_logps(graft["rid"])[0] - float(
        torch.log_softmax(lg_plain, dim=-1)[first]))
    if not lp_err <= LOGITS_ATOL:
        fail(f"reuse: the grafted row's first-token log-prob vs a plain "
             f"prefill's, |diff| {lp_err} > {LOGITS_ATOL}")
    agree = first == veng.result(full["rid"])[0] == int(lg_plain.argmax())
    peng.release_slot(graft["rid"])
    veng.release_slot(full["rid"])
    veng._alloc.check_leaks()
    saved = want_plain - st["prefill_tokens"]
    log(f"[reuse] {cfg.name}: the round's {len(ROUND_TASKS)} tasks x "
        f"{ROUND_GROUP} sessions, auto_prefix on / off: {n_calls} / "
        f"{len(plain['calls'])} LLM calls; one {n_pre}-token system prefix "
        f"({nblk} blocks) prefilled once, {st['prefix_cache_hits']} hits, "
        f"{st['kv_grafts']} grafts, {st['kv_cow_copies']} boundary-block "
        f"copies; prefill_tokens {st['prefill_tokens']} / {want_plain} "
        f"(counted saving {saved} = {n_calls} x {n_pre}; net of the one "
        f"registration prefill {saved - n_pre}); a {n_all}-token prompt's "
        f"grafted row ({graft['cow']} boundary-block copy) vs a plain "
        f"engine's, worst per-layer relative RMS {kv_err:.3g} over the "
        f"prefix, {sfx_err:.3g} over the suffix (tol {REUSE_KV_RTOL}); "
        f"first-token log-prob vs a plain prefill's |diff| {lp_err:.3g} "
        f"(tol {LOGITS_ATOL}), greedy token agreement {agree} "
        f"(information)")
    log(f"[reuse] {smi}. Smoke figures, not a benchmark: collect "
        f"{pre['collect_s']:.3f} s with the prefix, "
        f"{plain['collect_s']:.3f} s without; fused steps "
        f"{st['decode_steps']} / {plain['stats']['decode_steps']}")

    # 2. a held-slot continuation on the plain engine (greedy)
    p1 = plain["calls"][0][0]
    c0 = veng.stats()
    r1 = veng.submit(p1, max_new_tokens=16, hold_slot=True)
    veng.run()
    out1 = veng.result(r1)
    row = veng._slot_held.index(r1)
    hist = len(p1) + len(out1) - 1
    held = gather_blocks_quant(veng.pool, veng._tables[row])
    glue = tok.encode("\nNow run the tests.\n")
    full2 = p1 + out1 + glue
    r2 = veng.submit(full2, max_new_tokens=16, continue_from=r1,
                     hold_slot=True)
    veng.run()
    c1 = veng.stats()
    delta = {k: c1[k] - c0[k] for k in ("continuations",
                                        "continuation_delta_tokens",
                                        "prefills", "prefill_tokens")}
    want = {"continuations": 1, "continuation_delta_tokens": len(full2) - hist,
            "prefills": 1, "prefill_tokens": len(p1)}
    if delta != want:
        fail(f"reuse: continuation counters {delta} != {want}")
    veng.release_slot(r2)
    if any(h is not None for h in veng._slot_held):
        fail("reuse: release_slot left a hold")
    veng._alloc.check_leaks()
    lg_cont = reference_logits(full2[hist:], hist, held)
    lg_full = reference_logits(full2)
    cont_err = float((lg_cont - lg_full).abs().max())
    if not cont_err <= LOGITS_ATOL:
        fail(f"reuse: continuation logits vs a full re-prefill, max |diff| "
             f"{cont_err} > {LOGITS_ATOL}")
    # the policy client's multi-turn path (continue_turns)
    client = EnginePolicyClient(veng, tok, model_name=cfg.name,
                                default_max_new_tokens=16,
                                continue_turns=True)
    msgs = [ChatMessage("system", pre["system"])]
    k0 = veng.stats()["continuations"]
    for turn in ("Add a test for add().", "Run it.", "Summarize."):
        msgs.append(ChatMessage("user", turn))
        msgs.append(ChatMessage("assistant",
                                client.chat(msgs, temperature=0.0).text))
    client.release_held_slot()
    veng._alloc.check_leaks()
    log(f"[reuse] continuation: {len(p1)}-token turn + {len(out1)} "
        f"generated, held ({hist} resident tokens), then a "
        f"{len(full2) - hist}-token delta; counters {delta}; logits vs a "
        f"full re-prefill max |diff| {cont_err:.3g} (tol {LOGITS_ATOL}), "
        f"greedy token agreement "
        f"{int(lg_cont.argmax()) == int(lg_full.argmax())} (information); "
        f"a 3-turn continue_turns client made "
        f"{veng.stats()['continuations'] - k0} continuation(s)")
    retire(veng)
    del veng, runs, plain
    gc.collect()

    # 3. the host tier: a warm prefix tiers out under pressure and comes
    # back for its next consumer, bit for bit
    spare = 130
    heng = engine_for(num_slots=2, sample=greedy,
                      engine_config=EngineConfig(num_blocks=nblk + spare))
    swap_out_s, swap_in_s = [], []
    heng._swap_out_prefix = _timed(torch, heng._swap_out_prefix, swap_out_s)
    heng._restore_prefix = _timed(torch, heng._restore_prefix, swap_in_s)
    hid = heng.register_prefix(prefix_ids)
    user = tok.encode("Fix the failing test.\n")
    r = heng.submit(prefix_ids + user, max_new_tokens=8, prefix_id=hid)
    heng.run()
    before = gather_blocks_quant(heng.pool, heng._prefixes[hid][1])
    big = (prefix_ids + user) * 2
    big = big[:bs * (spare + 2) - 16]        # needs more than the spare
    rb = heng.submit(big, max_new_tokens=16)
    heng.run()
    if not heng.prefix_in_host_tier(hid) or len(swap_out_s) != 1:
        fail(f"reuse: the warm prefix did not tier out under pressure "
             f"(stats {heng.stats()})")
    r = heng.submit(prefix_ids + user, max_new_tokens=8, prefix_id=hid)
    heng.run()
    if heng.prefix_in_host_tier(hid) or len(swap_in_s) != 1:
        fail("reuse: the next consumer did not restore the prefix")
    after = gather_blocks_quant(heng.pool, heng._prefixes[hid][1])
    if not _payload_equal(torch, before, after):
        fail("reuse: restored prefix blocks differ from the blocks "
             "gathered before the swap")
    hst = heng.stats()
    if (hst["prefix_swap_outs"], hst["prefix_swap_ins"],
            hst["kv_swap_outs"], hst["kv_swap_ins"]) != (1, 1, nblk, nblk):
        fail(f"reuse: swap counters {hst}")
    swap_bytes = nblk * heng._alloc.bytes_per_block
    # a second round trip, called directly: the pinned host buffers now
    # come from the caching host allocator instead of a fresh page-lock
    heng._swap_out_prefix(hid)
    if not heng._restore_prefix(hid):
        fail("reuse: the second restore found no room")
    again = gather_blocks_quant(heng.pool, heng._prefixes[hid][1])
    if not _payload_equal(torch, before, again):
        fail("reuse: the second round trip changed the prefix's blocks")

    # a torn swap (the copy to the host fails) leaves the prefix resident
    def torn(_a):
        raise RuntimeError("copy to host failed")
    blocks = list(heng._prefixes[hid][1])
    heng._to_host = torn
    try:
        heng._swap_out_prefix(hid)
        fail("reuse: the forced torn swap did not raise")
    except RuntimeError:
        pass
    del heng._to_host
    if (heng._prefixes[hid][1] != blocks or heng.prefix_in_host_tier(hid)
            or any(heng._alloc.refcount(b) != 1 for b in blocks)):
        fail("reuse: a torn swap did not leave the prefix resident")
    heng.release_prefix(hid)
    heng._alloc.check_leaks()
    log(f"[reuse] host tier: pool of {nblk + spare} blocks, the "
        f"{nblk}-block prefix ({swap_bytes} bytes) swapped out under a "
        f"{len(big)}-token request and restored for the next consumer, "
        f"bit-identical; swap out {swap_out_s[0]:.4f} s "
        f"({swap_bytes / swap_out_s[0] / 1e9:.3f} GB/s), swap in "
        f"{swap_in_s[0]:.4f} s ({swap_bytes / swap_in_s[0] / 1e9:.3f} "
        f"GB/s); a second round trip {swap_out_s[1]:.4f} s "
        f"({swap_bytes / swap_out_s[1] / 1e9:.3f} GB/s) out, "
        f"{swap_in_s[1]:.4f} s ({swap_bytes / swap_in_s[1] / 1e9:.3f} "
        f"GB/s) in ({smi}); a forced torn swap left it resident")
    retire(heng)
    del heng
    gc.collect()

    # 4. export / import between two engines, bf16 and int8 pools
    moves = []
    k1_int8 = 0
    for dtype, src in (("bf16", peng), ("int8", None)):
        k1_0 = paged_flash_decode.launches
        if src is None:
            src = engine_for(num_slots=2, sample=greedy,
                             engine_config=EngineConfig(kv_dtype="int8"))
            spid = src.register_prefix(prefix_ids)
        else:
            spid = pid
        dst = engine_for(num_slots=2, sample=greedy,
                         engine_config=EngineConfig(kv_dtype=dtype))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks, kv, last = src.export_prefix(spid)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        qid = dst.import_prefix(toks, kv, last)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        a = gather_blocks_quant(src.pool, src._prefixes[spid][1])
        b = gather_blocks_quant(dst.pool, dst._prefixes[qid][1])
        if not _payload_equal(torch, a, b):
            fail(f"reuse: {dtype} import is not bit-identical to the "
                 f"exporter's blocks")
        rid = dst.submit(prefix_ids + tok.encode("Hi.\n"), max_new_tokens=8,
                         prefix_id=qid)
        dst.run()
        ds = dst.stats()
        if ds["kv_install_copies"] != nblk or ds["kv_grafts"] != 1 or \
                len(dst.result(rid)) == 0:
            fail(f"reuse: {dtype} import counters {ds}")
        dst.release_prefix(qid)
        dst._alloc.check_leaks()
        moves.append(f"{dtype} export {t1 - t0:.4f} s + import "
                     f"{t2 - t1:.4f} s ({kv.k.dtype}, "
                     f"{'quantized' if kv.quantized else 'full width'})")
        if src is not peng:
            src.release_prefix(spid)
            src._alloc.check_leaks()
            retire(src, dtype)
        retire(dst, dtype)
        if dtype == "int8":
            k1_int8 = paged_flash_decode.launches - k1_0
        del src, dst
    log(f"[reuse] export/import, {nblk} blocks, bit-identical: "
        f"{'; '.join(moves)}")
    peng.release_prefix(pid)
    peng._alloc.check_leaks()
    retire(peng)
    del peng
    gc.collect()

    # 5. the int8 slot cache (kv_quant, K3): a prefix and a continuation
    qcfg = dataclasses.replace(cfg, kv_quant=True, decode_attn_impl="flash")
    seng = engine_for(num_slots=4, config=qcfg, sample=greedy)
    steps0 = seng.stats()["decode_steps"]
    k3_0 = flash_decode.launches
    spid = seng.register_prefix(prefix_ids)
    suffix = tok.encode("Write the README.\n")
    s1 = seng.submit(prefix_ids + suffix, max_new_tokens=16, prefix_id=spid,
                     hold_slot=True)
    s2 = seng.submit(prefix_ids, max_new_tokens=16, prefix_id=spid)
    seng.run()
    full = prefix_ids + suffix + seng.result(s1) + glue
    hist_s = n_pre + len(suffix) + len(seng.result(s1)) - 1
    s3 = seng.submit(full, max_new_tokens=16, continue_from=s1)
    seng.run()
    ss = seng.stats()
    ones = sum(_chunk_sizes(n, seng.max_len).count(1)
               for n in (n_pre, len(suffix), len(full) - hist_s))
    k3 = flash_decode.launches - k3_0
    steps = ss["decode_steps"] - steps0
    if k3 != layers * (steps + ones) or k3 == 0:
        fail(f"reuse: int8 slots K3 launches {k3} != {layers} x ({steps} "
             f"decode steps + {ones} one-token chunks)")
    if (ss["prefix_installs"], ss["continuations"]) != (2, 1) or \
            any(len(seng.result(x)) != 16 for x in (s1, s2, s3)):
        fail(f"reuse: int8 slot prefix/continuation stats {ss}")
    log(f"[reuse] int8 slot cache (kv_quant, K3): prefix installed twice "
        f"(one with an empty suffix), a {len(full) - hist_s}-token "
        f"continuation; K3 launches {k3} = {layers} x ({steps} decode steps "
        f"+ {ones} one-token chunks)")
    del seng
    gc.collect()

    # 6. publish: update_params drops every prefix and hold; an
    # auto_prefix client re-registers
    eng = engine_for(num_slots=2, sample=greedy)
    client = EnginePolicyClient(eng, tok, model_name=cfg.name,
                                default_max_new_tokens=8, auto_prefix=True,
                                continue_turns=True)
    msgs = [ChatMessage("system", pre["system"]),
            ChatMessage("user", "Fix the bug.")]
    client.chat(msgs, temperature=0.0)
    if len(eng._prefixes) != 1 or all(h is None for h in eng._slot_held):
        fail("reuse: the client registered no prefix or held no slot")
    eng.update_params(params)
    if eng._prefixes or any(h is not None for h in eng._slot_held):
        fail("reuse: update_params kept a prefix or a hold")
    eng._alloc.check_leaks()
    client.chat(msgs, temperature=0.0)
    if eng.stats()["prefix_prefills"] != 2 or len(eng._prefixes) != 1:
        fail(f"reuse: the client did not re-register after the publish "
             f"({eng.stats()['prefix_prefills']} prefix prefills)")
    client.release_held_slot()
    for p in list(eng._prefixes):
        eng.release_prefix(p)
    eng._alloc.check_leaks()
    retire(eng)
    launches = {"k1": paged_flash_decode.launches - k1_int8,
                "k1_int8": k1_int8, "k3": flash_decode.launches,
                **{k: w.launches for k, w in k2.items()}}
    want = {"k1": layers * k1_steps["bf16"],
            "k1_int8": layers * k1_steps["int8"], "k3": k3,
            "fwd": 0, "dkdv": 0, "dq": 0}
    if launches != want or not all(launches[k] for k in ("k1", "k1_int8",
                                                         "k3")):
        fail(f"reuse: phase launches {launches} != {want} (K1: {layers} x "
             f"the fused steps {k1_steps}; K3: the int8 slot engine's)")
    log(f"[reuse] publish: update_params dropped the prefix and the hold, "
        f"the auto_prefix client re-registered; phase launches {launches} "
        f"(K1 = {layers} x {k1_steps} fused steps)")
    return launches


def _checksum(torch, tree):
    """Per tensor, the sums of its raw 16-bit words (all, and every 7th):
    equal trees give equal sums, a flipped bit changes one."""
    out = []
    for t in _leaves(tree):
        w = t.contiguous().view(torch.int16).reshape(-1)
        out.append((int(w.sum(dtype=torch.int64)),
                    int(w[::7].sum(dtype=torch.int64))))
    return out


def phase_async(torch, cfg, params, seed, smi):
    """The streaming learner at full width: AsyncGRPOTrainer for
    ASYNC_ROUNDS rounds (prefetch 1, importance correction, auto_prefix
    sessions on one shared engine, publish_params = engine.update_params,
    spread rewards), then one OnlineImprovementLoop round streaming into an
    ExperienceQueue and a StreamingTrainerAdapter step on its batch.
    Returns the trainer run's K1, K2 and K3 launches (K3 none: the
    engine is paged, and its prefix prefills run the einsum decode
    attention)."""
    import dataclasses
    import shutil

    import numpy as np
    from senweaver_ide_tpu_torch.apo import APOConfig, make_local_apo
    from senweaver_ide_tpu_torch.models import ByteTokenizer
    from senweaver_ide_tpu_torch.ops import flash_attention as fa
    from senweaver_ide_tpu_torch.ops.flash_decode import flash_decode
    from senweaver_ide_tpu_torch.ops.paged_attention import \
        paged_flash_decode
    from senweaver_ide_tpu_torch.rollout import (EnginePolicyClient,
                                                 RolloutEngine,
                                                 RolloutSession,
                                                 SampleParams)
    from senweaver_ide_tpu_torch.traces import TraceCollector
    from senweaver_ide_tpu_torch.training import (AsyncGRPOTrainer,
                                                  ExperienceQueue,
                                                  OnlineImprovementLoop,
                                                  StreamingTrainerAdapter,
                                                  assemble_batch,
                                                  behavior_logp_batched,
                                                  make_optimizer,
                                                  make_train_state)
    tcfg = dataclasses.replace(cfg, attn_impl="flash", remat=TRAIN_REMAT)
    layers = tcfg.num_layers
    tok = ByteTokenizer()
    engine = RolloutEngine(params, tcfg, num_slots=ROUND_SLOTS,
                           max_len=ROUND_MAX_LEN, sample=SampleParams(),
                           eos_id=tok.eos_id, seed=seed, device="cuda")
    work = _scratch_dir(0, "chip_smoke_async_ws_")
    n_sessions = [0]
    clients = []

    def make_session(rules=None, thread_id=None):
        n_sessions[0] += 1
        client = EnginePolicyClient(
            engine, tok, model_name=tcfg.name,
            default_max_new_tokens=ROUND_NEW_TOKENS, record_calls=True,
            auto_prefix=True)
        clients.append(client)
        kw = {} if thread_id is None else dict(
            apo_rules=list(rules or []), thread_id=thread_id,
            collector=collector)
        return RolloutSession(client, os.path.join(work,
                                                   f"ws{n_sessions[0]}"),
                              include_tool_definitions=False, **kw)

    state = make_train_state(tcfg, params=params,
                             optimizer=make_optimizer(TRAIN_LR))
    start_sum = _checksum(torch, params)
    trainer = AsyncGRPOTrainer(
        state, tcfg, None, make_session, list(ROUND_TASKS),
        group_size=ROUND_GROUP, pad_id=tok.pad_id, max_len=ROUND_MAX_LEN,
        reward_override=_spread_reward, max_parallel=ROUND_SLOTS,
        accum_steps=ROUND_ACCUM, prefetch=ASYNC_PREFETCH,
        publish_params=engine.update_params)
    rounds, publishes = [], []
    train_on, flush = trainer._train_on, trainer._flush_pending_publish

    def timed_train(item, wait_s):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = train_on(item, wait_s)
        torch.cuda.synchronize()
        rounds.append(dict(version=item.behavior_version,
                           collect_s=item.collect_s, wait_s=wait_s,
                           train_s=time.perf_counter() - t0,
                           staleness=res.staleness,
                           ratio_mean=res.metrics["ratio_mean"],
                           loss=res.metrics["loss"],
                           grad_norm=res.metrics["grad_norm"]))
        return res

    def recorded_flush():
        # what the flush applied, read after it (the trainer may stage a
        # newer version at any time; only the collector thread and the
        # end of run() flush)
        before = trainer._applied_behavior
        flush()
        applied = trainer._applied_behavior
        if applied is not before:
            if engine.params is not applied[1]:
                fail(f"async: the engine does not serve the params "
                     f"applied as version {applied[0]}")
            publishes.append(dict(version=applied[0], params=applied[1],
                                  sum=_checksum(torch, applied[1])))

    trainer._train_on = timed_train
    trainer._flush_pending_publish = recorded_flush
    k2 = {"fwd": fa.flash_attention_fwd,
          "dkdv": fa.flash_attention_bwd_dkdv,
          "dq": fa.flash_attention_bwd_dq}
    steps0 = engine.stats()["decode_steps"]
    paged_flash_decode.launches = 0
    flash_decode.launches = 0
    for w in k2.values():
        w.launches = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        results = trainer.run(ASYNC_ROUNDS)
    finally:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"k1": paged_flash_decode.launches,
                "k3": flash_decode.launches,
                **{k: w.launches for k, w in k2.items()}}
    peak = torch.cuda.max_memory_allocated()
    if launches["k3"] != 0:
        fail(f"async: K3 launched {launches['k3']} times on a paged engine")
    steps = engine.stats()["decode_steps"] - steps0
    if launches["k1"] != layers * steps or not steps:
        fail(f"async: K1 launches {launches['k1']} != {layers} x {steps} "
             f"fused steps")
    per_pass = layers * ROUND_ACCUM * ASYNC_ROUNDS
    want = {"fwd": per_pass * (2 if TRAIN_REMAT else 1), "dkdv": per_pass,
            "dq": per_pass}
    if {k: launches[k] for k in want} != want:
        fail(f"async: K2 launches {launches} != {want}")
    if len(results) != ASYNC_ROUNDS or any(
            not np.isfinite(r.metrics.get("loss", np.nan))
            for r in results):
        fail(f"async: {len(results)} rounds, metrics "
             f"{[r.metrics for r in results]}")
    # every cached version is, bit for bit, what the engine served
    cache = trainer.behavior_cache
    by_obj = {id(p["params"]): p for p in publishes}
    cache_bytes = 0
    for v in cache.versions():
        entry = cache.get(v)
        pub = by_obj.get(id(entry))
        if pub is None or pub["version"] != v:
            fail(f"async: cached version {v} is not the params published "
                 f"as version {v}")
        if _checksum(torch, entry) != pub["sum"]:
            fail(f"async: cached version {v} changed after its publish")
        cache_bytes += _tree_bytes(entry)
    if engine.params is not publishes[-1]["params"] or \
            _checksum(torch, engine.params) != \
            _checksum(torch, trainer.state.params):
        fail("async: the engine does not end on the final params")
    if _checksum(torch, trainer.state.params) == start_sum:
        fail("async: the params did not move")
    for r in rounds:
        log(f"[async] round v{r['version']}: collect_s {r['collect_s']:.3f}, "
            f"wait_s {r['wait_s']:.3f}, train_s {r['train_s']:.3f}, "
            f"staleness {r['staleness']}, ratio_mean {r['ratio_mean']:.6f}, "
            f"loss {r['loss']:.6g}, grad_norm {r['grad_norm']:.6g}")
    log(f"[async] {smi}. Smoke figures, not a benchmark: {ASYNC_ROUNDS} "
        f"rounds (prefetch {ASYNC_PREFETCH}) in {wall:.3f} s; "
        f"{len(publishes)} publishes (versions "
        f"{[p['version'] for p in publishes]}); behaviour cache versions "
        f"{cache.versions()} holding {cache_bytes} bytes, each bit-identical "
        f"to what the engine served; {steps} fused steps, launches "
        f"{launches}; peak max_memory_allocated {peak} bytes")

    # one online round streaming its episodes into an ExperienceQueue,
    # then a StreamingTrainerAdapter step on the batch
    collector = TraceCollector()
    queue = ExperienceQueue(group_size=ROUND_GROUP)
    apo = make_local_apo(collector, EnginePolicyClient(engine, tok),
                         config=APOConfig(min_traces_for_analysis=10 ** 9),
                         device="cuda")
    behavior = engine.params        # served through the round, a copy
    loop = OnlineImprovementLoop(
        trainer.state, tcfg, None, make_session, list(ROUND_TASKS), apo=apo,
        collector=collector, engine=engine, group_size=ROUND_GROUP,
        pad_id=tok.pad_id, max_len=ROUND_MAX_LEN, max_parallel=ROUND_SLOTS,
        reward_override=_spread_reward, checkpoint_every=0,
        accum_steps=ROUND_ACCUM, experience_sink=queue)
    n_clients = len(clients)
    try:
        res = loop.run_round()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    calls = sum(len(c.call_log) for c in clients[n_clients:])
    offered = queue.stats()["accepted"]
    groups = len(ROUND_TASKS) * ROUND_GROUP
    if offered != calls or res.episodes != groups:
        fail(f"async: {offered} episodes offered to the sink for {calls} "
             f"LLM calls of {res.episodes} episodes (groups x group size "
             f"{groups})")
    batch = queue.take_batch(current_version=0)
    if not batch:
        fail(f"async: the sink released no batch ({queue.stats()})")
    # the adapter's layout: max_len as it assembles the batch
    _, tokens, mask, _, _, old = assemble_batch(batch, pad_id=tok.pad_id,
                                                max_len=ROUND_MAX_LEN)
    if old is None:
        fail("async: streamed episodes carry no behaviour log-probs")
    recomputed = behavior_logp_batched(behavior, tcfg, tokens,
                                       ROUND_ACCUM).float().cpu().numpy()
    sel = mask[:, 1:]
    diff = np.abs(old[sel] - recomputed[sel])
    if not diff.mean() <= STREAM_LOGP_TOL:
        fail(f"async: streamed old_logp vs behavior_logp_batched on the "
             f"card, mean |diff| {diff.mean()} > {STREAM_LOGP_TOL}")
    # the loop trained on its round after sampling it, so the adapter's
    # params are one update past the behaviour params: its ratio is the
    # recorded old_logp against the params it trains, not 1
    current = behavior_logp_batched(loop.state.params, tcfg, tokens,
                                    ROUND_ACCUM).float().cpu().numpy()
    want_ratio = float(np.exp(current[sel] - old[sel]).mean())
    adapter = StreamingTrainerAdapter(loop.state, tcfg, None,
                                      pad_id=tok.pad_id,
                                      max_len=ROUND_MAX_LEN,
                                      accum_steps=ROUND_ACCUM)
    m = adapter.train_on_batch(batch)
    ratio_err = abs(m["ratio_mean"] - want_ratio)
    if not all(np.isfinite(v) for v in m.values()) or \
            not ratio_err < ADAPTER_RATIO_TOL:
        fail(f"async: adapter step ratio_mean {m['ratio_mean']} against "
             f"{want_ratio} from the recorded old_logp and the params it "
             f"trains (|diff| {ratio_err}, tol {ADAPTER_RATIO_TOL}); "
             f"metrics {m}")
    engine._alloc.check_leaks()
    log(f"[async] sink round: {res.episodes} episodes ({calls} LLM calls) "
        f"offered {offered} streamed episodes (groups x group size "
        f"{groups}); a batch of {len(batch)}: recorded old_logp vs "
        f"behavior_logp_batched on the card over {int(sel.sum())} "
        f"completion tokens, mean |diff| {diff.mean():.4g}, max "
        f"{diff.max():.4g} (tol on the mean {STREAM_LOGP_TOL}); adapter "
        f"step ratio_mean {m['ratio_mean']:.6f} against {want_ratio:.6f} "
        f"from the recorded old_logp and the loop's updated params "
        f"(|diff| {ratio_err:.3g}, tol {ADAPTER_RATIO_TOL}), loss "
        f"{m['loss']:.6g}")
    return launches


# The speculation path (phase_spec): the serving phase's paged engine,
# greedy, at full qwen2.5-coder-1.5b width, with a qwen2.5-coder-0.5b
# draft (random weights from --seed + 1); SPEC_REQUESTS prompts of
# SPEC_PROMPT_LENS tokens, SPEC_NEW_TOKENS new each.
SPEC_SLOTS, SPEC_MAX_LEN, SPEC_REQUESTS = 16, 2048, 16
SPEC_PROMPT_LENS, SPEC_NEW_TOKENS = (128, 1024), 32
SPEC_DEPTHS = (2, 4, 8)
SPEC_SELF_REQUESTS = 4
# The self-draft (draft = target) at depth 4 must accept at least this
# share: every proposal equals the target's argmax but where the draft's
# decode entries and the verify window round a near-tie differently in
# bf16 (PERF.md gives the bound's reasoning).
SPEC_SELF_ACCEPT_MIN = 0.5
# The draft's distillation: DRAFT_DISTILL_STEPS CE steps on the depth-4
# run's harvested outcomes, attn_impl="flash" (K2)
DRAFT_DISTILL_STEPS, DRAFT_DISTILL_BATCH = 8, 8
# SpeculativeDecoder: one prompt, k, new tokens; the slot cache at a
# 128-aligned length (K3 serves the draft's one-token feeds)
DECODER_PROMPT, DECODER_NEW, DECODER_K, DECODER_MAX_LEN = 512, 64, 4, 640
# The logit paths whose rounding may flip a near-tie argmax: each of
# TIE_ROWS prompts' last TIE_DEPTH tokens as one verify window on the
# pool and on a slot cache, as single decode entries (alone and one per
# row in a batch), as the last token of a chunked prefill and through the
# plain forward (no cache, no K1). Every emitted token is held by teacher
# forcing through the plain forward: it must be the argmax at its own
# position or within SPEC_TIE_ATOL of it. SPEC_TIE_ATOL is TIE_FACTOR
# times the largest difference between any two paths, that difference
# capped at TIE_DIFF_MAX (four bf16 ulps at |logit| in [4, 8)), so a
# verify path that is off cannot widen its own tolerance. An argmax
# taken on one path sits at most two such differences below the other
# path's argmax.
TIE_ROWS, TIE_DEPTH, TIE_PROMPT, TIE_FACTOR = 8, 8, 600, 2.0
TIE_DIFF_MAX = 0.125
# The group path (phase_group): one prompt, GROUP_SIZE members, greedy
GROUP_SIZE, GROUP_PROMPT, GROUP_NEW = 8, 1000, 64
# The tree round: 2 token-list tasks x TREE_GROUP, each root branching
# once (max depth 1) after min_tokens_between tokens, speculation at depth
# 4; grpo_round's planner path decodes collect_tree_trajectories' default
# 128 new tokens a leaf
TREE_TASK_LENS, TREE_GROUP = (600, 900), 4
TREE_POLICY = dict(max_leaves=8, max_depth=1, branch_width=2,
                   min_tokens_between=8, logp_threshold=0.0)


def _top2_gap(torch, logits):
    top = torch.topk(logits.float(), 2).values
    return float(top[0] - top[1])


def _spec_tie_atol(torch, params, cfg, rng):
    """The largest logit difference between the paths a token's logits
    can take on the card: a verify window (all rows' windows in one
    fused step, two-entry tiles), single decode entries (T = 1), a decode
    batch (one entry a row), the last token of a chunked prefill
    (``_paged_logits``), a verify window on a slot cache (the slots
    ``SpeculativeDecoder``'s target) and the plain forward that
    ``_teacher_forced`` runs. Returns (tie tolerance, that difference)."""
    from senweaver_ide_tpu_torch.models import (forward, forward_paged,
                                                init_kv_cache)
    from senweaver_ide_tpu_torch.rollout import init_paged_pool
    bs, n, k = 16, TIE_PROMPT, TIE_DEPTH
    prompts = [rng.integers(0, cfg.vocab_size, size=n + k).tolist()
               for _ in range(TIE_ROWS)]
    per_row = -(-(n + k) // bs)
    tables = torch.arange(TIE_ROWS * per_row, dtype=torch.int32).view(
        TIE_ROWS, per_row)

    def feed(pool, rows, poss):
        toks = torch.tensor([prompts[r][p] for r, p in zip(rows, poss)])
        rows, poss = torch.tensor(rows), torch.tensor(poss)
        with torch.no_grad():
            logits, _ = forward_paged(
                params, cfg, toks, pool=pool, tables=tables, seq_row=rows,
                positions=poss, write_block=tables[rows, poss // bs].long(),
                write_off=poss % bs, use_kernel=True)
        return logits.float()

    def slots(r):
        cache = init_kv_cache(cfg, 1, n + k, device="cuda")
        toks = torch.tensor(prompts[r], device="cuda")[None]
        with torch.no_grad():
            _, cache = forward(params, cfg, toks[:, :n], cache=cache)
            logits, _ = forward(params, cfg, toks[:, n:], cache=cache)
        return logits[0].float()

    pool = init_paged_pool(cfg, TIE_ROWS * per_row, bs, device="cuda")
    for r in range(TIE_ROWS):
        feed(pool, [r] * n, list(range(n)))
    paths = {}
    copy = lambda: type(pool)(*(None if a is None else a.clone()  # noqa
                                for a in pool))
    win = feed(copy(), [r for r in range(TIE_ROWS) for _ in range(k)],
               [n + j for _ in range(TIE_ROWS) for j in range(k)])
    paths["verify"] = win.view(TIE_ROWS, k, -1)
    one, batch = copy(), copy()
    paths["decode"] = torch.stack([torch.cat([
        feed(one, [r], [n + j]) for j in range(k)]) for r in range(TIE_ROWS)])
    paths["decode_batch"] = torch.stack([
        feed(batch, list(range(TIE_ROWS)), [n + j] * TIE_ROWS)
        for j in range(k)], dim=1)
    paths["prefill"] = torch.stack([torch.stack([
        _paged_logits(torch, params, cfg, prompts[r][:n + j + 1])
        for j in range(k)]) for r in range(TIE_ROWS)])
    paths["slots_verify"] = torch.stack([slots(r) for r in range(TIE_ROWS)])
    with torch.no_grad():
        paths["plain"] = torch.stack([forward(
            params, cfg, torch.tensor(prompts[r], device="cuda")[None])[
                0, n:n + k].float() for r in range(TIE_ROWS)])
    names = list(paths)
    diff = max(float((paths[a] - paths[b]).abs().max())
               for i, a in enumerate(names) for b in names[i + 1:])
    return TIE_FACTOR * min(diff, TIE_DIFF_MAX), diff


def _teacher_forced(torch, params, cfg, prompts, streams, tie_atol, label,
                    ref=None):
    """Every token of every stream held by teacher forcing: one plain
    forward (no cache, no K1) over prompt + stream, and each token must be
    the argmax at its own position or within ``tie_atol`` below it.
    Returns (the index at which each stream first leaves its ``ref``
    stream, None where it does not; the widest gap below the argmax of an
    emitted token; the number of emitted tokens that are not the plain
    forward's argmax)."""
    from senweaver_ide_tpu_torch.models import forward
    leaves, widest, off = [], 0.0, 0
    for i, (prompt, have) in enumerate(zip(prompts, streams)):
        if ref is not None:
            want = ref[i]
            if len(want) != len(have):
                fail(f"{label}: a stream of {len(have)} tokens against the "
                     f"reference's {len(want)}")
            leaves.append(next((j for j, (a, b) in enumerate(zip(want, have))
                                if a != b), None))
        if not have:
            continue
        toks = torch.tensor(list(prompt) + list(have[:-1]), device="cuda")
        got = torch.tensor(have, device="cuda")
        with torch.no_grad():
            logits = forward(params, cfg, toks[None])[0, len(prompt) - 1:]
            gaps = (logits.max(-1).values
                    - logits.gather(-1, got[:, None])[:, 0]).float()
        at = int(gaps.argmax())
        gap = float(gaps[at])
        if not gap <= tie_atol:
            fail(f"{label}: stream {i}'s token {at} lies {gap:.4f} below the "
                 f"plain forward's argmax at its position (SPEC_TIE_ATOL "
                 f"{tie_atol:.4f})")
        widest = max(widest, gap)
        off += int((gaps > 0).sum())
    return leaves, widest, off


def _log_held(tag, held, tie_atol):
    """One line a run: each stream's first index off its reference stream
    (None: it never leaves), the widest gap of an emitted token below the
    plain forward's argmax, and how many emitted tokens were not that
    argmax."""
    for name, (leaves, widest, off) in held.items():
        log(f"[{tag}] teacher-forced, {name}: every token within "
            f"SPEC_TIE_ATOL {tie_atol:.4f} of the plain forward's argmax "
            f"(widest gap {widest:.4f}, {off} tokens off the argmax); first "
            f"index off the reference per stream {leaves or 'n/a'}")


def _ledger_ms(obs):
    led = obs.get_profiler().ledger()
    return {n: led.get(n, {}).get("step_ms_sum", 0.0)
            for n in ("engine.spec_propose", "engine.spec_feed",
                      "engine.fused_step")}


def _spec_drive(torch, obs, engine, prompts, layers, dlayers, label, smi):
    """Submit every prompt, drive to completion with K1's count zeroed,
    and hold K1 to layers x fused steps + draft layers x draft forwards.
    Returns (streams, summary)."""
    from senweaver_ide_tpu_torch.ops.paged_attention import \
        paged_flash_decode
    rids = [engine.submit(p, max_new_tokens=SPEC_NEW_TOKENS)
            for p in prompts]
    led0 = _ledger_ms(obs)
    paged_flash_decode.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while engine.has_work:
        engine.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1 = paged_flash_decode.launches
    led = {n: v - led0[n] for n, v in _ledger_ms(obs).items()}
    st = engine.stats()
    sp = engine._spec
    fwd = (sp.propose_forwards + sp.feed_forwards) if sp else 0
    want = layers * st["decode_steps"] + dlayers * fwd
    if k1 != want:
        fail(f"{label}: K1 launches {k1} != {layers} x {st['decode_steps']} "
             f"fused steps + {dlayers} x {fwd} draft forwards")
    streams = [engine.result(r) for r in rids]
    if any(len(s) != SPEC_NEW_TOKENS for s in streams):
        fail(f"{label}: a greedy request stopped early")
    engine._alloc.check_leaks()
    engine.spec_check_leaks()
    ss = engine.spec_stats()
    out = dict(label=label, wall_s=wall, fused_steps=st["decode_steps"],
               tokens=st["tokens_emitted"],
               tok_s=st["tokens_emitted"] / wall, k1=k1,
               draft_forwards=fwd, propose_s=led["engine.spec_propose"] / 1e3,
               feed_s=led["engine.spec_feed"] / 1e3,
               fused_s=led["engine.fused_step"] / 1e3)
    if ss["enabled"]:
        out.update(rounds=ss["rounds"], proposed=ss["proposed"],
                   accepted=ss["accepted"],
                   acceptance=ss["accepted"] / max(1, ss["proposed"]),
                   wasted=ss["wasted_draft_tokens"],
                   feed_tokens=ss["draft_feed_tokens"], depth=ss["depth"])
    log(f"[spec] {label}, {smi}: wall {wall:.2f} s, {out['tokens']} tokens "
        f"= {out['tok_s']:.1f} tok/s, {out['fused_steps']} fused steps"
        + (f", rounds {out['rounds']}, acceptance {out['acceptance']:.3f} "
           f"({out['accepted']}/{out['proposed']}), wasted draft tokens "
           f"{out['wasted']}, draft feed tokens {out['feed_tokens']}, last "
           f"depth {out['depth']}" if ss["enabled"] else "")
        + f"; ledger: propose {out['propose_s']:.3f} s, feed "
        f"{out['feed_s']:.3f} s, fused (verify) steps {out['fused_s']:.3f} "
        f"s; K1 {k1} = {layers} x {out['fused_steps']} + {dlayers} x {fwd}")
    return streams, out


def _ce(torch, params, cfg, toks, mask):
    from senweaver_ide_tpu_torch.models import forward
    from senweaver_ide_tpu_torch.training.grpo import token_logprobs
    toks = torch.from_numpy(toks).cuda()
    m = torch.from_numpy(mask).cuda()[:, 1:].float()
    with torch.no_grad():
        logp = token_logprobs(forward(params, cfg, toks[:, :-1]),
                              toks[:, 1:])
    return float(-(logp * m).sum() / m.sum().clamp_min(1.0))


def phase_spec(torch, cfg, params, seed, smi, dcfg=None):
    """Speculative decoding at full width: the engine's fused speculation
    at fixed depths, under the default controller and with a self-draft,
    every stream held to the non-speculative reference; a publish
    stamping the draft stale; the draft's distillation on the harvested
    outcomes (K2) and its install; SpeculativeDecoder on both layouts
    (K1, and K3 for the slot cache's one-token draft feeds)."""
    import dataclasses

    import numpy as np
    from senweaver_ide_tpu_torch import obs
    from senweaver_ide_tpu_torch.models import (init_params,
                                                qwen2_5_coder_0_5b)
    from senweaver_ide_tpu_torch.ops import flash_attention as fa
    from senweaver_ide_tpu_torch.ops.flash_decode import flash_decode
    from senweaver_ide_tpu_torch.rollout import (RolloutEngine,
                                                 SampleParams,
                                                 SpeculativeDecoder)
    from senweaver_ide_tpu_torch.training import DraftDistiller
    dcfg = dcfg or qwen2_5_coder_0_5b()
    layers, dlayers = cfg.num_layers, dcfg.num_layers
    draft = init_params(dcfg, torch.Generator(device="cuda").manual_seed(
        seed + 1), device="cuda")
    log(f"[spec] draft {dcfg.name}: {dlayers} layers, hidden "
        f"{dcfg.hidden_size}, heads {dcfg.num_heads}/{dcfg.num_kv_heads} D "
        f"{dcfg.head_dim}, random weights (seed {seed + 1})")
    rng = np.random.default_rng(seed + 10)
    obs.set_profiler(obs.RuntimeProfiler())
    tie_atol, tie_diff = _spec_tie_atol(torch, params, cfg, rng)
    log(f"[spec] logit paths (verify window on the pool and on a slot "
        f"cache, decode entries alone and batched, chunked prefill, plain "
        f"forward; {TIE_ROWS} rows x {TIE_DEPTH} positions after "
        f"{TIE_PROMPT} tokens): max |diff| {tie_diff:.4f}; SPEC_TIE_ATOL = "
        f"{TIE_FACTOR} x min(that, TIE_DIFF_MAX {TIE_DIFF_MAX}) = "
        f"{tie_atol:.4f}")
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).tolist()
               for n in rng.integers(SPEC_PROMPT_LENS[0],
                                     SPEC_PROMPT_LENS[1] + 1,
                                     size=SPEC_REQUESTS)]
    greedy = SampleParams(0.0, 0, 1.0)

    def engine():
        return RolloutEngine(params, cfg, num_slots=SPEC_SLOTS,
                             max_len=SPEC_MAX_LEN, sample=greedy, seed=seed,
                             device="cuda")

    torch.cuda.reset_peak_memory_stats()
    eng = engine()
    ref, base = _spec_drive(torch, obs, eng, prompts, layers, 0,
                            "reference (no speculation)", smi)
    del eng
    runs = {"reference": base}
    k1_total = base["k1"]
    held = {"reference": _teacher_forced(torch, params, cfg, prompts, ref,
                                         tie_atol, "reference")}
    # one depth-4 run serves all SPEC_REQUESTS prompts (the distiller's
    # harvest); every other speculative run serves the first
    # SPEC_SELF_REQUESTS of them
    few = prompts[:SPEC_SELF_REQUESTS]

    def spec_run(name, draft_params, draft_cfg, ps=few, install=None, **kw):
        nonlocal k1_total
        name = f"{name}, {len(ps)} requests"
        eng = engine()
        eng.enable_speculation(draft_params, draft_cfg, **kw)
        if install is not None:
            install(eng)
        streams, out = _spec_drive(torch, obs, eng, ps, layers,
                                   draft_cfg.num_layers, name, smi)
        k1_total += out["k1"]
        held[name] = _teacher_forced(torch, params, cfg, ps, streams,
                                     tie_atol, name, ref=ref[:len(ps)])
        runs[name] = out
        return eng, out

    eng, before = spec_run("depth 4", draft, dcfg, ps=prompts, depth=4)
    # the distiller's data, then a publish on the target
    distiller = DraftDistiller(
        draft, dataclasses.replace(dcfg, attn_impl="flash"),
        batch_size=DRAFT_DISTILL_BATCH, seed=seed)
    harvested = distiller.harvest(eng)
    if harvested != min(before["rounds"], 512):
        fail(f"spec: harvested {harvested} outcomes of {before['rounds']} "
             f"rounds")
    eng.update_params(params)
    ss = eng.spec_stats()
    if ss["draft_staleness"] != 1 or ss["acceptance_ema"] is not None:
        fail(f"spec: a target publish left staleness "
             f"{ss['draft_staleness']}, EMA {ss['acceptance_ema']}")
    log("[spec] update_params on the target: draft staleness 1, "
        "acceptance EMA reset")
    del eng
    for depth in SPEC_DEPTHS:
        if depth != 4:
            spec_run(f"depth {depth}", draft, dcfg, depth=depth)
    spec_run("controller ladder", draft, dcfg)
    # the self-draft (draft = target): a draft that agrees is accepted,
    # and takes fewer rounds at depth 8 than at depth 2
    self_runs = {d: spec_run(f"self-draft depth {d}", params, cfg,
                             depth=d)[1] for d in SPEC_DEPTHS}
    acc_self = self_runs[4]["acceptance"]
    if acc_self < SPEC_SELF_ACCEPT_MIN:
        fail(f"spec: self-draft acceptance {acc_self:.3f} < "
             f"{SPEC_SELF_ACCEPT_MIN}")
    if not self_runs[8]["rounds"] < self_runs[2]["rounds"]:
        fail(f"spec: the self-draft took {self_runs[8]['rounds']} rounds at "
             f"depth 8 against {self_runs[2]['rounds']} at depth 2")

    # -- the draft's distillation on the harvested outcomes (K2) ---------
    fixed = distiller.batch()
    ce0 = _ce(torch, distiller.params, distiller.config, *fixed)
    k2 = (fa.flash_attention_fwd, fa.flash_attention_bwd_dkdv,
          fa.flash_attention_bwd_dq)
    for w in k2:
        w.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [distiller.step() for _ in range(DRAFT_DISTILL_STEPS)]
    torch.cuda.synchronize()
    distill_s = time.perf_counter() - t0
    k2_launches = {n: w.launches for n, w in zip(("fwd", "dkdv", "dq"), k2)}
    want = dlayers * DRAFT_DISTILL_STEPS
    if any(v != want for v in k2_launches.values()):
        fail(f"spec: distillation K2 launches {k2_launches}, expected "
             f"{want} each ({dlayers} layers x {DRAFT_DISTILL_STEPS} steps)")
    if not all(np.isfinite(losses)):
        fail(f"spec: non-finite distillation loss {losses}")
    ce1 = _ce(torch, distiller.params, distiller.config, *fixed)
    if not ce1 < ce0:
        fail(f"spec: CE on a fixed harvested batch {ce0:.4f} -> {ce1:.4f} "
             f"did not fall")
    log(f"[spec] distillation, {smi}: {harvested} outcomes harvested, "
        f"{DRAFT_DISTILL_STEPS} steps of batch {DRAFT_DISTILL_BATCH} x "
        f"{fixed[0].shape[1]} in {distill_s:.3f} s, losses "
        f"{[round(x, 4) for x in losses]}; CE on a fixed harvested batch "
        f"{ce0:.4f} -> {ce1:.4f}; K2 launches {k2_launches} = {dlayers} x "
        f"{DRAFT_DISTILL_STEPS}")
    eng, after = spec_run("depth 4, distilled draft", draft, dcfg,
                          install=distiller.install, depth=4)
    if eng.spec_stats()["draft_version"] != 1:
        fail("spec: the distilled draft was not installed")
    del eng
    log(f"[spec] acceptance at depth 4: {before['acceptance']:.4f} before "
        f"distillation ({len(prompts)} requests), {after['acceptance']:.4f} "
        f"after ({len(few)} requests)")

    # -- SpeculativeDecoder, both layouts ------------------------------
    prompt = rng.integers(0, cfg.vocab_size, size=DECODER_PROMPT).tolist()
    ref_eng = RolloutEngine(params, cfg, num_slots=1,
                            max_len=DECODER_MAX_LEN, sample=greedy,
                            device="cuda")
    rid = ref_eng.submit(prompt, max_new_tokens=DECODER_NEW)
    dec_ref = ref_eng.run()[rid]
    del ref_eng
    held["decoder reference"] = _teacher_forced(
        torch, params, cfg, [prompt], [dec_ref], tie_atol,
        "decoder reference")
    fd_cfg = dataclasses.replace(dcfg, decode_attn_impl="flash")
    for layout in ("paged", "slots"):
        dec = SpeculativeDecoder(params, cfg, draft,
                                 fd_cfg if layout == "slots" else dcfg,
                                 k=DECODER_K, kv_layout=layout)
        flash_decode.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = dec.generate(prompt, max_new_tokens=DECODER_NEW,
                           max_len=DECODER_MAX_LEN)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k3 = flash_decode.launches
        held[f"decoder {layout}"] = _teacher_forced(
            torch, params, cfg, [prompt], [got], tie_atol,
            f"decoder {layout}", ref=[dec_ref])
        if layout == "paged":
            for kv in dec._last_paged_kv:
                if kv.allocator.used_blocks != len(kv.table):
                    fail("decoder: a rolled-back block was not released")
                kv.free()
                kv.allocator.check_leaks()
            if k3:
                fail(f"decoder paged: K3 launched {k3} times")
        elif k3 != dlayers * DECODER_K * dec.rounds:
            fail(f"decoder slots: K3 launches {k3} != {dlayers} x "
                 f"{DECODER_K} x {dec.rounds} one-token draft feeds")
        log(f"[spec] SpeculativeDecoder {layout}, {smi}: {DECODER_PROMPT}-"
            f"token prompt, {len(got)} new in {wall:.2f} s = "
            f"{len(got) / wall:.1f} tok/s, {dec.rounds} rounds of k="
            f"{DECODER_K}, acceptance {dec.acceptance_rate:.3f}"
            + (f", K3 {k3} = {dlayers} x {DECODER_K} x "
                          f"{dec.rounds}" if layout == "slots" else
                          ", every block freed"))
    peak = torch.cuda.max_memory_allocated()
    _log_held("spec", held, tie_atol)
    log(f"[spec] peak memory {peak} bytes; {smi}")
    del draft, distiller
    return {"k1": k1_total, "k3": k3, **k2_launches, "tie_atol": tie_atol}


def phase_group(torch, cfg, params, seed, smi, tie_atol, dcfg=None):
    """Group-shared rollout at full width: a group of GROUP_SIZE on one
    prompt pays one prefill and matches independent submits; then a tree
    GRPO round through GroupRollout with speculation on (K1 on both
    pools, K2 in the update)."""
    import dataclasses

    import numpy as np
    from senweaver_ide_tpu_torch import obs
    from senweaver_ide_tpu_torch.models import (init_params,
                                                qwen2_5_coder_0_5b)
    from senweaver_ide_tpu_torch.ops import flash_attention as fa
    from senweaver_ide_tpu_torch.ops.flash_decode import flash_decode
    from senweaver_ide_tpu_torch.ops.paged_attention import \
        paged_flash_decode
    from senweaver_ide_tpu_torch.rollout import (BranchPolicy,
                                                 GroupRollout,
                                                 RolloutEngine,
                                                 SampleParams)
    from senweaver_ide_tpu_torch.training import (grpo_round,
                                                  make_optimizer,
                                                  make_train_state)
    dcfg = dcfg or qwen2_5_coder_0_5b()
    layers, dlayers = cfg.num_layers, dcfg.num_layers
    rng = np.random.default_rng(seed + 20)
    greedy = SampleParams(0.0, 0, 1.0)
    prompt = rng.integers(0, cfg.vocab_size, size=GROUP_PROMPT).tolist()
    # the phase runs no slot cache: K3 is read at its end and must be 0
    flash_decode.launches = 0

    # -- independent submits, then the group --------------------------
    eng = RolloutEngine(params, cfg, num_slots=GROUP_SIZE, max_len=2048,
                        sample=greedy, device="cuda")
    rids = [eng.submit(prompt, max_new_tokens=GROUP_NEW)
            for _ in range(GROUP_SIZE)]
    eng.run()
    ref = [eng.result(r) for r in rids]
    del eng
    eng = RolloutEngine(params, cfg, num_slots=GROUP_SIZE, max_len=2048,
                        sample=greedy, device="cuda")
    paged_flash_decode.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids = eng.submit_group(prompt, GROUP_SIZE, max_new_tokens=GROUP_NEW)
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1_group = paged_flash_decode.launches
    st = eng.stats()
    if k1_group != layers * st["decode_steps"]:
        fail(f"group: K1 launches {k1_group} != {layers} x "
             f"{st['decode_steps']}")
    followers = GROUP_SIZE - 1
    want = {"prefills": 1, "group_prefills": 1, "group_forks": followers,
            "prefill_tokens": GROUP_PROMPT + followers,
            "group_prefill_tokens_avoided": followers * (GROUP_PROMPT - 1),
            "group_degrades": 0}
    got = {k: st[k] for k in want}
    if got != want:
        fail(f"group: counters {got}, expected {want}")
    held = {
        "independent submits": _teacher_forced(
            torch, params, cfg, [prompt] * GROUP_SIZE, ref, tie_atol,
            "independent submits"),
        "group": _teacher_forced(
            torch, params, cfg, [prompt] * GROUP_SIZE,
            [eng.result(r) for r in rids], tie_atol, "group", ref=ref)}
    eng._alloc.check_leaks()
    log(f"[group] {smi}: submit_group of {GROUP_SIZE} on a {GROUP_PROMPT}-"
        f"token prompt, {GROUP_NEW} new: wall {wall:.2f} s, "
        f"{st['decode_steps']} fused steps, counters {got}, "
        f"kv_cow_copies {st['kv_cow_copies']}; K1 {k1_group}")
    _log_held("group", held, tie_atol)
    del eng

    # -- the tree round, speculation on ----------------------------------
    tcfg = dataclasses.replace(cfg, attn_impl="flash", remat=TRAIN_REMAT)
    draft = init_params(dcfg, torch.Generator(device="cuda").manual_seed(
        seed + 1), device="cuda")
    eng = RolloutEngine(params, tcfg, num_slots=SPEC_SLOTS, max_len=2048,
                        sample=greedy, device="cuda")
    eng.enable_speculation(draft, dcfg, depth=4)
    planner = GroupRollout(eng, BranchPolicy(**TREE_POLICY))
    tasks = [rng.integers(0, cfg.vocab_size, size=n).tolist()
             for n in TREE_TASK_LENS]
    state = make_train_state(tcfg, params=params,
                             optimizer=make_optimizer(TRAIN_LR))
    k2 = (fa.flash_attention_fwd, fa.flash_attention_bwd_dkdv,
          fa.flash_attention_bwd_dq)
    paged_flash_decode.launches = 0
    for w in k2:
        w.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = grpo_round(state, tcfg, None, None, tasks, group_size=TREE_GROUP,
                     pad_id=0, accum_steps=ROUND_ACCUM,
                     reward_override=lambda ti, li, rec: (
                         1.0 if li % 2 == 0 else -1.0),
                     planner=planner, engine=eng)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"k1": paged_flash_decode.launches,
                "fwd": fa.flash_attention_fwd.launches,
                "dkdv": fa.flash_attention_bwd_dkdv.launches,
                "dq": fa.flash_attention_bwd_dq.launches}
    st = eng.stats()
    sp = eng._spec
    want_k1 = (layers * st["decode_steps"]
               + dlayers * (sp.propose_forwards + sp.feed_forwards))
    if launches["k1"] != want_k1:
        fail(f"tree round: K1 {launches['k1']} != {layers} x "
             f"{st['decode_steps']} + {dlayers} x "
             f"{sp.propose_forwards + sp.feed_forwards}")
    remat = 2 if TRAIN_REMAT else 1
    want_k2 = {"fwd": layers * ROUND_ACCUM * remat,
               "dkdv": layers * ROUND_ACCUM, "dq": layers * ROUND_ACCUM}
    got_k2 = {k: launches[k] for k in want_k2}
    if got_k2 != want_k2:
        fail(f"tree round: K2 launches {got_k2}, expected {want_k2}")
    bad = {k: v for k, v in out.metrics.items()
           if not np.isfinite(float(v))}
    if bad or out.update_skipped is not None:
        fail(f"tree round: non-finite metrics {bad} or a skipped update "
             f"({out.update_skipped})")
    bs = planner.branch_stats()
    if bs["branched_leaves"] < 1 or bs["groups"] != len(tasks):
        fail(f"tree round: branch_stats {bs}")
    eng._alloc.check_leaks()
    eng.spec_check_leaks()
    ss = eng.spec_stats()
    log(f"[group] tree round, {smi}: {len(tasks)} tasks x {TREE_GROUP}, "
        f"{len(out.trajectories)} leaves, branch_stats {bs}, wall "
        f"{wall:.2f} s; {st['decode_steps']} fused steps, spec rounds "
        f"{ss['rounds']} acceptance "
        f"{ss['accepted'] / max(1, ss['proposed']):.3f}; group_forks "
        f"{st['group_forks']} branch_forks {st['branch_forks']}; loss "
        f"{out.metrics['loss']:.4g} grad_norm {out.metrics['grad_norm']:.4g}"
        f" ratio_mean {out.metrics['ratio_mean']:.6f}; K1 {launches['k1']} "
        f"= {layers} x {st['decode_steps']} + {dlayers} x "
        f"{sp.propose_forwards + sp.feed_forwards}, K2 {got_k2}; "
        f"check_leaks and spec_check_leaks clean")
    del eng, draft, planner
    k3 = flash_decode.launches
    if k3 != 0:
        fail(f"group: K3 launched {k3} times (the phase runs no slot cache)")
    return {"k1": k1_group + launches["k1"], **got_k2, "k3": k3}


# The tenants (phase_tenants): one AdapterPool (default config: ranks 8
# and 16, 4 slots a rung, wq/wk/wv/wo) on the serving engine, one adapter
# per TENANT_RANKS entry (A scaled like init_lora, B ~ N(0, 1) x
# TENANT_B_SCALE, each from its own seed), TENANT_REQUESTS greedy requests
# of TENANT_PROMPT_LENS tokens, TENANT_NEW new: two per tenant, the rest
# base. Churn: two waves of four tenants each, on the same prompts, through
# a pool of CHURN_SLOTS_PER_RANK slots a rung. The tenant train step: one
# lora_base GRPO step on TENANT_TRAIN_B x TENANT_TRAIN_S tokens at
# TENANT_TRAIN_LR (an adapter's learning rate; at the trainer's 1e-5 an
# Adam step moves B less than a bf16 ulp).
TENANT_RANKS, TENANT_B_SCALE = (8, 8, 8, 16, 16, 16), 0.02
TENANT_REQUESTS, TENANT_PROMPT_LENS, TENANT_NEW = 16, (128, 1024), 64
CHURN_SLOTS_PER_RANK, CHURN_PROMPT_LENS, CHURN_NEW = 2, (128, 256), 16
TENANT_TRAIN_B, TENANT_TRAIN_S, TENANT_TRAIN_LR = 4, 512, 1e-3
# Live migration (phase_migrate): engines of MIGRATE_SLOTS rows, greedy;
# MIGRATE_PROMPTS requests of MIGRATE_PROMPT_LENS tokens, MIGRATE_NEW new,
# checkpointed once every row has MIGRATE_AFTER tokens
MIGRATE_SLOTS, MIGRATE_PROMPTS = 8, 7
MIGRATE_PROMPT_LENS, MIGRATE_NEW, MIGRATE_AFTER = (512, 1536), 128, 32


def _tenant_lora(torch, cfg, seed, rank):
    """A rank-``rank`` adapter on the card, from ``seed``: A scaled like
    init_lora's (alpha = 2 rank), B nonzero (init_lora's B = 0 would make
    every check pass vacuously)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    dims = {"wq": (cfg.hidden_size, cfg.q_dim),
            "wk": (cfg.hidden_size, cfg.kv_dim),
            "wv": (cfg.hidden_size, cfg.kv_dim),
            "wo": (cfg.q_dim, cfg.hidden_size)}
    layers = {}
    for t, (d_in, d_out) in dims.items():
        a = rng.standard_normal((cfg.num_layers, d_in, rank),
                                dtype=np.float32) * (2.0 / d_in ** 0.5)
        b = rng.standard_normal((cfg.num_layers, rank, d_out),
                                dtype=np.float32) * TENANT_B_SCALE
        layers[t + "_lora_a"] = torch.from_numpy(a).to("cuda", cfg.dtype)
        layers[t + "_lora_b"] = torch.from_numpy(b).to("cuda", cfg.dtype)
    return {"layers": layers}


def _adapter_path_diff(torch, params, cfg, pool, loras, prompts):
    """The largest logit difference between a tenant's two logit paths:
    a paged prefill through K1 with the pool's banks and the tenant's slot
    ids (the engine's masked delta) and the plain forward over
    ``merge_lora(base, adapter)`` (``_teacher_forced``'s reference), at
    the last TIE_DEPTH positions of each prompt. Runs before the phase's
    counts are zeroed (it launches K1)."""
    from senweaver_ide_tpu_torch.models import forward, forward_paged
    from senweaver_ide_tpu_torch.rollout import init_paged_pool
    from senweaver_ide_tpu_torch.training import merge_lora
    worst = 0.0
    for key, prompt in prompts:
        b = pool.acquire(key)
        n, bs = len(prompt), 16
        nb = -(-n // bs)
        kv = init_paged_pool(cfg, nb, bs, device="cuda")
        pos = torch.arange(n)
        with torch.no_grad():
            paged, _ = forward_paged(
                params, cfg, torch.tensor(prompt), pool=kv,
                tables=torch.arange(nb, dtype=torch.int32)[None],
                seq_row=torch.zeros(n, dtype=torch.long), positions=pos,
                write_block=pos // bs, write_off=pos % bs, use_kernel=True,
                adapters=pool.banks(),
                adapter_ids=tuple(torch.full((n,), s, dtype=torch.long)
                                  for s in b.slot_ids))
            plain = forward(merge_lora(params, loras[key]), cfg,
                            torch.tensor(prompt, device="cuda")[None])[0]
        pool.release(b)
        worst = max(worst, float((paged[-TIE_DEPTH:].float()
                                  - plain[-TIE_DEPTH:].float()).abs().max()))
    return worst


def _drive_counted(torch, engine, label, layers):
    """Drive ``engine`` to completion; K1's launches over the run must be
    layers x the run's fused steps. Returns (wall s, per-step ms, fused
    steps, tokens emitted, K1 launches)."""
    from senweaver_ide_tpu_torch.ops.paged_attention import \
        paged_flash_decode
    st0 = engine.stats()
    k0 = paged_flash_decode.launches
    torch.cuda.synchronize()
    step_ms = []
    t0 = time.perf_counter()
    while engine.has_work:
        s = time.perf_counter()
        engine.step()
        step_ms.append((time.perf_counter() - s) * 1e3)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = engine.stats()
    steps = st["decode_steps"] - st0["decode_steps"]
    k1 = paged_flash_decode.launches - k0
    if k1 != layers * steps:
        fail(f"{label}: K1 launches {k1} != {layers} x {steps} fused steps")
    return (wall, step_ms, steps,
            st["tokens_emitted"] - st0["tokens_emitted"], k1)


def _step_ms_text(step_ms):
    return (f"p50 step {statistics.median(step_ms):.2f} ms, p90 step "
            f"{statistics.quantiles(step_ms, n=10)[-1]:.2f} ms")


def phase_tenants(torch, cfg, params, seed, smi, tie_atol):
    """Multi-tenant LoRA serving at full width: six tenants and base rows
    in one batch on the serving engine, every token held by teacher
    forcing against its tenant's merged params; tenant churn through a
    two-slot pool with flat kernel builds and fused-step signatures; a
    tenant's lora_base train step (K2) published mid-decode."""
    import dataclasses

    import numpy as np
    from senweaver_ide_tpu_torch import obs
    from senweaver_ide_tpu_torch.ops import _build
    from senweaver_ide_tpu_torch.ops import flash_attention as fa
    from senweaver_ide_tpu_torch.ops.flash_decode import flash_decode
    from senweaver_ide_tpu_torch.ops.paged_attention import \
        paged_flash_decode
    from senweaver_ide_tpu_torch.rollout import (AdapterPool,
                                                 AdapterPoolConfig,
                                                 EngineConfig,
                                                 RolloutEngine,
                                                 SampleParams)
    from senweaver_ide_tpu_torch.training import (make_lora_train_state,
                                                  merge_lora, train_step)
    t_phase = time.perf_counter()
    layers = cfg.num_layers
    rng = np.random.default_rng(seed + 30)
    greedy = SampleParams(0.0, 0, 1.0)
    ec = EngineConfig(block_size=16, step_tokens=64)

    def engine(pool=None, num_slots=16):
        return RolloutEngine(params, cfg, num_slots=num_slots, max_len=2048,
                             sample=greedy, adapter_pool=pool,
                             engine_config=ec, device="cuda")

    keys = [f"t{i}" for i in range(len(TENANT_RANKS))]
    loras = {k: _tenant_lora(torch, cfg, seed + 100 + i, r)
             for i, (k, r) in enumerate(zip(keys, TENANT_RANKS))}
    pool = AdapterPool(cfg, device="cuda")
    eng = engine(pool)
    for k in keys:
        if eng.publish_adapter(k, loras[k]) != 1:
            fail(f"tenants: first publish of {k} is not version 1")
    lo, hi = TENANT_PROMPT_LENS
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).tolist()
               for n in rng.integers(lo, hi + 1, size=TENANT_REQUESTS)]
    owners = [keys[i // 2] if i < 2 * len(keys) else None
              for i in range(TENANT_REQUESTS)]
    diff = _adapter_path_diff(torch, params, cfg, pool, loras,
                              [(keys[0], prompts[0][:TIE_PROMPT]),
                               (keys[-1], prompts[-5][:TIE_PROMPT])])
    tie = max(tie_atol, TIE_FACTOR * min(diff, TIE_DIFF_MAX))
    # every count zeroed just before the phase's runs, read at its end
    paged_flash_decode.launches = 0
    flash_decode.launches = 0
    k2 = (fa.flash_attention_fwd, fa.flash_attention_bwd_dkdv,
          fa.flash_attention_bwd_dq)
    for w in k2:
        w.launches = 0

    # -- the mixed batch, then the same traffic on a base-only engine ----
    # the pool's install / eviction counters are process-wide series
    ev0 = pool.stats()["evictions"]
    rids = [eng.submit(p, max_new_tokens=TENANT_NEW, adapter_id=o)
            for p, o in zip(prompts, owners)]
    wall, step_ms, steps, toks, _ = _drive_counted(torch, eng, "tenants",
                                                   layers)
    streams = [eng.result(r) for r in rids]
    if any(len(x) != TENANT_NEW for x in streams):
        fail("tenants: a greedy request stopped early")
    st = eng.stats()
    ap = eng.adapter_stats()
    if (st["adapters_published"] != len(keys) or ap["evictions"] != ev0
            or not all(pool.resident(k) for k in keys)):
        fail(f"tenants: adapter_stats {ap}")
    base = engine()
    base_rids = [base.submit(p, max_new_tokens=TENANT_NEW) for p in prompts]
    b_wall, b_ms, b_steps, b_toks, _ = _drive_counted(torch, base,
                                                      "tenants base", layers)
    base_streams = [base.result(r) for r in base_rids]
    base._alloc.check_leaks()
    del base
    pool.note_gather_overhead(statistics.median(step_ms)
                              / statistics.median(b_ms))
    held = {}
    for k in keys + [None]:
        idx = [i for i, o in enumerate(owners) if o == k]
        held[k or "base rows"] = _teacher_forced(
            torch, params if k is None else merge_lora(params, loras[k]),
            cfg, [prompts[i] for i in idx], [streams[i] for i in idx], tie,
            f"tenants {k or 'base rows'}")
    moved = sum(a != b for i, o in enumerate(owners) if o
                for a, b in zip(streams[i], base_streams[i]))
    log(f"[tenants] {smi}: AdapterPool {pool.pool_config} on the serving "
        f"engine (16 slots, block 16, step budget 64, greedy), bank bytes "
        f"{pool.bank_bytes()}; {len(keys)} tenants at ranks {TENANT_RANKS}; "
        f"{TENANT_REQUESTS} requests of {min(map(len, prompts))}.."
        f"{max(map(len, prompts))} tokens, {TENANT_NEW} new, "
        f"{2 * len(keys)} under tenants: wall {wall:.2f} s, {steps} fused "
        f"steps, {toks / wall:.1f} tok/s, {_step_ms_text(step_ms)}; the "
        f"same traffic base-only: wall {b_wall:.2f} s, {b_steps} fused "
        f"steps, {b_toks / b_wall:.1f} tok/s, {_step_ms_text(b_ms)}; "
        f"{moved} tenant tokens differ from the base stream; adapter path "
        f"difference {diff:.4f}, tie tolerance {tie:.4f}")
    _log_held("tenants", held, tie)
    log(f"[tenants] adapter_stats {ap}")
    eng._alloc.check_leaks()

    # -- a tenant's lora_base train step, published mid-decode -------------
    key = keys[-1]
    tcfg = dataclasses.replace(cfg, attn_impl="flash", remat=TRAIN_REMAT)
    state = make_lora_train_state(
        tcfg, params, torch.Generator(device="cuda").manual_seed(seed),
        rank=TENANT_RANKS[-1], learning_rate=TENANT_TRAIN_LR)
    for name, t in state.params["layers"].items():
        t.copy_(loras[key]["layers"][name])
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, size=(TENANT_TRAIN_B, TENANT_TRAIN_S))).cuda()
    mask = torch.zeros_like(tokens, dtype=torch.bool)
    mask[:, TENANT_TRAIN_S * 3 // 4:] = True
    rewards = torch.tensor([1.0, -1.0] * (TENANT_TRAIN_B // 2),
                           device="cuda")
    gids = torch.arange(TENANT_TRAIN_B, device="cuda") // 2
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, metrics = train_step(state, tcfg, None, tokens, mask, rewards,
                                gids, num_groups=TENANT_TRAIN_B // 2,
                                lora_base=params)
    m = {k: float(v) for k, v in metrics.items()}
    train_s = time.perf_counter() - t0
    if not all(np.isfinite(v) for v in m.values()):
        fail(f"tenant train step: non-finite metrics {m}")
    dB = max(float((state.params["layers"][n].float()
                    - loras[key]["layers"][n].float()).abs().max())
             for n in state.params["layers"] if n.endswith("_lora_b"))
    if not dB > 0:
        fail("tenant train step: the adapter did not move")
    prompt = prompts[-5]
    rid_old = eng.submit(prompt, max_new_tokens=TENANT_NEW, adapter_id=key)
    while len(eng.result(rid_old)) < TENANT_NEW // 4:
        eng.step()
    mid = len(eng.result(rid_old))
    version = eng.publish_adapter(key, state.params)
    if version != 2 or eng._requests[rid_old].adapter_binding.version != 1:
        fail(f"tenant publish: version {version}, in-flight binding "
             f"{eng._requests[rid_old].adapter_binding}")
    _drive_counted(torch, eng, "tenant publish (in flight)", layers)
    rid_new = eng.submit(prompt, max_new_tokens=TENANT_NEW, adapter_id=key)
    _drive_counted(torch, eng, "tenant publish (next request)", layers)
    old, new = eng.result(rid_old), eng.result(rid_new)
    held = {"in flight (v1)": _teacher_forced(
                torch, merge_lora(params, loras[key]), cfg, [prompt], [old],
                tie, "tenant publish: in-flight stream under v1"),
            "next request (v2)": _teacher_forced(
                torch, merge_lora(params, state.params), cfg, [prompt],
                [new], tie, "tenant publish: next stream under v2")}
    if eng.adapter_stats()["adapters"][key] != 2:
        fail(f"tenant publish: {eng.adapter_stats()}")
    eng._alloc.check_leaks()
    log(f"[tenants] lora_base train step of {key} (rank "
        f"{TENANT_RANKS[-1]}, {TENANT_TRAIN_B} x {TENANT_TRAIN_S}, "
        f"attn_impl=flash, remat={TRAIN_REMAT}, lr {TENANT_TRAIN_LR}): "
        f"{train_s:.3f} s, loss {m['loss']:.4g}, max |dB| {dB:.3g}; "
        f"publish_adapter -> version {version} after {mid} tokens of an "
        f"in-flight request, which kept v1; its next request decoded "
        f"under v2; streams equal: {old == new}")
    _log_held("tenants", held, tie)
    del eng, state

    # -- churn: two waves through two slots a rung ---------------------------
    cpool = AdapterPool(cfg, AdapterPoolConfig(
        slots_per_rank=CHURN_SLOTS_PER_RANK), device="cuda")
    ceng = engine(cpool, num_slots=8)
    ranks = (8, 8, 16, 16)
    waves = [[f"w{w}{i}" for i in range(len(ranks))] for w in range(2)]
    wl = {k: _tenant_lora(torch, cfg, seed + 200 + 10 * w + i, ranks[i])
          for w, wave in enumerate(waves) for i, k in enumerate(wave)}
    for k, lora in wl.items():
        ceng.publish_adapter(k, lora)
    lo, hi = CHURN_PROMPT_LENS
    cprompts = [rng.integers(0, cfg.vocab_size, size=int(n)).tolist()
                for n in rng.integers(lo, hi + 1, size=len(ranks))]
    led = obs.get_profiler().ledger
    c0 = ceng.adapter_stats()
    snaps = []
    for w, wave in enumerate(waves):
        crids = [ceng.submit(p, max_new_tokens=CHURN_NEW, adapter_id=k)
                 for p, k in zip(cprompts, wave)]
        _drive_counted(torch, ceng, f"churn wave {w}", layers)
        fs = led()["engine.fused_step"]
        snaps.append(({x["key"] for x in fs["signatures"]}, fs["compiles"],
                      {n: (b.path, b.build_seconds)
                       for n, b in _build._loaded.items()}))
        cst = [ceng.result(r) for r in crids]
    if snaps[1] != snaps[0]:
        fail(f"churn: fused-step signatures {len(snaps[0][0])} -> "
             f"{len(snaps[1][0])}, compiles {snaps[0][1]} -> {snaps[1][1]}, "
             f"kernel builds {snaps[0][2]} -> {snaps[1][2]}")
    cstats = ceng.adapter_stats()
    installs = cstats["installs"] - c0["installs"]
    evictions = cstats["evictions"] - c0["evictions"]
    if (installs, evictions) != (2 * len(ranks), len(ranks)):
        fail(f"churn: installs {installs}, evictions {evictions} "
             f"(expected {2 * len(ranks)} and {len(ranks)})")
    held = {f"wave 1 {k}": _teacher_forced(
        torch, merge_lora(params, wl[k]), cfg, [p], [x], tie,
        f"churn wave 1 {k}") for k, p, x in zip(waves[1], cprompts, cst)}
    ceng._alloc.check_leaks()
    log(f"[tenants] churn, {smi}: {len(ranks)} tenants a wave on the same "
        f"{len(ranks)} prompts through {CHURN_SLOTS_PER_RANK} slots a rung: "
        f"installs {installs:g}, evictions {evictions:g}; "
        f"fused-step signatures {len(snaps[0][0])} and compiles "
        f"{snaps[0][1]} after each wave, kernel libraries "
        f"{sorted(snaps[0][2])} unchanged")
    _log_held("tenants", held, tie)
    del ceng
    launches = {"k1": paged_flash_decode.launches,
                "fwd": fa.flash_attention_fwd.launches,
                "dkdv": fa.flash_attention_bwd_dkdv.launches,
                "dq": fa.flash_attention_bwd_dq.launches,
                "k3": flash_decode.launches}
    remat = 2 if TRAIN_REMAT else 1
    want_k2 = {"fwd": layers * remat, "dkdv": layers, "dq": layers}
    if {k: launches[k] for k in want_k2} != want_k2 or launches["k3"]:
        fail(f"tenants: K2 {launches}, expected {want_k2} and K3 0")
    log(f"[tenants] K1 {launches['k1']} = {layers} x the fused steps of "
        f"the phase's engines, K2 {want_k2}, K3 0; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    return launches


def phase_migrate(torch, cfg, params, seed, smi, tie_atol):
    """Live migration at full width: four in-flight decodes (two base, one
    under a tenant, one group follower) checkpointed on engine A, round-
    tripped through the wire form, restored on engine B through the fast
    path (the installed blocks bit for bit), released on A; a fifth
    restored through the recompute path (block size 32); an int8-pool row
    migrated to an int8 engine. Every stream is held by teacher forcing."""
    import numpy as np
    from senweaver_ide_tpu_torch.ops import flash_attention as fa
    from senweaver_ide_tpu_torch.ops.flash_decode import flash_decode
    from senweaver_ide_tpu_torch.ops.paged_attention import \
        paged_flash_decode
    from senweaver_ide_tpu_torch.rollout import (AdapterPool, EngineConfig,
                                                 RolloutEngine,
                                                 SampleParams)
    from senweaver_ide_tpu_torch.rollout.migration import DecodeCheckpoint
    from senweaver_ide_tpu_torch.rollout.paged_kv import gather_blocks_quant
    from senweaver_ide_tpu_torch.training import merge_lora
    t_phase = time.perf_counter()
    layers = cfg.num_layers
    rng = np.random.default_rng(seed + 40)
    greedy = SampleParams(0.0, 0, 1.0)
    lora = _tenant_lora(torch, cfg, seed + 300, 16)

    def engine(block_size=16, kv_dtype="bf16", pool=False,
               num_slots=MIGRATE_SLOTS):
        e = RolloutEngine(params, cfg, num_slots=num_slots, max_len=2048,
                          sample=greedy,
                          adapter_pool=(AdapterPool(cfg, device="cuda")
                                        if pool else None),
                          engine_config=EngineConfig(block_size=block_size,
                                                     kv_dtype=kv_dtype),
                          device="cuda")
        if pool:
            e.publish_adapter("m0", lora)
        return e

    def wire_bits(t):
        return t.contiguous().view(
            {1: torch.uint8, 2: torch.int16, 4: torch.int32}[
                t.element_size()]).cpu().numpy()

    def installed_equal(eng, rid, ck):
        """The restored row's blocks, gathered again on ``eng``, against
        the checkpoint's payload, bit for bit."""
        row = eng._requests[rid].slot
        nblk = np.shape(ck.kv_k)[1]
        got = gather_blocks_quant(eng.pool, eng._tables[row][:nblk])
        for name in ("k", "v", "k_scale", "v_scale"):
            want = getattr(ck, "kv_" + name)
            t = getattr(got, name)
            if (want is None) != (t is None) or (want is not None and not (
                    np.array_equal(wire_bits(t),
                                   np.ascontiguousarray(want).view(
                                       wire_bits(t).dtype)))):
                fail(f"migrate: installed {name} blocks differ from the "
                     f"checkpoint payload")

    def checkpoint(eng, rid):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ck = eng.checkpoint_request(rid)
        dt = time.perf_counter() - t0
        ck = DecodeCheckpoint.from_wire(ck.to_wire())
        nbytes = sum(a.nbytes for a in (ck.kv_k, ck.kv_v, ck.kv_k_scale,
                                        ck.kv_v_scale) if a is not None)
        return ck, dt, nbytes

    def restore(eng, ck):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rid = eng.restore_request(ck)
        torch.cuda.synchronize()
        return rid, time.perf_counter() - t0

    lo, hi = MIGRATE_PROMPT_LENS
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).tolist()
               for n in rng.integers(lo, hi + 1, size=MIGRATE_PROMPTS)]
    a, b = engine(pool=True), engine(pool=True)
    b32 = engine(block_size=32)
    paged_flash_decode.launches = 0
    flash_decode.launches = 0
    for w in (fa.flash_attention_fwd, fa.flash_attention_bwd_dkdv,
              fa.flash_attention_bwd_dq):
        w.launches = 0
    k1_of = {}

    def run(eng, label, until=None):
        st0 = eng.stats()["decode_steps"]
        k0 = paged_flash_decode.launches
        while eng.has_work and (until is None or not until()):
            eng.step()
        steps = eng.stats()["decode_steps"] - st0
        k1 = paged_flash_decode.launches - k0
        if k1 != layers * steps:
            fail(f"migrate {label}: K1 {k1} != {layers} x {steps}")
        k1_of[label] = k1_of.get(label, 0) + k1

    donor, follower = a.submit_group(prompts[0], 2,
                                     max_new_tokens=MIGRATE_NEW)
    tenant = a.submit(prompts[1], max_new_tokens=MIGRATE_NEW,
                      adapter_id="m0")
    plain = [a.submit(p, max_new_tokens=MIGRATE_NEW) for p in prompts[2:]]
    owner = {donor: 0, follower: 0, tenant: 1,
             **{r: i + 2 for i, r in enumerate(plain)}}
    run(a, "A", until=lambda: min(len(a.result(r)) for r in owner)
        >= MIGRATE_AFTER)
    if a.stats()["group_prefills"] != 1:
        fail("migrate: the group did not share its prefill")
    moved = [plain[0], plain[1], tenant, follower]
    out_of, ck_s, in_s, nbytes, blocks = {}, [], [], [], 0
    for rid in moved:
        ck, dt, nb = checkpoint(a, rid)
        if ck.kv_k is None or ck.kv_len != len(ck.prompt) + len(
                ck.tokens) - 1:
            fail(f"migrate: rid {rid}'s checkpoint carries no full payload")
        copies0 = b.stats()["kv_install_copies"]
        new, rt = restore(b, ck)
        got = b.stats()["kv_install_copies"] - copies0
        if got != np.shape(ck.kv_k)[1]:
            fail(f"migrate: rid {rid} did not take the fast path "
                 f"({got} install copies)")
        installed_equal(b, new, ck)
        if not a.release_request(rid):
            fail(f"migrate: release of rid {rid} on A failed")
        out_of[rid] = (b, new)
        ck_s.append(dt)
        in_s.append(rt)
        nbytes.append(nb)
        blocks += got
    ck, dt, nb = checkpoint(a, plain[2])
    new, rt = restore(b32, ck)
    if b32.stats()["kv_install_copies"] != 0 or b32.stats()[
            "migrations_in"] != 1:
        fail("migrate: the block-size-32 restore did not recompute")
    a.release_request(plain[2])
    out_of[plain[2]] = (b32, new)
    b_binding = b._requests[out_of[tenant][1]].adapter_binding
    if b_binding is None or b_binding.version != 1:
        fail(f"migrate: the tenant row's binding on B is {b_binding}")
    run(a, "A")
    run(b, "B")
    run(b32, "B32")
    streams, srcs = [], []
    for rid in owner:
        eng, r = out_of.get(rid, (a, rid))
        if len(eng.result(r)) != MIGRATE_NEW:
            fail(f"migrate: rid {rid} stopped at {len(eng.result(r))}")
        streams.append(eng.result(r))
        srcs.append(rid)
    held = {}
    for label, pick, p in (
            ("base rows", [r for r in srcs if r != tenant], params),
            ("tenant row", [tenant], merge_lora(params, lora))):
        held[label] = _teacher_forced(
            torch, p, cfg, [prompts[owner[r]] for r in pick],
            [streams[srcs.index(r)] for r in pick], tie_atol,
            f"migrate {label}")
    st_a, st_b = a.stats(), b.stats()
    if (st_a["migrations_out"], st_b["migrations_in"]) != (5, 4):
        fail(f"migrate: counters out {st_a['migrations_out']} in "
             f"{st_b['migrations_in']}")
    for e in (a, b, b32):
        e._alloc.check_leaks()
    del a, b, b32

    # -- an int8-pool row to an int8 engine ----------------------------------
    p8 = prompts[2]
    ref8 = engine(kv_dtype="int8", num_slots=2)
    rref = ref8.submit(p8, max_new_tokens=MIGRATE_NEW)
    run(ref8, "int8 reference")
    a8, b8 = (engine(kv_dtype="int8", num_slots=2) for _ in range(2))
    r8 = a8.submit(p8, max_new_tokens=MIGRATE_NEW)
    run(a8, "int8 A", until=lambda: len(a8.result(r8)) >= MIGRATE_AFTER)
    ck8, dt8, nb8 = checkpoint(a8, r8)
    if ck8.kv_k.dtype != np.int8 or ck8.kv_k_scale is None:
        fail(f"migrate int8: payload {ck8.kv_k.dtype}, scales "
             f"{ck8.kv_k_scale is not None}")
    n8, rt8 = restore(b8, ck8)
    installed_equal(b8, n8, ck8)
    a8.release_request(r8)
    run(b8, "int8 B")
    if b8.result(n8) != ref8.result(rref):
        fail("migrate int8: the migrated stream differs from the "
             "never-migrated int8 run")
    for e in (ref8, a8, b8):
        e._alloc.check_leaks()
    del ref8, a8, b8
    k2 = {"fwd": fa.flash_attention_fwd.launches,
          "dkdv": fa.flash_attention_bwd_dkdv.launches,
          "dq": fa.flash_attention_bwd_dq.launches}
    k1 = paged_flash_decode.launches
    if k1 != sum(k1_of.values()) or any(k2.values()) or flash_decode.launches:
        fail(f"migrate: K1 {k1} against {k1_of}, K2 {k2}, K3 "
             f"{flash_decode.launches}")
    int8_k1 = sum(v for k, v in k1_of.items() if k.startswith("int8"))
    total = sum(nbytes)
    log(f"[migrate] {smi}: engines of {MIGRATE_SLOTS} rows (block 16, "
        f"greedy), {len(owner)} requests of {min(map(len, prompts))}.."
        f"{max(map(len, prompts))} tokens, {MIGRATE_NEW} new; after >= "
        f"{MIGRATE_AFTER} tokens each, 4 rows (2 base, 1 tenant, 1 group "
        f"follower) moved A -> B on the fast path ({blocks} blocks installed, "
        f"bit-identical when gathered again), 1 A -> B (block 32) by "
        f"recomputation, an int8 row to an int8 engine (stream equal to "
        f"the never-migrated int8 run). Checkpoint bytes "
        f"{nbytes} (+ int8 {nb8}); gather {', '.join(f'{x * 1e3:.2f}' for x in ck_s)} ms = "
        f"{total / sum(ck_s) / 1e9:.2f} GB/s, install "
        f"{', '.join(f'{x * 1e3:.2f}' for x in in_s)} ms = "
        f"{total / sum(in_s) / 1e9:.2f} GB/s; recompute restore "
        f"{rt * 1e3:.2f} ms; int8 gather {dt8 * 1e3:.2f} ms, install "
        f"{rt8 * 1e3:.2f} ms; K1 {k1} = {layers} x the fused steps of "
        f"every engine ({k1_of}), K2 0, K3 0; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    _log_held("migrate", held, tie_atol)
    return {"k1": k1 - int8_k1, "k1_int8": int8_k1, **k2,
            "k3": flash_decode.launches}


# The serving fleet (phase_fleet) and the disaggregated learner
# (phase_learner): qwen2.5-coder-1.5b at full width and depth, engines at
# phase_serve's settings with phase_tenants' step budget (16 slots,
# max_len 2048, block 16, 64 tokens a step), greedy. FLEET_REQUESTS
# requests of FLEET_PROMPT_LENS tokens, FLEET_NEW new, half INTERACTIVE:
# FLEET_PREFIX_USERS of them start with one FLEET_PREFIX-token prefix
# shared through the fleet's prefix store, FLEET_GROUP are one
# submit_group. A local replica dies at tick FLEET_KILL_AT; the other
# local replica's pool is squeezed (every free block squatted) once
# FLEET_SQUEEZE_DECODING of its rows decode and the admission queue is
# empty (a MemoryPressurePlan wrapped around its engine then), until a
# decode has migrated off it (at most FLEET_SQUEEZE_MAX ticks); the rolling
# publish (FLEET_PERTURB x N(0, 1) added to every weight) begins once the
# squeezed decode has moved, or at tick FLEET_PUBLISH_BY.
FLEET_REQUESTS, FLEET_PROMPT_LENS, FLEET_NEW = 32, (128, 1024), 64
# the depth phase_fleet and phase_learner run at (full width): a weight
# frame over HTTP takes tens of seconds at full depth
FLEET_LAYERS = 4
FLEET_PREFIX, FLEET_PREFIX_USERS, FLEET_GROUP = 512, 8, 4
FLEET_KILL_AT, FLEET_SQUEEZE_DECODING, FLEET_SQUEEZE_MAX = 4, 4, 64
FLEET_PUBLISH_BY, FLEET_PERTURB, FLEET_MAX_TICKS = 400, 1e-3, 4000
# A full-width weight frame is ~4.1 GB of JSON through urllib and
# http.server (tens of seconds): the transports of the weight moves wait
# this long.
FRAME_TIMEOUT_S = 900.0
# The learner (phase_learner): a round of episodes, LEARNER_TASKS prompts
# of LEARNER_PROMPT_LENS tokens x ROUND_GROUP completions of
# ROUND_NEW_TOKENS sampled from the learner's fleet, phase_async's
# stand-in reward; two GRPO steps at phase_async's trainer settings, then
# one publish.
LEARNER_TASKS, LEARNER_PROMPT_LENS = 2, (256, 768)


class _FrameTap:
    """The size of every JSON frame ``serve/rpc.py`` builds (its module
    ``json`` is swapped for this shim while a phase runs)."""

    def __init__(self, rpc):
        self.rpc, self.real, self.sizes = rpc, rpc.json, []

    def dumps(self, obj, **kw):
        s = self.real.dumps(obj, **kw)
        self.sizes.append(len(s))
        return s

    def __getattr__(self, name):
        return getattr(self.real, name)

    def __enter__(self):
        self.rpc.json = self
        return self

    def __exit__(self, *exc):
        self.rpc.json = self.real


class _FaultyHttp:
    """An HttpTransport that consults a NetworkFaultPlan on every call, as
    LoopbackTransport does: a ``drop_response`` fault sends the call over
    the socket, lets the server execute it, and loses the answer
    (RpcTimeout), so the client's retry must be replayed from the
    server's idempotency cache."""

    def __init__(self, inner, plan):
        self.inner, self.plan, self.target = inner, plan, inner.target

    def call(self, method, params=None, *, request_id=None, timeout_s=None):
        from senweaver_ide_tpu_torch.serve import RpcTimeout
        fault = self.plan.take(self.target, method)
        if fault is not None and fault.kind != "drop_response":
            fail(f"fleet: fault kind {fault.kind} is not wired over HTTP")
        out = self.inner.call(method, params, request_id=request_id,
                              timeout_s=timeout_s)
        if fault is not None:
            raise RpcTimeout(f"{method}: executed but response lost")
        return out


def _perturbed(torch, params, seed, scale):
    """A new tree: every floating weight plus scale x N(0, 1), in its own
    dtype (a publish that changes every tensor)."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if not t.is_floating_point():
            return t.clone()
        n = torch.randn(t.shape, generator=g, device=t.device,
                        dtype=torch.float32)
        return (t.float() + scale * n).to(t.dtype)
    return walk(params)


def _ttft_run(torch, engine, reqs, label, layers):
    """Drive ``engine`` over ``reqs`` ((prompt, kwargs) or (prompt,
    group size)) submitted at once; returns (wall s, tokens emitted,
    TTFT ms per request: the wall time from submit to the step that
    emitted its first token)."""
    t0 = time.perf_counter()
    rids = []
    for prompt, kw in reqs:
        if isinstance(kw, int):
            rids += engine.submit_group(prompt, kw, max_new_tokens=FLEET_NEW)
        else:
            rids.append(engine.submit(prompt, max_new_tokens=FLEET_NEW, **kw))
    first = {}
    st0 = engine.stats()
    torch.cuda.synchronize()
    while engine.has_work:
        for rid in engine.step():
            first.setdefault(rid, time.perf_counter())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    toks = engine.stats()["tokens_emitted"] - st0["tokens_emitted"]
    missing = [r for r in rids if r not in first]
    if missing:
        fail(f"{label}: requests {missing} emitted no token")
    return wall, toks, [(first[r] - t0) * 1e3 for r in rids]


def _pct_text(xs):
    return (f"p50 {statistics.median(xs):.1f} ms, p90 "
            f"{statistics.quantiles(xs, n=10)[-1]:.1f} ms")


def phase_fleet(torch, cfg, params, seed, smi, tie_atol):
    """The serving fleet at full width: two local replicas sharing one
    params tree and a third behind serve_engine_http on 127.0.0.1 (its own
    weights, received over the socket) under one ServingFleet; 32 mixed
    requests with a shared prefix and a group, a replica killed
    mid-decode, a dropped response replayed from the remote's idempotency
    cache, a squeezed pool whose decode migrates across HTTP, and a
    rolling publish that carries the new weights over the wire. Every
    completed stream is teacher-forced on the weights of its version.
    Returns K1's launches and the pieces phase_learner reuses."""
    import numpy as np
    from senweaver_ide_tpu_torch import obs
    from senweaver_ide_tpu_torch.models import forward_paged
    from senweaver_ide_tpu_torch.ops import flash_attention as fa
    from senweaver_ide_tpu_torch.ops.flash_decode import flash_decode
    from senweaver_ide_tpu_torch.ops.paged_attention import \
        paged_flash_decode
    from senweaver_ide_tpu_torch.resilience import (MemoryPressureFault,
                                                    MemoryPressurePlan,
                                                    NetworkFault,
                                                    NetworkFaultPlan,
                                                    RetryPolicy)
    from senweaver_ide_tpu_torch.rollout import (EngineConfig,
                                                 RolloutEngine,
                                                 SampleParams)
    from senweaver_ide_tpu_torch.serve import (INTERACTIVE, TRAIN_ROLLOUT,
                                               Completed, EngineRpcHandler,
                                               HttpTransport, Rejected,
                                               RemoteReplica, ServingFleet,
                                               rpc, serve_engine_http)
    t_phase = time.perf_counter()
    layers = cfg.num_layers
    rng = np.random.default_rng(seed + 50)
    greedy = SampleParams(0.0, 0, 1.0)

    def engine(p, **ec):
        return RolloutEngine(p, cfg, num_slots=16, max_len=2048,
                             sample=greedy, device="cuda",
                             engine_config=EngineConfig(
                                 block_size=16, step_tokens=64, **ec))

    # -- the traffic ---------------------------------------------------------
    lo, hi = FLEET_PROMPT_LENS
    vocab = cfg.vocab_size
    prefix = rng.integers(0, vocab, size=FLEET_PREFIX).tolist()
    singles = []
    for i in range(FLEET_REQUESTS - FLEET_GROUP):
        n = int(rng.integers(lo, hi + 1))
        body = rng.integers(0, vocab, size=n).tolist()
        uses = i < FLEET_PREFIX_USERS
        singles.append(((prefix + body[:max(16, n - FLEET_PREFIX)])
                        if uses else body, uses,
                        INTERACTIVE if i % 7 < 4 else TRAIN_ROLLOUT))
    group_prompt = rng.integers(0, vocab, size=int(rng.integers(
        lo, hi + 1))).tolist()
    n_inter = sum(p == INTERACTIVE for _, _, p in singles)

    # -- one engine on the same 32 requests ----------------------------------
    one = engine(params)
    pid1 = one.register_prefix(prefix)
    one_wall, one_toks, one_ttft = _ttft_run(
        torch, one, [(p, dict(prefix_id=pid1) if u else {})
                     for p, u, _ in singles] + [(group_prompt, FLEET_GROUP)],
        "fleet single engine", layers)
    del one
    torch.cuda.empty_cache()

    # -- the fleet -------------------------------------------------------------
    e0 = engine(params, max_preempts=0)     # a squeezed row migrates at once
    e1 = engine(params)
    remote_engine = engine(params)          # its weights come over HTTP
    handler = EngineRpcHandler(remote_engine)
    server, port = serve_engine_http(handler)
    net = NetworkFaultPlan([NetworkFault(kind="drop_response",
                                         target="remote", method="submit",
                                         call_idx=0)])
    transport = _FaultyHttp(HttpTransport(
        f"http://127.0.0.1:{port}", timeout_s=FRAME_TIMEOUT_S,
        target="remote"), net)
    remote = RemoteReplica("remote", transport,
                           policy=RetryPolicy(max_retries=2,
                                              base_delay_s=0.01))
    tap = _FrameTap(rpc)
    try:
        with tap:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            remote.client.update_params(params, version=0, epoch=0)
            torch.cuda.synchronize()
            init_s = time.perf_counter() - t0
            init_frame = tap.sizes[-1]
        if (remote_engine.params["embed"].data_ptr()
                == params["embed"].data_ptr()
                or not _bits_equal(torch, remote_engine.params, params)):
            fail("fleet: the remote engine does not hold its own bit-equal "
                 "copy of the weights after the publish over HTTP")
        squeeze = MemoryPressurePlan([MemoryPressureFault(
            at_step=0, hold_blocks=1 << 30)])
        fleet = ServingFleet([e0, e1, remote], retry_base_delay_s=0.0)
        mig = fleet.attach_migration()
        installs = []
        import_prefix = remote.client.import_prefix

        def timed_import(*a, **kw):
            n0 = len(tap.sizes)
            t = time.perf_counter()
            out = import_prefix(*a, **kw)
            installs.append((time.perf_counter() - t, tap.sizes[n0]))
            return out
        remote.client.import_prefix = timed_import
        # one real fused step of the squeezed replica, captured for K1 vs
        # the plain path after the run
        captured = {}
        fused = e0._fused_step

        def spy(toks, rows, pos, wb, wo):
            if not captured and len(toks) > len(set(rows)):
                captured.update(
                    batch=[list(x) for x in (toks, rows, pos, wb, wo)],
                    params=e0.params, tables=e0._tables_device().clone(),
                    pool=type(e0.pool)(*(None if a is None else a.clone()
                                         for a in e0.pool)))
            return fused(toks, rows, pos, wb, wo)
        e0._fused_step = spy
        new_params = _perturbed(torch, params, seed + 51, FLEET_PERTURB)
        engines = {"replica-0": e0, "replica-1": e1, "remote": remote_engine}
        st0 = {k: e.stats()["decode_steps"] for k, e in engines.items()}
        k2 = (fa.flash_attention_fwd, fa.flash_attention_bwd_dkdv,
              fa.flash_attention_bwd_dq)
        for w in k2 + (flash_decode, paged_flash_decode):
            w.launches = 0
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t_run = time.perf_counter()
        with tap:
            pid = fleet.register_prefix(prefix)
            tickets = [fleet.submit(p, max_new_tokens=FLEET_NEW, priority=pr,
                                    prefix_id=pid if u else None)
                       for p, u, pr in singles]
            tickets += fleet.submit_group(group_prompt, FLEET_GROUP,
                                          max_new_tokens=FLEET_NEW)
            ticks, killed, roll, squeezed = 0, None, None, None
            while fleet.pending() or fleet.publisher.in_progress:
                fleet.step()
                ticks += 1
                if ticks == FLEET_KILL_AT:
                    victim = fleet._replica_by_id("replica-1")
                    if victim.outstanding == 0:
                        fail("fleet: replica-1 idle at the kill")
                    killed = victim.outstanding
                    fleet.kill_replica("replica-1")
                rep0 = fleet.replicas[0]
                if rep0.engine is e0 and ticks > FLEET_KILL_AT and \
                        fleet.admission.depth() == 0 and sum(
                            bool(r.tokens) and not r.done
                            for r in e0._requests.values()) \
                        >= FLEET_SQUEEZE_DECODING:
                    # nothing left to dispatch: the squeeze lands on decodes
                    rep0.engine = squeeze.wrap_engine(e0)
                    squeezed = ticks
                    log(f"[fleet] replica-0's pool squeezed from tick "
                        f"{ticks} ({e0._alloc.free_blocks} free blocks)")
                elif squeezed and squeeze.holding_blocks and (
                        _moved(obs, "kv_pressure")
                        or ticks - squeezed > FLEET_SQUEEZE_MAX):
                    log(f"[fleet] squeeze of {squeeze.holding_blocks} "
                        f"blocks released at tick {ticks}")
                    squeeze.release_all(e0)
                if roll is None and (ticks >= FLEET_PUBLISH_BY or _moved(
                        obs, "kv_pressure")):
                    n0 = len(tap.sizes)
                    roll = [time.perf_counter(), None, n0]
                    fleet.begin_publish(new_params)
                elif roll and roll[1] is None and \
                        not fleet.publisher.in_progress:
                    roll[1] = time.perf_counter()
                if ticks > FLEET_MAX_TICKS:
                    fail(f"fleet: {fleet.pending()} requests pending after "
                         f"{ticks} ticks")
            torch.cuda.synchronize()
        wall = time.perf_counter() - t_run
        peak = torch.cuda.max_memory_allocated()
        launches = paged_flash_decode.launches
        others = {n: w.launches for n, w in zip(("fwd", "dkdv", "dq", "k3"),
                                                k2 + (flash_decode,))}
        if any(others.values()):
            fail(f"fleet: K2 / K3 launched off the serving path: {others}")
        steps = {k: e.stats()["decode_steps"] - st0[k]
                 for k, e in engines.items()}
        if launches != layers * sum(steps.values()):
            fail(f"fleet: K1 launches {launches} != {layers} x the fused "
                 f"steps {steps}")
        outs = {t: fleet.outcome(t) for t in tickets}
        bad = [t for t, o in outs.items()
               if not isinstance(o, (Completed, Rejected))]
        if bad:
            fail(f"fleet: tickets {bad} hold no terminal outcome")
        done = {t: o for t, o in outs.items() if isinstance(o, Completed)}
        mixed = [t for t, o in done.items()
                 if o.weight_version != o.weight_version_at_finish]
        if mixed or not done:
            fail(f"fleet: tickets {mixed} mix weight versions "
                 f"({len(done)} completed)")
        versions = {r.replica_id: r.weight_version for r in fleet.replicas
                    if r.state != "dead"}
        if set(versions.values()) != {1} or roll is None or roll[1] is None:
            fail(f"fleet: the publish did not land everywhere: {versions}")
        if remote_engine.params["embed"].data_ptr() == \
                new_params["embed"].data_ptr() or not _bits_equal(
                    torch, remote_engine.params, new_params):
            fail("fleet: the remote replica does not hold the published "
                 "weights bit for bit")
        if not _bits_equal(torch, e0.params, new_params):
            fail("fleet: replica-0 does not hold the published weights")
        if not _moved(obs, "kv_pressure"):
            fail(f"fleet: the squeezed decode never migrated "
                 f"({_migration_counts(obs)})")
        if handler.replays < 1:
            fail(f"fleet: the dropped response was not replayed "
                 f"({handler.executed}, replays {handler.replays})")
        names = {n for n in obs.get_registry().snapshot()
                 if n.startswith("senweaver_serve_")}
        want_names = {"senweaver_serve_ttft_ms",
                      "senweaver_serve_weight_version_skew",
                      "senweaver_serve_replica_deaths_total",
                      "senweaver_serve_publishes_total",
                      "senweaver_serve_replicas_rolled_total",
                      "senweaver_serve_migrations_total",
                      "senweaver_serve_prefix_broadcasts_total",
                      "senweaver_serve_remote_rpcs_total",
                      "senweaver_serve_remote_rpc_retries_total",
                      "senweaver_serve_queue_depth",
                      "senweaver_serve_group_submits_total"}
        if not want_names <= names:
            fail(f"fleet: metric names missing {sorted(want_names - names)}")
        # every completed stream, teacher-forced on its version's weights
        held = {}
        for v, p_v in ((0, params), (1, new_params)):
            ts = [t for t, o in done.items() if o.weight_version == v]
            if ts:
                held[f"version {v}"] = _teacher_forced(
                    torch, p_v, cfg, [fleet._requests[t].prompt for t in ts],
                    [done[t].tokens for t in ts], tie_atol,
                    f"fleet version {v}")
        # K1 against its plain version on the captured fleet step
        if not captured:
            fail("fleet: no mixed fused step was captured")
        b = captured["batch"]
        with torch.no_grad():
            logits = [forward_paged(
                captured["params"], cfg, torch.tensor(b[0]),
                pool=type(captured["pool"])(*(
                    None if a is None else a.clone()
                    for a in captured["pool"])),
                tables=captured["tables"], seq_row=torch.tensor(b[1]),
                positions=torch.tensor(b[2]),
                write_block=torch.tensor(b[3]),
                write_off=torch.tensor(b[4]), use_kernel=k)[0].float()
                for k in (True, False)]
        k1_diff = float((logits[0] - logits[1]).abs().max())
        if not k1_diff <= tie_atol:
            fail(f"fleet: K1 vs plain on a fleet step {k1_diff} > "
                 f"{tie_atol}")
        # teardown: the squat given back, the dead replica's stranded rows
        # released by its janitor (here), prefixes released, no leak
        squeeze.release_all(e0)
        for name, eng in engines.items():
            for rid, req in list(eng._requests.items()):
                if not req.done:
                    eng.release_request(rid)
            for p_id in list(eng._prefixes):
                eng.release_prefix(p_id)
            eng._alloc.check_leaks()
    except BaseException:
        server.shutdown()
        raise
    st = fleet.stats()
    n_rej = sum(isinstance(o, Rejected) for o in outs.values())
    toks = sum(len(o.tokens) for o in done.values())
    ttft = [o.ttft_ms for o in done.values() if o.ttft_ms is not None]
    roll_s = roll[1] - roll[0]
    roll_frame = max(tap.sizes[roll[2]:])
    mig_ms = _hist_mean(obs, "senweaver_serve_migration_ms")
    log(f"[fleet] {smi}: 3 replicas on one card (2 local sharing one params "
        f"tree, 1 behind serve_engine_http on 127.0.0.1), engines of 16 "
        f"slots, max_len 2048, block 16, step budget 64, greedy; "
        f"{FLEET_REQUESTS} requests of {lo}..{hi} tokens, {FLEET_NEW} new "
        f"({n_inter} INTERACTIVE), {FLEET_PREFIX_USERS} on a {FLEET_PREFIX}"
        f"-token shared prefix, one group of {FLEET_GROUP}: "
        f"{len(done)} completed, {n_rej} rejected "
        f"({sorted({o.reason for o in outs.values() if isinstance(o, Rejected)})}); "
        f"wall {wall:.2f} s, {ticks} ticks, {toks / wall:.1f} tok/s, TTFT "
        f"{_pct_text(ttft)}; one engine on the same requests: wall "
        f"{one_wall:.2f} s, {one_toks / one_wall:.1f} tok/s, TTFT "
        f"{_pct_text(one_ttft)} (the replicas share the card's default "
        f"stream and the GIL: one fleet tick steps them in turn)")
    log(f"[fleet] weights over HTTP: the remote's own copy {init_frame} "
        f"frame bytes in {init_s:.2f} s = {init_frame / init_s / 1e9:.3f} "
        f"GB/s; the rolling publish {roll_s:.2f} s (drain, swap and resume "
        f"replica by replica; {killed} requests on the killed replica), its "
        f"remote frame {roll_frame} bytes; prefix installs over HTTP "
        f"{', '.join(f'{n} bytes in {s * 1e3:.1f} ms = {n / s / 1e9:.3f} GB/s' for s, n in installs)} "
        f"({FLEET_PREFIX} tokens = {FLEET_PREFIX * 2 * layers * cfg.num_kv_heads * cfg.head_dim * 2} "
        f"bytes of KV in a max_len buffer); migrations "
        f"{_migration_counts(obs)}, mean {mig_ms:.1f} ms; remote submits "
        f"executed {handler.executed.get('submit', 0)}, replays "
        f"{handler.replays}; peak max_memory_allocated {peak} bytes; K1 "
        f"{launches} = {layers} x fused steps {steps}; K1 vs plain on a "
        f"fleet step {k1_diff:.4f} (tie {tie_atol:.4f}); stats "
        f"{ {k: st[k] for k in ('completed', 'rejected', 'weight_version', 'replicas_live', 'shared_prefixes', 'kv_prefix_grafts', 'kv_install_copies') if k in st} }; "
        f"phase {time.perf_counter() - t_phase:.1f} s")
    _log_held("fleet", held, tie_atol)
    if len(mig.pending):
        fail(f"fleet: {len(mig.pending)} migrations never acked")
    del e1, fleet
    return {"k1": launches, **others, "server": server, "port": port,
            "remote_engine": remote_engine, "params": new_params}


def _moved(obs, reason):
    m = obs.get_registry().get("senweaver_serve_migrations_total")
    return m is not None and m.value(reason=reason, outcome="completed") > 0


def _migration_counts(obs):
    m = obs.get_registry().get("senweaver_serve_migrations_total")
    return {} if m is None else {",".join(k): v
                                 for k, v in m.samples().items()}


def _hist_mean(obs, name):
    m = obs.get_registry().get(name)
    if m is None:
        return float("nan")
    cells = list(m.samples().values())
    n = sum(c[-1] for c in cells)
    return sum(c[-2] for c in cells) / n if n else float("nan")


class _TwoSteps:
    """The streaming service's trainer for phase_learner: each streamed
    batch is two GRPO steps (its first and second half of groups), then
    the service publishes once."""

    def __init__(self, adapter):
        self.adapter, self.state, self.metrics = adapter, adapter.state, []

    def train_on_batch(self, episodes):
        keys = list(dict.fromkeys(ep.group_key for ep in episodes))
        half = set(keys[:len(keys) // 2])
        for part in ([ep for ep in episodes if ep.group_key in half],
                     [ep for ep in episodes if ep.group_key not in half]):
            self.metrics.append(self.adapter.train_on_batch(part))
        return self.metrics[-1]

    def note_published(self, version):
        self.adapter.note_published(version)


def phase_learner(torch, cfg, fleet_out, seed, smi):
    """The disaggregated learner at full width: a StreamingLearnerService
    over a StreamingTrainerAdapter at phase_async's trainer settings,
    behind serve_fleet_http (FleetRpcHandler with a LeaseStore) and
    serve_experience_http (ExperienceRpcHandler); its fleet is one local
    replica and phase_fleet's replica behind serve_engine_http. An
    EpisodeStreamer streams a round's episodes over HTTP; the learner takes
    two steps and publishes with its (epoch, version) fence; every replica
    then holds the learner's snapshot bit for bit, and still does after
    the learner's next in-place step. A second holder takes the lease: the
    first holder's next step is refused (LeaseLost) and its publish at its
    own fence (StalePublishError)."""
    import dataclasses

    import numpy as np
    from senweaver_ide_tpu_torch.ops import flash_attention as fa
    from senweaver_ide_tpu_torch.ops.flash_decode import flash_decode
    from senweaver_ide_tpu_torch.ops.paged_attention import \
        paged_flash_decode
    from senweaver_ide_tpu_torch.resilience import (LeaseLost, LeaseStore,
                                                    RetryPolicy)
    from senweaver_ide_tpu_torch.rollout import (EngineConfig,
                                                 RolloutEngine,
                                                 SampleParams)
    from senweaver_ide_tpu_torch.serve import (EpisodeStreamer,
                                               ExperienceClient,
                                               FleetPublishClient,
                                               FleetRpcHandler,
                                               HttpTransport, LearnerConfig,
                                               RemoteReplica, ServingFleet,
                                               StalePublishError,
                                               StreamingLearnerConfig,
                                               StreamingLearnerService, rpc,
                                               serve_experience_http,
                                               serve_fleet_http)
    from senweaver_ide_tpu_torch.training import (StreamedEpisode,
                                                  StreamingTrainerAdapter,
                                                  make_optimizer,
                                                  make_train_state)
    from senweaver_ide_tpu_torch.training.trainer import clone_params
    t_phase = time.perf_counter()
    layers = cfg.num_layers
    rng = np.random.default_rng(seed + 60)
    base = fleet_out["params"]
    remote_engine = fleet_out["remote_engine"]
    servers = [fleet_out["server"]]
    policy = RetryPolicy(max_retries=2, base_delay_s=0.05)

    def http(port):
        return HttpTransport(f"http://127.0.0.1:{port}",
                             timeout_s=FRAME_TIMEOUT_S)

    try:
        local = RolloutEngine(base, cfg, num_slots=16, max_len=2048,
                              sample=SampleParams(), seed=seed,
                              device="cuda", engine_config=EngineConfig(
                                  block_size=16, step_tokens=64))
        remote = RemoteReplica("remote", http(fleet_out["port"]),
                               policy=policy)
        fleet = ServingFleet([local, remote], retry_base_delay_s=0.0)
        gateway = FleetRpcHandler(fleet, lease_store=LeaseStore(
            ttl_s=FRAME_TIMEOUT_S * 4))
        gw_server, gw_port = serve_fleet_http(gateway)
        servers.append(gw_server)
        tcfg = dataclasses.replace(cfg, attn_impl="flash",
                                   remat=TRAIN_REMAT)
        state = make_train_state(tcfg, params=clone_params(base),
                                 optimizer=make_optimizer(TRAIN_LR))
        adapter = StreamingTrainerAdapter(state, tcfg, None, pad_id=0,
                                          max_len=2048,
                                          accum_steps=ROUND_ACCUM)
        trainer = _TwoSteps(adapter)
        client = FleetPublishClient(http(gw_port), name="learner-0",
                                    policy=policy)
        stage = []
        publish = client.publish

        def timed_publish(*a, **kw):
            t = time.perf_counter()
            out = publish(*a, **kw)
            stage.append(time.perf_counter() - t)
            return out
        client.publish = timed_publish
        svc = StreamingLearnerService(
            trainer, client,
            stream_config=StreamingLearnerConfig(group_size=ROUND_GROUP,
                                                 min_groups=LEARNER_TASKS),
            config=LearnerConfig(holder="learner-0",
                                 publish_timeout_s=FRAME_TIMEOUT_S))
        epochs = [svc.start()]
        exp_server, exp_port = serve_experience_http(svc)
        servers.append(exp_server)
        streamer = EpisodeStreamer(ExperienceClient(
            http(exp_port), name="collector-0", policy=policy))

        # -- a round of episodes from the learner's fleet ------------------
        lo, hi = LEARNER_PROMPT_LENS
        prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).tolist()
                   for n in rng.integers(lo, hi + 1, size=LEARNER_TASKS)]
        paged_flash_decode.launches = 0
        flash_decode.launches = 0
        st0 = (local.stats()["decode_steps"],
               remote_engine.stats()["decode_steps"])
        tickets = [(ti, g, fleet.submit(prompts[ti],
                                        max_new_tokens=ROUND_NEW_TOKENS))
                   for ti in range(LEARNER_TASKS)
                   for g in range(ROUND_GROUP)]
        fleet.run()
        steps = (local.stats()["decode_steps"] - st0[0]
                 + remote_engine.stats()["decode_steps"] - st0[1])
        k1 = paged_flash_decode.launches
        if k1 != layers * steps:
            fail(f"learner: K1 launches {k1} != {layers} x {steps} fused "
                 f"steps")

        def episodes(tag):
            return [StreamedEpisode(
                episode_id=f"collector-0/{tag}/t{ti}g{g}",
                group_key=f"collector-0/{tag}/t{ti}", prompt_ids=prompts[ti],
                completion_ids=list(fleet.result(t)),
                reward=_spread_reward(ti, g, None), epoch=svc.epoch,
                version=fleet.publisher.version,
                behavior_logp=list(fleet.result_logps(t)))
                for ti, g, t in tickets]

        batch = episodes("r0")
        streamer.offer(batch)
        flushed = streamer.flush()
        if flushed != {"retired": len(batch), "pending": 0}:
            fail(f"learner: the streamer's flush over HTTP {flushed}")

        # -- two steps, one fenced publish ----------------------------------
        k2 = (fa.flash_attention_fwd, fa.flash_attention_bwd_dkdv,
              fa.flash_attention_bwd_dq)
        for w in k2:
            w.launches = 0
        torch.cuda.reset_peak_memory_stats()
        before = clone_params(adapter.state.params)
        tap = _FrameTap(rpc)
        with tap:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = svc.run_step()
            torch.cuda.synchronize()
            step_s = time.perf_counter() - t0 - sum(stage)
            snapshot = clone_params(adapter.state.params)
            t1 = time.perf_counter()
            while not svc.pump_publish():
                pass
            roll_s = time.perf_counter() - t1
        if res is None or res["version"] != 1 or len(trainer.metrics) != 2:
            fail(f"learner: the streaming step {res}")
        if _bits_equal(torch, snapshot, before):
            fail("learner: two GRPO steps left the params unchanged")
        for m in trainer.metrics:
            if not all(np.isfinite(v) for v in m.values()):
                fail(f"learner: non-finite metrics {m}")
        # the first step trains on the served weights: its importance
        # ratio says the streamed log-probs are those weights' own
        if not abs(trainer.metrics[0]["ratio_mean"] - 1) < RATIO_TOL:
            fail(f"learner: first step's ratio_mean "
                 f"{trainer.metrics[0]['ratio_mean']} (tol {RATIO_TOL})")
        if (fleet.publisher.version, fleet.publisher.epoch) != (1, 1):
            fail(f"learner: the fleet is at (version, epoch) "
                 f"{(fleet.publisher.version, fleet.publisher.epoch)}")
        held = {"local": local.params, "remote": remote_engine.params}
        for name, p in held.items():
            if not _bits_equal(torch, p, snapshot):
                fail(f"learner: the {name} replica does not hold the "
                     f"learner's snapshot bit for bit")
        # the learner's next step, in place: the replicas keep the snapshot
        adapter.train_on_batch(batch)
        torch.cuda.synchronize()
        if _bits_equal(torch, adapter.state.params, snapshot):
            fail("learner: the next in-place step left the params unchanged")
        for name, p in held.items():
            if not _bits_equal(torch, p, snapshot):
                fail(f"learner: the learner's in-place step changed the "
                     f"{name} replica's weights")
        k2n = {n: w.launches for n, w in zip(("fwd", "dkdv", "dq"), k2)}
        want = {"fwd": 3 * layers * ROUND_ACCUM * (2 if TRAIN_REMAT else 1),
                "dkdv": 3 * layers * ROUND_ACCUM,
                "dq": 3 * layers * ROUND_ACCUM}
        if k2n != want:
            fail(f"learner: K2 launches {k2n} != {want} (three steps)")
        peak = torch.cuda.max_memory_allocated()

        # -- a second holder takes the lease ---------------------------------
        other = FleetPublishClient(http(gw_port), name="learner-1",
                                   policy=policy)
        epochs.append(other.acquire_lease("learner-1", steal=True)["epoch"])
        streamer.offer(episodes("r1"))
        streamer.flush()
        try:
            svc.run_step()
            fail("learner: the superseded holder's step was not fenced")
        except LeaseLost:
            pass
        try:
            fleet.begin_publish(adapter.state.params, epoch=epochs[0],
                                version=svc.version)
            fail("learner: the superseded holder's publish was accepted")
        except StalePublishError:
            pass
        if epochs != sorted(set(epochs)) or len(epochs) != 2:
            fail(f"learner: lease epochs {epochs} not strictly increasing")
        if fleet.publisher.version != 1:
            fail(f"learner: the fleet's version {fleet.publisher.version} "
                 f"!= the 1 accepted publish")
        for name, p in held.items():
            if not _bits_equal(torch, p, snapshot):
                fail(f"learner: the refused publish moved the {name} "
                     f"replica's weights")
        if flash_decode.launches:
            fail(f"learner: K3 launched {flash_decode.launches} times")
        for eng in (local, remote_engine):
            eng._alloc.check_leaks()
    finally:
        for s in servers:
            s.shutdown()
            s.server_close()
    frames = [n for n in tap.sizes if n > 1 << 30]
    m = trainer.metrics
    log(f"[learner] {smi}: StreamingLearnerService over a "
        f"StreamingTrainerAdapter (flash, remat, accum {ROUND_ACCUM}, lr "
        f"{TRAIN_LR}), the learner gateway and the episode intake on "
        f"127.0.0.1, a fleet of one local replica and the HTTP replica; "
        f"{len(batch)} episodes ({LEARNER_TASKS} prompts of {lo}..{hi} "
        f"tokens x {ROUND_GROUP}, {ROUND_NEW_TOKENS} new) streamed over "
        f"HTTP; two GRPO steps (loss {m[0]['loss']:.6g}, {m[1]['loss']:.6g}; "
        f"ratio_mean {m[0]['ratio_mean']:.6f}, {m[1]['ratio_mean']:.6f}) in "
        f"{step_s:.2f} s, then the publish: staged in {sum(stage):.2f} s, "
        f"rolled in {roll_s:.2f} s, {sum(stage) + roll_s:.2f} s end to end "
        f"(frames over 1 GiB: {frames}); lease epochs {epochs}; fleet "
        f"(version, epoch) {(fleet.publisher.version, fleet.publisher.epoch)}; "
        f"both replicas hold the snapshot bit for bit, unchanged by the next "
        f"in-place step; the superseded holder's step LeaseLost and its "
        f"publish StalePublishError; K1 {k1} = {layers} x {steps}; K2 "
        f"{k2n}; peak max_memory_allocated {peak} bytes; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    return {"k1": k1, **k2n, "k3": 0}


# The control plane (phase_control): rules for the eval_rules job (any
# list renders into the sessions' system message) and the ctl binary's
# per-call limit
CONTROL_RULES = ("Read a file before you edit it.",
                 "Run the tests after every change.")
CTL_TIMEOUT_S = 300
# the grpo job's microbatches: its 4 trajectories of ~2,100 tokens in one
# microbatch peaked at 68.4 GB on an H100 80GB, the phase run alone (fp32
# logits over the 151,936-token vocabulary), too close to the card's 80 GB
# beside the script's other live weights; two halve that part
CONTROL_ACCUM = 2


def _ctl_ok(binary, sock, *args):
    """One senweaver-ctl call that must succeed: the result of the last
    JSON line it printed."""
    res = subprocess.run([binary, "--socket", sock, "--interval", "1",
                          *args], capture_output=True, text=True,
                         timeout=CTL_TIMEOUT_S)
    lines = [ln for ln in res.stdout.strip().split("\n") if ln]
    resp = json.loads(lines[-1]) if lines else {}
    if res.returncode != 0 or "result" not in resp:
        fail(f"control: senweaver-ctl {' '.join(args)} exited "
             f"{res.returncode}: {resp} {res.stderr.strip()}")
    return resp["result"]


def _http_get(url):
    import urllib.request
    t0 = time.perf_counter()
    with urllib.request.urlopen(url, timeout=60) as r:
        body = r.read()
    return body, time.perf_counter() - t0


def _scm_repo(root):
    """A git repository with one commit and a staged change."""
    def git(*args):
        res = subprocess.run(["git", "-c", "user.name=chip-smoke",
                              "-c", "user.email=chip-smoke@localhost",
                              *args], cwd=root, capture_output=True,
                             text=True, timeout=60)
        if res.returncode != 0:
            fail(f"control: git {' '.join(args)}: {res.stderr.strip()}")
    os.makedirs(root)
    git("init", "-q")
    with open(os.path.join(root, "utils.py"), "w") as f:
        f.write("def add(a, b):\n    return a - b\n")
    git("add", "utils.py")
    git("commit", "-q", "-m", "Add utils.add")
    with open(os.path.join(root, "utils.py"), "w") as f:
        f.write("def add(a, b):\n    return a + b\n\n\n"
                "def sub(a, b):\n    return a - b\n")
    git("add", "utils.py")


def phase_control(torch, cfg, params, seed, smi):
    """The control plane at full width: the port's native library and
    senweaver-ctl built from the package's native/ sources; a ControlServer
    and a JobRunner whose TrainState trains the loaded weights; through the
    binary a grpo job (its sessions on one paged engine: K1; its update:
    K2), an eval_rules job, a job stopped while queued and a malformed one;
    the sessions' spans in a TraceRing; the operator dashboard over the
    same registry, tracer and socket; the onboarding probe; an SCM commit
    message from the same engine."""
    import dataclasses
    import math
    import shutil
    import tempfile

    from senweaver_ide_tpu_torch import obs
    from senweaver_ide_tpu_torch.models import ByteTokenizer
    from senweaver_ide_tpu_torch.ops import flash_attention as fa
    from senweaver_ide_tpu_torch.ops.flash_decode import flash_decode
    from senweaver_ide_tpu_torch.ops.paged_attention import \
        paged_flash_decode
    from senweaver_ide_tpu_torch.rollout import (EnginePolicyClient,
                                                 RolloutEngine,
                                                 RolloutSession,
                                                 SampleParams)
    from senweaver_ide_tpu_torch.runtime import (ControlServer, JobRunner,
                                                 TraceRing, native)
    from senweaver_ide_tpu_torch.services import (DashboardService,
                                                  OnboardingService,
                                                  RuntimeConfig, SCMService)
    from senweaver_ide_tpu_torch.traces import TraceCollector
    from senweaver_ide_tpu_torch.training import (make_optimizer,
                                                  make_train_state)
    t_phase = time.perf_counter()
    tcfg = dataclasses.replace(cfg, attn_impl="flash", remat=TRAIN_REMAT)
    layers = tcfg.num_layers
    tok = ByteTokenizer()
    torch.cuda.reset_peak_memory_stats()

    # 1. the native library and the CLI, from this checkout's sources
    t0 = time.time()
    if not native.build_native(force=True):
        fail("control: the native library did not build (g++)")
    build_s = time.time() - t0
    lib_path, ctl = native._LIB_PATH, native.ctl_binary_path()
    for path in (lib_path, ctl):
        if path is None or os.path.getmtime(path) < t0 - 1:
            fail(f"control: {path} was not built by this run")
    if not native.native_available():
        fail("control: the native library does not load")
    log(f"[control] {smi}: built {lib_path} and {ctl} with g++ in "
        f"{build_s:.2f} s")

    work = tempfile.mkdtemp(prefix="chip_smoke_control_")
    obs.set_profiler(obs.RuntimeProfiler())
    tracer = obs.enable()
    tracer.clear()
    registry = obs.get_registry()
    ring = TraceRing(os.path.join(work, "spans.ring"), slot_size=16384,
                     n_slots=1024)
    collector = TraceCollector(span_sink=ring.append)
    engine = RolloutEngine(params, tcfg, num_slots=ROUND_SLOTS,
                           max_len=ROUND_MAX_LEN, sample=SampleParams(),
                           eos_id=tok.eos_id, seed=seed, device="cuda")
    sessions = []

    def make_session(rules=None):
        client = EnginePolicyClient(
            engine, tok, model_name=tcfg.name,
            default_max_new_tokens=ROUND_NEW_TOKENS, record_calls=True)
        n = len(sessions)
        sess = RolloutSession(client, os.path.join(work, f"ws{n}"),
                              thread_id=f"control-{n}", collector=collector,
                              apo_rules=list(rules or []),
                              include_tool_definitions=False)
        sessions.append(sess)
        return sess

    state = make_train_state(tcfg, params=params,
                             optimizer=make_optimizer(TRAIN_LR))
    step0 = int(state.step)
    sock = os.path.join(work, "ctl.sock")
    server = ControlServer(sock)
    runner = JobRunner(server, make_session=make_session, train_state=state,
                       model_config=tcfg, reward_override=_spread_reward,
                       pad_id=tok.pad_id, max_len=ROUND_MAX_LEN)
    dash = DashboardService(collector=collector, engine=engine,
                            control=server, tracer=tracer,
                            registry=registry)
    k2 = (fa.flash_attention_fwd, fa.flash_attention_bwd_dkdv,
          fa.flash_attention_bwd_dq)

    def reset():
        paged_flash_decode.launches = 0
        for w in k2:
            w.launches = 0

    def counts():
        return {"k1": paged_flash_decode.launches,
                "fwd": fa.flash_attention_fwd.launches,
                "dkdv": fa.flash_attention_bwd_dkdv.launches,
                "dq": fa.flash_attention_bwd_dq.launches}

    rounds0 = registry.counter("senweaver_rounds_total",
                               "Completed GRPO rounds.").value()
    flash_decode.launches = 0
    server.start()
    runner.start()
    try:
        if _ctl_ok(ctl, sock, "ping") != "pong":
            fail("control: ping did not answer pong")

        # 2. a GRPO job through the binary
        steps0 = engine.stats()["decode_steps"]
        reset()
        t0 = time.perf_counter()
        grpo_id = _ctl_ok(ctl, sock, "submit", json.dumps(
            {"type": "grpo", "tasks": list(ROUND_TASKS), "rounds": 1,
             "group_size": 2, "accum_steps": CONTROL_ACCUM}))["job_id"]
        _ctl_ok(ctl, sock, "watch")
        job_s = time.perf_counter() - t0
        job_launches = counts()
        job_steps = engine.stats()["decode_steps"] - steps0
        got = _ctl_ok(ctl, sock, "call", "job_result",
                      json.dumps({"job_id": grpo_id}))
        res = got.get("result") or {}
        if got.get("status") != "done":
            fail(f"control: the grpo job ended {got.get('status')}: "
                 f"{res.get('error')}")
        if res.get("rounds_done") != 1 or res.get("step") != step0 + 1:
            fail(f"control: the grpo job did {res.get('rounds_done')} "
                 f"rounds to step {res.get('step')}, expected 1 and "
                 f"{step0 + 1}")
        metrics = res["metrics"][0]
        bad = [k for k, v in metrics.items()
               if not (isinstance(v, (int, float)) and math.isfinite(v))]
        if bad:
            fail(f"control: non-finite job metrics {bad}: {metrics}")
        if job_launches["k1"] != layers * job_steps or not job_steps:
            fail(f"control: K1 launches {job_launches['k1']} != {layers} "
                 f"x {job_steps} fused steps")
        per_pass = layers * CONTROL_ACCUM
        expect = {"fwd": per_pass * (2 if TRAIN_REMAT else 1),
                  "dkdv": per_pass, "dq": per_pass}
        if {k: job_launches[k] for k in expect} != expect:
            fail(f"control: K2 launches {job_launches} != expected {expect}")
        ratio_err = abs(metrics["ratio_mean"] - 1.0)
        if not ratio_err < RATIO_TOL:
            fail(f"control: |ratio_mean - 1| = {ratio_err} >= {RATIO_TOL}")
        round_s = sum(rec.duration_ms for rec in tracer.spans()
                      if rec.name == "grpo_round") / 1e3

        # 3. an eval_rules job; 4. a job stopped while it waits behind it,
        # then a malformed one
        reset()
        t0 = time.perf_counter()
        eval_id = _ctl_ok(ctl, sock, "submit", json.dumps(
            {"type": "eval_rules", "rules": list(CONTROL_RULES)}))["job_id"]
        deadline = time.time() + CTL_TIMEOUT_S
        while server.jobs[eval_id].status == "queued":
            if time.time() > deadline:
                fail("control: the eval_rules job never started")
            time.sleep(0.05)
        held_id = _ctl_ok(ctl, sock, "submit", json.dumps(
            {"type": "grpo", "tasks": list(ROUND_TASKS), "rounds": 1,
             "group_size": 2}))["job_id"]
        stopped = _ctl_ok(ctl, sock, "stop", held_id)
        bad_id = _ctl_ok(ctl, sock, "submit", json.dumps(
            {"type": "no_such_job"}))["job_id"]
        _ctl_ok(ctl, sock, "watch")
        eval_s = time.perf_counter() - t0
        eval_launches = counts()
        by_id = {j["job_id"]: j["status"]
                 for j in _ctl_ok(ctl, sock, "status")}
        want = {grpo_id: "done", eval_id: "done", held_id: "stopped",
                bad_id: "failed"}
        if by_id != want or stopped.get("status") != "stopped":
            fail(f"control: job statuses {by_id} (stop said {stopped}), "
                 f"expected {want}")
        final = server.jobs[eval_id].result.get("final_reward")
        if not (isinstance(final, float) and math.isfinite(final)):
            fail(f"control: eval_rules final_reward {final}")
        if server.jobs[held_id].result is not None:
            fail("control: the stopped job ran")
        err = (server.jobs[bad_id].result or {}).get("error", "")
        if "unknown job type" not in err:
            fail(f"control: the malformed job's error reads {err!r}")
        if eval_launches["k1"] <= 0 or any(eval_launches[k] for k in expect):
            fail(f"control: eval_rules launches {eval_launches}")

        # 5. the ring holds every span the collector accepted
        n_spans = sum(len(t.spans) for t in collector.get_all_traces())
        first, head = ring.window()
        back = [ring.read(i) for i in range(first, head)]
        if (head != n_spans or first != 0 or ring.dropped
                or any(b is None for b in back)):
            fail(f"control: ring head {head}, window from {first}, "
                 f"dropped {ring.dropped}; the collector holds {n_spans}")
        ids = {json.loads(b)["id"] for b in back}
        if ids != {s.id for t in collector.get_all_traces()
                   for s in t.spans}:
            fail("control: the ring's spans are not the collector's")

        # 6. the dashboard over the same registry, tracer and socket
        dash.control_socket = sock
        port = dash.start("127.0.0.1", 0)
        base = f"http://127.0.0.1:{port}"
        body, state_s = _http_get(base + "/api/state")
        st = json.loads(body)
        tiles = {j["job_id"]: j["status"] for j in st.get("jobs", [])}
        if tiles != want:
            fail(f"control: /api/state jobs {tiles}, expected {want}")
        fused = {f["fn"]: f["calls"] for f in st["runtime"]["functions"]}
        if not fused.get("engine.fused_step"):
            fail(f"control: the runtime tile lacks the engine's fused "
                 f"step: {sorted(fused)}")
        import urllib.request
        req = urllib.request.Request(
            base + "/api/action", data=json.dumps({"method": "status"})
            .encode(), headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            act = json.loads(r.read())
        if not act.get("ok") or {j["job_id"]: j["status"]
                                 for j in act["result"]} != want:
            fail(f"control: /api/action status over the socket: {act}")
        text, metrics_s = _http_get(base + "/metrics")
        rounds = [float(ln.split()[-1]) for ln in text.decode().splitlines()
                  if ln.startswith("senweaver_rounds_total ")]
        if rounds != [rounds0 + 1] or b"senweaver_train_step_ms" not in text:
            fail(f"control: /metrics rounds {rounds} (before the job "
                 f"{rounds0}), or no senweaver_train_step_ms")

        # 7. onboarding: the probe's subprocess reaches the card
        ob = OnboardingService(
            RuntimeConfig(settings_path=os.path.join(work, "settings.json")),
            state_path=os.path.join(work, "onboarding.json"))
        t0 = time.perf_counter()
        probed = ob.probe_accelerator()
        probe_s = time.perf_counter() - t0
        if not probed:
            fail("control: the onboarding probe found no card")
        answered = ob.answer("accelerator", "gpu")
        if answered["answers"].get("accelerator") != "gpu":
            fail(f"control: onboarding did not take 'gpu': {answered}")

        # 8. an SCM commit message from the same engine, greedy
        repo = os.path.join(work, "scm")
        _scm_repo(repo)
        engine.sample = SampleParams(0.0, 0, 1.0)
        reset()
        steps0 = engine.stats()["decode_steps"]
        client = EnginePolicyClient(engine, tok, model_name=tcfg.name,
                                    default_max_new_tokens=ROUND_NEW_TOKENS)
        t0 = time.perf_counter()
        try:
            scm = "message: " + repr(
                SCMService(client).generate_commit_message(repo))
        except RuntimeError as e:
            if "no <output> commit message" not in str(e):
                raise
            scm = f"RuntimeError: {e}"
        scm_s = time.perf_counter() - t0
        scm_k1 = paged_flash_decode.launches
        scm_steps = engine.stats()["decode_steps"] - steps0
        if scm_k1 != layers * scm_steps or not scm_steps:
            fail(f"control: SCM K1 launches {scm_k1} != {layers} x "
                 f"{scm_steps} fused steps")
        if flash_decode.launches:
            fail(f"control: K3 launched {flash_decode.launches} times")
        engine._alloc.check_leaks()
    finally:
        dash.stop()
        runner.stop()
        server.stop()
        ring.close()
        obs.disable()
        shutil.rmtree(work, ignore_errors=True)
    peak = torch.cuda.max_memory_allocated()
    log(f"[control] {smi}: a ControlServer on a unix socket and a JobRunner "
        f"over a TrainState of the loaded weights ({tcfg.name}, {layers} "
        f"layers, flash, remat, accum {CONTROL_ACCUM}, lr {TRAIN_LR}); "
        f"through senweaver-ctl a "
        f"grpo job of {len(ROUND_TASKS)} tasks x 2 agent sessions on one "
        f"paged engine ({ROUND_SLOTS} slots, max_len {ROUND_MAX_LEN}, "
        f"{ROUND_NEW_TOKENS} new a call, spread rewards, "
        f"{res['metrics'][0]['episodes']} episodes): done in "
        f"{job_s:.2f} s (the grpo_round span {round_s:.2f} s), step "
        f"{step0} -> {res['step']}, loss {metrics['loss']:.6g}, ratio_mean "
        f"{metrics['ratio_mean']:.6f}; K1 {job_launches['k1']} = {layers} "
        f"x {job_steps} fused steps, K2 {job_launches['fwd']} / "
        f"{job_launches['dkdv']} / {job_launches['dq']}")
    log(f"[control] {smi}: the eval_rules job ({len(CONTROL_RULES)} rules, "
        f"six pattern tasks) final_reward {final:.6g}, the queued job "
        f"stopped unrun and the malformed one failed, all in {eval_s:.2f} "
        f"s; K1 {eval_launches['k1']}; {head} spans in the ring, each the "
        f"collector's; /api/state in {state_s * 1e3:.1f} ms, /metrics in "
        f"{metrics_s * 1e3:.1f} ms (senweaver_rounds_total {rounds[0]:g}); "
        f"the onboarding probe passed in {probe_s:.2f} s; SCM in "
        f"{scm_s:.2f} s, K1 {scm_k1} = {layers} x {scm_steps}: {scm}; K3 0; "
        f"peak max_memory_allocated {peak} bytes; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    return {"k1": job_launches["k1"] + eval_launches["k1"] + scm_k1,
            **{k: job_launches[k] for k in expect}, "k3": 0}


def _spread_reward(task_idx, g, session):
    """Rewards that spread within a group (random weights tie every group
    on the trace reward, which would make every update zero)."""
    return 1.0 if g % 2 == 0 else -1.0


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


# Weight-only int8 on the 1.5B (phase_int8): the serving engine's traffic,
# greedy, once on int8 and once on bf16 weights; one profiled window a run
INT8_REQUESTS, INT8_PROMPT_LENS, INT8_NEW = 16, (128, 1024), 64
PROFILE_STEPS = 4
# Qwen3-30B-A3B (phase_moe): the serving engine's shape, 32 new tokens
MOE_SLOTS, MOE_MAX_LEN, MOE_REQUESTS = 16, 2048, 8
# Qwen3-30B-A3B's depth in phase_moe: half its 48 layers, a time cut
# (at 48 the whole script took up to 1,120 s of its 1,200 s limit on an
# H100 80GB HBM3 at 700 W)
MOE_LAYERS = 24
MOE_PROMPT_LENS, MOE_NEW = (128, 1024), 32
# One routed layer of a fused step against the per-expert loop: the same
# bf16 expert matmuls at other shapes round differently (2**-9 relative at
# each bf16 output), the gates and the combine are fp32 on both sides
MOE_LAYER_ATOL = MOE_LAYER_RTOL = 1e-2
# K2 at Qwen3-30B-A3B's heads on the QLoRA step's shape: microbatch 2 x 511
K2_REP8_B, K2_REP8_S = 2, 511
# The QLoRA GRPO step on the int8 base: 2 prompts x 4 sampled completions,
# attention targets, flash, remat, accum 4
QLORA_PROMPTS, QLORA_GROUP, QLORA_NEW = 2, 4, 64
QLORA_PROMPT_LENS, QLORA_RANK, QLORA_ACCUM, QLORA_LR = (384, 448), 16, 4, 1e-3


def _step_logit_diffs(torch, cfg, params, seed):
    """One fused step (3 decode rows, a 32-token prefill chunk, a dropped
    write) on a pool prefilled through K1: (max |kernel - plain path|,
    max |kernel path - the no-cache forward over each entry's sequence|,
    entries)."""
    from senweaver_ide_tpu_torch.models import forward, forward_paged
    from senweaver_ide_tpu_torch.rollout import init_paged_pool
    bs, mb = 16, 128
    lens = [300, 700, 1500, 40]
    pool = init_paged_pool(cfg, len(lens) * mb, bs, device="cuda")
    tables = torch.arange(len(lens) * mb, dtype=torch.int32).view(-1, mb)
    g = torch.Generator().manual_seed(seed + 7)
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

    flat = [entry(r, p) for r, n in enumerate(lens) for p in range(n)]
    with torch.no_grad():
        for i in range(0, len(flat), 256):
            forward_paged(params, cfg, pool=pool, tables=tables,
                          use_kernel=True, **batch(flat[i:i + 256]))
        step = ([entry(r, lens[r]) for r in range(3)]
                + [entry(3, p) for p in range(lens[3], lens[3] + 32)]
                + [entry(0, 10, drop=True)])
        pools = [type(pool)(*(None if a is None else a.clone()
                              for a in pool)) for _ in range(2)]
        logits = [forward_paged(params, cfg, pool=p, tables=tables,
                                use_kernel=k, **batch(step))[0].float()
                  for p, k in zip(pools, (True, False))]
        plain = float((logits[0] - logits[1]).abs().max())
        ref = 0.0
        for i, (_, row, pos, _, _) in enumerate(step[:-1]):
            want = forward(params, cfg, seqs[row][None, :pos + 1].cuda())[
                0, -1].float()
            ref = max(ref, float((logits[0][i] - want).abs().max()))
    return plain, ref, len(step)


def _profiled_step_ms(torch, engine, steps):
    """Device ms a fused step over ``steps`` steps under torch.profiler,
    the window's idle share and its step count."""
    from torch.profiler import ProfilerActivity, profile

    def device_us(evt):
        for name in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(evt, name):
                return float(getattr(evt, name))
        return 0.0

    torch.cuda.synchronize()
    # device activity only: a host-op trace of an MoE step (thousands of
    # ops) took longer to summarise than the steps took to run
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        n = 0
        while n < steps and engine.has_work:
            engine.step()
            n += 1
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy = sum(device_us(e) for e in prof.key_averages()
               if e.device_type.name == "CUDA")
    return busy / 1e3 / max(n, 1), 1 - busy / wall_us, n


def _serve_traffic(torch, engine, prompts, new, layers, label, reset,
                   profile_after=None):
    """Submit ``prompts`` (``new`` tokens each), zero K1's count, drive the
    engine to the end and read the count: it must be layers x fused
    steps. With ``profile_after``, PROFILE_STEPS steps after that many run
    under the profiler (they count). Returns a dict of the run's
    figures."""
    from senweaver_ide_tpu_torch.ops.paged_attention import \
        paged_flash_decode
    rids = [engine.submit(p, max_new_tokens=new) for p in prompts]
    st0 = engine.stats()
    if reset:
        paged_flash_decode.launches = 0
    k0 = paged_flash_decode.launches
    torch.cuda.synchronize()
    step_ms, prof = [], None
    prof_s, prof_tokens = 0.0, 0
    t0 = time.perf_counter()
    while engine.has_work:
        if profile_after is not None and prof is None \
                and len(step_ms) == profile_after:
            # the window's steps run slower under the profiler: they are
            # left out of the step times and the rate
            e0, s = engine.stats()["tokens_emitted"], time.perf_counter()
            prof = _profiled_step_ms(torch, engine, PROFILE_STEPS)
            prof_s = time.perf_counter() - s
            prof_tokens = engine.stats()["tokens_emitted"] - e0
            continue
        s = time.perf_counter()
        engine.step()
        step_ms.append((time.perf_counter() - s) * 1e3)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0 - prof_s
    k1 = paged_flash_decode.launches - k0
    st = engine.stats()
    steps = st["decode_steps"] - st0["decode_steps"]
    if k1 != layers * steps or k1 == 0:
        fail(f"{label}: K1 launches {k1} != {layers} x {steps} fused steps")
    streams = [engine.result(r) for r in rids]
    for rid, toks in zip(rids, streams):
        lp = engine.result_logps(rid)
        if len(toks) != new or not all(x == x and x <= 0 for x in lp):
            fail(f"{label}: request {rid} gave {len(toks)} tokens or a "
                 f"non-finite / positive log-prob")
    engine._alloc.check_leaks()
    gen = st["tokens_emitted"] - st0["tokens_emitted"] - prof_tokens
    return dict(wall=wall, steps=steps, k1=k1, tok_s=gen / wall,
                p50=statistics.median(step_ms),
                p90=statistics.quantiles(step_ms, n=10)[-1],
                streams=streams, prof=prof)


def _run_text(r):
    text = (f"{r['steps']} fused steps, {r['wall']:.2f} s outside the "
            f"profiled window = "
            f"{r['tok_s']:.1f} tok/s, p50 step {r['p50']:.2f} ms, p90 step "
            f"{r['p90']:.2f} ms, K1 {r['k1']}")
    if r["prof"] is not None:
        dev_ms, idle, n = r["prof"]
        text += (f"; profiled window of {n} steps: {dev_ms:.2f} device ms a "
                 f"step, idle share {idle:.3f}")
    return text


def _token_agreement(a, b):
    pairs = [(x, y) for sa, sb in zip(a, b) for x, y in zip(sa, sb)]
    return sum(x == y for x, y in pairs) / max(len(pairs), 1)


def phase_int8(torch, cfg, params, seed, smi, tie_atol):
    """Weight-only int8 on the qwen2.5-coder-1.5b weights: quantize_weights
    _int8 (bytes computed and measured), one fused step's logits K1 vs the
    plain path within the tie tolerance, the serving traffic on int8 and on
    bf16 weights side by side with a profiled window each, then a bf16
    publish into the int8 engine (re-quantized). K1 = 28 x fused steps.
    Returns {"k1": launches} over the int8 engine's runs."""
    import numpy as np
    from senweaver_ide_tpu_torch.models import (is_quantized,
                                                quantize_weights_int8,
                                                quantized_bytes)
    from senweaver_ide_tpu_torch.rollout import RolloutEngine, SampleParams
    layers = cfg.num_layers
    other0 = (_k2_count(), _k3_count())
    before = quantized_bytes(params)
    torch.cuda.synchronize()
    alloc0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    qparams = quantize_weights_int8(params)
    torch.cuda.synchronize()
    q_s = time.perf_counter() - t0
    added = torch.cuda.memory_allocated() - alloc0
    after = quantized_bytes(qparams)
    new_bytes = sum(t.numel() * t.element_size() for t in _leaves(qparams)
                    if not any(t is u for u in _leaves(params)))
    log(f"[int8] {cfg.name}: quantize_weights_int8 in {q_s:.3f} s; param "
        f"bytes {before} (bf16) -> {after} (int8 dense matrices, fp32 "
        f"scales, the bf16 embed kept for the gather, the int8 tied-head "
        f"shadow); new tensors {new_bytes} bytes computed, "
        f"{added} bytes measured (memory_allocated)")
    if not is_quantized(qparams) or qparams["tied_head_q8"].dtype != \
            torch.int8:
        fail("int8: quantize_weights_int8 left the weights full width")
    plain, ref, n = _step_logit_diffs(torch, cfg, qparams, seed)
    log(f"[int8] one fused step on int8 weights ({n} entries): K1 vs the "
        f"plain path max |dlogit| {plain:.4g}, vs the no-cache forward "
        f"{ref:.4g} (tie tolerance {tie_atol:.4f})")
    if not (plain <= tie_atol and ref <= tie_atol):
        fail(f"int8 fused step: logit paths differ by {max(plain, ref)} > "
             f"{tie_atol}")

    rng = np.random.default_rng(seed + 12)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(k)).tolist()
               for k in rng.integers(INT8_PROMPT_LENS[0],
                                     INT8_PROMPT_LENS[1] + 1,
                                     size=INT8_REQUESTS)]
    greedy = SampleParams(0.0, 0, 1.0)
    runs = {}
    k1 = 0          # every engine of the phase: 28 x its fused steps
    for name, p in (("int8", qparams), ("bf16", params)):
        eng = RolloutEngine(p, cfg, num_slots=16, max_len=2048,
                            sample=greedy, seed=seed, device="cuda")
        if eng.stats()["weight_quant"] != int(name == "int8"):
            fail(f"int8: the {name} engine reports weight_quant "
                 f"{eng.stats()['weight_quant']}")
        runs[name] = _serve_traffic(torch, eng, prompts, INT8_NEW, layers,
                                    f"int8 phase, {name} weights",
                                    reset=name == "int8", profile_after=40)
        k1 += runs[name]["k1"]
        if name == "int8":
            # the trainer publishes full-precision weights: re-quantized
            eng.update_params(params)
            if eng.stats()["weight_quant"] != 1 or \
                    eng.params["layers"]["wq"].dtype != torch.int8:
                fail("int8: a bf16 publish was not quantized again")
            steps0, k0 = eng.stats()["decode_steps"], _k1_count()
            rid = eng.submit(prompts[0], max_new_tokens=8)
            eng.run()
            n = _k1_count() - k0
            if n != layers * (eng.stats()["decode_steps"] - steps0):
                fail(f"int8 publish: K1 {n} != {layers} x fused steps")
            k1 += n
            if len(eng.result(rid)) != 8:
                fail("int8: the engine did not serve after the publish")
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    agree = _token_agreement(runs["int8"]["streams"], runs["bf16"]["streams"])
    lens = [len(p) for p in prompts]
    for name in ("int8", "bf16"):
        log(f"[int8] {name} weights, {INT8_REQUESTS} greedy requests "
            f"(prompts {min(lens)}..{max(lens)}, {INT8_NEW} new), {smi}: "
            + _run_text(runs[name]))
    q, b = runs["int8"], runs["bf16"]
    log(f"[int8] int8 / bf16: tok/s {q['tok_s'] / b['tok_s']:.3f}x, "
        f"p50 step {q['p50'] / b['p50']:.3f}x; greedy "
        f"token agreement int8 vs bf16 {agree:.3f} (a figure, not a "
        f"check); publish of bf16 weights re-quantized (weight_quant 1), "
        f"served 8 more tokens; K1 {k1} = {layers} x fused steps")
    del qparams
    return {"k1": k1, **_other_launches(other0, "int8")}


def _k3_count():
    from senweaver_ide_tpu_torch.ops.flash_decode import flash_decode
    return flash_decode.launches


def _other_launches(before, label):
    """K2's and K3's launches since ``before`` (their counts then): a
    serving phase on the paged pool launches neither."""
    k2 = {k: v - before[0][k] for k, v in _k2_count().items()}
    k3 = _k3_count() - before[1]
    if any(k2.values()) or k3:
        fail(f"{label}: K2 {k2} and K3 {k3} launched on the paged path")
    return {"k2": k2, "k3": k3}


def _k1_count():
    from senweaver_ide_tpu_torch.ops.paged_attention import \
        paged_flash_decode
    return paged_flash_decode.launches


def _k2_count():
    from senweaver_ide_tpu_torch.ops import flash_attention as fa
    return {"fwd": fa.flash_attention_fwd.launches,
            "dkdv": fa.flash_attention_bwd_dkdv.launches,
            "dq": fa.flash_attention_bwd_dq.launches}


def _k2_reset():
    from senweaver_ide_tpu_torch.ops import flash_attention as fa
    for w in (fa.flash_attention_fwd, fa.flash_attention_bwd_dkdv,
              fa.flash_attention_bwd_dq):
        w.launches = 0


def phase_kernel_rep8(torch, mcfg, timer):
    """K1 and K2 at Qwen3-30B-A3B's heads (32/4, D 128, rep 8): K1's
    checks (two-entry tiles) and its decode-step time; K2's forward, dK/dV
    and dQ against their plain versions at the QLoRA step's shape
    (2 x 511), each timed beside its bound and its plain version."""
    from senweaver_ide_tpu_torch.ops import flash_attention as fa
    g = torch.Generator(device="cuda").manual_seed(5)
    out = {"k1_err": _k1_head_checks(torch, g, mcfg, "rep 8")}
    ms, plain_ms, bound, nbytes = _k1_decode_time(torch, g, mcfg, timer)
    out["k1"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bytes=nbytes)
    log(f"[kernel] rep 8 decode step, heads {mcfg.num_heads}/"
        f"{mcfg.num_kv_heads} D {mcfg.head_dim}, T=16 lengths 128..2048: "
        f"kernel {ms:.4f} ms = {bound / ms:.3f} of the bound, plain "
        f"{plain_ms:.4f} ms, bound {bound:.4f} ms ({nbytes} bytes)")
    hq, hkv, d = mcfg.num_heads, mcfg.num_kv_heads, mcfg.head_dim
    b, s = K2_REP8_B, K2_REP8_S
    names = ("out", "lse", "dq", "dk", "dv")
    args = _fa_case(torch, fa, g, b, s, hq, hkv, d)
    got, again = _fa_run(fa, *args), _fa_run(fa, *args)
    torch.cuda.synchronize()
    ref = _fa_plain(fa, *args)
    errs = {}
    for name, a, a2, r in zip(names, got, again, ref):
        if not torch.equal(a, a2):
            fail(f"flash rep 8: {name} differs between two launches")
        e, ok = _fa_err(a, r, *FA_TOL[name])
        if not ok:
            fail(f"flash rep 8 B={b} S={s}: {name} kernel vs plain max err "
                 f"{e} (tol {_fa_tol_text(FA_TOL[name])})")
        errs[name] = e
    q, k, v, gout, bias, kw = args
    o, lse = fa.flash_attention_fwd(q, k, v, bias, **kw)
    delta = fa._delta(gout, o)
    t = {"fwd": timer.ms(lambda: fa.flash_attention_fwd(q, k, v, **kw)),
         "dkdv": timer.ms(lambda: fa.flash_attention_bwd_dkdv(
             q, k, v, None, gout, lse, delta, **kw)),
         "dq": timer.ms(lambda: fa.flash_attention_bwd_dq(
             q, k, v, None, gout, lse, delta, **kw)),
         "plain_fwd": timer.ms(lambda: fa.flash_attention_fwd_plain(
             q, k, v, **kw), iters=10),
         "plain_bwd": timer.ms(lambda: fa._bwd_plain(
             q, k, v, None, gout, lse, delta, **kw), iters=5)}
    gqa_note = _sdpa_times(torch, timer, q, k, v, gout, t)
    for kname, (flops, nb) in _fa_work(b, s, hq, hkv, d).items():
        bound = max(flops / BF16_FLOPS, nb / HBM_BYTES_PER_S) * 1e3
        plain = t["plain_fwd" if kname == "fwd" else "plain_bwd"]
        lib = t["sdpa_fwd" if kname == "fwd" else "sdpa_bwd"]
        out[kname] = dict(ms=t[kname], plain_ms=plain, bound_ms=bound,
                          library_ms=lib,
                          max_abs_err=max(errs[n] for n in FA_ERR_OF[kname]))
        log(f"[flash] rep 8 {kname} at B={b} S={s} Hq={hq} Hkv={hkv} D={d} "
            f"bf16 causal: kernel {t[kname]:.4f} ms = {bound / t[kname]:.3f} "
            f"of the bound, plain {plain:.4f} ms, bound {bound:.4f} ms, SDPA "
            f"({gqa_note}) {lib:.4f} ms"
            + (f" (forward + backward {t['sdpa_fwd_bwd']:.4f} ms)"
               if kname != "fwd" else "") + "; max |kernel - plain| "
            + ", ".join(
                f"{n} {errs[n]:.3g}" for n in FA_ERR_OF[kname])
            + "; two launches bit-identical")
    return out


def _capture_moe_layer(layer):
    """Patch the transformer's moe_ffn so that its ``layer``-th call of the
    first flat batch of the step budget records its params, config, input
    and output. Returns (record dict, restore function)."""
    from senweaver_ide_tpu_torch.models import transformer as tf
    real = tf.moe_ffn
    rec, calls = {}, [0]

    def spy(p, mcfg, h, **kw):
        out = real(p, mcfg, h, **kw)
        if not rec:
            calls[0] += 1
            if calls[0] == layer + 1:
                rec.update(p=p, cfg=mcfg, h=h.detach().clone(),
                           out=out[0].detach().clone())
        return out

    tf.moe_ffn = spy

    def restore():
        tf.moe_ffn = real
    return rec, restore


def _moe_loop_reference(torch, p, mcfg, h):
    """The routed FFN written out: softmax router, top-k, renormalised
    gates, capacity slots counted token by token on the host, then one
    expert at a time over the tokens it kept. Returns (out, dropped share
    of the assignments, per-expert kept counts, capacity)."""
    import math
    x = h.reshape(-1, h.shape[-1])
    t, e_n, k = x.shape[0], mcfg.num_experts, mcfg.top_k
    cap = max(1, math.ceil(t / e_n * mcfg.capacity_factor * k))
    probs = torch.softmax(x.float() @ p["router"].float(), dim=-1)
    gates, idx = torch.topk(probs, k, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    count = [0] * e_n
    per_expert = [[] for _ in range(e_n)]
    for ti, row in enumerate(idx.tolist()):
        for j, e in enumerate(row):
            if count[e] < cap:
                per_expert[e].append((ti, j))
                count[e] += 1
    y = torch.zeros(t, x.shape[1], dtype=torch.float32, device=x.device)
    for e, kept in enumerate(per_expert):
        if not kept:
            continue
        rows = torch.tensor([ti for ti, _ in kept], device=x.device)
        cols = torch.tensor([j for _, j in kept], device=x.device)
        xe = x[rows]
        gate = xe @ p["w_gate"][e]
        up = xe @ p["w_up"][e]
        act = torch.nn.functional.silu(gate.float()).to(x.dtype) * up
        ye = act @ p["w_down"][e]
        y.index_add_(0, rows, ye.float() * gates[rows, cols, None])
    dropped = 1 - sum(count) / (t * k)
    return y.to(x.dtype).view(h.shape), dropped, count, cap


def _base_sums(torch, params):
    """Per tensor, the sum of its raw bytes (int8) or 16-bit words and
    every 7th of them (the rest): equal trees give equal sums."""
    out = []
    for t in _leaves(params):
        if t.dtype == torch.int8:
            flat = t.view(torch.uint8).reshape(-1)
            step = 1 << 27          # int64 partial sums, 1 GB at a time
            out.append(sum(int(flat[i:i + step].sum(dtype=torch.int64))
                           for i in range(0, flat.numel(), step)))
        else:
            out.extend(_checksum(torch, {"t": t}))
    return out


def _quantize_in_place(torch, params):
    """quantize_weights_int8 one stacked tensor at a time, each bf16
    tensor released as soon as its int8 copy exists: the peak is the bf16
    tree plus the largest int8 tensor and one layer's fp32 transient."""
    from senweaver_ide_tpu_torch.models import quantize_weights_int8
    from senweaver_ide_tpu_torch.models.quantize import (QUANTIZABLE,
                                                         _quantize_matrix)
    layers = params["layers"]
    for name in QUANTIZABLE:
        q, sc = _quantize_matrix(layers[name])
        layers[name], layers[name + "_scale"] = q, sc
        del q, sc
        torch.cuda.empty_cache()
    head = params.pop("lm_head", None)
    if head is not None:
        params["lm_head"], params["lm_head_scale"] = _quantize_matrix(head)
        del head
        torch.cuda.empty_cache()
    return quantize_weights_int8(params)      # nothing left: a no-op


def phase_moe(torch, mcfg, seed, smi, timer):
    """Qwen3-30B-A3B at full width (``mcfg``'s depth) on one card: K1 and
    K2 at its heads; random bf16 weights; the serving engine on
    MOE_REQUESTS greedy requests (K1 = layers x fused steps) with one
    fused step's routed layer held against the per-expert loop; the same
    traffic under a dropless copy of the config, every token
    teacher-forced against the plain forward; int8 in place, the traffic again on int8 weights; a QLoRA
    GRPO step on the int8 base (K2) under the dropless copy: at capacity
    factor 1.25 the engine's batches and the trainer's microbatches drop
    different assignments, so the first step's ratio would read that
    batch dependence and not the serving and training paths' agreement;
    materialize_lora, update_params and one more request."""
    import dataclasses

    import numpy as np
    from senweaver_ide_tpu_torch.models import init_params
    from senweaver_ide_tpu_torch.models.quantize import quantized_bytes
    from senweaver_ide_tpu_torch.rollout import RolloutEngine, SampleParams
    from senweaver_ide_tpu_torch.training import (Trajectory, make_batch,
                                                  make_batch_logps,
                                                  make_lora_train_state,
                                                  materialize_lora,
                                                  train_step)
    t_phase = time.perf_counter()

    def stamp():
        return f"[moe +{time.perf_counter() - t_phase:.1f} s]"

    layers = mcfg.num_layers
    out = {"k1": {}, "k2": {}}
    out["rep8"] = phase_kernel_rep8(torch, mcfg, timer)
    other0 = (_k2_count(), _k3_count())

    # 2. random bf16 weights from the seed
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(mcfg, torch.Generator(device="cuda").manual_seed(
        seed), device="cuda")
    torch.cuda.synchronize()
    total = quantized_bytes(params)
    banks = sum(quantized_bytes(params["layers"][n])
                for n in ("w_gate", "w_up", "w_down"))
    log(f"{stamp()} {mcfg.name}: {layers} layers, {mcfg.num_experts} experts, "
        f"top-{mcfg.num_experts_per_tok}, hidden {mcfg.hidden_size}, expert "
        f"FFN {mcfg.intermediate_size}, heads {mcfg.num_heads}/"
        f"{mcfg.num_kv_heads} D {mcfg.head_dim}, QK-norm, capacity factor "
        f"{mcfg.expert_capacity_factor}, bf16 random weights (seed {seed}) "
        f"in {time.perf_counter() - t0:.2f} s: {total} bytes computed = "
        f"{total / 1e9:.2f} GB ({banks / 1e9:.2f} GB expert banks), "
        f"memory_allocated {torch.cuda.memory_allocated()}")

    rng = np.random.default_rng(seed + 30)
    prompts = [rng.integers(0, mcfg.vocab_size, size=int(k)).tolist()
               for k in rng.integers(MOE_PROMPT_LENS[0],
                                     MOE_PROMPT_LENS[1] + 1,
                                     size=MOE_REQUESTS)]
    lens = [len(p) for p in prompts]
    greedy = SampleParams(0.0, 0, 1.0)

    # 3. the serving engine, bf16; 4. one fused step's routed layer
    eng = RolloutEngine(params, mcfg, num_slots=MOE_SLOTS,
                        max_len=MOE_MAX_LEN, sample=greedy, seed=seed,
                        device="cuda")
    rec, restore = _capture_moe_layer(layers - 1)
    try:
        bf16 = _serve_traffic(torch, eng, prompts, MOE_NEW, layers,
                              "moe bf16", reset=True, profile_after=20)
    finally:
        restore()
    out["k1"]["bf16"] = bf16["k1"]
    log(f"{stamp()} bf16 weights, {MOE_REQUESTS} greedy requests (prompts "
        f"{min(lens)}..{max(lens)}, {MOE_NEW} new), {MOE_SLOTS} slots, "
        f"block 16, step budget 64, {smi}: " + _run_text(bf16)
        + f"; max_memory_allocated {torch.cuda.max_memory_allocated()}")
    with torch.no_grad():
        ref, dropped, load, cap = _moe_loop_reference(torch, rec["p"],
                                                      rec["cfg"], rec["h"])
    got = rec["out"].float()
    diff = (got - ref.float()).abs()
    ok = bool((diff <= MOE_LAYER_ATOL + MOE_LAYER_RTOL
               * ref.float().abs()).all())
    log(f"{stamp()} layer {layers - 1} of the first fused step (T = "
        f"{rec['h'].shape[0]}, capacity {cap}): moe_ffn vs the per-expert "
        f"loop max |diff| {float(diff.max()):.4g} (tol {MOE_LAYER_ATOL} + "
        f"{MOE_LAYER_RTOL} * |loop|); dropped share of the assignments "
        f"{dropped:.4f}; kept per expert min {min(load)} / mean "
        f"{sum(load) / len(load):.2f} / max {max(load)}; experts with none "
        f"{sum(1 for x in load if x == 0)}")
    if not ok:
        fail(f"moe: the routed layer differs from the per-expert loop by "
             f"{float(diff.max())}")
    del eng, rec
    gc.collect()
    torch.cuda.empty_cache()

    # 5. the streams under a dropless copy (C = T: no batch dependence),
    # teacher-forced against the plain forward
    dcfg = dataclasses.replace(
        mcfg, expert_capacity_factor=float(mcfg.num_experts
                                           // mcfg.num_experts_per_tok))
    plain, ref_d, n = _step_logit_diffs(torch, dcfg, params, seed)
    tie = TIE_FACTOR * min(max(plain, ref_d), TIE_DIFF_MAX)
    eng = RolloutEngine(params, dcfg, num_slots=MOE_SLOTS,
                        max_len=MOE_MAX_LEN, sample=greedy, seed=seed,
                        device="cuda")
    dropless = _serve_traffic(torch, eng, prompts, MOE_NEW, layers,
                              "moe dropless", reset=False)
    out["k1"]["bf16"] += dropless["k1"]
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    leaves, widest, off = _teacher_forced(
        torch, params, dcfg, prompts, dropless["streams"], tie,
        "moe dropless streams", ref=bf16["streams"])
    log(f"{stamp()} dropless copy (capacity factor "
        f"{dcfg.expert_capacity_factor}): one fused step's logits K1 vs "
        f"plain {plain:.4g}, vs the no-cache forward {ref_d:.4g} ({n} "
        f"entries), tie tolerance {tie:.4f}; " + _run_text(dropless)
        + f"; every token within the tie tolerance of the plain forward's "
        f"argmax (widest gap {widest:.4f}, {off} off the argmax); first "
        f"index off the capacity-1.25 streams {leaves}")

    # 6. int8 in place, one stacked tensor at a time
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = _quantize_in_place(torch, params)
    torch.cuda.synchronize()
    q_s = time.perf_counter() - t0
    qbytes = quantized_bytes(params)
    log(f"{stamp()} int8 in place in {q_s:.2f} s: {total} -> {qbytes} bytes "
        f"computed, memory_allocated {torch.cuda.memory_allocated()}, "
        f"max_memory_allocated {torch.cuda.max_memory_allocated()}")

    # 7. the same traffic on the int8 weights
    eng = RolloutEngine(params, mcfg, num_slots=MOE_SLOTS,
                        max_len=MOE_MAX_LEN, sample=greedy, seed=seed,
                        device="cuda")
    if eng.stats()["weight_quant"] != 1:
        fail("moe: the int8 engine does not report weight_quant 1")
    q8 = _serve_traffic(torch, eng, prompts, MOE_NEW, layers, "moe int8",
                        reset=False, profile_after=20)
    out["k1"]["int8_weights"] = q8["k1"]
    agree = _token_agreement(q8["streams"], bf16["streams"])
    log(f"{stamp()} int8 weights, the same traffic: " + _run_text(q8)
        + f"; against bf16: tok/s {q8['tok_s'] / bf16['tok_s']:.3f}x, p50 "
        f"{q8['p50'] / bf16['p50']:.3f}x; greedy token agreement "
        f"{agree:.3f} (a figure, not a check)")
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    # 8. one QLoRA GRPO step on the int8 base, dropless (see above)
    tcfg = dataclasses.replace(dcfg, attn_impl="flash", remat=True)
    eng = RolloutEngine(params, tcfg, num_slots=MOE_SLOTS,
                        max_len=MOE_MAX_LEN, seed=seed, device="cuda")
    qp = [rng.integers(0, mcfg.vocab_size, size=int(k)).tolist()
          for k in rng.integers(QLORA_PROMPT_LENS[0],
                                QLORA_PROMPT_LENS[1] + 1,
                                size=QLORA_PROMPTS)]
    # one prefill a group (submit_group): the followers graft its spine
    subs = [(gi, rid) for gi, p in enumerate(qp)
            for rid in eng.submit_group(p, QLORA_GROUP,
                                        max_new_tokens=QLORA_NEW)]
    k1_0 = _k1_count()
    eng.run()
    roll_k1 = _k1_count() - k1_0
    trajs = []
    for gi, rid in subs:
        toks, logps = eng.result(rid), eng.result_logps(rid)
        if len(toks) != QLORA_NEW or not np.all(np.isfinite(logps)):
            fail(f"qlora rollout {rid}: {len(toks)} tokens")
        trajs.append(Trajectory(prompt_ids=qp[gi], completion_ids=toks,
                                reward=_stand_in_reward(toks), group_id=gi,
                                behavior_logp=logps))
    tokens, mask, rewards, gids = make_batch(trajs, pad_id=0)
    old_logp = make_batch_logps(trajs, tokens, mask)
    served = _other_launches(other0, "moe serving")
    out["k3"], out["k2_serving"] = served["k3"], served["k2"]
    k3_qlora = _k3_count()
    state = make_lora_train_state(
        tcfg, params, torch.Generator(device="cuda").manual_seed(seed + 3),
        rank=QLORA_RANK, learning_rate=QLORA_LR)
    base_sum = _base_sums(torch, params)
    b_before = {k: v.clone() for k, v in state.params["layers"].items()}
    _k2_reset()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, metrics = train_step(state, tcfg, None, tokens, mask, rewards,
                                gids, old_logp=old_logp,
                                num_groups=QLORA_PROMPTS,
                                accum_steps=QLORA_ACCUM, lora_base=params)
    m = {k: float(v) for k, v in metrics.items()}
    step_s = time.perf_counter() - t0
    k2 = _k2_count()
    out["k2"] = k2
    per = layers * QLORA_ACCUM
    want = {"fwd": 2 * per, "dkdv": per, "dq": per}
    if k2 != want:
        fail(f"qlora: K2 launches {k2} != {want}")
    bad = [k for k, v in m.items() if not np.isfinite(v)]
    if bad:
        fail(f"qlora: non-finite metrics {bad}")
    ratio_err = abs(m["ratio_mean"] - 1.0)
    if not ratio_err < RATIO_TOL:
        fail(f"qlora: first step |ratio_mean - 1| = {ratio_err} >= "
             f"{RATIO_TOL}")
    moved = max(float((state.params["layers"][k].float()
                       - v.float()).abs().max())
                for k, v in b_before.items() if k.endswith("_lora_b"))
    if not moved > 0:
        fail("qlora: the adapters did not move")
    if _base_sums(torch, params) != base_sum:
        fail("qlora: the int8 base changed")
    b, s = tokens.shape
    log(f"{stamp()} QLoRA GRPO step on the int8 base: {QLORA_PROMPTS} prompts "
        f"x {QLORA_GROUP} sampled completions of {QLORA_NEW} (rollout K1 "
        f"{roll_k1}), batch {b} x {s}, rank {QLORA_RANK} on wq/wk/wv/wo, "
        f"flash, remat, accum {QLORA_ACCUM}, lr {QLORA_LR}: {step_s:.3f} s, "
        f"peak max_memory_allocated {torch.cuda.max_memory_allocated()}; "
        f"|ratio_mean - 1| {ratio_err:.3g} (tol {RATIO_TOL}); max |dB| "
        f"{moved:.4g}, base bit for bit; K2 {k2} = expected; "
        + ", ".join(f"{k} {v:.6g}" for k, v in sorted(m.items())))

    # 9. fold, publish into the int8 engine, serve one more request
    folded = materialize_lora(params, state.params, tcfg)
    if folded["layers"]["wq"].dtype != torch.int8:
        fail("qlora: materialize_lora did not re-quantize the int8 base")
    eng.update_params(folded)
    if eng.stats()["weight_quant"] != 1:
        fail("qlora: the engine left int8 after the publish")
    k1_0 = _k1_count()
    rid = eng.submit(qp[0], max_new_tokens=16)
    eng.run()
    roll_k1 += _k1_count() - k1_0
    lp = eng.result_logps(rid)
    if len(lp) != 16 or not np.all(np.isfinite(lp)):
        fail("qlora: the request after the publish did not finish cleanly")
    steps = eng.stats()["decode_steps"]
    if roll_k1 != layers * steps:
        fail(f"qlora engine: K1 {roll_k1} != {layers} x {steps} fused steps")
    eng._alloc.check_leaks()
    out["k1"]["qlora"] = roll_k1
    out["k3_qlora"] = _k3_count() - k3_qlora
    log(f"{stamp()} materialize_lora re-quantized wq/wk/wv/wo, update_params "
        f"into the int8 engine, one more request of 16 tokens; the QLoRA "
        f"engine's K1 {roll_k1} = {layers} x {steps}; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    del eng, folded, state, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---- phase_parallel: two ranks on the one card ----------------------------

PAR_RANKS = 2
# (b) the train step: 4 x 1024, flash, remat, accum 2 (a microbatch of 2)
PAR_B, PAR_S, PAR_ACCUM = 4, 1024, 2
PAR_LR = 1e-5
# A bf16 forward and backward whose matmuls are split over tp (partial
# sums rounded to bf16 before the all-reduce) or whose rows are split
# over fsdp differs from the one-rank step by bf16 rounding through 28
# layers. Each gradient tensor (each layer's slice of a stacked one) is
# held to a relative RMS of PAR_GRAD_TOL: a reduction missing on one
# tensor leaves out one rank's part of it and reads about 0.5 or more.
# The loss is held to PAR_LOSS_RTOL: with the behaviour log-probs the
# step's own, the first step's ratio is 1 and the loss is the masked
# mean of the advantages over the global batch, a function of the data
# alone; its fp32 sum cancels to about 1/40 of its terms' magnitude, so
# summation order may move it by a few 1e-6 (a mean of per-rank means
# moves it by percents).
PAR_GRAD_TOL = 0.1
PAR_LOSS_RTOL = 1e-5
# (a) the one-rank NCCL mesh: full width, PAR_NCCL_LAYERS deep, 2 x 256
PAR_NCCL_LAYERS = 4
PAR_NCCL_B, PAR_NCCL_S = 2, 256
# (d) the TP engine: 8 slots, greedy, 8 requests of 128-1024 tokens
PAR_SLOTS, PAR_MAX_LEN = 8, 2048
PAR_PROMPT_LENS, PAR_REQUESTS, PAR_NEW = (128, 1024), 8, 32
# (e) sequence parallel: B x S at the 1.5B's heads; ring / Ulysses (fp32
# scores) against the one-rank flash path (K2, bf16): relative RMS of
# the output and of each gradient
PAR_SP_B, PAR_SP_S = 2, 4096
PAR_SP_RMS_TOL = 2e-2
# (f) expert parallel: one Qwen3-30B-A3B MoE layer, B x S tokens
PAR_MOE_B, PAR_MOE_S = 4, 512
# (f) the dp=2 moe_ffn's capacity factors: the config's, and one the
# random router's loads overflow (drops present)
PAR_MOE_DP_CAPACITY = (1.25, 1.0)
# (f) timed forward + backward reps of the dp=2 moe_ffn (after a warm-up)
PAR_MOE_DP_REPS = 3
# (g) pipeline stages: pp=2 over the (b) batch, GPipe and 1F1B
PAR_PP = 2
PAR_PP_GPIPE_M, PAR_PP_1F1B_M = 2, 4
PAR_COLLECTIVE_TIMEOUT_S = 300
PAR_TIMEOUT_S = 900


class _RankFail(Exception):
    """A check that failed on a rank (the parent prints it and fails)."""


def _rcheck(ok, msg):
    if not ok:
        raise _RankFail(msg)


def _par_cfg(**over):
    import dataclasses
    from senweaver_ide_tpu_torch.models import qwen2_5_coder_1_5b
    return dataclasses.replace(qwen2_5_coder_1_5b(), **over)


def _par_params(torch, cfg, seed):
    from senweaver_ide_tpu_torch.models import init_params
    return init_params(cfg, torch.Generator(device="cuda").manual_seed(seed),
                       device="cuda")


def _par_batch(cfg, seed, b, s):
    """A GRPO batch (host arrays): prompts of s/4..s/2 tokens, the rest
    completion, rewards spread, groups of two."""
    import numpy as np
    rng = np.random.default_rng(seed + 17)
    tokens = rng.integers(0, cfg.vocab_size, size=(b, s)).astype(np.int64)
    mask = np.zeros((b, s), bool)
    for i in range(b):
        mask[i, int(rng.integers(s // 4, s // 2)):] = True
    rewards = np.linspace(-1.0, 1.0, b).astype(np.float32)
    group_ids = (np.arange(b) // 2).astype(np.int64)
    return tokens, mask, rewards, group_ids


def _par_floats(metrics):
    return {k: float(v) for k, v in metrics.items()}


def _rel_rms(torch, got, want, base=None):
    """(sqrt(sum |got - want|^2) / sqrt(sum |want - base|^2) over two
    trees of the same paths, {tensor: the same ratio over that tensor})
    in fp32; a stacked layer tensor counts per layer (``layers/wq[3]``);
    ``base`` is subtracted from both first (an update)."""
    from senweaver_ide_tpu_torch.training.trainer import flatten_params
    num = den = 0.0
    each = {}
    bases = (dict(flatten_params(base)) if base is not None else {})
    for (name, a), (_, b) in zip(flatten_params(got), flatten_params(want)):
        a, b = a.float(), b.float()
        if name in bases:
            a = a - bases[name].float()
            b = b - bases[name].float()
        d2, b2 = (a - b).pow(2), b.pow(2)
        if name.startswith("layers/"):
            axes = tuple(range(1, a.ndim))
            for i, (n_i, w_i) in enumerate(zip(d2.sum(axes).tolist(),
                                               b2.sum(axes).tolist())):
                each[f"{name}[{i}]"] = (n_i / max(w_i, 1e-30)) ** 0.5
        else:
            each[name] = (float(d2.sum()) / max(float(b2.sum()),
                                                1e-30)) ** 0.5
        num += float(d2.sum())
        den += float(b2.sum())
    return (num / max(den, 1e-30)) ** 0.5, each


def _par_nccl_one(torch, seed, port):
    """(a) A one-rank NCCL process group and a one-rank mesh: its train
    step (flash, remat) bit-equal to the mesh=None step."""
    import torch.distributed as dist
    from senweaver_ide_tpu_torch.parallel import single_device_mesh
    from senweaver_ide_tpu_torch.parallel.distributed import shutdown
    from senweaver_ide_tpu_torch.training import (make_train_state,
                                                  place_batch_for_mesh,
                                                  train_step)
    from senweaver_ide_tpu_torch.training.trainer import (clone_params,
                                                          flatten_params)
    t0 = time.perf_counter()
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    cfg = _par_cfg(num_layers=PAR_NCCL_LAYERS, attn_impl="flash",
                   remat=True)
    params = _par_params(torch, cfg, seed)
    batch = _par_batch(cfg, seed, PAR_NCCL_B, PAR_NCCL_S)
    runs = []
    for mesh in (None, single_device_mesh()):
        st = make_train_state(cfg, mesh=mesh, params=clone_params(params),
                              learning_rate=PAR_LR)
        placed = place_batch_for_mesh(mesh, *batch, device="cuda")
        st, met = train_step(st, cfg, mesh, *placed[:4])
        runs.append((st, _par_floats(met)))
    (s0, m0), (s1, m1) = runs
    _rcheck(m0 == m1, f"(a) one-rank mesh metrics {m1} != mesh=None {m0}")
    for tree in ("params", "mu", "nu"):
        pick = ((lambda s: s.params) if tree == "params"
                else (lambda s, t=tree: getattr(s.opt_state, t)))
        for (n, a), (_, b) in zip(flatten_params(pick(s0)),
                                  flatten_params(pick(s1))):
            _rcheck(torch.equal(a, b),
                    f"(a) one-rank mesh {tree} {n} differs from mesh=None")
    x = torch.ones(4, device="cuda")
    dist.all_reduce(x)
    backend = dist.get_backend()
    shutdown()
    return {"backend": backend, "loss": m0["loss"],
            "layers": cfg.num_layers, "seconds": time.perf_counter() - t0}


def _par_train(torch, rank, seed):
    """(b) tp=2 and fsdp=2 train steps (flash, remat, accum 2) against the
    one-rank step on the same weights and batch: the gradient's relative
    RMS, the loss, the update's relative RMS (a figure), K2's launches."""
    import torch.distributed as dist
    from senweaver_ide_tpu_torch.parallel import (MeshConfig, gather_params,
                                                  make_mesh)
    from senweaver_ide_tpu_torch.training import (make_train_state,
                                                  place_batch_for_mesh)
    from senweaver_ide_tpu_torch.training.trainer import (
        apply_gradients, clone_params, grpo_gradients, make_optimizer,
        TrainState)
    cfg = _par_cfg(attn_impl="flash", remat=True)
    params = _par_params(torch, cfg, seed)
    batch = _par_batch(cfg, seed, PAR_B, PAR_S)
    ref = {}
    if rank == 0:
        placed = place_batch_for_mesh(None, *batch, accum_steps=PAR_ACCUM,
                                      device="cuda")
        t0 = time.perf_counter()
        grads, met = grpo_gradients(params, cfg, *placed[:4],
                                    accum_steps=PAR_ACCUM)
        opt = make_optimizer(PAR_LR)
        st = TrainState(params=clone_params(params),
                        opt_state=opt.init(params), opt=opt)
        st = apply_gradients(st, grads, met["grad_norm"])
        torch.cuda.synchronize()
        ref = {"grads": grads, "new": st.params, "metrics": _par_floats(met),
               "seconds": time.perf_counter() - t0}
        del st
        torch.cuda.empty_cache()
    dist.barrier()
    out = {"ref_metrics": ref.get("metrics"),
           "ref_seconds": ref.get("seconds")}
    layers = cfg.num_layers
    want = {"fwd": layers * PAR_ACCUM * 2, "dkdv": layers * PAR_ACCUM,
            "dq": layers * PAR_ACCUM}
    for name, mcfg in (("tp2", MeshConfig(tp=2)),
                       ("fsdp2", MeshConfig(fsdp=2))):
        mesh = make_mesh(mcfg)
        state = make_train_state(cfg, mesh=mesh, params=params,
                                 learning_rate=PAR_LR)
        placed = place_batch_for_mesh(mesh, *batch, accum_steps=PAR_ACCUM,
                                      device="cuda")
        torch.cuda.synchronize()
        _k2_reset()
        t0 = time.perf_counter()
        # the train step: its gradients, then the optimizer (train_step's
        # two halves, the gradients kept for the comparison)
        grads, met = grpo_gradients(state.params, cfg, *placed[:4],
                                    accum_steps=PAR_ACCUM, mesh=mesh)
        state = apply_gradients(state, grads, met["grad_norm"])
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        k2 = _k2_count()
        _rcheck(k2 == want, f"(b) {name}: K2 launches {k2} != {want} "
                f"(layers x accum x (2 under remat, 1, 1))")
        full_g = gather_params(grads, mesh)
        full_p = gather_params(state.params, mesh)
        row = {"metrics": _par_floats(met), "k2": k2, "step_s": step_s,
               "local_wq": list(state.params["layers"]["wq"].shape)}
        if rank == 0:
            row["grad_rel_rms"], each = _rel_rms(torch, full_g, ref["grads"])
            row["grad_worst"] = sorted(each.items(), key=lambda kv: -kv[1])[:4]
            row["update_rel_rms"] = _rel_rms(torch, full_p, ref["new"],
                                             base=params)[0]
            row["loss_rel"] = abs(row["metrics"]["loss"]
                                  - ref["metrics"]["loss"]) / max(
                abs(ref["metrics"]["loss"]), 1e-12)
            _rcheck(row["grad_worst"][0][1] <= PAR_GRAD_TOL,
                    f"(b) {name}: gradient relative RMS per tensor, the "
                    f"worst {row['grad_worst']} > {PAR_GRAD_TOL} (over "
                    f"every tensor {row['grad_rel_rms']:.4g})")
            _rcheck(row["loss_rel"] <= PAR_LOSS_RTOL,
                    f"(b) {name}: loss {row['metrics']['loss']} vs one rank "
                    f"{ref['metrics']['loss']}")
        out[name] = row
        del state, grads, full_g, full_p
        torch.cuda.empty_cache()
    out["pp"] = _par_pp(torch, rank, cfg, params, batch, ref)
    return out


def _pp_full(grads, mesh):
    """A tree of pipeline stages' tensors, gathered over pp and unsplit:
    (L, ...) layer tensors."""
    from senweaver_ide_tpu_torch.parallel.pipeline import \
        gather_pipeline_params
    full = gather_pipeline_params(grads, mesh)
    full["layers"] = {n: v.reshape((-1,) + tuple(v.shape[2:]))
                      for n, v in full["layers"].items()}
    return full


def _stage_view(tree, layers):
    """``tree`` with its layer tensors replaced by ``layers(tensor)``."""
    return dict(tree, layers={n: layers(v) for n, v in tree["layers"].items()})


def _stage_rel_rms(torch, got, want, first):
    """``_rel_rms`` of one stage's trees (layers (L/K, ...), the
    replicated tensors whole); per-layer names carry the global layer
    index, ``first`` being the stage's first layer. Returns (pooled, the
    four worst tensors)."""
    import re
    pooled, each = _rel_rms(torch, got, want)
    named = {}
    for k, v in each.items():
        m = re.fullmatch(r"(layers/.+)\[(\d+)\]", k)
        named[f"{m[1]}[{int(m[2]) + first}]" if m else k] = v
    return pooled, sorted(named.items(), key=lambda kv: -kv[1])[:4]


def _par_pp(torch, rank, cfg, params, batch, ref):
    """(g) pp=2 on the (b) weights and batch: one GPipe step at M=2 and
    one 1F1B step at M=4 (gradients, then the optimizer). Each rank holds
    its own stage's gradients (and the replicated ones) to the one-rank
    step's and 1F1B's to GPipe's, with no gather; K2's launches, step
    seconds, bytes a tick, the send route and peak memory per
    schedule."""
    import torch.distributed as dist
    from senweaver_ide_tpu_torch.parallel import make_named_mesh
    from senweaver_ide_tpu_torch.parallel.comm import ROUTES
    from senweaver_ide_tpu_torch.parallel.pipeline import (
        place_pipeline_params, pp_gradients, split_layers_for_stages)
    from senweaver_ide_tpu_torch.training import place_batch_for_mesh
    from senweaver_ide_tpu_torch.training.trainer import (TrainState,
                                                          clone_params,
                                                          grpo_gradients,
                                                          make_optimizer)
    mesh = make_named_mesh({"pp": PAR_PP})
    stage = mesh.coord("pp")
    per = cfg.num_layers // PAR_PP
    ref_s = None
    if rank == 0:
        want = ref["grads"]
    else:
        # this rank's copy of the one-rank step's gradients: the same
        # deterministic computation as rank 0's (a recompute on the card
        # rather than its stage's half, ~1.8 GB, sent over gloo, which
        # stages CUDA tensors through the host)
        t0 = time.perf_counter()
        placed = place_batch_for_mesh(None, *batch, accum_steps=PAR_ACCUM,
                                      device="cuda")
        want, _ = grpo_gradients(params, cfg, *placed[:4],
                                 accum_steps=PAR_ACCUM)
        torch.cuda.synchronize()
        ref_s = time.perf_counter() - t0
    want = _stage_view(want, lambda v: v[stage * per:(stage + 1) * per])
    staged = place_pipeline_params(split_layers_for_stages(params, PAR_PP),
                                   mesh)
    out, kept = {}, {}
    for schedule, m in (("gpipe", PAR_PP_GPIPE_M), ("1f1b", PAR_PP_1F1B_M)):
        opt = make_optimizer(PAR_LR)
        state = TrainState(params=clone_params(staged),
                           opt_state=opt.init(staged), opt=opt)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _k2_reset()
        dist.barrier()
        t0 = time.perf_counter()
        grads, met = pp_gradients(state.params, cfg, mesh, *batch,
                                  n_microbatches=m, schedule=schedule)
        opt.update(grads, state.opt_state, state.params, met["grad_norm"])
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        k2 = _k2_count()
        fwd = per * m * (2 if schedule == "gpipe" or stage < PAR_PP - 1
                         else 1)
        k2_want = {"fwd": fwd, "dkdv": per * m, "dq": per * m}
        _rcheck(k2 == k2_want, f"(g) {schedule} stage {stage}: K2 launches "
                f"{k2} != {k2_want}")
        mb, s = PAR_B // m, PAR_S - 1
        row = {"metrics": _par_floats(met), "k2": k2, "step_s": step_s,
               "microbatches": m,
               "ticks": m + PAR_PP - 1 if schedule == "gpipe"
               else m + 2 * PAR_PP - 1,
               "tick_bytes": (1 if schedule == "gpipe" else 2) * mb * s
               * cfg.hidden_size * 2,
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
               "route": ROUTES.get("gloo/cuda/send_recv")}
        kept[schedule] = _stage_view(grads, lambda v: v[0])
        row["grad_rel_rms"], row["grad_worst"] = _stage_rel_rms(
            torch, kept[schedule], want, stage * per)
        _rcheck(row["grad_worst"][0][1] <= PAR_GRAD_TOL,
                f"(g) {schedule} stage {stage}: gradient relative RMS per "
                f"tensor, the worst {row['grad_worst']} > {PAR_GRAD_TOL}")
        if rank == 0:
            row["loss_rel"] = abs(row["metrics"]["loss"]
                                  - ref["metrics"]["loss"]) / max(
                abs(ref["metrics"]["loss"]), 1e-12)
            _rcheck(row["loss_rel"] <= PAR_LOSS_RTOL,
                    f"(g) {schedule}: loss {row['metrics']['loss']} vs one "
                    f"rank {ref['metrics']['loss']}")
        del state, grads
        out[schedule] = row
        torch.cuda.empty_cache()
    pooled, worst = _stage_rel_rms(torch, kept["1f1b"], kept["gpipe"],
                                   stage * per)
    lrel = abs(out["1f1b"]["metrics"]["loss"]
               - out["gpipe"]["metrics"]["loss"]) / max(
        abs(out["gpipe"]["metrics"]["loss"]), 1e-12)
    _rcheck(worst[0][1] <= PAR_GRAD_TOL and lrel <= PAR_LOSS_RTOL,
            f"(g) 1f1b vs gpipe, stage {stage}: gradient worst {worst}, "
            f"loss rel {lrel}")
    out["1f1b_vs_gpipe"] = {"grad_rel_rms": pooled, "grad_worst": worst,
                            "loss_rel": lrel}
    out["ref_recompute_s"] = ref_s
    del staged, kept, want
    torch.cuda.empty_cache()
    return out


def _par_engine(torch, rank, seed, tie_atol):
    """(d) A tp=2 slot engine serving PAR_REQUESTS greedy requests, K3 at
    its local heads; rank 0 runs a one-rank slot engine and holds every
    stream by teacher forcing."""
    import numpy as np
    from senweaver_ide_tpu_torch.ops.flash_decode import flash_decode
    from senweaver_ide_tpu_torch.parallel import make_named_mesh
    from senweaver_ide_tpu_torch.rollout import (EngineConfig,
                                                 RolloutEngine,
                                                 SampleParams)
    cfg = _par_cfg(decode_attn_impl="flash")
    params = _par_params(torch, cfg, seed)
    rng = np.random.default_rng(seed + 5)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).tolist()
               for n in np.linspace(*PAR_PROMPT_LENS, PAR_REQUESTS)]
    mesh = make_named_mesh({"tp": 2})
    greedy = SampleParams(0.0, 0, 1.0)
    eng = RolloutEngine(params, cfg, num_slots=PAR_SLOTS,
                        max_len=PAR_MAX_LEN, sample=greedy, mesh=mesh)
    _rcheck(eng.kv_layout_fallback == "tensor-parallel KV sharding",
            f"(d) layout {eng.kv_layout} ({eng.kv_layout_fallback})")
    heads = int(eng.cache.k.shape[3])
    _rcheck(heads == cfg.num_kv_heads // 2, f"(d) {heads} KV heads a rank")
    torch.cuda.synchronize()
    flash_decode.launches = 0
    torch.distributed.barrier()
    t0 = time.perf_counter()
    rids = [eng.submit(p, max_new_tokens=PAR_NEW) for p in prompts]
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k3 = flash_decode.launches
    steps = eng.stats()["decode_steps"]
    _rcheck(k3 == cfg.num_layers * steps,
            f"(d) K3 launches {k3} != layers x decode steps "
            f"{cfg.num_layers} x {steps}")
    streams = [eng.result(r) for r in rids]
    out = {"streams": streams, "k3": k3, "decode_steps": steps,
           "wall_s": wall, "tokens": sum(len(s) for s in streams),
           "cache_heads": heads}
    del eng
    torch.cuda.empty_cache()
    if rank == 0:
        one = RolloutEngine(params, cfg, num_slots=PAR_SLOTS,
                            max_len=PAR_MAX_LEN, sample=greedy,
                            engine_config=EngineConfig(kv_layout="slots"))
        t0 = time.perf_counter()
        rids = [one.submit(p, max_new_tokens=PAR_NEW) for p in prompts]
        one.run()
        torch.cuda.synchronize()
        out["one_wall_s"] = time.perf_counter() - t0
        ref = [one.result(r) for r in rids]
        del one
        out["held_tp"] = _teacher_forced(torch, params, cfg, prompts,
                                         streams, tie_atol, "(d) tp engine",
                                         ref=ref)
        out["held_one"] = _teacher_forced(torch, params, cfg, prompts, ref,
                                          tie_atol, "(d) one-rank engine")
        out["equal_streams"] = sum(a == b for a, b in zip(streams, ref))
    return out


def _par_seq(torch, rank, seed):
    """(e) Ring and Ulysses attention at sp=2 against the one-rank flash
    path (rank 0), forward and the gradients of sum(out * dO)."""
    from senweaver_ide_tpu_torch.ops.flash_attention import flash_attention
    from senweaver_ide_tpu_torch.parallel import (MeshConfig, make_mesh,
                                                  ring_attention,
                                                  ulysses_attention)
    from senweaver_ide_tpu_torch.parallel.comm import all_gather
    cfg = _par_cfg()
    hq, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    b, s = PAR_SP_B, PAR_SP_S
    g = torch.Generator(device="cuda").manual_seed(seed + 21)

    def rnd(h):
        return torch.randn(b, s, h, d, generator=g,
                           device="cuda").bfloat16()
    q, k, v, dout = rnd(hq), rnd(hkv), rnd(hkv), rnd(hq)
    mesh = make_mesh(MeshConfig(sp=2))
    c, n = mesh.coord("sp"), s // 2
    ref = None
    if rank == 0:
        qr, kr, vr = (x.clone().requires_grad_() for x in (q, k, v))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        o = flash_attention(qr, kr, vr, causal=True)
        o.backward(dout)
        torch.cuda.synchronize()
        ref = {"out": o.detach(), "dq": qr.grad, "dk": kr.grad,
               "dv": vr.grad, "ms": (time.perf_counter() - t0) * 1e3}
    torch.distributed.barrier()       # both ranks start the timers together
    out = {"flash_ms": ref["ms"] if ref else None}
    for kind, fn in (("ring", ring_attention), ("ulysses", ulysses_attention)):
        ql, kl, vl = (x[:, c * n:(c + 1) * n].clone().requires_grad_()
                      for x in (q, k, v))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        o = fn(ql, kl, vl, mesh=mesh)
        o.backward(dout[:, c * n:(c + 1) * n])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        got = {name: all_gather(t.detach(), mesh, "sp", 1)
               for name, t in (("out", o), ("dq", ql.grad), ("dk", kl.grad),
                               ("dv", vl.grad))}
        row = {"ms": ms}
        if rank == 0:
            for name, t in got.items():
                r = ref[name].float()
                e = float((t.float() - r).pow(2).mean().sqrt()
                          / r.pow(2).mean().sqrt())
                row[name] = e
                _rcheck(e <= PAR_SP_RMS_TOL,
                        f"(e) {kind} {name}: relative RMS {e:.4g} vs the "
                        f"one-rank flash path > {PAR_SP_RMS_TOL}")
        out[kind] = row
    return out


def _par_moe(torch, rank, seed):
    """(f) moe_ffn_sharded at ep=2 on one Qwen3-30B-A3B layer against
    moe_ffn on this rank's rows, at capacity 1.25 and dropless (E/k)."""
    import dataclasses
    from senweaver_ide_tpu_torch.models.config import qwen3_30b_a3b
    from senweaver_ide_tpu_torch.parallel import (MoEConfig, init_moe_params,
                                                  make_named_mesh, moe_ffn,
                                                  moe_ffn_sharded)
    from senweaver_ide_tpu_torch.parallel.comm import all_reduce
    mc = qwen3_30b_a3b()
    base = MoEConfig(hidden_size=mc.hidden_size,
                     intermediate_size=mc.intermediate_size,
                     num_experts=mc.num_experts,
                     top_k=mc.num_experts_per_tok, dtype=torch.bfloat16)
    g = torch.Generator(device="cuda").manual_seed(seed + 31)
    params = init_moe_params(base, g, device="cuda")
    x = torch.randn(PAR_MOE_B, PAR_MOE_S, mc.hidden_size, generator=g,
                    device="cuda").bfloat16()
    mesh = make_named_mesh({"ep": 2})
    c, n = mesh.coord("ep"), PAR_MOE_B // 2
    xl = x[c * n:(c + 1) * n]
    out = {}
    for label, cf in (("capacity 1.25", 1.25),
                      ("dropless", base.num_experts / base.top_k)):
        cfg = dataclasses.replace(base, capacity_factor=cf)
        torch.cuda.synchronize()
        torch.distributed.barrier()
        t0 = time.perf_counter()
        y, aux = moe_ffn_sharded(params, cfg, xl, mesh=mesh)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        ref, ref_aux = moe_ffn(params, cfg, xl)
        torch.cuda.synchronize()
        dense_ms = (time.perf_counter() - t0) * 1e3
        diff = (y.float() - ref.float()).abs()
        e = float(diff.max())
        _rcheck(bool((diff <= MOE_LAYER_ATOL
                      + MOE_LAYER_RTOL * ref.float().abs()).all()),
                f"(f) {label}: moe_ffn_sharded vs moe_ffn max err {e}")
        mean_aux = float(all_reduce(ref_aux.float(), mesh, "ep")) / 2
        _rcheck(abs(float(aux) - mean_aux) <= 1e-5 * max(1.0, mean_aux),
                f"(f) {label}: aux {float(aux)} != the mean over ep "
                f"{mean_aux}")
        out[label] = {"max_abs_err": e, "ms": ms, "dense_ms": dense_ms,
                      "aux": float(aux)}
    out["dp2"] = _par_moe_dp(torch, params, base, x)
    return out


def _par_moe_dp(torch, params, base, x):
    """(f) moe_ffn on a dp=2 mesh, each rank its rows, against one rank's
    moe_ffn over the whole batch: the outputs of its rows, the dropped
    assignments and the aux loss (the routing of the global batch), at
    capacity 1.25 and at 1.0 (the random router's loads overflow it)."""
    import dataclasses
    from senweaver_ide_tpu_torch.parallel import make_named_mesh, moe_ffn
    from senweaver_ide_tpu_torch.parallel import expert
    from senweaver_ide_tpu_torch.parallel.comm import all_reduce
    mesh = make_named_mesh({"dp": 2})
    c, n = mesh.coord("dp"), PAR_MOE_B // 2
    xl = x[c * n:(c + 1) * n]
    d, t = x.shape[-1], n * PAR_MOE_S
    out = {}
    for cf in PAR_MOE_DP_CAPACITY:
        cfg = dataclasses.replace(base, capacity_factor=cf)
        cap = expert._capacity(cfg, PAR_MOE_B * PAR_MOE_S)
        torch.cuda.synchronize()
        torch.distributed.barrier()
        t0 = time.perf_counter()
        y, aux = moe_ffn(params, cfg, xl, mesh=mesh)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        ref, ref_aux = moe_ffn(params, cfg, x)
        mine = expert._route(cfg, params["router"], xl.reshape(-1, d), cap,
                             mesh, rows=n)
        one = expert._route(cfg, params["router"], x.reshape(-1, d), cap)
        dropped = int(all_reduce((~mine.keep).sum(), mesh, "dp"))
        one_dropped = int((~one.keep).sum())
        picks = int((mine.expert_idx
                     != one.expert_idx[c * t:(c + 1) * t]).any(-1).sum())
        want = ref[c * n:(c + 1) * n].float()
        diff = (y.float() - want).abs()
        e = float(diff.max())
        _rcheck(bool((diff <= MOE_LAYER_ATOL + MOE_LAYER_RTOL
                      * want.abs()).all()),
                f"(f) dp=2 moe_ffn at capacity {cf} vs one rank's moe_ffn "
                f"over the batch: max err {e} ({picks} of this rank's "
                f"tokens picked other experts)")
        _rcheck(dropped == one_dropped,
                f"(f) dp=2 at capacity {cf}: dropped {dropped} != one "
                f"rank's {one_dropped}")
        _rcheck(abs(float(aux) - float(ref_aux))
                <= 1e-5 * max(1.0, abs(float(ref_aux))),
                f"(f) dp=2 at capacity {cf}: aux {float(aux)} != one "
                f"rank's {float(ref_aux)}")
        out[cf] = {"max_abs_err": e, "ms": ms, "dropped": dropped,
                   "one_dropped": one_dropped, "capacity": cap,
                   "aux": float(aux), "one_aux": float(ref_aux),
                   "other_picks": picks}
    out["train_ms"] = _moe_dp_train_ms(
        torch, params, dataclasses.replace(
            base, capacity_factor=PAR_MOE_DP_CAPACITY[0]), xl, mesh)
    return out


def _moe_dp_train_ms(torch, params, cfg, xl, mesh):
    """(f) one MoE layer's forward and backward on a dp=2 rank, ms (the
    median of PAR_MOE_DP_REPS after a warm-up; both ranks share the
    card): routed as the global batch (the buffer at the capacity of all
    4 rows, every rank running every expert over it) and as this rank's
    2 rows alone (``rows_split=False``: its own capacity, half the
    buffer; how a rank routed before the routing became global)."""
    from senweaver_ide_tpu_torch.parallel import moe_ffn
    live = {k: v.detach().requires_grad_() for k, v in params.items()}
    x = xl.detach().requires_grad_()
    out = {}
    for label, split in (("global", True), ("local", False)):
        times = []
        for _ in range(PAR_MOE_DP_REPS + 1):
            for t in list(live.values()) + [x]:
                t.grad = None
            torch.cuda.synchronize()
            torch.distributed.barrier()
            t0 = time.perf_counter()
            y, aux = moe_ffn(live, cfg, x, mesh=mesh, rows_split=split)
            (y.float().square().mean() + aux).backward()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        times = sorted(times[1:])
        out[label] = times[len(times) // 2]
    del live, x
    return out


def _par_rank(rank, port, nccl_port, seed, tie_atol, conn):
    """One rank of phase_parallel: (a) on rank 0 first, then both ranks on
    one gloo group over CUDA tensors (named explicitly), (b), (d), (e),
    (f). Sends ("ok", results) or ("err", traceback) to the parent."""
    import traceback
    try:
        here = os.path.dirname(os.path.abspath(__file__))
        sys.path.insert(0, here)
        import datetime

        import torch
        import torch.distributed as dist
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        out = {}
        if rank == 0:
            out["a"] = _par_nccl_one(torch, seed, nccl_port)
            conn.send(("part", "a", out["a"]))
        dist.init_process_group(
            "gloo", init_method=f"tcp://127.0.0.1:{port}",
            world_size=PAR_RANKS, rank=rank,
            timeout=datetime.timedelta(seconds=PAR_COLLECTIVE_TIMEOUT_S))
        for key, fn, args in (("b", _par_train, ()),
                              ("d", _par_engine, (tie_atol,)),
                              ("e", _par_seq, ()), ("f", _par_moe, ())):
            t0 = time.perf_counter()
            out[key] = fn(torch, rank, seed, *args)
            out[key + "_s"] = time.perf_counter() - t0
            torch.cuda.empty_cache()
            conn.send(("part", key, {k: v for k, v in out[key].items()
                                     if k not in ("streams",)}))
        from senweaver_ide_tpu_torch.parallel.comm import ROUTES
        out["routes"] = dict(ROUTES)
        out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        dist.destroy_process_group()
        conn.send(("ok", out))
    except BaseException:           # fail() exits: report, then go on
        conn.send(("err", traceback.format_exc()))
        raise


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_kernel_tp(torch, cfg, timer):
    """(c) K2 (forward, dK/dV, dQ) and K3 at one tp=2 rank's heads of
    qwen2.5-coder-1.5b (6/1, D 128, bf16) against their plain versions,
    then timed beside their bounds (and SDPA, a yardstick)."""
    import dataclasses
    from senweaver_ide_tpu_torch.models.transformer import tp_local_config
    from senweaver_ide_tpu_torch.ops import flash_attention as fa
    from senweaver_ide_tpu_torch.ops.flash_decode import split_plan
    lc = tp_local_config(cfg, 2)
    hq, hkv, d = lc.num_heads, lc.num_kv_heads, lc.head_dim
    g = torch.Generator(device="cuda").manual_seed(9)
    names = ("out", "lse", "dq", "dk", "dv")
    worst = dict.fromkeys(names, 0.0)
    b, s = PAR_B // PAR_ACCUM, PAR_S - 1      # one rank's microbatch
    for label, spec in ((f"causal B={b} S={s}", dict(b=b, s=s)),
                        ("ragged B=2 S=1000 kv_mask",
                         dict(b=2, s=1000, pad_from=[1000, 611]))):
        args = _fa_case(torch, fa, g, hq=hq, hkv=hkv, d=d, **spec)
        got = _fa_run(fa, *args)
        again = _fa_run(fa, *args)
        torch.cuda.synchronize()
        for name, a, a2 in zip(names, got, again):
            if not torch.equal(a, a2):
                fail(f"flash tp heads {label}: {name} differs between two "
                     f"launches")
        ref = _fa_plain(fa, *args)
        errs = []
        for name, a, r in zip(names, got, ref):
            e, ok = _fa_err(a, r, *FA_TOL[name])
            if not ok:
                fail(f"flash tp heads {label}: {name} kernel vs plain max "
                     f"err {e} (tol {_fa_tol_text(FA_TOL[name])})")
            worst[name] = max(worst[name], e)
            errs.append(f"{name} {e:.3g}")
        log(f"[parallel] (c) K2 at heads {hq}/{hkv} D={d} {label}: max "
            f"|kernel - plain| " + ", ".join(errs) + "; two launches "
            f"bit-identical")
    q, k, v, gout, bias, kw = _fa_case(torch, fa, g, b, s, hq, hkv, d)
    o, lse = fa.flash_attention_fwd(q, k, v, bias, **kw)
    delta = fa._delta(gout, o)
    t = {"fwd": timer.ms(lambda: fa.flash_attention_fwd(q, k, v, **kw)),
         "dkdv": timer.ms(lambda: fa.flash_attention_bwd_dkdv(
             q, k, v, None, gout, lse, delta, **kw)),
         "dq": timer.ms(lambda: fa.flash_attention_bwd_dq(
             q, k, v, None, gout, lse, delta, **kw)),
         "plain_fwd": timer.ms(lambda: fa.flash_attention_fwd_plain(
             q, k, v, **kw), iters=10),
         "plain_bwd": timer.ms(lambda: fa._bwd_plain(
             q, k, v, None, gout, lse, delta, **kw), iters=5)}
    _sdpa_times(torch, timer, q, k, v, gout, t)
    k2 = {}
    for kname, (flops, nbytes) in _fa_work(b, s, hq, hkv, d).items():
        ops_ms = flops / BF16_FLOPS * 1e3
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        bound = max(ops_ms, bytes_ms)
        lib = t["sdpa_fwd"] if kname == "fwd" else t["sdpa_bwd"]
        plain = t["plain_fwd"] if kname == "fwd" else t["plain_bwd"]
        k2[kname] = {"shape": f"q ({b},{s},{hq},{d}) k/v ({b},{s},{hkv},"
                              f"{d}) bf16 causal",
                     "max_abs_err": max(worst[n] for n in FA_ERR_OF[kname]),
                     "ms": t[kname], "plain_ms": plain, "bound_ms": bound,
                     "bound_by": ("operations" if ops_ms >= bytes_ms
                                  else "bytes"),
                     "flops": flops, "bytes": nbytes, "library_ms": lib}
        log(f"[parallel] (c) K2 {kname} at B={b} S={s} heads {hq}/{hkv}: "
            f"kernel {t[kname]:.4f} ms, {bound / t[kname]:.3f} of the bound "
            f"{bound:.4f} ms; plain {plain:.4f} ms; SDPA (yardstick) "
            f"{lib:.4f} ms")
    # K3 at the TP engine's local heads: ragged lengths with 0 and the
    # split plan's edges, then timed at the engine's 8 slots x 2048
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    smax = PAR_MAX_LEN
    _, chunk = split_plan(PAR_SLOTS, hkv, smax, sms)
    lens = [0, 1, 129, chunk - 1, chunk, chunk + 1, smax - 1, smax]
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    qd = torch.randn(len(lens), hq, d, generator=g, device="cuda").bfloat16()
    kc = torch.randn(len(lens), smax, hkv, d, generator=g,
                     device="cuda").bfloat16()
    vc = torch.randn(len(lens), smax, hkv, d, generator=g,
                     device="cuda").bfloat16()
    e3 = _fd_check(torch, "tp heads", qd, kc, vc, lengths, FD_TOL["bf16"])
    log(f"[parallel] (c) K3 at heads {hq}/{hkv} D={d} bf16 Smax={smax}, "
        f"lengths {lens}: max |kernel - plain| {e3:.3g}; poisoned tail and a "
        f"second launch bit-identical")
    FD_HEADS["qwen2.5-coder-1.5b tp=2"] = (hq, hkv, d)
    row = _fd_time(torch, timer, g, dict(
        b=PAR_SLOTS, smax=smax, heads="qwen2.5-coder-1.5b tp=2",
        lo=PAR_PROMPT_LENS[0], hi=PAR_PROMPT_LENS[1] + PAR_NEW), sms)
    row["max_abs_err"] = max(row["max_abs_err"], e3)
    return {"k2": k2, "k3": row}


def phase_parallel(torch, cfg, seed, smi, tie_atol, timer):
    """Two ranks on the one card (gloo on CUDA tensors, named; NCCL for
    the one-rank check): (a) a one-rank NCCL mesh's step bit-equal to
    mesh=None; (b) tp=2 and fsdp=2 train steps against the one-rank step;
    (c) K2 and K3 at the local heads; (d) a tp=2 engine; (e) ring and
    Ulysses at sp=2; (f) moe_ffn_sharded at ep=2."""
    import multiprocessing as mp
    t_phase = time.perf_counter()
    kern = phase_kernel_tp(torch, cfg, timer)
    gc.collect()
    torch.cuda.empty_cache()
    ctx = mp.get_context("spawn")
    port, nccl_port = _free_port(), _free_port()
    conns, procs = [], []
    for r in range(PAR_RANKS):
        parent, child = ctx.Pipe()
        p = ctx.Process(target=_par_rank,
                        args=(r, port, nccl_port, seed, tie_atol, child),
                        daemon=True)
        p.start()
        conns.append(parent)
        procs.append(p)
    results, errors = [], []
    deadline = time.perf_counter() + PAR_TIMEOUT_S
    try:
        for r, c in enumerate(conns):
            got = None
            while got is None and time.perf_counter() < deadline:
                if c.poll(1.0):
                    got = c.recv()
                    if got[0] == "part":
                        # a finished check's figures, printed as they come
                        log(f"[parallel] rank {r} ({got[1]}) done: "
                            f"{str(got[2])[:1500]}")
                        got = None
                elif not procs[r].is_alive():
                    got = ("err", f"rank {r} exited with code "
                                  f"{procs[r].exitcode}")
            if got is None:
                got = ("err", f"rank {r} timed out after {PAR_TIMEOUT_S} s")
            if got[0] != "ok":
                errors.append(f"--- rank {r} ---\n{got[1]}")
                break
            results.append(got[1])
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    if errors:
        fail("parallel: " + "\n".join(errors))
    # the ranks are gone and the card holds this process's memory alone
    # before the next phases load their weights
    alive = [r for r, p in enumerate(procs) if p.is_alive()]
    if alive:
        fail(f"parallel: ranks {alive} still running after the phase")
    free, total = torch.cuda.mem_get_info()
    log(f"[parallel] ranks exited (codes {[p.exitcode for p in procs]}); "
        f"card memory in use {(total - free) / 1e9:.2f} GB, this process "
        f"reserved {torch.cuda.memory_reserved() / 1e9:.2f} GB")
    r0, r1 = results
    a = r0["a"]
    log(f"[parallel] (a) one-rank {a['backend']} mesh, {a['layers']} layers "
        f"at full width, {PAR_NCCL_B} x {PAR_NCCL_S}, flash + remat: train "
        f"step bit-equal to mesh=None (loss, metrics, params, both moments); "
        f"{a['seconds']:.1f} s")
    b0, b1 = r0["b"], r1["b"]
    log(f"[parallel] (b) one-rank step {PAR_B} x {PAR_S}, accum {PAR_ACCUM}, "
        f"flash + remat: loss {b0['ref_metrics']['loss']:.6f}, grad_norm "
        f"{b0['ref_metrics']['grad_norm']:.4f}, {b0['ref_seconds']:.2f} s")
    for name in ("tp2", "fsdp2"):
        if b0[name]["metrics"] != b1[name]["metrics"]:
            fail(f"parallel (b) {name}: the ranks' metrics differ")
        row = b0[name]
        log(f"[parallel] (b) {name}: local wq {row['local_wq']}, loss "
            f"{row['metrics']['loss']:.6f} (rel {row['loss_rel']:.3g}, tol "
            f"{PAR_LOSS_RTOL}), "
            f"grad_norm {row['metrics']['grad_norm']:.4f}, gradient relative"
            f" RMS per tensor at most {row['grad_worst'][0][1]:.4g} (tol "
            f"{PAR_GRAD_TOL}; the worst "
            + ", ".join(f"{n} {v:.4g}" for n, v in row["grad_worst"])
            + f"), over every tensor {row['grad_rel_rms']:.4g}, update "
            f"relative RMS {row['update_rel_rms']:.4g} (a figure: Adam's "
            f"first step is sign-like), step {row['step_s']:.2f} / "
            f"{b1[name]['step_s']:.2f} s (rank 0 / 1), K2 {row['k2']} a rank")
    d0, d1 = r0["d"], r1["d"]
    if d0["streams"] != d1["streams"]:
        fail("parallel (d): the ranks' streams differ")
    log(f"[parallel] (d) tp=2 engine ({PAR_SLOTS} slots, greedy, "
        f"{d0['cache_heads']} KV head a rank, decode_attn_impl=flash): "
        f"{PAR_REQUESTS} requests of {PAR_PROMPT_LENS[0]}-"
        f"{PAR_PROMPT_LENS[1]} tokens, {PAR_NEW} new: {d0['tokens']} tokens "
        f"in {d0['wall_s']:.2f} s ({d0['tokens'] / d0['wall_s']:.1f} tok/s; "
        f"one rank {d0['one_wall_s']:.2f} s); K3 {d0['k3']} = "
        f"{cfg.num_layers} x {d0['decode_steps']} decode steps a rank; "
        f"{d0['equal_streams']} of {PAR_REQUESTS} streams equal the one-rank "
        f"engine's")
    _log_held("parallel", {"tp=2 engine": d0["held_tp"],
                           "one-rank engine": d0["held_one"]}, tie_atol)
    e0 = r0["e"]
    for kind in ("ring", "ulysses"):
        row = e0[kind]
        log(f"[parallel] (e) {kind} sp=2, B={PAR_SP_B} S={PAR_SP_S} heads "
            f"{cfg.num_heads}/{cfg.num_kv_heads} bf16: relative RMS vs the "
            f"one-rank flash path out {row['out']:.3g}, dq {row['dq']:.3g}, "
            f"dk {row['dk']:.3g}, dv {row['dv']:.3g} (tol {PAR_SP_RMS_TOL}); "
            f"fwd+bwd {row['ms']:.1f} / {r1['e'][kind]['ms']:.1f} ms (rank 0 "
            f"/ 1) against flash's {e0['flash_ms']:.1f} ms on one rank")
    for label in ("capacity 1.25", "dropless"):
        f0, f1 = r0["f"][label], r1["f"][label]
        log(f"[parallel] (f) ep=2 Qwen3-30B-A3B layer {label}, "
            f"{PAR_MOE_B} x {PAR_MOE_S} tokens: max |sharded - moe_ffn| "
            f"{max(f0['max_abs_err'], f1['max_abs_err']):.3g} (tol "
            f"{MOE_LAYER_ATOL} + {MOE_LAYER_RTOL} * |dense|), aux "
            f"{f0['aux']:.4f}; {f0['ms']:.1f} / {f1['ms']:.1f} ms against "
            f"moe_ffn's {f0['dense_ms']:.1f} / {f1['dense_ms']:.1f} ms on the "
            f"same rows")
    for cf in PAR_MOE_DP_CAPACITY:
        f0, f1 = r0["f"]["dp2"][cf], r1["f"]["dp2"][cf]
        log(f"[parallel] (f) dp=2 moe_ffn, {PAR_MOE_B // 2} rows a rank, "
            f"capacity {cf} ({f0['capacity']} slots over the global "
            f"{PAR_MOE_B} x {PAR_MOE_S}): max |dp=2 - one rank over the "
            f"batch| {max(f0['max_abs_err'], f1['max_abs_err']):.3g}, "
            f"dropped {f0['dropped']} = {f0['one_dropped']}, aux "
            f"{f0['aux']:.6f} / {f0['one_aux']:.6f}; tokens picking other "
            f"experts {f0['other_picks']} / {f1['other_picks']}; "
            f"{f0['ms']:.1f} / {f1['ms']:.1f} ms (rank 0 / 1)")
    t0_, t1_ = r0["f"]["dp2"]["train_ms"], r1["f"]["dp2"]["train_ms"]
    log(f"[parallel] (f) dp=2 moe_ffn forward + backward a rank at capacity "
        f"{PAR_MOE_DP_CAPACITY[0]} (median of {PAR_MOE_DP_REPS}, both ranks "
        f"on the card): routed as the global batch {t0_['global']:.2f} / "
        f"{t1_['global']:.2f} ms, as the rank's rows alone "
        f"{t0_['local']:.2f} / {t1_['local']:.2f} ms (rank 0 / 1)")
    g0, g1 = r0["b"]["pp"], r1["b"]["pp"]
    for schedule in ("gpipe", "1f1b"):
        a, b_ = g0[schedule], g1[schedule]
        if a["metrics"] != b_["metrics"]:
            fail(f"parallel (g) {schedule}: the ranks' metrics differ")
        worst = sorted(a["grad_worst"] + b_["grad_worst"],
                       key=lambda kv: -kv[1])[:4]
        log(f"[parallel] (g) pp={PAR_PP} {schedule}, M={a['microbatches']} "
            f"({a['ticks']} ticks, {cfg.num_layers // PAR_PP} layers a "
            f"stage): loss {a['metrics']['loss']:.6f} (rel "
            f"{a['loss_rel']:.3g}, tol {PAR_LOSS_RTOL}), grad_norm "
            f"{a['metrics']['grad_norm']:.4f}, gradient relative RMS per "
            f"tensor at most {worst[0][1]:.4g} (tol {PAR_GRAD_TOL}; the "
            f"worst " + ", ".join(f"{n} {v:.4g}" for n, v in worst)
            + f"), over each stage's tensors {a['grad_rel_rms']:.4g} / "
            f"{b_['grad_rel_rms']:.4g}; step {a['step_s']:.2f} / "
            f"{b_['step_s']:.2f} s (rank 0 / 1); K2 {a['k2']} / {b_['k2']}; "
            f"{a['tick_bytes'] / 1e6:.2f} MB sent a tick, route "
            f"{a['route']}; peak {a['peak_gb']:.2f} / {b_['peak_gb']:.2f} GB")
    v0, v1 = g0["1f1b_vs_gpipe"], g1["1f1b_vs_gpipe"]
    log(f"[parallel] (g) 1f1b vs gpipe: loss rel {v0['loss_rel']:.3g}, "
        f"gradient relative RMS per tensor at most "
        f"{max(v0['grad_worst'][0][1], v1['grad_worst'][0][1]):.4g} (over "
        f"each stage's tensors {v0['grad_rel_rms']:.4g} / "
        f"{v1['grad_rel_rms']:.4g}); rank 1's recompute of the one-rank "
        f"gradients {g1['ref_recompute_s']:.2f} s")
    for r, res in enumerate(results):
        log(f"[parallel] rank {r}: peak {res['peak_gb']:.2f} GB; collectives "
            f"{res['routes']}; (b) {res['b_s']:.1f} s, (d) {res['d_s']:.1f} "
            f"s, (e) {res['e_s']:.1f} s, (f) {res['f_s']:.1f} s")
    log(f"[parallel] phase {time.perf_counter() - t_phase:.1f} s")
    return {"k2": {k: {"tp2": b0["tp2"]["k2"][k],
                       "fsdp2": b0["fsdp2"]["k2"][k]}
                   for k in ("fwd", "dkdv", "dq")},
            "k2_pp": {k: {f"{sched}_stage{r}": res["b"]["pp"][sched]["k2"][k]
                          for sched in ("gpipe", "1f1b")
                          for r, res in enumerate(results)}
                      for k in ("fwd", "dkdv", "dq")},
            "k3": d0["k3"], "kern": kern}


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
                                                qwen2_5_coder_0_5b,
                                                qwen2_5_coder_1_5b)
    from senweaver_ide_tpu_torch.models.config import qwen3_30b_a3b
    t_start = time.perf_counter()
    smi = phase_device(torch)
    phase_build()
    cfg = qwen2_5_coder_1_5b()
    timer = Timer(torch)
    kern = phase_kernel(torch, cfg, timer)
    kspec = phase_kernel_spec(torch, cfg, qwen2_5_coder_0_5b(), timer)
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
    reuse_launches = phase_reuse(torch, cfg, loaded, args.seed, smi)
    async_launches = phase_async(torch, cfg, loaded, args.seed, smi)
    spec_launches = phase_spec(torch, cfg, loaded, args.seed, smi)
    group_launches = phase_group(torch, cfg, loaded, args.seed, smi,
                                 spec_launches["tie_atol"])
    tenant_launches = phase_tenants(torch, cfg, loaded, args.seed, smi,
                                    spec_launches["tie_atol"])
    migrate_launches = phase_migrate(torch, cfg, loaded, args.seed, smi,
                                     spec_launches["tie_atol"])
    # the fleet and the learner serve and train the first FLEET_LAYERS
    # layers (views of the loaded weights, full width): their four weight
    # frames over loopback HTTP cost time in proportion to the tree
    fcfg = dataclasses.replace(cfg, num_layers=FLEET_LAYERS)
    fparams = dict(loaded, layers={k: v[:FLEET_LAYERS]
                                   for k, v in loaded["layers"].items()})
    fleet_out = phase_fleet(torch, fcfg, fparams, args.seed, smi,
                            spec_launches["tie_atol"])
    learner_launches = phase_learner(torch, fcfg, fleet_out, args.seed, smi)
    del fparams
    fleet_launches = {k: fleet_out[k] for k in ("k1", "fwd", "dkdv", "dq",
                                                "k3")}
    del fleet_out
    gc.collect()
    torch.cuda.empty_cache()
    control_launches = phase_control(torch, cfg, loaded, args.seed, smi)
    gc.collect()
    torch.cuda.empty_cache()
    par = phase_parallel(torch, cfg, args.seed, smi,
                         spec_launches["tie_atol"], timer)
    gc.collect()
    torch.cuda.empty_cache()
    int8_w_launches = phase_int8(torch, cfg, loaded, args.seed, smi,
                                 spec_launches["tie_atol"])
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
    gc.collect()
    torch.cuda.empty_cache()
    moe = phase_moe(torch, dataclasses.replace(
        qwen3_30b_a3b(), num_layers=MOE_LAYERS), args.seed, smi, timer)
    rep8 = moe["rep8"]
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
            "launches_reuse": {"bf16": reuse_launches["k1"],
                               "int8": reuse_launches["k1_int8"]}.get(
                                   variant),
            "launches_async": (async_launches["k1"] if variant == "bf16"
                               else None),
            "launches_spec": (spec_launches["k1"] if variant == "bf16"
                              else None),
            "launches_group": (group_launches["k1"] if variant == "bf16"
                               else None),
            "launches_tenants": (tenant_launches["k1"] if variant == "bf16"
                                 else None),
            "launches_migrate": {"bf16": migrate_launches["k1"],
                                 "int8": migrate_launches["k1_int8"]}.get(
                                     variant),
            "launches_fleet": (fleet_launches["k1"] if variant == "bf16"
                               else None),
            "launches_learner": (learner_launches["k1"] if variant == "bf16"
                                 else None),
            "launches_control": (control_launches["k1"] if variant == "bf16"
                                 else None),
            "launches_int8": (int8_w_launches["k1"] if variant == "bf16"
                              else None),
            "launches_moe": ({"bf16_weights": moe["k1"]["bf16"],
                              "int8_weights": moe["k1"]["int8_weights"]}
                             if variant == "bf16" else None),
            "launches_qlora": (moe["k1"]["qlora"] if variant == "bf16"
                               else None),
            "max_abs_err": (max(r["max_abs_err"], kspec["max_abs_err_d64"],
                                kspec["max_abs_err_verify"], rep8["k1_err"])
                            if variant == "bf16" else r["max_abs_err"]),
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
            **{key: (kspec[key] if variant == "bf16" else None)
               for key in ("d64_ms", "d64_plain_ms", "d64_bound_ms",
                           "max_abs_err_d64", "verify_ms",
                           "verify_untiled_ms", "verify_plain_ms",
                           "verify_bound_ms", "verify_tiles",
                           "max_abs_err_verify")},
            **{f"rep8_{key}": (rep8["k1"][key] if variant == "bf16"
                               else None)
               for key in ("ms", "plain_ms", "bound_ms", "bytes")},
            "max_abs_err_rep8": (rep8["k1_err"] if variant == "bf16"
                                 else None),
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
            "launches_reuse": reuse_launches[kname],
            "launches_async": async_launches[kname],
            "launches_spec": spec_launches[kname],
            "launches_group": group_launches[kname],
            "launches_tenants": tenant_launches[kname],
            "launches_migrate": migrate_launches[kname],
            "launches_fleet": fleet_launches[kname],
            "launches_learner": learner_launches[kname],
            "launches_control": control_launches[kname],
            "launches_int8": int8_w_launches["k2"][kname],
            "launches_moe": moe["k2_serving"][kname],
            "launches_qlora": moe["k2"][kname],
            "launches_parallel": par["k2"][kname],
            "launches_pp": par["k2_pp"][kname],
            "local_heads": par["kern"]["k2"][kname],
            "max_abs_err": max(r["max_abs_err"],
                               rep8[kname]["max_abs_err"],
                               par["kern"]["k2"][kname]["max_abs_err"]),
            "tolerance": _fa_tol_text(FA_TOL[FA_ERR_OF[kname][0]]),
            "ms": r["kernel_ms"], "kernel_ms": r["kernel_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "flops": r["flops"],
            "bytes": r["bytes"], "library_ms": r["library_ms"],
            "library_note": ("torch.nn.functional.scaled_dot_product_"
                             "attention(is_causal=True) " +
                             ("forward" if kname == "fwd" else
                              "backward (all three gradients)")),
            **{f"rep8_{key}": rep8[kname][key]
               for key in ("ms", "plain_ms", "bound_ms", "library_ms",
                           "max_abs_err")},
            "rep8_shape": f"B={K2_REP8_B} S={K2_REP8_S} heads 32/4 D 128"})
    kernels.append({
        "name": "flash_decode", "route": "cuda",
        "source": "senweaver_ide_tpu_torch/csrc/flash_decode.cu",
        "replaces": "senweaver_ide_tpu/ops/flash_decode.py:44",
        "launches": slot_launches,
        "launches_int8_slots_qwen": int8_launches,
        "launches_reuse": reuse_launches["k3"],
        "launches_async": async_launches["k3"],
        "launches_spec": spec_launches["k3"],
        "launches_group": group_launches["k3"],
        "launches_tenants": tenant_launches["k3"],
        "launches_migrate": migrate_launches["k3"],
        "launches_fleet": fleet_launches["k3"],
        "launches_learner": learner_launches["k3"],
        "launches_control": control_launches["k3"],
        "launches_int8": int8_w_launches["k3"],
        "launches_moe": moe["k3"], "launches_qlora": moe["k3_qlora"],
        "launches_parallel": par["k3"],
        "local_heads": par["kern"]["k3"],
        "max_abs_err": max(fd["max_abs_err"],
                           par["kern"]["k3"]["max_abs_err"]),
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
