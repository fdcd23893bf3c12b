"""Perf-regression gate: deterministic CPU perf smoke vs a committed
baseline, with the runtime observatory as the evidence layer.

``torch_bench.py`` answers "how fast on the card"; this gate answers
"did THIS commit make the hot paths slower" — on the CUDA card (``--cpu``:
on the host), on the tiny-test model, deterministically enough to run
per-commit. Eleven cases cover the profiled hot set:

- ``engine_decode``: paged fused-step decode through RolloutEngine
  (ledger fn ``engine.fused_step``),
- ``spec_decode``: the same workload with a depth-4 draft fused into
  the step (ledger fns ``engine.fused_step`` + ``engine.spec_propose``),
- ``train_step``: one GRPO update via training.trainer.train_step
  (ledger fn ``trainer.grpo_step``),
- ``reward_head``: the batch reward scorer
  (ledger fn ``reward.head_batch``),
- ``fleet_scrape``: the fleet observability plane's host-side hot loop
  (scrape→ingest→rollup→alert-evaluate over loopback rpc). No ledger
  fn — the case instead proves the WHOLE ledger stays frozen across
  the timed window: federation must never touch a profiled path.

Warmup/steady separation is PROVEN, not assumed: each case runs a
warmup pass (kernel builds land there), then a timed steady pass; the
runtime ledger (obs/runtime_profile.py), where a compile is a kernel
build reported through ``note_compile``, must show ZERO new builds
inside the timed window or the case is re-run once and then failed.
The reported ``step_s`` therefore never contains build time.

Comparator semantics: the baseline file (``--baseline``; by default
``TORCH_PERF_BASELINE.json`` beside ``scripts/``, written by
``--update-baseline`` on the machine it gates) carries a per-metric
steady-state value and a noise band (default 2.0x; a genuine
algorithmic regression is typically well past 2x on these microscopic
cases). ``current > value * band`` fails the gate. Entries stamped
``"cached": true`` are REFUSED as evidence on either side: a cached
number proves nothing about this commit. With no baseline file the
gate passes and says so.

Usage:
  python scripts/torch_perf_gate.py                   # measure + compare
  python scripts/torch_perf_gate.py --out GATE.json   # also write artifact
  python scripts/torch_perf_gate.py --update-baseline # rewrite the baseline
  python scripts/torch_perf_gate.py --selftest        # hermetic selfcheck
  python scripts/torch_perf_gate.py --cpu ...         # on the host
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Any, Dict, List, Optional

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASELINE_PATH = os.path.join(REPO_ROOT, "TORCH_PERF_BASELINE.json")
DEFAULT_BAND = 2.0
# The reward head runs in ~100us — relative noise at that scale
# dwarfs the other cases, so its band is wider by construction. The
# fleet scrape sweep is pure host Python at sub-ms scale with the same
# jitter profile.
CASE_BANDS = {"reward_head": 3.0, "fleet_scrape": 3.0,
              # the handoff round trip is dominated by the host-side
              # gather/scatter pair — ms-scale with CPU-copy jitter
              "migration": 3.0}
STEADY_ITERS = 5


def _log(msg: str) -> None:
    print(f"[perf_gate] {msg}", file=sys.stderr, flush=True)


def _tiny_params(config, device, seed: int = 0):
    """The tiny model's weights, drawn on the host from ``seed`` (the
    same weights on the card and the host), on ``device``."""
    import torch

    from senweaver_ide_tpu_torch.models import init_params, params_from_numpy
    return params_from_numpy(init_params(
        config, torch.Generator().manual_seed(seed), device="cpu"),
        device=device)


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# -- comparator (pure; selftest-covered) ---------------------------------

def compare(current: Dict[str, Any], baseline: Dict[str, Any],
            default_band: float = DEFAULT_BAND) -> List[str]:
    """Violations of ``current`` vs ``baseline``; empty list == pass.

    Refuses cached evidence outright: a measurement replayed from a
    cache (``"cached": true`` on the run or any metric entry) says
    nothing about the commit under test, so it can neither pass nor
    set the bar."""
    problems: List[str] = []
    for side, payload in (("current", current), ("baseline", baseline)):
        if payload.get("cached"):
            return [f"{side} run is cached evidence (cached=true): "
                    "refusing to gate on a replayed measurement"]
    base_metrics = baseline.get("metrics", {})
    cur_metrics = current.get("metrics", {})
    for name, base in sorted(base_metrics.items()):
        if base.get("cached") or cur_metrics.get(name, {}).get("cached"):
            problems.append(f"{name}: cached metric entry refused")
            continue
        cur = cur_metrics.get(name)
        if cur is None:
            problems.append(f"{name}: missing from current run")
            continue
        band = float(base.get("band", default_band))
        limit = float(base["step_s"]) * band
        if float(cur["step_s"]) > limit:
            problems.append(
                f"{name}: steady step {cur['step_s']:.6f}s exceeds "
                f"baseline {base['step_s']:.6f}s x band {band:g} "
                f"(limit {limit:.6f}s)")
        if cur.get("steady_compiles", 0) > 0:
            problems.append(
                f"{name}: {cur['steady_compiles']} compile(s) inside "
                "the timed window — steady number is contaminated")
    return problems


# -- measurement cases ---------------------------------------------------

def _ledger_compiles(name: str) -> int:
    from senweaver_ide_tpu_torch.obs.runtime_profile import get_profiler
    snap = get_profiler().ledger().get(name)
    return int(snap["compiles"]) if snap else 0


def _timed_window(fn, ledger_fn: str, iters: int = STEADY_ITERS):
    """Run ``fn`` ``iters`` times, returning (per-iter wall seconds,
    compiles observed inside the window). One retry when compiles leak
    into the window (a first steady pass can still hit a cold signature
    on some shapes); a second leak is reported, not hidden."""
    for _attempt in range(2):
        c0 = _ledger_compiles(ledger_fn)
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        dt = (time.perf_counter() - t0) / iters
        leaked = _ledger_compiles(ledger_fn) - c0
        if leaked == 0:
            return dt, 0
    return dt, leaked


def _case_engine_decode(device) -> Dict[str, Any]:
    from senweaver_ide_tpu_torch.models import tiny_test
    from senweaver_ide_tpu_torch.rollout import EngineConfig, RolloutEngine
    from senweaver_ide_tpu_torch.rollout.sampler import SampleParams

    config = tiny_test()
    params = _tiny_params(config, device)
    greedy = SampleParams(temperature=0.0, top_k=0, top_p=1.0)
    prompts = [[(i * 7 + j) % 200 + 2 for j in range(16)]
               for i in range(4)]

    def run():
        eng = RolloutEngine(params, config, num_slots=4, max_len=128,
                            sample=greedy, device=device,
                            engine_config=EngineConfig(kv_layout="paged"))
        for p in prompts:
            eng.submit(p, max_new_tokens=24)
        eng.run()

    run()                                   # warmup: compiles land here
    step_s, leaked = _timed_window(run, "engine.fused_step", iters=3)
    return {"step_s": step_s, "steady_compiles": leaked,
            "compiles_total": _ledger_compiles("engine.fused_step")}


def _case_spec_decode(device) -> Dict[str, Any]:
    """The fused draft+verify speculative step (ISSUE 12): same paged
    workload as ``engine_decode`` but with a depth-4 draft riding the
    fused step. Gates BOTH that the spec path stays steady-state
    compile-free and that the fused step doesn't regress with
    speculation fused in."""
    import dataclasses

    from senweaver_ide_tpu_torch.models import tiny_test
    from senweaver_ide_tpu_torch.rollout import EngineConfig, RolloutEngine
    from senweaver_ide_tpu_torch.rollout.sampler import SampleParams

    config = tiny_test()
    params = _tiny_params(config, device)
    draft_cfg = dataclasses.replace(config, num_layers=2,
                                    name="tiny-draft")
    draft = _tiny_params(draft_cfg, device, seed=1)
    greedy = SampleParams(temperature=0.0, top_k=0, top_p=1.0)
    prompts = [[(i * 7 + j) % 200 + 2 for j in range(16)]
               for i in range(4)]

    def run():
        eng = RolloutEngine(params, config, num_slots=4, max_len=128,
                            sample=greedy, device=device,
                            engine_config=EngineConfig(kv_layout="paged"))
        eng.enable_speculation(draft, draft_cfg, depth=4)
        for p in prompts:
            eng.submit(p, max_new_tokens=24)
        eng.run()

    run()                                   # warmup: compiles land here
    c0 = _ledger_compiles("engine.spec_propose")
    step_s, leaked = _timed_window(run, "engine.fused_step", iters=3)
    leaked += _ledger_compiles("engine.spec_propose") - c0
    return {"step_s": step_s, "steady_compiles": leaked,
            "compiles_total": _ledger_compiles("engine.fused_step")
            + _ledger_compiles("engine.spec_propose")}


def _case_train_step(device) -> Dict[str, Any]:
    import torch

    from senweaver_ide_tpu_torch.models import tiny_test
    from senweaver_ide_tpu_torch.training.trainer import (TrainState,
                                                    make_optimizer,
                                                    train_step)

    config = tiny_test()
    params = _tiny_params(config, device)
    opt = make_optimizer()
    state = TrainState(params=params, opt_state=opt.init(params), step=0,
                       opt=opt)
    key = torch.Generator(device=device).manual_seed(1)
    tokens = torch.randint(0, config.vocab_size, (4, 64), generator=key,
                           device=device)
    mask = torch.ones((4, 64), dtype=torch.bool, device=device)
    rewards = torch.randn((4,), generator=key, device=device)
    group_ids = torch.arange(4, device=device) // 2

    holder = {"state": state}

    def run():
        st, _ = train_step(holder["state"], config, None, tokens, mask,
                           rewards, group_ids, optimizer=opt)
        _sync(device)
        holder["state"] = st

    run()                                   # warmup
    step_s, leaked = _timed_window(run, "trainer.grpo_step", iters=3)
    return {"step_s": step_s, "steady_compiles": leaked,
            "compiles_total": _ledger_compiles("trainer.grpo_step")}


def _case_reward_head(device) -> Dict[str, Any]:
    import numpy as np
    import torch

    from senweaver_ide_tpu_torch.rewards.head import reward_head_batch
    from senweaver_ide_tpu_torch.traces.features import N_FEATURES

    feats = torch.as_tensor(
        np.random.default_rng(0).uniform(0, 5, (32, N_FEATURES)),
        dtype=torch.float32, device=device)

    def run():
        reward_head_batch(feats)

    run()                                   # warmup
    step_s, leaked = _timed_window(run, "reward.head_batch")
    return {"step_s": step_s, "steady_compiles": leaked,
            "compiles_total": _ledger_compiles("reward.head_batch")}


def _case_kv_pressure(device) -> Dict[str, Any]:
    """The memory-pressure ladder end to end (ISSUE 13): the
    ``engine_decode`` workload made prefix-sharing and ~2x over pool
    capacity with the host tier on, so scored eviction, swap-out /
    on-demand restore, and preemption replay all ride the fused step.
    Gates that pressure handling adds no steady-state retraces and
    that the pressured end-to-end time is tracked run over run."""
    from senweaver_ide_tpu_torch.models import tiny_test
    from senweaver_ide_tpu_torch.rollout import EngineConfig, RolloutEngine
    from senweaver_ide_tpu_torch.rollout.sampler import SampleParams

    config = tiny_test()
    params = _tiny_params(config, device)
    greedy = SampleParams(temperature=0.0, top_k=0, top_p=1.0)
    prefix = [(j * 11) % 200 + 2 for j in range(16)]
    prompts = [prefix + [(i * 7 + j) % 200 + 2 for j in range(4)]
               for i in range(6)]

    def run():
        eng = RolloutEngine(
            params, config, num_slots=2, max_len=128, sample=greedy,
            device=device, engine_config=EngineConfig(
                kv_layout="paged", block_size=4, num_blocks=10,
                tier_min_uses=1))
        pid = eng.register_prefix(prefix)
        for p in prompts:
            eng.submit(p, max_new_tokens=12, prefix_id=pid)
        eng.run()
        eng.release_prefix(pid)
        eng._alloc.check_leaks()            # drain must stay leak-free

    run()                                   # warmup: compiles land here
    step_s, leaked = _timed_window(run, "engine.fused_step", iters=3)
    return {"step_s": step_s, "steady_compiles": leaked,
            "compiles_total": _ledger_compiles("engine.fused_step")}


def _case_kv_quant(device) -> Dict[str, Any]:
    """The quantized KV ladder (ISSUE 19): the pressured shared-prefix
    workload on an int8 pool. Gates that quantize-at-write rides the
    ONE fused-step signature — scale scatter, COW, preemption replay
    and prefix grafts must add no steady-state retraces — and tracks
    the quantized end-to-end time run over run."""
    from senweaver_ide_tpu_torch.models import tiny_test
    from senweaver_ide_tpu_torch.rollout import EngineConfig, RolloutEngine
    from senweaver_ide_tpu_torch.rollout.sampler import SampleParams

    config = tiny_test()
    params = _tiny_params(config, device)
    greedy = SampleParams(temperature=0.0, top_k=0, top_p=1.0)
    prefix = [(j * 11) % 200 + 2 for j in range(16)]
    prompts = [prefix + [(i * 7 + j) % 200 + 2 for j in range(4)]
               for i in range(6)]

    def run():
        eng = RolloutEngine(
            params, config, num_slots=2, max_len=128, sample=greedy,
            device=device, engine_config=EngineConfig(
                kv_layout="paged", block_size=4, num_blocks=10,
                kv_dtype="int8", host_tier=False))
        pid = eng.register_prefix(prefix)
        for p in prompts:
            eng.submit(p, max_new_tokens=12, prefix_id=pid)
        eng.run()
        if pid in eng._prefixes:
            eng.release_prefix(pid)
        eng._alloc.check_leaks()            # drain must stay leak-free

    run()                                   # warmup: compiles land here
    step_s, leaked = _timed_window(run, "engine.fused_step", iters=3)
    return {"step_s": step_s, "steady_compiles": leaked,
            "compiles_total": _ledger_compiles("engine.fused_step")}


def _case_migration(device) -> Dict[str, Any]:
    """The live-migration hot path (ISSUE 17): checkpoint a mid-flight
    decode off engine A (one gathered device_get), install it on
    engine B (one scatter), finish it there, release the source copy —
    the full handoff round trip. Gates that migrating adds no
    steady-state retraces (the install rides the same paged scatter
    the prefix import uses) and tracks the end-to-end handoff time."""
    from senweaver_ide_tpu_torch.models import tiny_test
    from senweaver_ide_tpu_torch.rollout import EngineConfig, RolloutEngine
    from senweaver_ide_tpu_torch.rollout.sampler import SampleParams

    config = tiny_test()
    params = _tiny_params(config, device)
    greedy = SampleParams(temperature=0.0, top_k=0, top_p=1.0)
    prompts = [[(i * 7 + j) % 200 + 2 for j in range(12)]
               for i in range(3)]

    def run():
        a = RolloutEngine(params, config, num_slots=4, max_len=128,
                          sample=greedy, device=device,
                          engine_config=EngineConfig(kv_layout="paged"))
        b = RolloutEngine(params, config, num_slots=4, max_len=128,
                          sample=greedy, device=device,
                          engine_config=EngineConfig(kv_layout="paged"))
        rids = [a.submit(p, max_new_tokens=16) for p in prompts]
        for _ in range(6):
            a.step()
        for rid in rids:
            ckpt = a.checkpoint_request(rid)
            b.restore_request(ckpt)
            a.release_request(rid)
        b.run()
        a._alloc.check_leaks()              # source fully released
        b._alloc.check_leaks()

    run()                                   # warmup: compiles land here
    step_s, leaked = _timed_window(run, "engine.fused_step", iters=3)
    return {"step_s": step_s, "steady_compiles": leaked,
            "compiles_total": _ledger_compiles("engine.fused_step")}


def _case_multi_lora(device) -> Dict[str, Any]:
    """Batched multi-tenant LoRA decode (ISSUE 14): four tenants across
    both rank rungs ride one pool engine's fused step via the gathered
    adapter banks. Gates that the gathered path stays steady-state
    compile-free — each iteration rebuilds the pool and re-acquires
    every slot, so tenant churn must land on warm signatures — and
    tracks the mixed-batch end-to-end time."""
    import torch

    from senweaver_ide_tpu_torch.models import tiny_test
    from senweaver_ide_tpu_torch.rollout import (AdapterPool, AdapterPoolConfig,
                                           EngineConfig, RolloutEngine)
    from senweaver_ide_tpu_torch.rollout.sampler import SampleParams
    from senweaver_ide_tpu_torch.training.lora import init_lora

    config = tiny_test()
    params = _tiny_params(config, device)
    greedy = SampleParams(temperature=0.0, top_k=0, top_p=1.0)
    prompts = [[(i * 7 + j) % 200 + 2 for j in range(16)]
               for i in range(4)]
    loras = {}
    for i in range(4):
        lora = init_lora(config, torch.Generator(
            device=device).manual_seed(10 + i), rank=8 if i % 2 else 16,
            device=device)
        for k in list(lora["layers"]):
            if k.endswith("_lora_b"):
                lora["layers"][k] = torch.randn(
                    lora["layers"][k].shape, generator=torch.Generator(
                        device=device).manual_seed(50 + i),
                    dtype=lora["layers"][k].dtype, device=device) * 0.05
        loras[f"tenant-{i}"] = lora

    def run():
        pool = AdapterPool(config, AdapterPoolConfig(slots_per_rank=2),
                           device=device)
        eng = RolloutEngine(
            params, config, num_slots=4, max_len=128, sample=greedy,
            device=device, adapter_pool=pool,
            engine_config=EngineConfig(kv_layout="paged"))
        for name, lora in loras.items():
            eng.publish_adapter(name, lora)
        for p, name in zip(prompts, loras):
            eng.submit(p, max_new_tokens=24, adapter_id=name)
        eng.run()
        eng._alloc.check_leaks()

    run()                                   # warmup: compiles land here
    step_s, leaked = _timed_window(run, "engine.fused_step", iters=3)
    return {"step_s": step_s, "steady_compiles": leaked,
            "compiles_total": _ledger_compiles("engine.fused_step")}


def _case_group_rollout(device) -> Dict[str, Any]:
    """The group-shared rollout hot path (ISSUE 18): one G=8 GRPO
    group decodes off a single donor prefill — followers graft the
    forked KV spine and pay only the one-token dropped-write rescore —
    then the whole group rides the fused step together. Gates that the
    fork/graft plumbing adds no steady-state retraces (grafts reuse
    the prefill and decode signatures) and tracks the group's
    end-to-end time; each iteration asserts one prefill and a
    leak-free drain, so a silent degrade to per-member prefills fails
    the case, not just the perf band."""
    from senweaver_ide_tpu_torch.models import tiny_test
    from senweaver_ide_tpu_torch.rollout import EngineConfig, RolloutEngine
    from senweaver_ide_tpu_torch.rollout.sampler import SampleParams

    config = tiny_test()
    params = _tiny_params(config, device)
    greedy = SampleParams(temperature=0.0, top_k=0, top_p=1.0)
    prompt = [(j * 11) % 200 + 2 for j in range(24)]

    def run():
        eng = RolloutEngine(
            params, config, num_slots=8, max_len=128, sample=greedy,
            device=device,
            engine_config=EngineConfig(kv_layout="paged", block_size=4))
        eng.submit_group(prompt, 8, max_new_tokens=16)
        eng.run()
        st = eng.stats()
        assert st["prefills"] == 1, \
            f"group paid {st['prefills']} prefills (degrade leaked in)"
        eng._alloc.check_leaks()            # drain must stay leak-free

    run()                                   # warmup: compiles land here
    step_s, leaked = _timed_window(run, "engine.fused_step", iters=3)
    return {"step_s": step_s, "steady_compiles": leaked,
            "compiles_total": _ledger_compiles("engine.fused_step")}


def _ledger_compiles_all() -> int:
    from senweaver_ide_tpu_torch.obs.runtime_profile import get_profiler
    return sum(int(s["compiles"])
               for s in get_profiler().ledger().values())


def _case_fleet_scrape(device) -> Dict[str, Any]:
    """The fleet observability plane's host hot loop (ISSUE 16): three
    peers' registries keep moving, the federator delta-scrapes them
    over loopback rpc, the store ingests and rolls up, and the alert
    manager sweeps the stock rule set. Pure host Python by contract,
    so there is no per-fn ledger name to bracket — instead the case
    proves the ENTIRE profiler ledger stays frozen across the timed
    window (federation must never touch a jitted path) and tracks the
    per-sweep wall time."""
    from senweaver_ide_tpu_torch import obs
    from senweaver_ide_tpu_torch.obs import MetricsScrapeMixin
    from senweaver_ide_tpu_torch.serve.remote_server import RpcHandlerBase
    from senweaver_ide_tpu_torch.serve.rpc import LoopbackTransport

    class _ObsScrapeHandler(MetricsScrapeMixin, RpcHandlerBase):
        mutating_methods = frozenset({"scrape"})
        span_service = "obs"

    clock = {"t": 0.0}

    def now() -> float:
        return clock["t"]

    journal = obs.EventJournal(clock=now)
    store = obs.FleetMetricsStore(clock=now)
    peers = {}
    instruments = []
    for i in range(3):
        reg = obs.MetricsRegistry()
        peer_journal = obs.EventJournal(clock=now, registry=reg)
        h = _ObsScrapeHandler()
        h.scrape_peer = f"peer-{i}"
        h.scrape_registry = reg
        h.scrape_journal = peer_journal
        h.scrape_clock = now
        peers[f"peer-{i}"] = LoopbackTransport(h, target=f"peer-{i}")
        instruments.append((
            reg.gauge("senweaver_kv_pressure", ""),
            reg.counter("senweaver_serve_slo_requests_total", "",
                        labelnames=("priority",)),
            reg.counter("senweaver_serve_slo_violations_total", "",
                        labelnames=("priority",)),
            reg.histogram("senweaver_learner_episode_staleness", "",
                          buckets=(1.0, 2.0, 4.0, 8.0))))
    fed = obs.MetricsFederator(store, peers, clock=now,
                               journal=journal, interval_s=0.0)
    mgr = obs.AlertManager(store, obs.default_alert_rules(),
                           clock=now, journal=journal)
    ticks = {"n": 0}

    def run():
        n = ticks["n"] = ticks["n"] + 1
        clock["t"] += 1.0
        for j, (kv, reqs, viols, staleness) in enumerate(instruments):
            kv.set(0.3 + 0.05 * ((n + j) % 5))
            reqs.inc(4, priority="interactive")
            if (n + j) % 7 == 0:
                viols.inc(priority="interactive")
            staleness.observe(float((n + j) % 4))
        fed.scrape_once(now())
        mgr.evaluate(now())

    base = _ledger_compiles_all()
    run()                                   # warmup: full resync scrape
    c0 = _ledger_compiles_all()
    iters = 50
    t0 = time.perf_counter()
    for _ in range(iters):
        run()
    step_s = (time.perf_counter() - t0) / iters
    leaked = _ledger_compiles_all() - c0
    return {"step_s": step_s, "steady_compiles": leaked,
            "compiles_total": _ledger_compiles_all() - base}


def _case_streaming_grpo(device) -> Dict[str, Any]:
    """The streaming learner's hot loop (ISSUE 15): bounded-queue
    intake with dedup and the staleness filter, batch assembly from
    recorded behavior logps, and the importance-corrected grpo step
    through the StreamingTrainerAdapter. Gates that episode-shaped
    intake lands on a warm train signature — per-round group churn
    must not retrace — and tracks the per-step time."""
    from senweaver_ide_tpu_torch.models import tiny_test
    from senweaver_ide_tpu_torch.training.experience import (
        ExperienceQueue, StreamedEpisode, StreamingTrainerAdapter)
    from senweaver_ide_tpu_torch.training.trainer import (TrainState,
                                                    make_optimizer)

    config = tiny_test()
    params = _tiny_params(config, device)
    opt = make_optimizer()
    state = TrainState(params=params, opt_state=opt.init(params), step=0,
                       opt=opt)
    adapter = StreamingTrainerAdapter(state, config, None, optimizer=opt,
                                      max_len=32)
    queue = ExperienceQueue(group_size=8, max_staleness=64)
    rounds = {"n": 0}

    def run():
        r = rounds["n"] = rounds["n"] + 1
        eps = [StreamedEpisode(
            episode_id=f"pg/r{r}/i{i}", group_key=f"pg/r{r}",
            prompt_ids=[(i * 7 + j) % 200 + 2 for j in range(8)],
            completion_ids=[(i + j) % 200 + 2 for j in range(4)],
            reward=float(i % 3) - 1.0, epoch=1, version=r,
            behavior_logp=[-0.5, -0.25, -0.5, -0.25])
            for i in range(8)]
        queue.offer_many(eps, current_version=r)
        batch = queue.take_batch(current_version=r)
        assert batch is not None
        adapter.train_on_batch(batch)
        adapter.note_published(r)
        _sync(device)

    run()                                   # warmup
    step_s, leaked = _timed_window(run, "trainer.grpo_step", iters=3)
    return {"step_s": step_s, "steady_compiles": leaked,
            "compiles_total": _ledger_compiles("trainer.grpo_step")}


CASES = {
    "engine_decode": _case_engine_decode,
    "spec_decode": _case_spec_decode,
    "kv_pressure": _case_kv_pressure,
    "kv_quant": _case_kv_quant,
    "migration": _case_migration,
    "multi_lora": _case_multi_lora,
    "group_rollout": _case_group_rollout,
    "train_step": _case_train_step,
    "streaming_grpo": _case_streaming_grpo,
    "reward_head": _case_reward_head,
    "fleet_scrape": _case_fleet_scrape,
}


def measure(device="cuda") -> Dict[str, Any]:
    """Run every case on ``device`` (the card unless asked for the host);
    returns the gate artifact, with the card's name on it."""
    import torch

    import senweaver_ide_tpu_torch.obs as obs
    from senweaver_ide_tpu_torch.device import resolve_device
    device = resolve_device(device)
    obs._reset_for_tests()
    run: Dict[str, Any] = {
        "schema": "perf_gate/v1",
        "cached": False,
        "backend": device.type,
        "device_name": (torch.cuda.get_device_name(device)
                        if device.type == "cuda" else "cpu"),
        "measured_at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "metrics": {},
    }
    for name, case in CASES.items():
        _log(f"case: {name}")
        entry = case(device)
        entry["step_s"] = round(entry["step_s"], 6)
        run["metrics"][name] = entry
        _log(f"  steady {entry['step_s']:.6f}s/iter, "
             f"{entry['compiles_total']} compile(s) in warmup, "
             f"{entry['steady_compiles']} in timed window")
    from senweaver_ide_tpu_torch.obs.runtime_profile import get_profiler
    run["ledger"] = get_profiler().ledger()
    return run


def _load_baseline(path: str) -> Optional[Dict[str, Any]]:
    try:
        with open(path) as f:
            payload = json.load(f)
        return payload if isinstance(payload, dict) else None
    except Exception:
        return None


def _write_baseline(run: Dict[str, Any], path: str) -> None:
    baseline = {
        "schema": "perf_gate/v1",
        "cached": False,
        "backend": run["backend"],
        "measured_at": run["measured_at"],
        "band": DEFAULT_BAND,
        "metrics": {
            name: {"step_s": entry["step_s"],
                   "band": CASE_BANDS.get(name, DEFAULT_BAND)}
            for name, entry in run["metrics"].items()
        },
    }
    with open(path, "w") as f:
        json.dump(baseline, f, indent=1)
        f.write("\n")


# -- selftest (hermetic: no model code, no baseline file) ----------------

def _built_per_shape(fn):
    """``fn`` behind a per-shape build cache: its first call at a new
    shape reports a build through ``note_compile``, as a kernel built
    for each shape would (the port's counterpart of a retrace)."""
    from senweaver_ide_tpu_torch.obs.runtime_profile import note_compile
    built = set()

    def call(x):
        if tuple(x.shape) not in built:
            built.add(tuple(x.shape))
            note_compile(0.0)
        return fn(x)
    return call


def selftest(device="cuda") -> int:
    """Self-check of the gate's own machinery: the storm detector
    fires on a function built anew for every shape, the ledger counts
    those builds, the comparator flags an injected 2x regression and
    passes an in-band run, and cached evidence is refused. No timing
    dependence — safe on any runner."""
    import torch

    import senweaver_ide_tpu_torch.obs as obs
    from senweaver_ide_tpu_torch.device import resolve_device
    from senweaver_ide_tpu_torch.obs.runtime_profile import (
        ProfiledFunction, get_profiler)

    device = resolve_device(device)
    failures: List[str] = []

    # 1. Retrace storm: every call a fresh shape, threshold far below.
    obs._reset_for_tests()
    storm_fn = ProfiledFunction(_built_per_shape(lambda x: x * 2),
                                "selftest.retrace", storm_threshold=4)
    for n in range(1, 13):
        storm_fn(torch.ones((n,), device=device))
    snap = get_profiler().ledger()["selftest.retrace"]
    if snap["compiles"] != 12:
        failures.append(f"retrace ledger saw {snap['compiles']} "
                        "compiles, expected 12")
    if snap["storms"] == 0:
        failures.append("storm detector did not fire on a per-call "
                        "retrace pattern")

    # 2. A stable function must NOT storm (the detector's other half).
    stable_fn = ProfiledFunction(_built_per_shape(lambda x: x + 1),
                                 "selftest.stable", storm_threshold=4)
    for _ in range(20):
        stable_fn(torch.ones((8,), device=device))
    if get_profiler().ledger()["selftest.stable"]["storms"]:
        failures.append("storm detector fired on a compile-once fn")

    # 3. Comparator: injected 2x regression flagged, in-band run passes.
    baseline = {"cached": False,
                "metrics": {"m": {"step_s": 0.010, "band": 1.75}}}
    regressed = {"cached": False,
                 "metrics": {"m": {"step_s": 0.020,
                                   "steady_compiles": 0}}}
    in_band = {"cached": False,
               "metrics": {"m": {"step_s": 0.012,
                                 "steady_compiles": 0}}}
    if not compare(regressed, baseline):
        failures.append("comparator passed an injected 2x regression")
    if compare(in_band, baseline):
        failures.append(f"comparator flagged an in-band run: "
                        f"{compare(in_band, baseline)}")

    # 4. Cached evidence refused — on the run and on a metric entry.
    if not compare({**in_band, "cached": True}, baseline):
        failures.append("comparator accepted a cached current run")
    if not compare(in_band, {**baseline, "cached": True}):
        failures.append("comparator accepted a cached baseline")
    poisoned = {"cached": False,
                "metrics": {"m": {"step_s": 0.012, "cached": True}}}
    if not compare(poisoned, baseline):
        failures.append("comparator accepted a cached metric entry")

    # 5. Contaminated steady window flagged even when timing is fine.
    dirty = {"cached": False,
             "metrics": {"m": {"step_s": 0.012, "steady_compiles": 2}}}
    if not any("timed window" in p for p in compare(dirty, baseline)):
        failures.append("comparator missed compiles inside the timed "
                        "window")

    obs._reset_for_tests()
    for f in failures:
        _log(f"SELFTEST FAIL: {f}")
    if not failures:
        _log("selftest OK: storm detector, comparator bands, cached "
             "refusal, window contamination all behave")
    return 1 if failures else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--selftest", action="store_true",
                    help="hermetic gate-machinery check (no model code)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the host (default: the CUDA card, which "
                         "must be there)")
    ap.add_argument("--out", help="write the gate artifact JSON here")
    ap.add_argument("--update-baseline", action="store_true",
                    help=f"rewrite {os.path.basename(BASELINE_PATH)} "
                         "from this run")
    ap.add_argument("--baseline", default=BASELINE_PATH,
                    help="baseline file to compare against")
    args = ap.parse_args(argv)

    device = "cpu" if args.cpu else "cuda"
    if args.selftest:
        return selftest(device)

    run = measure(device)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(run, f, indent=1)
            f.write("\n")
        _log(f"artifact written: {args.out}")
    if args.update_baseline:
        _write_baseline(run, args.baseline)
        _log(f"baseline written: {args.baseline}")
        return 0
    baseline = _load_baseline(args.baseline)
    if baseline is None:
        _log(f"no baseline at {args.baseline}; run with "
             "--update-baseline to create one (gate passes vacuously)")
        return 0
    problems = compare(run, baseline)
    for p in problems:
        _log(f"REGRESSION: {p}")
    if not problems:
        _log("gate PASS: all steady-state numbers within band")
    return 1 if problems else 0


if __name__ == "__main__":
    sys.path.insert(0, REPO_ROOT)
    sys.exit(main())
