#!/usr/bin/env python3
"""Paged-KV memory-pressure report: JSONL summary or a hermetic
selftest of the pressure ladder (KV-pressure acceptance).

Usage::

    python scripts/kv_pressure_report.py metrics.jsonl
    python scripts/kv_pressure_report.py --selftest

Companion to ``scripts/serve_report.py`` (serving plane) — this one
answers "what did MEMORY PRESSURE do?": evictions, host-tier swaps,
preemption storms, and whether admission shed ahead of exhaustion.

Two modes:

- **JSONL**: scans a metrics JSONL for KV-pressure snapshot fields and
  emits the last observed values.
- **--selftest**: hermetic card/CPU proof of the whole ladder, zero
  infrastructure (CI runs it after the kv-pressure test job):

  1. *Proactive backpressure*: a chaos pool squeeze drives fleet KV
     pressure over the admission watermark; a new session must shed
     with a typed ``kv_pressure`` rejection while the engine has
     recorded ZERO exhaustions, and the in-flight decode must still
     run to completion once the squeeze lifts.
  2. *Pressure ladder at 2x over-capacity*: a prefix-sharing workload
     whose working set is ~2x the pool, squeezed by chaos mid-run.
     Every ticket must complete with tokens IDENTICAL to an
     unpressured reference run (swap/restore and preemption are
     invisible to outputs), the cold unshared prefix must be evicted
     while the hot shared one survives (resident or host-tiered), and
     the pool must drain leak-free.
  3. *Host-tier round trip*: swap a prefix to host RAM, export it
     from there (numpy, no device traffic), restore on demand, and
     require the post-restore decode to be token-exact.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict

# Allow running from a source checkout without installation.
sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from senweaver_ide_tpu_torch.device import resolve_device  # noqa: E402
from senweaver_ide_tpu_torch.obs.scope import preserved_obs  # noqa: E402

KV_FIELDS = ("kv_pressure", "kv_exhaustions", "kv_preemptions",
             "kv_preemption_storms", "kv_swapped_blocks",
             "prefix_evictions", "prefix_swap_outs", "prefix_swap_ins")


def summarize_jsonl(path: str) -> Dict[str, Any]:
    from senweaver_ide_tpu_torch.services.metrics import load_jsonl_metrics

    last: Dict[str, Any] = {}
    events = 0
    for e in load_jsonl_metrics(path):
        p = e.get("properties", e)
        hit = False
        for f in KV_FIELDS:
            if f in p:
                last[f] = p[f]
                hit = True
        events += hit
    return {"mode": "jsonl", "path": path, "events_with_kv": events,
            **{f: last.get(f) for f in KV_FIELDS}}


@preserved_obs()
def selftest(device="cuda") -> Dict[str, Any]:
    """Hermetic proof of the memory-pressure ladder; raises on any
    violated invariant (non-zero exit for CI)."""
    device = resolve_device(device)
    import torch

    from senweaver_ide_tpu_torch import obs
    from senweaver_ide_tpu_torch.models import (init_params, params_from_numpy,
                                                tiny_test)
    from senweaver_ide_tpu_torch.resilience import (MemoryPressureFault,
                                              MemoryPressurePlan)
    from senweaver_ide_tpu_torch.rollout import EngineConfig, RolloutEngine
    from senweaver_ide_tpu_torch.rollout.sampler import SampleParams
    from senweaver_ide_tpu_torch.serve import ServingFleet
    from senweaver_ide_tpu_torch.serve.admission import (AdmissionConfig,
                                                   REJECT_KV_PRESSURE,
                                                   Rejected)

    greedy = SampleParams(temperature=0.0, top_k=0, top_p=1.0)
    config = tiny_test()
    params = params_from_numpy(init_params(
        config, torch.Generator().manual_seed(0), device="cpu"),
        device=device)
    hot = [5, 9, 2, 7, 4, 4, 8, 1]        # 2 blocks @ block_size 4
    cold = [11, 3, 8, 1, 2, 6, 9, 5]
    prompts = [hot + [i + 1, 3] for i in range(6)]

    def engine(num_blocks=None, num_slots=2, **cfg_kw):
        cfg = EngineConfig(kv_layout="paged", block_size=4,
                           **({"num_blocks": num_blocks}
                              if num_blocks else {}), **cfg_kw)
        return RolloutEngine(params, config, num_slots=num_slots,
                             max_len=64, sample=greedy, device=device,
                             engine_config=cfg)

    # -- 1. proactive backpressure: shed BEFORE exhaustion -----------------
    obs._reset_for_tests()
    eng = engine(num_blocks=12)
    plan = MemoryPressurePlan([MemoryPressureFault(at_step=1,
                                                   hold_blocks=9)])
    fleet = ServingFleet([plan.wrap_engine(eng)],
                         admission=AdmissionConfig(kv_pressure_high=0.8,
                                                   kv_pressure_low=0.5))
    t1 = fleet.submit([5, 9], max_new_tokens=10)
    for _ in range(3):
        fleet.step()
    assert fleet.admission.kv_gated, "squeeze did not engage the gate"
    pressure_at_shed = fleet.admission.stats()["kv_pressure"]
    probe = fleet.submit([7, 3], max_new_tokens=4)
    rej = fleet.outcome(probe)
    assert isinstance(rej, Rejected) and rej.reason == REJECT_KV_PRESSURE, \
        f"expected typed kv_pressure shed, got {rej!r}"
    exhaustions_at_shed = eng.stats()["kv_exhaustions"]
    assert exhaustions_at_shed == 0, \
        "admission shed AFTER the pool exhausted — backpressure was late"
    plan.release_all(eng)
    out = fleet.run()
    assert len(out[t1]) == 10, "in-flight decode lost under the gate"
    assert not fleet.admission.kv_gated, "gate never released"
    eng._alloc.check_leaks()

    backpressure = {
        "pressure_at_shed": round(pressure_at_shed, 3),
        "shed_reason": rej.reason,
        "engine_exhaustions_at_shed": exhaustions_at_shed,
        "inflight_completed_tokens": len(out[t1]),
        "gate_released": True,
    }

    # -- 2. pressure ladder at 2x over-capacity ----------------------------
    # Unpressured reference first: same prompts, ample pool.
    obs._reset_for_tests()
    ref_eng = engine(num_blocks=64)
    ref_pid = ref_eng.register_prefix(hot)
    ref_rids = [ref_eng.submit(p, max_new_tokens=8, prefix_id=ref_pid)
                for p in prompts]
    ref_raw = ref_eng.run()
    reference = [ref_raw[r] for r in ref_rids]

    # Pressured: working set (~6 requests x ~5 blocks + 2 prefixes)
    # against a 10-block pool squeezed by chaos — sustained >2x over
    # capacity, the ladder must carry every request to an outcome. The
    # cold decoy has a single use (registration) so the scored evictor
    # drops it outright; the hot shared prefix is tier-worthy and swaps
    # to host instead of being recomputed.
    obs._reset_for_tests()
    eng = engine(num_blocks=10)
    cold_pid = eng.register_prefix(cold)     # decoy the evictor must take
    plan = MemoryPressurePlan([MemoryPressureFault(at_step=3,
                                                   hold_blocks=4,
                                                   release_step=60)])
    fleet = ServingFleet([plan.wrap_engine(eng)],
                         admission=AdmissionConfig(kv_pressure_high=0.95,
                                                   kv_pressure_low=0.7))
    pid = fleet.register_prefix(hot)
    tickets = [fleet.submit(p, max_new_tokens=8, prefix_id=pid)
               for p in prompts]
    steps = 0
    while fleet.pending() and steps < 800:
        fleet.step()
        steps += 1
    assert not fleet.pending(), f"fleet did not drain in {steps} steps"
    plan.release_all(eng)
    out = fleet.run()
    completed = [out.get(t) for t in tickets]
    assert all(c is not None for c in completed), \
        "a request was lost under pressure (no Completed outcome)"
    # Pressure may never CORRUPT a decode: every output is an exact
    # prefix of the unpressured reference (a storm-capped request is
    # allowed to truncate-finish short — bounded below — but a wrong
    # token anywhere means swap/restore or preemption broke the KV).
    for got, ref in zip(completed, reference):
        assert got == ref[:len(got)], \
            "pressured decode diverged from the unpressured reference"
    st = eng.stats()
    full = sum(got == ref for got, ref in zip(completed, reference))
    truncated = len(tickets) - full
    assert full >= 4, f"only {full}/{len(tickets)} completed in full"
    assert truncated <= st["kv_preemption_storms"], \
        "a request truncated without a latched preemption storm"
    hot_eng_pid = eng._prefix_by_tokens.get(tuple(hot))
    assert st["prefix_evictions"] >= 1, "the evictor never fired"
    assert st["prefix_swap_outs"] >= 1 and st["prefix_swap_ins"] >= 1, \
        "the host tier never engaged under pressure"
    assert cold_pid not in eng._prefixes, "cold decoy prefix survived"
    assert hot_eng_pid is not None and hot_eng_pid in eng._prefixes, \
        "hot shared prefix was dropped while cold blocks remained"
    eng.release_prefix(hot_eng_pid)
    eng._alloc.check_leaks()                 # leak-free at drain

    ladder = {
        "tickets": len(tickets),
        "completed": sum(c is not None for c in completed),
        "completed_full": full,
        "truncate_finished": truncated,
        "prefix_exact": True,
        "drain_steps": steps,
        "evictions": st["prefix_evictions"],
        "swap_outs": st["prefix_swap_outs"],
        "swap_ins": st["prefix_swap_ins"],
        "preemptions": st["kv_preemptions"],
        "preemption_storms": st["kv_preemption_storms"],
        "exhaustions": st["kv_exhaustions"],
        "prefix_cache_misses": st["prefix_cache_misses"],
        "cold_evicted_first": True,
        "hot_prefix_survived": True,
        "leaks_clean": True,
    }

    # -- 3. host-tier round trip: swap -> export -> restore, token-exact --
    obs._reset_for_tests()
    eng = engine()
    pid = eng.register_prefix(hot)
    prompt = hot + [1, 3]
    r0 = eng.submit(prompt, max_new_tokens=10, prefix_id=pid)
    ref = eng.run()[r0]
    eng._swap_out_prefix(pid)
    assert eng.prefix_in_host_tier(pid), "swap-out left no host copy"
    toks, kv, _ = eng.export_prefix(pid)
    assert toks == hot and kv.k.device.type == "cpu", \
        "host-tier export must serve host tensors straight from RAM"
    r1 = eng.submit(prompt, max_new_tokens=10, prefix_id=pid)
    restored = eng.run()[r1]
    assert restored == ref, "post-restore decode diverged"
    st3 = eng.stats()
    assert st3["prefix_swap_outs"] == 1 and st3["prefix_swap_ins"] == 1
    assert st3["prefix_host_exports"] == 1
    eng.release_prefix(pid)
    eng._alloc.check_leaks()

    host_tier = {
        "swap_outs": st3["prefix_swap_outs"],
        "swap_ins": st3["prefix_swap_ins"],
        "host_exports": st3["prefix_host_exports"],
        "token_exact": restored == ref,
    }

    # The ladder's tiering rungs must have fired SOMEWHERE in the run.
    assert ladder["evictions"] >= 1
    assert host_tier["swap_outs"] >= 1 and host_tier["swap_ins"] >= 1

    return {
        "mode": "selftest",
        "backpressure": backpressure,
        "pressure_ladder": ladder,
        "host_tier": host_tier,
        "ok": True,
    }


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("path", nargs="?", help="metrics JSONL to scan")
    parser.add_argument("--selftest", action="store_true",
                        help="run the hermetic memory-pressure selftest")
    parser.add_argument("--cpu", action="store_true",
                        help="run the selftest on the CPU (default: "
                             "the CUDA card)")
    args = parser.parse_args()
    if args.selftest:
        device = "cpu" if args.cpu else "cuda"
        print(json.dumps(selftest(device=device), indent=2))
        return
    if not args.path:
        parser.error("need a metrics JSONL path (or --selftest)")
    print(json.dumps(summarize_jsonl(args.path), indent=2))


if __name__ == "__main__":
    main()
