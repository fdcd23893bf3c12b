#!/usr/bin/env python3
"""Fleet speculative-decoding report: JSONL summary or a hermetic
selftest of the two control loops.

Usage::

    python scripts/spec_report.py metrics.jsonl
    python scripts/spec_report.py --selftest

Companion to ``scripts/serve_report.py`` (serving plane) — this one
answers "what did SPECULATION do?": depth the controller chose,
acceptance, wasted draft tokens, draft staleness and republishes.

Two modes:

- **JSONL**: scans a training metrics JSONL for spec-prefixed snapshot
  fields (``spec_depth``, ``spec_acceptance`` …) and emits the last
  observed values.
- **--selftest**: hermetic card/CPU proof of both loops, zero
  infrastructure (CI runs it after the spec test job):

  1. *Concurrency-adaptive depth*: the controller must sit at the
     DEEPEST ladder rung when idle and walk to depth 0 (speculation
     off) under sustained high load — verified standalone and through
     a live engine flooded past its slot count.
  2. *Online draft distillation*: simulate a policy publish by
     perturbing the target away from the draft's teacher, measure the
     frozen draft's acceptance, distill on the outcomes the engine's
     fused verify step harvested, and require a measurably higher
     acceptance with the republished draft. Greedy parity is asserted
     throughout — distillation may only move THROUGHPUT.
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

SPEC_FIELDS = ("spec_depth", "spec_acceptance", "spec_wasted_draft_tokens",
               "spec_draft_staleness", "spec_draft_version",
               "draft_publishes")


def summarize_jsonl(path: str) -> Dict[str, Any]:
    from senweaver_ide_tpu_torch.services.metrics import load_jsonl_metrics

    last: Dict[str, Any] = {}
    events = 0
    for e in load_jsonl_metrics(path):
        p = e.get("properties", e)
        hit = False
        for f in SPEC_FIELDS:
            if f in p:
                last[f] = p[f]
                hit = True
        events += hit
    return {"mode": "jsonl", "path": path, "events_with_spec": events,
            **{f: last.get(f) for f in SPEC_FIELDS}}


def _drifted(params, scale: float, seed: int):
    import torch
    from senweaver_ide_tpu_torch.training.trainer import (flatten_params,
                                                          unflatten_params)
    g = torch.Generator().manual_seed(seed)     # host draws: same on any card
    return unflatten_params([
        (k, l + scale * torch.randn(l.shape, generator=g,
                                    dtype=l.dtype).to(l.device))
        for k, l in flatten_params(params)])


@preserved_obs()
def selftest(device="cuda") -> Dict[str, Any]:
    """Hermetic proof of both speculation control loops; raises on any
    violated invariant (non-zero exit for CI)."""
    device = resolve_device(device)
    import torch

    from senweaver_ide_tpu_torch import obs
    from senweaver_ide_tpu_torch.models import (init_params, params_from_numpy,
                                                tiny_test)
    from senweaver_ide_tpu_torch.rollout import EngineConfig, RolloutEngine
    from senweaver_ide_tpu_torch.rollout.sampler import SampleParams
    from senweaver_ide_tpu_torch.rollout.spec_controller import (
        SpecController, SpecControllerConfig)
    from senweaver_ide_tpu_torch.training.draft_distill import DraftDistiller

    obs._reset_for_tests()
    greedy = SampleParams(temperature=0.0, top_k=0, top_p=1.0)
    config = tiny_test()

    # -- 1. concurrency-adaptive depth ------------------------------------
    cfg = SpecControllerConfig(hysteresis_steps=2)
    ctl = SpecController(cfg)
    deepest = max(cfg.ladder)
    for _ in range(cfg.hysteresis_steps + 1):
        idle_depth = ctl.observe(occupancy=0.05, kv_pressure=0.05,
                                 decode_tokens=0, num_slots=4)
    assert idle_depth == deepest, \
        f"idle fleet must speculate deepest, got {idle_depth}"
    for _ in range(cfg.hysteresis_steps + 1):
        loaded_depth = ctl.observe(occupancy=1.0, kv_pressure=0.95,
                                   decode_tokens=4096, num_slots=4)
    assert loaded_depth == 0, \
        f"saturated fleet must turn speculation off, got {loaded_depth}"

    # Through a live engine: flood past the slot count with a heavy
    # router backlog and the per-step controller must walk depth to 0.
    target = params_from_numpy(init_params(
        config, torch.Generator().manual_seed(0), device="cpu"),
        device=device)
    eng = RolloutEngine(
        target, config, num_slots=2, max_len=96, sample=greedy, device=device,
        engine_config=EngineConfig(kv_layout="paged", block_size=4))
    eng.enable_speculation(
        target, config,
        controller=SpecController(SpecControllerConfig(hysteresis_steps=1)))
    for i in range(10):
        eng.submit([(3 * i + j) % 97 for j in range(5)], max_new_tokens=16)
    eng.note_decode_load(4096.0)
    depths = []
    for _ in range(6):
        eng.step()
        depths.append(eng.spec_stats()["depth"])
    engine_loaded_depth = min(depths)
    assert engine_loaded_depth == 0, \
        f"flooded engine never reached depth 0: {depths}"
    eng.note_decode_load(0.0)
    eng.run()
    # Load gone: a light trickle must bring speculation back on.
    eng.submit([1, 2, 3], max_new_tokens=24)
    eng.run()
    drained_depth = eng.spec_stats()["depth"]
    assert drained_depth > 0, \
        f"light-load engine must re-enable speculation, got {drained_depth}"
    eng._alloc.check_leaks()
    eng.spec_check_leaks()

    # -- 2. online draft distillation -------------------------------------
    obs._reset_for_tests()
    # Simulated policy publish: the serving target drifts away from the
    # weights the draft was distilled against.
    draft_teacher = params_from_numpy(init_params(
        config, torch.Generator().manual_seed(0), device="cpu"),
        device=device)
    policy = _drifted(draft_teacher, 0.02, seed=7)
    prompts = [[(i * 7 + j) % 97 for j in range(4 + i % 3)]
               for i in range(8)]

    def serve(draft_params):
        e = RolloutEngine(
            policy, config, num_slots=4, max_len=96, sample=greedy,
            device=device,
            engine_config=EngineConfig(kv_layout="paged", block_size=4))
        e.enable_speculation(draft_params, config, depth=4)
        for p in prompts:
            e.submit(p, max_new_tokens=24)
        out = e.run()
        s = e.spec_stats()
        e._alloc.check_leaks()
        e.spec_check_leaks()
        return s["accepted"] / max(1, s["proposed"]), e, out

    frozen_rate, eng, out_frozen = serve(draft_teacher)
    distiller = DraftDistiller(draft_teacher, config,
                               learning_rate=3e-3, batch_size=8, seed=0)
    harvested = distiller.harvest(eng)
    assert harvested > 0, "fused verify step harvested no outcomes"
    loss_first = distiller.step()
    loss_last = distiller.run(29)
    distilled_rate, _, out_distilled = serve(distiller.params)
    assert distilled_rate > frozen_rate + 0.05, \
        (f"distillation did not raise acceptance: "
         f"{frozen_rate:.3f} -> {distilled_rate:.3f}")
    # Exactness: a better draft changes THROUGHPUT only, never tokens.
    assert out_frozen == out_distilled, \
        "draft swap changed greedy outputs — speculation is broken"

    return {
        "mode": "selftest",
        "controller": {
            "ladder": list(cfg.ladder),
            "idle_depth": idle_depth,
            "loaded_depth": loaded_depth,
            "engine_loaded_depth": engine_loaded_depth,
            "engine_drained_depth": drained_depth,
        },
        "distillation": {
            "outcomes_harvested": harvested,
            "distill_steps": distiller.steps,
            "loss_first": round(loss_first, 4),
            "loss_last": round(loss_last, 4),
            "frozen_acceptance": round(frozen_rate, 4),
            "distilled_acceptance": round(distilled_rate, 4),
            "parity_preserved": True,
        },
        "ok": True,
    }


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("path", nargs="?", help="metrics JSONL to scan")
    parser.add_argument("--selftest", action="store_true",
                        help="run the hermetic speculation selftest")
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
