#!/usr/bin/env python3
"""Group-shared rollout / tree-branching report: JSONL summary or a
hermetic selftest of the shared-KV rollout plane (group-rollout
acceptance).

Usage::

    python scripts/group_tree_report.py metrics.jsonl
    python scripts/group_tree_report.py --selftest

Companion to ``scripts/kv_pressure_report.py`` (memory plane) — this
one answers "what did GROUP SHARING do?": prefills paid vs avoided,
forks and COW splits, branch events, and degrade counts.

Two modes:

- **JSONL**: scans a metrics JSONL for engine group/fork counter
  fields and emits the last observed values.
- **--selftest**: hermetic card/CPU proof, zero infrastructure (CI runs it
  after the group-rollout test job):

  1. *One prefill per group*: a G=8 group decodes bitwise-identical
     to 8 independent submits while the engine's prefill counter
     reads exactly 1, and the pool drains leak-free.
  2. *Tree exactness*: a BranchPolicy-driven rollout tree (sampled +
     forced branches, depth 2) where every leaf's suffix equals an
     independent decode of its full stream.
  3. *Degrade honesty*: donor death before spine capture falls back
     to unshared prefills — same outputs, ``group_degrades`` counted,
     still leak-free.
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

GROUP_FIELDS = ("engine_group_prefills", "engine_group_forks",
                "engine_branch_forks",
                "engine_group_prefill_tokens_avoided",
                "engine_group_degrades", "engine_kv_cow_copies",
                "engine_prefills")


def summarize_jsonl(path: str) -> Dict[str, Any]:
    from senweaver_ide_tpu_torch.services.metrics import load_jsonl_metrics

    last: Dict[str, Any] = {}
    events = 0
    for e in load_jsonl_metrics(path):
        p = e.get("properties", e)
        hit = False
        for f in GROUP_FIELDS:
            if f in p:
                last[f] = p[f]
                hit = True
        events += hit
    return {"mode": "jsonl", "path": path, "events_with_group": events,
            **{f: last.get(f) for f in GROUP_FIELDS}}


@preserved_obs()
def selftest(device="cuda") -> Dict[str, Any]:
    """Hermetic proof of the shared-rollout invariants; raises on any
    violation (non-zero exit for CI)."""
    device = resolve_device(device)
    import torch

    from senweaver_ide_tpu_torch import obs
    from senweaver_ide_tpu_torch.models import (init_params, params_from_numpy,
                                                tiny_test)
    from senweaver_ide_tpu_torch.rollout import (BranchPolicy, EngineConfig,
                                           GroupRollout, RolloutEngine)
    from senweaver_ide_tpu_torch.rollout.sampler import SampleParams

    greedy = SampleParams(temperature=0.0, top_k=0, top_p=1.0)
    config = tiny_test()
    params = params_from_numpy(init_params(
        config, torch.Generator().manual_seed(0), device="cpu"),
        device=device)
    prompt = [5, 9, 2, 7, 1, 3]

    def engine(num_slots=8):
        return RolloutEngine(params, config, num_slots=num_slots,
                             max_len=96, sample=greedy, device=device,
                             engine_config=EngineConfig(
                                 kv_layout="paged", block_size=4))

    def independent(stream, max_new):
        eng = engine(num_slots=2)
        rid = eng.submit(list(stream), max_new_tokens=max_new)
        return eng.run()[rid]

    # -- 1. one prefill per group, bitwise-exact ---------------------------
    obs._reset_for_tests()
    ref = independent(prompt, 12)
    eng = engine()
    rids = eng.submit_group(prompt, 8, max_new_tokens=12)
    out = eng.run()
    for r in rids:
        assert out[r] == ref, "group member diverged from the reference"
    st = eng.stats()
    assert st["prefills"] == 1, \
        f"G=8 group paid {st['prefills']} prefills, wanted exactly 1"
    assert st["group_prefills"] == 1 and st["group_forks"] == 7
    assert st["group_degrades"] == 0
    eng._alloc.check_leaks()

    group = {
        "group_size": 8,
        "prefills": st["prefills"],
        "group_forks": st["group_forks"],
        "prefill_tokens_avoided": st["group_prefill_tokens_avoided"],
        "cow_copies": st["kv_cow_copies"],
        "bitwise_exact": True,
        "leaks_clean": True,
    }

    # -- 2. tree exactness at depth, sampled + forced ----------------------
    obs._reset_for_tests()
    eng = engine()
    trigger = int(ref[2])
    planner = GroupRollout(eng, policy=BranchPolicy(
        max_leaves=6, max_depth=2, branch_width=2,
        min_tokens_between=1, branch_tokens=(trigger,)))
    gid = planner.submit_group(prompt, 2, max_new_tokens=12)
    planner.run()
    recs = planner.collect(gid)
    assert len(recs) > 2, "branch policy never fired"
    assert any(r["depth"] > 0 for r in recs)
    for rec in recs:
        leaf = planner._leaves[rec["rid"]]
        stream = list(prompt) + list(leaf.inherited)
        own = eng.result(rec["rid"])
        assert own == independent(stream, len(own)), \
            f"leaf rid={rec['rid']} depth={rec['depth']} diverged"
    stats = planner.branch_stats()
    eng._alloc.check_leaks()

    tree = {
        "leaves": stats["leaves"],
        "branched_leaves": stats["branched_leaves"],
        "max_depth": stats["max_depth"],
        "branch_events": stats["branch_events"],
        "every_leaf_exact": True,
        "leaks_clean": True,
    }

    # -- 3. donor death degrades honestly ----------------------------------
    obs._reset_for_tests()
    eng = engine()
    rids = eng.submit_group(prompt, 3, max_new_tokens=8)
    assert eng.release_request(rids[0])      # donor dies pre-capture
    out = eng.run()
    ref8 = independent(prompt, 8)
    for r in rids[1:]:
        assert out[r] == ref8, "degraded follower diverged"
    st3 = eng.stats()
    assert st3["group_degrades"] == 1 and st3["group_prefills"] == 0
    eng._alloc.check_leaks()

    degrade = {
        "group_degrades": st3["group_degrades"],
        "followers_exact": True,
        "leaks_clean": True,
    }

    return {
        "mode": "selftest",
        "group_shared_prefill": group,
        "tree_branching": tree,
        "donor_death_degrade": degrade,
        "ok": True,
    }


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("path", nargs="?", help="metrics JSONL to scan")
    parser.add_argument("--selftest", action="store_true",
                        help="run the hermetic group-rollout selftest")
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
