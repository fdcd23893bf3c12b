"""De-lottery the flagship pretrain: config sweep on the HARD seeds.

VERDICT r4 weak #2 / next-round #7: the rule-following pretrain behind
the 2.06x headline converges in ~2 of 9 seeds at the proven recipe
(2 groups x 16, lr 0.02, 80-round cap), and a seed-10/11/12 attempt
found NONE — best-of-N retries handle it honestly but the pipeline is a
lottery. This sweep measures what moves the convergence rate, on
exactly those previously-all-failing seeds (10, 11, 12): a config that
converges where the baseline went 0/3 is evidence, not luck.

Swept axes (cheap, mechanism-motivated):
  baseline   : the r4 recipe (control)
  entropy    : entropy_coef 0.05 (vs 0.02) — hold exploration open
               through the contrastive see-saw phase
  group32    : group_size 32 — 2x contrastive signal per round
  lr_hi      : lr 0.04 — cross the saddle before the cap

Convergence bar matches pretrain_with_retries: final 4-round window
mean >= 0.75. Each cell records rounds-to-stop and the tail curve.

    python torch_eval_seed_robustness.py [--seeds 10,11,12] [--rounds 80] [--cpu]

Prints ONE JSON line (the SEED_ROBUSTNESS_r05 artifact).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from torch_eval_uplift_real import pretrain_rule_policy

CONFIGS = {
    "baseline": {},
    "entropy": {"entropy_coef": 0.05},
    "group32": {"group_size": 32},
    "lr_hi": {"lr": 0.04},
}


def run_cell(name: str, seed: int, *, rounds: int, base_group: int,
             device="cuda") -> dict:
    kw = dict(CONFIGS[name])
    group_size = kw.pop("group_size", base_group)
    lr = kw.pop("lr", 0.02)
    entropy = kw.pop("entropy_coef", 0.02)
    t0 = time.monotonic()
    state, engine, tok, cfg, curve = pretrain_rule_policy(
        rounds=rounds, seed=seed, group_size=group_size, lr=lr,
        entropy_coef=entropy, device=device)
    tail = sum(curve[-4:]) / max(len(curve[-4:]), 1)
    return {
        "config": name, "seed": seed,
        "converged": bool(tail >= 0.75),
        "tail_mean": round(tail, 4),
        "rounds_run": len(curve),
        "curve_tail": curve[-6:],
        "wall_s": round(time.monotonic() - t0, 1),
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", default="10,11,12")
    ap.add_argument("--rounds", type=int, default=80)
    ap.add_argument("--configs", default="baseline,entropy,group32,lr_hi")
    ap.add_argument("--group-size", type=int, default=16)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA card)")
    args = ap.parse_args()

    from senweaver_ide_tpu_torch.device import resolve_device
    device = resolve_device("cpu" if args.cpu else "cuda")

    seeds = [int(s) for s in args.seeds.split(",") if s.strip()]
    names = [c for c in args.configs.split(",") if c.strip()]
    cells = []
    for name in names:
        for seed in seeds:
            cell = run_cell(name, seed, rounds=args.rounds,
                            base_group=args.group_size, device=device)
            cells.append(cell)
            print(f"[robustness] {json.dumps(cell)}",
                  file=sys.stderr, flush=True)
    by_cfg = {}
    for name in names:
        mine = [c for c in cells if c["config"] == name]
        by_cfg[name] = {
            "converged": sum(c["converged"] for c in mine),
            "of": len(mine),
            "mean_rounds": round(sum(c["rounds_run"] for c in mine)
                                 / max(len(mine), 1), 1),
        }
    best = max(by_cfg,
               key=lambda n: (by_cfg[n]["converged"],
                              -by_cfg[n]["mean_rounds"]))
    print(json.dumps({
        "metric": "pretrain_seed_robustness",
        "seeds": seeds,
        "note": "seeds 10/11/12 all FAILED the r4 baseline recipe "
                "(ROUND4_NOTES engineering notes) — any convergence "
                "here is a config effect, not seed luck",
        "cells": cells,
        "by_config": by_cfg,
        "best_config": best,
        "rounds_cap": args.rounds,
        "convergence_bar": "final 4-round window mean >= 0.75",
    }))


if __name__ == "__main__":
    try:
        main()
    except Exception as e:   # always leave a JSON line for the caller
        print(json.dumps({"error": f"{type(e).__name__}: {e}"}))
        sys.exit(1)
