"""Prompt-length conditioning frontier (VERDICT r3 missing #4).

The product premise is that injected '# APO Optimized Rules' steer the
policy from inside a LONG assembled system message
(``convertToLLMMessageService.ts:834-856``). r3 proved rule/task
conditioning at a ~30-byte prompt and a precise NEGATIVE at the full
~1.8k-byte prompt (tiny 2xd64 capacity). This eval measures the
frontier between them: for each prefix length N, pretrain the
rule-following task with N bytes of the REAL assembled prompt ahead of
the rules section (rules stay last, as production places them), then
probe conditioning on a held-out user text.

The output is a capacity/placement curve — at what prompt length does
tiny-scale conditioning break, and how gradually — the measured
counterpart of r3's single-point negative. The chip queue's small-test
run covers the capacity axis; this covers the length axis on CPU.

    python torch_eval_prompt_frontier.py [--lengths 0,256,512,1024,1792] [--cpu]

Prints ONE JSON line (the PROMPT_FRONTIER_r04 artifact).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from torch_eval_uplift_real import (RULE_HIGH, RULE_LOW, minimal_sysmsg,
                                    pretrain_with_retries, probe_frac_low,
                                    realistic_prefix)


def run_frontier(lengths, *, rounds: int = 60, attempts: int = 2,
                 seed: int = 0, group_size: int = 16,
                 device="cuda") -> dict:
    points = []
    for n in lengths:
        t0 = time.monotonic()
        _st, engine, tok, _cfg, curve, _seed, tried = \
            pretrain_with_retries(max_attempts=attempts, seed=seed,
                                  seed_stride=7, rounds=rounds,
                                  group_size=group_size, prefix_bytes=n,
                                  device=device)
        tail = sum(curve[-4:]) / max(len(curve[-4:]), 1)
        rounds_run = len(curve)
        probes = {
            "rule_low": probe_frac_low(engine, tok, [RULE_LOW],
                                       prefix_bytes=n),
            "rule_high": probe_frac_low(engine, tok, [RULE_HIGH],
                                        prefix_bytes=n),
        }
        delta = probes["rule_low"] - probes["rule_high"]
        point = {
            "prefix_bytes": n,
            "sysmsg_bytes": len(minimal_sysmsg([RULE_LOW],
                                               prefix_bytes=n)),
            "train_tail_mean": round(tail, 4),
            "attempt_tails": [a["final_window_mean"] for a in tried],
            "rounds_run": rounds_run,
            "probe_frac_low": {k: round(v, 4) for k, v in probes.items()},
            "conditioning_delta": round(delta, 4),
            "conditioned": bool(delta > 0.5),
            "wall_s": round(time.monotonic() - t0, 1),
        }
        points.append(point)
        # Full per-point record to stderr as soon as it exists: a
        # multi-hour frontier run must not lose finished points to a
        # crash/timeout of a later one.
        print(f"[frontier] point {json.dumps(point)}",
              file=sys.stderr, flush=True)
    conditioned_up_to = max((p["prefix_bytes"] for p in points
                             if p["conditioned"]), default=None)
    first_break = next((p["prefix_bytes"] for p in points
                        if not p["conditioned"]), None)
    return {
        "metric": "prompt_length_conditioning_frontier[tiny-test]",
        "points": points,
        "conditioned_up_to_bytes": conditioned_up_to,
        "first_unconditioned_bytes": first_break,
        "full_prompt_bytes": len(realistic_prefix(10 ** 9)),
        "policy": "tiny-test (2xd64); rules LAST as in production "
                  "assembly; conditioning signal = rules section only",
        "config": {"rounds_cap": rounds, "attempts_per_point": attempts,
                   "group_size": group_size, "seed": seed},
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--lengths", default="0,256,512,1024,1792")
    ap.add_argument("--rounds", type=int, default=60)
    ap.add_argument("--attempts", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA card)")
    args = ap.parse_args()

    from senweaver_ide_tpu_torch.device import resolve_device
    device = resolve_device("cpu" if args.cpu else "cuda")

    lengths = [int(x) for x in args.lengths.split(",") if x.strip()]
    report = run_frontier(lengths, rounds=args.rounds,
                          attempts=args.attempts, seed=args.seed,
                          device=device)
    print(json.dumps(report))


if __name__ == "__main__":
    try:
        main()
    except Exception as e:   # always leave a JSON line for the caller
        print(json.dumps({"error": f"{type(e).__name__}: {e}"}))
        sys.exit(1)
