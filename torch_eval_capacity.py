"""Capacity x prefix-length conditioning: curriculum + model-size grid.

VERDICT r4 missing #2 / next-round #1: every RL artifact lives at tiny
scale, and PROMPT_FRONTIER_r04 shows tiny-test's rule-conditioning
decaying to noise by a 256-byte realistic prefix while production
prompts are ~1.8k bytes (``convertToLLMMessageService.ts:834-856``
renders the rules at the END of a long assembled system message). The
capacity hypothesis ("a bigger model conditions under the full prompt")
had zero datapoints. This eval puts datapoints on BOTH axes that could
rescue the product premise:

- **Curriculum over prefix length** (VERDICT #7's suggestion): pretrain
  rule-following at prefix 0 (the proven regime), then GROW the
  realistic prefix in stages, reusing the state — each stage only has
  to preserve an attention pattern that already exists, not discover it
  ~2k tokens from the completion. Direct-at-length training is what the
  r4 frontier measured failing; the curriculum is the recipe a
  production system would actually use (it mirrors how the reference's
  rules section rides on top of an ever-growing prompt).
- **Model size**: the same recipe (direct or curriculum) on
  ``small-test`` (4L x d128, 8 heads) vs ``tiny-test`` (2L x d64) —
  does the frontier move right with capacity alone?

Probes are held-out (user text never seen in training) at the TARGET
prefix: delta = frac_low(rule_low) - frac_low(rule_high) > 0.5 counts
as conditioned — same bar as PROMPT_FRONTIER_r04.

    python torch_eval_capacity.py --model tiny-test --schedule 0,64,192,448,960,1792
    python torch_eval_capacity.py --model small-test --schedule 256      # direct point

Prints ONE JSON line (the CAPACITY_r05 artifact).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from torch_eval_uplift_real import (DECOY_RULE, RULE_HIGH, RULE_LOW,
                                    load_policy, minimal_sysmsg,
                                    pretrain_rule_policy,
                                    pretrain_with_retries, probe_frac_low,
                                    realistic_prefix)

PROBE_TEXT = "write the response bytes"   # held out from PRETRAIN_TEXTS


def probe_suite(engine, tok, prefix_bytes: int, *, episodes: int = 8) -> dict:
    out = {}
    for name, rules in (("rule_low", [RULE_LOW]), ("rule_high", [RULE_HIGH]),
                        ("no_rules", []), ("decoy", [DECOY_RULE])):
        out[name] = round(probe_frac_low(
            engine, tok, rules, prefix_bytes=prefix_bytes,
            episodes=episodes, user_text=PROBE_TEXT), 4)
    out["delta"] = round(out["rule_low"] - out["rule_high"], 4)
    return out


def run_capacity(*, model: str, schedule, stage0_rounds: int = 40,
                 stage_rounds: int = 30, attempts: int = 3, seed: int = 0,
                 group_size: int = 16, stop_mean: float = 0.9,
                 lr: float = 0.02, save_dir=None,
                 stop_on_unconditioned: bool = False,
                 stage_probe_episodes: int = 4,
                 init_from=None, device="cuda"):
    """Returns (report_dict, final_state, engine, tok).

    Each stage ends with a HELD-OUT probe at its own prefix (cheap,
    ``stage_probe_episodes`` per rule-set) and, when ``save_dir`` is
    given, a per-stage checkpoint under ``save_dir/stage<prefix>`` —
    the r05 tiny run showed a later FAILED stage erases earlier
    conditioning (catastrophic forgetting through 30 unconverged 1792B
    rounds), so evidence and state must be banked as the curriculum
    climbs, not only at the end. ``stop_on_unconditioned`` aborts the
    remaining schedule when a stage's probe delta falls below 0.3
    (churning past a failed stage only destroys what was learned)."""
    t_all = time.monotonic()
    stages = []

    def bank_stage(stage: dict, state) -> dict:
        n = stage["prefix_bytes"]
        p = probe_suite(engine, tok, n, episodes=stage_probe_episodes)
        stage["probe_frac_low"] = p
        stage["probe_delta"] = p["delta"]
        stage["probe_conditioned"] = bool(p["delta"] > 0.5)
        if save_dir:
            from senweaver_ide_tpu_torch.training.checkpoint import \
                CheckpointManager
            CheckpointManager(f"{save_dir}/stage{n}").save(
                state, extra_meta={"eval": "capacity_stage",
                                   "prefix_bytes": n})
        return stage

    # Stage 0: the proven short-prefix regime — either a pre-converged
    # rule-following checkpoint (``init_from``, e.g. the flagship uplift
    # pretrain: skips the seed lottery entirely) or a fresh pretrain
    # with seed retries (convergence is stochastic — ROUND4_NOTES).
    t0 = time.monotonic()
    if init_from:
        state, engine, tok, _cfg = load_policy(init_from, model=model,
                                               seed=seed, lr=lr,
                                               device=device)
        curve, seed_used = [], seed
        tried = [{"loaded_from": init_from}]
    else:
        state, engine, tok, _cfg, curve, seed_used, tried = \
            pretrain_with_retries(max_attempts=attempts, seed=seed,
                                  seed_stride=7, rounds=stage0_rounds,
                                  group_size=group_size, lr=lr,
                                  model=model,
                                  prefix_bytes=int(schedule[0]),
                                  max_len=4096, stop_mean=stop_mean,
                                  device=device)
    stages.append(bank_stage({
        "prefix_bytes": int(schedule[0]), "rounds_run": len(curve),
        "tail_mean": round(sum(curve[-4:]) / max(len(curve[-4:]), 1), 4)
        if curve else None,
        "curve": curve,
        "attempts": tried, "seed_used": seed_used,
        "wall_s": round(time.monotonic() - t0, 1),
    }, state))
    print(f"[capacity] stage {json.dumps(stages[-1])}",
          file=sys.stderr, flush=True)

    # Later stages: grow the prefix, REUSING the trained state — no
    # retries (continuation), generous cap with the same early stop.
    skipped = []
    for n in schedule[1:]:
        if stop_on_unconditioned and stages \
                and stages[-1].get("probe_delta", 1.0) < 0.3:
            skipped.append(int(n))
            continue
        t0 = time.monotonic()
        state, engine, tok, _cfg, curve = pretrain_rule_policy(
            rounds=stage_rounds, lr=lr, seed=seed_used,
            group_size=group_size, model=model, prefix_bytes=int(n),
            max_len=4096, stop_mean=stop_mean,
            state=state, engine=engine, device=device)
        stages.append(bank_stage({
            "prefix_bytes": int(n), "rounds_run": len(curve),
            "tail_mean": round(sum(curve[-4:]) / max(len(curve[-4:]), 1), 4),
            "curve": curve,
            "wall_s": round(time.monotonic() - t0, 1),
        }, state))
        print(f"[capacity] stage {json.dumps(stages[-1])}",
              file=sys.stderr, flush=True)

    target = int(stages[-1]["prefix_bytes"]) if skipped \
        else int(schedule[-1])
    # bank_stage already probed this prefix on this exact state (at the
    # stage budget); the headline probe re-measures at 8 episodes for a
    # tighter estimate only when the budgets differ.
    if stage_probe_episodes >= 8:
        probes = dict(stages[-1]["probe_frac_low"])
    else:
        probes = probe_suite(engine, tok, target)
    # Bonus: does the curriculum preserve short-prompt conditioning?
    probes_at_0 = probe_suite(engine, tok, 0, episodes=4) \
        if target > 0 else None
    report = {
        "metric": f"capacity_conditioning[{model}]",
        "model": model,
        "curriculum": len(schedule) > 1,
        "schedule": [int(n) for n in schedule],
        "stages": stages,
        "target_prefix_bytes": target,
        "target_sysmsg_bytes": len(minimal_sysmsg([RULE_LOW],
                                                  prefix_bytes=target)),
        "full_prompt_bytes": len(realistic_prefix(10 ** 9)),
        "probes_frac_low": probes,
        "conditioning_delta": probes["delta"],
        "conditioned": bool(probes["delta"] > 0.5),
        "probes_at_prefix0": probes_at_0,
        "stages_skipped": skipped,
        "stage_conditioned_up_to": max(
            (s["prefix_bytes"] for s in stages
             if s.get("probe_conditioned")), default=None),
        "probe_user_text": PROBE_TEXT,
        "config": {"stage0_rounds": stage0_rounds,
                   "stage_rounds": stage_rounds, "attempts": attempts,
                   "group_size": group_size, "lr": lr, "seed": seed,
                   "stop_mean": stop_mean,
                   "stop_on_unconditioned": stop_on_unconditioned,
                   "stage_probe_episodes": stage_probe_episodes,
                   "save_dir": save_dir, "init_from": init_from},
        "total_wall_s": round(time.monotonic() - t_all, 1),
    }
    return report, state, engine, tok


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="tiny-test")
    ap.add_argument("--schedule", default="0,64,192,448,960,1792",
                    help="comma-separated prefix-byte stages; a single "
                         "value = direct (no-curriculum) training at "
                         "that prefix")
    ap.add_argument("--stage0-rounds", type=int, default=40)
    ap.add_argument("--stage-rounds", type=int, default=30)
    ap.add_argument("--attempts", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--group-size", type=int, default=16)
    ap.add_argument("--save-dir", default=None,
                    help="checkpoint the final state here")
    ap.add_argument("--accel", action="store_true",
                    help="accepted for the command lines of the JAX "
                         "script; the card is the default already")
    ap.add_argument("--stop-on-unconditioned", action="store_true",
                    help="abort remaining stages when a stage's held-out "
                         "probe delta < 0.3 (don't churn past failure)")
    ap.add_argument("--init-from", default=None,
                    help="stage-0 checkpoint dir (a pre-converged rule "
                         "follower, e.g. a --save-dir of "
                         "torch_eval_uplift_real.py) — skips the "
                         "stage-0 pretrain and its seed lottery")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA card)")
    args = ap.parse_args()

    from senweaver_ide_tpu_torch.device import resolve_device
    device = resolve_device("cpu" if args.cpu else "cuda")

    schedule = [int(x) for x in args.schedule.split(",") if x.strip()]
    report, state, _engine, _tok = run_capacity(
        model=args.model, schedule=schedule,
        stage0_rounds=args.stage0_rounds, stage_rounds=args.stage_rounds,
        attempts=args.attempts, seed=args.seed, group_size=args.group_size,
        save_dir=args.save_dir,
        stop_on_unconditioned=args.stop_on_unconditioned,
        init_from=args.init_from, device=device)
    if args.save_dir:
        from senweaver_ide_tpu_torch.training.checkpoint import CheckpointManager
        CheckpointManager(args.save_dir).save(
            state, extra_meta={"eval": "capacity", "model": args.model,
                               "schedule": schedule})
        report["checkpoint_dir"] = args.save_dir
    print(json.dumps(report))


if __name__ == "__main__":
    try:
        main()
    except Exception as e:   # always leave a JSON line for the caller
        print(json.dumps({"error": f"{type(e).__name__}: {e}"}))
        sys.exit(1)
