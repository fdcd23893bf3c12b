"""A speculative-decoding artifact: online draft learning
raises the acceptance rate while outputs stay exactly the target's.

r2 recorded acceptance gains only in free-form notes; this
script reproduces them as a JSON artifact. A tiny target serves greedy
completions through the SpeculativeDecoder with an UNRELATED tiny draft
(low initial acceptance); OnlineDraftLearner distills the draft on the
served (prompt, output) pairs (the FastGRPO posture: the draft tracks a
drifting policy from exactly what it serves); acceptance is re-measured
on the same prompt distribution. Exactness is asserted, not hoped:
greedy outputs before == after (speculation never changes the output
distribution — only throughput moves).

    python torch_eval_speculative.py [--prompts 8] [--distill-steps 80] [--cpu]
"""

from __future__ import annotations

import argparse
import json
import sys


def run_speculative_eval(*, n_prompts: int = 8, max_new_tokens: int = 12,
                         k: int = 4, distill_steps: int = 80,
                         lr: float = 3e-2, seed: int = 0,
                         device="cuda") -> dict:
    import dataclasses

    import torch
    import numpy as np

    from senweaver_ide_tpu_torch.device import resolve_device

    from senweaver_ide_tpu_torch.models import get_config, init_params
    from senweaver_ide_tpu_torch.rollout.speculative import (OnlineDraftLearner,
                                                       SpeculativeDecoder)

    tc = get_config("tiny-test")
    dc = dataclasses.replace(tc, num_layers=1, name="tiny-draft")
    dev = resolve_device(device)
    tp = init_params(tc, torch.Generator(device=dev.type).manual_seed(seed),
                     device=dev)
    dp = init_params(dc, torch.Generator(device=dev.type).manual_seed(
        seed + 99), device=dev)                          # unrelated init
    dec = SpeculativeDecoder(tp, tc, dp, dc, k=k)
    learner = OnlineDraftLearner(dec, learning_rate=lr, seed=seed)

    rng = np.random.default_rng(seed)
    prompts = [[int(x) for x in rng.integers(1, 400, 6)]
               for _ in range(n_prompts)]

    def serve_all():
        return [dec.generate(p, max_new_tokens=max_new_tokens)
                for p in prompts]

    base_out = serve_all()
    acceptance_before = dec.acceptance_rate
    rounds_before = dec.rounds

    for p, out in zip(prompts, base_out):
        learner.observe(p, out)
    losses = [learner.step(batch_size=4) for _ in range(distill_steps)]

    dec.rounds = dec.accepted = dec.proposed = 0
    new_out = serve_all()
    acceptance_after = dec.acceptance_rate

    return {
        "metric": "speculative_acceptance[tiny target, distilled draft]",
        "acceptance_before": round(acceptance_before, 4),
        "acceptance_after": round(acceptance_after, 4),
        "gain": round(acceptance_after - acceptance_before, 4),
        "verify_rounds_before": rounds_before,
        "verify_rounds_after": dec.rounds,
        "outputs_exact": bool(new_out == base_out),
        "distill_loss_first": round(float(losses[0]), 4),
        "distill_loss_last": round(float(losses[-1]), 4),
        "config": {"k": k, "prompts": n_prompts,
                   "max_new_tokens": max_new_tokens,
                   "distill_steps": distill_steps, "lr": lr,
                   "seed": seed},
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--prompts", type=int, default=8)
    ap.add_argument("--max-new-tokens", type=int, default=12)
    ap.add_argument("--k", type=int, default=4)
    ap.add_argument("--distill-steps", type=int, default=80)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA card)")
    args = ap.parse_args()

    from senweaver_ide_tpu_torch.device import resolve_device
    device = resolve_device("cpu" if args.cpu else "cuda")

    print(json.dumps(run_speculative_eval(
        n_prompts=args.prompts, max_new_tokens=args.max_new_tokens,
        k=args.k, distill_steps=args.distill_steps, seed=args.seed,
        device=device)))


if __name__ == "__main__":
    try:
        main()
    except Exception as e:   # always leave a JSON line
        print(json.dumps({"error": f"{type(e).__name__}: {e}"}))
        sys.exit(1)
