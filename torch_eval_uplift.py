"""North-star uplift eval: baseline vs post-APO finalReward.

Runs the full local APO cycle (baseline rollouts → textual-gradient beam
search with prompt-conditioned candidate scoring → re-roll under winning
rules) on the 6-pattern task suite and prints ONE JSON line with both
scores (BASELINE north star: ≥2× finalReward vs the un-optimized prompt).

Offline by default via the deterministic RuleSensitivePolicy
(apo/eval.py); pass a local HF checkpoint dir to drive the REAL policy:

    python torch_eval_uplift.py [--model-dir /path/to/qwen2.5-coder-1.5b] [--cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model-dir", default=None,
                    help="local HF-layout checkpoint; default = scripted "
                         "hermetic policy")
    ap.add_argument("--config", default="qwen2.5-coder-1.5b",
                    help="ModelConfig preset the checkpoint matches "
                         "(models/config.py PRESETS; e.g. tiny-test for "
                         "the fixture checkpoint)")
    ap.add_argument("--beam-rounds", type=int, default=3)
    ap.add_argument("--max-new-tokens", type=int, default=256,
                    help="per-call decode budget for the real policy")
    ap.add_argument("--tasks", type=int, default=None,
                    help="run only the first N pattern tasks (smoke runs)")
    ap.add_argument("--engine-max-len", type=int, default=4096,
                    help="serving context bound for the real policy")
    ap.add_argument("--holdout", action="store_true",
                    help="scripted optimizer proposes from the hold-out "
                         "rule bank (beam must search, not be handed the "
                         "winner)")
    ap.add_argument("--proposal-seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA card)")
    args = ap.parse_args()

    # The scripted policy's only device work is the reward head; the
    # real policy's engine and the head both run on the run's device.
    from senweaver_ide_tpu_torch.device import resolve_device
    device = resolve_device("cpu" if args.cpu else "cuda")

    from senweaver_ide_tpu_torch.apo import run_uplift_eval

    client = None
    if args.model_dir:
        from senweaver_ide_tpu_torch.models import (get_config, load_hf_params,
                                              load_tokenizer)
        from senweaver_ide_tpu_torch.rollout import (EnginePolicyClient,
                                               RolloutEngine)
        config = get_config(args.config)
        params = load_hf_params(args.model_dir, config, device=device)
        engine = RolloutEngine(params, config, max_len=args.engine_max_len,
                               device=device)
        client = EnginePolicyClient(engine, load_tokenizer(args.model_dir),
                                    default_max_new_tokens=args.max_new_tokens,
                                    record_calls=False)

    from senweaver_ide_tpu_torch.apo.eval import SIX_PATTERN_TASKS
    tasks = tuple(SIX_PATTERN_TASKS[:args.tasks] if args.tasks
                  else SIX_PATTERN_TASKS)
    with tempfile.TemporaryDirectory() as workdir:
        report = run_uplift_eval(workdir, client=client, tasks=tasks,
                                 beam_rounds=args.beam_rounds,
                                 holdout=args.holdout,
                                 proposal_seed=args.proposal_seed,
                                 device=device)
    if args.model_dir:
        report["policy"] = {"model_dir": args.model_dir,
                            "config": args.config,
                            "max_new_tokens": args.max_new_tokens}
    # Per-round training-health trace (obs/training_health.py): APO is
    # prompt-space only, so the ring is empty unless an in-process
    # weight-training phase ran this process — but when one did, the
    # uplift artifact carries its health alongside the scores.
    from senweaver_ide_tpu_torch.obs import get_health_monitor
    monitor = get_health_monitor()
    report["training_health"] = {"rounds": monitor.history(),
                                 "summary": monitor.summary()}
    print(json.dumps(report))


if __name__ == "__main__":
    try:
        main()
    except Exception as e:  # always leave a JSON line
        print(json.dumps({"error": f"{type(e).__name__}: {e}"}))
        sys.exit(1)
