"""North-star learning proof: GRPO weight updates raise episode reward.

The reference's whole premise is an optimizer loop that makes the agent
measurably better (``apoService.ts:992-1215`` scores candidate prompts
and applies the winners); the TPU build upgrades that loop to WEIGHT
updates. This eval is the existence proof the r2 verdict demanded: N
rounds of ``grpo_round`` on the tiny policy, each episode driven through
the REAL stack — RolloutSession over the continuous-batching engine,
real sampled tokens, recorded sample-time behavior logps — against a
hermetic reward with learnable ground truth (emit printable ASCII:
reward = 2·frac(bytes < 128) − 1, base rate ~25% at random init, a
RuleSensitivePolicy-style "better policy exists" structure expressed in
token space). Prints ONE JSON line with the per-round reward curve:

    python torch_eval_learning.py [--rounds 12] [--lr 0.02] [--group-size 16] [--cpu]

Success criterion (asserted by tests/test_learning.py): the final-window
mean reward exceeds the initial-window mean by a wide margin.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time


def run_learning_eval(*, rounds: int = 12, lr: float = 0.02,
                      group_size: int = 16, max_new_tokens: int = 16,
                      ppo_epochs: int = 2, seed: int = 0,
                      window: int = 2, max_parallel: int = 8,
                      contextual: bool = False,
                      model: str = "tiny-test",
                      lora_rank: int = 0,
                      qlora: bool = False,
                      short_prompt: bool = False,
                      anchor_kl: float = 0.0,
                      anchor_every: int = 5,
                      capture: dict = None, device="cuda") -> dict:
    import torch

    from senweaver_ide_tpu_torch.device import resolve_device
    from senweaver_ide_tpu_torch.models import get_config
    from senweaver_ide_tpu_torch.models.tokenizer import ByteTokenizer
    from senweaver_ide_tpu_torch.rollout import (EnginePolicyClient, RolloutEngine,
                                           RolloutSession)
    from senweaver_ide_tpu_torch.training import (grpo_round, make_lora_train_state,
                                            make_train_state,
                                            materialize_lora)
    from senweaver_ide_tpu_torch.training.grpo import GRPOConfig
    from torch_eval_uplift_real import device_collector

    dev = resolve_device(device)

    def generator(s):
        return torch.Generator(device=dev.type).manual_seed(s)

    if qlora and lora_rank <= 0:
        raise ValueError("qlora requires lora_rank > 0 (adapters over an "
                         "int8 base); a full-FT run cannot be QLoRA")
    config = get_config(model)
    # lora_rank > 0: the adapter-only variant of the same proof — the
    # frozen base plus rank-r factors must STILL climb the curve (the
    # single-chip 7B-class training path; training/lora.py).
    lora_base = None
    if lora_rank > 0:
        from senweaver_ide_tpu_torch.models import init_params
        lora_base = init_params(config, generator(seed), device=dev)
        if qlora:
            # QLoRA: the frozen base is int8 (models/quantize.py) and
            # stays int8 through serving — materialize_lora folds the
            # trained adapters back into an int8 tree, so the engine
            # runs the same weight-quantized path the 6.7B plan uses.
            from senweaver_ide_tpu_torch.models.quantize import \
                quantize_weights_int8
            lora_base = quantize_weights_int8(lora_base)
        state = make_lora_train_state(config, lora_base,
                                     generator(seed + 1),
                                     rank=lora_rank, learning_rate=lr)
    else:
        state = make_train_state(config, generator(seed), None,
                                 learning_rate=lr, device=dev)
    tok = ByteTokenizer()
    workdir = tempfile.mkdtemp(prefix="learn_")

    def serving_params(p):
        """What the engine serves: the folded full policy under LoRA,
        the train params themselves otherwise — ONE definition so the
        initial engine weights and per-round publishes cannot diverge."""
        return (materialize_lora(lora_base, p, config)
                if lora_base is not None else p)

    # eos_id=None: fixed-length completions — reward reflects token
    # CONTENT only, not length noise.
    engine = RolloutEngine(serving_params(state.params), config,
                           num_slots=8, max_len=4096,
                           eos_id=None, seed=seed, device=dev)

    # short_prompt: pin the system message to ~30 bytes, isolating
    # PROMPT LENGTH from model capacity — the contextual 2-task mode at
    # tiny scale approaches but never crosses reward 0 with the task
    # tokens trailing an ~1.8k-byte assembled prompt (ROUND3_NOTES.md
    # §16); if the same model crosses 0 here, attention dilution over
    # the long prefix (not the 2x64 capacity) is the binding factor.
    override = "You are a byte emitter." if short_prompt else None

    def make_session():
        client = EnginePolicyClient(engine, tok,
                                    default_max_new_tokens=max_new_tokens,
                                    record_calls=True, auto_prefix=True)
        return RolloutSession(client, f"{workdir}/ws",
                              include_tool_definitions=False,
                              system_message_override=override,
                              collector=device_collector(dev))

    # Contextual mode: two tasks with CONTRASTIVE target classes (low
    # vs high byte half, 25% base rate each, mutually exclusive) — the
    # policy must CONDITION on the prompt, not just learn a global
    # emission bias. Group advantages are per task, so each task pushes
    # its own class; early rounds see-saw between unconditional biases
    # before the routing separates.
    if contextual:
        tasks = ["write plain ascii text", "write binary bytes"]
        classes = [set(range(0, 128)), set(range(128, 256))]
    else:
        tasks = ["write plain ascii text"]
        classes = [set(range(0, 128))]

    def reward(task_idx, g, session):
        out_ids = session.client.call_log[-1][1]
        if not out_ids:
            return -1.0
        frac = sum(1 for t in out_ids
                   if t in classes[task_idx]) / len(out_ids)
        return 2.0 * frac - 1.0

    # Contextual mode NEEDS the entropy bonus: without it the policy
    # collapses into one task's unconditional bias, the starved task's
    # rewards go uniform, and its advantage signal vanishes (observed;
    # see ROUND3_NOTES.md §16).
    # anchor_kl > 0: k3-KL toward a ROLLING snapshot of the policy
    # (refreshed every anchor_every rounds) — the stabilizer for the
    # conditioning collapse observed in long unanchored contextual runs
    # (ROUND3_NOTES.md §23): the anchor lets the policy keep improving
    # slowly but penalizes rapid drift away from its recent self.
    gcfg = GRPOConfig(kl_coef=anchor_kl,
                      entropy_coef=0.02 if contextual else 0.0)
    anchor = serving_params(state.params) if anchor_kl > 0 else None

    curve = []
    per_task = []
    health_series = []
    health_trigger_counts: dict = {}
    t0 = time.monotonic()
    for r in range(rounds):
        out = grpo_round(state, config, None, make_session, tasks,
                         group_size=group_size,
                         pad_id=tok.pad_id, max_len=2048,
                         grpo_config=gcfg,
                         ppo_epochs=ppo_epochs, max_parallel=max_parallel,
                         reward_override=reward, lora_base=lora_base,
                         ref_params=anchor)
        state = out.state
        # Publish the updated weights to the serving engine — the same
        # actor/learner weight sync the async trainer does at round
        # boundaries; without it every round samples the initial policy.
        served = serving_params(state.params)
        engine.update_params(served)
        # anchor_every=0 means a FIXED anchor (never refreshed); the
        # refresh reuses the already-folded serving view
        if (anchor is not None and anchor_every > 0
                and (r + 1) % anchor_every == 0):
            anchor = served
        by_task = [[e.reward for e in out.episodes if e.task_idx == i]
                   for i in range(len(tasks))]
        means = [sum(v) / max(len(v), 1) for v in by_task]
        curve.append(round(sum(means) / len(means), 4))
        per_task.append([round(m, 4) for m in means])
        # Per-round training-health snapshot (training/diagnostics.py):
        # the learning proof doubles as a health trace — a passing curve
        # with a collapsing rank spectrum is worth knowing about.
        if out.health:
            health_series.append({
                "round": r,
                "health": {k: round(v, 6)
                           for k, v in out.health.items()},
                "triggers": list(out.health_triggers),
                "events": list(out.health_events),
            })
            for t in out.health_triggers:
                health_trigger_counts[t] = \
                    health_trigger_counts.get(t, 0) + 1

    if capture is not None:
        # Downstream evals (e.g. eval_moe_int8's trained-router int8
        # comparison) need the TRAINED policy itself, not just the
        # curve: hand back the final serving view.
        capture["params"] = serving_params(state.params)
    w = max(1, min(window, len(curve) // 2))
    initial = sum(curve[:w]) / w
    final = sum(curve[-w:]) / w
    name = "contextual-2task" if contextual else "ascii-task"
    report = {
        "metric": f"grpo_reward_curve[{model},{name}]",
        "rounds": rounds,
        "curve": curve,
        "reward_initial": round(initial, 4),
        "reward_final": round(final, 4),
        "uplift": round(final - initial, 4),
        "learned": bool(final > initial + 0.5),
        "config": {"lr": lr, "group_size": group_size,
                   "max_new_tokens": max_new_tokens,
                   "ppo_epochs": ppo_epochs, "seed": seed,
                   "contextual": contextual, "model": model,
                   "lora_rank": lora_rank, "qlora": qlora,
                   "short_prompt": short_prompt,
                   "anchor_kl": anchor_kl, "anchor_every": anchor_every},
        "wall_s": round(time.monotonic() - t0, 1),
        "training_health": {
            "rounds": health_series,
            "trigger_counts": health_trigger_counts,
        },
    }
    if contextual:
        report["per_task_curve"] = per_task
        # Conditioning proof #1 (peak): any UNCONDITIONAL policy has
        # mean reward <= 0 (the two target classes partition the byte
        # space, so bias toward one is the other's loss) — a sustained
        # window of mean near +1 is only reachable by prompt-CONDITIONAL
        # emission. Report the best width-w window and flag > 0.3.
        peak = (max(sum(curve[i:i + w]) / w
                    for i in range(len(curve) - w + 1))
                if len(curve) >= w else sum(curve) / max(len(curve), 1))
        report["peak_window_mean"] = round(peak, 4)
        report["conditioned"] = bool(peak > 0.3)
        # Conditioning proof #2 (endpoint): BOTH contrastive tasks end
        # above their start — a global bias can only raise one at the
        # other's expense. Window-averaged like reward_initial/final (a
        # single noisy round must not flip the headline flag).
        def _task_mean(rows, i):
            return sum(r[i] for r in rows) / len(rows)

        report["both_tasks_improved"] = bool(all(
            _task_mean(per_task[-w:], i) > _task_mean(per_task[:w], i) + 0.3
            for i in range(len(tasks))))
    return report


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=12)
    ap.add_argument("--lr", type=float, default=0.02)
    ap.add_argument("--group-size", type=int, default=16)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--ppo-epochs", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--contextual", action="store_true",
                    help="two contrastive tasks: the policy must learn "
                         "prompt-CONDITIONAL emission, not a global bias")
    ap.add_argument("--anchor-kl", type=float, default=0.0,
                    help="k3-KL coefficient toward a rolling policy "
                         "snapshot (0 = unanchored)")
    ap.add_argument("--anchor-every", type=int, default=5,
                    help="rounds between anchor refreshes")
    ap.add_argument("--short-prompt", action="store_true",
                    help="pin a ~30-byte system message (isolates prompt "
                         "length from capacity in the contextual mode)")
    ap.add_argument("--lora-rank", type=int, default=0,
                    help="train rank-r LoRA adapters on a frozen base "
                         "instead of full fine-tuning (0 = full)")
    ap.add_argument("--qlora", action="store_true",
                    help="int8-quantize the frozen LoRA base (requires "
                         "--lora-rank > 0): adapters train bf16, the "
                         "engine serves the int8 fold")
    ap.add_argument("--model", default="tiny-test",
                    help="model preset (small-test for the contextual "
                         "capacity run)")
    ap.add_argument("--accel", action="store_true",
                    help="accepted for the command lines of the JAX "
                         "script; the card is the default already")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA card)")
    args = ap.parse_args()

    from senweaver_ide_tpu_torch.device import resolve_device
    device = resolve_device("cpu" if args.cpu else "cuda")

    report = run_learning_eval(rounds=args.rounds, lr=args.lr,
                               group_size=args.group_size,
                               max_new_tokens=args.max_new_tokens,
                               ppo_epochs=args.ppo_epochs, seed=args.seed,
                               contextual=args.contextual,
                               model=args.model, lora_rank=args.lora_rank,
                               qlora=args.qlora,
                               short_prompt=args.short_prompt,
                               anchor_kl=args.anchor_kl,
                               anchor_every=args.anchor_every,
                               device=device)
    print(json.dumps(report))


if __name__ == "__main__":
    try:
        main()
    except Exception as e:   # always leave a JSON line for the caller
        print(json.dumps({"error": f"{type(e).__name__}: {e}"}))
        sys.exit(1)
