"""Quickstart: QLoRA GRPO — int8-quantized frozen base + rank-r
adapters, trained and served on one chip.

This is the single-chip 7B-class recipe scaled down to run anywhere:
full fine-tuning a 6.7B policy needs ~27 GB of fp32-equivalent Adam
moments on top of 13.4 GB bf16 weights; here the base is int8
(models/quantize.py halves its HBM) and only the adapters carry
gradients and optimizer state (training/lora.py). The serving engine
always holds a FOLDED full policy (materialize_lora re-quantizes the
int8 base), so the rollout path is identical to full-FT serving.

    python examples/torch_qlora_quickstart.py [--rounds 3] [--rank 8] [--cpu]

On the card, swap "tiny-test" for "deepseek-coder-6.7b" (or
"qwen3-8b") and point models.load.load_hf_params at a checkpoint dir.
"""
import argparse
import functools
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import torch

from senweaver_ide_tpu_torch.device import resolve_device
from senweaver_ide_tpu_torch.models import (get_config, init_params,
                                      quantize_weights_int8, quantized_bytes)
from senweaver_ide_tpu_torch.models.tokenizer import ByteTokenizer
from senweaver_ide_tpu_torch.rewards.head import score_trace
from senweaver_ide_tpu_torch.rollout import (EnginePolicyClient, RolloutEngine,
                                       RolloutSession)
from senweaver_ide_tpu_torch.training import (grpo_round, lora_param_count,
                                        make_lora_train_state,
                                        materialize_lora)
from senweaver_ide_tpu_torch.traces.collector import TraceCollector

ap = argparse.ArgumentParser()
ap.add_argument("--rounds", type=int, default=3)
ap.add_argument("--rank", type=int, default=8)
ap.add_argument("--cpu", action="store_true",
                help="run on the CPU (default: the CUDA card)")
args = ap.parse_args()
device = resolve_device("cpu" if args.cpu else "cuda")

cfg = get_config("tiny-test")
full = init_params(cfg, torch.Generator(device.type).manual_seed(0),
                   device=device)
base = quantize_weights_int8(full)          # the frozen int8 backbone
state = make_lora_train_state(cfg, base,
                              torch.Generator(device.type).manual_seed(1),
                              rank=args.rank, learning_rate=0.1)
print(f"base: {quantized_bytes(base):,} bytes int8 "
      f"(vs {quantized_bytes(full):,} full) | trainable adapter params: "
      f"{lora_param_count(state.params):,}")

tok = ByteTokenizer()
engine = RolloutEngine(materialize_lora(base, state.params, cfg), cfg,
                       num_slots=4, max_len=2048, eos_id=None, seed=0,
                       device=device)
workdir = tempfile.mkdtemp(prefix="qlora_")


def make_session():
    client = EnginePolicyClient(engine, tok, default_max_new_tokens=8,
                                record_calls=True)
    return RolloutSession(client, f"{workdir}/ws",
                          include_tool_definitions=False,
                          collector=TraceCollector(
                              reward_fn=functools.partial(score_trace,
                                                          device=device)))


def reward(task_idx, g, session):
    out_ids = session.client.call_log[-1][1]
    frac = sum(1 for t in out_ids if t < 128) / max(len(out_ids), 1)
    return 2.0 * frac - 1.0


for r in range(args.rounds):
    # max_len must hold the FULL sampled context (~1.9k-byte assembled
    # prompt + completion): truncating below it would recompute train
    # logps on a different context than the recorded behavior logps
    out = grpo_round(state, cfg, None, make_session, ["write ascii"],
                     group_size=8, pad_id=tok.pad_id, max_len=2048,
                     reward_override=reward, ppo_epochs=2, lora_base=base)
    state = out.state
    engine.update_params(materialize_lora(base, state.params, cfg))
    rewards = [e.reward for e in out.episodes]
    print(f"round {r}: reward_mean={sum(rewards) / len(rewards):+.3f} "
          f"loss={float(out.metrics['loss']):+.4f}")

print("adapters trained; engine serves the folded int8 policy")
