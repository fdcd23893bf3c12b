"""Quickstart: one closed GRPO round, fully offline.

Rolls the 6-pattern task suite through hermetic agent sessions (the
deterministic RuleSensitivePolicy — no network, no checkpoint), scores
traces with the 9-dim reward head, and takes one group-relative update
on the tiny policy. Swap in EnginePolicyClient + load_hf_params for the
real thing (see eval_uplift.py --model-dir).

    python examples/torch_train_grpo.py [--cpu]
"""
import argparse
import functools
import itertools
import os
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA card)")
    args = ap.parse_args()

    import torch
    from senweaver_ide_tpu_torch.device import resolve_device

    from senweaver_ide_tpu_torch.apo.eval import (SIX_PATTERN_TASKS,
                                            RuleSensitivePolicy)
    from senweaver_ide_tpu_torch.models import get_config
    from senweaver_ide_tpu_torch.models.tokenizer import ByteTokenizer
    from senweaver_ide_tpu_torch.rewards.head import score_trace
    from senweaver_ide_tpu_torch.rollout import RolloutSession
    from senweaver_ide_tpu_torch.traces.collector import TraceCollector
    from senweaver_ide_tpu_torch.training import grpo_round, make_train_state
    device = resolve_device("cpu" if args.cpu else "cuda")

    config = get_config("tiny-test")
    state = make_train_state(config,
                             torch.Generator(device.type).manual_seed(0),
                             None, learning_rate=1e-3, device=device)
    tok = ByteTokenizer()

    class RecordingPolicy:
        """PolicyClient adapter: records (prompt_ids, output_ids) per
        call — the trajectory format GRPO trains on. The real
        EnginePolicyClient(record_calls=True) does this natively; this
        shows the seam for custom/scripted policies."""

        def __init__(self):
            self.inner = RuleSensitivePolicy()
            self.call_log = []

        def chat(self, messages, **kw):
            r = self.inner.chat(messages, **kw)
            prompt_text = "\n".join(m.content for m in messages)
            self.call_log.append((tok.encode(prompt_text)[-256:],
                                  tok.encode(r.text)[:128]))
            return r

    with tempfile.TemporaryDirectory() as workdir:
        counter = itertools.count()   # thread-safe in CPython: sessions
                                      # are created from collector threads

        def make_session():
            s = RolloutSession(RecordingPolicy(),
                               os.path.join(workdir,
                                            f"ws{next(counter)}"),
                               include_tool_definitions=False,
                               collector=TraceCollector(
                                   reward_fn=functools.partial(
                                       score_trace, device=device)))
            s.workspace.write_file("app.py", "def run():\n    return 1\n")
            return s

        out = grpo_round(state, config, None, make_session,
                         SIX_PATTERN_TASKS[:2], group_size=2, max_len=512)

    rewards = [round(e.reward, 3) for e in out.episodes]
    print(f"episodes: {len(out.episodes)}  rewards: {rewards}")
    print(f"loss={out.metrics['loss']:.4f} "
          f"grad_norm={out.metrics['grad_norm']:.3f} "
          f"step={int(out.state.step)}")
    print("GRPO ROUND OK")


if __name__ == "__main__":
    main()
