"""Quickstart: the FULL improvement cycle — prompt search + weight
updates in one loop, with the operator dashboard over it.

Round 0 collects sloppy episodes (no rules), the outcome evaluator
records bad feedback, the APO gates open, and the beam search finds the
careful rule-set; round 1+ run under those rules at full reward while
GRPO steps the weights every round.

    python examples/torch_online_cycle.py [--rounds 3] [--serve] [--cpu]

--serve keeps the dashboard up afterwards (http://127.0.0.1:8321/).
"""
import argparse
import functools
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import torch

from senweaver_ide_tpu_torch.apo.eval import RuleSensitivePolicy, SIX_PATTERN_TASKS
from senweaver_ide_tpu_torch.apo.local import make_local_apo
from senweaver_ide_tpu_torch.apo.types import APOConfig
from senweaver_ide_tpu_torch.device import resolve_device
from senweaver_ide_tpu_torch.models import get_config
from senweaver_ide_tpu_torch.models.tokenizer import ByteTokenizer
from senweaver_ide_tpu_torch.rewards.head import score_trace
from senweaver_ide_tpu_torch.rollout.session import RolloutSession
from senweaver_ide_tpu_torch.services import DashboardService, MetricsService
from senweaver_ide_tpu_torch.traces.collector import TraceCollector
from senweaver_ide_tpu_torch.training import OnlineImprovementLoop, make_train_state

ap = argparse.ArgumentParser()
ap.add_argument("--rounds", type=int, default=3)
ap.add_argument("--serve", action="store_true")
ap.add_argument("--cpu", action="store_true",
                help="run on the CPU (default: the CUDA card)")
args = ap.parse_args()
device = resolve_device("cpu" if args.cpu else "cuda")

cfg = get_config("tiny-test")
state = make_train_state(cfg, torch.Generator(device.type).manual_seed(0),
                         None, learning_rate=1e-3, device=device)
collector = TraceCollector(
    reward_fn=functools.partial(score_trace, device=device))
client = RuleSensitivePolicy()
tok = ByteTokenizer()
tmp = tempfile.mkdtemp()
n = [0]


class Recording:
    """Wraps the scripted policy with the (prompt_ids, out_ids) call log
    the GRPO batch builder consumes."""

    def __init__(self):
        self.call_log = []

    def chat(self, messages, **kw):
        r = client.chat(messages, **kw)
        self.call_log.append((tok.encode(messages[-1].content)[-96:],
                              tok.encode(r.text)[:48]))
        return r


def make_session(rules=None, thread_id=None):
    n[0] += 1
    s = RolloutSession(Recording(), f"{tmp}/ws{n[0]}",
                       apo_rules=list(rules or []),
                       thread_id=thread_id or f"demo{n[0]}",
                       collector=collector,
                       include_tool_definitions=False,
                       loop_sleep=lambda _s: None)
    s.workspace.write_file("app.py", "x = 1\n")
    return s


apo = make_local_apo(collector, client,
                     config=APOConfig(min_traces_for_analysis=4,
                                      min_feedbacks_for_analysis=4,
                                      gradient_min_feedbacks=4,
                                      beam_rounds=1),
                     make_session=make_session,
                     eval_tasks=SIX_PATTERN_TASKS[:2], device=device)
metrics = MetricsService(jsonl_path=f"{tmp}/metrics.jsonl")
loop = OnlineImprovementLoop(state, cfg, None, make_session,
                             SIX_PATTERN_TASKS[:2], apo=apo,
                             collector=collector, group_size=2,
                             max_len=1024, max_parallel=1,
                             metrics_service=metrics)
for r in loop.run(args.rounds):
    print(f"round {r.round_idx}: reward={r.reward_mean:+.3f} "
          f"rules={len(r.rules)} analyzed={r.analyzed} "
          f"beam={r.beam_ran}")
print("optimized rules:", loop.current_rules())
print("ONLINE CYCLE OK")

if args.serve:
    dash = DashboardService(collector=collector, apo=apo,
                            metrics_path=f"{tmp}/metrics.jsonl")
    port = dash.start(port=8321)
    print(f"dashboard: http://127.0.0.1:{port}/  (Ctrl-C to stop)")
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        dash.stop()
