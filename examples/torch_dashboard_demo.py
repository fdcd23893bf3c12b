"""Quickstart: the operator dashboard over live service state.

Builds a real TraceCollector (by rolling the 6-pattern tasks with the
scripted policy), an APOService report, a metrics JSONL with training
curves, and a ControlServer job queue — then serves the L6 dashboard:

    python examples/torch_dashboard_demo.py [--port 8321] [--once] [--cpu]

--once prints the aggregated /api/state JSON and exits (CI-friendly);
otherwise the server stays up until Ctrl-C.
"""
import argparse
import functools
import json
import math
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from senweaver_ide_tpu_torch.device import resolve_device  # noqa: E402

from senweaver_ide_tpu_torch.apo.eval import RuleSensitivePolicy, SIX_PATTERN_TASKS
from senweaver_ide_tpu_torch.apo.service import APOService
from senweaver_ide_tpu_torch.rewards.head import score_trace
from senweaver_ide_tpu_torch.rollout.session import RolloutSession
from senweaver_ide_tpu_torch.runtime.control import ControlServer
from senweaver_ide_tpu_torch.services import DashboardService, MetricsService
from senweaver_ide_tpu_torch.traces.collector import TraceCollector

ap = argparse.ArgumentParser()
ap.add_argument("--port", type=int, default=8321)
ap.add_argument("--once", action="store_true")
ap.add_argument("--cpu", action="store_true",
                help="score traces on the CPU (default: the CUDA card)")
args = ap.parse_args()
device = resolve_device("cpu" if args.cpu else "cuda")

tmp = tempfile.mkdtemp()
collector = TraceCollector(
    reward_fn=functools.partial(score_trace, device=device))
client = RuleSensitivePolicy()
for i, task in enumerate(SIX_PATTERN_TASKS[:4]):
    s = RolloutSession(client, f"{tmp}/ws{i}", collector=collector,
                       include_tool_definitions=False,
                       loop_sleep=lambda _s: None)
    s.workspace.write_file("app.py", "x = 1\n")
    s.run_turn(task)
    s.record_feedback("bad")
    s.close()

apo = APOService(collector)
apo.analyze()

metrics_path = f"{tmp}/metrics.jsonl"
m = MetricsService(jsonl_path=metrics_path)
for i in range(25):     # a plausible learning curve for the demo
    m.capture("GRPO Round Done",
              {"reward_mean": -0.6 + 1.2 * (1 - math.exp(-i / 8)),
               "loss": 0.02 * math.exp(-i / 10),
               "episodes": 16, "collect_s": 30 + i % 5})

ctl = ControlServer(f"{tmp}/ctl.sock")
ctl._submit({"type": "grpo", "rounds": 3})
ctl._submit({"type": "eval_rules"})
ctl.jobs["job-1"].status = "done"
ctl.jobs["job-2"].status = "running"

dash = DashboardService(collector=collector, apo=apo, control=ctl,
                        metrics_path=metrics_path)
if args.once:
    print(json.dumps(dash.state())[:2000])
    print("DASHBOARD STATE OK")
else:
    port = dash.start(port=args.port)
    print(f"dashboard: http://127.0.0.1:{port}/  (Ctrl-C to stop)")
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        dash.stop()
