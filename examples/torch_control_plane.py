"""Quickstart: drive real training through the C++ control plane.

Starts a ControlServer + JobRunner around a hermetic session factory,
then uses the senweaver-ctl binary (built on demand from
senweaver_ide_tpu_torch/native/senweaver_ctl.cpp) to submit a GRPO job, watch it, and fetch its
metrics — the operator workflow for a long-running trainer process.

    python examples/torch_control_plane.py [--cpu]
"""
import argparse, functools, json, subprocess, sys, tempfile
from pathlib import Path
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import torch
from senweaver_ide_tpu_torch.apo.eval import GOOD_RULESET, RuleSensitivePolicy
from senweaver_ide_tpu_torch.device import resolve_device
from senweaver_ide_tpu_torch.models import get_config
from senweaver_ide_tpu_torch.models.tokenizer import ByteTokenizer
from senweaver_ide_tpu_torch.rewards.head import score_trace
from senweaver_ide_tpu_torch.rollout import RolloutSession
from senweaver_ide_tpu_torch.runtime import ControlServer, JobRunner
from senweaver_ide_tpu_torch.runtime.native import ctl_binary_path
from senweaver_ide_tpu_torch.traces.collector import TraceCollector
from senweaver_ide_tpu_torch.training import make_train_state

ap = argparse.ArgumentParser()
ap.add_argument("--cpu", action="store_true",
                help="run on the CPU (default: the CUDA card)")
args = ap.parse_args()
device = resolve_device("cpu" if args.cpu else "cuda")

config = get_config("tiny-test")
state = make_train_state(config, torch.Generator(device.type).manual_seed(0),
                         None, learning_rate=1e-3, device=device)
tok = ByteTokenizer()
tmp = tempfile.mkdtemp()
n = [0]

class RecordingPolicy:
    """Scripted policy + the (prompt_ids, out_ids) call log that
    collect_group_trajectories slices into GRPO trajectories — without
    it a round collects zero training data."""

    def __init__(self):
        self.inner = RuleSensitivePolicy(); self.call_log = []
    def chat(self, messages, **kw):
        r = self.inner.chat(messages, **kw)
        self.call_log.append(( tok.encode("\n".join(m.content for m in messages))[-128:],
                               tok.encode(r.text)[:64]))
        return r

def make_session(rules=None):
    n[0] += 1
    s = RolloutSession(RecordingPolicy(), f"{tmp}/ws{n[0]}",
                       apo_rules=list(rules or []),
                       include_tool_definitions=False,
                       collector=TraceCollector(reward_fn=functools.partial(
                           score_trace, device=device)))
    s.workspace.write_file("app.py", "def run():\n    return 1\n")
    return s

server = ControlServer(f"{tmp}/ctl.sock")
runner = JobRunner(server, make_session=make_session, train_state=state,
                   model_config=config, max_len=512, device=device,
                   reward_override=lambda ti, g, s: 1.0 if g % 2 == 0 else -1.0)
server.start(); runner.start()
CTL = ctl_binary_path()
if CTL is None:
    sys.exit("senweaver-ctl binary unavailable (native build failed — "
             "install a C++ toolchain and rebuild "
             "senweaver_ide_tpu_torch/native/senweaver_ctl.cpp)")

def ctl(*args):
    p = subprocess.run([CTL, "--socket", server.socket_path, "--interval", "1",
                        *args], capture_output=True, text=True, timeout=300)
    return json.loads([l for l in p.stdout.strip().split("\n") if l][-1])

job = ctl("submit", json.dumps({"type": "grpo", "tasks": ["fix the crash"],
                                "rounds": 2, "group_size": 2,
                                "ppo_epochs": 2}))["result"]["job_id"]
ctl("watch")
res = ctl("call", "job_result", json.dumps({"job_id": job}))["result"]
print("job", job, "->", res["status"], "| step", res["result"]["step"],
      "| rounds", res["result"]["rounds_done"])
ev = ctl("submit", json.dumps({"type": "eval_rules",
                               "rules": list(GOOD_RULESET)}))["result"]["job_id"]
ctl("watch")
score = ctl("call", "job_result", json.dumps({"job_id": ev}))["result"]["result"]
print("eval_rules finalReward:", round(score["final_reward"], 3))
runner.stop(); server.stop()
print("JOBS SESSION OK")
