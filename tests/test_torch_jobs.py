"""The port's ``JobRunner`` (``runtime/jobs.py``) against the JAX
package's: the control plane training.

Mirrors tests/test_jobs.py. Each side gets the fixture of that file on
the same ``tiny_test`` fp32 weights (JAX ``init_params`` bridged by
``params_from_numpy``): a ``ControlServer`` and a ``JobRunner`` whose
sessions run the scripted ``RuleSensitivePolicy`` through a recording
client, with the same spread ``reward_override``. The scripted policy
answers every member of a group alike, which would cancel the update's
gradients and leave Adam's sign-like first step to noise; each recorded
completion therefore starts with 32 letters drawn from a seed of the
episode's ``(task_idx, g)`` (``bind_episode``), the same on both sides.

- A ``grpo`` job's result on each side: ``rounds_done``, ``step``,
  episodes and ``reward_mean`` equal; the loss metrics within 1e-5 and
  the final params within 0.25 x lr (the tolerances of
  tests/test_torch_trainer.py for one step, with their reasons there).
- ``eval_rules`` gives the same ``final_reward`` on both (within 1e-6,
  the reward head's tolerance) and ranks the careful rule-set first.
- A malformed job fails cleanly; the port's senweaver-ctl drives a
  training job end to end; the online cycle runs as a control-plane job
  (tests/test_online_loop.py::test_online_job_through_control_plane).
"""

import functools
import json
import math
import random
import shutil
import string
import subprocess
import time

import jax
import numpy as np
import pytest
import torch

from senweaver_ide_tpu import apo as japo
from senweaver_ide_tpu import runtime as jruntime
from senweaver_ide_tpu.models import get_config as jax_get_config
from senweaver_ide_tpu.models import init_params as jax_init_params
from senweaver_ide_tpu.models.tokenizer import ByteTokenizer as JaxTokenizer
from senweaver_ide_tpu.rollout import RolloutSession as JaxSession
from senweaver_ide_tpu.training import make_train_state as jax_train_state
from senweaver_ide_tpu_torch import apo, runtime
from senweaver_ide_tpu_torch.apo import eval as apo_eval
from senweaver_ide_tpu_torch.models import (ByteTokenizer, params_from_numpy,
                                            tiny_test)
from senweaver_ide_tpu_torch.rewards import score_trace
from senweaver_ide_tpu_torch.rollout import RolloutSession
from senweaver_ide_tpu_torch.traces import TraceCollector
from senweaver_ide_tpu_torch.training import make_train_state

LR = 1e-3
METRIC_TOL = 1e-5
PARAM_ATOL = 0.25 * LR
REWARD_TOL = 1e-6
SALT = 32
# what the job result rounds with round(v, 6), and what is not a metric
NOT_METRICS = ("round", "episodes", "reward_mean")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny-model engine steps are thousands of small ops: with several
    pytest-xdist workers, torch's default thread pool in each of them
    oversubscribes the host's cores and spins, several times slower than
    one thread. The previous setting is restored for the next module."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _head_on_the_host(monkeypatch):
    """evaluate_rules scores on the card by default; here on the CPU."""
    monkeypatch.setitem(apo_eval.evaluate_rules.__kwdefaults__, "device",
                        "cpu")


@pytest.fixture(scope="module")
def init():
    """tests/test_jobs.py's weights (``tiny-test``, key 0) as host
    arrays."""
    jcfg = jax_get_config("tiny-test")
    return jcfg, jax.device_get(jax_init_params(jcfg,
                                                jax.random.PRNGKey(0)))


def spread(ti, g, s):
    return 1.0 if g % 2 == 0 else -1.0


def _salt(task_idx, g):
    rng = random.Random(f"{task_idx}-{g}")
    return "".join(rng.choice(string.ascii_letters) for _ in range(SALT))


class Side:
    """One package's job stack: ControlServer + JobRunner over recording
    sessions (tests/test_jobs.py's fixture)."""

    def __init__(self, name, tmp_path, init, *, salt=True):
        jcfg, host = init
        self.is_jax = name == "jax"
        if self.is_jax:
            self.rt, mod, Session, tok = (jruntime, japo, JaxSession,
                                          JaxTokenizer())
            self.cfg = jcfg
            state = jax_train_state(jcfg, None, None, params=jax.tree_util.
                                    tree_map(jax.numpy.asarray, host),
                                    learning_rate=LR)
            collector = None
        else:
            self.rt, mod, Session, tok = (runtime, apo, RolloutSession,
                                          ByteTokenizer())
            self.cfg = tiny_test()
            state = make_train_state(self.cfg, params=params_from_numpy(
                host, device="cpu"), learning_rate=LR)
            collector = functools.partial(
                TraceCollector,
                reward_fn=functools.partial(score_trace, device="cpu"))
        n = [0]

        class RecordingPolicy:
            """Scripted policy + the (prompt_ids, out_ids) log GRPO
            needs; ``tag`` starts each recorded completion."""

            def __init__(self):
                self.inner = mod.RuleSensitivePolicy()
                self.call_log = []
                self.tag = ""

            def chat(self, messages, **kw):
                r = self.inner.chat(messages, **kw)
                ptext = "\n".join(m.content for m in messages)
                self.call_log.append((tok.encode(ptext)[-128:],
                                      tok.encode(self.tag + r.text)[:64]))
                return r

        def make_session(rules=None):
            n[0] += 1
            client = RecordingPolicy()
            kw = {} if collector is None else {"collector": collector()}
            s = Session(client, str(tmp_path / f"{name}-ws{n[0]}"),
                        apo_rules=list(rules or []),
                        include_tool_definitions=False,
                        loop_sleep=lambda _s: None, **kw)
            s.workspace.write_file("app.py", "def run():\n    return 1\n")
            if salt:
                def bind(round_idx, task_idx, g):
                    client.tag = _salt(task_idx, g) + " "
                s.bind_episode = bind
            return s

        self.server = self.rt.ControlServer(str(tmp_path / f"{name}.sock"))
        self.runner = self.rt.JobRunner(
            self.server, make_session=make_session, train_state=state,
            model_config=self.cfg, reward_override=spread, max_len=512)

    def __enter__(self):
        self.server.start()
        self.runner.start()
        return self

    def __exit__(self, *exc):
        self.runner.stop()
        self.server.stop()

    def run(self, spec, timeout=300):
        job_id = self.server._submit(spec)["job_id"]
        t0 = time.time()
        while time.time() - t0 < timeout:
            job = self.server.jobs[job_id]
            if job.status in ("done", "failed", "stopped"):
                return job.status, job.result
            time.sleep(0.05)
        raise TimeoutError(self.server.jobs[job_id].status)


def _host(tree, prefix=""):
    """A params tree of either package as flat host arrays, keyed as
    ``flatten_params`` names them (``layers/wq``)."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_host(v, f"{prefix}{k}/"))
        elif isinstance(v, torch.Tensor):
            out[prefix + k] = v.detach().numpy().copy()
        else:
            out[prefix + k] = np.asarray(jax.device_get(v))
    return out


def test_grpo_job_matches_jax(tmp_path, init):
    spec = {"type": "grpo", "tasks": ["fix", "test"], "rounds": 1,
            "group_size": 2}
    got, final = {}, {}
    for name in ("jax", "port"):
        with Side(name, tmp_path, init) as side:
            got[name] = side.run(spec)
            final[name] = _host(side.runner.state.params)
    (js, jr), (ts, tr) = got["jax"], got["port"]
    assert js == ts == "done", (jr, tr)
    assert (tr["rounds_done"], tr["step"]) == (jr["rounds_done"],
                                               jr["step"]) == (1, 1)
    (jm,), (tm,) = jr["metrics"], tr["metrics"]
    assert (tm["round"], tm["episodes"]) == (jm["round"], jm["episodes"])
    assert tm["episodes"] == 4 and tm["reward_mean"] == jm["reward_mean"]
    assert sorted(tm) == sorted(jm)
    for k in jm:
        if k not in NOT_METRICS:
            assert math.isfinite(tm[k])
            assert tm[k] == pytest.approx(jm[k], abs=METRIC_TOL,
                                          rel=METRIC_TOL), k
    assert tm["grad_norm"] > 0          # the salted members differ
    jp, tp = final["jax"], final["port"]
    start = _host(init[1])
    assert sorted(tp) == sorted(jp)
    moved = 0
    for k in jp:
        np.testing.assert_allclose(tp[k], jp[k], rtol=0, atol=PARAM_ATOL,
                                   err_msg=k)
        moved += int(np.any(tp[k] != start[k]))
    assert moved == len(jp)


def test_eval_rules_job_matches_jax(tmp_path, init):
    rewards = {}
    for name in ("jax", "port"):
        with Side(name, tmp_path, init, salt=False) as side:
            for tag, rules in (("bad", []),
                               ("good", list(japo.GOOD_RULESET))):
                status, res = side.run({"type": "eval_rules",
                                        "rules": rules})
                assert status == "done", res
                assert res["rules"] == rules
                rewards[name, tag] = res["final_reward"]
    for tag in ("bad", "good"):
        assert rewards["port", tag] == pytest.approx(rewards["jax", tag],
                                                     abs=REWARD_TOL)
    assert rewards["port", "good"] > rewards["port", "bad"] + 0.3


def test_bad_jobs_fail_cleanly(tmp_path, init):
    side = Side("port", tmp_path, init)
    side.server.start()
    try:
        # stopped while queued: the runner's check-and-set never runs it
        held = side.server._submit({"type": "grpo"})["job_id"]
        assert side.server._stop({"job_id": held})["status"] == "stopped"
        side.runner.start()
        status, res = side.run({"type": "nonsense"})
        assert status == "failed"
        assert "unknown job type" in res["error"] and res["traceback"]
        assert side.server.jobs[held].status == "stopped"
        assert side.server.jobs[held].result is None
        side.runner.state = None
        status, res = side.run({"type": "grpo"})
        assert status == "failed"
        assert "without a train state" in res["error"]
    finally:
        side.__exit__(None, None, None)


def test_ctl_binary_drives_training(tmp_path, init):
    """The port's C++ CLI submits a training job, watches it finish and
    fetches its metrics."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    binary = runtime.ctl_binary_path()
    assert binary is not None

    def ctl(sock, *args):
        p = subprocess.run([binary, "--socket", sock, "--interval", "1",
                            *args], capture_output=True, text=True,
                           timeout=300)
        lines = [ln for ln in p.stdout.strip().split("\n") if ln]
        return p.returncode, json.loads(lines[-1])

    with Side("port", tmp_path, init) as side:
        sock = side.server.socket_path
        code, resp = ctl(sock, "submit", json.dumps(
            {"type": "grpo", "tasks": ["fix"], "rounds": 2,
             "group_size": 2}))
        assert code == 0
        job_id = resp["result"]["job_id"]
        code, resp = ctl(sock, "watch")
        assert code == 0 and resp["result"][0]["status"] == "done"
        code, resp = ctl(sock, "call", "job_result",
                         json.dumps({"job_id": job_id}))
        assert code == 0 and resp["result"]["status"] == "done"
        res = resp["result"]["result"]
        assert res["rounds_done"] == 2 and res["step"] == 2
        assert all(math.isfinite(m["loss"]) for m in res["metrics"])
        code, resp = ctl(sock, "call", "job_result",
                         json.dumps({"job_id": "job-99"}))
        assert code == 2 and "unknown job" in resp["error"]["message"]


def test_online_job_through_control_plane(tmp_path):
    """The cycle as a control-plane job on the port: submit
    ``{'type': 'online'}``, poll to done, read per-round results (the
    fixture of tests/test_torch_online.py)."""
    from test_torch_online import _stack
    from senweaver_ide_tpu_torch.models import init_params
    params = init_params(tiny_test(), torch.Generator().manual_seed(0),
                         device="cpu")
    host = {k: ({n: t.numpy() for n, t in v.items()}
                if isinstance(v, dict) else v.numpy())
            for k, v in params.items()}
    state, cfg, collector, service, make_session = _stack(
        "port", tmp_path, (jax_get_config("tiny-test"), host))
    server = runtime.ControlServer(str(tmp_path / "online.sock"))
    runner = runtime.JobRunner(server, make_session=make_session,
                               train_state=state, model_config=cfg,
                               max_len=1024, apo=service,
                               collector=collector)
    runner.start()
    try:
        job = server._submit({"type": "online", "rounds": 2,
                              "group_size": 2,
                              "tasks": list(apo.SIX_PATTERN_TASKS[:2])})
        jid = job["job_id"]
        deadline = time.time() + 300
        while server.jobs[jid].status not in ("done", "failed"):
            assert time.time() < deadline
            time.sleep(0.1)
        j = server.jobs[jid]
        assert j.status == "done", j.result
        assert j.result["rounds_done"] == 2 and j.result["step"] == 2
        # the prompt optimizer kicked in and round 1 ran under its rules
        assert j.result["optimized_rules"]
        assert j.result["rounds"][0]["analyzed"]
        assert j.result["rounds"][1]["rules_active"] >= 1
    finally:
        runner.stop()
        server.stop()
