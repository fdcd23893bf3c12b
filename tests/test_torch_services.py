"""The port's services (``senweaver_ide_tpu_torch/services/``) and
editor edit prediction on the port's own control plane and engine.

Mirrors tests/test_dashboard.py, tests/test_dashboard_actions.py,
tests/test_onboarding.py, tests/test_scm.py, tests/test_model_refresh.py
and tests/test_spec_engine.py::test_dashboard_speculation_tile where the
port has its own parts; the verbatim host code itself is held to the JAX
files by tests/test_torch_copies.py.

- The dashboard's state over a port collector, APO service, engine and
  ``ControlServer``; its page, ``/api/state``, ``/metrics`` off the
  port's registry, and operator actions over HTTP into the port's control
  socket (auth enforced there, jobs submitted and stopped, APO
  suggestions applied, config pushed).
- The speculation tile over a speculating engine of each package, the
  same weights, greedy: equal tiles (``torch_fleet_sides.both``).
- Onboarding's accelerator step takes ``'gpu'`` or ``'cpu'``: with no
  card the probe (a subprocess) fails and ``'gpu'`` is refused with the
  JAX message's shape; an injected probe makes it accepted.
- SCM on a temporary git repository with a scripted client: the same
  prompt as the JAX service, the message, the typed missing-``<output>``
  error; model refresh against a loopback ``/models`` server.
- Edit prediction's content pass through a port ``RolloutEngine``
  (``tiny_test``, CPU, greedy) and through the JAX engine on the same
  weights: the same locations, replies and suggestions.
"""

import http.server
import json
import subprocess
import threading
import urllib.error
import urllib.request

import pytest
import torch

from senweaver_ide_tpu.agents.llm import LLMResponse as JaxResponse
from senweaver_ide_tpu.editor import edit_prediction as jedit
from senweaver_ide_tpu.models.tokenizer import ByteTokenizer as JaxTokenizer
from senweaver_ide_tpu.services import onboarding as jonboarding
from senweaver_ide_tpu.services import scm as jscm
from senweaver_ide_tpu.services.config import RuntimeConfig as JaxConfig
from senweaver_ide_tpu.services.dashboard import \
    DashboardService as JaxDashboard
from senweaver_ide_tpu.tools.sandbox import Workspace as JaxWorkspace
from senweaver_ide_tpu_torch import obs
from senweaver_ide_tpu_torch.agents.llm import LLMResponse
from senweaver_ide_tpu_torch.apo.service import (APOService,
                                                 install_apo_channel)
from senweaver_ide_tpu_torch.apo.types import new_suggestion
from senweaver_ide_tpu_torch.editor import (changed_symbols,
                                            predict_edit_locations,
                                            suggest_contents)
from senweaver_ide_tpu_torch.editor import edit_prediction as tedit
from senweaver_ide_tpu_torch.models.tokenizer import ByteTokenizer
from senweaver_ide_tpu_torch.rewards import score_trace
from senweaver_ide_tpu_torch.runtime import ControlServer
from senweaver_ide_tpu_torch.services import (DashboardService,
                                              MetricsService,
                                              OnboardingService,
                                              RuntimeConfig, SCMService,
                                              install_config_channel,
                                              install_onboarding_channel)
from senweaver_ide_tpu_torch.services.model_refresh import (
    STATE_ERROR, STATE_SUCCESS, RefreshModelService, fetch_model_list)
from senweaver_ide_tpu_torch.services.onboarding import STEPS
from senweaver_ide_tpu_torch.tools.sandbox import Workspace
from senweaver_ide_tpu_torch.traces import TraceCollector
from senweaver_ide_tpu_torch.transport.providers import ProviderSettings
from torch_fleet_sides import Models, both, one_torch_thread

TOKEN = "test-operator-token"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    yield from one_torch_thread()


def _collector():
    import functools
    return TraceCollector(reward_fn=functools.partial(score_trace,
                                                      device="cpu"))


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=10) as r:
        return r.headers["Content-Type"], r.read().decode()


def _post(port, method, params=None, token=TOKEN):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/api/action",
        data=json.dumps({"method": method, "params": params}).encode(),
        headers={"Content-Type": "application/json",
                 **({"X-Auth-Token": token} if token else {})},
        method="POST")
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


# ---- the dashboard over the port's stack ----------------------------------

@pytest.fixture()
def stack(tmp_path):
    """A port collector with one scored trace, an APO service, a metrics
    file with three rounds, a token-guarded ControlServer with the APO,
    config and onboarding channels, and the dashboard over all of it."""
    obs._reset_for_tests()
    collector = _collector()
    collector.start_trace("t1", metadata={"chatMode": "agent"})
    collector.record_user_message("t1", 0, "fix it")
    collector.record_llm_call("t1", 1, model="m", input_tokens=100,
                              output_tokens=20)
    collector.record_tool_call("t1", 1, tool_name="read_file",
                               tool_success=True, duration_ms=4.0)
    collector.end_trace_for_thread("t1")
    metrics_path = str(tmp_path / "metrics.jsonl")
    m = MetricsService(jsonl_path=metrics_path)
    for i in range(3):
        m.capture("GRPO Round Done", {"reward_mean": -0.5 + 0.2 * i,
                                      "loss": 0.01 * i, "episodes": 8,
                                      "collect_s": 1.5})
    apo = APOService(collector)
    config = RuntimeConfig(settings_path=str(tmp_path / "settings.json"))
    onboarding = OnboardingService(config,
                                   state_path=str(tmp_path / "ob.json"),
                                   accelerator_probe=lambda: False)
    server = ControlServer(str(tmp_path / "ctl.sock"), token=TOKEN)
    install_apo_channel(server, apo)
    install_config_channel(server, config)
    install_onboarding_channel(server, onboarding)
    server.start()

    class Engine:
        def stats(self):
            return {"tokens_emitted": 123, "prefill_tokens": 456}

    dash = DashboardService(collector=collector, apo=apo, engine=Engine(),
                            control=server, metrics_path=metrics_path,
                            onboarding=onboarding, title="port-dash")
    port = dash.start(port=0)
    yield dash, port, apo, config, server
    dash.stop()
    server.stop()
    obs._reset_for_tests()


def test_dashboard_state_page_and_metrics(stack):
    dash, port, _apo, _config, server = stack
    server._submit({"type": "grpo"})
    s = dash.state()
    assert s["title"] == "port-dash"
    assert s["traces"]["total_traces"] == 1
    assert s["traces"]["total_tool_calls"] == 1
    assert s["engine"]["tokens_emitted"] == 123
    assert [j["status"] for j in s["jobs"]] == ["queued"]
    assert s["training"]["reward_mean"] == pytest.approx([-0.5, -0.3, -0.1])
    assert s["onboarding"]["current"] == "workspace"
    assert "optimized_rules" in s["apo"]
    json.dumps(s)
    kind, page = _get(port, "/")
    assert kind.startswith("text/html") and "port-dash" in page
    _, body = _get(port, "/api/state")
    assert json.loads(body)["training"]["rounds"] == [0, 1, 2]
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(port, "/nope")
    assert e.value.code == 404
    # /metrics serves the port's registry; the obs tile reads it
    obs.get_registry().counter("senweaver_rounds_total", "rounds").inc(2)
    obs.get_registry().gauge("senweaver_tokens_per_sec", "tput",
                             labelnames=("phase",)).set(42.0, phase="train")
    obs.enable()
    with obs.get_tracer().span("train_step"):
        pass
    s = dash.state()
    assert s["obs"]["total_spans"] == 1 and s["obs"]["rounds_total"] == 2
    assert s["obs"]["tokens_per_sec"] == 42.0
    kind, text = _get(port, "/metrics")
    assert kind.startswith("text/plain")
    assert "# TYPE senweaver_rounds_total counter" in text
    assert "senweaver_rounds_total 2" in text
    assert 'senweaver_tokens_per_sec{phase="train"} 42' in text


def test_dashboard_runtime_tile_reads_the_port_ledger(stack):
    """The runtime tile reads the port's obs.runtime_profile ledger and
    the senweaver_runtime_* gauges by JAX's names."""
    dash, *_ = stack
    obs.set_profiler(obs.RuntimeProfiler())
    from senweaver_ide_tpu_torch.obs.runtime_profile import ProfiledFunction
    wrapped = ProfiledFunction(lambda x: x + 1, "engine.fused_step")
    for _ in range(3):
        wrapped(torch.zeros(4))
    obs.get_registry().gauge(
        "senweaver_runtime_hbm_watermark_bytes", "wm",
        labelnames=("device",)).set(3 * 1024 * 1024, device="cpu")
    rt = dash.state()["runtime"]
    rows = {r["fn"]: r for r in rt["functions"]}
    assert rows["engine.fused_step"]["calls"] == 3 and rt["calls"] == 3
    assert rt["hbm_watermark_mb"] == 3.0


def test_dashboard_actions_through_the_port_control_socket(stack):
    _dash, port, apo, config, server = stack
    status, body = _post(port, "submit", {"type": "grpo"}, token=None)
    assert status == 401 and not body["ok"] and server.list_jobs() == []
    status, body = _post(port, "submit", {"type": "grpo", "rounds": 2})
    assert status == 200 and body["ok"]
    job_id = body["result"]["job_id"]
    status, body = _post(port, "stop", {"job_id": job_id})
    assert status == 200 and server.jobs[job_id].status == "stopped"
    apo.segments.add_suggestions([new_suggestion(
        target_category="tool_usage", type="add", priority="high",
        description="verify first", reasoning="r", estimated_impact="high",
        suggested_content="Verify inputs before acting.")])
    sid = json.loads(_get(port, "/api/state")[1])["apo"]["suggestions"][0][
        "id"]
    status, body = _post(port, "apo.apply", {"id": sid})
    assert status == 200 and "Verify inputs before acting." in body[
        "result"]["rules"]
    status, body = _post(port, "apo.apply", {"id": "nope"})
    assert status == 400 and not body["ok"]
    status, body = _post(port, "config.push",
                         {"allowed_models": ["tiny-test"]})
    assert status == 200 and config.is_model_allowed("tiny-test")
    assert not config.is_model_allowed("other-model")
    status, body = _post(port, "onboarding.answer",
                         {"step": "accelerator", "value": "cpu"})
    assert status == 200 and body["result"]["answers"]["accelerator"] == \
        "cpu"


def _speculation_tile(S):
    dash_cls = JaxDashboard if S.is_jax else DashboardService
    draft, draft_cfg = S.draft()
    eng = S.engine(num_slots=2, max_len=64)
    eng.enable_speculation(draft, draft_cfg, depth=4)
    rid = eng.submit([5, 9, 2, 7, 1, 3], max_new_tokens=8)
    out = eng.run()[rid]
    return dict(tile=dash_cls().state()["speculation"], out=list(out))


def test_dashboard_speculation_tile_like_jax():
    r = both(Models(), _speculation_tile)
    spec = r["tile"]
    assert spec["depth"] == 4 and spec["wasted_draft_tokens"] > 0
    assert spec["draft_blocks_free"] > 0
    json.dumps(spec)


# ---- onboarding with the 'gpu' posture -------------------------------------

def test_onboarding_accelerator_takes_gpu(tmp_path):
    def svc(pkg, probe, tag):
        cfg = (RuntimeConfig if pkg is None else JaxConfig)(
            settings_path=str(tmp_path / f"{tag}.json"))
        return (OnboardingService if pkg is None else pkg.OnboardingService)(
            cfg, state_path=str(tmp_path / f"{tag}-ob.json"),
            accelerator_probe=probe)

    assert [s.name for s in STEPS] == [s.name for s in jonboarding.STEPS]
    port = svc(None, None, "p")
    assert port.probe_accelerator(timeout_s=120) is False   # no card here
    with pytest.raises(ValueError) as e:
        port.answer("accelerator", "gpu")
    with pytest.raises(ValueError) as je:
        svc(jonboarding, lambda: False, "j").answer("accelerator", "tpu")
    for got in (str(e.value), str(je.value)):
        assert got.startswith("accelerator probe failed: no ")
        assert got.endswith("pick 'cpu' or fix the platform and retry")
    with pytest.raises(ValueError, match="must be 'gpu' or 'cpu'"):
        port.answer("accelerator", "tpu")
    assert port.answer("accelerator", "cpu")["answers"]["accelerator"] == \
        "cpu"
    ok = svc(None, lambda: True, "q")
    assert ok.answer("accelerator", "gpu")["answers"]["accelerator"] == \
        "gpu"
    assert ok._config.get("runtime.accelerator") == "gpu"


def test_probe_subprocess_needs_a_card_round_trip(monkeypatch):
    """The probe's child exits 0 only when a CUDA tensor round-trips:
    run it with the child's interpreter swapped for one that reports a
    card but cannot move a tensor to it."""
    calls = []

    def fake_run(cmd, **kw):
        calls.append(cmd)
        return subprocess.CompletedProcess(cmd, 1)

    monkeypatch.setattr(subprocess, "run", fake_run)
    svc = OnboardingService(RuntimeConfig())
    assert svc.probe_accelerator(timeout_s=5) is False
    code = calls[0][-1]
    assert "import torch" in code and "jax" not in code
    assert ".cuda().cpu().item()" in code and "is_available()" in code


# ---- SCM and model refresh -------------------------------------------------

class _Scripted:
    def __init__(self, text, response_cls):
        self.text, self.response_cls = text, response_cls
        self.calls = []

    def chat(self, messages, **kw):
        self.calls.append([(m.role, m.content) for m in messages])
        return self.response_cls(text=self.text)


@pytest.fixture()
def repo(tmp_path):
    def git(*args):
        subprocess.run(["git", *args], cwd=tmp_path, check=True,
                       capture_output=True)
    git("init", "-q", "-b", "main")
    git("config", "user.email", "t@t")
    git("config", "user.name", "t")
    (tmp_path / "a.py").write_text("x = 1\n")
    git("add", ".")
    git("commit", "-q", "-m", "initial commit")
    return tmp_path


def test_scm_commit_message_like_jax(repo):
    (repo / "a.py").write_text("x = 2\nprint(x)\n")
    reply = "<output>Update a.py computation</output><reasoning>r</reasoning>"
    port = _Scripted(reply, LLMResponse)
    jax_client = _Scripted(reply, JaxResponse)
    assert SCMService(port).generate_commit_message(str(repo)) == \
        jscm.SCMService(jax_client).generate_commit_message(str(repo)) == \
        "Update a.py computation"
    assert port.calls == jax_client.calls
    assert "a.py" in port.calls[0][1][1] and "main" in port.calls[0][1][1]
    with pytest.raises(RuntimeError, match="no <output> commit message"):
        SCMService(_Scripted("no tags", LLMResponse)
                   ).generate_commit_message(str(repo))
    subprocess.run(["git", "checkout", "--", "a.py"], cwd=repo, check=True)
    with pytest.raises(RuntimeError, match="clean tree"):
        SCMService(port).generate_commit_message(str(repo))


class _ModelsHandler(http.server.BaseHTTPRequestHandler):
    payload: dict = {}

    def do_GET(self):
        if "gone" in self.path or not self.path.endswith("/models"):
            self.send_error(404)
            return
        body = json.dumps(self.payload).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *a):
        pass


def test_model_refresh_against_a_loopback_models_server():
    srv = http.server.HTTPServer(("127.0.0.1", 0), _ModelsHandler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        s = ProviderSettings("t", "openai-compat", base_url=url)
        _ModelsHandler.payload = {"data": [{"id": "qwen2.5-coder"},
                                           {"id": "deepseek-coder"}]}
        assert fetch_model_list(s) == ["qwen2.5-coder", "deepseek-coder"]
        _ModelsHandler.payload = {"models": [{"name": "llama3"}, "phi-3"]}
        svc = RefreshModelService(fetcher=lambda _p: fetch_model_list(s))
        assert svc.refresh("ollama") == ["llama3", "phi-3"]
        assert svc.state_of("ollama") == STATE_SUCCESS
        dead = ProviderSettings("t", "openai-compat",
                                base_url=url + "/gone")
        svc = RefreshModelService(fetcher=lambda _p: fetch_model_list(dead))
        assert svc.refresh("ollama") == []
        assert svc.state_of("ollama") == STATE_ERROR
    finally:
        srv.shutdown()
        srv.server_close()


# ---- edit prediction through each package's engine -------------------------

BEFORE = "def compute_total(items):\n    return sum(items)\n"
AFTER = "def compute_sum(items):\n    return sum(items)\n"
CALLER = ("from lib import compute_total\n\n"
          "print(compute_total([1, 2]))\n"
          "value = compute_total(range(3))\n")


class _Recorder:
    def __init__(self, inner):
        self.inner, self.replies = inner, []

    def chat(self, messages, **kw):
        r = self.inner.chat(messages, **kw)
        self.replies.append(r.text)
        return r


def _edit_prediction(S, root):
    ws_cls, mod, tok = ((JaxWorkspace, jedit, JaxTokenizer()) if S.is_jax
                        else (Workspace, tedit, ByteTokenizer()))
    ws = ws_cls(str(root / S.name))
    ws.write_file("lib.py", AFTER)
    ws.write_file("main.py", CALLER)
    preds = mod.predict_edit_locations(ws, "lib.py", BEFORE, AFTER)
    client = _Recorder(S.PolicyClient(S.engine(num_slots=1, max_len=1024),
                                      tok, default_max_new_tokens=24))
    out = mod.suggest_contents(client, preds, BEFORE, AFTER)
    return dict(preds=[(p.uri, p.line, p.symbol, p.preview, p.suggested)
                       for p in out], replies=client.replies)


def test_edit_prediction_content_pass_like_jax(tmp_path):
    assert changed_symbols(BEFORE, AFTER) == ["compute_total",
                                              "compute_sum"]
    r = both(Models(), _edit_prediction, tmp_path)
    assert [p[1] for p in r["preds"]] == [1, 3, 4]
    assert len(r["replies"]) == 1 and r["replies"][0]
    # a scripted reply fills the suggestions the same way on the port
    ws = Workspace(str(tmp_path / "scripted"))
    ws.write_file("lib.py", AFTER)
    ws.write_file("main.py", CALLER)
    preds = predict_edit_locations(ws, "lib.py", BEFORE, AFTER)
    out = suggest_contents(_Scripted(
        "0: from lib import compute_sum\n1: SKIP\n2: value = x",
        LLMResponse), preds, BEFORE, AFTER)
    assert [p.suggested for p in out] == ["from lib import compute_sum",
                                          None, "value = x"]
