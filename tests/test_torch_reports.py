"""The port's operator reports (``scripts/torch_*_report.py``) on the
CPU, against the JAX ones (``scripts/*_report.py``).

- Each port ``selftest(device="cpu")`` passes (it raises on a violated
  invariant, as JAX's does), returns JAX's report keys (nested dicts
  included, read from the JAX script's own return expressions) and
  leaves the process's observability globals as it found them.
- Each JSONL mode, given the same small fixture files, prints exactly
  what the JAX script prints; ``torch_analysis_report.py`` runs on the
  same fixture package and baseline as JAX's.
"""

import ast
import contextlib
import importlib.util
import io
import json
import os
import sys

import jax  # noqa: F401  (test files import both frameworks)
import pytest
import torch

from senweaver_ide_tpu_torch import obs
from senweaver_ide_tpu_torch.obs import incidents, training_health

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(ROOT, "scripts")
SELFTESTS = ("kv_quant", "kv_pressure", "spec", "group_tree", "migration",
             "learner", "remote_fleet", "slo", "fleet_obs",
             "training_health")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny-model steps are thousands of small ops: with several
    pytest-xdist workers, torch's default thread pool in each of them
    oversubscribes the host's cores. The previous setting is restored for
    the next module."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _load(name):
    """A script of ``scripts/`` as a module (``<name>.py``)."""
    spec = importlib.util.spec_from_file_location(
        f"_report_{name}", os.path.join(SCRIPTS, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _own_nodes(fn):
    """The nodes of function ``fn``, not entering nested functions."""
    todo = list(ast.iter_child_nodes(fn))
    while todo:
        node = todo.pop(0)
        yield node
        if not isinstance(node, (ast.FunctionDef, ast.Lambda,
                                 ast.ClassDef)):
            todo.extend(ast.iter_child_nodes(node))


def _shape(node, fn, funcs):
    """The keys of the dict that expression ``node`` of function ``fn``
    evaluates to (a literal, a name bound to one in ``fn``, or a call of a
    module function that returns one), nested the same way; None where
    it is no such dict."""
    if isinstance(node, ast.Name):
        bound = [a.value for a in _own_nodes(fn) if isinstance(a, ast.Assign)
                 and any(isinstance(t, ast.Name) and t.id == node.id
                         for t in a.targets)]
        return _shape(bound[-1], fn, funcs) if bound else None
    if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
            and node.func.id in funcs):
        f = funcs[node.func.id]
        rets = [r.value for r in _own_nodes(f)
                if isinstance(r, ast.Return) and r.value is not None]
        return _shape(rets[-1], f, funcs) if rets else None
    if isinstance(node, ast.Dict) and node.keys and all(
            isinstance(k, ast.Constant) for k in node.keys):
        return {k.value: _shape(v, fn, funcs)
                for k, v in zip(node.keys, node.values)}
    return None


def jax_selftest_keys(name):
    """The nested keys of what ``scripts/<name>_report.py``'s selftest
    returns, read from its source."""
    with open(os.path.join(SCRIPTS, f"{name}_report.py")) as f:
        tree = ast.parse(f.read())
    funcs = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    rets = [r.value for r in _own_nodes(funcs["selftest"])
            if isinstance(r, ast.Return) and r.value is not None]
    return _shape(rets[-1], funcs["selftest"], funcs)


def _check_keys(got, want, where):
    assert isinstance(got, dict), where
    assert set(got) == set(want), (where, sorted(got), sorted(want))
    for k, sub in want.items():
        if sub is not None:
            _check_keys(got[k], sub, f"{where}.{k}")


def _obs_state():
    return (obs.get_tracer(), obs.get_registry(), obs.is_enabled(),
            training_health._monitor, incidents._journal)


def test_jax_key_reader_sees_nested_reports():
    keys = jax_selftest_keys("kv_quant")
    assert set(keys) == {"mode", "capacity", "parity", "movement",
                         "pressure_payoff", "ok"}
    assert "capacity_ratio" in keys["capacity"]
    assert set(jax_selftest_keys("fleet_obs")["partition"]) >= {
        "top_cause", "cause_ok"}
    assert "continuation_replays" in jax_selftest_keys("remote_fleet")


@pytest.mark.parametrize("name", SELFTESTS)
def test_selftest_passes_with_jax_keys(name):
    mod = _load(f"torch_{name}_report")
    before = _obs_state()
    report = mod.selftest(device="cpu")
    assert _obs_state() == before, "the selftest left the obs state changed"
    assert report["mode"] == "selftest"
    _check_keys(report, jax_selftest_keys(name), name)
    assert report.get("ok", True) is True
    json.dumps(report, default=str)            # the CLI prints it


# -- JSONL modes -------------------------------------------------------------

def _snapshot(i):
    return {"event": "Serving Snapshot", "properties": {
        "replicas_live": 2, "queue_depth": 3 - i, "completed": 10 + 5 * i,
        "shed": i, "retries": 2, "publishes": 1 + i,
        "weight_version_skew": 1 - i, "ttft_count": 4, "ttft_ms_sum": 41.5,
        "e2e_count": 4 * i, "e2e_ms_sum": 400.25 * i, "remote_rpcs": 20 + i,
        "remote_rpc_retries": 2, "remote_rpc_errors": 1, "breaker_opens": i,
        "continuation_replays": 1, "publish_quarantined": 0,
        "weight_version": 2 + i, "publish_epoch": 1, "stale_publishes": i,
        "autoscale_actions": 0, "learner_publishes": 2 + i,
        "prefix_prefills_avoided": 5 + 3 * i, "prefix_broadcasts": 2,
        "prefix_broadcast_failures": i, "prefix_invalidations": 1,
        "prefix_install_count": 2 * i, "prefix_install_ms_sum": 3.5 * i,
        "ttft_by_priority": {
            "interactive": {"count": 4, "sum": 40.0,
                            "buckets": {"5.0": 1, "10.0": 3, "inf": 4}},
            "train_rollout": {"count": 2, "sum": 900.0,
                              "buckets": {"5.0": 0, "10.0": 0,
                                          "inf": 2}}}}}


METRICS = [
    _snapshot(0),
    {"event": "Weights Published", "properties": {"weight_version": 3}},
    {"event": "Engine Snapshot", "properties": {
        "kv_dtype": "int8", "kv_bytes_per_block": 1280,
        "kv_bytes_device": 12800, "kv_bytes_host": 2560,
        "prefix_evictions": 2, "kv_preemptions": 1, "kv_pressure": 0.75,
        "kv_exhaustions": 0, "kv_preemption_storms": 0,
        "kv_swapped_blocks": 2, "prefix_swap_outs": 1, "prefix_swap_ins": 1,
        "spec_depth": 4, "spec_acceptance": 0.625,
        "spec_wasted_draft_tokens": 12, "spec_draft_staleness": 1,
        "spec_draft_version": 2, "draft_publishes": 1,
        "engine_group_prefills": 1, "engine_group_forks": 7,
        "engine_branch_forks": 2, "engine_group_prefill_tokens_avoided": 42,
        "engine_group_degrades": 0, "engine_kv_cow_copies": 3,
        "engine_prefills": 2}},
    {"event": "GRPO Round Done", "properties": {
        "episodes": 4, "failed_episodes": 1, "episode_retries": 2,
        "groups_dropped": 1, "update_skipped": None, "reward_mean": 0.25}},
    {"event": "GRPO Round Empty", "properties": {"episodes": 0}},
    {"event": "Async GRPO Round", "properties": {
        "episodes": 8, "update_skipped": "nonfinite_loss",
        "reward_mean": -0.5}},
    {"event": "Engine Snapshot", "properties": {
        "kv_dtype": "bf16", "kv_pressure": 0.5, "spec_depth": 0}},
    _snapshot(1),
]

HEALTH = [
    {"round": 0, "health": {"rank_fraction": 0.75, "advantage_std": 1.0},
     "triggers": []},
    {"round": 1, "health": {"rank_fraction": 0.125, "advantage_std": 0.0},
     "triggers": ["rank_collapse", "zero_groups"], "events": []},
    {"round": 2, "health": {"rank_fraction": 0.25, "advantage_std": 0.5},
     "triggers": ["rank_collapse"],
     "events": ["mitigation_enabled:leave_one_out"]},
]

RUNTIME = [
    {"fn": "engine.fused_step", "calls": 40, "compiles": 3,
     "signatures": ["a", "b", "c"], "compile_ms": 12.5,
     "last_step_ms": 1.25, "h2d_bytes": 2048, "d2h_bytes": 1024,
     "storms": 0},
    {"fn": "trainer.grpo_step", "calls": 4, "compiles": 4,
     "signatures": ["x"], "compile_ms": 80.0, "last_step_ms": 9.5,
     "h2d_bytes": 4096, "d2h_bytes": 64, "storms": 1},
]

FLEET = [
    {"incident_id": 1, "alert": "kv_pressure_high",
     "candidates": [{"cause": "kv_evictions", "score": 0.9}],
     "worst_peer": "serve-1", "summary": "kv_pressure_high: kv_evictions"},
    {"rollups": {"senweaver_kv_pressure": {
        "sum": 0.9, "min": 0.1, "max": 0.8, "worst_peer": "serve-1",
        "worst_value": 0.8}, "senweaver_learner_steps_total": {
        "sum": 12.0}}, "peers": {"serve-1": {"stale": False},
                                 "learner-1": {"stale": True}},
     "alerts": {"kv_pressure_high": {"firing": True, "value": 0.9},
                "slo_burn_fast": {"firing": False, "value": 0.1}}},
    {"incident_id": 2, "alert": "fleet_peer_stale",
     "candidates": [{"cause": "peer_unreachable"}],
     "worst_peer": "learner-1"},
    {"incident_id": 3, "alert": "slo_burn_fast", "candidates": []},
]

EXEMPLARS = [
    {"priority": "interactive", "violations": ["ttft_s", "e2e_s"],
     "derived": {"ttft_s": 0.5, "tpot_s": 0.0125, "queue_wait_s": 0.25,
                 "e2e_s": 1.0}},
    {"priority": "interactive", "violations": [],
     "derived": {"ttft_s": 0.003, "tpot_s": 0.001, "e2e_s": 0.01}},
    {"priority": "train_rollout", "violations": ["tpot_s"],
     "derived": {"ttft_s": 2.0, "tpot_s": 0.5}},
]


def _write_jsonl(path, records, torn=True):
    with open(path, "w") as f:
        for r in records:
            f.write(json.dumps(r) + "\n")
        if torn:
            f.write('{"event": "Serving Snap')    # a crash mid-write


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    d = tmp_path_factory.mktemp("reports")
    paths = {k: str(d / f"{k}.jsonl") for k in (
        "metrics", "health", "runtime", "fleet", "exemplars", "spans")}
    _write_jsonl(paths["metrics"], METRICS)
    _write_jsonl(paths["health"], HEALTH, torn=False)
    _write_jsonl(paths["runtime"], RUNTIME)
    _write_jsonl(paths["fleet"], FLEET, torn=False)   # read strictly
    _write_jsonl(paths["exemplars"], EXEMPLARS)
    tracer = obs.Tracer(enabled=True)
    for i in range(3):
        with tracer.span("grpo_round", round=i):
            with tracer.span("collect"):
                with tracer.span("rpc.client.submit"):
                    with tracer.span("rpc.server.submit", replayed=i == 1):
                        pass
            with tracer.span("train_step"):
                pass
    tracer.export_jsonl(paths["spans"])
    # a small package for the static-analysis gate: one module with a
    # host sync in a jitted-style hot path and an unguarded global write
    pkg = d / "pkg"
    pkg.mkdir()
    (pkg / "__init__.py").write_text("")
    (pkg / "hot.py").write_text(
        "import threading\n\n_lock = threading.Lock()\n_count = 0\n\n\n"
        "def bump():\n    global _count\n    _count += 1\n    return _count\n")
    paths["pkg"] = str(pkg)
    paths["baseline"] = str(d / "baseline.json")
    with open(paths["baseline"], "w") as f:
        json.dump({"entries": [{"rule": "LCK999", "path": "pkg/gone.py",
                                "symbol": "gone", "reason": "stale"}]}, f)
    return paths


# (script, argv): each JSONL / file mode of the reports; {name} is a
# fixture path
JSONL_MODES = [
    ("kv_quant", ["{metrics}"]),
    ("kv_pressure", ["{metrics}"]),
    ("spec", ["{metrics}"]),
    ("group_tree", ["{metrics}"]),
    ("learner", ["{metrics}"]),
    ("remote_fleet", ["{metrics}"]),
    ("slo", ["{exemplars}"]),
    ("fleet_obs", ["{fleet}"]),
    ("training_health", ["{health}"]),
    ("serve", ["{metrics}"]),
    ("prefix", ["{metrics}"]),
    ("resilience", ["{metrics}"]),
    ("obs", ["{spans}", "--sort", "count", "--health", "{health}",
             "--runtime", "{runtime}", "--fleet", "{fleet}",
             "--incidents", "2"]),
    ("obs", ["{spans}", "--top", "2", "--sort", "name"]),
    ("analysis", ["--root", "{pkg}", "--baseline", "{baseline}"]),
    ("analysis", ["--root", "{pkg}", "--baseline", "{baseline}",
                  "--json"]),
]


def _main(name, argv, monkeypatch):
    """stdout and exit code of ``scripts/<name>.py``'s main on argv."""
    mod = _load(name)
    monkeypatch.setattr(sys, "argv", [name + ".py", *argv])
    buf, code = io.StringIO(), None
    with contextlib.redirect_stdout(buf):
        try:
            code = mod.main()
        except SystemExit as e:
            code = e.code
    return buf.getvalue(), code


@pytest.mark.parametrize("name,argv", JSONL_MODES,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(JSONL_MODES)])
def test_jsonl_mode_prints_what_jax_prints(name, argv, fixtures,
                                           monkeypatch):
    argv = [a.format(**fixtures) for a in argv]
    want, want_code = _main(f"{name}_report", argv, monkeypatch)
    got, got_code = _main(f"torch_{name}_report", argv, monkeypatch)
    assert want.strip(), "the JAX report printed nothing"
    assert got == want
    assert got_code == want_code


def test_analysis_report_defaults_to_the_port(monkeypatch):
    """With no arguments the port's report lints the port's package
    against the port's own baseline (the gate itself passing on the port
    is tests/test_torch_analysis.py's and the training-health
    selftest's)."""
    mod = _load("torch_analysis_report")
    seen = []

    def summarize(root, baseline):
        seen.append((root, baseline))
        return {"gate_passes": True}
    monkeypatch.setattr(mod, "summarize", summarize)
    monkeypatch.setattr(sys, "argv", ["torch_analysis_report.py", "--json"])
    with contextlib.redirect_stdout(io.StringIO()):
        assert mod.main() == 0
    pkg = os.path.join(ROOT, "senweaver_ide_tpu_torch")
    assert seen == [(pkg, os.path.join(pkg, "analysis", "baseline.json"))]


def test_obs_report_contract_round_trips_on_the_port(monkeypatch):
    out, code = _main("torch_obs_report", ["--contract"], monkeypatch)
    assert code == 0 and "round-trip: EXACT" in out
