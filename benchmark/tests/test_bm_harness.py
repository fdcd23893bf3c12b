"""Each cell's driver end to end on the port's tiny-test model on the CPU,
through the same harness, and the harness's contract around it."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import core
from benchmark.tests import tiny

BENCHMARK_CELLS = [w["name"] for w in json.load(open(os.path.join(
    core.ROOT, "BENCHMARK.json")))["workloads"]]
CELLS = BENCHMARK_CELLS + list(tiny.EXTRA)
SEED = 2 ** 31 + 2 ** 20 + 17       # past 32 signed bits
TINY_LIMITS = {"logp_gap": {"limit": 1e-3}, "sample_z": {"limit": 6.0},
               "loss_gap": {"limit": 1e-4},
               "grad_gap": {"limit": 1e-3},
               "grad_gap_median": {"limit": 1e-3},
               "change_gap": {"limit": 1e-3}}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bm"),
                          limits={c: TINY_LIMITS for c in CELLS})


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_and_is_correct(root, cell, trace):
    res, readings = core.run(cell, SEED, 1.0, trace, device="cpu", root=root)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    spec = core.load_cell(cell, root)
    if trace:
        # the device readers need the card; the counters do not
        assert set(res["metrics"]) <= {m["name"] for m in spec.per_layer}
        assert res["device"]["window_s"] > 0
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(res["metrics"]) == {m["name"] for m in spec.end_to_end}
        assert all(v["value"] > 0 for v in res["metrics"].values())
    assert readings["program"]


@pytest.mark.parametrize("cell", [c for c in CELLS if "grpo" not in c])
def test_a_step_record_that_misses_steps_fails_the_traced_run(
        root, cell, monkeypatch):
    from benchmark import serving
    monkeypatch.setattr(serving, "record_steps", lambda engine, steps: None)
    with pytest.raises(RuntimeError, match="step record"):
        core.run(cell, SEED, 1.0, True, device="cpu", root=root)


def test_every_traffic_file_names_its_sources():
    tdir = os.path.join(core.BENCH, "traffic")
    for name in os.listdir(tdir):
        with open(os.path.join(tdir, name)) as f:
            t = json.load(f)
        assert t["source"] and all(isinstance(v, str) and v
                                   for v in t["source"].values()), name


def test_same_seed_same_traffic(root):
    cell = core.load_cell("ds6.7b.group_decode", root)
    drv = core.driver("group_rollout", root)
    a = drv._Groups(core.Ctx(cell, SEED, 1, False, "cpu", None))
    b = drv._Groups(core.Ctx(cell, SEED, 1, False, "cpu", None))
    c = drv._Groups(core.Ctx(cell, SEED + 1, 1, False, "cpu", None))
    ga, gb, gc = ([g.next() for _ in range(64)] for g in (a, b, c))
    assert ga == gb and ga != gc
    # every seed gets the same sizes in the same order, other token ids
    sizes = lambda gs: [(len(p), n) for p, n in gs]  # noqa: E731
    assert sizes(ga) == sizes(gc)


def test_a_new_traffic_file_is_found(root, tmp_path):
    new = str(tmp_path / "root")
    shutil.copytree(root, new)
    tdir = os.path.join(new, "benchmark", "traffic")
    with open(os.path.join(tdir, "group_decode.json")) as f:
        t = json.load(f)
    t.update(group_size=2, num_slots=4)
    with open(os.path.join(tdir, "pairs_decode.json"), "w") as f:
        json.dump(t, f)
    spec_path = os.path.join(new, "BENCHMARK.json")
    with open(spec_path) as f:
        spec = json.load(f)
    spec["workloads"].append({"name": "tiny.pairs", "config":
                              "deepseek-coder-6.7b", "traffic":
                              "pairs_decode", "chips": 1, "why": "test"})
    for m in spec["end_to_end"]:
        if "ds6.7b.group_decode" in m.get("workloads", []):
            m["workloads"].append("tiny.pairs")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    shutil.copy(os.path.join(new, "benchmark", "limits",
                             "ds6.7b.group_decode.json"),
                os.path.join(new, "benchmark", "limits", "tiny.pairs.json"))
    res, _ = core.run("tiny.pairs", SEED, 1.0, False, device="cpu", root=new)
    assert res["correct"]
    assert set(res["metrics"]) == {"rollout_tok_s", "setup_s"}


def test_no_card_no_result(tmp_path):
    """Without a card the command fails and prints no result, also from a
    directory that holds only BENCHMARK.json and the benchmark."""
    shutil.copy(os.path.join(core.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(core.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    for cwd in (core.ROOT, str(tmp_path)):
        p = subprocess.run(
            [sys.executable, "benchmark/run.py", "--workload",
             "ds6.7b.group_decode", "--seed", str(SEED), "--seconds", "1",
             "--trace", "0"], cwd=cwd, capture_output=True, text=True,
            timeout=300, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
        assert p.returncode != 0
        assert p.stdout.strip() == ""


def test_forbidden_modules_are_named(monkeypatch):
    monkeypatch.setitem(sys.modules, "senweaver_ide_tpu.fake", object())
    assert core.forbidden_modules() == ["senweaver_ide_tpu"]
    monkeypatch.delitem(sys.modules, "senweaver_ide_tpu.fake")
    # the port's name begins with the JAX package's: compared whole
    monkeypatch.setitem(sys.modules, "senweaver_ide_tpu_torch", object())
    assert core.forbidden_modules() == []


def test_a_width_that_differs_from_the_preset_is_refused():
    cfg = dict(tiny.TINY, hidden_size=65)
    with pytest.raises(ValueError, match="hidden_size"):
        core.model_config(cfg)


def test_every_configuration_matches_its_preset():
    spec = json.load(open(os.path.join(core.ROOT, "BENCHMARK.json")))
    for c in spec["configs"]:
        with open(os.path.join(core.ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        core.model_config(cfg)


def test_every_metric_has_a_reader_and_every_cell_its_files():
    spec = json.load(open(os.path.join(core.ROOT, "BENCHMARK.json")))
    for m in spec["per_layer"]:
        assert callable(core.reader(m["name"]).read)
    for w in spec["workloads"]:
        cell = core.load_cell(w["name"])
        assert callable(core.driver(cell.traffic["kind"]).setup)
        assert cell.limits["checks"], w["name"]


def test_a_number_without_a_limit_fails_unless_it_is_not_compared():
    cell = core.load_cell("qwen1.5b.grpo_train")
    cell.limits = {"checks": {"a": {"limit": 1.0}},
                   "not_compared": {"b": "the reason"}}
    checks = core._checks(cell, {"a": 0.5, "b": 9.0, "c": 0.1})
    assert set(checks) == {"a", "c"} and checks["c"]["limit"] is None
    assert core._ok(checks["a"]) and not core._ok(checks["c"])
