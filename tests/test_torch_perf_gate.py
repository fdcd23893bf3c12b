"""scripts/torch_perf_gate.py (the port's counterpart of
scripts/perf_gate.py): tests/test_perf_gate.py's eight tests on the
port — the hermetic selftest and the comparator's semantics (bands,
missing metrics, cached refusal, timed-window contamination), the
missing-baseline pass and the port's own baseline file — plus the
steady-window proof over the port's ledger, where a compile is a kernel
build, and three live cases on the host."""

import importlib.util
import pathlib

import pytest
import torch

import senweaver_ide_tpu_torch.obs as obs

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _load_gate(name="scripts/torch_perf_gate.py"):
    spec = importlib.util.spec_from_file_location(
        pathlib.Path(name).stem + "_test", ROOT / name)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


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
def _fresh_obs():
    obs._reset_for_tests()
    yield
    obs._reset_for_tests()


def test_selftest_passes():
    gate = _load_gate()
    assert gate.main(["--selftest", "--cpu"]) == 0


def test_comparator_flags_out_of_band_regression():
    gate = _load_gate()
    baseline = {"cached": False,
                "metrics": {"m": {"step_s": 0.010, "band": 2.0}}}
    bad = {"cached": False,
           "metrics": {"m": {"step_s": 0.025, "steady_compiles": 0}}}
    problems = gate.compare(bad, baseline)
    assert problems and "exceeds" in problems[0]


def test_comparator_passes_in_band_run():
    gate = _load_gate()
    baseline = {"cached": False,
                "metrics": {"m": {"step_s": 0.010, "band": 2.0}}}
    ok = {"cached": False,
          "metrics": {"m": {"step_s": 0.019, "steady_compiles": 0}}}
    assert gate.compare(ok, baseline) == []


def test_comparator_flags_missing_metric():
    gate = _load_gate()
    baseline = {"cached": False,
                "metrics": {"m": {"step_s": 0.010}}}
    assert any("missing" in p
               for p in gate.compare({"cached": False, "metrics": {}},
                                     baseline))


def test_comparator_refuses_cached_evidence():
    gate = _load_gate()
    baseline = {"cached": False,
                "metrics": {"m": {"step_s": 0.010}}}
    ok = {"cached": False,
          "metrics": {"m": {"step_s": 0.010, "steady_compiles": 0}}}
    assert gate.compare({**ok, "cached": True}, baseline)
    assert gate.compare(ok, {**baseline, "cached": True})
    poisoned = {"cached": False,
                "metrics": {"m": {"step_s": 0.010, "cached": True}}}
    assert any("cached" in p for p in gate.compare(poisoned, baseline))


def test_comparator_flags_contaminated_steady_window():
    gate = _load_gate()
    baseline = {"cached": False,
                "metrics": {"m": {"step_s": 0.010, "band": 2.0}}}
    dirty = {"cached": False,
             "metrics": {"m": {"step_s": 0.005, "steady_compiles": 3}}}
    assert any("timed window" in p for p in gate.compare(dirty, baseline))


def test_gate_passes_vacuously_without_baseline(tmp_path, monkeypatch,
                                               capsys):
    gate = _load_gate()
    assert gate._load_baseline(str(tmp_path / "missing.json")) is None
    (tmp_path / "junk.json").write_text("[1, 2, 3]\n")
    assert gate._load_baseline(str(tmp_path / "junk.json")) is None
    # main with no baseline passes and says so (the cases stubbed)
    monkeypatch.setattr(gate, "measure", lambda device: {
        "cached": False, "metrics": {"m": {"step_s": 1.0,
                                           "steady_compiles": 0}}})
    assert gate.main(["--cpu", "--baseline",
                      str(tmp_path / "missing.json")]) == 0
    assert "no baseline" in capsys.readouterr().err


def test_default_baseline_is_the_ports_own_file():
    """The JAX gate's committed PERF_BASELINE.json holds JAX CPU figures:
    the port's gate defaults to a file of its own, written with
    --update-baseline on the machine it gates; once one is committed it
    must be usable evidence (tests/test_perf_gate.py's last test). The
    cases and their bands are JAX's."""
    gate, jax_gate = _load_gate(), _load_gate("scripts/perf_gate.py")
    path = pathlib.Path(gate.BASELINE_PATH)
    assert path.parent == ROOT and path.name != "PERF_BASELINE.json"
    assert list(gate.CASES) == list(jax_gate.CASES)
    assert gate.CASE_BANDS == jax_gate.CASE_BANDS
    assert gate.DEFAULT_BAND == jax_gate.DEFAULT_BAND
    if path.exists():
        baseline = gate._load_baseline(str(path))
        assert baseline is not None and baseline.get("cached") is False
        assert set(baseline["metrics"]) == set(gate.CASES)
        for name, entry in baseline["metrics"].items():
            assert entry["step_s"] > 0, name
            assert entry.get("band", gate.DEFAULT_BAND) >= 1.5, name


def test_timed_window_counts_a_kernel_build():
    """A build reported through note_compile inside the timed window of
    a profiled function is a leaked compile: retried once, then
    reported, and the comparator fails the case."""
    from senweaver_ide_tpu_torch.obs.runtime_profile import (
        ProfiledFunction, note_compile)
    gate = _load_gate()
    builds = iter(range(10))

    def step(x):
        if next(builds) >= 1:           # the warmup call builds nothing
            note_compile(0.0)
        return x + 1
    fn = ProfiledFunction(step, "gate_test.step")
    fn(torch.ones(2))
    step_s, leaked = gate._timed_window(lambda: fn(torch.ones(2)),
                                        "gate_test.step", iters=2)
    assert leaked == 2 and step_s >= 0
    run = {"cached": False,
           "metrics": {"m": {"step_s": step_s, "steady_compiles": leaked}}}
    assert any("timed window" in p for p in gate.compare(
        run, {"cached": False, "metrics": {"m": {"step_s": 1.0}}}))


@pytest.mark.parametrize("case", ["engine_decode", "reward_head",
                                  "fleet_scrape"])
def test_live_case_on_the_host_has_a_clean_window(case):
    gate = _load_gate()
    entry = gate.CASES[case](torch.device("cpu"))
    assert entry["step_s"] > 0 and entry["steady_compiles"] == 0
