"""The port's observability plane against the JAX package's: one paged
engine run on ``tiny_test`` with tracing on emits the same
``senweaver_*`` metric names and span names on both sides (and the same
runtime ledger entries); the torch ``obs/runtime_profile.py`` counts
calls, signatures, kernel builds and a signature storm past its
threshold; ``sample_memory`` works on the host; ``obs._reset_for_tests``
isolates."""

import jax
import pytest
import torch

from senweaver_ide_tpu import obs as jobs
from senweaver_ide_tpu.models import init_params as jax_init_params
from senweaver_ide_tpu.models import tiny_test as jax_tiny_test
from senweaver_ide_tpu.obs import runtime_profile as jrp
from senweaver_ide_tpu.rollout import engine as jengine
from senweaver_ide_tpu.rollout import paged_kv as jpaged
from senweaver_ide_tpu.rollout import EngineConfig as JaxEngineConfig
from senweaver_ide_tpu.rollout import RolloutEngine as JaxEngine
from senweaver_ide_tpu.rollout.sampler import SampleParams as JaxSample
from senweaver_ide_tpu_torch import obs
from senweaver_ide_tpu_torch.models import params_from_numpy, tiny_test
from senweaver_ide_tpu_torch.obs import runtime_profile as rp
from senweaver_ide_tpu_torch.rollout import (EngineConfig, RolloutEngine,
                                             SampleParams)
from senweaver_ide_tpu_torch.rollout import engine as tengine
from senweaver_ide_tpu_torch.rollout import paged_kv as tpaged

PROMPTS = [[5, 9, 2], list(range(20, 40)), [300, 7]]


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


def _rearm_memory_sampling():
    """Each module-level profiled function samples device memory every
    ``mem_every`` calls, on a countdown that outlives ``_reset_for_tests``;
    rewind every countdown on both sides so that earlier tests in the
    process cannot make one side sample (and emit the memory gauges)
    inside a test while the other does not."""
    for mod in (jengine, jpaged, tengine, tpaged):
        for fn in vars(mod).values():
            if isinstance(fn, (jrp.ProfiledFunction, rp.ProfiledFunction)):
                fn._mem_countdown = fn.mem_every


@pytest.fixture(autouse=True)
def _fresh_obs():
    obs._reset_for_tests()
    jobs._reset_for_tests()
    _rearm_memory_sampling()
    yield
    obs._reset_for_tests()
    jobs._reset_for_tests()


def _run(package_obs, engine):
    tracer = package_obs.enable()
    try:
        for p in PROMPTS:
            engine.submit(p, max_new_tokens=5)
        engine.run()
    finally:
        package_obs.disable()
    names = {n for n in package_obs.get_registry().snapshot()
             if n.startswith("senweaver_")}
    return (names, {rec.name for rec in tracer.spans()},
            set(package_obs.get_profiler().ledger()))


def test_engine_run_emits_jax_metric_and_span_names():
    jcfg = jax_tiny_test()
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.device_get(jparams), device="cpu")
    # a 12-block pool of 4-token blocks, as tests/test_torch_engine.py
    # runs it
    jeng = JaxEngine(jparams, jcfg, num_slots=2, max_len=32,
                     sample=JaxSample(0.0, 0, 1.0),
                     engine_config=JaxEngineConfig(kv_layout="paged",
                                                   block_size=4,
                                                   num_blocks=12))
    jnames, jspans, jledger = _run(jobs, jeng)
    teng = RolloutEngine(tparams, tiny_test(), num_slots=2, max_len=32,
                         sample=SampleParams(0.0, 0, 1.0),
                         engine_config=EngineConfig(block_size=4,
                                                    num_blocks=12),
                         device="cpu")
    tnames, tspans, tledger = _run(obs, teng)
    assert {"senweaver_kv_blocks_total", "senweaver_engine_tokens_total",
            "senweaver_runtime_calls_total",
            "senweaver_kv_preemption_storms_total"} <= jnames
    assert tnames == jnames, (sorted(jnames - tnames),
                              sorted(tnames - jnames))
    assert tspans == jspans == {"engine.decode_step"}
    assert tledger == jledger
    assert "engine.fused_step" in tledger
    reg = obs.get_registry()
    assert reg.get("senweaver_engine_tokens_total").value() == sum(
        len(teng.result(r)) for r in range(len(PROMPTS)))
    assert reg.get("senweaver_kv_blocks_free").value() == 12
    teng._alloc.check_leaks()


def test_slot_engine_run_emits_jax_span_names():
    jcfg = jax_tiny_test()
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.device_get(jparams), device="cpu")
    jeng = JaxEngine(jparams, jcfg, num_slots=2, max_len=32,
                     sample=JaxSample(0.0, 0, 1.0),
                     engine_config=JaxEngineConfig(kv_layout="slots"))
    teng = RolloutEngine(tparams, tiny_test(), num_slots=2, max_len=32,
                         sample=SampleParams(0.0, 0, 1.0),
                         engine_config=EngineConfig(kv_layout="slots"),
                         device="cpu")
    jnames, jspans, jledger = _run(jobs, jeng)
    tnames, tspans, tledger = _run(obs, teng)
    assert tspans == jspans
    assert {"engine.decode_step", "engine.prefill"} <= tspans
    assert tledger == jledger == {"engine.decode_step"}
    assert tnames == jnames


def test_ledger_counts_calls_signatures_builds_and_storms():
    def fn(x):
        if x.shape[0] == 3:
            rp.note_compile(0.25)        # as ops/_build.py reports a build
        return x * 2

    pf = rp.ProfiledFunction(fn, "test.fn", storm_threshold=4)
    for n in (1, 1, 1, 2, 3):
        pf(torch.ones(n))
    snap = obs.get_profiler().ledger()["test.fn"]
    assert snap["calls"] == 5 and len(snap["signatures"]) == 3
    assert snap["compiles"] == 1 and snap["compile_ms"] == pytest.approx(250)
    assert snap["storms"] == 0
    for n in range(4, 9):               # new shape every call
        pf(torch.ones(n))
    snap = obs.get_profiler().ledger()["test.fn"]
    assert len(snap["signatures"]) == 8 and snap["storms"] >= 1
    reg = obs.get_registry()
    assert reg.get("senweaver_runtime_retrace_storms_total").value(
        fn="test.fn") == snap["storms"]
    assert reg.get("senweaver_runtime_calls_total").value(fn="test.fn") == 10
    assert reg.get("senweaver_runtime_compiles_total").value(
        fn="test.fn") == 1
    # skipped arguments stay out of the signature; numpy feeds count h2d
    import numpy as np
    pg = rp.ProfiledFunction(lambda p, x: x, "test.skip", skip_args=(0,))
    pg(torch.ones(3), np.zeros(4, np.float32))
    pg(torch.ones(5), np.zeros(4, np.float32))
    snap = obs.get_profiler().ledger()["test.skip"]
    assert len(snap["signatures"]) == 1 and snap["h2d_bytes"] == 32
    # a disabled profiler is a pass-through
    obs.get_profiler().set_enabled(False)
    pf(torch.ones(99))
    assert obs.get_profiler().ledger()["test.fn"]["calls"] == 10


def test_profiled_device_get_counts_device_bytes_only():
    host = rp.profiled_device_get({"a": torch.ones(4), "b": [torch.ones(2)]},
                                  fn="test.get")
    assert host["a"].device.type == "cpu" and len(host["b"]) == 1
    assert "test.get" not in obs.get_profiler().ledger()   # nothing moved


def test_sample_memory_on_the_host():
    keep = torch.ones(1024, dtype=torch.float32)
    out = obs.sample_memory()
    cpu = out["cpu"]
    assert cpu["source"] == "live_tensors"
    assert cpu["bytes_in_use"] >= keep.numel() * 4
    assert cpu["watermark_bytes"] >= cpu["bytes_in_use"]
    reg = obs.get_registry()
    assert reg.get("senweaver_runtime_live_buffer_bytes").value(
        backend="cpu") == cpu["live_buffer_bytes"]


def test_reset_for_tests_isolates():
    obs.enable()
    obs.get_registry().counter("senweaver_test_total").inc()
    rp.ProfiledFunction(lambda x: x, "test.iso")(torch.ones(1))
    with obs.get_tracer().span("test.span"):
        pass
    tracer = obs.get_tracer()
    assert [r.name for r in tracer.spans()] == ["test.span"]
    obs._reset_for_tests()
    assert obs.get_tracer() is not tracer and not obs.is_enabled()
    assert obs.get_registry().get("senweaver_test_total") is None
    assert obs.get_profiler().ledger() == {}


def test_profile_capture_writes_a_chrome_trace(tmp_path):
    from senweaver_ide_tpu_torch.services import profile_capture
    with profile_capture(None):          # no directory: a null context
        pass
    with profile_capture(str(tmp_path / "prof")):
        torch.ones(8).sum()
    files = list((tmp_path / "prof").glob("trace_*.json"))
    assert len(files) == 1 and files[0].stat().st_size > 0


def test_cost_analysis_counts_flops_once_per_signature():
    prof = obs.get_profiler()
    prof.set_cost_analysis(True)
    pf = rp.ProfiledFunction(lambda a, b: a @ b, "test.mm")
    a, b = torch.ones(8, 16), torch.ones(16, 4)
    for _ in range(3):
        pf(a, b)
    assert prof.flops_per_call("test.mm") == 2 * 8 * 16 * 4
    assert len(prof.ledger()["test.mm"]["signatures"]) == 1
    assert obs.get_registry().get("senweaver_runtime_flops_per_call").value(
        fn="test.mm") == 2 * 8 * 16 * 4
