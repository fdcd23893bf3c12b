"""The PyTorch port's paged RolloutEngine against the JAX engine on the
same weights: greedy token streams must be identical and behaviour
log-probs within 1e-4 (fp32 tiny-test config, block_size 4), through
slot contention, mid-stream submits, eos, pool-exhaustion preemption and
the int8 KV ladder. Shared stats() counters must agree."""

import jax
import numpy as np
import pytest
import torch

from senweaver_ide_tpu import obs
from senweaver_ide_tpu.models import init_params as jax_init_params
from senweaver_ide_tpu.models import tiny_test as jax_tiny_test
from senweaver_ide_tpu.rollout import EngineConfig as JaxEngineConfig
from senweaver_ide_tpu.rollout import RolloutEngine as JaxEngine
from senweaver_ide_tpu.rollout.sampler import SampleParams as JaxSample
from senweaver_ide_tpu_torch.models import params_from_numpy, tiny_test
from senweaver_ide_tpu_torch.rollout import (EngineConfig, RolloutEngine,
                                             SampleParams)

LOGP_ATOL = 1e-4


@pytest.fixture(autouse=True)
def _fresh_obs():
    obs._reset_for_tests()
    yield
    obs._reset_for_tests()


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_tiny_test()
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.device_get(jparams), device="cpu")
    return jparams, jcfg, tparams, tiny_test()


def _engines(weights, num_slots=2, max_len=64, eos_id=None, **ec):
    jparams, jcfg, tparams, tcfg = weights
    jeng = JaxEngine(jparams, jcfg, num_slots=num_slots, max_len=max_len,
                     sample=JaxSample(0.0, 0, 1.0), eos_id=eos_id,
                     engine_config=JaxEngineConfig(kv_layout="paged",
                                                   block_size=4, **ec))
    teng = RolloutEngine(tparams, tcfg, num_slots=num_slots,
                         max_len=max_len, sample=SampleParams(0.0, 0, 1.0),
                         eos_id=eos_id,
                         engine_config=EngineConfig(block_size=4, **ec),
                         device="cpu")
    return jeng, teng


def _assert_same(jeng, teng, rids):
    for rid in rids:
        assert teng.result(rid) == jeng.result(rid), rid
        np.testing.assert_allclose(teng.result_logps(rid),
                                   jeng.result_logps(rid), atol=LOGP_ATOL)
        assert teng.is_done(rid) and jeng.is_done(rid)
    js, ts = jeng.stats(), teng.stats()
    shared = sorted(set(js) & set(ts))
    assert "kv_preemptions" in shared and "tokens_emitted" in shared
    assert {k: ts[k] for k in shared} == {k: js[k] for k in shared}
    teng._alloc.check_leaks()
    jeng._alloc.check_leaks()


def _submit_both(jeng, teng, prompt, **kw):
    rj = jeng.submit(prompt, **kw)
    rt = teng.submit(prompt, **kw)
    assert rj == rt
    return rt


PROMPTS = [[5, 9, 2], [11, 3, 8, 1, 7, 7, 40, 2, 9],
           list(range(20, 40)), [300], [6, 6, 6, 6, 6, 6]]


def test_more_requests_than_slots(weights):
    jeng, teng = _engines(weights, num_slots=2)
    rids = [_submit_both(jeng, teng, p, max_new_tokens=4 + i)
            for i, p in enumerate(PROMPTS)]
    jeng.run()
    teng.run()
    _assert_same(jeng, teng, rids)


def test_mid_stream_submits(weights):
    jeng, teng = _engines(weights, num_slots=3,
                          step_tokens=8)
    rids = [_submit_both(jeng, teng, p, max_new_tokens=10)
            for p in PROMPTS[:2]]
    for _ in range(3):
        assert jeng.step() == teng.step()
    rids += [_submit_both(jeng, teng, p, max_new_tokens=6)
             for p in PROMPTS[2:]]
    while jeng.has_work or teng.has_work:
        assert jeng.step() == teng.step()
    _assert_same(jeng, teng, rids)


def test_eos_stops_both(weights):
    jeng, _ = _engines(weights)
    probe = jeng.submit(PROMPTS[1], max_new_tokens=8)
    eos = jeng.run()[probe][2]
    jeng, teng = _engines(weights, eos_id=eos)
    rids = [_submit_both(jeng, teng, p, max_new_tokens=8)
            for p in PROMPTS[:3]]
    jeng.run()
    teng.run()
    assert teng.result(rids[1])[-1] == eos
    assert len(teng.result(rids[1])) == 3
    _assert_same(jeng, teng, rids)


def test_pool_exhaustion_preempts_like_jax(weights):
    """The preemption scenario of tests/test_paged_kv.py: 6 blocks of 4
    cannot hold two 16-token rollouts at once."""
    jeng, teng = _engines(weights, num_slots=2, num_blocks=6)
    rids = [_submit_both(jeng, teng, p, max_new_tokens=12)
            for p in ([5, 9, 2, 7], [11, 3, 8, 1])]
    jeng.run()
    teng.run()
    assert teng.stats()["kv_preemptions"] >= 1
    assert teng.stats()["kv_exhaustions"] >= 1
    _assert_same(jeng, teng, rids)


def test_int8_ladder_matches(weights):
    jeng, teng = _engines(weights, num_slots=2, kv_dtype="int8")
    rids = [_submit_both(jeng, teng, p, max_new_tokens=8)
            for p in PROMPTS[:4]]
    jeng.run()
    teng.run()
    _assert_same(jeng, teng, rids)


def test_sampled_run_invariants(weights):
    """temperature > 0 cannot match JAX's random stream; check what must
    hold: budgets, vocabulary range, finite log-probs ≤ 0, and that a
    fixed seed reproduces the stream."""
    _, _, tparams, tcfg = weights

    def run(seed):
        eng = RolloutEngine(tparams, tcfg, num_slots=2, max_len=64,
                            seed=seed,
                            engine_config=EngineConfig(block_size=4),
                            device="cpu")
        rids = [eng.submit(p, max_new_tokens=7) for p in PROMPTS[:3]]
        eng.run()
        eng._alloc.check_leaks()
        return [(eng.result(r), eng.result_logps(r)) for r in rids]

    a = run(3)
    assert a == run(3)
    for toks, logps in a:
        assert len(toks) == 7 and len(logps) == 7
        assert all(0 <= t < tcfg.vocab_size for t in toks)
        assert all(np.isfinite(lp) and lp <= 0.0 for lp in logps)


def _slot_engines(weights, cfg_override=None, **kw):
    """A JAX and a port engine on the same weights, greedy, with the
    given config override and engine keywords."""
    import dataclasses
    jparams, jcfg, tparams, tcfg = weights
    over = cfg_override or {}
    jeng = JaxEngine(jparams, dataclasses.replace(jcfg, **over),
                     num_slots=2, max_len=64, sample=JaxSample(0.0, 0, 1.0),
                     **{k: (JaxEngineConfig(**v) if k == "engine_config"
                            else v) for k, v in kw.items()})
    teng = RolloutEngine(tparams, dataclasses.replace(tcfg, **over),
                         num_slots=2, max_len=64,
                         sample=SampleParams(0.0, 0, 1.0), device="cpu",
                         **{k: (EngineConfig(**v) if k == "engine_config"
                                else v) for k, v in kw.items()})
    return jeng, teng


def _slot_parity(jeng, teng):
    rids = [_submit_both(jeng, teng, p, max_new_tokens=6)
            for p in PROMPTS[:3]]
    while jeng.has_work or teng.has_work:
        assert jeng.step() == teng.step()
    for rid in rids:
        assert teng.result(rid) == jeng.result(rid), rid
        np.testing.assert_allclose(teng.result_logps(rid),
                                   jeng.result_logps(rid), atol=LOGP_ATOL)
    js, ts = jeng.stats(), teng.stats()
    shared = sorted(set(js) & set(ts))
    assert {k: ts[k] for k in shared} == {k: js[k] for k in shared}


@pytest.mark.parametrize("kw", [
    {"engine_config": {"kv_layout": "slots"}},
    {"mesh": object()},
])
def test_slot_layout_requests_raise(weights, kw):
    """kv_layout='slots' is served now, token for token as the JAX
    engine; a tensor-parallel mesh still raises, naming its slice."""
    if "mesh" in kw:
        _, _, tparams, tcfg = weights
        with pytest.raises(NotImplementedError,
                           match="parallel-layout slice"):
            RolloutEngine(tparams, tcfg, device="cpu", **kw)
        return
    jeng, teng = _slot_engines(weights, **kw)
    assert teng.kv_layout == "slots" and teng.kv_layout_fallback is None
    assert teng.stats()["kv_paged"] == 0
    _slot_parity(jeng, teng)


@pytest.mark.parametrize("override", [{"kv_quant": True},
                                      {"sliding_window": 8}])
def test_slot_only_configs_raise(weights, override):
    """The int8 slot cache and sliding-window rings no longer raise: a
    paged request falls back to the slot layout with JAX's reason and
    serves the same greedy streams."""
    jeng, teng = _slot_engines(weights, override)
    assert teng.kv_layout == jeng.kv_layout == "slots"
    assert teng.kv_layout_fallback == jeng.kv_layout_fallback
    _slot_parity(jeng, teng)


def test_kernel_on_cpu_and_out_of_slice_submits_raise(weights):
    _, _, tparams, tcfg = weights
    with pytest.raises(ValueError, match="CUDA"):
        RolloutEngine(tparams, tcfg, device="cpu",
                      engine_config=EngineConfig(paged_kernel=True))
    eng = RolloutEngine(tparams, tcfg, device="cpu")
    for kw in ({"prefix_id": 0}, {"hold_slot": True},
               {"continue_from": 0}, {"adapter_id": "t"}):
        with pytest.raises(NotImplementedError, match="later slice"):
            eng.submit([1, 2], **kw)
    with pytest.raises(NotImplementedError, match="later slice"):
        RolloutEngine(tparams, tcfg, device="cpu", adapter_pool=object())


def test_params_on_wrong_device_raise(weights):
    _, _, tparams, tcfg = weights
    assert tparams["embed"].device.type == "cpu"
    eng = RolloutEngine(tparams, tcfg, device="cpu")
    eng.update_params(tparams)
    meta = {"embed": torch.empty(1, device="meta")}
    with pytest.raises(ValueError, match="params live on"):
        eng.update_params(meta)


def test_query_tiles_on_engine_plans(weights):
    """The kernel's query tiles, built from every fused step's flat batch
    of a CPU engine run (decode rows, then prefill segments cut by the
    step budget): they cover the entries in order, never cross a table
    row or a position gap, hold at most TILE_ROWS // rep entries (one m16
    row block of the kernel; at most 64 // rep), and keep decode rows
    alone."""
    from senweaver_ide_tpu_torch.ops.paged_attention import (
        TILE_ROWS, check_query_tiles, query_tiles)
    _, _, tparams, tcfg = weights
    rep = tcfg.num_heads // tcfg.num_kv_heads
    cap = TILE_ROWS // rep
    eng = RolloutEngine(tparams, tcfg, num_slots=3, max_len=128,
                        sample=SampleParams(0.0, 0, 1.0),
                        engine_config=EngineConfig(block_size=4,
                                                   step_tokens=40),
                        device="cpu")
    plans = []
    assemble = eng._assemble_paged_plan

    def capture():
        plan = assemble()
        if plan is not None:
            plans.append(plan)
        return plan

    eng._assemble_paged_plan = capture
    for n in (70, 45, 9, 33, 3):
        eng.submit(list(range(1, n + 1)), max_new_tokens=12)
    eng.run()
    assert plans and any(len(p[5]) and len(p[6]) for p in plans)
    long_runs = 0
    for _, rows, pos, _, _, decode_rows, _ in plans:
        tiles = query_tiles(torch.tensor(rows), torch.tensor(pos), rep)
        check_query_tiles(tiles, len(rows), rep)
        decode_idx = {i for i, _, _ in decode_rows}
        for first, count in tiles.tolist():
            span = range(first, first + count)
            assert count <= cap <= 64 // rep
            assert len({rows[i] for i in span}) == 1
            assert [pos[i] for i in span] == list(
                range(pos[first], pos[first] + count))
            if first in decode_idx:
                assert count == 1
            long_runs += count == cap
    assert long_runs > 0          # a segment longer than a tile was cut
