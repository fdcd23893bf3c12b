"""The port's RolloutEngine on the slot layout against the JAX engine on
the same weights, greedy: token streams identical and behaviour log-probs
within 1e-4 (fp32 tiny-test config), shared stats() counters equal. Covers
a single request against generate, more requests than slots, eos freeing
a slot, mid-stream submits, batched against serial prefill, mixed
buckets in FIFO order, the kv_quant and sliding-window fallbacks from the
paged layout, a ring pool's long-prompt chunk chain, a short
sliding-window pool stopping at capacity, and a quantized kv_dtype
refused on slots."""

import dataclasses

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
                                             SampleParams, generate)

LOGP_ATOL = 1e-4
GREEDY = (0.0, 0, 1.0)


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
    return jparams, tparams


def _engines(weights, num_slots=2, max_len=64, eos_id=None, layout="slots",
             **cfg):
    jparams, tparams = weights
    jcfg = dataclasses.replace(jax_tiny_test(), **cfg)
    tcfg = dataclasses.replace(tiny_test(), **cfg)
    jeng = JaxEngine(jparams, jcfg, num_slots=num_slots, max_len=max_len,
                     sample=JaxSample(*GREEDY), eos_id=eos_id,
                     engine_config=JaxEngineConfig(kv_layout=layout))
    teng = RolloutEngine(tparams, tcfg, num_slots=num_slots,
                         max_len=max_len, sample=SampleParams(*GREEDY),
                         eos_id=eos_id,
                         engine_config=EngineConfig(kv_layout=layout),
                         device="cpu")
    assert teng.kv_layout == jeng.kv_layout
    assert teng.kv_layout_fallback == jeng.kv_layout_fallback
    assert teng.max_len == jeng.max_len
    assert teng.context_bound == jeng.context_bound
    return jeng, teng


def _submit_both(jeng, teng, prompt, **kw):
    rj = jeng.submit(prompt, **kw)
    rt = teng.submit(prompt, **kw)
    assert rj == rt
    return rt


def _assert_same(jeng, teng, rids):
    for rid in rids:
        assert teng.result(rid) == jeng.result(rid), rid
        np.testing.assert_allclose(teng.result_logps(rid),
                                   jeng.result_logps(rid), atol=LOGP_ATOL)
        assert teng.is_done(rid) and jeng.is_done(rid)
    js, ts = jeng.stats(), teng.stats()
    shared = sorted(set(js) & set(ts))
    assert {"tokens_emitted", "decode_steps", "kv_paged"} <= set(shared)
    assert {k: ts[k] for k in shared} == {k: js[k] for k in shared}


def _run_in_lockstep(jeng, teng):
    while jeng.has_work or teng.has_work:
        assert jeng.step() == teng.step()


PROMPTS = [[5, 9, 2], [11, 3, 8, 1, 7, 7, 40, 2, 9],
           list(range(20, 40)), [300], [6, 6, 6, 6, 6, 6]]


def test_single_request_matches_generate(weights):
    jeng, teng = _engines(weights)
    rid = _submit_both(jeng, teng, PROMPTS[1], max_new_tokens=9)
    _run_in_lockstep(jeng, teng)
    _assert_same(jeng, teng, [rid])
    ref = generate(weights[1], tiny_test(), torch.tensor([PROMPTS[1]]),
                   max_new_tokens=9, sample=SampleParams(*GREEDY),
                   max_len=64)
    assert teng.result(rid) == ref[0].tolist()


def test_more_requests_than_slots(weights):
    jeng, teng = _engines(weights, num_slots=2)
    rids = [_submit_both(jeng, teng, p, max_new_tokens=4 + i)
            for i, p in enumerate(PROMPTS)]
    _run_in_lockstep(jeng, teng)
    _assert_same(jeng, teng, rids)


def test_eos_frees_a_slot(weights):
    jeng, _ = _engines(weights)
    probe = jeng.submit(PROMPTS[1], max_new_tokens=8)
    eos = jeng.run()[probe][2]
    jeng, teng = _engines(weights, eos_id=eos)
    rids = [_submit_both(jeng, teng, p, max_new_tokens=8)
            for p in PROMPTS[:4]]
    _run_in_lockstep(jeng, teng)
    assert teng.result(rids[1])[-1] == eos
    assert len(teng.result(rids[1])) == 3
    _assert_same(jeng, teng, rids)


def test_mid_stream_submits(weights):
    jeng, teng = _engines(weights, num_slots=3)
    rids = [_submit_both(jeng, teng, p, max_new_tokens=10)
            for p in PROMPTS[:2]]
    for _ in range(3):
        assert jeng.step() == teng.step()
    rids += [_submit_both(jeng, teng, p, max_new_tokens=6)
             for p in PROMPTS[2:]]
    _run_in_lockstep(jeng, teng)
    _assert_same(jeng, teng, rids)


def test_batched_prefill_matches_serial(weights):
    """A burst of same-bucket prompts prefills in one batched forward;
    the streams equal those of one-at-a-time (serial) prefills."""
    burst = [[7, 1, 4], [9, 9, 2, 5], [3, 3, 8, 8, 1], [2, 40, 6]]
    jeng, teng = _engines(weights, num_slots=4)
    rids = [_submit_both(jeng, teng, p, max_new_tokens=5) for p in burst]
    _run_in_lockstep(jeng, teng)
    _assert_same(jeng, teng, rids)
    assert teng.stats()["batched_prefills"] == 1
    assert teng.stats()["batched_prefill_slots"] == 4
    serial = RolloutEngine(weights[1], tiny_test(), num_slots=4, max_len=64,
                           sample=SampleParams(*GREEDY),
                           engine_config=EngineConfig(kv_layout="slots"),
                           device="cpu")
    srids = []
    for p in burst:
        srids.append(serial.submit(p, max_new_tokens=5))
        serial.step()
    serial.run()
    assert serial.stats()["batched_prefills"] == 0
    assert [serial.result(r) for r in srids] == [teng.result(r)
                                                 for r in rids]
    for a, b in zip(srids, rids):
        np.testing.assert_allclose(serial.result_logps(a),
                                   teng.result_logps(b), atol=LOGP_ATOL)


def test_mixed_buckets_keep_fifo_order(weights):
    """Buckets 16, 32, 16: no batch forms across the 32-bucket request,
    so every prefill runs alone, in submission order."""
    prompts = [[1, 2, 3], list(range(50, 70)), [4, 5], [6, 7, 8]]
    jeng, teng = _engines(weights, num_slots=4)
    rids = [_submit_both(jeng, teng, p, max_new_tokens=4) for p in prompts]
    _run_in_lockstep(jeng, teng)
    _assert_same(jeng, teng, rids)
    assert teng.stats()["batched_prefills"] == 1     # the last two only
    assert teng.stats()["batched_prefill_slots"] == 2


@pytest.mark.parametrize("override,reason", [
    ({"kv_quant": True}, "kv_quant int8 cache"),
    ({"sliding_window": 8}, "sliding-window ring cache")])
def test_paged_request_falls_back_to_slots(weights, override, reason):
    jeng, teng = _engines(weights, num_slots=2, layout="paged", **override)
    assert teng.kv_layout == "slots"
    assert teng.kv_layout_fallback == reason
    rids = [_submit_both(jeng, teng, p, max_new_tokens=12)
            for p in PROMPTS[:3]]
    _run_in_lockstep(jeng, teng)
    _assert_same(jeng, teng, rids)


def test_ring_long_prompt_chunk_chain(weights):
    """A 21-token prompt on an 8-position ring: chunks 8, 8, 4, 1, then
    decode past the window; beside it a short request."""
    jeng, teng = _engines(weights, num_slots=2, sliding_window=8)
    assert teng.max_len == 8 and teng.context_bound == 128
    prompt = [int(x) for x in np.random.default_rng(1).integers(1, 500, 21)]
    rids = [_submit_both(jeng, teng, prompt, max_new_tokens=10),
            _submit_both(jeng, teng, PROMPTS[0], max_new_tokens=12)]
    _run_in_lockstep(jeng, teng)
    _assert_same(jeng, teng, rids)


@pytest.mark.parametrize("layout", ["slots", "paged"])
def test_short_swa_pool_stops_at_capacity(weights, layout):
    """A pool smaller than the window is a bounded absolute cache: decode
    stops at capacity, on either layout, as in the JAX engine."""
    jeng, teng = _engines(weights, num_slots=1, max_len=16, layout=layout,
                          sliding_window=64)
    assert teng.max_len == 16 and teng.kv_layout == layout
    rid = _submit_both(jeng, teng, [5, 6, 7], max_new_tokens=100)
    _run_in_lockstep(jeng, teng)
    assert len(teng.result(rid)) <= 16 - 3
    _assert_same(jeng, teng, [rid])


def test_quantized_kv_dtype_on_slots_raises(weights):
    for layout, cfg in (("slots", tiny_test()),
                        ("paged", dataclasses.replace(tiny_test(),
                                                      kv_quant=True))):
        with pytest.raises(ValueError, match="needs the paged KV layout"):
            RolloutEngine(weights[1], cfg, device="cpu",
                          engine_config=EngineConfig(kv_layout=layout,
                                                     kv_dtype="int8"))


def test_sampled_slot_run_invariants(weights):
    """temperature > 0: budgets, vocabulary range, finite log-probs ≤ 0,
    and a fixed seed reproduces the stream."""
    def run(seed):
        eng = RolloutEngine(weights[1], tiny_test(), num_slots=2, max_len=64,
                            seed=seed,
                            engine_config=EngineConfig(kv_layout="slots"),
                            device="cpu")
        rids = [eng.submit(p, max_new_tokens=7) for p in PROMPTS[:3]]
        eng.run()
        return [(eng.result(r), eng.result_logps(r)) for r in rids]

    a = run(3)
    assert a == run(3)
    for toks, logps in a:
        assert len(toks) == 7 and len(logps) == 7
        assert all(0 <= t < 512 for t in toks)
        assert all(np.isfinite(lp) and lp <= 0.0 for lp in logps)


def test_update_params_between_rounds(weights):
    """update_params swaps the weights the slot engine serves with."""
    jparams, tparams = weights
    eng = RolloutEngine(tparams, tiny_test(), num_slots=2, max_len=64,
                        sample=SampleParams(*GREEDY),
                        engine_config=EngineConfig(kv_layout="slots"),
                        device="cpu")
    rid = eng.submit(PROMPTS[2], max_new_tokens=6)
    before = eng.run()[rid]
    shifted = jax.tree_util.tree_map(lambda x: x * 1.5, jparams)
    eng.update_params(params_from_numpy(jax.device_get(shifted),
                                        device="cpu"))
    rid = eng.submit(PROMPTS[2], max_new_tokens=6)
    after = eng.run()[rid]
    jeng = JaxEngine(shifted, jax_tiny_test(), num_slots=2, max_len=64,
                     sample=JaxSample(*GREEDY),
                     engine_config=JaxEngineConfig(kv_layout="slots"))
    rid = jeng.submit(PROMPTS[2], max_new_tokens=6)
    want = jeng.run()[rid]
    assert after == want and after != before
