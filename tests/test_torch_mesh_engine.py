"""The port's tensor-parallel engine (``RolloutEngine(mesh=)``) against
the JAX package's mesh engine and the port's own one-rank slot engine:
greedy streams token for token with their log-probs, on a tp=2 mesh
(tests/test_engine.py:167), on a dp2/fsdp2/tp2 mesh over int8 weights
(tests/test_weight_quant.py:141), through ``update_params`` and a
registered prefix, and with MoE layers on a dp2/tp2 mesh.

The port's ranks run in a pool of gloo processes (``torch_mesh_pool``);
JAX runs here on the 8 virtual CPU devices of ``conftest.py``."""

import jax
import numpy as np
import pytest
import torch

import torch_mesh_pool as tmp
from senweaver_ide_tpu.models import get_config as jget_config
from senweaver_ide_tpu.models import init_params as jax_init_params
from senweaver_ide_tpu.models.quantize import quantize_weights_int8
from senweaver_ide_tpu.parallel import MeshConfig as JMeshConfig
from senweaver_ide_tpu.parallel import make_mesh as jmake_mesh
from senweaver_ide_tpu.parallel import make_named_mesh as jnamed
from senweaver_ide_tpu.rollout import EngineConfig as JaxEngineConfig
from senweaver_ide_tpu.rollout import RolloutEngine as JaxEngine
from senweaver_ide_tpu.rollout.sampler import SampleParams as JaxSample
from senweaver_ide_tpu_torch.models import params_from_numpy
from senweaver_ide_tpu_torch.models import config as tconfig
from senweaver_ide_tpu_torch.models.quantize import \
    quantize_weights_int8 as tquantize
from senweaver_ide_tpu_torch.rollout import (EngineConfig, RolloutEngine,
                                             SampleParams)

# the behaviour log-probs of the same greedy tokens through two
# frameworks' fp32 cache forwards (tests/test_torch_engine.py's bound)
LOGP_ATOL = 1e-4
PROMPTS = [list(range(1, 20)), [5, 9, 2, 7], list(range(40, 71)),
           [3, 3, 3, 8, 1, 2]]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def pool():
    p = tmp.RankPool(8)
    yield p
    p.close()


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _jax_streams(params, cfg, mesh, prompts, new, publish=None):
    eng = JaxEngine(params, cfg, num_slots=4, max_len=64, seed=3,
                    sample=JaxSample(0.0, 0, 1.0), mesh=mesh)

    def wave():
        rids = [eng.submit(p, max_new_tokens=new) for p in prompts]
        eng.run()
        return [(eng.result(r), eng.result_logps(r)) for r in rids]

    first = wave()
    second = None
    if publish is not None:
        eng.update_params(publish)
        second = wave()
    return eng, first, second


def _port_slot_streams(params, cfg, prompts, new, publish=None):
    eng = RolloutEngine(params, cfg, num_slots=4, max_len=64, seed=3,
                        sample=SampleParams(0.0, 0, 1.0), device="cpu",
                        engine_config=EngineConfig(kv_layout="slots"))

    def wave():
        rids = [eng.submit(p, max_new_tokens=new) for p in prompts]
        eng.run()
        return [(eng.result(r), eng.result_logps(r)) for r in rids]

    first = wave()
    second = None
    if publish is not None:
        eng.update_params(publish)
        second = wave()
    return first, second


def _same_streams(got, want):
    for (gt, gl), (wt, wl) in zip(got, want):
        assert gt == wt
        np.testing.assert_allclose(gl, wl, atol=LOGP_ATOL)


def test_tp_engine_streams_match_jax_and_one_rank(pool):
    """tp=2: every rank emits the same greedy streams, equal token for
    token to JAX's tp=2 engine and to the port's one-rank slot engine,
    before and after update_params; each rank's cache holds one of the
    two KV heads; a prefix request's stream, and the exported prefix
    carries both heads."""
    cfg = jget_config("tiny-test")
    params = jax_init_params(cfg, jax.random.PRNGKey(0))
    new_params = jax_init_params(cfg, jax.random.PRNGKey(9))
    mesh = jnamed({"tp": 2}, devices=jax.devices()[:2])
    jeng, jfirst, jsecond = _jax_streams(params, cfg, mesh, PROMPTS, 8,
                                         publish=new_params)
    assert jeng.kv_layout_fallback == "tensor-parallel KV sharding"
    tcfg = tconfig.tiny_test()
    tfirst, tsecond = _port_slot_streams(
        params_from_numpy(_np(params), device="cpu"), tcfg, PROMPTS, 8,
        publish=params_from_numpy(_np(new_params), device="cpu"))
    prefix = list(range(10, 30))
    outs = pool.run(tmp.sc_engine, _np(params), "tiny-test", "named",
                    {"tp": 2}, PROMPTS, 8, publish_np=_np(new_params),
                    prefix=prefix)
    ref_eng = RolloutEngine(params_from_numpy(_np(params), device="cpu"),
                            tcfg, num_slots=4, max_len=64, seed=3,
                            sample=SampleParams(0.0, 0, 1.0), device="cpu",
                            engine_config=EngineConfig(kv_layout="slots"))
    pid = ref_eng.register_prefix(prefix)
    rid = ref_eng.submit(prefix + [7, 9], max_new_tokens=8, prefix_id=pid)
    ref_eng.run()
    for o in outs[:2]:
        assert o["layout"] == ("slots", "tensor-parallel KV sharding")
        assert o["cache_heads"] == 1
        assert o["first"] == outs[0]["first"]        # lockstep ranks
        _same_streams(o["first"], jfirst)
        _same_streams(o["first"], tfirst)
        _same_streams(o["second"], jsecond)
        _same_streams(o["second"], tsecond)
        assert o["prefix"][0] == ref_eng.result(rid)
        np.testing.assert_allclose(o["prefix"][1], ref_eng.result_logps(rid),
                                   atol=LOGP_ATOL)
        assert o["export_heads"] == 2


@pytest.mark.parametrize("tied", [False, True])
def test_dp_fsdp_tp_quantized_engine(pool, tied):
    """tests/test_weight_quant.py:141 (and :233, a tied head's int8
    shadow) on the port: int8 weights on a dp2/fsdp2/tp2 mesh (slots
    replicated over the data axes): every rank's greedy streams equal
    JAX's mesh engine's and the port's one-rank int8 slot engine's; a
    full-precision publish is re-quantized and placed through the same
    specs."""
    import dataclasses
    over = {"tie_word_embeddings": True} if tied else {}
    cfg = dataclasses.replace(jget_config("tiny-test"), **over)
    params = jax_init_params(cfg, jax.random.PRNGKey(0))
    qparams = quantize_weights_int8(params)
    new_params = jax_init_params(cfg, jax.random.PRNGKey(3))
    mesh = jmake_mesh(JMeshConfig(dp=2, fsdp=2, tp=2))
    prompts = PROMPTS[:3]
    _, jfirst, jsecond = _jax_streams(qparams, cfg, mesh, prompts, 6,
                                      publish=new_params)
    tcfg = dataclasses.replace(tconfig.tiny_test(), **over)
    tfirst, tsecond = _port_slot_streams(
        tquantize(params_from_numpy(_np(params), device="cpu")), tcfg,
        prompts, 6, publish=params_from_numpy(_np(new_params),
                                              device="cpu"))
    outs = pool.run(tmp.sc_engine, _np(params), "tiny-test", "mesh",
                    {"dp": 2, "fsdp": 2, "tp": 2}, prompts, 6, int8=True,
                    publish_np=_np(new_params), cfg_over=over)
    for o in outs:
        assert o["quantized_after_publish"]
        assert o["first"] == outs[0]["first"]
        assert o["second"] == outs[0]["second"]
        _same_streams(o["first"], jfirst)
        _same_streams(o["first"], tfirst)
        _same_streams(o["second"], jsecond)
        _same_streams(o["second"], tsecond)


def test_moe_engine_on_data_axes_routes_its_whole_batch(pool):
    """tiny-moe-test (capacity 1.25: assignments dropped) on a dp2/tp2
    mesh: the slots are replicated over dp, so each MoE layer routes the
    engine's whole batch with its own capacity, as the one-rank engine
    does. Every rank's greedy streams and log-probs equal JAX's slot
    engine's and the port's one-rank slot engine's."""
    cfg = jget_config("tiny-moe-test")
    params = jax_init_params(cfg, jax.random.PRNGKey(0))
    jeng = JaxEngine(params, cfg, num_slots=4, max_len=64, seed=3,
                     sample=JaxSample(0.0, 0, 1.0),
                     engine_config=JaxEngineConfig(kv_layout="slots"))
    rids = [jeng.submit(p, max_new_tokens=8) for p in PROMPTS]
    jeng.run()
    jfirst = [(jeng.result(r), jeng.result_logps(r)) for r in rids]
    tfirst, _ = _port_slot_streams(
        params_from_numpy(_np(params), device="cpu"),
        tconfig.tiny_moe_test(), PROMPTS, 8)
    _same_streams(tfirst, jfirst)
    outs = pool.run(tmp.sc_engine, _np(params), "tiny-moe-test", "mesh",
                    {"dp": 2, "tp": 2}, PROMPTS, 8)
    for o in outs[:4]:
        assert o["layout"] == ("slots", "tensor-parallel KV sharding")
        assert o["first"] == outs[0]["first"]
        _same_streams(o["first"], jfirst)
    assert outs[4:] == [None] * 4
