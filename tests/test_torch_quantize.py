"""The port's weight-only int8 path against the JAX package: the int8
values and scales equal JAX's bit for bit (stacked, MoE banks, untied and
tied heads, bf16 and fp32); logits through the no-cache, cache and paged
forwards on int8 ``tiny-test`` within 1e-5 of JAX; greedy engine streams
on int8 weights token-equal to the JAX engine's on both layouts;
``tests/test_weight_quant.py``'s cases (idempotence, the untied head, the
publish re-quantization, the trainer's ``TypeError`` and the export
refusal); and QLoRA (an int8 LoRA base trains, ``materialize_lora``
re-quantizes) against JAX."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from senweaver_ide_tpu import obs
from senweaver_ide_tpu.models import config as jax_config
from senweaver_ide_tpu.models import quantize as jq
from senweaver_ide_tpu.models import transformer as jax_tf
from senweaver_ide_tpu.rollout import EngineConfig as JaxEngineConfig
from senweaver_ide_tpu.rollout import RolloutEngine as JaxEngine
from senweaver_ide_tpu.rollout import paged_kv as jax_pkv
from senweaver_ide_tpu.rollout.sampler import SampleParams as JaxSample
from senweaver_ide_tpu.training import data as jdata
from senweaver_ide_tpu.training import lora as jlora
from senweaver_ide_tpu.training import trainer as jtr
from senweaver_ide_tpu_torch.models import config as t_config
from senweaver_ide_tpu_torch.models import quantize as tq
from senweaver_ide_tpu_torch.models import transformer as t_tf
from senweaver_ide_tpu_torch.models.load import (export_hf_params,
                                                 params_from_numpy)
from senweaver_ide_tpu_torch.rollout import (EngineConfig, RolloutEngine,
                                             SampleParams)
from senweaver_ide_tpu_torch.rollout import paged_kv as t_pkv
from senweaver_ide_tpu_torch.training import data as tdata
from senweaver_ide_tpu_torch.training import lora as tlora
from senweaver_ide_tpu_torch.training import trainer as ttr

# fp32 functions of the same inputs through two frameworks
ATOL = RTOL = 1e-5
LOGP_ATOL = 1e-4
GREEDY = (0.0, 0, 1.0)
# Adam's first step is about sign(g)·lr (tests/test_torch_trainer.py)
LR = 1e-3
PARAM_ATOL = 0.25 * LR


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


def _bridge(tree):
    return params_from_numpy(jax.device_get(tree), device="cpu")


def _bits(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _jbits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _assert_bit_equal(port, ref, path=""):
    if isinstance(ref, dict):
        assert sorted(port) == sorted(ref), path
        for k in ref:
            _assert_bit_equal(port[k], ref[k], f"{path}/{k}")
        return
    np.testing.assert_array_equal(_bits(port), _jbits(ref), err_msg=path)


# name -> (preset, overrides)
CONFIGS = {
    "tiny": ("tiny-test", {}),
    "tiny-tied": ("tiny-test", {"tie_word_embeddings": True}),
    "tiny-bf16": ("tiny-test", {"dtype": "bf16",
                                "tie_word_embeddings": True}),
    "tiny-moe": ("tiny-moe-test", {}),
}


def _configs(name):
    preset, over = CONFIGS[name]
    over = dict(over)
    bf16 = over.pop("dtype", None) == "bf16"
    jcfg = dataclasses.replace(jax_config.get_config(preset), **over)
    tcfg = dataclasses.replace(t_config.get_config(preset), **over)
    if bf16:
        jcfg = dataclasses.replace(jcfg, dtype=jnp.bfloat16)
        tcfg = dataclasses.replace(tcfg, dtype=torch.bfloat16)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def models():
    out = {}
    for name in CONFIGS:
        jcfg, tcfg = _configs(name)
        jp = jax_tf.init_params(jcfg, jax.random.PRNGKey(2))
        out[name] = (jp, jcfg, _bridge(jp), tcfg)
    return out


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_quantize_is_bit_equal_to_jax(models, name):
    jp, _, tp, _ = models[name]
    jqp, tqp = jq.quantize_weights_int8(jp), tq.quantize_weights_int8(tp)
    _assert_bit_equal(tqp, jax.device_get(jqp))
    assert tq.is_quantized(tqp) and not tq.is_quantized(tp)
    assert tq.quantized_bytes(tqp) == jq.quantized_bytes(jqp)
    assert tq.quantized_bytes(tp) == jq.quantized_bytes(jp)
    if name == "tiny-moe":
        assert tqp["layers"]["w_gate"].dtype == torch.int8
        assert tuple(tqp["layers"]["w_gate_scale"].shape) == (2, 4, 128)
        assert tqp["layers"]["router"].dtype == torch.float32
    for k, v in tp["layers"].items():        # the input is not modified
        assert v.dtype != torch.int8, k


def test_quantize_matrix_rounds_half_to_even():
    # absmax 127 → scale 1, so the codes are round(w): ties go to even
    w = torch.tensor([[0.5, 127.0], [1.5, -2.5], [-127.0, 3.5]])
    q, s = tq._quantize_matrix(w)
    jqv, js = jq._quantize_matrix(jnp.asarray(w.numpy()))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert q[:, 0].tolist() == [0, 2, -127] and q[:, 1].tolist() == \
        [127, -2, 4]


def test_dense_family_shapes_match_jax():
    for name in ("tiny-test", "qwen2.5-coder-1.5b", "mistral-7b"):
        assert tq.dense_family_shapes(t_config.get_config(name)) == \
            jq.dense_family_shapes(jax_config.get_config(name))
    with pytest.raises(ValueError, match="MoE"):
        tq.dense_family_shapes(t_config.get_config("tiny-moe-test"))


@pytest.mark.parametrize("name", ["tiny", "tiny-tied"])
def test_int8_forward_and_cache_match_jax(models, name):
    jp, jcfg, tp, tcfg = models[name]
    jqp, tqp = jq.quantize_weights_int8(jp), tq.quantize_weights_int8(tp)
    toks = np.random.default_rng(3).integers(
        0, jcfg.vocab_size, (2, 12)).astype(np.int32)
    jl, _ = jax_tf.forward(jqp, jcfg, jnp.asarray(toks))
    tl = t_tf.forward(tqp, tcfg, torch.from_numpy(toks))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                               rtol=RTOL)
    jc = jax_tf.init_kv_cache(jcfg, 2, 32)
    tc = t_tf.init_kv_cache(tcfg, 2, 32, device="cpu")
    for lo, hi in ((0, 8), (8, 9), (9, 10)):
        jl, jc = jax_tf.forward(jqp, jcfg, jnp.asarray(toks[:, lo:hi]),
                                cache=jc)
        tl, tc = t_tf.forward(tqp, tcfg, torch.from_numpy(toks[:, lo:hi]),
                              cache=tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=RTOL, err_msg=f"{lo}:{hi}")


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("name", ["tiny", "tiny-tied"])
def test_int8_forward_paged_matches_jax(models, name, use_kernel):
    jp, jcfg, tp, tcfg = models[name]
    jqp, tqp = jq.quantize_weights_int8(jp), tq.quantize_weights_int8(tp)
    rng = np.random.default_rng(4)
    nb, bs = 6, 4
    shape = (jcfg.num_layers, nb, bs, jcfg.num_kv_heads, jcfg.head_dim)
    arrs = {n: rng.standard_normal(shape).astype(np.float32)
            for n in ("k", "v")}
    jpool = jax_pkv.PagedKVPool(**{k: jnp.asarray(v)
                                   for k, v in arrs.items()})
    tpool = t_pkv.PagedKVPool(**params_from_numpy(arrs, device="cpu"))
    tables = np.array([[0, 1, 2], [3, 4, 5]], np.int32)
    plan = [(17, 0, 5, 1, 1), (40, 1, 0, 3, 0), (41, 1, 1, 3, 1),
            (0, 0, 0, nb, 0)]
    cols = [np.array(c, np.int32) for c in zip(*plan)]
    jl, _ = jax_tf.forward_paged(
        jqp, jcfg, jnp.asarray(cols[0]), pool=jpool,
        tables=jnp.asarray(tables), seq_row=jnp.asarray(cols[1]),
        positions=jnp.asarray(cols[2]), write_block=jnp.asarray(cols[3]),
        write_off=jnp.asarray(cols[4]))
    tc = [torch.from_numpy(c) for c in cols]
    tl, _ = t_tf.forward_paged(
        tqp, tcfg, tc[0], pool=tpool, tables=torch.from_numpy(tables),
        seq_row=tc[1], positions=tc[2], write_block=tc[3],
        write_off=tc[4], use_kernel=use_kernel)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                               rtol=RTOL)


# -- tests/test_weight_quant.py's cases on the port ------------------------

def test_quantized_forward_close_to_fp(models):
    _, _, tp, tcfg = models["tiny"]
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, tcfg.vocab_size, (2, 24)))
    ref = t_tf.forward(tp, tcfg, toks).numpy()
    got = t_tf.forward(tq.quantize_weights_int8(tp), tcfg, toks).numpy()
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 0.05
    assert np.mean(got.argmax(-1) == ref.argmax(-1)) > 0.9


def test_idempotent_and_smaller(models):
    _, _, tp, _ = models["tiny"]
    qp = tq.quantize_weights_int8(tp)
    assert tq.quantized_bytes(qp) < 0.62 * tq.quantized_bytes(tp)
    qp2 = tq.quantize_weights_int8(qp)
    assert qp2["layers"]["wq"] is qp["layers"]["wq"]
    _, _, tp, _ = models["tiny-tied"]
    qp = tq.quantize_weights_int8(tp)
    assert tq.quantize_weights_int8(qp)["tied_head_q8"] is \
        qp["tied_head_q8"]                            # no shadow of it
    assert qp["embed"] is tp["embed"]                 # the gather stays fp


def test_untied_head_quantized(models):
    _, _, tp, tcfg = models["tiny"]
    assert not tcfg.tie_word_embeddings
    qp = tq.quantize_weights_int8(tp)
    assert qp["lm_head"].dtype == torch.int8 and "tied_head_q8" not in qp
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, tcfg.vocab_size, (2, 16)))
    ref = t_tf.forward(tp, tcfg, toks).numpy()
    got = t_tf.forward(qp, tcfg, toks).numpy()
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 0.05


@pytest.mark.parametrize("layout", ["paged", "slots"])
def test_engine_republish_requantizes(models, layout):
    jp, jcfg, tp, tcfg = models["tiny-tied"]
    eng = RolloutEngine(tq.quantize_weights_int8(tp), tcfg, num_slots=2,
                        max_len=64, eos_id=None,
                        engine_config=EngineConfig(kv_layout=layout),
                        device="cpu")
    assert eng.stats()["weight_quant"] == 1
    fresh = t_tf.init_params(tcfg, torch.Generator().manual_seed(7),
                             device="cpu")
    eng.update_params(fresh)
    assert tq.is_quantized(eng.params) and "tied_head_q8" in eng.params
    assert eng.stats()["weight_quant"] == 1
    assert not tq.is_quantized(fresh)          # the publish is not written
    rid = eng.submit([1, 2, 3], max_new_tokens=4)
    assert len(eng.run()[rid]) == 4
    plain = RolloutEngine(tp, tcfg, num_slots=2, max_len=64, device="cpu")
    assert plain.stats()["weight_quant"] == 0


def test_train_rejects_int8_params_and_export_refuses(models, tmp_path):
    _, _, tp, tcfg = models["tiny"]
    qp = tq.quantize_weights_int8(tp)
    toks = np.ones((2, 8), np.int64)
    state = ttr.TrainState(params=qp, opt_state=None, step=0)
    with pytest.raises(TypeError, match="SERVING"):
        ttr.train_step(state, tcfg, None, toks, np.ones_like(toks, bool),
                       np.ones(2, np.float32), np.arange(2))
    with pytest.raises(TypeError, match="serving"):
        export_hf_params(qp, tcfg, str(tmp_path))


# -- engine streams on int8 weights against JAX ----------------------------

PROMPTS = [[5, 9, 2], [11, 3, 8, 1, 7, 7, 40, 2, 9], list(range(20, 40)),
           [300, 4], [6, 6, 6, 6, 6, 6]]


@pytest.mark.parametrize("layout", ["paged", "slots"])
def test_int8_engine_streams_match_jax(models, layout):
    jp, jcfg, tp, tcfg = models["tiny-tied"]
    kw = dict(num_slots=2, max_len=64, eos_id=None)
    jeng = JaxEngine(jq.quantize_weights_int8(jp), jcfg,
                     sample=JaxSample(*GREEDY),
                     engine_config=JaxEngineConfig(kv_layout=layout,
                                                   block_size=4), **kw)
    teng = RolloutEngine(tq.quantize_weights_int8(tp), tcfg,
                         sample=SampleParams(*GREEDY),
                         engine_config=EngineConfig(kv_layout=layout,
                                                    block_size=4),
                         device="cpu", **kw)
    rids = []
    for i, p in enumerate(PROMPTS):
        rids.append(jeng.submit(p, max_new_tokens=4 + i))
        assert teng.submit(p, max_new_tokens=4 + i) == rids[-1]
    while jeng.has_work or teng.has_work:
        assert jeng.step() == teng.step()
    for rid in rids:
        assert teng.result(rid) == jeng.result(rid), rid
        np.testing.assert_allclose(teng.result_logps(rid),
                                   jeng.result_logps(rid), atol=LOGP_ATOL)
    js, ts = jeng.stats(), teng.stats()
    shared = sorted(set(js) & set(ts))
    assert ts["weight_quant"] == js["weight_quant"] == 1
    assert {k: ts[k] for k in shared} == {k: js[k] for k in shared}
    if layout == "paged":
        teng._alloc.check_leaks()
        jeng._alloc.check_leaks()
    # a full-precision publish is quantized again on both sides
    fresh = jax_tf.init_params(jcfg, jax.random.PRNGKey(9))
    jeng.update_params(fresh)
    teng.update_params(_bridge(fresh))
    _assert_bit_equal(teng.params, jax.device_get(jeng.params))


# -- QLoRA ---------------------------------------------------------------

def _batch(rng, n=4):
    trajs = []
    for i in range(n):
        p = rng.integers(1, 90, rng.integers(3, 12)).tolist()
        c = rng.integers(1, 90, rng.integers(2, 14)).tolist()
        trajs.append(tdata.Trajectory(
            prompt_ids=p, completion_ids=c, reward=float(rng.random()),
            group_id=i // 2,
            behavior_logp=(rng.standard_normal(len(c)) * 0.05
                           - 6.2).tolist()))
    jtrajs = [jdata.Trajectory(**dataclasses.asdict(t)) for t in trajs]
    tokens, mask, rewards, gids = jdata.make_batch(jtrajs, pad_id=0)
    return (dict(tokens=tokens, completion_mask=mask, rewards=rewards,
                 group_ids=gids),
            jdata.make_batch_logps(jtrajs, tokens, mask))


@pytest.mark.parametrize("name", ["tiny", "tiny-moe"])
def test_qlora_int8_base_trains(models, name):
    """JAX tests/test_lora.py's case against JAX: an int8 base, adapters
    only move, metrics within 1e-5 over two steps' first, the base never
    written."""
    jp, jcfg, tp, tcfg = models[name]
    jqb, tqb = jq.quantize_weights_int8(jp), tq.quantize_weights_int8(tp)
    before = {k: v.clone() for k, v in tqb["layers"].items()}
    batch, old = _batch(np.random.default_rng(11))
    js = jtr.make_lora_train_state(jcfg, jqb, jax.random.PRNGKey(4), rank=4,
                                   learning_rate=LR)
    ts = ttr.make_train_state(tcfg, params=_bridge(js.params),
                              learning_rate=LR)
    js, jm = jtr.train_step(js, jcfg, None, **batch, num_groups=2,
                            accum_steps=2, old_logp=jnp.asarray(old),
                            lora_base=jqb)
    ts, tm = ttr.train_step(ts, tcfg, None, **batch, num_groups=2,
                            accum_steps=2, old_logp=old, lora_base=tqb)
    assert sorted(tm) == sorted(jm)
    for k in jm:
        if k == "moe_aux":       # JAX keeps the last microbatch's term
            continue             # (tests/test_torch_moe.py)
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=ATOL,
                                   rtol=RTOL, err_msg=k)
    assert np.isfinite(float(tm["loss"]))
    for path, leaf in jax.tree_util.tree_leaves_with_path(
            jax.device_get(js.params)):
        got = ts.params["layers"][path[-1].key]
        np.testing.assert_allclose(got.numpy(), np.asarray(leaf),
                                   atol=PARAM_ATOL, err_msg=str(path))
    for k, v in tqb["layers"].items():
        assert torch.equal(v, before[k]), k
    out = t_tf.forward(tlora.merge_lora(tqb, ts.params), tcfg,
                       torch.from_numpy(batch["tokens"]).long())
    assert torch.isfinite(out).all()


def test_materialize_requantizes_int8_base(models):
    jp, jcfg, tp, tcfg = models["tiny"]
    jqb, tqb = jq.quantize_weights_int8(jp), tq.quantize_weights_int8(tp)
    jl = jlora.init_lora(jcfg, jax.random.PRNGKey(7), rank=4)
    # B with real values, so the fold changes the weights
    jl["layers"] = {k: (jax.random.normal(jax.random.PRNGKey(6), v.shape,
                                          v.dtype) * 0.02
                        if k.endswith("_lora_b") else v)
                    for k, v in jl["layers"].items()}
    tl = _bridge(jl)
    jf = jax.device_get(jlora.materialize_lora(jqb, jl, jcfg))
    tf = tlora.materialize_lora(tqb, tl, tcfg)
    assert tf["layers"]["wq"].dtype == torch.int8
    assert not any("_lora_" in k for k in tf["layers"])
    for name in ("wq", "wk", "wv", "wo"):
        # the fp32 A·B may differ in its last bit, which can move a code
        # that sits on a rounding edge by one; the scales stay put
        d = np.abs(tf["layers"][name].numpy().astype(int)
                   - np.asarray(jf["layers"][name]).astype(int))
        assert d.max() <= 1 and d.mean() < 1e-3, name
        np.testing.assert_allclose(tf["layers"][name + "_scale"].numpy(),
                                   np.asarray(jf["layers"][name + "_scale"]),
                                   rtol=1e-6)
    for name in ("w_gate", "w_up", "w_down"):      # untouched targets
        assert tf["layers"][name] is tqb["layers"][name]
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, tcfg.vocab_size, (2, 16)))
    jout, _ = jax_tf.forward(jf, jcfg, jnp.asarray(toks.numpy(), jnp.int32))
    torch.testing.assert_close(t_tf.forward(tf, tcfg, toks),
                               torch.from_numpy(np.array(jout)),
                               atol=1e-3, rtol=1e-3)
    # JAX's case: a zero-delta fold round-trips the quantization
    zero = tlora.init_lora(tcfg, torch.Generator().manual_seed(0), rank=4,
                           device="cpu")
    folded = tlora.materialize_lora(tqb, zero, tcfg)
    assert folded["layers"]["wq"].dtype == torch.int8
    torch.testing.assert_close(t_tf.forward(folded, tcfg, toks),
                               t_tf.forward(tqb, tcfg, toks),
                               atol=5e-2, rtol=5e-2)
