"""The port's mixture-of-experts path against the JAX package on the same
inputs (fp32): ``moe_ffn``'s routing decisions (expert, capacity slot and
keep mask) equal JAX's dispatch tensor, outputs and aux within 1e-5, with
capacity drops and int8 banks; router and expert gradients against
``jax.grad``; ``tiny-moe-test`` logits through the no-cache, cache and
paged forwards with the aux summed; Qwen3-MoE logits against
``transformers``; a ``train_step`` with ``moe_aux``; and greedy engine
streams on both layouts, on fp32 and int8 weights, token-equal to the
JAX engine's with equal shared ``stats()``."""

import dataclasses
import os

os.environ.setdefault("USE_TF", "0")    # transformers would import TF

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from senweaver_ide_tpu import obs
from senweaver_ide_tpu.models import config as jax_config
from senweaver_ide_tpu.models import transformer as jax_tf
from senweaver_ide_tpu.models.load import load_hf_params as jax_load
from senweaver_ide_tpu.models.quantize import _quantize_matrix as jax_qm
from senweaver_ide_tpu.models.quantize import \
    quantize_weights_int8 as jax_quantize
from senweaver_ide_tpu.parallel import expert as jexp
from senweaver_ide_tpu.rollout import EngineConfig as JaxEngineConfig
from senweaver_ide_tpu.rollout import RolloutEngine as JaxEngine
from senweaver_ide_tpu.rollout import paged_kv as jax_pkv
from senweaver_ide_tpu.rollout.sampler import SampleParams as JaxSample
from senweaver_ide_tpu.training import data as jdata
from senweaver_ide_tpu.training import trainer as jtr
from senweaver_ide_tpu_torch.models import config as t_config
from senweaver_ide_tpu_torch.models import transformer as t_tf
from senweaver_ide_tpu_torch.models.load import (load_hf_params,
                                                 params_from_numpy)
from senweaver_ide_tpu_torch.models.quantize import quantize_weights_int8
from senweaver_ide_tpu_torch.parallel import expert as texp
from senweaver_ide_tpu_torch.rollout import (EngineConfig, RolloutEngine,
                                             SampleParams)
from senweaver_ide_tpu_torch.rollout import paged_kv as t_pkv
from senweaver_ide_tpu_torch.training import data as tdata
from senweaver_ide_tpu_torch.training import trainer as ttr

# fp32 functions of the same inputs through two frameworks
ATOL = RTOL = 1e-5
LOGP_ATOL = 1e-4
GREEDY = (0.0, 0, 1.0)


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


# -- parallel/expert.py ----------------------------------------------------

# (D, F, E, k, capacity factor, (B, S)); "drops" is
# tests/test_pipeline_expert.py::test_moe_capacity_drops_tokens' config
FFN_CASES = {
    "top2": (64, 128, 4, 2, 1.25, (2, 16)),
    "drops": (8, 16, 2, 1, 0.26, (1, 16)),
    "top4_tight": (32, 48, 8, 4, 0.75, (3, 8)),
    "top2_int8": (64, 128, 4, 2, 1.25, (2, 16)),
}


def _ffn_case(name):
    d, f, e, k, cf, shape = FFN_CASES[name]
    jcfg = jexp.MoEConfig(hidden_size=d, intermediate_size=f, num_experts=e,
                          top_k=k, capacity_factor=cf)
    tcfg = texp.MoEConfig(hidden_size=d, intermediate_size=f, num_experts=e,
                          top_k=k, capacity_factor=cf)
    jp = jexp.init_moe_params(jcfg, jax.random.PRNGKey(0))
    if name.endswith("int8"):
        # the banks through JAX's quantizer: (E, in, out) → int8 + (E,
        # out) scales
        jp = dict(jp)
        for n in ("w_gate", "w_up", "w_down"):
            jp[n], jp[n + "_scale"] = jax_qm(jp[n])
    x = np.random.default_rng(1).standard_normal(shape + (d,)).astype(
        np.float32)
    return jcfg, tcfg, jp, _bridge(jp), x


@pytest.mark.parametrize("case", sorted(FFN_CASES))
def test_moe_ffn_matches_jax(case):
    jcfg, tcfg, jp, tp, x = _ffn_case(case)
    jout, jaux = jexp.moe_ffn(jp, jcfg, jnp.asarray(x))
    tout, taux = texp.moe_ffn(tp, tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(float(taux), float(jaux), atol=ATOL,
                               rtol=RTOL)
    # routing decisions: the dispatch tensor JAX builds, from the port's
    # expert indices, capacity slots and keep mask
    t = x.shape[0] * x.shape[1]
    cap = texp._capacity(tcfg, t)
    assert cap == jexp._capacity(jcfg, t)
    flat = x.reshape(t, -1)
    jdisp, jcomb, _ = jexp._route(jcfg, jp["router"], jnp.asarray(flat), cap)
    r = texp._route(tcfg, tp["router"], torch.from_numpy(flat), cap)
    disp = np.zeros((t, tcfg.num_experts, cap), np.float32)
    comb = np.zeros_like(disp)
    for i, j in zip(*np.nonzero(r.keep.numpy())):
        e, c = int(r.expert_idx[i, j]), int(r.pos_in_expert[i, j])
        disp[i, e, c] = 1.0
        comb[i, e, c] = float(r.gates[i, j])
    np.testing.assert_array_equal(disp, np.asarray(jdisp))
    np.testing.assert_allclose(comb, np.asarray(jcomb), atol=1e-6)
    if case == "drops":
        dropped = ~r.keep.numpy().any(-1)
        assert dropped.any()
        rows = tout.numpy().reshape(t, -1)[dropped]
        assert not rows.any()              # exactly zero, as in JAX
        assert not np.asarray(jout).reshape(t, -1)[dropped].any()


def test_moe_gradients_match_jax():
    jcfg, tcfg, jp, tp, x = _ffn_case("top4_tight")
    ct = np.random.default_rng(2).standard_normal(x.shape).astype(np.float32)

    def jloss(p, xx):
        out, aux = jexp.moe_ffn(p, jcfg, xx)
        return jnp.sum(out * ct) + 0.7 * aux

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    live = {k: v.clone().requires_grad_() for k, v in tp.items()}
    tx = torch.from_numpy(x).requires_grad_()
    out, aux = texp.moe_ffn(live, tcfg, tx)
    ((out * torch.from_numpy(ct)).sum() + 0.7 * aux).backward()
    for k in ("router", "w_gate", "w_up", "w_down"):
        g = live[k].grad.numpy()
        assert np.abs(g).sum() > 0, k
        np.testing.assert_allclose(g, np.asarray(jg[k]), atol=ATOL,
                                   rtol=RTOL, err_msg=k)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), atol=ATOL,
                               rtol=RTOL)


def test_init_moe_params_shapes():
    cfg = texp.MoEConfig(hidden_size=16, intermediate_size=24,
                         num_experts=4, dtype=torch.bfloat16)
    p = texp.init_moe_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    jshape = jax.eval_shape(lambda: jexp.init_moe_params(
        jexp.MoEConfig(16, 24, 4), jax.random.PRNGKey(0)))
    assert {k: tuple(v.shape) for k, v in p.items()} == \
        {k: v.shape for k, v in jshape.items()}
    assert all(v.dtype == torch.bfloat16 for v in p.values())
    std = p["w_gate"].float().std().item()
    assert abs(std - 16 ** -0.5) < 0.03


# -- models/transformer.py on tiny-moe-test --------------------------------

@pytest.fixture(scope="module")
def moe_weights():
    jcfg = jax_config.tiny_moe_test()
    jparams = jax_tf.init_params(jcfg, jax.random.PRNGKey(4))
    return jparams, jcfg, _bridge(jparams), t_config.tiny_moe_test()


def test_port_init_matches_jax_structure():
    tp = t_tf.init_params(t_config.tiny_moe_test(),
                          torch.Generator().manual_seed(0), device="cpu")
    jp = jax.eval_shape(lambda: jax_tf.init_params(
        jax_config.tiny_moe_test(), jax.random.PRNGKey(0)))
    assert sorted(tp["layers"]) == sorted(jp["layers"])
    for k, v in jp["layers"].items():
        assert tuple(tp["layers"][k].shape) == v.shape, k


@pytest.mark.parametrize("masked", [False, True])
def test_forward_with_aux_matches_jax(moe_weights, masked):
    jparams, jcfg, tparams, tcfg = moe_weights
    toks = np.random.default_rng(3).integers(
        0, jcfg.vocab_size, (2, 13)).astype(np.int32)
    mask = None
    if masked:
        mask = np.ones((2, 13), bool)
        mask[1, 9:] = False
    jl, _, jaux = jax_tf.forward(
        jparams, jcfg, jnp.asarray(toks), with_aux=True,
        attn_mask=None if mask is None else jnp.asarray(mask))
    tl, none, taux = t_tf.forward(
        tparams, tcfg, torch.from_numpy(toks), with_aux=True,
        attn_mask=None if mask is None else torch.from_numpy(mask))
    assert none is None
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                               rtol=RTOL)
    assert float(taux) > 0
    np.testing.assert_allclose(float(taux), float(jaux), atol=ATOL,
                               rtol=RTOL)


def test_cache_forward_matches_jax(moe_weights):
    """Prefill then single-token steps through the contiguous cache, the
    aux summed over layers at every step as JAX's cache forward does."""
    jparams, jcfg, tparams, tcfg = moe_weights
    toks = np.random.default_rng(5).integers(
        0, jcfg.vocab_size, (3, 14)).astype(np.int32)
    jc = jax_tf.init_kv_cache(jcfg, 3, 32)
    tc = t_tf.init_kv_cache(tcfg, 3, 32, device="cpu")
    for lo, hi in ((0, 9), (9, 10), (10, 11), (11, 14)):
        jl, jc, jaux = jax_tf.forward(jparams, jcfg,
                                      jnp.asarray(toks[:, lo:hi]),
                                      cache=jc, with_aux=True)
        tl, tc, taux = t_tf.forward(tparams, tcfg,
                                    torch.from_numpy(toks[:, lo:hi]),
                                    cache=tc, with_aux=True)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=RTOL, err_msg=f"{lo}:{hi}")
        np.testing.assert_allclose(float(taux), float(jaux), atol=ATOL,
                                   rtol=RTOL)
    assert int(tc.length) == int(jc.length) == 14


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_forward_paged_matches_jax(moe_weights, use_kernel, int8):
    """One flat batch of decode, prefill, padding and rescore entries: the
    routed layers see the whole batch, capacity included."""
    jparams, jcfg, tparams, tcfg = moe_weights
    if int8:
        jparams = jax_quantize(jparams)
        tparams = quantize_weights_int8(tparams)
    rng = np.random.default_rng(6)
    nb, bs = 9, 4
    shape = (jcfg.num_layers, nb, bs, jcfg.num_kv_heads, jcfg.head_dim)
    arrs = {n: rng.standard_normal(shape).astype(np.float32)
            for n in ("k", "v")}
    jpool = jax_pkv.PagedKVPool(**{k: jnp.asarray(v)
                                   for k, v in arrs.items()})
    tpool = t_pkv.PagedKVPool(**params_from_numpy(arrs, device="cpu"))
    tables = np.array([[0, 1, 2], [3, 4, 5], [6, 7, 8]], np.int32)
    plan = [(17, 0, 5, 1, 1), (40, 1, 0, 3, 0), (41, 1, 1, 3, 1),
            (42, 1, 2, 3, 2), (43, 1, 3, 3, 3), (0, 0, 0, nb, 0),
            (99, 2, 9, 8, 1), (18, 0, 4, nb, 0)]
    cols = [np.array(c, np.int32) for c in zip(*plan)]
    jl, _ = jax_tf.forward_paged(
        jparams, jcfg, jnp.asarray(cols[0]), pool=jpool,
        tables=jnp.asarray(tables), seq_row=jnp.asarray(cols[1]),
        positions=jnp.asarray(cols[2]), write_block=jnp.asarray(cols[3]),
        write_off=jnp.asarray(cols[4]))
    tc = [torch.from_numpy(c) for c in cols]
    tl, _ = t_tf.forward_paged(
        tparams, tcfg, tc[0], pool=tpool, tables=torch.from_numpy(tables),
        seq_row=tc[1], positions=tc[2], write_block=tc[3],
        write_off=tc[4], use_kernel=use_kernel)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                               rtol=RTOL)


def test_qwen3_moe_logits_match_transformers(tmp_path):
    """tests/test_load.py's Qwen3-MoE parity config: capacity high enough
    that nothing drops (transformers has no capacity limit)."""
    transformers = pytest.importorskip("transformers")
    hf = transformers.Qwen3MoeConfig(
        vocab_size=512, hidden_size=64, intermediate_size=128,
        moe_intermediate_size=48, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, head_dim=16,
        num_experts=4, num_experts_per_tok=2, decoder_sparse_step=1,
        norm_topk_prob=True, max_position_embeddings=128,
        rope_theta=1_000_000.0, rms_norm_eps=1e-6,
        tie_word_embeddings=False, attention_bias=False, mlp_only_layers=[])
    torch.manual_seed(0)
    model = transformers.Qwen3MoeForCausalLM(hf).eval().to(torch.float32)
    model.save_pretrained(str(tmp_path), safe_serialization=True)
    kw = dict(name="qwen3-moe-parity", vocab_size=512, hidden_size=64,
              intermediate_size=48, num_layers=2, num_heads=4,
              num_kv_heads=2, head_dim=16, max_seq_len=128,
              rope_theta=1_000_000.0, qkv_bias=False, qk_norm=True,
              num_experts=4, num_experts_per_tok=2,
              expert_capacity_factor=8.0, moe_layout="qwen3",
              matmul_precision="highest")
    tcfg = t_config.ModelConfig(**kw, dtype=torch.float32)
    jcfg = jax_config.ModelConfig(**kw, dtype=jnp.float32)
    ours = load_hf_params(str(tmp_path), tcfg, device="cpu")
    ids = np.random.default_rng(8).integers(0, 512, (2, 12))
    with torch.no_grad():
        want = model(torch.tensor(ids)).logits.numpy()
        got = t_tf.forward(ours, tcfg, torch.tensor(ids)).numpy()
    jgot, _ = jax_tf.forward(jax_load(str(tmp_path), jcfg), jcfg,
                             jnp.asarray(ids, jnp.int32))
    # tests/test_load.py's HF parity tolerance
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(got, np.asarray(jgot), atol=ATOL, rtol=RTOL)


# -- training/trainer.py ---------------------------------------------------

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


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_moe_aux_matches_jax(moe_weights, accum):
    jparams, jcfg, tparams, tcfg = moe_weights
    batch, old = _batch(np.random.default_rng(9))
    js = jtr.make_train_state(jcfg, None, params=jparams,
                              learning_rate=1e-3)
    ts = ttr.make_train_state(tcfg, params=_bridge(jparams),
                              learning_rate=1e-3)
    js, jm = jtr.train_step(js, jcfg, None, **batch, num_groups=2,
                            accum_steps=accum, old_logp=jnp.asarray(old))
    ts, tm = ttr.train_step(ts, tcfg, None, **batch, num_groups=2,
                            accum_steps=accum, old_logp=old)
    assert sorted(tm) == sorted(jm) and "moe_aux" in tm
    assert float(tm["moe_aux"]) > 0
    # moe_aux: the microbatches' aux losses, token-share weighted like
    # every other metric (and like the loss term on both sides). JAX's
    # scan body rebuilds its metric accumulator from the objective's keys
    # and so reports only the last microbatch's weighted term; the port
    # reports the whole sum, checked here against JAX's own forwards.
    mb = batch["tokens"].shape[0] // accum
    tgt = batch["completion_mask"][:, 1:]
    terms = []
    for i in range(accum):
        sl = slice(i * mb, (i + 1) * mb)
        _, _, aux = jax_tf.forward(
            jparams, jcfg, jnp.asarray(batch["tokens"][sl, :-1]),
            with_aux=True)
        terms.append(float(aux) * tgt[sl].sum() / max(tgt.sum(), 1))
    np.testing.assert_allclose(float(tm["moe_aux"]), sum(terms), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(float(jm["moe_aux"]), terms[-1], atol=ATOL,
                               rtol=RTOL)
    for k in jm:
        if k != "moe_aux":
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       atol=ATOL, rtol=RTOL, err_msg=k)
    # the router moved: the aux and the gates reach it
    assert not torch.equal(ts.params["layers"]["router"],
                           tparams["layers"]["router"])


# -- rollout/engine.py -----------------------------------------------------

PROMPTS = [[5, 9, 2], [11, 3, 8, 1, 7, 7, 40, 2, 9], list(range(20, 40)),
           [300, 4], [6, 6, 6, 6, 6, 6], list(range(60, 71)),
           [8, 1, 8, 1]]


def _engines(moe_weights, layout, int8):
    jparams, jcfg, tparams, tcfg = moe_weights
    if int8:
        jparams = jax_quantize(jparams)
        tparams = quantize_weights_int8(tparams)
    kw = dict(num_slots=3, max_len=64, eos_id=None)
    jeng = JaxEngine(jparams, jcfg, sample=JaxSample(*GREEDY),
                     engine_config=JaxEngineConfig(kv_layout=layout,
                                                   block_size=4), **kw)
    teng = RolloutEngine(tparams, tcfg, sample=SampleParams(*GREEDY),
                         engine_config=EngineConfig(kv_layout=layout,
                                                    block_size=4),
                         device="cpu", **kw)
    return jeng, teng


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("layout", ["paged", "slots"])
def test_engine_streams_match_jax(moe_weights, layout, int8):
    """More requests than slots, mixed prompt buckets, mid-stream submits:
    every fused step (paged) and batched prefill (slots) routes the same
    flat batch as the JAX engine's, padding included."""
    jeng, teng = _engines(moe_weights, layout, int8)
    rids = []
    for i, p in enumerate(PROMPTS[:5]):
        rids.append(jeng.submit(p, max_new_tokens=5 + i))
        assert teng.submit(p, max_new_tokens=5 + i) == rids[-1]
    steps = 0
    while jeng.has_work or teng.has_work:
        assert jeng.step() == teng.step(), steps
        steps += 1
        if steps == 3:
            for p in PROMPTS[5:]:
                rids.append(jeng.submit(p, max_new_tokens=6))
                assert teng.submit(p, max_new_tokens=6) == rids[-1]
    for rid in rids:
        assert teng.result(rid) == jeng.result(rid), rid
        np.testing.assert_allclose(teng.result_logps(rid),
                                   jeng.result_logps(rid), atol=LOGP_ATOL)
    js, ts = jeng.stats(), teng.stats()
    shared = sorted(set(js) & set(ts))
    assert {"tokens_emitted", "decode_steps", "weight_quant"} <= set(shared)
    assert {k: ts[k] for k in shared} == {k: js[k] for k in shared}
    assert ts["weight_quant"] == int(int8)
    if layout == "paged":
        teng._alloc.check_leaks()
        jeng._alloc.check_leaks()
    else:
        assert js["batched_prefills"] > 0


def test_moe_batch_padding_widths(moe_weights):
    """The fused step's width ladder is the JAX engine's: num_slots for
    decode-only steps, step_tokens with prefill segments."""
    _, _, tparams, tcfg = moe_weights
    eng = RolloutEngine(tparams, tcfg, num_slots=3, max_len=64,
                        sample=SampleParams(*GREEDY),
                        engine_config=EngineConfig(block_size=4),
                        device="cpu")
    widths = []
    real = eng._fused_step

    def spy(toks_l, *rest):
        widths.append(len(toks_l))
        return real(toks_l, *rest)

    eng._fused_step = spy
    eng.submit(PROMPTS[2], max_new_tokens=3)
    eng.run()
    assert widths[0] == eng._step_tokens      # the prefill step
    assert set(widths[1:]) == {3}             # decode steps
