"""The port's training path against the JAX package on the same inputs
(fp32 tiny-test config, ``matmul_precision="highest"``): every GRPO
function and metric, the batch builders array for array, the AdamW chain
against the optax chain, and one and three ``train_step``s (einsum and
flash attention, accum_steps 1 and 2, old/ref log-probs and branch
credit, LoRA) against JAX ``train_step``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from senweaver_ide_tpu.models import init_params as jax_init_params
from senweaver_ide_tpu.models import tiny_test as jax_tiny_test
from senweaver_ide_tpu.training import data as jdata
from senweaver_ide_tpu.training import grpo as jgrpo
from senweaver_ide_tpu.training import lora as jlora
from senweaver_ide_tpu.training import trainer as jtr
from senweaver_ide_tpu_torch.models import params_from_numpy, tiny_test
from senweaver_ide_tpu_torch.models.transformer import count_params, forward
from senweaver_ide_tpu_torch.training import async_loop as tasync
from senweaver_ide_tpu_torch.training import data as tdata
from senweaver_ide_tpu_torch.training import grpo as tgrpo
from senweaver_ide_tpu_torch.training import lora as tlora
from senweaver_ide_tpu_torch.training import trainer as ttr

# fp32 functions of the same inputs: summation order only
FN_ATOL = 1e-6
# train_step metrics at the first step: the same loss through two
# frameworks' fp32 forward and backward (observed <= 2e-6)
STEP1_ATOL = STEP1_RTOL = 1e-5
# after three steps the params already differ (below), and the metrics
# follow them (observed <= 1.2e-4 on a grad_norm of 8.8)
STEP3_ATOL = STEP3_RTOL = 5e-4
LR = 1e-3
# Updated params: Adam's first steps are sign-like, u = g / (|g| + eps),
# so where |g| is within a few eps of 0 an fp32 rounding difference in g
# moves u by up to a whole step of size lr. Most elements agree to 1e-6;
# the worst stays a fraction of one step (observed 1.3e-4 at lr 1e-3).
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


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _assert_tree_close(jtree, ttree, atol, rtol=0.0):
    for path, leaf in jax.tree_util.tree_leaves_with_path(
            jax.device_get(jtree)):
        node = ttree
        for p in path:
            node = node[p.key]
        np.testing.assert_allclose(node.detach().numpy(), np.asarray(leaf),
                                   atol=atol, rtol=rtol, err_msg=str(path))


# -- grpo.py ------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    {}, {"normalize_std": False}, {"leave_one_out": True},
    {"min_std": 0.5}])
def test_group_relative_advantages_match(rng, kw):
    rewards = rng.standard_normal(9).astype(np.float32)
    rewards[6:8] = 1.5                       # a tied group member pair
    gids = np.array([0, 0, 0, 1, 1, 2, 3, 3, 4], np.int32)
    want = jgrpo.group_relative_advantages(jnp.asarray(rewards),
                                           jnp.asarray(gids), 6, **kw)
    got = tgrpo.group_relative_advantages(_t(rewards), _t(gids), 6, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=FN_ATOL, rtol=FN_ATOL)


def _mask(rng, b=4, s=12):
    m = np.zeros((b, s), bool)
    for i in range(b - 1):
        lo = rng.integers(0, s // 2)
        m[i, lo:rng.integers(lo + 1, s + 1)] = True
    return m                                  # last row has no tokens


@pytest.mark.parametrize("gamma,boost", [(0.9, 0.0), (1.0, 0.0),
                                         (0.98, 0.5)])
def test_credit_weights_match(rng, gamma, boost):
    m = _mask(rng)
    br = (rng.random(m.shape) > 0.7).astype(np.float32)
    np.testing.assert_allclose(
        tgrpo.token_credit_weights(_t(m), gamma).numpy(),
        np.asarray(jgrpo.token_credit_weights(jnp.asarray(m), gamma)),
        atol=FN_ATOL, rtol=FN_ATOL)
    np.testing.assert_allclose(
        tgrpo.branch_credit_weights(_t(m), _t(br), gamma=gamma,
                                    boost=boost).numpy(),
        np.asarray(jgrpo.branch_credit_weights(
            jnp.asarray(m), jnp.asarray(br), gamma=gamma, boost=boost)),
        atol=FN_ATOL, rtol=FN_ATOL)


def test_token_logprobs_match(rng):
    logits = (rng.standard_normal((2, 5, 31)) * 3).astype(np.float32)
    tgt = rng.integers(0, 31, (2, 5)).astype(np.int32)
    np.testing.assert_allclose(
        tgrpo.token_logprobs(_t(logits), _t(tgt)).numpy(),
        np.asarray(jgrpo.token_logprobs(jnp.asarray(logits),
                                        jnp.asarray(tgt))),
        atol=FN_ATOL, rtol=FN_ATOL)


@pytest.mark.parametrize("variant", ["plain", "ref_kl", "token_level",
                                     "branch", "per_token_adv", "entropy"])
def test_grpo_objective_matches(rng, variant):
    b, s = 4, 12
    m = _mask(rng, b, s)
    logp = (rng.standard_normal((b, s)) * 0.3 - 2).astype(np.float32)
    old = (logp + rng.standard_normal((b, s)) * 0.3).astype(np.float32)
    ref = (logp + rng.standard_normal((b, s)) * 0.1).astype(np.float32)
    adv = rng.standard_normal(b).astype(np.float32)
    adv[1] = 0.0                               # a zero-advantage row
    br = (rng.random((b, s)) > 0.6).astype(np.float32)
    cfg = {"plain": {}, "ref_kl": {"kl_coef": 0.1},
           "token_level": {"token_level_advantages": True},
           "branch": {"branch_credit_boost": 0.7},
           "per_token_adv": {}, "entropy": {"entropy_coef": 0.01}}[variant]
    if variant == "per_token_adv":
        adv = rng.standard_normal((b, s)).astype(np.float32)
    kw_t, kw_j = {}, {}
    if variant == "ref_kl":
        kw_t["ref_logp"], kw_j["ref_logp"] = _t(ref), jnp.asarray(ref)
    if variant == "branch":
        kw_t["branch_mask"], kw_j["branch_mask"] = _t(br), jnp.asarray(br)
    jl, jm = jgrpo.grpo_objective(jnp.asarray(logp), jnp.asarray(old),
                                  jnp.asarray(adv), jnp.asarray(m),
                                  jgrpo.GRPOConfig(**cfg), **kw_j)
    tl, tm = tgrpo.grpo_objective(_t(logp), _t(old), _t(adv), _t(m),
                                  tgrpo.GRPOConfig(**cfg), **kw_t)
    assert sorted(tm) == sorted(jm)
    np.testing.assert_allclose(float(tl), float(jl), atol=FN_ATOL,
                               rtol=FN_ATOL)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                   atol=FN_ATOL, rtol=FN_ATOL, err_msg=k)


def test_grpo_config_defaults_match():
    assert tgrpo.GRPOConfig()._asdict() == jgrpo.GRPOConfig()._asdict()


# -- data.py -------------------------------------------------------------


def _trajectories(rng, n=5, with_logps=True, with_branches=True):
    out = []
    for i in range(n):
        p = rng.integers(1, 90, rng.integers(2, 20)).tolist()
        c = rng.integers(1, 90, rng.integers(1, 30)).tolist()
        out.append(tdata.Trajectory(
            prompt_ids=p, completion_ids=c, reward=float(rng.random()),
            group_id=i // 2,
            behavior_logp=(rng.standard_normal(len(c)).tolist()
                           if with_logps else None),
            branch_points=([0, len(c) // 2, len(c) + 3] if with_branches
                           and i % 2 else None)))
    return out


@pytest.mark.parametrize("max_len", [None, 16])
def test_batch_builders_match(rng, max_len):
    trajs = _trajectories(rng)
    jtrajs = [jdata.Trajectory(**dataclasses.asdict(t)) for t in trajs]
    got = tdata.make_batch(trajs, pad_id=3, max_len=max_len)
    want = jdata.make_batch(jtrajs, pad_id=3, max_len=max_len)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    tok, mask = got[0], got[1]
    np.testing.assert_array_equal(tdata.make_batch_logps(trajs, tok, mask),
                                  jdata.make_batch_logps(jtrajs, tok, mask))
    np.testing.assert_array_equal(tdata.make_branch_mask(trajs, tok, mask),
                                  jdata.make_branch_mask(jtrajs, tok, mask))
    bare = _trajectories(rng, with_logps=False, with_branches=False)
    tok, mask, _, _ = tdata.make_batch(bare, pad_id=0)
    assert tdata.make_batch_logps(bare, tok, mask) is None
    assert tdata.make_branch_mask(bare, tok, mask) is None
    assert tdata._bucket(33) == jdata._bucket(33) == 64


# -- the optimizer -------------------------------------------------------


@pytest.mark.parametrize("kw", [
    {"max_grad_norm": 1e6},                          # no clipping
    {"max_grad_norm": 0.5},                          # clipping every step
    {"max_grad_norm": 0.5, "weight_decay": 0.1},
    {"max_grad_norm": 0.5, "warmup_steps": 2},
])
def test_adamw_chain_matches_optax(rng, kw):
    params = {"a": rng.standard_normal((7, 5)).astype(np.float32),
              "b": {"c": rng.standard_normal(11).astype(np.float32)}}
    grads = [{"a": (rng.standard_normal((7, 5)) * 0.3).astype(np.float32),
              "b": {"c": (rng.standard_normal(11) * 0.3).astype(
                  np.float32)}} for _ in range(3)]
    jopt = jtr.make_optimizer(1e-2, **kw)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = jopt.init(jp)
    topt = ttr.make_optimizer(1e-2, **kw)
    tp = params_from_numpy(params, device="cpu")
    ts = topt.init(tp)
    for g in grads:
        upd, js = jopt.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, upd)
        ts = topt.update(params_from_numpy(g, device="cpu"), ts, tp)
        # same fp32 arithmetic in the same order: ulp-level agreement
        _assert_tree_close(jp, tp, atol=1e-7, rtol=1e-6)
    assert ts.count == 3
    _assert_tree_close(js[1][0].mu, ts.mu, atol=1e-7, rtol=1e-6)
    _assert_tree_close(js[1][0].nu, ts.nu, atol=1e-9, rtol=1e-6)
    if kw.get("warmup_steps"):            # lr 0 at the first update
        assert topt.step_size(0) == 0.0
        assert topt.step_size(1) == pytest.approx(-5e-3)
    assert ttr.make_optimizer(1e-2, **kw) is topt


def test_unclipped_adamw_is_optax_adam(rng):
    """``max_grad_norm=None, b2=0.999``: optax's ``adam``, the update the
    JAX package's rule proposer trains with."""
    params = {"a": rng.standard_normal((7, 5)).astype(np.float32),
              "b": {"c": rng.standard_normal(11).astype(np.float32)}}
    jopt = optax.adam(1e-2)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = jopt.init(jp)
    topt = ttr.AdamW(learning_rate=1e-2, max_grad_norm=None, b2=0.999)
    tp = params_from_numpy(params, device="cpu")
    ts = topt.init(tp)
    for _ in range(3):
        # large gradients: a clipping chain would scale these
        g = {"a": (rng.standard_normal((7, 5)) * 30).astype(np.float32),
             "b": {"c": (rng.standard_normal(11) * 30).astype(np.float32)}}
        upd, js = jopt.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, upd)
        ts = topt.update(params_from_numpy(g, device="cpu"), ts, tp)
        _assert_tree_close(jp, tp, atol=1e-7, rtol=1e-6)
    _assert_tree_close(js[0].mu, ts.mu, atol=1e-7, rtol=1e-6)
    _assert_tree_close(js[0].nu, ts.nu, atol=1e-9, rtol=1e-6)


def test_flatten_params_names_in_jax_leaf_order(rng):
    tree = {"z": np.float32(1), "layers": {"wq": np.float32(2),
                                          "bq": np.float32(3)},
            "embed": np.float32(4)}
    pairs = list(ttr.flatten_params(tree))
    assert [n for n, _ in pairs] == ["embed", "layers/bq", "layers/wq", "z"]
    assert [v for _, v in pairs] == jax.tree_util.tree_leaves(tree)
    assert ttr.unflatten_params(pairs) == tree


# -- train_step ------------------------------------------------------------


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(7)
    jcfg = jax_tiny_test()
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(3))
    trajs = _trajectories(rng, n=4)
    for t in trajs:
        t.behavior_logp = [x * 0.05 - 6.2 for x in t.behavior_logp]
    jtrajs = [jdata.Trajectory(**dataclasses.asdict(t)) for t in trajs]
    tokens, mask, rewards, gids = jdata.make_batch(jtrajs, pad_id=0)
    batch = dict(tokens=tokens, completion_mask=mask, rewards=rewards,
                 group_ids=gids)
    extras = dict(
        old_logp=jdata.make_batch_logps(jtrajs, tokens, mask),
        ref_logp=(rng.standard_normal((4, tokens.shape[1] - 1)) * 0.05
                  - 6.2).astype(np.float32),
        branch_mask=jdata.make_branch_mask(jtrajs, tokens, mask))
    return jcfg, jparams, batch, extras


def _run_both(setup, attn_impl, accum, with_extras, steps):
    jcfg, jparams, batch, extras = setup
    jc = dataclasses.replace(jcfg, attn_impl=attn_impl)
    tc = dataclasses.replace(tiny_test(), attn_impl=attn_impl)
    gkw = dict(kl_coef=0.1, branch_credit_boost=0.5) if with_extras else {}
    ekw = extras if with_extras else {}
    js = jtr.make_train_state(jc, None, params=jparams, learning_rate=LR)
    ts = ttr.make_train_state(
        tc, params=params_from_numpy(jax.device_get(jparams), device="cpu"),
        learning_rate=LR)
    out = []
    for i in range(steps):
        js, jm = jtr.train_step(
            js, jc, None, **batch, num_groups=2, accum_steps=accum,
            grpo_config=jgrpo.GRPOConfig(**gkw),
            **{k: jnp.asarray(v) for k, v in ekw.items()})
        ts, tm = ttr.train_step(
            ts, tc, None, **batch, num_groups=2, accum_steps=accum,
            grpo_config=tgrpo.GRPOConfig(**gkw), **ekw)
        out.append((jm, tm))
        if i == 0:                       # the params after one step
            _assert_tree_close(js.params, ts.params, atol=PARAM_ATOL)
    return js, ts, out


@pytest.mark.parametrize("attn_impl,accum,with_extras", [
    ("einsum", 1, False), ("einsum", 2, True),
    ("flash", 1, True), ("flash", 2, False)])
def test_train_step_matches_jax(setup, attn_impl, accum, with_extras):
    js, ts, hist = _run_both(setup, attn_impl, accum, with_extras, steps=3)
    for i, (jm, tm) in enumerate(hist):
        assert sorted(tm) == sorted(jm)
        tol = STEP1_ATOL if i == 0 else STEP3_ATOL
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       atol=tol, rtol=tol,
                                       err_msg=f"step {i + 1} {k}")
    assert ts.step == 3 and ts.opt_state.count == 3
    _assert_tree_close(js.params, ts.params, atol=PARAM_ATOL)
    # most elements agree far closer than the sign-like worst case
    close = []
    for path, leaf in jax.tree_util.tree_leaves_with_path(
            jax.device_get(js.params)):
        node = ts.params
        for p in path:
            node = node[p.key]
        close.append(np.abs(node.numpy() - np.asarray(leaf)) < 1e-6)
    assert np.mean(np.concatenate([c.ravel() for c in close])) > 0.99


def test_remat_gives_the_same_gradients(setup):
    jcfg, jparams, batch, extras = setup
    params = params_from_numpy(jax.device_get(jparams), device="cpu")
    out = []
    for remat in (False, True):
        cfg = dataclasses.replace(tiny_test(), attn_impl="flash",
                                  remat=remat)
        grads, metrics = ttr.grpo_gradients(
            params, cfg, **batch, old_logp=extras["old_logp"], num_groups=2,
            accum_steps=2)
        out.append((grads, metrics))
    for (path, a), (_, b) in zip(ttr.flatten_params(out[0][0]),
                                 ttr.flatten_params(out[1][0])):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6,
                                   msg=str(path))
    assert float(out[0][1]["loss"]) == pytest.approx(float(out[1][1]["loss"]),
                                                     abs=1e-7)


def test_lora_train_step_matches_jax(setup):
    jcfg, jparams, batch, extras = setup
    jstate = jtr.make_lora_train_state(jcfg, jparams, jax.random.PRNGKey(5),
                                       rank=4, learning_rate=LR)
    tbase = params_from_numpy(jax.device_get(jparams), device="cpu")
    base_before = {k: v.clone() for k, v in tbase["layers"].items()}
    tstate = ttr.make_train_state(
        tiny_test(), params=params_from_numpy(jax.device_get(jstate.params),
                                              device="cpu"),
        learning_rate=LR)
    for step in range(3):
        jstate, jm = jtr.train_step(jstate, jcfg, None, **batch,
                                    num_groups=2, accum_steps=2,
                                    old_logp=jnp.asarray(extras["old_logp"]),
                                    lora_base=jparams)
        tstate, tm = ttr.train_step(tstate, tiny_test(), None, **batch,
                                    num_groups=2, accum_steps=2,
                                    old_logp=extras["old_logp"],
                                    lora_base=tbase)
        tol = STEP1_ATOL if step == 0 else STEP3_ATOL
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=tol,
                                       rtol=tol, err_msg=f"{step} {k}")
    assert sorted(tstate.params["layers"]) == sorted(
        jstate.params["layers"])
    _assert_tree_close(jstate.params, tstate.params, atol=PARAM_ATOL)
    for k, v in tbase["layers"].items():      # the base is never written
        assert torch.equal(v, base_before[k]), k
    # folding the adapters gives the merged model's function
    merged = tlora.merge_lora(tbase, tstate.params)
    folded = tlora.materialize_lora(tbase, tstate.params, tiny_test())
    toks = torch.from_numpy(batch["tokens"][:2, :20]).long()
    torch.testing.assert_close(forward(folded, tiny_test(), toks),
                               forward(merged, tiny_test(), toks),
                               atol=1e-4, rtol=1e-4)
    jmat = jlora.materialize_lora(jparams, jstate.params, jcfg)
    _assert_tree_close(jmat, folded, atol=PARAM_ATOL)


def test_lora_state_shapes_and_init(setup):
    jcfg, jparams, _, _ = setup
    tbase = params_from_numpy(jax.device_get(jparams), device="cpu")
    st = ttr.make_lora_train_state(tiny_test(), tbase,
                                   torch.Generator().manual_seed(0), rank=4)
    jl = jlora.init_lora(jcfg, jax.random.PRNGKey(0), rank=4)
    assert {k: tuple(v.shape) for k, v in st.params["layers"].items()} == \
        {k: v.shape for k, v in jl["layers"].items()}
    assert all(not v.any() for k, v in st.params["layers"].items()
               if k.endswith("_lora_b"))
    assert tlora.lora_param_count(st.params) == jlora.lora_param_count(jl)
    base, adapters = tlora.split_lora(tlora.merge_lora(tbase, st.params))
    assert sorted(base["layers"]) == sorted(tbase["layers"])
    assert sorted(adapters["layers"]) == sorted(st.params["layers"])
    assert count_params(tbase) == sum(x.size for x in
                                      jax.tree_util.tree_leaves(jparams))


def test_behavior_logp_batched_matches_jax(setup):
    from senweaver_ide_tpu.training.async_loop import \
        behavior_logp_batched as jax_blp
    jcfg, jparams, batch, _ = setup
    tparams = params_from_numpy(jax.device_get(jparams), device="cpu")
    want = jax_blp(jparams, jcfg, jnp.asarray(batch["tokens"]), 2)
    got = tasync.behavior_logp_batched(tparams, tiny_test(),
                                       batch["tokens"], 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_out_of_slice_training_raises(setup, tmp_path):
    jcfg, jparams, batch, _ = setup
    tparams = params_from_numpy(jax.device_get(jparams), device="cpu")
    state = ttr.make_train_state(tiny_test(), params=tparams)
    # meshes train (tests/test_torch_mesh_train.py); a mesh is a Mesh,
    # and ring/ulysses attention needs one with an 'sp' axis, as in JAX
    with pytest.raises(TypeError, match="mesh"):
        ttr.train_step(state, tiny_test(), object(), **batch)
    for impl in ("ring", "ulysses"):
        with pytest.raises(ValueError, match="'sp' axis"):
            ttr.train_step(state, dataclasses.replace(tiny_test(),
                                                      attn_impl=impl),
                           None, **batch)
    q8 = dict(tparams)
    q8["layers"] = dict(tparams["layers"],
                        wq=tparams["layers"]["wq"].to(torch.int8))
    # an int8 LoRA base trains (QLoRA, tests/test_torch_quantize.py); int8
    # trained params still raise
    with pytest.raises(TypeError, match="int8"):
        ttr.train_step(ttr.make_train_state(tiny_test(), params=q8),
                       tiny_test(), None, **batch)
    with pytest.raises(ValueError, match="accum_steps"):
        ttr.train_step(state, tiny_test(), None, **batch, accum_steps=3)
    # PEFT adapter I/O is ported now: it refuses bad input instead
    with pytest.raises(ValueError, match="no LoRA adapter leaves"):
        tlora.export_peft_adapter({"layers": {}}, tiny_test(),
                                  str(tmp_path / "peft"))
    with pytest.raises(FileNotFoundError):
        tlora.load_peft_adapter(str(tmp_path / "missing"), tiny_test(),
                                device="cpu")
