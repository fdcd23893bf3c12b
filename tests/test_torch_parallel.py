"""The port's parallel layouts against the JAX package's on the same
meshes: ``forward(mesh=)``, ring and Ulysses attention, the
expert-parallel MoE FFN and the mesh constructors.

The port's side runs on a pool of gloo ranks (``torch_mesh_pool``: one
process per rank, started once for this file); the JAX side runs here,
on the 8 virtual CPU devices ``conftest.py`` provides. Every rank returns
its block and the test assembles them by mesh coordinate."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_pool as tmp
from senweaver_ide_tpu.models import forward as jax_forward
from senweaver_ide_tpu.models import init_params as jax_init_params
from senweaver_ide_tpu.models import small_test as jax_small_test
from senweaver_ide_tpu.models import tiny_test as jax_tiny_test
from senweaver_ide_tpu.parallel import MeshConfig as JMeshConfig
from senweaver_ide_tpu.parallel import make_mesh as jmake_mesh
from senweaver_ide_tpu.parallel import shard_params as jshard_params
from senweaver_ide_tpu.parallel.mesh import data_sharding as jdata_sharding

# fp32 forwards through two frameworks (observed ≤ 3e-6 on logits of
# magnitude ~1): the relative bound the slice states
LOGITS_RTOL = LOGITS_ATOL = 1e-4


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
    return jax.tree_util.tree_map(lambda a: np.asarray(a), jax.device_get(
        tree))


def _block(full, sizes, coords, dims):
    """The block of ``full`` that a rank at ``coords`` holds: ``dims``
    maps a tensor dim to the mesh axes split over it."""
    index = [slice(None)] * full.ndim
    for dim, axes in dims.items():
        n, c = 1, 0
        for a in axes:
            n *= sizes.get(a, 1)
            c = c * sizes.get(a, 1) + coords.get(a, 0)
        part = full.shape[dim] // n
        index[dim] = slice(c * part, (c + 1) * part)
    return full[tuple(index)]


def test_sharded_forward_fsdp2_tp4_matches_jax(pool):
    """tests/test_model.py:145 on the port: an fsdp=2 × tp=4 forward's
    logits, every rank's (rows, vocab) block, against JAX's sharded
    forward (small-test: 8/4 heads split 2/1 per tp rank)."""
    cfg = jax_small_test()
    params = jax_init_params(cfg, jax.random.PRNGKey(0))
    toks = np.arange(16, dtype=np.int32).reshape(2, 8) * 7 % cfg.vocab_size
    mesh = jmake_mesh(JMeshConfig(fsdp=2, tp=4))
    with mesh:
        ref, _ = jax_forward(jshard_params(params, mesh), cfg,
                             jax.device_put(jnp.asarray(toks),
                                            jdata_sharding(mesh)))
    ref = np.asarray(ref)
    sizes = {"fsdp": 2, "tp": 4}
    outs = pool.run(tmp.sc_forward, _np(params), "small-test", sizes, toks)
    for o in outs:
        want = _block(ref, sizes, o["coords"], {0: ("fsdp",), 2: ("tp",)})
        np.testing.assert_allclose(o["logits"], want, rtol=LOGITS_RTOL,
                                   atol=LOGITS_ATOL)


def _qkv(seed, b, s, hq, hkv, d):
    r = np.random.default_rng(seed)
    return (r.standard_normal((b, s, hq, d)).astype(np.float32),
            r.standard_normal((b, s, hkv, d)).astype(np.float32),
            r.standard_normal((b, s, hkv, d)).astype(np.float32))


# fp32 attention and its gradients through different summation orders
# (tests/test_ring_attention.py's own bounds)
ATTN_TOL = 1e-5
GRAD_TOL = 1e-4


@pytest.mark.parametrize("kind,hq,hkv,causal,masked", [
    ("ring", 4, 2, True, False),
    ("ring", 2, 2, False, False),
    ("ring", 4, 2, True, True),
    ("ulysses", 8, 8, True, False),
])
def test_sequence_parallel_matches_dense_and_jax(pool, kind, hq, hkv,
                                                 causal, masked):
    """Ring and Ulysses attention over sp=8, forward and the gradients of
    sum(out²), against dense attention (jax.grad) and JAX's own ring /
    Ulysses (tests/test_ring_attention.py)."""
    from senweaver_ide_tpu.ops.attention import attention as jattention
    from senweaver_ide_tpu.parallel.ring_attention import (
        make_ring_attention, make_ulysses_attention)
    q, k, v = _qkv(1, 2, 64, hq, hkv, 16)
    kv_mask = None
    if masked:
        kv_mask = np.ones((2, 64), bool)
        kv_mask[0, 40:] = False
        kv_mask[1, 5:9] = False

    def dense(q, k, v):
        return jattention(q, k, v, causal=causal,
                          kv_mask=None if kv_mask is None
                          else jnp.asarray(kv_mask))

    ref = np.asarray(dense(q, k, v))
    grads = jax.grad(lambda q, k, v: jnp.sum(dense(q, k, v) ** 2),
                     argnums=(0, 1, 2))(q, k, v)
    jmesh = jmake_mesh(JMeshConfig(sp=8))
    if kind == "ring":
        if masked:
            jfn = jax.jit(make_ring_attention(jmesh, causal=causal,
                                              with_mask=True))
            jout = np.asarray(jfn(q, k, v, jnp.asarray(kv_mask)))
        else:
            jout = np.asarray(jax.jit(make_ring_attention(
                jmesh, causal=causal))(q, k, v))
    else:
        jout = np.asarray(jax.jit(make_ulysses_attention(
            jmesh, causal=causal))(q, k, v))
    outs = pool.run(tmp.sc_seq_parallel, kind, q, k, v, kv_mask, causal, 8)
    n = 64 // 8
    for o in outs:
        sl = slice(o["c"] * n, (o["c"] + 1) * n)
        np.testing.assert_allclose(o["out"], ref[:, sl], atol=ATTN_TOL,
                                   rtol=ATTN_TOL)
        np.testing.assert_allclose(o["out"], jout[:, sl], atol=ATTN_TOL,
                                   rtol=ATTN_TOL)
        for name, g in zip(("dq", "dk", "dv"), grads):
            np.testing.assert_allclose(o[name], np.asarray(g)[:, sl],
                                       atol=GRAD_TOL, rtol=GRAD_TOL)


def test_ulysses_rejects_indivisible_heads(pool):
    q, _, _ = _qkv(2, 1, 64, 4, 4, 16)
    outs = pool.run(tmp.sc_ulysses_heads, q[:, :8], 8)
    assert all("divisible" in o for o in outs)


# the sharded and dense MoE paths reassociate the same fp sums
# (tests/test_pipeline_expert.py's bound); bf16 rounds each expert's
# output in bf16 on both sides
MOE_TOL = {"float32": 2e-4, "bfloat16": 2e-2}


@pytest.mark.parametrize("ep,dtype,int8", [
    (2, "float32", False), (2, "bfloat16", True),
    (4, "float32", True), (4, "bfloat16", False)])
def test_moe_sharded_matches_dense_and_jax(pool, ep, dtype, int8):
    """``moe_ffn_sharded`` over ep=2/4 against the port's ``moe_ffn`` on
    each rank's rows (same capacity: the local batch) and, at a capacity
    with no drops, against JAX's ``moe_ffn`` and ``moe_ffn_sharded`` on
    the whole batch (tests/test_pipeline_expert.py:73, :120); int8 banks
    carry their scales."""
    from senweaver_ide_tpu.models.quantize import _quantize_matrix
    from senweaver_ide_tpu.parallel import make_named_mesh
    from senweaver_ide_tpu.parallel.expert import (MoEConfig as JMoEConfig,
                                                   init_moe_params,
                                                   moe_ffn as jmoe,
                                                   moe_ffn_sharded as jshard)
    kw = dict(hidden_size=16, intermediate_size=32, num_experts=4, top_k=2,
              capacity_factor=4.0)
    params = dict(init_moe_params(JMoEConfig(**kw), jax.random.PRNGKey(0)))
    if int8:
        for n in ("w_gate", "w_up", "w_down"):
            params[n], params[n + "_scale"] = _quantize_matrix(params[n])
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (8, 8, 16)))
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jp = {n: (a.astype(jdt) if a.dtype == jnp.float32
              and not n.endswith("_scale") and n != "router" else a)
          for n, a in params.items()}
    jcfg = JMoEConfig(dtype=jdt, **kw)
    ref, _ = jmoe(jp, jcfg, jnp.asarray(x, jdt))
    jmesh = make_named_mesh({"ep": ep}, devices=jax.devices()[:ep])
    jref, jaux = jshard(jp, jcfg, jnp.asarray(x, jdt), mesh=jmesh)
    ref = np.asarray(ref.astype(jnp.float32))
    jref = np.asarray(jref.astype(jnp.float32))
    outs = pool.run(tmp.sc_moe_sharded, _np(params), kw, x, ep, dtype)
    tol = MOE_TOL[dtype]
    n = 8 // ep
    for o in outs[:ep]:
        sl = slice(o["c"] * n, (o["c"] + 1) * n)
        np.testing.assert_allclose(o["out"], o["local_dense"], atol=tol,
                                   rtol=tol)
        np.testing.assert_allclose(o["out"], ref[sl], atol=tol, rtol=tol)
        np.testing.assert_allclose(o["out"], jref[sl], atol=tol, rtol=tol)
        # the aux loss: the mean over ep of the ranks' own
        assert o["aux"] == pytest.approx(
            np.mean([p["local_aux"] for p in outs[:ep]]), rel=1e-5)
        assert o["aux"] == pytest.approx(float(jaux), rel=1e-4)
    assert all(o is None for o in outs[ep:])


def test_mesh_layout_groups_and_errors(pool):
    """make_hybrid_mesh's layout (tests/test_accum_hybrid.py:127): dp picks
    a block of 4 consecutive ranks; the groups over (dp, fsdp) and tp
    hold their ranks in coordinate order; JAX's two errors."""
    outs = pool.run(tmp.sc_mesh_layout)
    for r, o in enumerate(outs):
        assert o["axis_names"] == ("dp", "fsdp", "tp", "sp")
        assert np.asarray(o["devices"]).reshape(2, 2, 2)[0].ravel().tolist() \
            == [0, 1, 2, 3]
        tp = o["coords"]["tp"]
        assert o["data_group"] == [tp, 2 + tp, 4 + tp, 6 + tp]
        assert o["tp_group"] == [r - tp, r - tp + 1]
        assert "multiple of num_slices" in o["errors"][0]
        assert "needs" in o["errors"][1]
        assert "needs" in o["needs"]


@pytest.mark.parametrize("backend,dev,routes", [
    ("gloo", "cpu", {"all_reduce": "native", "send_recv": "native"}),
    ("nccl", "cuda", {"all_reduce": "native", "reduce_scatter": "native",
                      "send_recv": "native"}),
    ("gloo", "cuda", {"all_reduce": "native", "all_gather": "native",
                      "broadcast": "native", "all_to_all_single": "native",
                      "send_recv": "host"}),
    ("nccl", "cpu", None),
    ("mpi", "cuda", None),
])
def test_collective_routes_are_fixed(monkeypatch, backend, dev, routes):
    """Each (backend, device) has one route per collective, recorded in
    ROUTES; a pair with no route raises before any call."""
    from senweaver_ide_tpu_torch.parallel import comm

    class _T:                       # a tensor's device is all _route reads
        device = torch.device(dev)

    monkeypatch.setattr(comm.dist, "get_backend", lambda group: backend)
    monkeypatch.setattr(comm, "ROUTES", {})
    if routes is None:
        with pytest.raises(RuntimeError, match="no route"):
            comm._route("all_reduce", None, _T())
        assert comm.ROUTES == {}
        return
    for name, want in routes.items():
        assert comm._route(name, None, _T()) == want
    assert comm.ROUTES == {f"{backend}/{dev}/{n}": r
                           for n, r in routes.items()}


# ---- MoE on data axes: the global batch's routing ----

@pytest.mark.parametrize("sizes,capacity", [
    ({"dp": 2}, 1.25), ({"dp": 2}, 100.0),
    ({"fsdp": 2, "sp": 2}, 1.25), ({"fsdp": 2, "sp": 2}, 100.0)])
def test_moe_forward_on_data_axes_routes_the_global_batch(pool, sizes,
                                                          capacity):
    """tiny-moe-test on dp=2 and on fsdp=2 × sp=2, at capacity 1.25
    (assignments dropped) and 100 (none): every rank's logits block and
    the aux loss against JAX's forward on the same mesh (which routes the
    global (B, S) batch) and against the port's mesh=None forward of the
    whole batch."""
    import dataclasses

    from senweaver_ide_tpu.models import get_config as jget_config
    jcfg = dataclasses.replace(jget_config("tiny-moe-test"),
                               expert_capacity_factor=capacity)
    params = jax_init_params(jcfg, jax.random.PRNGKey(0))
    toks = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (4, 32)).astype(np.int32)
    n = int(np.prod(list(sizes.values())))
    mesh = jmake_mesh(JMeshConfig(**sizes), devices=jax.devices()[:n])
    fwd = jax.jit(lambda p, t: jax_forward(p, jcfg, t, with_aux=True))
    with mesh:
        ref, _, ref_aux = fwd(jshard_params(params, mesh), jax.device_put(
            jnp.asarray(toks), jdata_sharding(mesh)))
    ref = np.asarray(ref)
    outs = pool.run(tmp.sc_moe_forward, _np(params),
                    {"expert_capacity_factor": capacity}, sizes, toks)
    dims = {0: ("dp", "fsdp"), 1: ("sp",)}
    for o in outs[:n]:
        np.testing.assert_allclose(o["logits"], _block(ref, sizes,
                                                       o["coords"], dims),
                                   rtol=LOGITS_RTOL, atol=LOGITS_ATOL)
        np.testing.assert_allclose(o["logits"], _block(o["one"], sizes,
                                                       o["coords"], dims),
                                   rtol=LOGITS_RTOL, atol=LOGITS_ATOL)
        assert o["aux"] == pytest.approx(float(ref_aux), rel=1e-5)
        assert o["aux"] == pytest.approx(o["one_aux"], rel=1e-5)
    assert all(o is None for o in outs[n:])


# ---- pipeline stages (tests/test_pipeline_expert.py, test_pp_train.py) --

# the JAX pipeline tests' bounds: logits; loss, grad_norm (relative) and
# the params after Adam steps, within one framework
PP_LOGITS_TOL = 2e-4
PP_LOSS_ATOL = 1e-5
PP_NORM_RTOL = 1e-4
PP_PARAM_TOL = 2e-5
PP_LR = 1e-3
# Adam's first steps are sign-like (u = g / (|g| + eps)): where |g| is
# within a few eps of 0, the two frameworks' fp32 rounding moves an
# element by up to one step of lr (tests/test_torch_trainer.py's bound),
# so params across frameworks are held to this, the loss and grad_norm
# to the bounds above
PP_PARAM_ATOL_JAX = 0.25 * PP_LR


@functools.lru_cache(maxsize=None)
def _pp_tiny(layers=2):
    """tiny-test at ``layers`` deep and its PRNGKey(0) weights, made once
    for the module (JAX's init and each jitted function are paid per
    config)."""
    import dataclasses
    cfg = dataclasses.replace(jax_tiny_test(), num_layers=layers)
    return cfg, jax_init_params(cfg, jax.random.PRNGKey(0))


def test_pipeline_forward_matches_jax(pool):
    """tests/test_pipeline_expert.py:25 on the port: pp=2, 4
    microbatches, every rank's logits against JAX's dense forward (which
    that test holds JAX's pipeline_forward to); the stage leaves a rank
    holds equal JAX's split_layers_for_stages output, carried through
    params_from_numpy."""
    from senweaver_ide_tpu.parallel import split_layers_for_stages as jsplit
    cfg, params = _pp_tiny()
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (8, 16)).astype(np.int32)
    ref = np.asarray(jax.jit(lambda p, t: jax_forward(p, cfg, t)[0])(
        params, toks))
    split = jsplit(params, 2)
    outs = pool.run(tmp.sc_pp_forward, None, 2, toks, 4,
                    split_np=_np(split))
    for o in outs[:2]:
        np.testing.assert_allclose(o["logits"], ref, rtol=PP_LOGITS_TOL,
                                   atol=PP_LOGITS_TOL)
        for name, leaf in o["layers"].items():
            np.testing.assert_array_equal(
                leaf[0], np.asarray(split["layers"][name][o["stage"]]))
    assert all(o is None for o in outs[2:])


def test_pipeline_split_of_carried_weights_equals_jax_split():
    """The port's split of params_from_numpy(JAX's tree) equals JAX's
    split carried through params_from_numpy, leaf by leaf."""
    from senweaver_ide_tpu.parallel import split_layers_for_stages as jsplit
    from senweaver_ide_tpu_torch.models import params_from_numpy
    from senweaver_ide_tpu_torch.parallel import split_layers_for_stages
    _, params = _pp_tiny(4)
    for k in (2, 4):
        mine = split_layers_for_stages(params_from_numpy(
            _np(params), device="cpu"), k)
        theirs = params_from_numpy(_np(jsplit(params, k)), device="cpu")
        for name, t in theirs["layers"].items():
            assert torch.equal(mine["layers"][name], t), (k, name)
        for name in ("embed", "final_norm"):
            assert torch.equal(mine[name], theirs[name])


def test_pipeline_per_microbatch_mask_matches_jax(pool):
    """tests/test_pipeline_expert.py:98: per-example padding masks that
    differ in every microbatch; each stage gathers the mask of ITS
    microbatch (t − stage), so the valid positions equal the dense
    masked forward's."""
    cfg, params = _pp_tiny()
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (8, 16)).astype(np.int32)
    lens = np.asarray([16, 12, 9, 16, 5, 16, 14, 7])
    mask = np.arange(16)[None, :] < lens[:, None]
    ref = np.asarray(jax.jit(lambda p, t, m: jax_forward(
        p, cfg, t, attn_mask=m)[0])(params, toks, mask))
    outs = pool.run(tmp.sc_pp_forward, _np(params), 2, toks, 4, mask=mask)
    for o in outs[:2]:
        np.testing.assert_allclose(o["logits"][mask], ref[mask],
                                   rtol=PP_LOGITS_TOL, atol=PP_LOGITS_TOL)


def test_pipeline_gradients_match_jax(pool):
    """tests/test_pipeline_expert.py:39: gradients flow through the
    stages; here each rank's gradients of mean(logits) (its stage's
    layers, the replicated tensors whole) against jax.grad of the dense
    forward."""
    cfg, params = _pp_tiny()
    toks = np.ones((4, 8), np.int32)
    toks[:, ::3] = 7
    grads = jax.jit(jax.grad(lambda p: jax_forward(p, cfg, toks)[0].mean()))(
        params)
    outs = pool.run(tmp.sc_pp_grad_flow, _np(params), 2, toks, 2)
    for o in outs[:2]:
        assert o["finite"] and o["layers"] > 0
        per = cfg.num_layers // 2
        sl = slice(o["stage"] * per, (o["stage"] + 1) * per)
        for name, g in o["grads"]["layers"].items():
            np.testing.assert_allclose(g[0], np.asarray(
                grads["layers"][name][sl]), rtol=1e-4, atol=1e-7,
                err_msg=name)
        for name in ("embed", "final_norm"):
            np.testing.assert_allclose(o["grads"][name], np.asarray(
                grads[name]), rtol=1e-4, atol=1e-7, err_msg=name)


def test_pipeline_split_errors_match_jax():
    """tests/test_pipeline_expert.py:56: a split that does not divide
    the layers raises ValueError with JAX's message."""
    from senweaver_ide_tpu.parallel import split_layers_for_stages as jsplit
    from senweaver_ide_tpu_torch.models import params_from_numpy
    from senweaver_ide_tpu_torch.parallel import split_layers_for_stages
    _, params = _pp_tiny()
    with pytest.raises(ValueError) as want:
        jsplit(params, 3)
    with pytest.raises(ValueError) as got:
        split_layers_for_stages(params_from_numpy(_np(params), device="cpu"),
                                3)
    assert str(got.value) == str(want.value)


def _pp_batch(seed, b, s, masked_prefix=0, vocab=512):
    rng = np.random.default_rng(seed)
    mask = np.ones((b, s), bool)
    mask[:, :masked_prefix] = False
    return {"tokens": rng.integers(0, vocab, (b, s)).astype(np.int32),
            "mask": mask,
            "rewards": np.linspace(-1.0, 1.0, b).astype(np.float32),
            "group_ids": (np.arange(b) // 2).astype(np.int32)}


def _train_steps(cfg, params, batch, steps):
    """JAX's single-device train_step (what the JAX suite holds its
    pipelines to) and the port's, from the same weights: each one's
    params after ``steps`` steps and its metrics per step."""
    from senweaver_ide_tpu.training import make_train_state as jmake_state
    from senweaver_ide_tpu.training import train_step as jtrain_step
    from senweaver_ide_tpu_torch.models import params_from_numpy
    from senweaver_ide_tpu_torch.training import (make_train_state,
                                                  train_step)
    tcfg = tmp.config("tiny-test", num_layers=cfg.num_layers)
    jst = jmake_state(cfg, jax.random.PRNGKey(0), None,
                      learning_rate=PP_LR, params=params)
    tst = make_train_state(tcfg, params=params_from_numpy(
        _np(params), device="cpu"), learning_rate=PP_LR)
    args = (batch["tokens"], batch["mask"], batch["rewards"],
            batch["group_ids"])
    jhist, thist = [], []
    for _ in range(steps):
        jst, m = jtrain_step(jst, cfg, None, *args)
        jhist.append({k: float(v) for k, v in m.items()})
        tst, m = train_step(tst, tcfg, None, *args)
        thist.append({k: float(v) for k, v in m.items()})
    return (_np(jst.params), jhist), (tmp.np_tree(tst.params), thist)


def _close_step(got, want):
    assert got["loss"] == pytest.approx(want["loss"], abs=PP_LOSS_ATOL)
    assert got["grad_norm"] == pytest.approx(want["grad_norm"],
                                             rel=PP_NORM_RTOL)


def _close_params(got, want, tol=PP_PARAM_TOL):
    for name, leaf in want["layers"].items():
        np.testing.assert_allclose(got["layers"][name], leaf, atol=tol,
                                   rtol=tol, err_msg=name)
    for group in ("embed", "final_norm", "lm_head"):
        if group in want:
            np.testing.assert_allclose(got[group], want[group], atol=tol,
                                       rtol=tol, err_msg=group)


def test_pp_train_steps_match_jax_train_step(pool):
    """tests/test_pp_train.py:20, :62 and :114 on the port: pp=2, a
    completion mask with a masked prefix. GPipe at M=2 and 1F1B at M=4,
    two steps each from the same weights: loss and grad_norm of each step
    against JAX's train_step on the same batch; the params after the
    steps (stage split undone) against the port's train_step and each
    other on every group (embed, final_norm, layers) within the JAX
    tests' bound, against JAX's within Adam's sign-step bound; the
    unknown schedule's error."""
    cfg, params = _pp_tiny()
    batch = _pp_batch(5, 8, 20, masked_prefix=4)
    (jax_p, jax_m), (port_p, port_m) = _train_steps(cfg, params, batch, 2)
    got = {}
    for n_micro, schedule in ((2, "gpipe"), (4, "1f1b")):
        outs = pool.run(tmp.sc_pp_steps, _np(params), {}, 2, batch, n_micro,
                        (schedule,), steps=2, lr=PP_LR)
        assert outs[0][schedule]["metrics"] == outs[1][schedule]["metrics"]
        assert outs[0][schedule]["step"] == 2
        assert outs[0]["unknown"] == \
            "unknown pipeline schedule 'interleaved-nope'"
        got[schedule] = outs[0][schedule]
        for step in range(2):
            _close_step(got[schedule]["metrics"][step], jax_m[step])
            _close_step(got[schedule]["metrics"][step], port_m[step])
        _close_params(got[schedule]["params"], port_p)
        _close_params(got[schedule]["params"], jax_p, PP_PARAM_ATOL_JAX)
    _close_params(got["1f1b"]["params"], got["gpipe"]["params"])


@pytest.mark.parametrize("layers,pp,n_micro,b,s", [
    (2, 2, 1, 8, 20),      # M < K: mostly bubble
    (4, 4, 4, 8, 20),      # K = 4, one layer a stage
])
def test_pp_1f1b_matches_gpipe_and_jax(pool, layers, pp, n_micro, b, s):
    """tests/test_pp_train.py:84 and :145: 1F1B against GPipe on every
    group, and both against the port's and JAX's train_step, at M=1 on
    pp=2 and at K=4 (ranks 0-3)."""
    cfg, params = _pp_tiny(layers)
    batch = _pp_batch(7 + layers, b, s)
    (jax_p, jax_m), (port_p, port_m) = _train_steps(cfg, params, batch, 1)
    outs = pool.run(tmp.sc_pp_steps, _np(params), {"num_layers": layers},
                    pp, batch, n_micro, ("gpipe", "1f1b"), lr=PP_LR)
    assert all(o is None for o in outs[pp:])
    for schedule in ("gpipe", "1f1b"):
        assert all(o[schedule]["metrics"] == outs[0][schedule]["metrics"]
                   for o in outs[:pp])
        _close_step(outs[0][schedule]["metrics"][0], jax_m[0])
        _close_step(outs[0][schedule]["metrics"][0], port_m[0])
        _close_params(outs[0][schedule]["params"], port_p)
        _close_params(outs[0][schedule]["params"], jax_p, PP_PARAM_ATOL_JAX)
    _close_params(outs[0]["1f1b"]["params"], outs[0]["gpipe"]["params"])


def test_pp_on_a_dp_mesh_replicates_the_pipeline(pool):
    """A dp=2 x pp=2 mesh (ranks 0-3) replicates the pipeline over dp, as
    JAX's shard_map with P() specs does: GPipe and 1F1B at M=2 give every
    rank the same metrics, equal to pp=2 alone (ranks 0-1) and within the
    JAX tests' bounds of JAX's and the port's train_step, and the same
    updated params as pp=2 alone."""
    cfg, params = _pp_tiny()
    batch = _pp_batch(11, 8, 20, masked_prefix=3)
    (jax_p, jax_m), (port_p, port_m) = _train_steps(cfg, params, batch, 1)
    schedules = ("gpipe", "1f1b")
    alone = pool.run(tmp.sc_pp_steps, _np(params), {}, 2, batch, 2,
                     schedules, lr=PP_LR)[0]
    outs = pool.run(tmp.sc_pp_steps, _np(params), {}, 2, batch, 2,
                    schedules, lr=PP_LR, dp=2)
    assert all(o is None for o in outs[4:])
    for schedule in schedules:
        for o in outs[:4]:
            assert o[schedule]["metrics"] == alone[schedule]["metrics"]
        _close_step(outs[0][schedule]["metrics"][0], jax_m[0])
        _close_step(outs[0][schedule]["metrics"][0], port_m[0])
        _close_params(outs[0][schedule]["params"], alone[schedule]["params"])
        _close_params(outs[0][schedule]["params"], port_p)
        _close_params(outs[0][schedule]["params"], jax_p, PP_PARAM_ATOL_JAX)
