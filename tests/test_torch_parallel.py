"""The port's parallel layouts against the JAX package's on the same
meshes: ``forward(mesh=)``, ring and Ulysses attention, the
expert-parallel MoE FFN and the mesh constructors.

The port's side runs on a pool of gloo ranks (``torch_mesh_pool``: one
process per rank, started once for this file); the JAX side runs here,
on the 8 virtual CPU devices ``conftest.py`` provides. Every rank returns
its block and the test assembles them by mesh coordinate."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_pool as tmp
from senweaver_ide_tpu.models import forward as jax_forward
from senweaver_ide_tpu.models import init_params as jax_init_params
from senweaver_ide_tpu.models import small_test as jax_small_test
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
