"""torch_graft_entry.py (the port's counterpart of __graft_entry__.py)
against the JAX package on the same weights: entry()'s forward, and
dryrun_multichip's sequence on the gloo ranks of
``tests/torch_mesh_pool.py``.

The dry run's train losses are ~0 by construction (all-ones tokens in
one group: zero advantages; JAX's own run prints 0.0000 for every step),
so of the step cases the test holds only that each loss is finite and
that the ranks agree. The outputs that carry information are held to
JAX on carried weights: the pp=2 forward's logits against JAX's forward,
and the ep=2 layer's output and aux against JAX's expert-parallel layer
on the same two-way split."""

import os
import runpy
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_pool as tmp
from senweaver_ide_tpu.models import forward as jax_forward
from senweaver_ide_tpu.models import init_params as jax_init_params
from senweaver_ide_tpu.models import tiny_test as jax_tiny_test
from senweaver_ide_tpu.parallel import MoEConfig as JMoEConfig
from senweaver_ide_tpu.parallel import init_moe_params as jinit_moe_params
from senweaver_ide_tpu.parallel import make_named_mesh as jmake_named_mesh
from senweaver_ide_tpu.parallel import moe_ffn_sharded as jmoe_ffn_sharded

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch_graft_entry as tge  # noqa: E402

# fp32 forwards through two frameworks (tests/test_torch_model.py)
LOGITS_ATOL = LOGITS_RTOL = 1e-4
# the fp32 MoE layer through two frameworks (tests/test_torch_parallel.py)
MOE_TOL = 1e-4


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


# one compile of the whole init instead of an eager compile per op
_jax_init = jax.jit(jax_init_params, static_argnums=0)


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a),
                                  jax.device_get(tree))


def test_entry_logits_match_jax_forward():
    """entry()'s forward on carried tiny-test weights: its (1, 128)
    all-ones tokens' logits against JAX's forward."""
    cfg = jax_tiny_test()
    params = _jax_init(cfg, jax.random.PRNGKey(0))
    fn, (tparams, tokens) = tge.entry(device="cpu",
                                      params=_np(params))
    assert tuple(tokens.shape) == (1, 128) and tokens.device.type == "cpu"
    got = fn(tparams, tokens).numpy()
    want = jax.jit(lambda p, t: jax_forward(p, cfg, t)[0])(
        params, jnp.ones((1, 128), jnp.int32))
    np.testing.assert_allclose(got, np.asarray(want), atol=LOGITS_ATOL,
                               rtol=LOGITS_RTOL)


def test_entry_points_refuse_without_a_card(monkeypatch):
    """entry() and dryrun_multichip() raise, naming CUDA, before any
    work when there is no card and the caller did not ask for the host;
    so does the script run as its user runs it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tge.entry()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tge.dryrun_multichip(2)
    path = os.path.join(ROOT, "torch_graft_entry.py")
    monkeypatch.setattr(sys, "argv", [path])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        runpy.run_path(path, run_name="__main__")


def test_dryrun_on_eight_ranks_matches_jax():
    """dryrun_rank on 8 gloo ranks (dp2/fsdp2/tp2, QLoRA, sp=2 ring,
    the hybrid mesh, pp=2 and ep=2), with the pp=2 and ep=2 weights
    carried from JAX's seeds (PRNGKey(1) and PRNGKey(2), as JAX's dry
    run draws them): finite losses that every rank agrees on, the pp=2
    logits against JAX's forward and each ep rank's rows and aux against
    JAX's moe_ffn_sharded on a 2-device mesh. The pool starts with the
    test, and JAX's side is computed while the ranks run."""
    pool = tmp.RankPool(8)
    try:
        cfg = jax_tiny_test()
        pp_params = _jax_init(cfg, jax.random.PRNGKey(1))
        mcfg = JMoEConfig(hidden_size=cfg.hidden_size,
                          intermediate_size=cfg.intermediate_size,
                          num_experts=4, top_k=2)
        moe_params = jinit_moe_params(mcfg, jax.random.PRNGKey(2))
        ranks = {}

        def run():
            try:
                ranks["outs"] = pool.run(
                    tge.dryrun_rank, 8, "cpu",
                    {"pp": _np(pp_params), "moe": _np(moe_params)})
            except BaseException as e:
                ranks["error"] = e
        waiter = threading.Thread(target=run)
        waiter.start()
        want = jax.jit(lambda p, t: jax_forward(p, cfg, t)[0])(
            pp_params, jnp.ones((4, 8), jnp.int32))
        x = jnp.ones((4, 8, cfg.hidden_size), jnp.float32)
        jmesh = jmake_named_mesh({"ep": 2}, devices=jax.devices()[:2])
        jout, jaux = jax.jit(lambda p, x: jmoe_ffn_sharded(
            p, mcfg, x, mesh=jmesh))(moe_params, x)
        waiter.join()
    finally:
        pool.close()
    if "error" in ranks:
        raise ranks["error"]
    outs = ranks["outs"]
    cases = {"train", "qlora", "sp_ring", "hybrid"}
    for r, o in enumerate(outs):
        assert o["rank"] == r and o["placement"] == "gloo on the host"
        assert set(o["losses"]) == cases | ({"pp_1f1b"} if r < 2 else set())
        assert all(np.isfinite(v) for v in o["losses"].values())
        for case in cases:
            assert o["losses"][case] == outs[0]["losses"][case], (r, case)
    assert outs[0]["losses"]["pp_1f1b"] == outs[1]["losses"]["pp_1f1b"]
    for o in outs[:2]:
        np.testing.assert_allclose(o["pp_logits"], np.asarray(want),
                                   atol=LOGITS_ATOL, rtol=LOGITS_RTOL)
    jout = np.asarray(jout)
    for c, o in enumerate(outs[:2]):
        np.testing.assert_allclose(o["moe_out"], jout[2 * c:2 * c + 2],
                                   atol=MOE_TOL, rtol=MOE_TOL)
        assert o["moe_aux"] == pytest.approx(float(jaux), rel=1e-4)
    assert all("pp_logits" not in o and "moe_out" not in o
               for o in outs[2:])
