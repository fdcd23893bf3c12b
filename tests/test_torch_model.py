"""The port's model against the JAX model on the same weights (JAX
init_params → numpy → params_from_numpy): no-cache forward logits (atol
1e-4), and one forward_paged flat batch mixing decode rows, a prefill
chunk and dropped (sentinel) writes, on every KV ladder rung; logits and
pools must agree, and positions no kept entry writes must stay
bit-identical."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from senweaver_ide_tpu.models import config as jax_config
from senweaver_ide_tpu.models import transformer as jax_tf
from senweaver_ide_tpu.rollout import paged_kv as jax_pkv
from senweaver_ide_tpu_torch.models import config as t_config
from senweaver_ide_tpu_torch.models import transformer as t_tf
from senweaver_ide_tpu_torch.models.load import params_from_numpy
from senweaver_ide_tpu_torch.rollout import paged_kv as t_pkv

LOGITS_ATOL = 1e-4


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


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_config.tiny_test()
    jparams = jax_tf.init_params(jcfg, jax.random.PRNGKey(1))
    tparams = params_from_numpy(jax.device_get(jparams), device="cpu")
    return jparams, jcfg, tparams, t_config.tiny_test()


def test_presets_match_jax():
    assert sorted(t_config.PRESETS) == sorted(jax_config.PRESETS)
    dtypes = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}
    for name in jax_config.PRESETS:
        j = dataclasses.asdict(jax_config.get_config(name))
        t = dataclasses.asdict(t_config.get_config(name))
        assert dtypes[j.pop("dtype")] == t.pop("dtype"), name
        assert t == j, name


def test_bridge_keeps_layout_and_bits(weights):
    jparams, _, tparams, _ = weights
    flat_j = jax.tree_util.tree_leaves_with_path(jparams)
    assert len(flat_j) == (len(tparams["layers"]) + len(tparams) - 1)
    wq = np.asarray(jparams["layers"]["wq"])
    assert tuple(tparams["layers"]["wq"].shape) == wq.shape  # (L, in, out)
    np.testing.assert_array_equal(tparams["layers"]["wq"].numpy(), wq)
    bf = params_from_numpy(jax.device_get({"w": jparams["embed"].astype(
        jnp.bfloat16)}), device="cpu")["w"]
    assert bf.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        bf.view(torch.int16).numpy(),
        np.asarray(jparams["embed"].astype(jnp.bfloat16)).view(np.int16))
    cast = params_from_numpy({"w": np.ones(3, np.float32),
                              "i": np.arange(3, dtype=np.int32)},
                             device="cpu", dtype=torch.bfloat16)
    assert cast["w"].dtype == torch.bfloat16        # floats cast
    assert cast["i"].dtype == torch.int32           # integers kept


def test_port_init_params_matches_jax_structure():
    cfg = t_config.tiny_test()
    g = torch.Generator().manual_seed(0)
    tparams = t_tf.init_params(cfg, g, device="cpu")
    jparams = jax.eval_shape(lambda: jax_tf.init_params(
        jax_config.tiny_test(), jax.random.PRNGKey(0)))
    assert sorted(tparams) == sorted(jparams)
    for k, v in jparams["layers"].items():
        assert tuple(tparams["layers"][k].shape) == v.shape, k
    assert tparams["embed"].dtype == torch.float32
    # normal / sqrt(fan_in): the empirical std of a big matrix shows it
    std = tparams["layers"]["w_gate"].std().item()
    assert abs(std - cfg.hidden_size ** -0.5) < 0.01


@pytest.mark.parametrize("masked", [False, True])
def test_forward_matches_jax(weights, rng, masked):
    jparams, jcfg, tparams, tcfg = weights
    tokens = rng.integers(0, jcfg.vocab_size, size=(2, 11)).astype(np.int32)
    mask = None
    if masked:
        mask = np.ones((2, 11), bool)
        mask[1, 7:] = False
    jl, _ = jax_tf.forward(jparams, jcfg, jnp.asarray(tokens),
                           attn_mask=None if mask is None
                           else jnp.asarray(mask))
    tl = t_tf.forward(tparams, tcfg, torch.from_numpy(tokens),
                      attn_mask=None if mask is None
                      else torch.from_numpy(mask))
    assert tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                               atol=LOGITS_ATOL, rtol=LOGITS_ATOL)


@pytest.mark.parametrize("variant", ["flash", "positions", "lora",
                                     "remat_with_aux"])
def test_forward_variants_match_jax(weights, rng, variant):
    """The training forward's options: flash attention (the plain path on
    the CPU), explicit RoPE positions, a merged LoRA adapter and
    per-layer remat with the aux output."""
    from senweaver_ide_tpu.training import lora as jax_lora
    jparams, jcfg, tparams, tcfg = weights
    tokens = rng.integers(0, jcfg.vocab_size, size=(2, 13)).astype(np.int32)
    kw_j, kw_t = {}, {}
    if variant == "flash":
        jcfg = dataclasses.replace(jcfg, attn_impl="flash")
        tcfg = dataclasses.replace(tcfg, attn_impl="flash")
        mask = np.ones((2, 13), bool)
        mask[0, 9:] = False
        kw_j["attn_mask"], kw_t["attn_mask"] = (jnp.asarray(mask),
                                                torch.from_numpy(mask))
    elif variant == "positions":
        pos = (np.arange(13)[None, :] + np.array([[5], [40]])).astype(
            np.int32)
        kw_j["positions"], kw_t["positions"] = (jnp.asarray(pos),
                                                torch.from_numpy(pos))
    elif variant == "lora":
        lora = jax_lora.init_lora(jcfg, jax.random.PRNGKey(2), rank=4,
                                  targets=("wq", "wo", "w_down"))
        # a nonzero B, so the adapter changes the function
        lora["layers"] = {k: (v + 0.05 if k.endswith("_lora_b") else v)
                          for k, v in lora["layers"].items()}
        jparams = jax_lora.merge_lora(jparams, lora)
        tparams = params_from_numpy(jax.device_get(jparams), device="cpu")
    else:
        tcfg = dataclasses.replace(tcfg, remat=True)
    want = jax_tf.forward(jparams, jcfg, jnp.asarray(tokens), with_aux=True,
                          **kw_j)
    with torch.enable_grad():
        got = t_tf.forward(tparams, tcfg, torch.from_numpy(tokens),
                           with_aux=True, **kw_t)
    assert got[1] is None and float(got[2]) == 0.0
    np.testing.assert_allclose(got[0].detach().numpy(), np.asarray(want[0]),
                               atol=LOGITS_ATOL, rtol=LOGITS_ATOL)


def _pool_arrays(rng, jcfg, nb, bs, kv_dtype, per_layer):
    """Random full-width contents for every pool tensor, quantized
    through the JAX quantizer where the rung stores payloads."""
    shape = lambda n: (n, nb, bs, jcfg.num_kv_heads, jcfg.head_dim)  # noqa
    payload, n_hi = jax_pkv.resolve_kv_dtypes(jcfg.num_layers, kv_dtype,
                                              per_layer)
    arrs = {}
    if payload is None:
        for n in ("k", "v"):
            arrs[n] = rng.standard_normal(shape(jcfg.num_layers)).astype(
                np.float32)
        return arrs
    lq = jcfg.num_layers - n_hi
    for n in ("k", "v"):
        q, s = jax_tf.quantize_pool_kv(
            jnp.asarray(rng.standard_normal(shape(lq)), jnp.float32),
            payload)
        arrs[n], arrs[n + "_scale"] = np.asarray(q), np.asarray(s)
        if n_hi:
            arrs[n + "_hi"] = rng.standard_normal(shape(n_hi)).astype(
                np.float32)
    return arrs


RUNGS = {
    "full": ("bf16", None),
    "int8": ("int8", None),
    "fp8": ("fp8", None),
    "int8_hi_prefix": ("bf16", ("bf16", "int8")),
}


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("rung", sorted(RUNGS))
def test_forward_paged_matches_jax(weights, rng, rung, use_kernel):
    jparams, jcfg, tparams, tcfg = weights
    kv_dtype, per_layer = RUNGS[rung]
    nb, bs = 9, 4
    arrs = _pool_arrays(rng, jcfg, nb, bs, kv_dtype, per_layer)
    jpool = jax_pkv.PagedKVPool(**{k: jnp.asarray(v)
                                   for k, v in arrs.items()})
    tpool = t_pkv.PagedKVPool(**params_from_numpy(arrs, device="cpu"))
    before = {k: v.clone() for k, v in tpool._asdict().items()
              if v is not None}

    tables = np.array([[0, 1, 2], [3, 4, 5], [6, 7, 8]], np.int32)
    # (token, row, position, write block, write offset)
    plan = [(17, 0, 5, 1, 1),            # decode, row 0
            (40, 1, 0, 3, 0),            # prefill chunk, row 1
            (41, 1, 1, 3, 1),
            (42, 1, 2, 3, 2),
            (43, 1, 3, 3, 3),
            (0, 0, 0, nb, 0),            # padding: write dropped
            (99, 2, 9, 8, 1),            # decode, row 2
            (18, 0, 4, nb, 0)]           # rescore: write dropped
    cols = [np.array(c, np.int32) for c in zip(*plan)]
    jl, jpool2 = jax_tf.forward_paged(
        jparams, jcfg, *map(jnp.asarray, cols[:1]), pool=jpool,
        tables=jnp.asarray(tables), seq_row=jnp.asarray(cols[1]),
        positions=jnp.asarray(cols[2]), write_block=jnp.asarray(cols[3]),
        write_off=jnp.asarray(cols[4]))
    tc = [torch.from_numpy(c) for c in cols]
    tl, tpool2 = t_tf.forward_paged(
        tparams, tcfg, tc[0], pool=tpool, tables=torch.from_numpy(tables),
        seq_row=tc[1], positions=tc[2], write_block=tc[3],
        write_off=tc[4], use_kernel=use_kernel)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                               atol=LOGITS_ATOL, rtol=LOGITS_ATOL)
    assert tpool2 is tpool                   # updated in place

    written = np.zeros((nb, bs), bool)
    for _, _, _, wb, wo in plan:
        if wb < nb:
            written[wb, wo] = True
    for name, t_after in tpool2._asdict().items():
        if t_after is None:
            assert getattr(jpool2, name) is None
            continue
        t_np = params_from_numpy({"a": np.asarray(getattr(jpool2, name))},
                                 device="cpu")["a"]
        # untouched positions, dropped writes included: bit-identical
        keep = torch.from_numpy(~written)
        assert torch.equal(t_after[:, keep], before[name][:, keep]), name
        assert torch.equal(t_np[:, keep], before[name][:, keep]), name
        new_t, new_j = t_after[:, ~keep].float(), t_np[:, ~keep].float()
        if t_after.dtype == torch.float32:
            torch.testing.assert_close(new_t, new_j, atol=1e-5, rtol=1e-5)
        else:                                # quantized payloads
            assert torch.equal(new_t, new_j), name


def test_out_of_slice_paths_raise(weights):
    """The contiguous-cache forward is ported (it returns (logits, cache)
    as JAX does, with JAX's logits), and so are MoE layers and int8
    weights (tests/test_torch_moe.py, tests/test_torch_quantize.py), and
    the parallel layouts (tests/test_torch_parallel.py): ring attention
    without an 'sp' mesh raises JAX's error, and the pipeline split
    refuses int8 and LoRA params with JAX's TypeErrors."""
    jparams, jcfg, tparams, tcfg = weights
    toks = np.array([[3, 1, 4, 1, 5]], np.int32)
    jl, jc = jax_tf.forward(jparams, jcfg, jnp.asarray(toks),
                            cache=jax_tf.init_kv_cache(jcfg, 1, 16))
    tl, tc = t_tf.forward(tparams, tcfg, torch.from_numpy(toks),
                          cache=t_tf.init_kv_cache(tcfg, 1, 16, device="cpu"))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                               atol=LOGITS_ATOL, rtol=LOGITS_ATOL)
    assert int(tc.length) == int(jc.length) == 5
    with pytest.raises(ValueError, match="'sp' axis"):
        t_tf.forward(tparams, dataclasses.replace(tcfg, attn_impl="ring"),
                     torch.zeros(1, 2, dtype=torch.long))
    # pipeline stages refuse int8 and LoRA leaves with JAX's TypeErrors
    from senweaver_ide_tpu.models.quantize import \
        quantize_weights_int8 as jquantize
    from senweaver_ide_tpu.parallel import split_layers_for_stages as jsplit
    from senweaver_ide_tpu_torch.models.quantize import quantize_weights_int8
    from senweaver_ide_tpu_torch.parallel import split_layers_for_stages
    lora_j = dict(jparams, layers=dict(jparams["layers"],
                                       wq_lora_a=jparams["layers"]["wq"]))
    lora_t = dict(tparams, layers=dict(tparams["layers"],
                                       wq_lora_a=tparams["layers"]["wq"]))
    for jtree, ttree in ((jquantize(jparams), quantize_weights_int8(tparams)),
                         (lora_j, lora_t)):
        with pytest.raises(TypeError) as want:
            jsplit(jtree, 2)
        with pytest.raises(TypeError) as got:
            split_layers_for_stages(ttree, 2)
        assert str(got.value) == str(want.value)
    moe = t_tf.init_params(t_config.tiny_moe_test(), torch.Generator(),
                           device="cpu")
    assert tuple(moe["layers"]["w_gate"].shape) == (2, 4, 64, 128)
    lp = {"w": torch.tensor([[1, -2], [3, 4]], dtype=torch.int8),
          "w_scale": torch.tensor([0.5, 2.0])}
    out = t_tf._dense(torch.ones(1, 2), lp, "w")
    torch.testing.assert_close(out, torch.tensor([[2.0, 4.0]]))


@pytest.mark.parametrize("at", [4, [2, 4]])
def test_cache_forward_logits_at_picks_rows(weights, at):
    """``logits_at`` returns each row's logits at its position, (B, V),
    the full cache forward's values there (the head then runs on those
    rows alone)."""
    _, _, tparams, tcfg = weights
    toks = torch.tensor([[3, 1, 4, 1, 5], [9, 2, 6, 5, 3]])
    full, _ = t_tf.forward(tparams, tcfg, toks,
                           cache=t_tf.init_kv_cache(tcfg, 2, 16,
                                                    device="cpu"))
    got, cache = t_tf.forward(tparams, tcfg, toks,
                              cache=t_tf.init_kv_cache(tcfg, 2, 16,
                                                       device="cpu"),
                              logits_at=torch.tensor(at))
    pos = torch.tensor(at).expand(2)
    assert got.shape == (2, tcfg.vocab_size)
    torch.testing.assert_close(got, full[torch.arange(2), pos])
    assert int(cache.length) == 5
