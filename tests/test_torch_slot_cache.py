"""The port's contiguous KV-cache forward (``forward(cache=KVCache)``)
against the JAX package's on the same weights and tokens: logits within
1e-4 (fp32 test configs) through prefill and decode on the einsum and
flash paths, per-slot lengths with a slot at capacity (dropped writes),
the clamped start of a scalar-length write, the int8 cache (payloads
bit-identical), and the sliding-window ring cache: decode past the
window, wrapping chunked prefill, the int8 ring, the flash ring, the
short absolute SWA cache and the fresh_cache hint."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from senweaver_ide_tpu.models import config as jax_config
from senweaver_ide_tpu.models import transformer as jax_tf
from senweaver_ide_tpu_torch.models import config as t_config
from senweaver_ide_tpu_torch.models import transformer as t_tf
from senweaver_ide_tpu_torch.models.load import params_from_numpy

LOGITS_ATOL = 1e-4
# one compile per (config, shape) instead of a retrace of the layer scan
# on every call
_jax_forward = jax.jit(jax_tf.forward,
                       static_argnames=("config", "fresh_cache", "with_aux"))


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_config.tiny_test()
    jparams = jax_tf.init_params(jcfg, jax.random.PRNGKey(3))
    tparams = params_from_numpy(jax.device_get(jparams), device="cpu")
    return jparams, tparams


def _cfgs(**kw):
    return (dataclasses.replace(jax_config.tiny_test(), **kw),
            dataclasses.replace(t_config.tiny_test(), **kw))


def _caches(jcfg, tcfg, batch, max_len, per_slot=None):
    jc = jax_tf.init_kv_cache(jcfg, batch, max_len)
    tc = t_tf.init_kv_cache(tcfg, batch, max_len, device="cpu")
    if per_slot is not None:
        lens = np.asarray(per_slot, np.int32)
        jc = jc._replace(length=jnp.asarray(lens))
        tc = tc._replace(length=torch.from_numpy(lens))
    return jc, tc


def _np(x):
    return np.asarray(x) if not isinstance(x, torch.Tensor) else x.numpy()


def _run(weights, jcfg, tcfg, tokens, chunks, jc, tc, fresh_first=False):
    """Feed ``tokens[:, lo:hi]`` for each chunk through both caches;
    returns the two logit lists and the final caches."""
    jparams, tparams = weights
    got, want = [], []
    for n, (lo, hi) in enumerate(chunks):
        fresh = fresh_first and n == 0
        jl, jc = _jax_forward(jparams, jcfg, jnp.asarray(tokens[:, lo:hi]),
                              cache=jc, fresh_cache=fresh)
        tl, tc = t_tf.forward(tparams, tcfg, torch.from_numpy(
            tokens[:, lo:hi]), cache=tc, fresh_cache=fresh)
        want.append(np.asarray(jl))
        got.append(tl.numpy())
    return got, want, jc, tc


def _assert_logits(got, want):
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, atol=LOGITS_ATOL, rtol=LOGITS_ATOL,
                                   err_msg=f"call {i}")


def _assert_cache(jc, tc):
    np.testing.assert_array_equal(_np(tc.length), np.asarray(jc.length))
    for name in ("k", "v", "k_scale", "v_scale"):
        a, b = getattr(tc, name), getattr(jc, name)
        if a is None:
            assert b is None, name
            continue
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                   rtol=1e-5, err_msg=name)


def _tokens(rng, b, s):
    return rng.integers(0, 512, size=(b, s)).astype(np.int32)


@pytest.mark.parametrize("impl", ["einsum", "flash"])
def test_prefill_then_decode_matches_jax(weights, rng, impl):
    jcfg, tcfg = _cfgs(decode_attn_impl=impl)
    toks = _tokens(rng, 2, 12)
    jc, tc = _caches(jcfg, tcfg, 2, 24)       # 24 % 8 == 0: tileable
    chunks = [(0, 8)] + [(i, i + 1) for i in range(8, 12)]
    got, want, jc, tc = _run(weights, jcfg, tcfg, toks, chunks, jc, tc)
    _assert_logits(got, want)
    _assert_cache(jc, tc)
    # the returned cache holds the same, updated tensors
    assert int(tc.length) == 12


def test_flash_and_einsum_decode_agree(weights, rng):
    """decode_attn_impl='flash' (the plain version on the CPU) gives the
    einsum path's logits through prefill and decode."""
    _, tparams = weights
    toks = torch.from_numpy(_tokens(rng, 2, 11))
    outs = {}
    for impl in ("einsum", "flash"):
        _, tcfg = _cfgs(decode_attn_impl=impl)
        tc = t_tf.init_kv_cache(tcfg, 2, 24, device="cpu")
        lg, tc = t_tf.forward(tparams, tcfg, toks[:, :8], cache=tc)
        steps = [lg[:, -1]]
        for i in range(8, 11):
            lg, tc = t_tf.forward(tparams, tcfg, toks[:, i:i + 1], cache=tc)
            steps.append(lg[:, -1])
        outs[impl] = torch.stack(steps)
    torch.testing.assert_close(outs["flash"], outs["einsum"], atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("impl", ["einsum", "flash"])
def test_per_slot_lengths_with_a_slot_at_capacity(weights, rng, impl):
    """Per-slot lengths on a 16-position cache: slot 2 sits at capacity,
    so both its writes are dropped and nothing of its row may change;
    slot 1 straddles the end (one write kept, one dropped)."""
    jcfg, tcfg = _cfgs(decode_attn_impl=impl)
    jc, tc = _caches(jcfg, tcfg, 3, 16, per_slot=[3, 15, 16])
    # live-looking contents everywhere, identical on both sides
    k = rng.standard_normal(jc.k.shape).astype(np.float32)
    v = rng.standard_normal(jc.v.shape).astype(np.float32)
    jc = jc._replace(k=jnp.asarray(k), v=jnp.asarray(v))
    tc = tc._replace(k=torch.from_numpy(k.copy()),
                     v=torch.from_numpy(v.copy()))
    toks = _tokens(rng, 3, 3)
    got, want, jc, tc = _run(weights, jcfg, tcfg, toks, [(0, 2), (2, 3)],
                             jc, tc)
    _assert_logits(got, want)
    _assert_cache(jc, tc)
    np.testing.assert_array_equal(tc.k[:, 2].numpy(), k[:, 2])
    np.testing.assert_array_equal(tc.v[:, 2].numpy(), v[:, 2])
    np.testing.assert_array_equal(tc.k[:, 1, :15].numpy(), k[:, 1, :15])


def test_scalar_length_write_clamps_its_start(weights, rng):
    """A scalar length of 14 and a 4-token chunk on a 16-position cache:
    JAX's dynamic_update_slice clamps the start to 12, so the write lands
    at 12..15; the port must write exactly there, not raise."""
    jcfg, tcfg = _cfgs()
    jc, tc = _caches(jcfg, tcfg, 2, 16)
    toks = _tokens(rng, 2, 18)
    got, want, jc, tc = _run(weights, jcfg, tcfg, toks, [(0, 14), (14, 18)],
                             jc, tc)
    _assert_logits(got, want)
    _assert_cache(jc, tc)
    assert int(tc.length) == 18


def test_int8_cache_matches_jax(weights, rng):
    jcfg, tcfg = _cfgs(kv_quant=True, decode_attn_impl="flash")
    jc, tc = _caches(jcfg, tcfg, 2, 24)
    assert tc.quantized and tc.k.dtype == torch.int8
    toks = _tokens(rng, 2, 13)
    chunks = [(0, 9)] + [(i, i + 1) for i in range(9, 13)]
    got, want, jc, tc = _run(weights, jcfg, tcfg, toks, chunks, jc, tc)
    _assert_logits(got, want)
    for name in ("k", "v"):                   # payloads bit-identical
        np.testing.assert_array_equal(getattr(tc, name).numpy(),
                                      np.asarray(getattr(jc, name)))
    for name in ("k_scale", "v_scale"):
        np.testing.assert_allclose(getattr(tc, name).numpy(),
                                   np.asarray(getattr(jc, name)),
                                   rtol=1e-6, atol=0)


def test_ring_decode_past_the_window(weights, rng):
    jcfg, tcfg = _cfgs(sliding_window=4)
    jc, tc = _caches(jcfg, tcfg, 2, 64)
    assert tuple(tc.k.shape[2:3]) == (8,)      # ring of 8 regardless
    toks = _tokens(rng, 2, 20)
    got, want, jc, tc = _run(weights, jcfg, tcfg, toks,
                             [(i, i + 1) for i in range(20)], jc, tc)
    _assert_logits(got, want)
    _assert_cache(jc, tc)


@pytest.mark.parametrize("window,chunks", [
    (8, [(0, 8), (8, 16), (16, 24)]),          # cap == window
    (4, [(0, 6), (6, 12), (12, 18)]),          # chunks past cap - window
    (4, [(0, 5), (5, 9), (9, 12)]),
])
def test_ring_chunked_prefill_with_wrap(weights, rng, window, chunks):
    jcfg, tcfg = _cfgs(sliding_window=window)
    jc, tc = _caches(jcfg, tcfg, 2, 64)
    toks = _tokens(rng, 2, chunks[-1][1])
    got, want, jc, tc = _run(weights, jcfg, tcfg, toks, chunks, jc, tc,
                             fresh_first=True)
    _assert_logits(got, want)
    _assert_cache(jc, tc)
    # and the same as the no-cache forward with the window
    full = t_tf.forward(weights[1], tcfg, torch.from_numpy(toks))
    np.testing.assert_allclose(np.concatenate(got, axis=1), full.numpy(),
                               atol=3e-4)


def test_ring_chunk_larger_than_capacity_raises(weights):
    _, tcfg = _cfgs(sliding_window=4)
    tc = t_tf.init_kv_cache(tcfg, 1, 32, device="cpu")
    with pytest.raises(ValueError, match="ring capacity"):
        t_tf.forward(weights[1], tcfg, torch.ones(1, 9, dtype=torch.long),
                     cache=tc)


def test_ring_int8_cache_matches_jax(weights, rng):
    jcfg, tcfg = _cfgs(sliding_window=4, kv_quant=True)
    jc, tc = _caches(jcfg, tcfg, 1, 32)
    toks = _tokens(rng, 1, 17)
    chunks = [(0, 6), (6, 11)] + [(i, i + 1) for i in range(11, 17)]
    got, want, jc, tc = _run(weights, jcfg, tcfg, toks, chunks, jc, tc)
    _assert_logits(got, want)
    for name in ("k", "v"):
        np.testing.assert_array_equal(getattr(tc, name).numpy(),
                                      np.asarray(getattr(jc, name)))


def test_ring_flash_decode_matches_jax(weights, rng):
    """cap == window 16 makes the ring eligible for flash-decode: per-step
    logits across a wrap equal JAX's flash path and the einsum path."""
    jcfg, tcfg = _cfgs(sliding_window=16, decode_attn_impl="flash")
    jc, tc = _caches(jcfg, tcfg, 2, 64)
    assert tc.k.shape[2] == 16
    toks = _tokens(rng, 2, 24)
    got, want, _, _ = _run(weights, jcfg, tcfg, toks,
                           [(i, i + 1) for i in range(24)], jc, tc)
    _assert_logits(got, want)
    _, ecfg = _cfgs(sliding_window=16)
    ec = t_tf.init_kv_cache(ecfg, 2, 64, device="cpu")
    for i in range(24):
        lg, ec = t_tf.forward(weights[1], ecfg,
                              torch.from_numpy(toks[:, i:i + 1]), cache=ec)
        np.testing.assert_allclose(lg.numpy(), got[i], atol=3e-4)


def test_short_swa_cache_uses_absolute_mode(weights, rng):
    jcfg, tcfg = _cfgs(sliding_window=8, decode_attn_impl="flash")
    jc, tc = _caches(jcfg, tcfg, 1, 6)        # 6 < aligned window 8
    assert tc.k.shape[2] == 6 and not t_tf._is_ring(tcfg, 6)
    toks = _tokens(rng, 1, 6)
    got, want, jc, tc = _run(weights, jcfg, tcfg, toks,
                             [(0, 2)] + [(i, i + 1) for i in range(2, 6)],
                             jc, tc)
    _assert_logits(got, want)
    _assert_cache(jc, tc)


def test_fresh_cache_hint_changes_nothing(weights, rng):
    jcfg, tcfg = _cfgs(sliding_window=4)
    toks = _tokens(rng, 1, 7)
    ga, wa, _, _ = _run(weights, jcfg, tcfg, toks, [(0, 7)],
                        *_caches(jcfg, tcfg, 1, 32), fresh_first=True)
    gb, wb, _, _ = _run(weights, jcfg, tcfg, toks, [(0, 7)],
                        *_caches(jcfg, tcfg, 1, 32))
    _assert_logits(ga, wa)
    np.testing.assert_allclose(ga[0], gb[0], atol=1e-5)


def test_small_test_config_with_aux_and_positions(rng):
    """small_test widths, with_aux and the default per-slot positions."""
    jcfg = jax_config.small_test()
    tcfg = t_config.small_test()
    jparams = jax_tf.init_params(jcfg, jax.random.PRNGKey(5))
    tparams = params_from_numpy(jax.device_get(jparams), device="cpu")
    jc, tc = _caches(jcfg, tcfg, 2, 32, per_slot=[0, 4])
    toks = _tokens(rng, 2, 5)
    jl, jc, _ = _jax_forward(jparams, jcfg, jnp.asarray(toks), cache=jc,
                             with_aux=True)
    tl, tc, aux = t_tf.forward(tparams, tcfg, torch.from_numpy(toks),
                               cache=tc, with_aux=True)
    assert float(aux) == 0.0
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGITS_ATOL,
                               rtol=LOGITS_ATOL)
    _assert_cache(jc, tc)
