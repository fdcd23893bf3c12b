"""The port's contiguous-cache decode functions (prefill, prefill_chunked,
decode_step, generate, generate_scan) against the JAX package's on the
same weights, greedy: identical tokens, including a prompt longer than a
sliding-window ring (chunked through it), the int8 cache, and eos
overwriting the tokens after it."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from senweaver_ide_tpu.models import init_kv_cache as jax_init_kv_cache
from senweaver_ide_tpu.models import init_params as jax_init_params
from senweaver_ide_tpu.models import tiny_test as jax_tiny_test
from senweaver_ide_tpu.rollout import sampler as jax_sampler
from senweaver_ide_tpu_torch.models import (init_kv_cache, params_from_numpy,
                                            tiny_test)
from senweaver_ide_tpu_torch.rollout import sampler

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


@pytest.fixture(scope="module")
def weights():
    jparams = jax_init_params(jax_tiny_test(), jax.random.PRNGKey(8))
    return jparams, params_from_numpy(jax.device_get(jparams), device="cpu")


def _cfgs(**kw):
    return (dataclasses.replace(jax_tiny_test(), **kw),
            dataclasses.replace(tiny_test(), **kw))


@pytest.mark.parametrize("cfg,s", [
    ({}, 7),
    ({"sliding_window": 8}, 20),               # 20 tokens through a ring of 8
    ({"kv_quant": True, "decode_attn_impl": "flash"}, 9)])
def test_generate_matches_jax(weights, rng, cfg, s):
    jcfg, tcfg = _cfgs(**cfg)
    prompt = rng.integers(1, 500, size=(2, s)).astype(np.int32)
    want = jax_sampler.generate(weights[0], jcfg, jnp.asarray(prompt),
                                max_new_tokens=6,
                                sample=jax_sampler.SampleParams(*GREEDY),
                                key=jax.random.PRNGKey(0), max_len=64)
    got = sampler.generate(weights[1], tcfg, torch.from_numpy(prompt),
                           max_new_tokens=6,
                           sample=sampler.SampleParams(*GREEDY), max_len=64)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("cfg,s", [({}, 7), ({"sliding_window": 8}, 19)])
def test_generate_scan_matches_jax_and_generate(weights, rng, cfg, s):
    jcfg, tcfg = _cfgs(**cfg)
    prompt = rng.integers(1, 500, size=(2, s)).astype(np.int32)
    want, _ = jax_sampler.generate_scan(
        weights[0], jcfg, jnp.asarray(prompt),
        jax_init_kv_cache(jcfg, 2, 32), jax.random.PRNGKey(1),
        max_new_tokens=5, sample=jax_sampler.SampleParams(*GREEDY))
    got, cache = sampler.generate_scan(
        weights[1], tcfg, torch.from_numpy(prompt),
        init_kv_cache(tcfg, 2, 32, device="cpu"), max_new_tokens=5,
        sample=sampler.SampleParams(*GREEDY))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(cache.length) == s + 4
    host = sampler.generate(weights[1], tcfg, torch.from_numpy(prompt),
                            max_new_tokens=5,
                            sample=sampler.SampleParams(*GREEDY), max_len=32)
    assert torch.equal(host, got)


def test_eos_overwrites_later_tokens(weights, rng):
    """With eos set to a token one row emits mid-stream, that row repeats
    eos afterwards in both loops, as in JAX; generate stops once every
    row is done."""
    jcfg, tcfg = _cfgs()
    prompt = rng.integers(1, 500, size=(2, 6)).astype(np.int32)
    free, _ = sampler.generate_scan(
        weights[1], tcfg, torch.from_numpy(prompt),
        init_kv_cache(tcfg, 2, 32, device="cpu"), max_new_tokens=8,
        sample=sampler.SampleParams(*GREEDY))
    eos = int(free[0, 2])
    want, _ = jax_sampler.generate_scan(
        weights[0], jcfg, jnp.asarray(prompt),
        jax_init_kv_cache(jcfg, 2, 32), jax.random.PRNGKey(1),
        max_new_tokens=8, sample=jax_sampler.SampleParams(*GREEDY),
        eos_id=eos)
    got, _ = sampler.generate_scan(
        weights[1], tcfg, torch.from_numpy(prompt),
        init_kv_cache(tcfg, 2, 32, device="cpu"), max_new_tokens=8,
        sample=sampler.SampleParams(*GREEDY), eos_id=eos)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    first = int((got[0] == eos).nonzero()[0])
    assert bool((got[0, first:] == eos).all())
    gen = sampler.generate(weights[1], tcfg, torch.from_numpy(prompt),
                           max_new_tokens=8, eos_id=eos,
                           sample=sampler.SampleParams(*GREEDY), max_len=32)
    jgen = jax_sampler.generate(weights[0], jcfg, jnp.asarray(prompt),
                                max_new_tokens=8, eos_id=eos,
                                sample=jax_sampler.SampleParams(*GREEDY),
                                key=jax.random.PRNGKey(0), max_len=32)
    np.testing.assert_array_equal(gen.numpy(), np.asarray(jgen))


def test_prefill_chunked_and_decode_step_match_jax(weights, rng):
    jcfg, tcfg = _cfgs(sliding_window=8)
    prompt = rng.integers(1, 500, size=(1, 21)).astype(np.int32)
    jl, jc = jax_sampler.prefill_chunked(weights[0], jcfg,
                                         jnp.asarray(prompt),
                                         jax_init_kv_cache(jcfg, 1, 64))
    tl, tc = sampler.prefill_chunked(weights[1], tcfg,
                                     torch.from_numpy(prompt),
                                     init_kv_cache(tcfg, 1, 64,
                                                   device="cpu"))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    tok = tl.argmax(-1)
    nt, logits, tc = sampler.decode_step(weights[1], tcfg, tok[:, None], tc,
                                         None, sampler.SampleParams(*GREEDY))
    jnt, jlogits, _ = jax_sampler.decode_step(
        weights[0], jcfg, jnp.asarray(tok.numpy())[:, None], jc,
        jax.random.PRNGKey(0), jax_sampler.SampleParams(*GREEDY))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=1e-4)
    assert nt.tolist() == np.asarray(jnt).tolist()
    assert int(tc.length) == 22
