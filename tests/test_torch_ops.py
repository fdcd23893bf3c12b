"""The PyTorch port's ops against the JAX package's: RMSNorm, RoPE (with
llama3 scaling), GQA attention (causal, window, 2-D/3-D kv_mask, per-row
q_offset) and the sampling transforms, on the same numpy inputs in fp32
(atol 2e-5: fp32 rounding of differently ordered sums)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from senweaver_ide_tpu.models.config import RopeScaling as JaxRopeScaling
from senweaver_ide_tpu.ops.attention import attention as jax_attn
from senweaver_ide_tpu.ops.attention import causal_mask as jax_causal_mask
from senweaver_ide_tpu.ops import norms as jax_norms
from senweaver_ide_tpu.ops import rotary as jax_rotary
from senweaver_ide_tpu.ops import sampling as jax_sampling
from senweaver_ide_tpu_torch.models.config import RopeScaling
from senweaver_ide_tpu_torch.ops.attention import attention as t_attn
from senweaver_ide_tpu_torch.ops.attention import causal_mask as t_causal_mask
from senweaver_ide_tpu_torch.ops import norms as t_norms
from senweaver_ide_tpu_torch.ops import rotary as t_rotary
from senweaver_ide_tpu_torch.ops import sampling as t_sampling

ATOL = 2e-5


def _close(t_out, j_out, atol=ATOL):
    np.testing.assert_allclose(t_out.detach().numpy(), np.asarray(j_out),
                               atol=atol, rtol=atol)


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def test_rms_norm(rng):
    x, w = _randn(rng, 3, 5, 32), _randn(rng, 32)
    _close(t_norms.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5),
           jax_norms.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5))


@pytest.mark.parametrize("scaling", [None, "llama3"])
def test_rope(rng, scaling):
    pos = rng.integers(0, 20_000, size=(2, 7)).astype(np.int32)
    x = _randn(rng, 2, 7, 3, 64)
    js = JaxRopeScaling(factor=32.0) if scaling else None
    ts = RopeScaling(factor=32.0) if scaling else None
    jc, jsn = jax_rotary.rope_cos_sin(jnp.asarray(pos), 64, 500_000.0,
                                      scaling=js)
    tc, tsn = t_rotary.rope_cos_sin(torch.from_numpy(pos), 64, 500_000.0,
                                    scaling=ts)
    # angles reach 2e4 rad: fp32 argument rounding differs by ~1e-3 ulp
    # of the angle between the two frameworks' cos/sin, so compare the
    # tables at 1e-3 and the rotation itself on moderate positions
    _close(tc, jc, atol=1e-3)
    _close(tsn, jsn, atol=1e-3)
    _close(t_rotary.apply_rope(torch.from_numpy(x), tc, tsn),
           jax_rotary.apply_rope(jnp.asarray(x), jnp.asarray(tc.numpy()),
                                 jnp.asarray(tsn.numpy())))
    _close(t_rotary.rope_frequencies(64, 1e6),
           jax_rotary.rope_frequencies(64, 1e6))


def test_rope_positions_within_context(rng):
    pos = np.arange(0, 4096, 37, dtype=np.int32)[None]
    jc, jsn = jax_rotary.rope_cos_sin(jnp.asarray(pos), 128, 1e6)
    tc, tsn = t_rotary.rope_cos_sin(torch.from_numpy(pos), 128, 1e6)
    _close(tc, jc, atol=1e-4)
    _close(tsn, jsn, atol=1e-4)


ATTN_CASES = {
    "gqa_causal": dict(),
    "mha": dict(hkv=4),
    "q_offset_scalar": dict(sq=3, skv=9, q_offset=6),
    "q_offset_rows": dict(sq=2, skv=9, q_offset=np.array([7, 3])),
    "window": dict(sq=6, skv=6, window=3),
    "kv_mask_2d": dict(kv_mask="2d"),
    "kv_mask_3d_noncausal": dict(kv_mask="3d", causal=False),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_attention(rng, case):
    kw = dict(ATTN_CASES[case])
    b, hq, d = 2, 4, 16
    sq, skv = kw.pop("sq", 5), kw.pop("skv", 5)
    hkv = kw.pop("hkv", 2)
    q, k, v = (_randn(rng, b, sq, hq, d), _randn(rng, b, skv, hkv, d),
               _randn(rng, b, skv, hkv, d))
    mask_kind = kw.pop("kv_mask", None)
    if mask_kind == "2d":
        m = rng.random((b, skv)) > 0.3
        m[:, 0] = True
        kw["kv_mask"] = m
    elif mask_kind == "3d":
        m = rng.random((b, sq, skv)) > 0.3
        m[..., 0] = True
        kw["kv_mask"] = m
    jkw = {k2: (jnp.asarray(v2) if isinstance(v2, np.ndarray) else v2)
           for k2, v2 in kw.items()}
    tkw = {k2: (torch.from_numpy(v2) if isinstance(v2, np.ndarray) else v2)
           for k2, v2 in kw.items()}
    _close(t_attn(torch.from_numpy(q), torch.from_numpy(k),
                  torch.from_numpy(v), **tkw),
           jax_attn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **jkw))


def test_attention_bf16_inputs_track_fp32(rng):
    """Low-precision inputs: fp32 scores, bf16 probabilities, fp32 PV
    sums (the JAX preferred_element_type contract) stay within bf16
    rounding of the fp32 result."""
    q, k, v = (_randn(rng, 1, 4, 4, 16), _randn(rng, 1, 4, 2, 16),
               _randn(rng, 1, 4, 2, 16))
    full = t_attn(torch.from_numpy(q), torch.from_numpy(k),
                  torch.from_numpy(v))
    low = t_attn(torch.from_numpy(q).bfloat16(),
                 torch.from_numpy(k).bfloat16(),
                 torch.from_numpy(v).bfloat16())
    assert low.dtype == torch.bfloat16
    np.testing.assert_allclose(low.float().numpy(), full.numpy(), atol=5e-2)


@pytest.mark.parametrize("q_offset,window", [(0, None), (3, 4),
                                             (np.array([1, 5]), None)])
def test_causal_mask(q_offset, window):
    j = jax_causal_mask(3, 8, jnp.asarray(q_offset), window)
    t = t_causal_mask(3, 8, torch.as_tensor(q_offset), window)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_top_k_and_temperature(rng):
    logits = _randn(rng, 3, 50)
    _close(t_sampling.apply_top_k(torch.from_numpy(logits), 5),
           jax_sampling.apply_top_k(jnp.asarray(logits), 5))
    _close(t_sampling.apply_temperature(torch.from_numpy(logits), 0.7),
           jax_sampling.apply_temperature(jnp.asarray(logits), 0.7))


@pytest.mark.parametrize("k", [8, 20])
def test_top_k_at_or_past_vocab_keeps_all(rng, k):
    logits = _randn(rng, 2, 8)
    got = t_sampling.apply_top_k(torch.from_numpy(logits), k)
    ref = jax_sampling.apply_top_k(jnp.asarray(logits), k)
    _close(got, ref)
    np.testing.assert_array_equal(got.numpy(), logits)


@pytest.mark.parametrize("cutoff", [None, 8, 128])
def test_top_p(rng, cutoff):
    logits = 3.0 * _randn(rng, 4, 200)
    _close(t_sampling.apply_top_p(torch.from_numpy(logits), 0.9, cutoff),
           jax_sampling.apply_top_p(jnp.asarray(logits), 0.9, cutoff))


def test_greedy_sample_and_logprob(rng):
    logits = _randn(rng, 5, 64)
    logits[1, [3, 9]] = 10.0            # tie: the first index wins
    tt = t_sampling.sample_token(torch.from_numpy(logits), None,
                                 temperature=0.0)
    jt = jax_sampling.sample_token(jnp.asarray(logits),
                                   jax.random.PRNGKey(0), temperature=0.0)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert int(tt[1]) == 3
    _close(t_sampling.sampled_logprob(torch.from_numpy(logits), tt),
           jax_sampling.sampled_logprob(jnp.asarray(logits), jt))


def test_sampling_distribution_and_nucleus(rng):
    """Random draws cannot match JAX's stream: check the default
    (temperature 0.8, top_p 0.95, cutoff 128) draws only from the JAX
    nucleus, and plain draws follow softmax."""
    logits = 2.0 * _randn(rng, 1, 300)
    g = torch.Generator().manual_seed(0)
    draws = t_sampling.sample_token(
        torch.from_numpy(logits).expand(4000, 300), g, temperature=0.8,
        top_p=0.95)
    nucleus = jax_sampling.apply_top_p(jnp.asarray(logits) / 0.8, 0.95, 128)
    allowed = set(np.nonzero(np.asarray(nucleus)[0] > -1e29)[0].tolist())
    assert set(draws.tolist()) <= allowed

    small = np.array([[0.0, 1.0, 2.0, -1.0]], np.float32)
    d = t_sampling.sample_token(torch.from_numpy(small).expand(20000, 4), g,
                                temperature=1.0)
    freq = np.bincount(d.numpy(), minlength=4) / 20000
    p = np.exp(small[0]) / np.exp(small[0]).sum()
    np.testing.assert_allclose(freq, p, atol=0.015)
