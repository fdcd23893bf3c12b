"""The port's flash_decode against the JAX package's (Pallas kernel in
interpret mode) on the same numpy inputs: per-slot lengths, GQA shapes,
a scalar length, the block-alignment contract, a short slot in a long
pool, bf16 I/O, the Sq=1 contract and the 3-D round trip. On the CPU the
port runs its plain version; the CUDA kernel is held against that plain
version on the card by the test marked ``gpu``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from senweaver_ide_tpu.ops.flash_decode import flash_decode as jax_fd
from senweaver_ide_tpu_torch.ops.flash_decode import (flash_decode,
                                                      flash_decode_plain)

ATOL = 2e-5          # the JAX tests' kernel-vs-reference tolerance
BF16_ATOL = 3e-2     # bf16 I/O, fp32 accumulation on both sides


def _mk(rng, b, smax, hq, hkv, d):
    q = rng.standard_normal((b, 1, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, smax, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, smax, hkv, d)).astype(np.float32)
    return q, k, v


def _both(q, k, v, lengths, **kw):
    want = jax_fd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  jnp.asarray(lengths), interpret=True, **kw)
    got = flash_decode(torch.from_numpy(q), torch.from_numpy(k),
                       torch.from_numpy(v), torch.as_tensor(lengths), **kw)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("hq,hkv", [(8, 8), (12, 2), (4, 1)])
def test_matches_jax(rng, hq, hkv):
    q, k, v = _mk(rng, 3, 256, hq, hkv, 128)
    got, want = _both(q, k, v, np.array([5, 128, 256], np.int32),
                      block_kv=128)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL)


def test_scalar_length_broadcasts(rng):
    q, k, v = _mk(rng, 2, 128, 4, 2, 128)
    got, want = _both(q, k, v, np.int32(64))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL)
    vec = flash_decode(torch.from_numpy(q), torch.from_numpy(k),
                       torch.from_numpy(v), torch.tensor([64, 64]))
    np.testing.assert_array_equal(got, vec.numpy())


def test_non_divisible_smax_rejected_unless_opted_in(rng):
    q, k, v = _mk(rng, 2, 200, 4, 2, 128)               # 200 % 128 != 0
    lengths = np.array([200, 37], np.int32)
    with pytest.raises(ValueError, match="block-aligned"):
        flash_decode(torch.from_numpy(q), torch.from_numpy(k),
                     torch.from_numpy(v), torch.from_numpy(lengths),
                     block_kv=128)
    got, want = _both(q, k, v, lengths, block_kv=128, allow_pad_copy=True)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL)


def test_short_slot_in_long_pool(rng):
    """One valid token in a 512-position row: the output is its v."""
    q, k, v = _mk(rng, 2, 512, 4, 4, 128)
    got, want = _both(q, k, v, np.array([1, 512], np.int32))
    np.testing.assert_allclose(got[0, 0], v[0, 0], atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL)


def test_zero_length_gives_zeros(rng):
    q, k, v = _mk(rng, 2, 128, 12, 2, 64)
    got, want = _both(q, k, v, np.array([0, 77], np.int32))
    assert not got[0].any() and not want[0].any()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL)


def test_bf16_io_fp32_accumulation(rng):
    q, k, v = _mk(rng, 2, 128, 12, 2, 128)
    lengths = np.array([100, 17], np.int32)
    want = jax_fd(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                  jnp.asarray(lengths), interpret=True)
    got = flash_decode(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)),
                       torch.from_numpy(lengths))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want).astype(np.float32),
                               atol=BF16_ATOL, rtol=BF16_ATOL)


def test_multi_query_rejected(rng):
    q, k, v = _mk(rng, 1, 128, 4, 2, 128)
    q2 = torch.from_numpy(np.concatenate([q, q], axis=1))
    with pytest.raises(ValueError, match="Sq=1"):
        flash_decode(q2, torch.from_numpy(k), torch.from_numpy(v), 8)


def test_3d_query_squeeze_roundtrip(rng):
    q, k, v = _mk(rng, 2, 128, 4, 2, 128)
    kt, vt = torch.from_numpy(k), torch.from_numpy(v)
    out4 = flash_decode(torch.from_numpy(q), kt, vt, 32)
    out3 = flash_decode(torch.from_numpy(q[:, 0]), kt, vt, 32)
    assert tuple(out3.shape) == (2, 4, 128)
    assert torch.equal(out4[:, 0], out3)
    want = jax_fd(jnp.asarray(q[:, 0]), jnp.asarray(k), jnp.asarray(v), 32,
                  interpret=True)
    np.testing.assert_allclose(out3.numpy(), np.asarray(want), atol=ATOL,
                               rtol=ATOL)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,heads", [
    (torch.bfloat16, (32, 8, 128)), (torch.float32, (12, 2, 128)),
    (torch.bfloat16, (14, 2, 64))])
def test_kernel_matches_plain_on_card(dtype, heads):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    hq, hkv, d = heads
    g = torch.Generator(device="cuda").manual_seed(0)
    smax = 1111
    lengths = torch.tensor([0, 1, 127, 128, 129, 1000, smax],
                           dtype=torch.int32, device="cuda")
    b = lengths.numel()
    q = torch.randn(b, hq, d, generator=g, device="cuda").to(dtype)
    k = torch.randn(b, smax, hkv, d, generator=g, device="cuda").to(dtype)
    v = torch.randn(b, smax, hkv, d, generator=g, device="cuda").to(dtype)
    before = flash_decode.launches
    out = flash_decode(q, k, v, lengths, allow_pad_copy=True)
    torch.cuda.synchronize()
    assert flash_decode.launches == before + 1
    ref = flash_decode_plain(q.float(), k.float(), v.float(), lengths)
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-4
    assert bool(((out.float() - ref).abs() <= tol + tol * ref.abs()).all())
