"""The port's paged_flash_decode against the JAX Pallas kernel (run in
interpret mode, as the JAX tests run it on the CPU): the four scenarios
of tests/test_paged_attention.py plus int8 and fp8 pools with scales,
fp32, atol 2e-5. The CUDA kernel itself is held against the plain
version on the card by the tests marked ``gpu``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from senweaver_ide_tpu.ops.paged_attention import \
    paged_flash_decode as jax_pfd
from senweaver_ide_tpu_torch.models.load import params_from_numpy
from senweaver_ide_tpu_torch.models.transformer import quantize_pool_kv
from senweaver_ide_tpu_torch.ops import paged_attention as tpa

ATOL = 2e-5


def _mk(rng, t, nb, bs, mb, hq, hkv, d):
    q = rng.standard_normal((t, hq, d)).astype(np.float32)
    k = rng.standard_normal((nb, bs, hkv, d)).astype(np.float32)
    v = rng.standard_normal((nb, bs, hkv, d)).astype(np.float32)
    tables = rng.integers(0, nb, size=(t, mb)).astype(np.int32)
    return q, k, v, tables


def _both(q, k, v, tables, lengths, ks=None, vs=None):
    """(port plain, port wrapper on CPU tensors, JAX interpret)."""
    def tt(a):     # through the weight bridge, which carries fp8 bits
        if a is None:
            return None
        return params_from_numpy({"a": np.asarray(a)}, device="cpu")["a"]

    def jj(a):
        return None if a is None else jnp.asarray(a)

    targs = (tt(q), tt(k), tt(v), tt(tables), tt(lengths), tt(ks), tt(vs))
    plain = tpa.paged_flash_decode_plain(*targs)
    wrapped = tpa.paged_flash_decode(*targs)
    ref = jax_pfd(jj(q), jj(k), jj(v), jj(tables), jj(lengths),
                  k_scale=jj(ks), v_scale=jj(vs), interpret=True)
    return plain.numpy(), wrapped.numpy(), np.asarray(ref)


def _check(plain, wrapped, ref, atol=ATOL):
    np.testing.assert_allclose(plain, ref, atol=atol, rtol=atol)
    np.testing.assert_array_equal(wrapped, plain)


@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2), (8, 1)])
def test_matches_jax_kernel(rng, hq, hkv):
    q, k, v, tables = _mk(rng, 5, 9, 16, 4, hq, hkv, 16)
    lengths = np.array([1, 17, 33, 64, 50], np.int32)
    _check(*_both(q, k, v, tables, lengths))


def test_aliased_blocks_shared_prefix(rng):
    q, k, v, _ = _mk(rng, 4, 6, 8, 3, 4, 2, 16)
    tables = np.array([[0, 1, 2 + i % 3] for i in range(4)], np.int32)
    lengths = np.array([20, 24, 17, 21], np.int32)
    _check(*_both(q, k, v, tables, lengths))


def test_scalar_length_broadcasts(rng):
    q, k, v, tables = _mk(rng, 3, 5, 8, 2, 4, 2, 16)
    _check(*_both(q, k, v, tables, np.int32(12)))


def test_length_one_skips_dead_blocks(rng):
    q, k, v, tables = _mk(rng, 2, 4, 8, 4, 4, 2, 16)
    tables[:, 0] = [0, 1]
    lengths = np.array([1, 1], np.int32)
    clean = _both(q, k, v, tables, lengths)
    _check(*clean)
    k_bad, v_bad = k.copy(), v.copy()
    k_bad[2:], v_bad[2:] = 1e4, 1e4
    tables_bad = tables.copy()
    tables_bad[:, 1:] = 3
    poisoned = _both(q, k_bad, v_bad, tables_bad, lengths)
    np.testing.assert_allclose(poisoned[0], clean[0], atol=ATOL)


@pytest.mark.parametrize("payload", [torch.int8, torch.float8_e4m3fn])
def test_quantized_pools_match_jax(rng, payload):
    t, nb, bs, mb, hq, hkv, d = 5, 9, 8, 4, 4, 2, 16
    q, k, v, tables = _mk(rng, t, nb, bs, mb, hq, hkv, d)
    kq, ks = quantize_pool_kv(torch.from_numpy(k), payload)
    vq, vs = quantize_pool_kv(torch.from_numpy(v), payload)
    lengths = np.array([1, 9, 16, 25, 32], np.int32)
    args = [q, None, None, tables, lengths, ks.numpy(), vs.numpy()]
    if payload == torch.int8:
        args[1], args[2] = kq.numpy(), vq.numpy()
    else:       # same bits, as the ml_dtypes fp8 JAX reads
        args[1] = kq.view(torch.uint8).numpy().view(jnp.float8_e4m3fn)
        args[2] = vq.view(torch.uint8).numpy().view(jnp.float8_e4m3fn)
    plain, _, ref = _both(*args)
    np.testing.assert_allclose(plain, ref, atol=ATOL, rtol=ATOL)
    # the wrapper routes CPU tensors to the plain version
    wrapped = tpa.paged_flash_decode(
        torch.from_numpy(q), kq, vq, torch.from_numpy(tables),
        torch.from_numpy(lengths), ks, vs)
    np.testing.assert_array_equal(wrapped.numpy(), plain)


def test_zero_length_row_is_zero(rng):
    q, k, v, tables = _mk(rng, 2, 4, 8, 2, 4, 2, 16)
    out = tpa.paged_flash_decode_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(tables), torch.tensor([0, 5], dtype=torch.int32))
    assert torch.count_nonzero(out[0]) == 0
    assert torch.count_nonzero(out[1]) > 0


def _valid_args(t=3, nb=4, bs=8, hq=4, hkv=2, d=16, dtype=torch.bfloat16,
                quant=None):
    q = torch.zeros(t, hq, d, dtype=dtype)
    pool_dtype = quant or dtype
    k = torch.zeros(nb, bs, hkv, d, dtype=pool_dtype)
    v = torch.zeros(nb, bs, hkv, d, dtype=pool_dtype)
    tables = torch.zeros(t, 2, dtype=torch.int32)
    lengths = torch.ones(t, dtype=torch.int32)
    ks = vs = None
    if quant is not None:
        ks = torch.ones(nb, bs, hkv)
        vs = torch.ones(nb, bs, hkv)
    return [q, k, v, tables, lengths, ks, vs]


@pytest.mark.parametrize("breakage,match", [
    ("q_f16", "q dtype"),
    ("pool_f16", "pool dtypes"),
    ("noncontig", "contiguous"),
    ("tables_i64", "tables must be int32"),
    ("lengths_shape", "lengths must be int32"),
    ("missing_scales", "need k_scale"),
    ("scales_dtype", "scales must be f32"),
    ("head_dim", "16-byte"),
    ("gqa", "multiple of Hkv"),
])
def test_kernel_argument_checks_raise(breakage, match):
    """The wrapper's checks run before any launch; they are device
    independent, so they are exercised here on host tensors."""
    quant = torch.int8 if breakage in ("missing_scales",
                                       "scales_dtype") else None
    a = _valid_args(quant=quant,
                    d=4 if breakage == "head_dim" else 16,
                    hq=3 if breakage == "gqa" else 4)
    if breakage == "q_f16":
        a[0] = a[0].half()
    elif breakage == "pool_f16":
        a[1], a[2] = a[1].half(), a[2].half()
    elif breakage == "noncontig":
        a[0] = torch.zeros(16, 4, 3, dtype=torch.bfloat16).transpose(0, 2)
    elif breakage == "tables_i64":
        a[3] = a[3].long()
    elif breakage == "lengths_shape":
        a[4] = torch.ones(5, dtype=torch.int32)
    elif breakage == "missing_scales":
        a[5] = a[6] = None
    elif breakage == "scales_dtype":
        a[5], a[6] = a[5].double(), a[6].double()
    with pytest.raises(ValueError, match=match):
        tpa._check(*a)


@pytest.mark.gpu
@pytest.mark.parametrize("pool", ["f32", "bf16", "int8", "fp8"])
@pytest.mark.parametrize("qdtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_matches_plain(pool, qdtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(0)
    t, nb, bs, mb, hq, hkv, d = 9, 300, 16, 128, 12, 2, 128
    q = torch.randn(t, hq, d, generator=g, device="cuda").to(qdtype)
    kf = torch.randn(nb, bs, hkv, d, generator=g, device="cuda")
    vf = torch.randn(nb, bs, hkv, d, generator=g, device="cuda")
    ks = vs = None
    if pool == "f32":
        kp, vp = kf, vf
    elif pool == "bf16":
        kp, vp = kf.bfloat16(), vf.bfloat16()
    else:
        dt = torch.int8 if pool == "int8" else torch.float8_e4m3fn
        (kp, ks), (vp, vs) = quantize_pool_kv(kf, dt), quantize_pool_kv(vf, dt)
    tables = torch.randint(0, nb, (t, mb), generator=g, device="cuda",
                           dtype=torch.int32)
    tables[3] = tables[2]                   # aliased rows
    lengths = torch.tensor([1, 15, 16, 17, 1000, 2048, 2048, 33, 0],
                           dtype=torch.int32, device="cuda")
    before = tpa.paged_flash_decode.launches
    out = tpa.paged_flash_decode(q, kp, vp, tables, lengths, ks, vs)
    torch.cuda.synchronize()
    assert tpa.paged_flash_decode.launches == before + 1
    ref = tpa.paged_flash_decode_plain(q.float(), kp, vp, tables, lengths,
                                       ks, vs)
    # fp32 accumulation in both; a bf16 output rounds at 2**-9 relative
    tol = 1e-4 if qdtype == torch.float32 else 1e-2
    torch.testing.assert_close(out.float(), ref, atol=tol, rtol=tol)
    assert torch.count_nonzero(out[8]) == 0
