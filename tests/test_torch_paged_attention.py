"""The port's paged_flash_decode against the JAX Pallas kernel (run in
interpret mode, as the JAX tests run it on the CPU): the four scenarios
of tests/test_paged_attention.py plus int8 and fp8 pools with scales,
fp32, atol 2e-5. Query tiles (host-built groups of entries that read one
table row) leave the result unchanged and are checked on the host; the
split plan asks for about BLOCKS_PER_SM blocks an SM. The CUDA kernel
itself is held against the plain version on the card by the tests
marked ``gpu``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from senweaver_ide_tpu.ops.paged_attention import \
    paged_flash_decode as jax_pfd
from senweaver_ide_tpu_torch.models.load import params_from_numpy
from senweaver_ide_tpu_torch.models.transformer import quantize_pool_kv
from senweaver_ide_tpu_torch.ops import paged_attention as tpa
from senweaver_ide_tpu_torch.ops.flash_decode import (BLOCKS_PER_SM, FD_TILE,
                                                      split_plan)

ATOL = 2e-5


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


def _segments_batch(rng, rep=2, hkv=2, d=16, bs=4, mb=8):
    """Two decode rows, then a 5-token and a 3-token prefill segment of
    two more sequences, as the engine lays a step out; tables per entry
    are their sequence's row. Returns (q, k, v, tables, lengths, tiles)."""
    seq_row = np.array([0, 1, 2, 2, 2, 2, 2, 3, 3, 3])
    positions = np.array([20, 7, 9, 10, 11, 12, 13, 0, 1, 2])
    q, k, v, seq_tables = _mk(rng, len(seq_row), 4 * mb, bs, mb, hkv * rep,
                              hkv, d)
    seq_tables = seq_tables[:4]
    tables = torch.from_numpy(seq_tables[seq_row])
    lengths = torch.from_numpy((positions + 1).astype(np.int32))
    tiles = tpa.query_tiles(torch.from_numpy(seq_row),
                            torch.from_numpy(positions), rep)
    return (torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            tables, lengths, tiles)


def test_query_tiles_group_prefill_segments(rng):
    *_, tiles = _segments_batch(rng)
    assert tiles.dtype == torch.int32
    assert tiles.tolist() == [[0, 1], [1, 1], [2, 5], [7, 3]]
    # runs are cut at TILE_ROWS // rep entries (one m16 row block of the
    # kernel), and at a position gap
    rows = torch.zeros(40, dtype=torch.long)
    pos = torch.arange(40)
    pos[30:] += 1
    assert tpa.TILE_ROWS == 16
    assert tpa.query_tiles(rows, pos, 2).tolist() == [
        [0, 8], [8, 8], [16, 8], [24, 6], [30, 8], [38, 2]]
    assert tpa.query_tiles(rows, pos, 6)[:, 1].tolist() == [2] * 20
    assert tpa.query_tiles(rows, pos, 16)[:, 1].tolist() == [1] * 40
    assert tpa.query_tiles(rows, pos, 32)[:, 1].tolist() == [1] * 40
    assert tpa.query_tiles([], [], 6).shape == (0, 2)


@pytest.mark.parametrize("quant", [None, torch.int8])
def test_tiles_leave_the_result_unchanged(rng, quant):
    q, k, v, tables, lengths, tiles = _segments_batch(rng)
    ks = vs = None
    if quant is not None:
        (k, ks), (v, vs) = (quantize_pool_kv(k, quant),
                            quantize_pool_kv(v, quant))
    args = (q, k, v, tables, lengths, ks, vs)
    plain = tpa.paged_flash_decode_plain(*args)
    for fn in (tpa.paged_flash_decode_plain, tpa.paged_flash_decode):
        np.testing.assert_array_equal(fn(*args, q_tiles=tiles).numpy(),
                                      plain.numpy())
        np.testing.assert_array_equal(fn(*args).numpy(), plain.numpy())


@pytest.mark.parametrize("breakage,match", [
    ("gap", "comes next"),
    ("overlap", "comes next"),
    ("zero_count", "outside"),
    ("short_total", "cover"),
    ("long_total", "cover"),
    ("too_many_rows", "outside"),
    ("two_table_rows", "more than one table row"),
    ("int64", "host int32"),
    ("on_a_device", "host int32"),
])
def test_malformed_tiles_raise(rng, breakage, match):
    q, k, v, tables, lengths, tiles = _segments_batch(rng)
    t = tiles.tolist()
    if breakage == "gap":
        t = [[0, 1], [2, 5], [7, 3]]
    elif breakage == "overlap":
        t = [[0, 1], [1, 1], [2, 5], [6, 4]]
    elif breakage == "zero_count":
        t = [[0, 1], [1, 0], [1, 1], [2, 5], [7, 3]]
    elif breakage == "short_total":
        t = t[:-1]
    elif breakage == "long_total":
        t = t + [[10, 1]]
    elif breakage == "too_many_rows":     # 3 entries x rep 6 > 16 rows
        a = _valid_args(t=40, hq=12, hkv=2, dtype=torch.float32)
        with pytest.raises(ValueError, match=match):
            tpa.paged_flash_decode(*a, q_tiles=torch.tensor(
                [[0, 3], [3, 2]] + [[i, 1] for i in range(5, 40)],
                dtype=torch.int32))
        return
    elif breakage == "two_table_rows":
        t = [[0, 2], [2, 5], [7, 3]]
    bad = torch.tensor(t, dtype=torch.int32)
    if breakage == "int64":
        bad = tiles.long()
    elif breakage == "on_a_device":       # tiles are host-built only
        bad = tiles.to("meta")
    for fn in (lambda: tpa.paged_flash_decode(q, k, v, tables, lengths,
                                              q_tiles=bad),
               lambda: tpa.check_query_tiles(bad, q.shape[0], 2, tables)):
        with pytest.raises(ValueError, match=match):
            fn()


@pytest.mark.parametrize("n_tiles", [16, 40, 64])
def test_split_plan_at_the_timing_shapes(n_tiles):
    """K1 reuses flash_decode's plan: at the decode step (16 tiles), the
    mixed step (40 tiles of up to TILE_ROWS rows) and a 64-entry untiled
    step, Qwen2.5-Coder-1.5B heads (Hkv 2), 128 blocks of 16 positions a
    table row."""
    hkv, cap, sms = 2, 128 * 16, 132
    splits, chunk = split_plan(n_tiles, hkv, cap, sms)
    assert chunk % FD_TILE == 0 and splits * chunk >= cap
    assert (splits - 1) * chunk < cap          # no split wholly past cap
    blocks = splits * hkv * n_tiles
    want = BLOCKS_PER_SM * sms
    # about BLOCKS_PER_SM an SM, as the chunk granularity allows
    assert want / 2 <= blocks <= 2 * want or splits == 1


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
    # query tiles as forward_paged builds them (16 rows: 2 entries at rep
    # 6): decode rows, then prefill segments from positions 15, 31 and
    # 1000 of their table rows (in a tile of lengths 16 and 17 a warp's
    # step at position 16 is wholly past the shorter row), then a decode
    # row at the table's end, against the same plain version
    seq_row = torch.tensor([0, 1] + [4] * 10 + [2] * 10 + [3] * 10 + [5])
    pos = torch.tensor([0, 14] + list(range(15, 25)) + list(range(31, 41))
                       + list(range(1000, 1010)) + [2047])
    tables_s = tables[seq_row.cuda()].contiguous()
    lengths_s = (pos + 1).to(torch.int32).cuda()
    q_s = torch.randn(len(pos), hq, d, generator=g,
                      device="cuda").to(qdtype)
    tiles = tpa.query_tiles(seq_row, pos, hq // hkv)
    assert tiles[:, 1].max() == tpa.TILE_ROWS // (hq // hkv)
    out_s = tpa.paged_flash_decode(q_s, kp, vp, tables_s, lengths_s, ks, vs,
                                   q_tiles=tiles)
    ref_s = tpa.paged_flash_decode_plain(q_s.float(), kp, vp, tables_s,
                                         lengths_s, ks, vs)
    torch.testing.assert_close(out_s.float(), ref_s, atol=tol, rtol=tol)
    # the same tiles already on the card, as forward_paged passes them
    out_d = tpa.paged_flash_decode(q_s, kp, vp, tables_s, lengths_s, ks, vs,
                                   q_tiles=tiles.cuda())
    assert torch.equal(out_d, out_s)


def test_forward_paged_builds_tiles_without_changing_logits():
    """forward_paged(use_kernel=True) on host tensors builds the query
    tiles of its flat batch once and hands them, on the pool's device, to
    every layer's call; on CPU tensors the result is the plain path's,
    bit for bit."""
    from senweaver_ide_tpu_torch.models import (forward_paged, init_params,
                                                tiny_test)
    from senweaver_ide_tpu_torch.rollout import init_paged_pool
    cfg = tiny_test()
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu")
    bs, mb = 4, 8
    tables = torch.arange(3 * mb, dtype=torch.int32).view(3, mb)
    seq_row = torch.tensor([0, 1, 2, 2, 2, 2, 2, 2])
    positions = torch.tensor([5, 3, 0, 1, 2, 3, 4, 5])
    batch = dict(tables=tables, seq_row=seq_row, positions=positions,
                 write_block=tables[seq_row, positions // bs],
                 write_off=positions % bs)
    tokens = torch.tensor([7, 9, 1, 2, 3, 4, 5, 6])
    seen = []
    real = tpa.paged_flash_decode

    def spy(*a, q_tiles=None, **kw):
        seen.append(q_tiles)
        return real(*a, q_tiles=q_tiles, **kw)

    out = []
    for use_kernel in (True, False):
        pool = init_paged_pool(cfg, 3 * mb, bs, device="cpu")
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr("senweaver_ide_tpu_torch.models.transformer."
                       "paged_flash_decode", spy)
            out.append(forward_paged(params, cfg, tokens, pool=pool,
                                     use_kernel=use_kernel, **batch)[0])
    assert len(seen) == cfg.num_layers
    assert all(s.device.type == "cpu"
               and s.tolist() == [[0, 1], [1, 1], [2, 6]] for s in seen)
    np.testing.assert_array_equal(out[0].numpy(), out[1].numpy())
