"""The port's flash_decode against the JAX package's (Pallas kernel in
interpret mode) on the same numpy inputs: per-slot lengths, GQA shapes,
a scalar length, the block-alignment contract, a short slot in a long
pool, bf16 I/O, the Sq=1 contract and the 3-D round trip. On the CPU the
port runs its plain version; the CUDA kernel is held against that plain
version on the card by the tests marked ``gpu``. The bf16 kernel's split
design is checked here through its host plan and a numpy model of its
two passes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from senweaver_ide_tpu.ops.flash_decode import flash_decode as jax_fd
from senweaver_ide_tpu_torch.ops import flash_decode as fdm
from senweaver_ide_tpu_torch.ops.flash_decode import (flash_decode,
                                                      flash_decode_plain)

ATOL = 2e-5          # the JAX tests' kernel-vs-reference tolerance
BF16_ATOL = 3e-2     # bf16 I/O, fp32 accumulation on both sides


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


# -- the split design: the host plan and the merge --------------------------

PLAN_SHAPES = [(b, hkv, smax) for b in (1, 16, 64) for hkv in (1, 2, 8)
               for smax in (1, 64, 65, 1111, 4096, 32768)]


@pytest.mark.parametrize("b,hkv,smax", PLAN_SHAPES)
def test_split_plan_covers_every_position_once(b, hkv, smax):
    """Chunks [s * chunk, (s + 1) * chunk) for s < splits partition [0,
    Smax): tile-aligned, none empty at full length, and enough blocks to
    cover the SMs where the cache has the tiles for it."""
    splits, chunk = fdm.split_plan(b, hkv, smax)
    assert chunk > 0 and chunk % fdm.FD_TILE == 0
    assert splits >= 1 and (splits - 1) * chunk < smax <= splits * chunk
    covered = np.zeros(smax, np.int64)
    for s in range(splits):
        covered[s * chunk:min((s + 1) * chunk, smax)] += 1
    assert (covered == 1).all()
    target = fdm.BLOCKS_PER_SM * fdm.H100_SMS
    tiles = -(-smax // fdm.FD_TILE)
    assert 2 * b * hkv * splits >= min(target, b * hkv * tiles)


def test_split_plan_depends_on_shapes_only():
    """The plan takes no lengths (they stay on the device: no host sync a
    token), and the serving shapes get the plans the kernel was tuned at:
    16 Mistral-7B slots (Hkv 8) in 5 chunks of 832, 16 Qwen2.5-Coder-1.5B
    slots (Hkv 2) in 16 chunks of 256, a B=1 slot view in 64 of 64."""
    import inspect
    assert list(inspect.signature(fdm.split_plan).parameters) == [
        "b", "hkv", "smax", "sms"]
    assert fdm.split_plan(16, 8, 4096) == (5, 832)
    assert fdm.split_plan(16, 2, 4096) == (16, 256)
    assert fdm.split_plan(1, 8, 4096) == (64, 64)
    assert fdm.split_plan(16, 8, 4096) == fdm.split_plan(16, 8, 4096)


def _partial(qg, k, v):
    """(m, l, acc) of the rows qg (Hkv, rep, D), pre-scaled, over the
    positions of k/v (P, Hkv, D); None for no position."""
    if k.shape[0] == 0:
        return None
    s = np.einsum("grd,pgd->grp", qg, k)
    m = s.max(-1)
    e = np.exp(s - m[..., None])
    return m, e.sum(-1), np.einsum("grp,pgd->grd", e, v)


def _merge(parts):
    """Fixed-order merge of partials; an empty one weighs 0."""
    parts = [p for p in parts if p is not None and (p[1] > 0).all()]
    if not parts:
        return None
    big = np.max([p[0] for p in parts], axis=0)
    f = [np.exp(p[0] - big) for p in parts]
    return (big, sum(p[1] * w for p, w in zip(parts, f)),
            sum(p[2] * w[..., None] for p, w in zip(parts, f)))


def _split_merge_np(q, k, v, lengths, splits, chunk, warps=4):
    """The kernel's arithmetic order in numpy: per split block, each warp's
    state over its 16 positions of every 64-position tile, merged in warp
    order; then the slot's live splits merged in split order."""
    b, hq, d = q.shape
    smax, hkv = k.shape[1], k.shape[2]
    out = np.zeros((b, hq, d))
    span = fdm.FD_TILE // warps
    for i in range(b):
        n = min(max(int(lengths[i]), 0), smax)
        qg = q[i].astype(np.float64).reshape(hkv, hq // hkv, d) / np.sqrt(d)
        blocks = []
        for s in range(splits):
            c0, c1 = s * chunk, min((s + 1) * chunk, n)
            if c0 >= n:
                continue               # the block exits at once
            pos = np.arange(c0, c1)
            lane = (pos - c0) % fdm.FD_TILE // span
            blocks.append(_merge([_partial(qg, k[i, pos[lane == w]],
                                           v[i, pos[lane == w]])
                                  for w in range(warps)]))
        merged = _merge(blocks)
        if merged is not None:
            out[i] = (merged[2] / merged[1][..., None]).reshape(hq, d)
    return out


@pytest.mark.parametrize("hq,hkv,d,smax", [(32, 8, 128, 640),
                                           (12, 2, 128, 1000),
                                           (14, 2, 64, 256)])
def test_split_and_merge_model_matches_plain(rng, hq, hkv, d, smax):
    """The split design's two passes, modelled in numpy, give what the
    plain version gives: lengths at tile and chunk edges, empty splits
    (short lengths in a long row) and a slot of length 0 (exactly 0)."""
    b = 10
    splits, chunk = fdm.split_plan(b, hkv, smax)
    assert splits > 1
    lens = np.array([0, 1, 63, 64, 65, chunk - 1, chunk, chunk + 1,
                     smax - 1, smax], np.int32)
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, smax, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, smax, hkv, d)).astype(np.float32)
    got = _split_merge_np(q, k, v, lens, splits, chunk)
    want = flash_decode_plain(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), torch.from_numpy(lens))
    assert not got[0].any()
    np.testing.assert_allclose(got, want.numpy(), atol=ATOL, rtol=ATOL)


def test_kernel_names_are_the_sources_kernels():
    """KERNEL_NAMES (what the profile scripts attribute to K3) lists every
    kernel csrc/flash_decode.cu defines, and nothing else."""
    import os
    import re
    src = open(os.path.join(os.path.dirname(fdm.__file__), os.pardir,
                            "csrc", "flash_decode.cu")).read()
    defined = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)"
                         r"\s+)?(\w+)\s*\(", src)
    assert sorted(defined) == sorted(fdm.KERNEL_NAMES)


def _card_batch(hq, hkv, d, smax, lens, strided=False, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    b, rows = len(lens), smax + 64 if strided else smax
    q = torch.randn(b, hq, d, generator=g, device="cuda").bfloat16()
    k, v = (torch.randn(b, rows, hkv, d, generator=g,
                        device="cuda").bfloat16()[:, :smax]
            for _ in range(2))
    return q, k, v, lengths


def _assert_card_close(q, k, v, lengths):
    """bf16 kernel vs plain within 1e-2 + 1e-2 * |plain|, zeros for length
    0, a second launch and NaN past every length bit-identical."""
    kw = {"allow_pad_copy": True}
    out = flash_decode(q, k, v, lengths, **kw)
    again = flash_decode(q, k, v, lengths, **kw)
    kp, vp = k.clone(), v.clone()
    for i, n in enumerate(lengths.tolist()):
        kp[i, n:] = float("nan")
        vp[i, n:] = float("nan")
    poisoned = flash_decode(q, kp, vp, lengths, **kw)
    torch.cuda.synchronize()
    ref = flash_decode_plain(q.float(), k.float(), v.float(), lengths)
    assert bool(((out.float() - ref).abs() <= 1e-2 + 1e-2 * ref.abs()).all())
    assert not out[lengths == 0].any()
    assert torch.equal(out, again) and torch.equal(out, poisoned)


@pytest.mark.gpu
@pytest.mark.parametrize("heads,smax,strided", [
    ((32, 8, 128), 4096, False), ((12, 2, 128), 3000, True),
    ((14, 2, 64), 1024, False)])
def test_split_edges_on_card(heads, smax, strided):
    """Lengths 1, chunk - 1, chunk, chunk + 1 and Smax of the batch's own
    plan, tile edges and a length-0 slot, on aligned and strided caches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    hq, hkv, d = heads
    _, chunk = fdm.split_plan(10, hkv, smax, fdm._sm_count(
        torch.device("cuda", 0)))
    lens = [0, 1, 63, 64, 65, chunk - 1, chunk, chunk + 1, smax - 1, smax]
    _assert_card_close(*_card_batch(hq, hkv, d, smax, lens, strided))


@pytest.mark.gpu
@pytest.mark.parametrize("lens", [[4096], [129, 4095]])
def test_short_grid_many_splits_on_card(lens):
    """Heads 12/2 at B=1 and B=2: B * Hkv is 2 or 4, so the plan runs
    many splits per slot."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    _assert_card_close(*_card_batch(12, 2, 128, 4096, lens,
                                    strided=len(lens) == 2))
