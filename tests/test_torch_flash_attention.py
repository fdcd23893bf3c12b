"""The port's flash_attention against the JAX Pallas kernel (interpret
mode, as tests/test_flash_attention.py runs it on the CPU): forward
output and the gradients of q, k and v through ``jax.grad`` and torch
autograd, fp32, on the eight scenarios of the JAX tests (causal GQA,
non-causal, kv_mask, q_offset, kv_offset, sliding window, a fully masked
row, a sequence that is not a multiple of the tile). On CPU tensors the
port runs its plain versions; the CUDA kernels are held against those
plain versions on the card by the tests marked ``gpu``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from senweaver_ide_tpu.ops.flash_attention import flash_attention as jax_fa
from senweaver_ide_tpu_torch.ops import flash_attention as tfa
from senweaver_ide_tpu_torch.ops.attention import NEG_INF

# fp32 on both sides; the JAX kernel walks 32-wide blocks with an online
# softmax, the plain version takes one pass: they differ by summation
# order only (observed <= 3e-6 on gradients).
ATOL = RTOL = 2e-5

CASES = {
    "causal_gqa": dict(b=2, sq=40, skv=40, hq=4, hkv=2),
    "non_causal": dict(b=1, sq=32, skv=64, hq=2, hkv=2, causal=False),
    "kv_mask": dict(b=2, sq=40, skv=40, hq=4, hkv=2, mask="random"),
    "q_offset": dict(b=1, sq=16, skv=48, hq=4, hkv=2, q_offset=32),
    "kv_offset": dict(b=1, sq=48, skv=24, hq=4, hkv=2, kv_offset=24),
    "window": dict(b=2, sq=70, skv=70, hq=4, hkv=1, window=9),
    "fully_masked_row": dict(b=2, sq=40, skv=40, hq=4, hkv=2,
                             mask="row1_empty"),
    "ragged_seq": dict(b=2, sq=45, skv=45, hq=4, hkv=2),
}


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


def _inputs(rng, spec, d=16):
    b, sq, skv = spec["b"], spec["sq"], spec["skv"]
    q = rng.standard_normal((b, sq, spec["hq"], d)).astype(np.float32)
    k = rng.standard_normal((b, skv, spec["hkv"], d)).astype(np.float32)
    v = rng.standard_normal((b, skv, spec["hkv"], d)).astype(np.float32)
    g = rng.standard_normal((b, sq, spec["hq"], d)).astype(np.float32)
    mask = None
    if spec.get("mask") == "random":
        mask = rng.random((b, skv)) > 0.3
        mask[:, 0] = True
    elif spec.get("mask") == "row1_empty":
        mask = np.ones((b, skv), bool)
        mask[1] = False
    kw = {k: spec[k] for k in ("q_offset", "kv_offset", "causal", "window")
          if k in spec}
    return q, k, v, g, mask, kw


def _jax(q, k, v, g, mask, kw):
    kmask = None if mask is None else jnp.asarray(mask)

    def f(q, k, v):
        return jax_fa(q, k, v, kv_mask=kmask, block_q=32, block_kv=32,
                      interpret=True, **kw)

    qj, kj, vj = map(jnp.asarray, (q, k, v))
    out = f(qj, kj, vj)
    grads = jax.grad(lambda *a: jnp.sum(f(*a) * g), argnums=(0, 1, 2))(
        qj, kj, vj)
    return [np.asarray(out)] + [np.asarray(x) for x in grads]


def _torch(q, k, v, g, mask, kw):
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = tfa.flash_attention(
        tq, tk, tv, kv_mask=None if mask is None else torch.from_numpy(mask),
        **kw)
    (out * torch.from_numpy(g)).sum().backward()
    return [out.detach().numpy()] + [x.grad.numpy() for x in (tq, tk, tv)]


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_and_grads_match_jax_kernel(rng, case):
    args = _inputs(rng, CASES[case])
    want = _jax(*args)
    got = _torch(*args)
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=RTOL,
                                   err_msg=f"{case}: {name}")
    if case == "fully_masked_row":
        assert not np.any(got[0][1])
        assert not np.any(got[1][1])


def _np_lse(q, k, mask, kw):
    """Reference logsumexp in float64 numpy over the visible keys."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    kk = np.repeat(k.astype(np.float64), hq // hkv, axis=2)
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), kk) / np.sqrt(d)
    vis = np.ones((b, 1, sq, skv), bool)
    if kw.get("causal", True):
        qp = kw.get("q_offset", 0) + np.arange(sq)[:, None]
        kp = kw.get("kv_offset", 0) + np.arange(skv)[None, :]
        band = kp <= qp
        if kw.get("window") is not None:
            band &= kp > qp - kw["window"]
        vis &= band[None, None]
    if mask is not None:
        vis &= mask[:, None, None, :]
    s = np.where(vis, s, -np.inf)
    m = s.max(-1, keepdims=True)
    with np.errstate(invalid="ignore"):
        lse = (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]
    return np.where(vis.any(-1), lse, NEG_INF)


@pytest.mark.parametrize("case", sorted(CASES))
def test_lse_matches_numpy_logsumexp(rng, case):
    q, k, v, _, mask, kw = _inputs(rng, CASES[case])
    bias = tfa._bias_of(None if mask is None else torch.from_numpy(mask))
    out, lse = tfa.flash_attention_fwd(torch.from_numpy(q),
                                       torch.from_numpy(k),
                                       torch.from_numpy(v), bias, **kw)
    assert lse.dtype == torch.float32 and lse.shape == (
        q.shape[0], q.shape[2], q.shape[1])
    np.testing.assert_allclose(lse.numpy(), _np_lse(q, k, mask, kw),
                               atol=1e-5, rtol=1e-5)


def test_cpu_wrappers_take_the_plain_versions(rng):
    q, k, v, g, _, kw = _inputs(rng, CASES["window"])
    tq, tk, tv, tg = map(torch.from_numpy, (q, k, v, g))
    before = (tfa.flash_attention_fwd.launches,
              tfa.flash_attention_bwd_dkdv.launches,
              tfa.flash_attention_bwd_dq.launches)
    out, lse = tfa.flash_attention_fwd(tq, tk, tv, **kw)
    ref_out, ref_lse = tfa.flash_attention_fwd_plain(tq, tk, tv, **kw)
    assert torch.equal(out, ref_out) and torch.equal(lse, ref_lse)
    delta = tfa._delta(tg, out)
    dk, dv = tfa.flash_attention_bwd_dkdv(tq, tk, tv, None, tg, lse, delta,
                                          **kw)
    dq = tfa.flash_attention_bwd_dq(tq, tk, tv, None, tg, lse, delta, **kw)
    want = tfa.flash_attention_bwd_plain(tq, tk, tv, None, out, lse, tg,
                                         **kw)
    for a, b in zip((dq, dk, dv), want):
        assert torch.equal(a, b)
    # the counters count kernel launches only
    assert (tfa.flash_attention_fwd.launches,
            tfa.flash_attention_bwd_dkdv.launches,
            tfa.flash_attention_bwd_dq.launches) == before


def _valid(dtype=torch.bfloat16, d=128, hq=4, hkv=2):
    q = torch.zeros(2, 8, hq, d, dtype=dtype)
    k = torch.zeros(2, 8, hkv, d, dtype=dtype)
    return dict(q=q, k=k, v=k.clone(), bias=None, q_offset=0, kv_offset=0,
                causal=True, window=None)


@pytest.mark.parametrize("breakage,match", [
    ("f16", "dtype"),
    ("mixed", "one dtype"),
    ("head_dim", "head dim"),
    ("gqa", "multiple of Hkv"),
    ("strides", "contiguous head dim"),
    ("bias", "bias must be"),
    ("window", "sliding window"),
    ("offset", "Python int"),
])
def test_kernel_argument_checks_raise(breakage, match):
    """The wrappers' checks run before any launch and do not depend on
    the device, so they are exercised here on host tensors."""
    a = _valid(d=16 if breakage == "head_dim" else 128,
               hq=3 if breakage == "gqa" else 4)
    if breakage == "f16":
        a["q"], a["k"], a["v"] = (x.half() for x in (a["q"], a["k"],
                                                     a["v"]))
    elif breakage == "mixed":
        a["v"] = a["v"].float()
    elif breakage == "strides":
        a["q"] = torch.zeros(2, 8, 4, 256, dtype=torch.bfloat16)[..., ::2]
    elif breakage == "bias":
        a["bias"] = torch.zeros(2, 8, dtype=torch.bool)
    elif breakage == "window":
        a["causal"], a["window"] = False, 4
    elif breakage == "offset":
        a["q_offset"] = torch.tensor(3)
    tensors = {"q": a["q"], "k": a["k"], "v": a["v"]}
    with pytest.raises(ValueError, match=match):
        tfa._check(tensors, **a)


def test_non_cpu_tensors_never_take_the_plain_path():
    """Only a CPU tensor runs the plain version; any other device goes to
    the kernel path or raises."""
    a = _valid()
    q, k, v = (a[n].to("meta") for n in ("q", "k", "v"))
    with pytest.raises(ValueError, match="unsupported device"):
        tfa.flash_attention_fwd(q, k, v)
    with pytest.raises(ValueError, match="unsupported device"):
        tfa.flash_attention_bwd_dq(q, k, v, None, q, None, None)


def _cuda_case(dtype, b=2, s=300, hq=12, hkv=2, d=128, window=None,
               masked=False, seed=0, skv=None):
    g = torch.Generator(device="cuda").manual_seed(seed)
    skv = skv or s

    def rnd(n, h):
        return torch.randn(b, n, h, d, generator=g, device="cuda").to(dtype)
    q, k, v, gout = rnd(s, hq), rnd(skv, hkv), rnd(skv, hkv), rnd(s, hq)
    mask = None
    if masked:
        mask = torch.ones(b, skv, dtype=torch.bool, device="cuda")
        mask[1, skv // 2:] = False
    return q, k, v, gout, mask, dict(window=window)


# The tiled bf16 kernels' edge paths (64-row / 64-position tiles): S under
# one tile and one past a tile boundary, offsets with Skv != Sq, MHA (rep
# 1), D=64 with a window edge inside a tile, the non-causal masked-tile
# branch with a fully masked batch row.
CUDA_VARIANTS = {
    "causal": {}, "window": dict(window=37), "masked": dict(masked=True),
    "offsets": dict(q_offset=40, kv_offset=-25), "d64": dict(d=64),
    "s17": dict(s=17), "s65": dict(s=65), "s1025": dict(b=1, s=1025),
    "offsets_skv": dict(b=1, skv=333, q_offset=40, kv_offset=-25),
    "mha": dict(b=1, s=512, hq=16, hkv=16),
    "d64_window": dict(d=64, hq=14, window=37),
    "non_causal_masked": dict(s=200, causal=False, masked="row1_empty"),
}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("variant", list(CUDA_VARIANTS))
def test_cuda_kernels_match_plain(dtype, variant):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    spec = dict(CUDA_VARIANTS[variant])
    opts = {n: spec.pop(n) for n in ("q_offset", "kv_offset", "causal")
            if n in spec}
    empty_row = spec.get("masked") == "row1_empty"
    q, k, v, gout, mask, kw = _cuda_case(dtype, **spec)
    if empty_row:
        mask[1] = False
    kw.update(opts)
    launches = (tfa.flash_attention_fwd.launches,
                tfa.flash_attention_bwd_dkdv.launches,
                tfa.flash_attention_bwd_dq.launches)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = tfa.flash_attention(*leaves, kv_mask=mask, **kw)
    out.backward(gout)
    torch.cuda.synchronize()
    assert (tfa.flash_attention_fwd.launches,
            tfa.flash_attention_bwd_dkdv.launches,
            tfa.flash_attention_bwd_dq.launches) == tuple(
                n + 1 for n in launches)
    ref = [x.float().clone().requires_grad_() for x in (q, k, v)]
    bias = tfa._bias_of(mask)
    r_out, r_lse = tfa.flash_attention_fwd_plain(*ref, bias, **kw)
    r_grads = tfa.flash_attention_bwd_plain(*ref, bias, r_out, r_lse,
                                            gout.float(), **kw)
    for got, want in zip([out] + [x.grad for x in leaves],
                         [r_out] + list(r_grads)):
        _assert_kernel_close(got.float(), want, dtype)
    if dtype == torch.bfloat16:   # no atomics: a second run is identical
        again = [x.clone().requires_grad_() for x in (q, k, v)]
        out2 = tfa.flash_attention(*again, kv_mask=mask, **kw)
        out2.backward(gout)
        for a, b in zip([out] + [x.grad for x in leaves],
                        [out2] + [x.grad for x in again]):
            assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_dkdv_scratch_is_per_q_head_fp32(dtype):
    """The bf16 dK/dV kernel writes one fp32 partial per q head, (2, B,
    Skv, Hq, D), folded over each GQA group by its second pass; the f32
    kernel needs none. Shapes only: meta tensors allocate nothing."""
    q = torch.empty(3, 40, 12, 128, dtype=dtype, device="meta")
    k = torch.empty(3, 56, 2, 128, dtype=dtype, device="meta")
    scratch = tfa.dkdv_scratch(q, k)
    if dtype == torch.float32:
        assert scratch is None
    else:
        assert scratch.shape == (2, 3, 56, 12, 128)
        assert scratch.dtype == torch.float32 and scratch.device == q.device


def _assert_kernel_close(got, want, dtype):
    """f32: the CUDA-core kernels differ from the plain version by
    summation order only. bf16: the tensor-core kernels round their outputs
    to bf16 (2**-9 relative) and P and dS to bf16 before the second
    products, as SDPA does, so one gradient element can carry ~2**-8 of the
    largest terms that meet in it: the bound scales with the tensor's max,
    and the RMS error must stay within 1% of the RMS."""
    err = (got - want).abs()
    if dtype == torch.float32:
        bound = 1e-4 + 1e-4 * want.abs()
    else:
        bound = 1e-2 + 1e-2 * want.abs() + 5e-3 * want.abs().max()
        assert err.pow(2).mean().sqrt() <= 1e-2 * want.pow(2).mean().sqrt()
    assert bool((err <= bound).all()), float(err.max())


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["causal", "s17", "s65", "s1025",
                                     "offsets_skv", "d64_window", "masked",
                                     "non_causal_masked"])
def test_cuda_dq_alone_matches_plain(variant):
    """The bf16 dQ kernel fed the plain forward's lse and delta, so a fault
    in the forward cannot hide one in dQ; two launches bit-identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    spec = dict(CUDA_VARIANTS[variant])
    opts = {n: spec.pop(n) for n in ("q_offset", "kv_offset", "causal")
            if n in spec}
    empty_row = spec.get("masked") == "row1_empty"
    q, k, v, gout, mask, kw = _cuda_case(torch.bfloat16, **spec)
    if empty_row:
        mask[1] = False
    kw.update(opts)
    bias = tfa._bias_of(mask)
    qf, kf, vf, gf = (x.float() for x in (q, k, v, gout))
    r_out, r_lse = tfa.flash_attention_fwd_plain(qf, kf, vf, bias, **kw)
    delta = tfa._delta(gf, r_out)
    want = tfa._bwd_plain(qf, kf, vf, bias, gf, r_lse, delta, **kw)[0]
    before = tfa.flash_attention_bwd_dq.launches
    dq = tfa.flash_attention_bwd_dq(q, k, v, bias, gout, r_lse, delta, **kw)
    again = tfa.flash_attention_bwd_dq(q, k, v, bias, gout, r_lse, delta,
                                       **kw)
    torch.cuda.synchronize()
    assert tfa.flash_attention_bwd_dq.launches == before + 2
    _assert_kernel_close(dq.float(), want, torch.bfloat16)
    assert torch.equal(dq, again)


def test_kernel_names_are_the_sources_kernels():
    """KERNEL_NAMES (what the train profile attributes to each K2 wrapper)
    lists every kernel csrc/flash_attention.cu defines, each once."""
    import os
    import re
    src = open(os.path.join(os.path.dirname(tfa.__file__), os.pardir,
                            "csrc", "flash_attention.cu")).read()
    defined = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)"
                         r"\s+)?(\w+)\s*\(", src)
    named = [n for names in tfa.KERNEL_NAMES.values() for n in names]
    assert sorted(defined) == sorted(named)
