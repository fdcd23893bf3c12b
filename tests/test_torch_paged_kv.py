"""The port's rollout/paged_kv.py against the JAX one: the same allocator
operation sequence leaves the same free list, refcounts and counters;
the kv_dtype ladder resolves (and refuses) alike; pool sizes and the COW
block copy agree."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from senweaver_ide_tpu import obs
from senweaver_ide_tpu.models.config import tiny_test as jax_tiny_test
from senweaver_ide_tpu.rollout import paged_kv as jax_pkv
from senweaver_ide_tpu_torch.models.config import tiny_test
from senweaver_ide_tpu_torch.models.load import params_from_numpy
from senweaver_ide_tpu_torch.rollout import paged_kv as t_pkv


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


@pytest.fixture(autouse=True)
def _fresh_obs():
    obs._reset_for_tests()
    yield
    obs._reset_for_tests()


def _script(alloc_cls, exhausted_cls):
    """One allocator history: alloc, fork, COW, exhaustion, release."""
    a = alloc_cls(6, 4)
    log = []
    t1 = a.alloc(3)
    g = a.fork(t1)
    log.append(("fork", g, [a.refcount(b) for b in range(6)]))
    fresh = a.cow_target(g[1])
    g[1] = fresh
    log.append(("cow", fresh, a.cow_target(fresh)))
    t2 = a.alloc(2)
    try:
        a.alloc(1)
    except exhausted_cls as e:
        log.append(("exhausted", e.requested, e.free, e.num_blocks))
    forks = a.fork_n(t2 + [6], 2)          # sentinel id kept, not counted
    log.append(("fork_n", forks, [a.refcount(b) for b in range(6)]))
    for tbl in [t1, g, t2] + forks:
        a.release(tbl)
    a.check_leaks()
    log.append(("end", a.counters(), a.free_blocks, a.blocks_for(9)))
    return log


def test_allocator_history_matches_jax():
    ported = _script(t_pkv.BlockAllocator, t_pkv.BlocksExhausted)
    ref = _script(jax_pkv.BlockAllocator, jax_pkv.BlocksExhausted)
    *head, (_, t_counters, t_free, t_need) = ported
    *ref_head, (_, j_counters, j_free, j_need) = ref
    assert head == ref_head
    assert (t_free, t_need) == (j_free, j_need)
    assert t_counters == {k: j_counters[k] for k in t_counters}


def test_allocator_refuses_misuse():
    a = t_pkv.BlockAllocator(2, 4)
    with pytest.raises(ValueError):
        a.retain([0])
    with pytest.raises(ValueError):
        a.release([1])
    b = a.alloc(1)
    a.release(b)
    with pytest.raises(ValueError):
        a.release(b)
    held = a.alloc(1)
    with pytest.raises(AssertionError, match="KV block leak"):
        a.check_leaks()
    a.release(held)


LADDERS = [("bf16", None), ("int8", None), ("fp8", None),
           ("bf16", ("bf16", "int8")), ("int8", ("bf16", "int8")),
           ("bf16", ("bf16", "bf16")), ("fp8", ("bf16", "int8")),
           ("int4", None), ("bf16", ("int8", "bf16")), ("bf16", ("bf16",))]


@pytest.mark.parametrize("kv_dtype,per_layer", LADDERS)
def test_kv_dtype_ladder_matches_jax(kv_dtype, per_layer):
    def run(fn):
        try:
            payload, n_hi = fn(2, kv_dtype, per_layer)
        except ValueError:
            return "refused"
        if isinstance(payload, torch.dtype):
            return str(payload).split(".")[-1], n_hi
        return (None if payload is None else np.dtype(payload).name), n_hi

    assert run(t_pkv.resolve_kv_dtypes) == run(jax_pkv.resolve_kv_dtypes)


@pytest.mark.parametrize("kv_dtype,per_layer", LADDERS[:4])
def test_pool_shapes_and_bytes_match_jax(kv_dtype, per_layer):
    jp = jax_pkv.init_paged_pool(jax_tiny_test(), 5, 4, kv_dtype, per_layer)
    tp = t_pkv.init_paged_pool(tiny_test(), 5, 4, kv_dtype, per_layer,
                               device="cpu")
    for j, t in zip(jp, tp):
        assert (j is None) == (t is None)
        if j is not None:
            assert tuple(t.shape) == j.shape
            assert t.element_size() == j.dtype.itemsize
    assert (t_pkv.pool_bytes_per_block(tp)
            == jax_pkv.pool_bytes_per_block(jp))
    assert (tp.quantized, tp.hi_layers, tp.num_layers, tp.num_blocks) == (
        jp.quantized, jp.hi_layers, jp.num_layers, jp.num_blocks)


def test_copy_blocks_matches_jax(rng):
    jp = jax_pkv.init_paged_pool(jax_tiny_test(), 5, 4, "bf16",
                                 ("bf16", "int8"))
    arrs = {}
    for name, a in jp._asdict().items():
        if a is None:
            continue
        if a.dtype == jnp.int8:
            arrs[name] = rng.integers(-127, 128, a.shape).astype(np.int8)
        else:
            arrs[name] = rng.standard_normal(a.shape).astype(np.float32)
    jp = jax_pkv.PagedKVPool(**{k: jnp.asarray(v) for k, v in arrs.items()})
    tp = t_pkv.PagedKVPool(**params_from_numpy(arrs, device="cpu"))
    jout = jax_pkv.copy_blocks(jp, jnp.asarray([0, 3]), jnp.asarray([4, 1]))
    tout = t_pkv.copy_blocks(tp, [0, 3], [4, 1])
    for name, t in tout._asdict().items():
        if t is not None:
            np.testing.assert_array_equal(
                t.numpy(), np.asarray(jax.device_get(getattr(jout, name))))
