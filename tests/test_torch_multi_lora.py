"""The port's multi-tenant LoRA serving against the JAX package's, on the
same weights (fp32 ``tiny_test``, bridged through ``params_from_numpy``,
greedy, paged, 4-token blocks) and the same adapters (made from numpy
seeds, nonzero B so every delta really moves the logits).

Mirrors the engine-level tests of tests/test_multi_lora.py; its fleet
cases wait for the port's serving fleet. Each scenario runs a JAX and a
port engine, each with an ``AdapterPool``, step by step: emitted tokens
equal at every step, streams and log-probs equal, every stream equal to
an unbatched engine serving ``merge_lora(base, adapter)``, the shared
``stats()`` counters and ``adapter_stats()`` equal, both block pools
leak-free. Also: the pool's invariants on both packages, the submit
guards, ``forward_paged`` with mixed adapter ids against JAX's, and
tenant churn adding no fused-step signature.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from senweaver_ide_tpu import obs as jobs
from senweaver_ide_tpu.models.transformer import \
    forward_paged as jax_forward_paged
from senweaver_ide_tpu.models import init_params as jax_init_params
from senweaver_ide_tpu.models import tiny_test as jax_tiny_test
from senweaver_ide_tpu.rollout import AdapterPool as JaxPool
from senweaver_ide_tpu.rollout import AdapterPoolConfig as JaxPoolConfig
from senweaver_ide_tpu.rollout import AdapterPoolFull as JaxPoolFull
from senweaver_ide_tpu.rollout import EngineConfig as JaxEngineConfig
from senweaver_ide_tpu.rollout import RolloutEngine as JaxEngine
from senweaver_ide_tpu.rollout import StaleAdapterVersion as JaxStale
from senweaver_ide_tpu.rollout import init_paged_pool as jax_init_pool
from senweaver_ide_tpu.rollout.sampler import SampleParams as JaxSample
from senweaver_ide_tpu_torch import obs
from senweaver_ide_tpu_torch.models import (forward_paged, params_from_numpy,
                                            tiny_test)
from senweaver_ide_tpu_torch.obs.runtime_profile import get_profiler
from senweaver_ide_tpu_torch.rollout import (AdapterPool, AdapterPoolConfig,
                                             AdapterPoolFull, EngineConfig,
                                             RolloutEngine, SampleParams,
                                             StaleAdapterVersion,
                                             init_paged_pool)
from senweaver_ide_tpu_torch.training.lora import merge_lora

LOGP_ATOL = 1e-4
LOGITS_ATOL = 1e-4
PROMPTS = [[1, 2, 3, 4], [5, 6, 7], [8, 9, 10, 11, 12], [3, 1, 2]]


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
    jobs._reset_for_tests()
    yield
    obs._reset_for_tests()
    jobs._reset_for_tests()


@pytest.fixture(scope="module")
def models():
    jcfg = jax_tiny_test()
    jdc = dataclasses.replace(jcfg, num_layers=2, name="tiny-draft")
    jt = jax_init_params(jcfg, jax.random.PRNGKey(0))
    jd = jax_init_params(jdc, jax.random.PRNGKey(9))
    tcfg = tiny_test()
    return dict(jt=jt, jcfg=jcfg, jd=jd, jdc=jdc,
                tt=params_from_numpy(jax.device_get(jt), device="cpu"),
                tcfg=tcfg,
                td=params_from_numpy(jax.device_get(jd), device="cpu"),
                tdc=dataclasses.replace(tcfg, num_layers=2,
                                        name="tiny-draft"))


class Lora:
    """One adapter as numpy arrays, handed to each package in its own
    array type: A scaled like ``init_lora`` (alpha = 2r), B random."""

    def __init__(self, cfg, seed, rank, scale=0.05,
                 targets=("wq", "wk", "wv", "wo")):
        rng = np.random.default_rng(seed)
        dims = {"wq": (cfg.hidden_size, cfg.q_dim),
                "wk": (cfg.hidden_size, cfg.kv_dim),
                "wv": (cfg.hidden_size, cfg.kv_dim),
                "wo": (cfg.q_dim, cfg.hidden_size)}
        L = cfg.num_layers
        self.np = {}
        for t in targets:
            d_in, d_out = dims[t]
            self.np[t + "_lora_a"] = (rng.standard_normal((L, d_in, rank))
                                      * 2.0 / d_in ** 0.5).astype(np.float32)
            self.np[t + "_lora_b"] = (rng.standard_normal((L, rank, d_out))
                                      * scale).astype(np.float32)

    def jax(self):
        return {"layers": {k: jnp.asarray(v) for k, v in self.np.items()}}

    def port(self):
        return {"layers": {k: torch.from_numpy(v.copy())
                           for k, v in self.np.items()}}


def _engine_pair(m, *, pool_config=None, num_slots=4, max_len=96,
                 with_pool=True):
    j = JaxEngine(m["jt"], m["jcfg"], num_slots=num_slots, max_len=max_len,
                  sample=JaxSample(0.0, 0, 1.0),
                  adapter_pool=(JaxPool(m["jcfg"], JaxPoolConfig(
                      **dataclasses.asdict(pool_config or AdapterPoolConfig())
                  )) if with_pool else None),
                  engine_config=JaxEngineConfig(kv_layout="paged",
                                                block_size=4))
    t = RolloutEngine(m["tt"], m["tcfg"], num_slots=num_slots,
                      max_len=max_len, sample=SampleParams(0.0, 0, 1.0),
                      adapter_pool=(AdapterPool(m["tcfg"], pool_config,
                                                device="cpu")
                                    if with_pool else None),
                      engine_config=EngineConfig(block_size=4),
                      device="cpu")
    return j, t


class Pair:
    """A JAX and a port engine, each with an adapter pool; ``do(fn)``
    applies ``fn`` to both and requires the same return value."""

    def __init__(self, m, **kw):
        self.m = m
        self.j, self.t = _engine_pair(m, **kw)

    def publish(self, key, lora, **kw):
        return self.do2(lambda e: e.publish_adapter(key, lora.jax(), **kw),
                        lambda e: e.publish_adapter(key, lora.port(), **kw))

    def do(self, fn):
        return self.do2(fn, fn)

    def do2(self, fj, ft):
        a, b = fj(self.j), ft(self.t)
        assert a == b
        return b

    def steps(self, n=None):
        i = 0
        while (self.j.has_work or self.t.has_work) and (n is None or i < n):
            assert self.j.step() == self.t.step()
            i += 1

    def check(self, rids):
        for rid in rids:
            assert self.t.result(rid) == self.j.result(rid), rid
            np.testing.assert_allclose(self.t.result_logps(rid),
                                       self.j.result_logps(rid),
                                       atol=LOGP_ATOL)
        js, ts = self.j.stats(), self.t.stats()
        shared = sorted(set(js) & set(ts))
        assert {k: ts[k] for k in shared} == {k: js[k] for k in shared}
        assert {"adapters_published", "adapter_installs",
                "adapter_evictions"} <= set(shared)
        assert self.t.adapter_stats() == self.j.adapter_stats()
        for e in (self.j, self.t):
            e._alloc.check_leaks()
            e.spec_check_leaks()
        return ts


def ref_decode(m, prompt, lora, max_new=8):
    """Unbatched single-adapter reference on the port: a dedicated engine
    serving ``merge_lora(base, adapter)``, no pool."""
    p = merge_lora(m["tt"], lora.port()) if lora is not None else m["tt"]
    eng = RolloutEngine(p, m["tcfg"], num_slots=4, max_len=96,
                        sample=SampleParams(0.0, 0, 1.0),
                        engine_config=EngineConfig(block_size=4),
                        device="cpu")
    rid = eng.submit(prompt, max_new_tokens=max_new)
    return eng.run()[rid]


# ---- batched mixed-adapter parity -------------------------------------------

def test_batched_mixed_rank_parity(models):
    """One batch mixing a rank-4 adapter (padded to the 8 rung), a rank-16
    adapter, a base row and a second row of the first tenant."""
    cfg = models["tcfg"]
    l1, l2 = Lora(cfg, 1, rank=4), Lora(cfg, 2, rank=16)
    pair = Pair(models)
    assert pair.publish("t1", l1) == 1
    assert pair.publish("t2", l2) == 1
    rids = [pair.do(lambda e: e.submit(PROMPTS[0], max_new_tokens=8,
                                       adapter_id="t1")),
            pair.do(lambda e: e.submit(PROMPTS[1], max_new_tokens=8,
                                       adapter_id="t2")),
            pair.do(lambda e: e.submit(PROMPTS[2], max_new_tokens=8)),
            pair.do(lambda e: e.submit(PROMPTS[3], max_new_tokens=8,
                                       adapter_id="t1"))]
    pair.steps()
    batched = [pair.t.result(r) for r in rids]
    assert batched == [ref_decode(models, PROMPTS[0], l1),
                       ref_decode(models, PROMPTS[1], l2),
                       ref_decode(models, PROMPTS[2], None),
                       ref_decode(models, PROMPTS[3], l1)]
    # the adapters really diverged from the base: parity is not vacuous
    assert (batched[0] != ref_decode(models, PROMPTS[0], None)
            or batched[1] != ref_decode(models, PROMPTS[1], None))
    s = pair.check(rids)
    assert s["adapters_published"] == 2 and s["adapter_installs"] == 2


@pytest.mark.parametrize("rank", [8, 16])
def test_exact_at_every_ladder_rung(models, rank):
    """Exact at every rank of the ladder, an exact fit included (no
    padding columns)."""
    lora = Lora(models["tcfg"], 10 + rank, rank=rank)
    pair = Pair(models)
    pair.publish("t", lora)
    rids = [pair.do(lambda e, p=p: e.submit(p, max_new_tokens=8,
                                            adapter_id="t"))
            for p in PROMPTS]
    pair.steps()
    assert [pair.t.result(r) for r in rids] == [
        ref_decode(models, p, lora) for p in PROMPTS]
    pair.check(rids)


def test_base_rows_identical_to_pool_less_engine(models):
    """adapter_id=None rows on a pool engine take the null slot: their
    tokens equal a pool-less engine's, beside adapter rows in the batch."""
    pair = Pair(models)
    pair.publish("t1", Lora(models["tcfg"], 1, rank=4))
    base = [pair.do(lambda e, p=p: e.submit(p, max_new_tokens=8))
            for p in PROMPTS[:2]]
    other = pair.do(lambda e: e.submit(PROMPTS[2], max_new_tokens=8,
                                       adapter_id="t1"))
    pair.steps()
    assert [pair.t.result(r) for r in base] == [
        ref_decode(models, p, None) for p in PROMPTS[:2]]
    pair.check(base + [other])


# ---- the hot-swap contract --------------------------------------------------

def test_mid_decode_publish_lands_next_request_only(models):
    cfg = models["tcfg"]
    l_v1, l_v2 = Lora(cfg, 1, rank=4), Lora(cfg, 7, rank=4, scale=0.08)
    pair = Pair(models)
    pair.publish("t1", l_v1)
    rid = pair.do(lambda e: e.submit(PROMPTS[0], max_new_tokens=10,
                                     adapter_id="t1"))
    pair.steps()
    assert pair.t.adapter_stats()["adapters"]["t1"] == 1
    assert pair.publish("t1", l_v2) == 2
    rid2 = pair.do(lambda e: e.submit(PROMPTS[0], max_new_tokens=10,
                                      adapter_id="t1"))
    pair.steps()
    first, second = pair.t.result(rid), pair.t.result(rid2)
    assert first == ref_decode(models, PROMPTS[0], l_v1, max_new=10)
    assert second == ref_decode(models, PROMPTS[0], l_v2, max_new=10)
    assert first != second
    pair.check([rid, rid2])


def test_publish_during_flight_keeps_old_binding(models):
    """The publish lands while the request still holds its slot."""
    cfg = models["tcfg"]
    l_v1, l_v2 = Lora(cfg, 1, rank=4), Lora(cfg, 7, rank=4, scale=0.08)
    pair = Pair(models)
    pair.publish("t1", l_v1)
    rid = pair.do(lambda e: e.submit(PROMPTS[0], max_new_tokens=10,
                                     adapter_id="t1"))
    pair.steps(1)
    assert pair.t.result(rid)
    pair.publish("t1", l_v2)                 # mid-flight
    assert pair.t.adapter_stats()["version_skew"] == 1
    pair.steps()
    assert pair.t.result(rid) == ref_decode(models, PROMPTS[0], l_v1,
                                            max_new=10)
    # the stale slot freed at release; the pool reports only v2 now
    assert pair.t.adapter_pool.version("t1") == 2
    assert pair.check([rid])["adapter_installs"] == 1


def test_spec_verify_per_tenant_exact(models):
    """Speculation over a mixed-adapter batch: drafts stay base-only,
    verification runs under each row's adapter; streams equal
    non-speculative pool decoding on both sides."""
    cfg = models["tcfg"]
    l1, l2 = Lora(cfg, 1, rank=4), Lora(cfg, 2, rank=16)

    def run(depth):
        pair = Pair(models)
        if depth:
            pair.j.enable_speculation(models["jd"], models["jdc"],
                                      depth=depth)
            pair.t.enable_speculation(models["td"], models["tdc"],
                                      depth=depth)
        pair.publish("t1", l1)
        pair.publish("t2", l2)
        rids = [pair.do(lambda e: e.submit(PROMPTS[0], max_new_tokens=12,
                                           adapter_id="t1")),
                pair.do(lambda e: e.submit(PROMPTS[1], max_new_tokens=12,
                                           adapter_id="t2")),
                pair.do(lambda e: e.submit(PROMPTS[2], max_new_tokens=12))]
        pair.steps()
        pair.check(rids)
        if depth:
            s = pair.t.spec_stats()
            assert s["enabled"] and s["rounds"] > 0
            assert s == pair.j.spec_stats()
        return [pair.t.result(r) for r in rids]

    assert run(4) == run(0)


def test_tenant_churn_adds_no_fused_step_signature(models):
    """The port's form of test_tenant_churn_zero_compiles_after_warmup:
    churning through more tenants than the pool holds (evictions and
    re-uploads) adds no ``engine.fused_step`` signature after the warmup
    workload: the banks' shapes never change."""
    cfg = models["tcfg"]
    _, eng = _engine_pair(models, pool_config=AdapterPoolConfig(
        slots_per_rank=2))
    for i in range(6):
        eng.publish_adapter(f"t{i}", Lora(cfg, 20 + i,
                                          rank=4 if i % 2 else 16).port())

    def workload(tenants):
        for i, t in enumerate(tenants):
            eng.submit([(i * 5 + j) % 80 + 2 for j in range(3 + i)],
                       max_new_tokens=6, adapter_id=t)
        eng.run()

    workload(["t0", "t1", "t2", "t3"])
    before = get_profiler().ledger()["engine.fused_step"]
    assert before["calls"] > 0
    keys = {s["key"] for s in before["signatures"]}
    workload(["t4", "t5", "t0", "t1"])
    workload(["t2", "t3", "t4", "t5"])
    after = get_profiler().ledger()["engine.fused_step"]
    assert after["calls"] > before["calls"]
    assert {s["key"] for s in after["signatures"]} == keys
    assert after["compiles"] == before["compiles"]
    assert after["storms"] == 0
    assert eng.adapter_pool.stats()["evictions"] > 0
    eng._alloc.check_leaks()


# ---- forward_paged with adapters ----------------------------------------------

def test_forward_paged_mixed_adapter_ids_matches_jax(models):
    """One flat batch with base entries, rank-8 and rank-16 entries (two
    tenants in the 16 rung) over a prefilled pool: logits within
    LOGITS_ATOL of JAX's ``forward_paged``, the pool writes equal, and
    the base entries' logits EXACTLY those of a forward without
    adapters."""
    jcfg, tcfg = models["jcfg"], models["tcfg"]
    jpc = JaxPoolConfig()
    jpool, tpool = JaxPool(jcfg, jpc), AdapterPool(tcfg, device="cpu")
    ids = {}
    for key, seed, rank in (("a", 3, 8), ("b", 4, 16), ("c", 5, 12)):
        lora = Lora(tcfg, seed, rank=rank)
        jpool.publish(key, lora.jax())
        tpool.publish(key, lora.port())
        jb, tb = jpool.acquire(key), tpool.acquire(key)
        assert dataclasses.astuple(jb) == dataclasses.astuple(tb)
        ids[key] = tb.slot_ids
    rng = np.random.default_rng(0)
    bs, nb = 4, 16
    tables = np.array([[1, 2, 3, 0], [4, 5, 0, 0], [6, 7, 8, 9]], np.int32)
    # entries: row, position, tenant (None = base)
    entries = [(0, 9, "a"), (1, 5, None), (2, 13, "b"), (2, 14, "b"),
               (0, 10, "c"), (1, 6, "a"), (2, 15, None)]
    toks = rng.integers(1, tcfg.vocab_size, len(entries)).astype(np.int32)
    rows = np.array([e[0] for e in entries], np.int32)
    pos = np.array([e[1] for e in entries], np.int32)
    wb = tables[rows, pos // bs].astype(np.int32)
    wo = (pos % bs).astype(np.int32)
    aid = [np.array([ids[e[2]][j] if e[2] else 0 for e in entries],
                    np.int32) for j in range(2)]
    kv = rng.standard_normal(
        (2, tcfg.num_layers, nb, bs, tcfg.num_kv_heads,
         tcfg.head_dim)).astype(np.float32)

    jpool_kv = jax_init_pool(jcfg, nb, bs)._replace(
        k=jnp.asarray(kv[0]), v=jnp.asarray(kv[1]))
    jl, jout = jax_forward_paged(
        models["jt"], jcfg, jnp.asarray(toks), pool=jpool_kv,
        tables=jnp.asarray(tables), seq_row=jnp.asarray(rows),
        positions=jnp.asarray(pos), write_block=jnp.asarray(wb),
        write_off=jnp.asarray(wo), adapters=jpool.banks(),
        adapter_ids=tuple(jnp.asarray(a) for a in aid))

    def port(adapters, adapter_ids):
        pool = init_paged_pool(tcfg, nb, bs, device="cpu")
        pool.k.copy_(torch.from_numpy(kv[0]))
        pool.v.copy_(torch.from_numpy(kv[1]))
        as_t = lambda a: torch.from_numpy(a.astype(np.int64))  # noqa: E731
        logits, pool = forward_paged(
            models["tt"], tcfg, as_t(toks), pool=pool,
            tables=torch.from_numpy(tables), seq_row=as_t(rows),
            positions=as_t(pos), write_block=as_t(wb), write_off=as_t(wo),
            adapters=adapters, adapter_ids=adapter_ids)
        return logits, pool

    tl, tout = port(tpool.banks(), tuple(torch.from_numpy(a) for a in aid))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                               atol=LOGITS_ATOL, rtol=LOGITS_ATOL)
    np.testing.assert_allclose(tout.k.numpy(), np.asarray(jout.k),
                               atol=1e-5, rtol=1e-5)
    base_l, _ = port(None, None)
    base = [i for i, e in enumerate(entries) if e[2] is None]
    # a base entry's logits depend only on its own row's KV, which the
    # adapter rows of OTHER rows do not write: exactly the no-adapter
    # forward's (row 2's base entry reads row 2's adapter writes, so
    # only row 1's is exact)
    assert torch.equal(tl[base[0]], base_l[base[0]])
    assert not torch.allclose(tl[0], base_l[0])
    # all-null ids: exactly the forward without adapters
    zl, _ = port(tpool.banks(), tuple(torch.zeros(len(entries),
                                                  dtype=torch.int64)
                                      for _ in range(2)))
    assert torch.equal(zl, base_l)


# ---- pool invariants, on both packages ----------------------------------------

def _pool_eviction_lru_and_full(pool, lora, Full, Stale):
    for i in range(3):
        pool.publish(f"t{i}", lora(30 + i, 8))
    b0 = pool.acquire("t0")
    b1 = pool.acquire("t1")
    with pytest.raises(Full):
        pool.acquire("t2")                   # both slots pinned
    pool.release(b0)
    b2 = pool.acquire("t2")                  # evicts t0 (LRU, refs 0)
    assert not pool.resident("t0")
    assert pool.resident("t1") and pool.resident("t2")
    assert pool.stats()["evictions"] == 1
    pool.release(b1)
    pool.release(b2)
    b0b = pool.acquire("t0")                 # a cold tenant re-uploads
    assert pool.resident("t0")
    pool.release(b0b)
    return [dataclasses.astuple(b) for b in (b0, b1, b2, b0b)]


def _pool_version_fencing(pool, lora, Full, Stale):
    one = lora(40, 8)
    out = [pool.publish("t", one), pool.publish("t", one, version=5)]
    with pytest.raises(Stale):
        pool.publish("t", one, version=5)    # not monotonic
    with pytest.raises(KeyError):
        pool.acquire("unknown")
    return out


def _pool_rejects_oversized_and_malformed(pool, lora, Full, Stale):
    with pytest.raises(ValueError):
        pool.publish("t", lora(41, 16))      # above the ladder's top
    with pytest.raises(ValueError):
        pool.publish("t", {"layers": {}})
    return pool.has("t")


def _pool_version_skew_stat(pool, lora, Full, Stale):
    pool.publish("t", lora(42, 8))
    b = pool.acquire("t")
    pool.publish("t", lora(43, 8))
    skew = pool.stats()["version_skew"]
    pool.release(b)
    return skew, pool.stats()["version_skew"]


POOL_CASES = {
    "eviction_lru_and_full": (_pool_eviction_lru_and_full,
                              dict(slots_per_rank=2)),
    "version_fencing": (_pool_version_fencing, {}),
    "rejects_oversized_and_malformed": (
        _pool_rejects_oversized_and_malformed, dict(rank_ladder=(8,))),
    "version_skew_stat": (_pool_version_skew_stat, {}),
}


@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_pool_invariants(models, case):
    fn, kw = POOL_CASES[case]
    cfg = models["tcfg"]
    jout = fn(JaxPool(models["jcfg"], JaxPoolConfig(**kw)),
              lambda seed, r: Lora(cfg, seed, r).jax(), JaxPoolFull,
              JaxStale)
    tpool = AdapterPool(cfg, AdapterPoolConfig(**kw), device="cpu")
    tout = fn(tpool, lambda seed, r: Lora(cfg, seed, r).port(),
              AdapterPoolFull, StaleAdapterVersion)
    assert tout == jout
    if case == "version_skew_stat":
        assert tout == (1, 0)
    # the port's banks hold each resident tenant's padded host copy
    for j, rung in enumerate(tpool.stats()["rungs"]):
        for occ in rung["occupants"]:
            _v, _r, host = tpool._host[occ["key"]]
            if occ["version"] == _v:
                for name, arr in host.items():
                    assert np.array_equal(
                        tpool.banks()[j][name][:, occ["slot"]].numpy(), arr)


def test_pool_metrics_and_refusals(models):
    """The senweaver_serve_adapter_* series under JAX's names; a card-less
    pool refuses like every entry point; targets outside the ladder and
    mixed ranks are refused."""
    cfg = models["tcfg"]
    JaxPool(models["jcfg"])
    jnames = {n for n in jobs.get_registry().snapshot()
              if "adapter" in n}
    pool = AdapterPool(cfg, device="cpu")
    tnames = {n for n in obs.get_registry().snapshot() if "adapter" in n}
    assert tnames == jnames and len(tnames) == 7
    pool.publish("t", Lora(cfg, 1, 8).port())
    pool.note_gather_overhead(1.25)
    assert obs.get_registry().get(
        "senweaver_serve_adapter_gather_overhead_ratio").value() == 1.25
    with pytest.raises(ValueError, match="not in pool targets"):
        AdapterPool(cfg, AdapterPoolConfig(targets=("wq",)),
                    device="cpu").publish("t", Lora(cfg, 1, 8).port())
    mixed = Lora(cfg, 2, 8).port()
    mixed["layers"]["wk_lora_a"] = mixed["layers"]["wk_lora_a"][..., :4]
    with pytest.raises(ValueError, match="mixed adapter ranks"):
        pool.publish("m", mixed)
    with pytest.raises(ValueError, match="strictly increasing"):
        AdapterPoolConfig(rank_ladder=(16, 8))
    assert pool.bank_bytes() == sum(
        a.numel() * 4 for bank in pool.banks() for a in bank.values())


def test_submit_guards(models):
    j, t = _engine_pair(models, with_pool=False)
    for e in (j, t):
        with pytest.raises(ValueError):
            e.submit([1, 2, 3], max_new_tokens=4, adapter_id="t")
        with pytest.raises(RuntimeError):
            e.publish_adapter("t", {"layers": {}})
        assert e.adapter_stats() == {} and not e.has_adapter("t")
    pair = Pair(models)
    for e in (pair.j, pair.t):
        with pytest.raises(KeyError):
            e.submit([1, 2, 3], max_new_tokens=4, adapter_id="nope")
        held = e.submit([1, 2, 3], max_new_tokens=2, hold_slot=True)
        e.run()
        with pytest.raises(ValueError, match="continuations inherit"):
            e.submit([1, 2, 3, 4, 5], continue_from=held, adapter_id="t")
        e.release_slot(held)
    pair.publish("t1", Lora(models["tcfg"], 1, rank=4))
    assert pair.do(lambda e: (e.has_adapter("t1"),
                              e.adapter_resident("t1"))) == (True, False)
    with pytest.raises(ValueError, match="paged KV layout"):
        RolloutEngine(models["tt"], models["tcfg"],
                      adapter_pool=AdapterPool(models["tcfg"], device="cpu"),
                      engine_config=EngineConfig(kv_layout="slots"),
                      device="cpu")


def test_adapter_binding_follows_holds_prefixes_and_preemption(models):
    """A held-slot continuation inherits its turn's binding; a prefix is
    skipped under an adapter (base-policy KV) and counted a miss; every
    slot's refs drop back to 0 at the end."""
    cfg = models["tcfg"]
    lora = Lora(cfg, 3, rank=8)
    pair = Pair(models, num_slots=2)
    pair.publish("t1", lora)
    pid = pair.do(lambda e: e.register_prefix([7] * 8))
    a = pair.do(lambda e: e.submit([7] * 8 + [3], max_new_tokens=4,
                                   prefix_id=pid, adapter_id="t1"))
    h = pair.do(lambda e: e.submit(PROMPTS[0], max_new_tokens=3,
                                   hold_slot=True, adapter_id="t1"))
    pair.steps()
    hist = pair.t._requests[h].held_history
    c = pair.do(lambda e: e.submit(hist + [pair.t.result(h)[-1], 9],
                                   max_new_tokens=4, continue_from=h))
    assert pair.t._requests[c].adapter_binding is not None
    pair.steps()
    pair.do(lambda e: e.release_prefix(pid))
    s = pair.check([a, h, c])
    assert s["prefix_cache_misses"] == 1 and s["prefix_installs"] == 0
    assert pair.t.result(a) == ref_decode(models, [7] * 8 + [3], lora,
                                          max_new=4)
    occ = [o for r in pair.t.adapter_stats()["rungs"]
           for o in r["occupants"]]
    assert occ and all(o["refs"] == 0 for o in occ)
