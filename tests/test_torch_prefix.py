"""The port's engine reuse paths against the JAX engine on the same
weights (fp32 tiny-test config, greedy): shared prefixes (graft and
copy-on-write on the paged layout, slot installs on slots, LRU,
invalidation by weight sync), export/import between engines on bf16 and
int8 pools, the host-RAM tier (swap out, restore, torn swap), and
held-slot continuations. Every scenario runs on both engines: token
streams and behaviour log-probs must match, the shared ``stats()``
counters (``kv_cow_copies``, ``kv_grafts``, ``kv_install_copies``,
``kv_swap_*`` included) must be equal, and the block pool must drain
clean (``check_leaks``). Mirrors tests/test_engine.py's prefix and
continuation tests, tests/test_paged_kv.py's graft tests and
tests/test_kv_pressure.py."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from senweaver_ide_tpu import obs
from senweaver_ide_tpu.models import init_params as jax_init_params
from senweaver_ide_tpu.models import tiny_test as jax_tiny_test
from senweaver_ide_tpu.rollout import EngineConfig as JaxEngineConfig
from senweaver_ide_tpu.rollout import RolloutEngine as JaxEngine
from senweaver_ide_tpu.rollout.sampler import SampleParams as JaxSample
from senweaver_ide_tpu_torch import obs as tobs
from senweaver_ide_tpu_torch.models import params_from_numpy, tiny_test
from senweaver_ide_tpu_torch.rollout import (EngineConfig,
                                             PrefixImportError,
                                             RolloutEngine, SampleParams)
from senweaver_ide_tpu_torch.rollout import paged_kv as tpk

LOGP_ATOL = 1e-4
HOT = [5, 9, 2, 7, 4, 4, 8, 1]       # 8 tokens = 2 full blocks @ bs 4
COLD = [11, 3, 8, 1, 2, 6, 9, 5]


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
    tobs._reset_for_tests()
    yield
    obs._reset_for_tests()
    tobs._reset_for_tests()


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_tiny_test()
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.device_get(jparams), device="cpu")
    return jparams, jcfg, tparams, tiny_test()


class Pair:
    """A JAX and a port engine on the same weights; ``do(fn)`` applies
    ``fn`` to both and requires the same return value."""

    def __init__(self, weights, *, num_slots=2, max_len=64, eos_id=None,
                 cfg=None, params=None, **kw):
        jparams, jcfg, tparams, tcfg = weights
        if params is not None:
            jparams, tparams = params
        if cfg:
            jcfg = dataclasses.replace(jcfg, **cfg)
            tcfg = dataclasses.replace(tcfg, **cfg)
        ec = kw.pop("engine_config", {})
        self.j = JaxEngine(jparams, jcfg, num_slots=num_slots,
                           max_len=max_len, sample=JaxSample(0.0, 0, 1.0),
                           eos_id=eos_id, engine_config=JaxEngineConfig(**ec),
                           **kw)
        self.t = RolloutEngine(tparams, tcfg, num_slots=num_slots,
                               max_len=max_len,
                               sample=SampleParams(0.0, 0, 1.0),
                               eos_id=eos_id,
                               engine_config=EngineConfig(**ec),
                               device="cpu", **kw)

    def do(self, fn):
        a, b = fn(self.j), fn(self.t)
        assert a == b
        return b

    def steps(self):
        """Step both to completion, emitted dicts equal step by step."""
        while self.j.has_work or self.t.has_work:
            assert self.j.step() == self.t.step()

    def check(self, rids, leaks=True):
        for rid in rids:
            assert self.t.result(rid) == self.j.result(rid), rid
            np.testing.assert_allclose(self.t.result_logps(rid),
                                       self.j.result_logps(rid),
                                       atol=LOGP_ATOL)
        js, ts = self.j.stats(), self.t.stats()
        shared = sorted(set(js) & set(ts))
        assert {k: ts[k] for k in shared} == {k: js[k] for k in shared}
        if leaks and self.t.kv_layout == "paged":
            self.t._alloc.check_leaks()
            self.j._alloc.check_leaks()
        return ts


def _rand(rng, n):
    return [int(x) for x in rng.integers(1, 400, n)]


LAYOUTS = [{"kv_layout": "paged", "block_size": 4},
           {"kv_layout": "paged", "block_size": 16},
           {"kv_layout": "slots"}]


@pytest.mark.parametrize("ec", LAYOUTS)
def test_prefix_matches_plain_prefill(weights, rng, ec):
    prefix, suffix = _rand(rng, 9), _rand(rng, 5)
    pair = Pair(weights, engine_config=ec)
    pid = pair.do(lambda e: e.register_prefix(prefix))
    r1 = pair.do(lambda e: e.submit(prefix + suffix, max_new_tokens=8,
                                    prefix_id=pid))
    pair.steps()
    # empty suffix: decode straight from the stored prefix logits
    r2 = pair.do(lambda e: e.submit(list(prefix), max_new_tokens=6,
                                    prefix_id=pid))
    pair.steps()
    pair.do(lambda e: e.release_prefix(pid))
    st = pair.check([r1, r2])
    assert st["prefix_installs"] == 2 and st["prefix_prefills"] == 1
    # and the same tokens as a plain prefill on the port
    plain = Pair(weights, engine_config=ec).t
    p1 = plain.submit(prefix + suffix, max_new_tokens=8)
    p2 = plain.submit(list(prefix), max_new_tokens=6)
    out = plain.run()
    assert (out[p1], out[p2]) == (pair.t.result(r1), pair.t.result(r2))
    if ec["kv_layout"] == "paged":
        # a 9-token prefix shares its partial boundary block: each
        # consumer copies it at its first write
        assert st["kv_grafts"] == 2 and st["kv_cow_copies"] == 2


@pytest.mark.parametrize("ec", LAYOUTS[::2])
def test_prefix_reused_across_slots(weights, rng, ec):
    prefix = _rand(rng, 7)
    pair = Pair(weights, engine_config=ec)
    pid = pair.do(lambda e: e.register_prefix(prefix))
    sufs = [_rand(rng, 4) for _ in range(3)]
    rids = [pair.do(lambda e, s=s: e.submit(prefix + s, max_new_tokens=6,
                                            prefix_id=pid)) for s in sufs]
    pair.steps()
    pair.do(lambda e: e.release_prefix(pid))
    assert pair.check(rids)["prefix_cache_hits"] == 3


def test_prefix_validation(weights):
    pair = Pair(weights)
    eng = pair.t
    pid = eng.register_prefix([5, 6, 7])
    with pytest.raises(ValueError, match="does not start with"):
        eng.submit([9, 9, 9, 9], max_new_tokens=4, prefix_id=pid)
    with pytest.raises(KeyError):
        eng.submit([5, 6, 7, 8], max_new_tokens=4, prefix_id=999)
    with pytest.raises(ValueError, match="empty prefix"):
        eng.register_prefix([])
    with pytest.raises(ValueError, match="pool capacity"):
        eng.register_prefix(list(range(1, 65)))


def test_prefix_and_continuation_on_ring_pool(weights, rng):
    """A sliding-window config falls back to the ring slot cache: the
    prefix install and a continuation's delta both wrap the ring."""
    prefix, suffix = _rand(rng, 5), _rand(rng, 6)
    pair = Pair(weights, cfg={"sliding_window": 8})
    assert pair.t.kv_layout == "slots"
    pid = pair.do(lambda e: e.register_prefix(prefix))
    r1 = pair.do(lambda e: e.submit(prefix + suffix, max_new_tokens=6,
                                    prefix_id=pid, hold_slot=True))
    pair.steps()
    full2 = prefix + suffix + pair.t.result(r1) + _rand(rng, 6)
    r2 = pair.do(lambda e: e.submit(full2, max_new_tokens=4,
                                    continue_from=r1))
    pair.steps()
    pair.check([r1, r2])


def test_prefix_and_continuation_on_int8_slot_cache(weights, rng):
    """kv_quant (int8 slot cache, K3's layout on the card): the prefix's
    int8 one-slot cache installs into a slot, a continuation appends."""
    prefix = _rand(rng, 11)
    pair = Pair(weights, cfg={"kv_quant": True})
    assert pair.t.kv_layout == "slots" and pair.t.cache.quantized
    pid = pair.do(lambda e: e.register_prefix(prefix))
    r1 = pair.do(lambda e: e.submit(prefix + [3, 4], max_new_tokens=5,
                                    prefix_id=pid, hold_slot=True))
    r2 = pair.do(lambda e: e.submit(prefix + [8], max_new_tokens=5,
                                    prefix_id=pid))
    pair.steps()
    full = prefix + [3, 4] + pair.t.result(r1) + [9, 9]
    r3 = pair.do(lambda e: e.submit(full, max_new_tokens=4,
                                    continue_from=r1))
    pair.steps()
    st = pair.check([r1, r2, r3])
    assert st["continuations"] == 1 and st["prefix_installs"] == 2
    assert pair.t.cache.k.dtype == torch.int8


def _client_pair(weights, max_len, **kw):
    from senweaver_ide_tpu.models.tokenizer import ByteTokenizer as JTok
    from senweaver_ide_tpu.rollout import EnginePolicyClient as JClient
    from senweaver_ide_tpu_torch.models.tokenizer import ByteTokenizer
    from senweaver_ide_tpu_torch.rollout import EnginePolicyClient
    pair = Pair(weights, max_len=max_len, eos_id=ByteTokenizer().eos_id)
    return (pair, JClient(pair.j, JTok(), default_max_new_tokens=6, **kw),
            EnginePolicyClient(pair.t, ByteTokenizer(),
                               default_max_new_tokens=6, **kw))


def test_client_auto_prefix_and_weight_sync(weights):
    """auto_prefix: one registration serves both calls; a weight sync
    drops it and the client re-registers on the KeyError. Same text as
    the JAX client throughout."""
    from senweaver_ide_tpu.agents.llm import ChatMessage as JMsg
    from senweaver_ide_tpu_torch.agents.llm import ChatMessage
    pair, jc, tc = _client_pair(weights, 512, auto_prefix=True)
    sysmsg = "You are a careful coding agent. " * 3
    for user in ("fix the bug", "run the tests"):
        a = jc.chat([JMsg("system", sysmsg), JMsg("user", user)],
                    temperature=0.0)
        b = tc.chat([ChatMessage("system", sysmsg),
                     ChatMessage("user", user)], temperature=0.0)
        assert a.text == b.text
    assert len(tc._prefix_ids) == 1 and len(pair.t._prefixes) == 1
    pair.j.update_params(pair.j.params)
    pair.t.update_params(pair.t.params)
    assert pair.t._prefixes == {}
    pair.t._alloc.check_leaks()
    a = jc.chat([JMsg("system", sysmsg), JMsg("user", "again")],
                temperature=0.0)
    b = tc.chat([ChatMessage("system", sysmsg),
                 ChatMessage("user", "again")], temperature=0.0)
    assert a.text == b.text and len(pair.t._prefixes) == 1
    st = pair.check([], leaks=False)
    assert st["prefix_prefills"] == 2 and st["prefix_cache_hits"] == 3


def test_client_continue_turns_parity_and_no_leak(weights):
    from senweaver_ide_tpu.agents.llm import ChatMessage as JMsg
    from senweaver_ide_tpu_torch.agents.llm import ChatMessage
    pair, jc, tc = _client_pair(weights, 1024, continue_turns=True)
    jm, tm = [JMsg("system", "agent rules")], [ChatMessage("system",
                                                           "agent rules")]
    for turn in ("first", "second", "third"):
        jm.append(JMsg("user", turn))
        tm.append(ChatMessage("user", turn))
        a, b = jc.chat(jm, temperature=0.0), tc.chat(tm, temperature=0.0)
        assert a.text == b.text
        jm.append(JMsg("assistant", a.text))
        tm.append(ChatMessage("assistant", b.text))
    jc.release_held_slot()
    tc.release_held_slot()
    assert pair.t._slot_held == [None, None]
    pair.check([])


def test_prefix_dedup_and_queued_request_survives_invalidation(weights):
    pair = Pair(weights)
    pid = pair.do(lambda e: e.register_prefix([5, 6, 7]))
    assert pair.do(lambda e: e.register_prefix([5, 6, 7])) == pid
    assert len(pair.t._prefixes) == 1
    rids = [pair.do(lambda e, i=i: e.submit([5, 6, 7, 8 + i],
                                            max_new_tokens=4,
                                            prefix_id=pid))
            for i in range(4)]               # two queued beyond the slots
    pair.j.update_params(pair.j.params)      # drops the prefix
    pair.t.update_params(pair.t.params)
    pair.steps()
    st = pair.check(rids)
    assert st["prefix_cache_misses"] == 4


@pytest.mark.parametrize("ec", LAYOUTS)
def test_continuation_matches_full_prefill(weights, rng, ec):
    p1 = _rand(rng, 6)
    pair = Pair(weights, engine_config=ec)
    r1 = pair.do(lambda e: e.submit(p1, max_new_tokens=5, hold_slot=True))
    pair.steps()
    full2 = p1 + pair.t.result(r1) + _rand(rng, 4)
    r2 = pair.do(lambda e: e.submit(full2, max_new_tokens=5,
                                    continue_from=r1))
    pair.steps()
    st = pair.check([r1, r2])
    assert st["continuations"] == 1 and st["prefills"] == 1
    plain = Pair(weights, engine_config=ec).t
    rr = plain.submit(full2, max_new_tokens=5)
    assert plain.run()[rr] == pair.t.result(r2)


def test_continuation_validation_and_release(weights):
    pair = Pair(weights)
    eng = pair.t
    p1 = [5, 6, 7, 8]
    r1 = eng.submit(p1, max_new_tokens=3, hold_slot=True)
    out1 = eng.run()[r1]
    with pytest.raises(ValueError, match="does not extend"):
        eng.submit([9] * 10, max_new_tokens=3, continue_from=r1)
    eng.release_slot(r1)
    with pytest.raises(ValueError, match="released|not finished"):
        eng.submit(p1 + out1 + [3], max_new_tokens=3, continue_from=r1)
    r3 = eng.submit([4, 4, 4], max_new_tokens=2)
    eng.run()
    with pytest.raises(ValueError, match="holding"):
        eng.submit([4, 4, 4, 1, 2], max_new_tokens=2, continue_from=r3)
    eng._alloc.check_leaks()


def test_held_slots_queue_pressure_and_sync(weights, rng):
    """A held slot is not recycled; with every slot held, a queued
    request evicts the OLDEST hold instead of livelocking; a one-token
    held run still holds; a weight sync drops the remaining hold."""
    pair = Pair(weights)
    held = [pair.do(lambda e, i=i: e.submit([5, 6, 7 + i],
                                            max_new_tokens=1 + i,
                                            hold_slot=True))
            for i in range(2)]
    pair.steps()
    assert pair.t._slot_held.count(None) == 0
    r = pair.do(lambda e: e.submit([9, 9, 9, 9], max_new_tokens=3))
    pair.steps()
    assert pair.t._slot_held.count(None) == 1
    with pytest.raises(ValueError, match="holding"):
        pair.t.submit([5, 6, 7] + pair.t.result(held[0]) + [1],
                      max_new_tokens=2, continue_from=held[0])
    keep = held[1]
    r2 = pair.do(lambda e: e.submit([5, 6, 8] + e.result(keep) + [2],
                                    max_new_tokens=2, continue_from=keep,
                                    hold_slot=True))
    pair.steps()
    pair.j.update_params(pair.j.params)
    pair.t.update_params(pair.t.params)
    assert pair.t._slot_held == [None, None]
    st = pair.check(held + [r, r2])
    assert st["hold_evictions"] == 1


def test_engine_stats_track_reuse(weights):
    pair = Pair(weights)
    pid = pair.do(lambda e: e.register_prefix([5, 6, 7]))
    r1 = pair.do(lambda e: e.submit([5, 6, 7, 8], max_new_tokens=3,
                                    prefix_id=pid, hold_slot=True))
    pair.steps()
    r2 = pair.do(lambda e: e.submit([5, 6, 7, 8] + e.result(r1) + [9],
                                    max_new_tokens=2, continue_from=r1))
    pair.steps()
    pair.do(lambda e: e.release_prefix(pid))
    s = pair.check([r1, r2])
    assert s["prefix_installs"] == 1 and s["prefix_tokens_reused"] == 3
    assert s["continuations"] == 1 and s["prefills"] == 1
    assert s["tokens_emitted"] == 5


def test_prefix_lru_eviction_and_fallback(weights):
    pair = Pair(weights, max_prefixes=2)
    p1 = pair.do(lambda e: e.register_prefix([1, 2, 3]))
    p2 = pair.do(lambda e: e.register_prefix([4, 5, 6]))
    assert pair.do(lambda e: e.register_prefix([1, 2, 3])) == p1
    p3 = pair.do(lambda e: e.register_prefix([7, 8, 9]))
    assert set(pair.t._prefixes) == {p1, p3} and p2 not in pair.t._prefixes
    # a request carrying a prefix that is evicted while it sits queued
    # completes through a full prefill
    rid = pair.do(lambda e: e.submit([1, 2, 3, 4], max_new_tokens=4,
                                     prefix_id=p1))
    pair.do(lambda e: e.register_prefix([9, 8, 7]))     # evicts p1
    pair.do(lambda e: e.register_prefix([6, 6, 6]))     # evicts p3
    pair.steps()
    for pid in list(pair.t._prefixes):
        pair.do(lambda e, pid=pid: e.release_prefix(pid))
    s = pair.check([rid])
    assert s["prefix_evictions"] == 3 and s["prefix_cache_misses"] == 1


def test_prefix_hit_and_miss_counters(weights):
    pair = Pair(weights)
    pid = pair.do(lambda e: e.register_prefix([1, 2, 3]))
    rids = [pair.do(lambda e, t=t: e.submit([1, 2, 3, t], max_new_tokens=2,
                                            prefix_id=pid)) for t in (4, 5)]
    pair.steps()
    pair.do(lambda e: e.release_prefix(pid))
    assert pair.check(rids)["prefix_cache_hits"] == 2
    pair = Pair(weights, num_slots=1)
    pid = pair.do(lambda e: e.register_prefix([1, 2, 3]))
    hold = pair.do(lambda e: e.submit([9, 9, 9], max_new_tokens=2))
    rc = pair.do(lambda e: e.submit([1, 2, 3, 4], max_new_tokens=2,
                                    prefix_id=pid))
    pair.j.update_params(pair.j.params)
    pair.t.update_params(pair.t.params)
    pair.steps()
    assert pair.check([hold, rc])["prefix_cache_misses"] == 1


def test_cow_consumer_survives_donor_release(weights):
    """A consumer grafted onto a prefix keeps decoding after the prefix
    entry is released mid-flight (its own references keep the blocks)."""
    prefix, suffix = [5, 9, 2, 7, 4, 4], [1, 3]
    pair = Pair(weights, engine_config={"block_size": 4})
    pid = pair.do(lambda e: e.register_prefix(prefix))
    rid = pair.do(lambda e: e.submit(prefix + suffix, max_new_tokens=10,
                                     prefix_id=pid))
    for _ in range(3):
        assert pair.j.step() == pair.t.step()
    pair.do(lambda e: e.release_prefix(pid))
    pair.steps()
    st = pair.check([rid])
    assert st["kv_grafts"] == 1 and st["kv_cow_copies"] == 1


def test_update_params_drops_prefix_block_refcounts(weights):
    pair = Pair(weights, engine_config={"block_size": 4})
    pid1 = pair.do(lambda e: e.register_prefix([5, 9, 2, 7]))
    pid2 = pair.do(lambda e: e.register_prefix([8, 8, 1]))
    rid = pair.do(lambda e: e.submit([5, 9, 2, 7, 1], max_new_tokens=4,
                                     prefix_id=pid1))
    pair.steps()
    assert pair.t._alloc.used_blocks == 2
    pair.j.update_params(pair.j.params)
    pair.t.update_params(pair.t.params)
    for pid in (pid1, pid2):
        with pytest.raises(KeyError):
            pair.t.submit([5, 9, 2, 7, 1], max_new_tokens=2, prefix_id=pid)
    pair.check([rid])


# ---- export / import between engines ---------------------------------------

IMPORT_CASES = [
    ({"block_size": 4}, {"block_size": 4}),
    ({"block_size": 4, "kv_dtype": "int8"},
     {"block_size": 4, "kv_dtype": "int8"}),          # quantized splice
    ({"block_size": 4, "kv_dtype": "int8"},
     {"block_size": 4, "kv_dtype": "int8",
      "kv_dtype_per_layer": ("bf16", "int8")}),      # dequant at the door
    ({"kv_layout": "slots"}, {"block_size": 16}),   # slot → paged
]


@pytest.mark.parametrize("src_ec,dst_ec", IMPORT_CASES)
def test_export_import_between_engines(weights, src_ec, dst_ec):
    """A prefix prefilled once on one engine serves another: the import
    writes its blocks once (``kv_install_copies``), every request after
    that grafts. Exports are copies: a later write into the donor's pool
    does not change them. Same tokens and counters as the JAX pair."""
    prefix = [5, 9, 2, 7] * 3 + [1, 1]          # 14 tokens
    src = Pair(weights, engine_config=src_ec)
    dst = Pair(weights, engine_config=dst_ec)
    pid = src.do(lambda e: e.register_prefix(prefix))
    jt, jkv, jlast = src.j.export_prefix(pid)
    tt, tkv, tlast = src.t.export_prefix(pid)
    assert tt == jt == prefix
    for a, b in zip(jkv[:2] + jkv[3:], tkv[:2] + tkv[3:]):
        if a is None:
            assert b is None
            continue
        np.testing.assert_allclose(np.asarray(b.float()),
                                   np.asarray(a, np.float32), atol=2e-5)
    snapshot = [None if a is None else a.clone() for a in tkv]
    if src.t.kv_layout == "paged":
        for a in src.t.pool:
            if a is not None:
                a.fill_(3)
    else:
        src.t._prefixes[pid][1].k.fill_(3)
    for a, b in zip(tkv, snapshot):
        if a is not None:
            assert torch.equal(a, b)
    for with_logits in (True, False):
        qid = dst.do(lambda e: e.import_prefix(
            prefix, jkv if e is dst.j else tkv,
            (jlast if e is dst.j else tlast) if with_logits else None))
        rids = [dst.do(lambda e, s=s: e.submit(prefix + s,
                                               max_new_tokens=5,
                                               prefix_id=qid))
                for s in ([3], [], [6, 2])]
        dst.steps()
        dst.do(lambda e: e.release_prefix(qid))
        st = dst.check(rids)
    nblk = -(-len(prefix) // dst.t._alloc.block_size)
    assert st["prefix_imports"] == 2
    assert st["kv_install_copies"] == 2 * nblk and st["kv_grafts"] == 6


def test_paged_export_installs_on_a_slot_engine(weights):
    """A paged engine's export (length shaped (1,)) serves a slot engine:
    the same tokens as a slot engine that registered the prefix itself.
    Port only: the JAX slot engine's install of such a buffer raises (it
    sets a () length from the (1,) one)."""
    prefix = [5, 9, 2, 7] * 3 + [1, 1]
    src = Pair(weights, engine_config={"block_size": 4}).t
    toks, kv, last = src.export_prefix(src.register_prefix(prefix))
    outs = []
    for imported in (True, False):
        dst = Pair(weights, engine_config={"kv_layout": "slots"}).t
        pid = (dst.import_prefix(toks, kv, last) if imported
               else dst.register_prefix(prefix))
        rids = [dst.submit(prefix + s, max_new_tokens=5, prefix_id=pid)
                for s in ([3], [], [6, 2])]
        dst.run()
        outs.append([dst.result(r) for r in rids])
    assert outs[0] == outs[1]


def test_import_without_logits_rescores_with_dropped_writes(weights):
    """A zero-suffix request on an imported prefix without logits
    rescores the last token with its write dropped: no copy of the
    shared boundary block for the rescore, only for the first decode
    write (the counters JAX keeps)."""
    prefix = [5, 9, 2, 7, 4, 4]                 # partial boundary block
    src = Pair(weights, engine_config={"block_size": 4})
    pid = src.do(lambda e: e.register_prefix(prefix))
    jkv, tkv = src.j.export_prefix(pid)[1], src.t.export_prefix(pid)[1]
    dst = Pair(weights, engine_config={"block_size": 4})
    qid = dst.do(lambda e: e.import_prefix(prefix,
                                           jkv if e is dst.j else tkv))
    rid = dst.do(lambda e: e.submit(list(prefix), max_new_tokens=1,
                                    prefix_id=qid))
    dst.steps()
    assert dst.t.stats()["kv_cow_copies"] == 0
    rid2 = dst.do(lambda e: e.submit(list(prefix), max_new_tokens=4,
                                     prefix_id=qid))
    dst.steps()
    dst.do(lambda e: e.release_prefix(qid))
    st = dst.check([rid, rid2])
    assert st["kv_cow_copies"] == 1 and st["prefill_tokens"] == 2


def test_import_refuses_mismatched_buffers(weights):
    pair = Pair(weights, engine_config={"block_size": 4})
    pid = pair.t.register_prefix([5, 6, 7, 8])
    toks, kv, _ = pair.t.export_prefix(pid)
    other = Pair(weights, engine_config={"block_size": 4}, max_len=32).t
    with pytest.raises(PrefixImportError, match="shape"):
        other.import_prefix(toks, kv)
    with pytest.raises(PrefixImportError, match="length"):
        pair.t.import_prefix([1, 2, 3], kv)
    with pytest.raises(PrefixImportError, match="dtype"):
        pair.t.import_prefix([1, 2, 3, 4], kv._replace(
            k=kv.k.double(), v=kv.v.double()))
    slots = Pair(weights, cfg={"kv_quant": True}).t
    with pytest.raises(PrefixImportError):
        slots.import_prefix(toks, kv)


@pytest.mark.parametrize("ladder", [{}, {"kv_dtype": "int8"},
                                    {"kv_dtype": "int8",
                                     "kv_dtype_per_layer": ("bf16",
                                                            "int8")}])
def test_block_movers_match_jax(weights, ladder):
    """install_blocks → gather_blocks / gather_blocks_quant equal the
    JAX functions on the same buffers; the gathers are copies."""
    from senweaver_ide_tpu.rollout import paged_kv as jpk
    _, jcfg, _, tcfg = weights
    rs = np.random.default_rng(3)
    shape = (jcfg.num_layers, 3, 4, jcfg.num_kv_heads, jcfg.head_dim)
    k_np = rs.standard_normal(shape).astype(np.float32)
    v_np = rs.standard_normal(shape).astype(np.float32)
    dst = [5, 1, 7]
    jpool = jpk.install_blocks(jpk.init_paged_pool(jcfg, 8, 4, **ladder),
                               k_np, v_np, np.asarray(dst, np.int32))
    tpool = tpk.init_paged_pool(tcfg, 8, 4, device="cpu", **ladder)
    tpk.install_blocks(tpool, torch.from_numpy(k_np),
                       torch.from_numpy(v_np), dst)
    idx = [7, 5]
    # a quantized pool gathers to bf16 on both sides (JAX's full_dtype)
    for a, b in zip(jpk.gather_blocks(jpool, np.asarray(idx, np.int32)),
                    tpk.gather_blocks(tpool, idx)):
        assert str(b.dtype).endswith(str(a.dtype))
        np.testing.assert_allclose(b.float().numpy(),
                                   np.asarray(a, np.float32),
                                   rtol=1e-2 if ladder else 0, atol=1e-6)
    jq = jpk.gather_blocks_quant(jpool, np.asarray(idx, np.int32))
    tq = tpk.gather_blocks_quant(tpool, idx)
    for name, a, b in zip(tq._fields, jq, tq):
        assert (a is None) == (b is None)
        if a is None:
            continue
        if name.endswith("scale"):
            # absmax / 127 in f32: XLA may round the last bit differently
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6)
        else:
            np.testing.assert_array_equal(b.float().numpy(),
                                          np.asarray(a, np.float32))
    before = tq.k.clone()
    tpool.k.zero_()
    assert torch.equal(tq.k, before)          # a copy, not a view
    tpk.install_blocks_quant(tpool, tq, [0, 2])
    np.testing.assert_array_equal(
        tpk.gather_blocks_quant(tpool, [0, 2]).k.float().numpy(),
        before.float().numpy())


# ---- memory pressure: eviction order, host tier, torn swap ---------------

def _press(weights, **ec):
    return Pair(weights, engine_config=dict(block_size=4, **ec))


def test_eviction_prefers_cold_unshared_prefix(weights):
    prompt = HOT + [1, 3, 2, 6]
    pair = Pair(weights, num_slots=1,
                engine_config={"block_size": 4, "num_blocks": 6,
                               "host_tier": False})
    hot = pair.do(lambda e: e.register_prefix(HOT))
    cold = pair.do(lambda e: e.register_prefix(COLD))
    rid = pair.do(lambda e: e.submit(prompt, max_new_tokens=8,
                                     prefix_id=hot))
    pair.steps()
    with pytest.raises(KeyError):
        pair.t.submit(COLD + [1], max_new_tokens=2, prefix_id=cold)
    assert pair.t._prefixes[hot][1] is not None
    pair.do(lambda e: e.release_prefix(hot))
    st = pair.check([rid])
    assert st["prefix_evictions"] == 1 and st["kv_preemptions"] == 0
    reg = tobs.get_registry()
    assert reg.get("senweaver_kv_evictions_total").value() == 1


def test_swap_restore_decode_token_exact(weights):
    prompt = HOT + [1, 3]
    pair = Pair(weights, num_slots=1, engine_config={"block_size": 4})
    pid = pair.do(lambda e: e.register_prefix(HOT))
    r0 = pair.do(lambda e: e.submit(prompt, max_new_tokens=10,
                                    prefix_id=pid))
    pair.steps()
    gathered = tpk.gather_blocks_quant(pair.t.pool, pair.t._prefixes[pid][1])
    pair.do(lambda e: e._swap_out_prefix(pid))
    assert pair.t.prefix_in_host_tier(pid)
    reg = tobs.get_registry()
    assert reg.get("senweaver_kv_swapped_blocks").value() == 2
    assert reg.get("senweaver_kv_swaps_out_total").value() == 2
    # an export while tiered is served from the host
    pair.j.export_prefix(pid)
    toks, kv, _ = pair.t.export_prefix(pid)
    assert toks == HOT and kv.k.device.type == "cpu"
    r1 = pair.do(lambda e: e.submit(prompt, max_new_tokens=10,
                                    prefix_id=pid))
    pair.steps()
    assert pair.t.result(r1) == pair.t.result(r0)
    assert not pair.t.prefix_in_host_tier(pid)
    restored = tpk.gather_blocks_quant(pair.t.pool, pair.t._prefixes[pid][1])
    assert torch.equal(restored.k, gathered.k)
    assert torch.equal(restored.v, gathered.v)
    assert reg.get("senweaver_kv_swaps_in_total").value() == 2
    assert reg.get("senweaver_kv_swapped_blocks").value() == 0
    pair.do(lambda e: e.release_prefix(pid))
    st = pair.check([r0, r1])
    assert st["prefix_swap_outs"] == st["prefix_swap_ins"] == 1
    assert st["prefix_host_exports"] == 1


def test_pressure_tiers_warm_prefix_and_restores(weights):
    """Under exhaustion a warm prefix swaps out (instead of being
    evicted) and its next consumer restores it, on both engines."""
    pair = Pair(weights, num_slots=1,
                engine_config={"block_size": 4, "num_blocks": 6,
                               "tier_min_uses": 1})
    pid = pair.do(lambda e: e.register_prefix(COLD))
    r0 = pair.do(lambda e: e.submit(COLD + [1], max_new_tokens=2,
                                    prefix_id=pid))
    pair.steps()
    r1 = pair.do(lambda e: e.submit([7, 7, 3, 2], max_new_tokens=16))
    pair.steps()
    assert pair.t.prefix_in_host_tier(pid)
    r2 = pair.do(lambda e: e.submit(COLD + [2], max_new_tokens=3,
                                    prefix_id=pid))
    pair.steps()
    pair.do(lambda e: e.release_prefix(pid))
    st = pair.check([r0, r1, r2])
    assert st["prefix_swap_outs"] == 1 and st["prefix_swap_ins"] == 1


def test_torn_swap_falls_back_to_eviction_leak_free(weights, monkeypatch):
    pair = Pair(weights, num_slots=1,
                engine_config={"block_size": 4, "num_blocks": 6,
                               "tier_min_uses": 1})
    pid = pair.do(lambda e: e.register_prefix(COLD))
    r0 = pair.do(lambda e: e.submit(COLD + [1], max_new_tokens=2,
                                    prefix_id=pid))
    pair.steps()

    def boom(pool, ids):
        raise RuntimeError("gather killed mid-swap")
    monkeypatch.setattr(
        "senweaver_ide_tpu.rollout.engine.gather_blocks_quant", boom)
    monkeypatch.setattr(
        "senweaver_ide_tpu_torch.rollout.engine.gather_blocks_quant", boom)
    rid = pair.do(lambda e: e.submit([7, 7, 3, 2], max_new_tokens=16))
    pair.steps()
    assert pid not in pair.t._prefixes
    assert not pair.t.prefix_in_host_tier(pid)
    st = pair.check([r0, rid])
    assert st["prefix_swap_outs"] == 0 and st["prefix_evictions"] == 1


def test_torn_swap_keeps_prefix_resident(weights, monkeypatch):
    """A swap that fails before its point of no return leaves the prefix
    resident, its blocks referenced and no host copy."""
    eng = Pair(weights, engine_config={"block_size": 4}).t
    pid = eng.register_prefix(HOT)
    blocks = list(eng._prefixes[pid][1])

    def boom(a):
        raise RuntimeError("copy to host failed")
    monkeypatch.setattr(eng, "_to_host", boom)
    with pytest.raises(RuntimeError):
        eng._swap_out_prefix(pid)
    assert eng._prefixes[pid][1] == blocks
    assert all(eng._alloc.refcount(b) == 1 for b in blocks)
    assert not eng.prefix_in_host_tier(pid)
    eng.release_prefix(pid)
    eng._alloc.check_leaks()


def test_preemption_storm_cap_bounds_rework(weights):
    pair = Pair(weights, num_slots=3,
                engine_config={"block_size": 4, "num_blocks": 6,
                               "max_preempts": 1})
    rids = [pair.do(lambda e, i=i: e.submit([i + 2, 9, 2, 7],
                                            max_new_tokens=12))
            for i in range(3)]
    pair.steps()
    st = pair.check(rids)
    assert st["kv_preemption_storms"] >= 1


def test_kv_pressure_and_queue_depth(weights):
    eng = Pair(weights, num_slots=1, max_queue=2,
               engine_config={"block_size": 4}).t
    assert eng.kv_pressure == 0.0 and eng.queue_depth == 0
    pid = eng.register_prefix(HOT)
    assert eng.kv_pressure == 2 / eng._alloc.num_blocks
    eng.submit([1, 2, 3], max_new_tokens=2)
    eng.submit([4, 5, 6], max_new_tokens=2)
    assert eng.queue_depth == 2
    eng.step()
    assert eng.queue_depth == 1
    eng.run()
    eng.release_prefix(pid)
    eng._alloc.check_leaks()
    assert Pair(weights, engine_config={"kv_layout": "slots"}
                ).t.kv_pressure == 0.0
