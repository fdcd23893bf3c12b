"""The port's group-shared and tree-structured rollout against the JAX
package's, on the same weights (fp32 ``tiny_test``, greedy, paged,
4-token blocks). Mirrors tests/test_group_tree.py without its fleet case
(that waits for the port's serving fleet):

- ``fork_n`` and ``fork`` on the port's allocator;
- a group of 8 paying one prefill; a group with speculation on; more
  members than slots; a tree fork at every depth with speculation on
  and off; fork validation; donor death before the spine capture and
  mid-decode; block exhaustion mid-group; a weight publish mid-roll;
  under an active LoRA tenant: a group, forks at every depth, and an
  adapter publish mid-roll pinning the tree's version. Each scenario runs on a JAX and a port engine step by step: emitted
  tokens equal at every step, every leaf equal to an unshared
  independent decode of its stream, the shared ``stats()`` counters
  (``group_*``, ``branch_forks``, ``kv_cow_copies``) equal, and both
  block pools leak-free;
- the ``GroupRollout`` planner's triggers, caps and forced tokens, its
  records and ``senweaver_rollout_group_*`` counters equal to JAX's;
- ``collect_tree_trajectories`` and ``grpo_round(planner=...)``: the
  same trajectories, and the round's metrics within 1e-5 of JAX's.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from senweaver_ide_tpu import obs as jobs
from senweaver_ide_tpu.models import init_params as jax_init_params
from senweaver_ide_tpu.models import tiny_test as jax_tiny_test
from senweaver_ide_tpu.rollout import AdapterPool as JaxAdapterPool
from senweaver_ide_tpu.rollout import BranchPolicy as JaxPolicy
from senweaver_ide_tpu.rollout import EngineConfig as JaxEngineConfig
from senweaver_ide_tpu.rollout import GroupRollout as JaxGroupRollout
from senweaver_ide_tpu.rollout import RolloutEngine as JaxEngine
from senweaver_ide_tpu.rollout.sampler import SampleParams as JaxSample
from senweaver_ide_tpu.training import grpo_round as jax_grpo_round
from senweaver_ide_tpu.training import make_train_state as jax_train_state
from senweaver_ide_tpu.training.rl_loop import \
    collect_group_trajectories as jax_collect_group
from senweaver_ide_tpu.training.rl_loop import \
    collect_tree_trajectories as jax_collect_tree
from senweaver_ide_tpu_torch import obs
from senweaver_ide_tpu_torch.models import params_from_numpy, tiny_test
from senweaver_ide_tpu_torch.rollout import (AdapterPool, BlockAllocator,
                                             BranchPolicy,
                                             EngineConfig, GroupRollout,
                                             RolloutEngine, SampleParams)
from senweaver_ide_tpu_torch.training import (collect_group_trajectories,
                                              collect_tree_trajectories,
                                              grpo_round, make_train_state)
from senweaver_ide_tpu_torch.training.lora import merge_lora

PROMPT = [5, 9, 2, 7, 1, 3]
LOGP_ATOL = 1e-4
METRIC_TOL = 1e-5


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
    jd = jax_init_params(jdc, jax.random.PRNGKey(1))
    tcfg = tiny_test()
    return dict(jt=jt, jcfg=jcfg, jd=jd, jdc=jdc,
                tt=params_from_numpy(jax.device_get(jt), device="cpu"),
                tcfg=tcfg,
                td=params_from_numpy(jax.device_get(jd), device="cpu"),
                tdc=dataclasses.replace(tcfg, num_layers=2,
                                        name="tiny-draft"))


class Pair:
    """A JAX and a port engine on the same weights; ``do(fn)`` applies
    ``fn`` to both and requires the same return value."""

    def __init__(self, m, *, num_slots=8, max_len=96, num_blocks=None,
                 spec=False, adapters=False):
        self.m = m
        self.j = JaxEngine(m["jt"], m["jcfg"], num_slots=num_slots,
                           max_len=max_len, sample=JaxSample(0.0, 0, 1.0),
                           adapter_pool=(JaxAdapterPool(m["jcfg"])
                                         if adapters else None),
                           engine_config=JaxEngineConfig(
                               kv_layout="paged", block_size=4,
                               num_blocks=num_blocks))
        self.t = RolloutEngine(m["tt"], m["tcfg"], num_slots=num_slots,
                               max_len=max_len,
                               sample=SampleParams(0.0, 0, 1.0),
                               adapter_pool=(AdapterPool(m["tcfg"],
                                                         device="cpu")
                                             if adapters else None),
                               engine_config=EngineConfig(
                                   block_size=4, num_blocks=num_blocks),
                               device="cpu")
        if spec:
            self.j.enable_speculation(m["jd"], m["jdc"], depth=4)
            self.t.enable_speculation(m["td"], m["tdc"], depth=4)

    def do(self, fn):
        a, b = fn(self.j), fn(self.t)
        assert a == b
        return b

    def publish(self, key, seed, scale=0.05):
        """The same nonzero-B rank-4 adapter, from a numpy seed, to both
        engines; returns the port's copy."""
        arrs = _lora_arrays(self.m["tcfg"], seed, scale)
        self.do(lambda e: e.publish_adapter(key, {"layers": {
            k: (torch.from_numpy(v) if e is self.t else jax.numpy.asarray(v))
            for k, v in arrs.items()}}))
        return {"layers": {k: torch.from_numpy(v) for k, v in arrs.items()}}

    def steps(self, n=None):
        i = 0
        while (self.j.has_work or self.t.has_work) and (n is None or i < n):
            assert self.j.step() == self.t.step()
            i += 1

    def step_until(self, rid, n):
        while (len(self.t.result(rid)) < n
               and not self.t.is_done(rid)):
            self.steps(1)

    def check(self, rids):
        for rid in rids:
            assert self.t.result(rid) == self.j.result(rid), rid
            np.testing.assert_allclose(self.t.result_logps(rid),
                                       self.j.result_logps(rid),
                                       atol=LOGP_ATOL)
        js, ts = self.j.stats(), self.t.stats()
        shared = sorted(set(js) & set(ts))
        assert {k: ts[k] for k in shared} == {k: js[k] for k in shared}
        for e in (self.j, self.t):
            e._alloc.check_leaks()
            e.spec_check_leaks()
        return ts


def _lora_arrays(cfg, seed, scale, rank=4):
    """A rank-``rank`` adapter with NONZERO B (init_lora's B = 0 would
    make an adapter parity vacuous), as numpy arrays."""
    rng = np.random.default_rng(seed)
    dims = {"wq": (cfg.hidden_size, cfg.q_dim),
            "wk": (cfg.hidden_size, cfg.kv_dim),
            "wv": (cfg.hidden_size, cfg.kv_dim),
            "wo": (cfg.q_dim, cfg.hidden_size)}
    out = {}
    for t, (d_in, d_out) in dims.items():
        out[t + "_lora_a"] = (rng.standard_normal(
            (cfg.num_layers, d_in, rank)) * 2.0 / d_in ** 0.5).astype(
                np.float32)
        out[t + "_lora_b"] = (rng.standard_normal(
            (cfg.num_layers, rank, d_out)) * scale).astype(np.float32)
    return out


def independent(m, prompt, max_new, params=None):
    """The unshared reference on the port: a fresh engine, a plain
    prefill (``params`` may carry merged adapter leaves)."""
    eng = RolloutEngine(params or m["tt"], m["tcfg"], num_slots=2,
                        max_len=96, sample=SampleParams(0.0, 0, 1.0),
                        engine_config=EngineConfig(block_size=4),
                        device="cpu")
    rid = eng.submit(list(prompt), max_new_tokens=max_new)
    return eng.run()[rid]


# ---- allocator-level fork ---------------------------------------------------

def test_fork_skips_dropped_write_sentinel():
    alloc = BlockAllocator(num_blocks=8, block_size=4)
    table = alloc.alloc(2)
    forked = alloc.fork(table + [alloc.num_blocks])
    assert forked == table + [alloc.num_blocks]
    alloc.release(forked)
    alloc.release(table)
    alloc.check_leaks()


def test_fork_n_all_or_nothing():
    alloc = BlockAllocator(num_blocks=8, block_size=4)
    table = alloc.alloc(3)
    alloc.release([table[1]])
    with pytest.raises(ValueError):
        alloc.fork_n(table, 4)
    alloc.release([table[0], table[2]])
    alloc.check_leaks()


def test_fork_n_refcounts_and_release():
    alloc = BlockAllocator(num_blocks=8, block_size=4)
    table = alloc.alloc(2)
    tables = alloc.fork_n(table, 3)
    assert len(tables) == 3 and all(t == table for t in tables)
    assert [alloc.refcount(b) for b in table] == [4, 4]
    for t in tables:
        alloc.release(t)
    alloc.release(table)
    alloc.check_leaks()


# ---- group-shared prefill ---------------------------------------------------

@pytest.mark.parametrize("spec", [False, True], ids=["plain", "spec"])
def test_group_pays_exactly_one_prefill(models, spec):
    size, new = (8, 12) if not spec else (4, 12)
    ref = independent(models, PROMPT, new)
    pair = Pair(models, spec=spec)
    rids = pair.do(lambda e: e.submit_group(PROMPT, size,
                                            max_new_tokens=new))
    pair.steps()
    for r in rids:
        assert pair.t.result(r) == ref
    s = pair.check(rids)
    assert s["prefills"] == 1 and s["group_prefills"] == 1
    assert s["group_forks"] == size - 1 and s["group_degrades"] == 0
    # each follower avoided the prompt but its rescored last token
    assert s["group_prefill_tokens_avoided"] == (size - 1) * (len(PROMPT) - 1)
    assert s["prefill_tokens"] == len(PROMPT) + size - 1


def test_group_more_members_than_slots_queues_exactly(models):
    ref = independent(models, PROMPT, 8)
    pair = Pair(models, num_slots=3)
    rids = pair.do(lambda e: e.submit_group(PROMPT, 6, max_new_tokens=8))
    pair.steps()
    assert all(pair.t.result(r) == ref for r in rids)
    pair.check(rids)


@pytest.mark.parametrize("spec", [False, True], ids=["plain", "spec"])
def test_tree_fork_exact_at_every_depth(models, spec):
    """Depth-1 sampled and forced branches plus a depth-2 fork of a fork,
    each equal to an independent decode of its stream."""
    pair = Pair(models, spec=spec)
    root = pair.do(lambda e: e.submit(PROMPT, max_new_tokens=14))
    pair.step_until(root, 4)
    c_sampled = pair.do(lambda e: e.fork_request(root))
    c_forced = pair.do(lambda e: e.fork_request(root, token=7))
    pair.step_until(c_sampled, len(pair.t.result(c_sampled)) + 3)
    c_deep = pair.do(lambda e: e.fork_request(c_sampled, token=2))
    pair.steps()
    for rid in (root, c_sampled, c_forced, c_deep):
        stream = pair.t._requests[rid].prompt
        assert stream == pair.j._requests[rid].prompt
        got = pair.t.result(rid)
        assert got == independent(models, stream, len(got))
    assert pair.t._requests[c_deep].branch_depth == 2
    assert pair.check([root, c_sampled, c_forced, c_deep])["branch_forks"] \
        >= 1


@pytest.mark.parametrize("spec", [False, True], ids=["plain", "spec"])
def test_tree_fork_exact_at_every_depth_with_lora(models, spec):
    """The same tree under an active adapter: every branch decodes under
    the root's binding and equals an independent decode of its stream on
    ``merge_lora(base, adapter)``."""
    pair = Pair(models, spec=spec, adapters=True)
    merged = merge_lora(models["tt"], pair.publish("t1", seed=5))
    root = pair.do(lambda e: e.submit(PROMPT, max_new_tokens=14,
                                      adapter_id="t1"))
    pair.step_until(root, 4)
    c_sampled = pair.do(lambda e: e.fork_request(root))
    c_forced = pair.do(lambda e: e.fork_request(root, token=7))
    pair.step_until(c_sampled, len(pair.t.result(c_sampled)) + 3)
    c_deep = pair.do(lambda e: e.fork_request(c_sampled, token=2))
    assert pair.t._requests[c_deep].adapter_binding.version == 1
    pair.steps()
    for rid in (root, c_sampled, c_forced, c_deep):
        stream = pair.t._requests[rid].prompt
        got = pair.t.result(rid)
        assert got == independent(models, stream, len(got), params=merged)
    assert got != independent(models, stream, len(got))   # not vacuous
    assert pair.check([root, c_sampled, c_forced, c_deep])["branch_forks"] \
        >= 1
    assert pair.t.adapter_stats() == pair.j.adapter_stats()


def test_fork_validation_errors(models):
    pair = Pair(models)
    rid = pair.do(lambda e: e.submit(PROMPT, max_new_tokens=6))
    for e in (pair.j, pair.t):
        with pytest.raises(ValueError):
            e.fork_request(rid)            # still prefilling
        with pytest.raises(KeyError):
            e.fork_request(12345)
    pair.steps()
    for e in (pair.j, pair.t):
        with pytest.raises(ValueError):
            e.fork_request(rid)            # done
    pair.check([rid])
    slots = RolloutEngine(models["tt"], models["tcfg"], num_slots=2,
                          max_len=64, device="cpu",
                          engine_config=EngineConfig(kv_layout="slots"))
    with pytest.raises(ValueError, match="paged"):
        slots.submit_group(PROMPT, 2)
    with pytest.raises(ValueError, match="paged"):
        slots.fork_request(0)
    for e in (pair.j, pair.t):
        # a tenant group needs an adapter pool (the JAX engine's refusal)
        with pytest.raises(ValueError, match="no adapter_pool"):
            e.submit_group(PROMPT, 2, adapter_id="t1")


# ---- degrade paths ----------------------------------------------------------

def test_donor_death_before_capture_degrades_group(models):
    ref = independent(models, PROMPT, 8)
    pair = Pair(models)
    rids = pair.do(lambda e: e.submit_group(PROMPT, 3, max_new_tokens=8))
    assert pair.do(lambda e: e.release_request(rids[0]))
    assert pair.do(lambda e: e.release_request(rids[0])) is False
    pair.steps()
    for r in rids[1:]:
        assert pair.t.result(r) == ref
    s = pair.check(rids[1:])
    assert s["group_degrades"] == 1 and s["group_prefills"] == 0


def test_donor_leaf_death_mid_decode_releases_refcounts(models):
    ref = independent(models, PROMPT, 10)
    pair = Pair(models)
    rids = pair.do(lambda e: e.submit_group(PROMPT, 4, max_new_tokens=10))
    pair.step_until(rids[0], 2)            # captured, grafts landed
    assert pair.do(lambda e: e.release_request(rids[0]))
    pair.steps()
    for r in rids[1:]:
        assert pair.t.result(r) == ref
    assert pair.check(rids[1:])["group_prefills"] == 1


def test_block_exhaustion_mid_group_preempts_not_corrupts(models):
    ref = list(independent(models, PROMPT, 12))
    pair = Pair(models, num_slots=4, num_blocks=12)
    rids = pair.do(lambda e: e.submit_group(PROMPT, 4, max_new_tokens=12))
    pair.steps()
    outs = [pair.t.result(r) for r in rids]
    assert any(len(o) == len(ref) for o in outs)
    assert all(o == ref[:len(o)] for o in outs)   # never inexact
    pair.check(rids)


def test_publish_mid_roll_matches_jax(models):
    """A weight publish mid-tree (the port has no adapter pool yet, so the
    base weights are what is published): both engines keep decoding the
    in-flight rows on the new weights, a fork after the publish shares the
    spine, and every stream equals JAX's."""
    bumped_j = jax.tree_util.tree_map(lambda x: x + 0.01, models["jt"])
    bumped_t = params_from_numpy(jax.device_get(bumped_j), device="cpu")
    pair = Pair(models)
    rids = pair.do(lambda e: e.submit_group(PROMPT, 3, max_new_tokens=12))
    pair.step_until(rids[0], 3)
    pair.j.update_params(bumped_j)
    pair.t.update_params(bumped_t)
    child = pair.do(lambda e: e.fork_request(rids[0]))
    pair.steps()
    s = pair.check(rids + [child])
    assert s["branch_forks"] == 1 and s["group_prefills"] == 1


def test_group_exact_under_active_adapter(models):
    """A group under a LoRA tenant matches the merged-params unshared
    reference: the graft shares adapter-conditioned KV."""
    pair = Pair(models, adapters=True)
    merged = merge_lora(models["tt"], pair.publish("t1", seed=3))
    ref = independent(models, PROMPT, 10, params=merged)
    rids = pair.do(lambda e: e.submit_group(PROMPT, 4, max_new_tokens=10,
                                            adapter_id="t1"))
    pair.steps()
    assert all(pair.t.result(r) == ref for r in rids)
    assert ref != independent(models, PROMPT, 10)
    assert pair.check(rids)["group_prefills"] == 1
    assert pair.t.adapter_stats() == pair.j.adapter_stats()


def test_branch_under_mid_roll_publish_pins_version(models):
    """An adapter publish landing mid-tree must not mix policies: the
    group and a branch forked AFTER the publish stay on the submit-time
    version and match the v1 merged reference end to end."""
    pair = Pair(models, adapters=True)
    v1 = merge_lora(models["tt"], pair.publish("t1", seed=11))
    ref = independent(models, PROMPT, 12, params=v1)
    rids = pair.do(lambda e: e.submit_group(PROMPT, 3, max_new_tokens=12,
                                            adapter_id="t1"))
    pair.step_until(rids[0], 3)
    pair.publish("t1", seed=12, scale=0.2)      # mid-roll publish
    child = pair.do(lambda e: e.fork_request(rids[0]))
    assert pair.do(lambda e: e._requests[child].adapter_binding.version) \
        == pair.t._requests[rids[0]].adapter_binding.version == 1
    assert pair.t.adapter_stats()["version_skew"] == 1
    pair.steps()
    assert all(pair.t.result(r) == ref for r in rids)
    stream = pair.t._requests[child].prompt
    got = pair.t.result(child)
    assert got == independent(models, stream, len(got), params=v1)
    pair.check(rids + [child])
    assert pair.t.adapter_stats() == pair.j.adapter_stats()
    assert pair.t.adapter_stats()["version_skew"] == 0


# ---- the GroupRollout planner -----------------------------------------------

def _planner_pair(models, policy_kw, **pair_kw):
    pair = Pair(models, **pair_kw)
    return (pair, JaxGroupRollout(pair.j, policy=JaxPolicy(**policy_kw)),
            GroupRollout(pair.t, policy=BranchPolicy(**policy_kw)))


def _run_planners(jgr, tgr):
    while jgr.engine.has_work or tgr.engine.has_work:
        assert jgr.step() == tgr.step()
    jgr.run()
    tgr.run()


def _counter(pkg, name):
    m = pkg.get_registry().get(name)
    return 0.0 if m is None else m.value()


GROUP_COUNTERS = ("senweaver_rollout_group_prefills_total",
                  "senweaver_rollout_group_forks_total",
                  "senweaver_rollout_group_branch_events_total",
                  "senweaver_rollout_group_cow_copies_total",
                  "senweaver_rollout_group_prefill_tokens_avoided_total")


def test_planner_branches_on_trigger_token(models):
    trigger = int(independent(models, PROMPT, 12)[3])
    pair, jgr, tgr = _planner_pair(models, dict(
        max_leaves=6, max_depth=2, branch_width=2, min_tokens_between=1,
        branch_tokens=(trigger,)))
    gid = pair.do(lambda e: 0)
    assert jgr.submit_group(PROMPT, 2, max_new_tokens=12) == gid
    assert tgr.submit_group(PROMPT, 2, max_new_tokens=12) == gid
    _run_planners(jgr, tgr)
    recs = tgr.collect(gid)
    jrecs = jgr.collect(gid)
    assert recs == [dict(r, logps=recs[i]["logps"])
                    for i, r in enumerate(jrecs)]
    for r, jr in zip(recs, jrecs):
        np.testing.assert_allclose(r["logps"], jr["logps"], atol=LOGP_ATOL)
    assert len(recs) > 2 and any(r["depth"] > 0 for r in recs)
    for rec in recs:
        if rec["depth"] > 0:
            assert rec["branch_pos"] in rec["branch_points"]
            leaf = tgr._leaves[rec["rid"]]
            own = pair.t.result(rec["rid"])
            assert own == independent(
                models, list(PROMPT) + list(leaf.inherited), len(own))
    assert tgr.branch_stats() == jgr.branch_stats()
    for name in GROUP_COUNTERS:
        assert _counter(obs, name) == _counter(jobs, name), name
    assert _counter(obs, "senweaver_rollout_group_prefills_total") == 1.0
    pair.check([r["rid"] for r in recs])


@pytest.mark.parametrize("policy", [
    dict(max_leaves=4, max_depth=1, branch_width=2, min_tokens_between=1,
         logp_threshold=0.0),
    dict(max_leaves=4, max_depth=1, min_tokens_between=2,
         logp_threshold=0.0, forced_tokens=(7,))],
    ids=["caps", "forced"])
def test_planner_caps_and_forced_tokens(models, policy):
    pair, jgr, tgr = _planner_pair(models, policy)
    size = 1 if policy.get("forced_tokens") else 2
    jgr.submit_group(PROMPT, size, max_new_tokens=10)
    tgr.submit_group(PROMPT, size, max_new_tokens=10)
    _run_planners(jgr, tgr)
    recs, jrecs = tgr.collect(0), jgr.collect(0)
    assert [r["tokens"] for r in recs] == [r["tokens"] for r in jrecs]
    assert len(recs) <= 4 and max(r["depth"] for r in recs) <= 1
    assert tgr.branch_stats() == jgr.branch_stats()
    assert tgr.branch_stats()["leaves"] == len(recs)
    if size == 1:
        forced = [r for r in recs if r["forced_token"] == 7]
        assert forced
        for rec in forced:
            assert rec["tokens"][rec["branch_pos"] - 1] == 7
            assert rec["logps"][rec["branch_pos"] - 1] == 0.0
    pair.check([r["rid"] for r in recs])


# ---- the training plane -----------------------------------------------------

def test_collect_tree_trajectories_matches_jax(models):
    kw = dict(max_leaves=4, max_depth=1, min_tokens_between=2,
              logp_threshold=0.0)
    pair, jgr, tgr = _planner_pair(models, kw)
    reward = lambda ti, li, rec: float(li)              # noqa: E731
    jres = jax_collect_tree(jgr, [PROMPT], group_size=2, max_new_tokens=8,
                            reward_fn=reward)
    tres = collect_tree_trajectories(tgr, [PROMPT], group_size=2,
                                     max_new_tokens=8, reward_fn=reward)
    assert len(tres.trajectories) == len(jres.trajectories) >= 2
    assert tres.branch_stats == jres.branch_stats
    assert tres.branch_stats["groups"] == 1.0
    for t, j in zip(tres.trajectories, jres.trajectories):
        assert (t.prompt_ids, t.completion_ids, t.reward, t.group_id,
                t.branch_points) == (j.prompt_ids, j.completion_ids,
                                     j.reward, j.group_id, j.branch_points)
        np.testing.assert_allclose(t.behavior_logp, j.behavior_logp,
                                   atol=LOGP_ATOL)
    assert len({t.reward for t in tres.trajectories}) > 1
    # routing through collect_group_trajectories
    pair2, jgr2, tgr2 = _planner_pair(models, {})
    tr = collect_group_trajectories(None, [PROMPT], group_size=3,
                                    planner=tgr2)
    jr = jax_collect_group(None, [PROMPT], group_size=3, planner=jgr2)
    assert ([t.completion_ids for t in tr.trajectories]
            == [t.completion_ids for t in jr.trajectories])
    assert len(tr.trajectories) == 3
    with pytest.raises(ValueError):
        collect_group_trajectories(None, ["a string task"], group_size=2,
                                   planner=tgr2)
    pair.check([t for t in range(len(tres.trajectories))])
    pair2.check([0, 1, 2])


@pytest.mark.parametrize("spec", [False, True], ids=["plain", "spec"])
def test_grpo_round_with_planner_matches_jax(models, spec):
    """grpo_round over token-list tasks through the tree planner: the same
    trajectories, and the round's metrics and health within 1e-5."""
    policy = dict(max_leaves=4, max_depth=1, min_tokens_between=2,
                  logp_threshold=0.0)
    pair, jgr, tgr = _planner_pair(models, policy, spec=spec)
    tasks = [PROMPT, [1, 2, 3, 4, 5]]
    reward = lambda ti, li, rec: 1.0 if li % 2 == 0 else -1.0   # noqa: E731
    kw = dict(group_size=2, pad_id=0, accum_steps=2, reward_override=reward)
    # the round updates params in place on the port: train a copy
    tparams = params_from_numpy(jax.device_get(models["jt"]), device="cpu")
    jout = jax_grpo_round(
        jax_train_state(models["jcfg"], None, None, params=models["jt"],
                        learning_rate=1e-3),
        models["jcfg"], None, None, tasks, planner=jgr, **kw)
    tout = grpo_round(make_train_state(models["tcfg"], params=tparams,
                                       learning_rate=1e-3),
                      models["tcfg"], None, None, tasks, planner=tgr, **kw)
    assert len(tout.trajectories) == len(jout.trajectories) > 4
    for t, j in zip(tout.trajectories, jout.trajectories):
        assert t.completion_ids == j.completion_ids
        assert t.branch_points == j.branch_points
    assert sorted(tout.metrics) == sorted(jout.metrics)
    for k, v in jout.metrics.items():
        assert tout.metrics[k] == pytest.approx(v, abs=METRIC_TOL,
                                                rel=METRIC_TOL), k
    assert sorted(tout.health) == sorted(jout.health)
    for k, v in jout.health.items():
        assert tout.health[k] == pytest.approx(v, abs=METRIC_TOL,
                                               rel=METRIC_TOL), k
    assert tout.health["tree_leaves"] == len(tout.trajectories)
    assert tout.metrics["grad_norm"] > 0
    for e in (pair.j, pair.t):
        e._alloc.check_leaks()
        e.spec_check_leaks()
