"""The port's streaming learner against the JAX package's: the pipelined
``AsyncGRPOTrainer`` (training/async_loop.py) and the experience pipeline
(training/experience.py).

Mirrors tests/test_async_loop.py and tests/test_streaming_learner.py's
queue and old_logp tests. Where the JAX tests run the threaded pipeline
they check invariants (its staleness depends on thread timing); the
metrics are held against JAX within 1e-5 through ``_train_on`` on fixed
batches (fresh, stale, ppo_epochs 2, with a KL anchor) and through
``StreamingTrainerAdapter.train_on_batch``. The in-place hazards each
have a test that fails without their snapshot: the behaviour cache's
version 0, a staged publish, the engine that would alias the trainer's
tensors."""

import time
import types

import jax
import numpy as np
import pytest
import torch

from senweaver_ide_tpu import obs as jobs
from senweaver_ide_tpu.models import init_params as jax_init_params
from senweaver_ide_tpu.models import tiny_test as jax_tiny_test
from senweaver_ide_tpu.training import AsyncGRPOTrainer as JaxAsync
from senweaver_ide_tpu.training import GRPOConfig as JaxGRPOConfig
from senweaver_ide_tpu.training import make_train_state as jax_train_state
from senweaver_ide_tpu.training.async_loop import _Collected as JaxCollected
from senweaver_ide_tpu.training.async_loop import \
    behavior_logp_batched as jax_behavior_logp
from senweaver_ide_tpu.training.data import Trajectory as JaxTrajectory
from senweaver_ide_tpu.training.experience import \
    StreamedEpisode as JaxEpisode
from senweaver_ide_tpu.training.experience import \
    StreamingTrainerAdapter as JaxAdapter
from senweaver_ide_tpu_torch import obs
from senweaver_ide_tpu_torch.models import params_from_numpy, tiny_test
from senweaver_ide_tpu_torch.training import (AsyncGRPOTrainer,
                                              BehaviorParamsCache,
                                              ExperienceQueue, GRPOConfig,
                                              StreamedEpisode,
                                              StreamingTrainerAdapter,
                                              Trajectory, assemble_batch,
                                              behavior_logp_batched,
                                              make_batch, make_train_state)
from senweaver_ide_tpu_torch.training.async_loop import _Collected
from senweaver_ide_tpu_torch.training.trainer import (clone_params,
                                                      flatten_params)

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
def weights():
    jcfg = jax_tiny_test()
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    return jparams, jcfg, jax.device_get(jparams), tiny_test()


def _states(weights, lr):
    jparams, jcfg, host, tcfg = weights
    jstate = jax_train_state(jcfg, None, None, params=jparams,
                             learning_rate=lr)
    tstate = make_train_state(tcfg, params=params_from_numpy(
        host, device="cpu"), learning_rate=lr)
    return jstate, tstate


class _FakeClient:
    def __init__(self, rng):
        self._rng = rng
        self.call_log = []


class _FakeSession:
    """Minimal session contract for collect_group_trajectories."""

    def __init__(self, rng, delay_s=0.0, engine=None):
        self.client = _FakeClient(rng)
        self.client.engine = engine
        self._delay = delay_s

    def run_turn(self, task):
        if self._delay:
            time.sleep(self._delay)
        rng = self.client._rng
        self.client.call_log.append(
            ([int(x) for x in rng.integers(1, 200, 6)],
             [int(x) for x in rng.integers(1, 200, 5)]))
        return types.SimpleNamespace(trace=None,
                                     loop=types.SimpleNamespace(steps=1))

    def close(self):
        pass


def _reward(task_idx, g, session):
    return 1.0 if g % 2 == 0 else -1.0


def _make_trainer(state, cfg, rng, **kw):
    return AsyncGRPOTrainer(
        state, cfg, None, lambda: _FakeSession(rng),
        ["t1", "t2"], group_size=2, pad_id=0, max_len=64,
        reward_override=_reward, max_parallel=2, **kw)


def _trajs(cls, seed=7, n=4):
    rs = np.random.default_rng(seed)
    return [cls([int(x) for x in rs.integers(1, 200, 6)],
                [int(x) for x in rs.integers(1, 200, 5)],
                reward=1.0 if i % 2 == 0 else -1.0, group_id=i // 2)
            for i in range(n)]


def _pair(weights, lr, *, jkw=None, tkw=None, **kw):
    jstate, tstate = _states(weights, lr)
    j = JaxAsync(jstate, weights[1], None, None, ["t"], group_size=2,
                 pad_id=0, max_len=64, **kw, **(jkw or {}))
    t = AsyncGRPOTrainer(tstate, weights[3], None, None, ["t"],
                         group_size=2, pad_id=0, max_len=64, **kw,
                         **(tkw or {}))
    return j, t


def _metrics_match(got, want):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k] == pytest.approx(v, abs=METRIC_TOL,
                                       rel=METRIC_TOL), k


def _tensors(tree):
    return dict(flatten_params(tree))


def _equal(a, b):
    ta, tb = _tensors(a), _tensors(b)
    return sorted(ta) == sorted(tb) and all(torch.equal(ta[k], tb[k])
                                            for k in ta)


@pytest.mark.parametrize("kw", [
    {},
    {"ppo_epochs": 2},
    {"importance_correction": False},
])
def test_train_on_matches_jax(weights, kw):
    """A fresh batch, then the same batch stale by one version: the
    importance-corrected step (old_logp under the cached version-0
    params) moves the ratio off 1 on both sides, metrics within 1e-5."""
    j, t = _pair(weights, 1e-2, **kw)
    jt, tt = _trajs(JaxTrajectory), _trajs(Trajectory)
    for stale in (0, 1):
        rj = j._train_on(JaxCollected(jt, [], 0), 0.0)
        rt = t._train_on(_Collected(tt, [], 0), 0.0)
        assert rt.staleness == rj.staleness == stale
        _metrics_match(rt.metrics, rj.metrics)
    if kw.get("importance_correction", True):
        assert abs(rt.metrics["ratio_mean"] - 1.0) > 1e-6
    else:
        assert rt.metrics["ratio_mean"] == pytest.approx(1.0, abs=1e-6)


def test_train_on_with_anchor_matches_jax(weights):
    """ref_params + kl_coef: the first update trains against the anchor
    (kl ≈ 0), the second reads the drift; both within 1e-5 of JAX."""
    jstate, tstate = _states(weights, 1e-2)
    j = JaxAsync(jstate, weights[1], None, None, ["t"], group_size=2,
                 max_len=64, grpo_config=JaxGRPOConfig(kl_coef=0.05),
                 ref_params=jstate.params)
    t = AsyncGRPOTrainer(tstate, weights[3], None, None, ["t"],
                         group_size=2, max_len=64,
                         grpo_config=GRPOConfig(kl_coef=0.05),
                         ref_params=clone_params(tstate.params))
    jt, tt = _trajs(JaxTrajectory), _trajs(Trajectory)
    for i in range(2):
        rj = j._train_on(JaxCollected(jt, [], i), 0.0)
        rt = t._train_on(_Collected(tt, [], i), 0.0)
        _metrics_match(rt.metrics, rj.metrics)
    assert abs(rt.metrics["kl"]) > 0


def test_behavior_cache_version0_survives_in_place_update(weights):
    """The cache's version 0 is a copy: after the in-place update it
    still holds the initial params, so a stale batch's ratio is not 1."""
    _, tstate = _states(weights, 1e-2)
    initial = clone_params(tstate.params)
    t = AsyncGRPOTrainer(tstate, weights[3], None, None, ["t"],
                         group_size=2, max_len=64)
    tt = _trajs(Trajectory)
    t._train_on(_Collected(tt, [], 0), 0.0)
    assert _equal(t.behavior_cache.get(0), initial)
    assert not _equal(t.state.params, initial)
    r1 = t._train_on(_Collected(tt, [], 0), 0.0)
    assert abs(r1.metrics["ratio_mean"] - 1.0) > 1e-6


def test_staged_publish_is_a_copy_taken_at_staging(weights):
    """The trainer keeps writing after it stages: what the collector
    publishes at the next round boundary is the staged version's params,
    and the cache holds those same tensors."""
    _, tstate = _states(weights, 1e-2)
    published = []
    t = AsyncGRPOTrainer(tstate, weights[3], None, None, ["t"],
                         group_size=2, max_len=64,
                         publish_params=published.append)
    t._flush_pending_publish()                  # version 0's copy
    assert len(published) == 1
    assert published[0]["embed"].data_ptr() != \
        tstate.params["embed"].data_ptr()
    tt = _trajs(Trajectory)
    t._train_on(_Collected(tt, [], 0), 0.0)
    staged = clone_params(t.state.params)
    # a later in-place write (the next update) before the flush
    for _, x in flatten_params(t.state.params):
        x.add_(1.0)
    t._flush_pending_publish()
    assert _equal(published[-1], staged)
    assert t.behavior_cache.get(1) is published[-1]
    assert t._applied_behavior[0] == 1


def _side(weights, side, lr):
    """(trainer class, state, config, params-equal, leaves) of one side."""
    jstate, tstate = _states(weights, lr)
    if side == "jax":
        def eq(a, b):
            return all(np.array_equal(np.asarray(x), np.asarray(y))
                       for x, y in zip(jax.tree_util.tree_leaves(a),
                                       jax.tree_util.tree_leaves(b)))
        return JaxAsync, jstate, weights[1], eq
    return AsyncGRPOTrainer, tstate, weights[3], _equal


@pytest.mark.parametrize("side", ["jax", "port"])
def test_async_pipeline_runs_rounds(weights, rng, side):
    """Three pipelined rounds on each side: publication deferred to round
    boundaries and coalesced, the last flushed; staleness within the
    pipeline's depth; the params move; the collector winds down. The
    port also publishes the version-0 copy first, and what it publishes
    is a copy equal to the params."""
    cls, state, cfg, eq = _side(weights, side, 1e-3)
    before = (clone_params(state.params) if side == "port"
              else state.params)
    published = []
    trainer = cls(state, cfg, None, lambda: _FakeSession(rng),
                  ["t1", "t2"], group_size=2, pad_id=0, max_len=64,
                  reward_override=_reward, max_parallel=2, prefetch=2,
                  publish_params=published.append)
    results = trainer.run(3)
    assert len(results) == 3
    if side == "jax":
        assert 1 <= len(published) <= 3
        assert published[-1] is trainer.state.params
    else:
        assert 2 <= len(published) <= 4
        assert eq(published[-1], trainer.state.params)
        assert published[-1]["embed"].data_ptr() != \
            trainer.state.params["embed"].data_ptr()
    for r in results:
        assert r.staleness in (0, 1, 2)
        assert np.isfinite(r.metrics["loss"])
        assert len(r.episodes) == 4
        assert sorted(r.metrics) == sorted(results[0].metrics)
    assert not eq(before, results[-1].state.params)
    assert not trainer._thread.is_alive()
    assert len(trainer.behavior_cache) <= trainer.behavior_cache.capacity


def test_collection_without_publish_reads_a_snapshot(weights, rng):
    """No publication channel: each round's behaviour is a copy taken
    between updates, and an engine serving the trainer's own tensors is
    refused."""
    _, tstate = _states(weights, 1e-3)
    trainer = _make_trainer(tstate, weights[3], rng)
    trainer.run(2)
    live = {x.data_ptr() for _, x in flatten_params(trainer.state.params)}
    for v in trainer.behavior_cache.versions():
        assert not live & {x.data_ptr() for _, x in
                           flatten_params(trainer.behavior_cache.get(v))}
    aliasing = types.SimpleNamespace(params=tstate.params)
    trainer = AsyncGRPOTrainer(
        tstate, weights[3], None,
        lambda: _FakeSession(rng, engine=aliasing), ["t"], group_size=1,
        reward_override=_reward)
    with pytest.raises(RuntimeError, match="collector failed"):
        trainer.run(1)
    assert isinstance(trainer._error, ValueError)
    assert "publish_params" in str(trainer._error)


@pytest.mark.parametrize("side", ["jax", "port"])
def test_async_collector_error_propagates(weights, side):
    cls, state, cfg, _ = _side(weights, side, 1e-3)

    def boom():
        raise OSError("workspace exploded")

    trainer = cls(state, cfg, None, boom, ["t"], group_size=1,
                  reward_override=_reward)
    with pytest.raises(RuntimeError, match="collector failed"):
        trainer.run(1)
    assert isinstance(trainer._error, OSError)


def test_async_on_mesh_raises(weights, rng):
    """A mesh argument is a parallel Mesh (the port's dp/fsdp async run
    is tests/test_torch_mesh_train.py's); anything else raises."""
    _, tstate = _states(weights, 1e-3)
    with pytest.raises(TypeError, match="mesh"):
        AsyncGRPOTrainer(tstate, weights[3], object(),
                         lambda: _FakeSession(rng), ["t"])


@pytest.mark.parametrize("side", ["jax", "port"])
def test_async_lora_trains_adapters_and_publishes_folded(weights, rng,
                                                          side):
    """LoRA: the trainer steps only the adapters; what it publishes is
    the folded full policy, carrying the trained delta. On the port the
    version-0 entry holds copies of the initial adapters."""
    jparams, jcfg, host, tcfg = weights
    if side == "jax":
        from senweaver_ide_tpu.training import \
            make_lora_train_state as jax_lora_state
        base, cfg, cls = jparams, jcfg, JaxAsync
        state = jax_lora_state(jcfg, jparams, jax.random.PRNGKey(1), rank=4,
                               learning_rate=0.05)
    else:
        from senweaver_ide_tpu_torch.training import make_lora_train_state
        base, cfg, cls = params_from_numpy(host, device="cpu"), tcfg, \
            AsyncGRPOTrainer
        state = make_lora_train_state(tcfg, base,
                                      torch.Generator().manual_seed(1),
                                      rank=4, learning_rate=0.05)
        a0 = clone_params(state.params)
    published = []
    trainer = cls(state, cfg, None, lambda: _FakeSession(rng),
                  ["t1", "t2"], group_size=2, pad_id=0, max_len=64,
                  reward_override=_reward, max_parallel=2, ppo_epochs=2,
                  publish_params=published.append, lora_base=base)
    results = trainer.run(2)
    assert all(np.isfinite(r.metrics["loss"]) for r in results)
    assert all("_lora_" in k for k in trainer.state.params["layers"])
    assert published and not any("_lora_" in k
                                 for k in published[-1]["layers"])
    assert not np.array_equal(np.asarray(base["layers"]["wq"]),
                              np.asarray(published[-1]["layers"]["wq"]))
    if side == "port":
        v0 = trainer.behavior_cache.get(0)
        assert all(torch.equal(v0["layers"][k], a0["layers"][k])
                   for k in a0["layers"])


# ---- the experience pipeline ---------------------------------------------

def _eps(n, *, version, epoch=1, start=0, source="c0", group_size=2):
    return [StreamedEpisode(
        episode_id=f"{source}/r0/i{start + i}",
        group_key=f"{source}/r0/g{(start + i) // group_size}",
        prompt_ids=[1, 2, 3], completion_ids=[4, 5],
        reward=float(i), epoch=epoch, version=version,
        behavior_logp=[-0.5, -0.25])
        for i in range(n)]


def test_streamed_old_logp_token_exact_vs_lockstep(weights):
    """old_logp assembled from recorded behaviour logps equals the
    behaviour forward at every masked position; the port's forward is
    JAX's within 1e-5."""
    jparams, jcfg, host, tcfg = weights
    tparams = params_from_numpy(host, device="cpu")
    trajectories = [
        Trajectory([1, 2, 3], [4, 5, 6], reward=1.0, group_id=0),
        Trajectory([1, 2, 3], [7, 8], reward=0.0, group_id=0),
        Trajectory([9, 8], [1, 2, 3, 4], reward=0.5, group_id=1),
        Trajectory([9, 8], [5], reward=0.25, group_id=1),
    ]
    tokens, mask, _, _ = make_batch(trajectories, pad_id=0)
    full = behavior_logp_batched(tparams, tcfg, tokens, 1).numpy()
    np.testing.assert_allclose(
        full, np.asarray(jax_behavior_logp(jparams, jcfg, tokens, 1)),
        atol=METRIC_TOL)
    episodes = []
    for i, t in enumerate(trajectories):
        pos = np.nonzero(mask[i])[0]
        episodes.append(StreamedEpisode(
            episode_id=f"x/i{i}", group_key=f"x/g{t.group_id}",
            prompt_ids=t.prompt_ids, completion_ids=t.completion_ids,
            reward=t.reward, epoch=1, version=0,
            behavior_logp=[float(full[i, j - 1]) for j in pos]))
    _, s_tokens, s_mask, _, s_gids, s_old = assemble_batch(episodes,
                                                           pad_id=0)
    np.testing.assert_array_equal(s_tokens, tokens)
    np.testing.assert_array_equal(s_mask, mask)
    np.testing.assert_array_equal(s_gids, [0, 0, 1, 1])
    shifted = mask[:, 1:]
    np.testing.assert_array_equal(s_old[shifted], full[shifted])
    assert np.all(s_old[~shifted] == 0.0)


def test_partial_groups_wait_then_release():
    q = ExperienceQueue(group_size=4)
    acks = q.offer_many(_eps(3, version=0, group_size=4),
                        current_version=0)["acks"]
    assert set(acks.values()) == {"accepted"}
    assert q.take_batch(current_version=0) is None
    q.offer_many(_eps(1, version=0, start=3, group_size=4),
                 current_version=0)
    batch = q.take_batch(current_version=0)
    assert [ep.episode_id for ep in batch] == [f"c0/r0/i{i}"
                                              for i in range(4)]
    assert q.stats()["depth"] == 0
    assert q.offer(batch[0], current_version=0) == "duplicate"


def test_staleness_bound_drops_and_counts():
    q = ExperienceQueue(group_size=2, max_staleness=2)
    q.offer_many(_eps(2, version=0), current_version=0)
    q.offer_many(_eps(2, version=5, start=2), current_version=5)
    batch = q.take_batch(current_version=5)
    assert [ep.version for ep in batch] == [5, 5]
    assert q.stats()["stale_dropped"] == 2
    m = obs.get_registry().get("senweaver_learner_stale_episodes_total")
    assert float(m.value()) == 2
    acks = q.offer_many(_eps(2, version=1, start=4),
                        current_version=9)["acks"]
    assert set(acks.values()) == {"stale"}


def test_seen_snapshot_restores_dedup_and_capacity_acks():
    q = ExperienceQueue(group_size=2, capacity=2)
    acks = q.offer_many(_eps(3, version=0), current_version=0)["acks"]
    assert list(acks.values()) == ["accepted", "accepted", "full"]
    q2 = ExperienceQueue(group_size=2)
    q2.restore_seen(q.seen_snapshot())
    assert q2.offer(_eps(1, version=0)[0], current_version=0) == "duplicate"
    ep = StreamedEpisode.from_wire(_eps(1, version=3)[0].to_wire())
    assert ep.version == 3 and ep.behavior_logp == [-0.5, -0.25]


@pytest.mark.parametrize("recorded", [True, False])
def test_streaming_adapter_matches_jax(weights, recorded):
    """train_on_batch: recorded behaviour logps (the normal path) or a
    recompute under each stamped version from the cache, with an evicted
    version degrading to ratio 1 (counted); metrics within 1e-5 of JAX."""
    jstate, tstate = _states(weights, 1e-2)
    initial = clone_params(tstate.params)
    j = JaxAdapter(jstate, weights[1], None, max_len=64,
                   behavior_cache_size=1)
    t = StreamingTrainerAdapter(tstate, weights[3], None, max_len=64,
                                behavior_cache_size=1)
    rs = np.random.default_rng(5)
    rows = []
    for i in range(4):
        comp = [int(x) for x in rs.integers(1, 200, 5)]
        lp = [float(x) for x in -rs.uniform(0.5, 3.0, 5)] if recorded \
            else None
        rows.append(dict(episode_id=f"s/i{i}", group_key=f"s/g{i // 2}",
                         prompt_ids=[3, 4, 5], completion_ids=comp,
                         reward=float(i % 2), epoch=0, version=0,
                         behavior_logp=lp))
    for step in range(2):
        mj = j.train_on_batch([JaxEpisode(**r) for r in rows])
        mt = t.train_on_batch([StreamedEpisode(**r) for r in rows])
        _metrics_match(mt, mj)
        if step == 0:
            # version 0 is a copy: the in-place step left it behind
            assert _equal(t.behavior_cache.get(0), initial)
            assert not _equal(t.state.params, initial)
        j.note_published(step + 1)
        t.note_published(step + 1)
    if not recorded:
        assert t.behavior_cache.versions() == [2]
        m = obs.get_registry().get(
            "senweaver_grpo_behavior_ratio_one_fallbacks_total")
        assert float(m.value()) == 1


def test_behavior_cache_lru_and_typed_eviction():
    from senweaver_ide_tpu_torch.training import BehaviorParamsEvicted
    c = BehaviorParamsCache(2)
    for v in range(3):
        c.put(v, {"v": v})
    assert c.versions() == [1, 2] and 0 not in c
    with pytest.raises(BehaviorParamsEvicted):
        c.get(0)
    assert c.get(1) == {"v": 1}
