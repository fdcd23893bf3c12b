"""The port's online GRPO round against the JAX package's.

- The training-health diagnostics head (``training/diagnostics.py``)
  against JAX's on seeded rewards with tied groups, a single-member
  group, non-finite rewards and non-contiguous group ids: every key
  within 1e-5 (f32 segment sums in a different order), the spectrum's
  effective rank within 1e-4 (an exp of an entropy over SVD values).
- A greedy ``grpo_round`` on ``tiny_test`` fp32, same bridged weights on
  both sides, 2 tasks x group 2 agent sessions (``max_parallel=1``, a
  short system message, 8 new tokens a call): identical episode token
  streams and trace features, trace rewards within 1e-6 (the reward
  head's tolerance, tests/test_torch_reward_head.py) and the round's
  metrics and health within 1e-5 (tests/test_torch_grpo_round.py's).
- The port alone: a ``max_parallel=4`` round keeps ``(task_idx, g)``
  order, a guard's veto leaves params and moments bit-identical, and
  ``stats()`` holds every key of the JAX engine's on both layouts.
"""

import dataclasses
import functools
import importlib.util
import math
import os

import jax
import numpy as np
import pytest
import torch

from senweaver_ide_tpu import obs as jobs
from senweaver_ide_tpu.models import init_params as jax_init_params
from senweaver_ide_tpu.models import tiny_test as jax_tiny_test
from senweaver_ide_tpu.models.tokenizer import ByteTokenizer as JaxTokenizer
from senweaver_ide_tpu.rollout import EngineConfig as JaxEngineConfig
from senweaver_ide_tpu.rollout import EnginePolicyClient as JaxClient
from senweaver_ide_tpu.rollout import RolloutEngine as JaxEngine
from senweaver_ide_tpu.rollout import RolloutSession as JaxSession
from senweaver_ide_tpu.rollout.sampler import SampleParams as JaxSample
from senweaver_ide_tpu.traces import features as jfeat
from senweaver_ide_tpu.training import diagnostics as jdiag
from senweaver_ide_tpu.training import grpo_round as jax_grpo_round
from senweaver_ide_tpu.training import make_train_state as jax_train_state
from senweaver_ide_tpu_torch import obs
from senweaver_ide_tpu_torch.models import (ByteTokenizer, params_from_numpy,
                                            tiny_test)
from senweaver_ide_tpu_torch.resilience import UpdateGuard
from senweaver_ide_tpu_torch.rewards import score_trace
from senweaver_ide_tpu_torch.rollout import (EngineConfig,
                                             EnginePolicyClient,
                                             RolloutEngine, RolloutSession,
                                             SampleParams)
from senweaver_ide_tpu_torch.traces import TraceCollector
from senweaver_ide_tpu_torch.traces import features as tfeat
from senweaver_ide_tpu_torch.training import diagnostics as tdiag
from senweaver_ide_tpu_torch.training import grpo_round, make_train_state

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIAG_TOL = 1e-5
RANK_TOL = 1e-4
REWARD_TOL = 1e-6
METRIC_TOL = 1e-5
TASKS = ["Add a function add(a, b) to utils.py.", "Write a README.md."]
GROUP = 2
NEW_TOKENS = 8
SYSTEM = "You are a coding agent in a sandbox. Answer briefly."
LR = 1e-3


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


# -- diagnostics ------------------------------------------------------------

def _diag_batch(seed):
    """Rewards over non-contiguous task ids: a tied group, a single-member
    group, a group with a NaN and an inf member, two live groups."""
    rng = np.random.default_rng(seed)
    gids = np.array([3, 3, 3, 7, 7, 7, 9, 12, 12, 12, 12, 20, 20, 20])
    rewards = rng.normal(size=gids.size).astype(np.float32)
    rewards[0:3] = 0.25                       # group 3 ties
    rewards[8] = np.nan                       # group 12: non-finite members
    rewards[10] = np.inf
    mask = rng.random((gids.size, 24)) < 0.6
    mask[:, :4] = False                       # prompt positions
    return rewards, gids, mask


@pytest.mark.parametrize("cfg", [
    dict(), dict(normalize_std=False), dict(leave_one_out=True),
    dict(min_group_std=0.5)], ids=["std", "centered", "loo", "min_std"])
@pytest.mark.parametrize("seed", [0, 1])
def test_diagnostics_match_jax(cfg, seed):
    rewards, gids, mask = _diag_batch(seed)
    uniq, codes = np.unique(gids, return_inverse=True)
    want = jdiag.finalize_round_health(jdiag.dispatch_round_health(
        rewards, codes, mask, num_groups=len(uniq),
        config=jdiag.DiagnosticsConfig(**cfg)))
    dev = tdiag.dispatch_round_health(
        rewards, codes, mask, num_groups=len(uniq),
        config=tdiag.DiagnosticsConfig(**cfg), device="cpu")
    assert all(isinstance(v, torch.Tensor) for v in dev.values())
    got = tdiag.finalize_round_health(dev)
    assert sorted(got) == sorted(want)
    assert want["nonfinite_reward_fraction"] == pytest.approx(2 / 14)
    assert 0.0 < want["zero_advantage_group_fraction"] < 1.0
    for k, v in want.items():
        tol = RANK_TOL if k in ("effective_rank", "rank_fraction") \
            else DIAG_TOL
        assert math.isfinite(got[k]), k
        assert got[k] == pytest.approx(v, abs=tol, rel=tol), k


def test_advantage_stats_match_jax():
    rewards, gids, _ = _diag_batch(2)
    want = jdiag.advantage_stats(rewards, gids)
    got = tdiag.advantage_stats(rewards, gids, device="cpu")
    assert sorted(got) == sorted(want) and got["groups"] == want["groups"]
    for k, v in want.items():
        assert got[k] == pytest.approx(v, abs=DIAG_TOL), k
    assert tdiag.advantage_stats([], [], device="cpu")["groups"] == 0


# -- the round, JAX vs port --------------------------------------------------

def _jax_sessions(engine, tmp, made):
    tok = JaxTokenizer()

    def make():
        client = JaxClient(engine, tok, default_max_new_tokens=NEW_TOKENS,
                           record_calls=True)
        s = JaxSession(client, os.path.join(tmp, f"jax{len(made)}"),
                       include_tool_definitions=False,
                       system_message_override=SYSTEM)
        made.append(s)
        return s
    return make


def _port_sessions(engine, tmp, made, device="cpu"):
    tok = ByteTokenizer()

    def make():
        client = EnginePolicyClient(engine, tok,
                                    default_max_new_tokens=NEW_TOKENS,
                                    record_calls=True)
        s = RolloutSession(client, os.path.join(tmp, f"port{len(made)}"),
                           include_tool_definitions=False,
                           system_message_override=SYSTEM,
                           collector=TraceCollector(reward_fn=(
                               functools.partial(score_trace,
                                                 device=device))))
        made.append(s)
        return s
    return make


@pytest.fixture(scope="module")
def rounds(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("rounds"))
    jcfg, tcfg = jax_tiny_test(), tiny_test()
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(5))
    tparams = params_from_numpy(jax.device_get(jparams), device="cpu")
    eos = JaxTokenizer().eos_id
    jeng = JaxEngine(jparams, jcfg, num_slots=2, max_len=512,
                     sample=JaxSample(0.0, 0, 1.0), eos_id=eos,
                     engine_config=JaxEngineConfig(kv_layout="paged"))
    teng = RolloutEngine(tparams, tcfg, num_slots=2, max_len=512,
                         sample=SampleParams(0.0, 0, 1.0), eos_id=eos,
                         device="cpu")
    out, made = {}, {"jax": [], "port": []}
    kw = dict(group_size=GROUP, pad_id=JaxTokenizer().pad_id,
              max_parallel=1, accum_steps=2)
    jstate = jax_train_state(jcfg, None, None, params=jparams,
                             learning_rate=LR)
    out["jax"] = jax_grpo_round(jstate, jcfg, None,
                                _jax_sessions(jeng, tmp, made["jax"]),
                                TASKS, **kw)
    tstate = make_train_state(tcfg, params=tparams, learning_rate=LR)
    out["port"] = grpo_round(tstate, tcfg, None,
                             _port_sessions(teng, tmp, made["port"]),
                             TASKS, **kw)
    # Greedy members of a group tie on the trace reward, so the first
    # update is a zero-advantage step; a second round on the published
    # weights scores episodes by g so the update moves the weights.
    jeng.update_params(out["jax"].state.params)
    teng.update_params(out["port"].state.params)
    spread = lambda ti, g, s: 1.0 if g % 2 == 0 else -1.0   # noqa: E731
    out["jax2"] = jax_grpo_round(out["jax"].state, jcfg, None,
                                 _jax_sessions(jeng, tmp, []), TASKS,
                                 reward_override=spread, **kw)
    out["port2"] = grpo_round(out["port"].state, tcfg, None,
                              _port_sessions(teng, tmp, []), TASKS,
                              reward_override=spread, **kw)
    return out, made, teng


def test_round_episodes_and_traces_match_jax(rounds):
    out, made, teng = rounds
    jo, to = out["jax"], out["port"]
    assert len(to.episodes) == len(jo.episodes) == len(TASKS) * GROUP
    assert len(to.trajectories) == len(jo.trajectories)
    for jt, tt in zip(jo.trajectories, to.trajectories):
        assert tt.prompt_ids == jt.prompt_ids
        assert tt.completion_ids == jt.completion_ids
        assert tt.group_id == jt.group_id
        np.testing.assert_allclose(tt.behavior_logp, jt.behavior_logp,
                                   atol=1e-4)
    for je, te in zip(jo.episodes, to.episodes):
        assert (te.task_idx, te.n_calls, te.steps) == (je.task_idx,
                                                      je.n_calls, je.steps)
        assert te.reward == pytest.approx(je.reward, abs=REWARD_TOL)
    for js, ts in zip(made["jax"], made["port"]):
        (jtr,), (ttr,) = (js.collector.get_all_traces(),
                          ts.collector.get_all_traces())
        np.testing.assert_array_equal(tfeat.trace_features(ttr),
                                      jfeat.trace_features(jtr))
        assert ([d["name"] for d in ttr.summary.reward_dimensions]
                == [d["name"] for d in jtr.summary.reward_dimensions])
        assert ttr.summary.final_reward == pytest.approx(
            jtr.summary.final_reward, abs=REWARD_TOL)
    teng._alloc.check_leaks()


@pytest.mark.parametrize("which", ["", "2"], ids=["trace", "spread"])
def test_round_metrics_and_health_match_jax(rounds, which):
    out, _, _ = rounds
    jo, to = out["jax" + which], out["port" + which]
    assert sorted(to.metrics) == sorted(jo.metrics)
    for k, v in jo.metrics.items():
        assert to.metrics[k] == pytest.approx(v, abs=METRIC_TOL,
                                              rel=METRIC_TOL), k
    assert sorted(to.health) == sorted(jo.health)
    for k, v in jo.health.items():
        assert to.health[k] == pytest.approx(v, abs=METRIC_TOL,
                                             rel=METRIC_TOL), k
    assert to.health_triggers == jo.health_triggers
    assert to.update_skipped is None and jo.update_skipped is None
    assert to.state.step == int(jo.state.step) == (2 if which else 1)
    if which:
        assert to.metrics["grad_norm"] > 0
        for jt, tt in zip(jo.trajectories, to.trajectories):
            assert tt.completion_ids == jt.completion_ids
    else:
        # the round's rewards are the traces' (no override)
        assert [e.reward for e in to.episodes] == [
            s.collector.get_all_traces()[0].summary.final_reward
            for s in rounds[1]["port"]]


def test_round_records_spans_and_ledger(tmp_path):
    """The round's spans and runtime ledger entries, under JAX's names."""
    tcfg = tiny_test()
    params = params_from_numpy(jax.device_get(jax_init_params(
        jax_tiny_test(), jax.random.PRNGKey(5))), device="cpu")
    engine = RolloutEngine(params, tcfg, num_slots=2, max_len=512,
                           sample=SampleParams(0.0, 0, 1.0), device="cpu")
    tracer = obs.enable()
    try:
        grpo_round(make_train_state(tcfg, params=params), tcfg, None,
                   _port_sessions(engine, str(tmp_path), []), TASKS[:1],
                   group_size=1, max_parallel=1,
                   reward_override=lambda ti, g, s: 0.0)
    finally:
        obs.disable()
    names = {rec.name for rec in tracer.spans()}
    assert {"grpo_round", "collect", "episode", "batch_build", "train_step",
            "trainer.grpo_step", "agent.turn", "engine.decode_step"} <= names
    assert {"engine.fused_step", "trainer.grpo_step"} <= set(
        obs.get_profiler().ledger())


# -- the port alone ----------------------------------------------------------

@pytest.fixture(scope="module")
def port_stack():
    tcfg = tiny_test()
    params = params_from_numpy(jax.device_get(jax_init_params(
        jax_tiny_test(), jax.random.PRNGKey(7))), device="cpu")
    return tcfg, params


def test_parallel_round_keeps_task_group_order(port_stack, tmp_path):
    tcfg, params = port_stack
    engine = RolloutEngine(params, tcfg, num_slots=4, max_len=512,
                           device="cpu")
    out = grpo_round(make_train_state(tcfg, params=params), tcfg, None,
                     _port_sessions(engine, str(tmp_path), []), TASKS,
                     group_size=GROUP, max_parallel=4,
                     reward_override=lambda ti, g, s: 10.0 * ti + g)
    assert [(e.task_idx, e.reward) for e in out.episodes] == [
        (0, 0.0), (0, 1.0), (1, 10.0), (1, 11.0)]
    assert [t.group_id for t in out.trajectories] == sorted(
        t.group_id for t in out.trajectories)
    assert out.metrics["grad_norm"] > 0
    engine._alloc.check_leaks()


def test_vetoed_update_leaves_params_and_moments_untouched(port_stack,
                                                           tmp_path):
    tcfg, params = port_stack
    params = torch.utils._pytree.tree_map(torch.clone, params)
    state = make_train_state(tcfg, params=params, learning_rate=LR)
    snap = [[t.clone() for t in torch.utils._pytree.tree_leaves(tree)]
            for tree in (state.params, state.opt_state.mu,
                         state.opt_state.nu)]
    engine = RolloutEngine(params, tcfg, num_slots=2, max_len=512,
                           sample=SampleParams(0.0, 0, 1.0), device="cpu")
    guard = UpdateGuard()
    out = grpo_round(state, tcfg, None,
                     _port_sessions(engine, str(tmp_path), []), TASKS,
                     group_size=GROUP, max_parallel=1, ppo_epochs=2,
                     update_guard=guard,
                     reward_override=lambda ti, g, s: float("nan"))
    assert out.update_skipped == "nonfinite_loss"
    assert "update_skipped:nonfinite_loss" in out.health_events
    assert out.state is state and state.step == 0
    assert state.opt_state.count == 0
    assert not math.isfinite(out.metrics["loss"])
    after = [torch.utils._pytree.tree_leaves(tree)
             for tree in (state.params, state.opt_state.mu,
                          state.opt_state.nu)]
    for before_l, after_l in zip(snap, after):
        assert len(before_l) == len(after_l)
        for b, a in zip(before_l, after_l):
            assert torch.equal(b, a)
    assert guard.skipped and guard.skipped[0][0] == "nonfinite_loss"


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("layout", ["paged", "slots"])
def test_stats_keys_cover_jax(layout):
    jcfg = jax_tiny_test()
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.device_get(jparams), device="cpu")
    jeng = JaxEngine(jparams, jcfg, num_slots=2, max_len=64,
                     engine_config=JaxEngineConfig(kv_layout=layout))
    teng = RolloutEngine(tparams, tiny_test(), num_slots=2, max_len=64,
                         engine_config=EngineConfig(kv_layout=layout),
                         device="cpu")
    for eng in (jeng, teng):
        eng.submit([1, 2, 3], max_new_tokens=2)
        eng.run()
    js, ts = jeng.stats(), teng.stats()
    assert set(js) <= set(ts), sorted(set(js) - set(ts))
    assert {k: ts[k] for k in js} == js
    if layout == "paged":
        # the list chip_smoke.py checks on the card (it cannot import JAX)
        assert set(_chip_smoke().JAX_STATS_KEYS_PAGED) == set(js)


# -- on the card -------------------------------------------------------------

@pytest.mark.gpu
def test_round_on_the_card_scores_with_the_card_head(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the round's engine, head and "
                    "kernels run there")
    from senweaver_ide_tpu_torch.rewards import reward_head
    from senweaver_ide_tpu_torch.traces import batch_features
    tcfg = dataclasses.replace(tiny_test(), attn_impl="flash")
    params = params_from_numpy(jax.device_get(jax_init_params(
        jax_tiny_test(), jax.random.PRNGKey(5))), device="cuda")
    engine = RolloutEngine(params, tcfg, num_slots=2, max_len=512,
                           device="cuda")
    made = []
    out = grpo_round(make_train_state(tcfg, params=params), tcfg, None,
                     _port_sessions(engine, str(tmp_path), made,
                                    device="cuda"),
                     TASKS[:1], group_size=2, max_parallel=2)
    assert len(out.episodes) == 2 and math.isfinite(out.metrics["loss"])
    traces = [s.collector.get_all_traces()[0] for s in made]
    host = reward_head(torch.from_numpy(batch_features(traces)))
    card = torch.tensor([t.summary.final_reward for t in traces])
    assert torch.allclose(card, host.final_reward, atol=REWARD_TOL, rtol=0)
    engine._alloc.check_leaks()
