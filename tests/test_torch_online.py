"""The port's ``OnlineImprovementLoop`` against the JAX package's, and its
checkpoint/resume.

Mirrors ``tests/test_online_loop.py`` (all but the control-plane job,
whose ``runtime/`` is not ported) and the resume cases of
``tests/test_resilience.py``:

- Both loops run from the same bridged ``tiny-test`` state over the
  scripted ``RuleSensitivePolicy``: per round the same rules, episode
  count, analyze/beam flags and rewards (within 1e-6, the reward head's
  tolerance), train metrics within 1e-5; the rules APO installs after
  round 0 raise round 1's reward by more than 0.3.
- The KL anchor is a copy: right after a refresh it equals the params in
  value, the next in-place update leaves it where it was, and with
  ``anchor_every=2`` round 1 trains against the round-0 snapshot, its
  ``kl`` equal to JAX's and above zero (an anchor aliasing the live
  params would read exactly 0).
- Resume restores the round index, the rules, the session cursor, the
  train state (params, both moments, count, step) and the anchor bit for
  bit, serves the restored params to the engine, and the resumed round
  equals the uninterrupted one; a missing anchor file re-anchors at the
  restored params.
- A plumbing run on the port's own engine (``EnginePolicyClient``, gates
  lowered): APO analyzes and runs its beam inside the loop.
"""

import dataclasses
import functools
import os
import random
import string

import jax
import numpy as np
import pytest
import torch

from senweaver_ide_tpu import apo as japo
from senweaver_ide_tpu.models.tokenizer import ByteTokenizer as JaxTokenizer
from senweaver_ide_tpu.rollout.session import RolloutSession as JaxSession
from senweaver_ide_tpu.traces.collector import TraceCollector as JaxCollector
from senweaver_ide_tpu.training import OnlineImprovementLoop as JaxLoop
from senweaver_ide_tpu.training import make_train_state as jax_train_state
from senweaver_ide_tpu.training.grpo import GRPOConfig as JaxGRPOConfig
from senweaver_ide_tpu_torch import apo
from senweaver_ide_tpu_torch.apo.eval import outcome_feedback
from senweaver_ide_tpu_torch.models import (ByteTokenizer, params_from_numpy,
                                            tiny_test)
from senweaver_ide_tpu_torch.rewards import score_trace
from senweaver_ide_tpu_torch.rollout import (EnginePolicyClient,
                                             RolloutEngine, RolloutSession,
                                             SampleParams)
from senweaver_ide_tpu_torch.traces import TraceCollector
from senweaver_ide_tpu_torch.training import (CheckpointManager, GRPOConfig,
                                              OnlineImprovementLoop,
                                              make_train_state, train_step)
from senweaver_ide_tpu_torch.training.trainer import flatten_params
from senweaver_ide_tpu_torch.training.online import ANCHOR_FILE

REWARD_TOL = 1e-6
METRIC_TOL = 1e-5
LR = 1e-3
TASKS2 = apo.SIX_PATTERN_TASKS[:2]
APO_GATES = dict(min_traces_for_analysis=4, min_feedbacks_for_analysis=4,
                 gradient_min_feedbacks=4, beam_rounds=1)


def spread(ti, g, s):
    return 1.0 if g % 2 == 0 else -1.0


@pytest.fixture(scope="module")
def init():
    """``tiny-test`` init weights as host arrays, for both sides."""
    from senweaver_ide_tpu.models import get_config
    from senweaver_ide_tpu_torch.models import init_params
    params = init_params(tiny_test(), torch.Generator().manual_seed(0),
                         device="cpu")
    host = {k: ({n: t.numpy() for n, t in v.items()}
                if isinstance(v, dict) else v.numpy())
            for k, v in params.items()}
    return get_config("tiny-test"), host


def _stack(side, tmp_path, init, tag="s", gates_open=True, salt=False):
    """(state, cfg, collector, apo service, recording session factory)
    for ``side``: the fixture of tests/test_online_loop.py. The scripted
    policy answers every member of a group alike, so their gradients
    cancel; ``salt`` starts each recorded completion with 32 letters
    drawn from a seed of the round and session-cursor part of its thread
    id (``r0-s1``: the same on both sides and across a resume), so the
    members differ and the update has a direction."""
    jcfg, host = init
    if side == "jax":
        state = jax_train_state(jcfg, None, None, params=jax.tree_util.
                                tree_map(jax.numpy.asarray, host),
                                learning_rate=LR)
        cfg, collector = jcfg, JaxCollector()
        mod, Session, tok = japo, JaxSession, JaxTokenizer()
    else:
        cfg = tiny_test()
        state = make_train_state(cfg, params=params_from_numpy(
            host, device="cpu"), learning_rate=LR)
        collector = TraceCollector(
            reward_fn=functools.partial(score_trace, device="cpu"))
        mod, Session, tok = apo, RolloutSession, ByteTokenizer()
    client = mod.RuleSensitivePolicy()
    n = [0]

    def make_session(rules=None, thread_id=None):
        n[0] += 1
        s = Session(client, str(tmp_path / f"{side}-{tag}-ws{n[0]}"),
                    apo_rules=list(rules or []),
                    thread_id=thread_id or f"{tag}-t{n[0]}",
                    collector=collector, include_tool_definitions=False,
                    loop_sleep=lambda _s: None)
        s.workspace.write_file("app.py", "x = 1\n")
        return s

    class Recording:
        """Scripted clients record no token streams; this one does."""

        def __init__(self, inner, tag=""):
            self.inner, self.tag = inner, tag
            self.call_log = []

        def chat(self, messages, **kw):
            r = self.inner.chat(messages, **kw)
            self.call_log.append(
                (tok.encode("\n".join(m.content for m in messages))[-96:],
                 tok.encode(self.tag + r.text)[:48]))
            return r

    def make_recording_session(rules=None, thread_id=None):
        s = make_session(rules=rules, thread_id=thread_id)
        tag = ""
        if salt and thread_id:
            rng = random.Random(thread_id.split("-", 3)[-1])
            tag = "".join(rng.choice(string.ascii_letters)
                          for _ in range(32)) + " "
        s.client = Recording(client, tag)
        s.loop.client = s.client
        return s

    gates = APO_GATES if gates_open else dict(min_traces_for_analysis=10**9)
    kw = {"device": "cpu"} if side == "port" else {}
    service = mod.make_local_apo(collector, client,
                                 config=mod.APOConfig(**gates),
                                 make_session=make_session,
                                 eval_tasks=TASKS2, **kw)
    return state, cfg, collector, service, make_recording_session


def _loop(side, stack, tasks, **kw):
    state, cfg, collector, service, make_session = stack
    cls = JaxLoop if side == "jax" else OnlineImprovementLoop
    if side == "jax" and "grpo_config" in kw:
        kw["grpo_config"] = JaxGRPOConfig(**kw["grpo_config"]._asdict())
    return cls(state, cfg, None, make_session, tasks, apo=service,
               collector=collector, group_size=2, max_len=1024,
               max_parallel=1, **kw)


def _assert_rounds_match(got, want):
    assert got.round_idx == want.round_idx
    assert got.rules == want.rules
    assert got.episodes == want.episodes
    assert (got.analyzed, got.beam_ran) == (want.analyzed, want.beam_ran)
    assert got.reward_mean == pytest.approx(want.reward_mean,
                                            abs=REWARD_TOL)
    assert sorted(got.train_metrics) == sorted(want.train_metrics)
    for k, v in want.train_metrics.items():
        assert got.train_metrics[k] == pytest.approx(
            v, abs=METRIC_TOL, rel=METRIC_TOL), k
    assert got.update_skipped == want.update_skipped


def _tensors(tree):
    return dict(flatten_params(tree))


def _assert_equal(a, b):
    ta, tb = _tensors(a), _tensors(b)
    assert sorted(ta) == sorted(tb)
    for k in ta:
        assert torch.equal(ta[k], tb[k]), k


def test_loop_couples_both_optimizers_like_jax(tmp_path, init):
    loops = {side: _loop(side, _stack(side, tmp_path, init), TASKS2)
             for side in ("jax", "port")}
    rounds = {side: loop.run(2) for side, loop in loops.items()}
    for got, want in zip(rounds["port"], rounds["jax"]):
        _assert_rounds_match(got, want)
    r0, r1 = rounds["port"]
    assert r0.rules == [] and r0.episodes == 4
    assert r0.analyzed and r0.beam_ran
    assert any("verify" in r.lower() for r in r1.rules)
    assert r1.reward_mean > r0.reward_mean + 0.3
    assert int(loops["port"].state.step) == 2
    assert loops["port"].current_rules() == loops["jax"].current_rules()
    jstats = loops["jax"].collector.get_stats()
    tstats = loops["port"].collector.get_stats()
    assert tstats["total_feedbacks"] == jstats["total_feedbacks"] >= 4


def test_reward_override_and_analyze_cadence(tmp_path, init):
    loop = _loop("port", _stack("port", tmp_path, init), ["task"],
                 reward_override=spread)
    r = loop.run_round()
    assert r.episodes == 2 and r.reward_mean == pytest.approx(0.0)
    stack = _stack("port", tmp_path, init, tag="c")
    stack[3].config = dataclasses.replace(stack[3].config,
                                          auto_analyze_interval_ms=0.0)
    loop = _loop("port", stack, TASKS2, analyze_every=2)
    assert [r.analyzed for r in loop.run(3)] == [True, False, True]


def test_thread_ids_and_refusals(tmp_path, init):
    state, cfg, collector, service, make_session = _stack(
        "port", tmp_path, init)

    def legacy_factory(rules=None):
        raise AssertionError("never called")

    with pytest.raises(ValueError, match="thread_id"):
        OnlineImprovementLoop(state, cfg, None, legacy_factory, ["t"],
                              apo=service, collector=collector,
                              max_parallel=8)
    with pytest.raises(NotImplementedError, match="mesh"):
        OnlineImprovementLoop(state, cfg, object(), make_session, ["t"],
                              apo=service, collector=collector)
    with pytest.raises(NotImplementedError, match="experience sink"):
        OnlineImprovementLoop(state, cfg, None, make_session, ["t"],
                              apo=service, collector=collector,
                              experience_sink=object())
    # two loops over one collector never reuse thread ids
    kw = dict(apo=service, collector=collector, group_size=2, max_len=1024,
              max_parallel=1)
    l1 = OnlineImprovementLoop(state, cfg, None, make_session, ["t"], **kw)
    l1.run_round()
    before = collector.get_stats()["total_feedbacks"]
    l2 = OnlineImprovementLoop(l1.state, cfg, None, make_session, ["t"],
                               **kw)
    l2.run_round()
    assert collector.get_stats()["total_feedbacks"] > before


def test_rolling_anchor_is_a_copy(tmp_path, init):
    kw = dict(grpo_config=GRPOConfig(kl_coef=0.05), anchor_every=2,
              reward_override=spread)
    loops = {side: _loop(side, _stack(side, tmp_path, init, salt=True),
                         ["task"], **kw)
             for side in ("jax", "port")}
    loop = loops["port"]
    snap0 = {k: v.clone() for k, v in _tensors(loop._anchor).items()}
    rounds = {side: lp.run(2) for side, lp in loops.items()}
    for got, want in zip(rounds["port"], rounds["jax"]):
        _assert_rounds_match(got, want)
    r0, r1 = rounds["port"]
    assert abs(r0.train_metrics["kl"]) < 1e-3     # anchor == init
    # round 1 trained against the round-0 snapshot, not the live params
    assert r1.train_metrics["kl"] > 100 * METRIC_TOL
    # the refresh after round 1: equal values, distinct tensors
    anchor, params = _tensors(loop._anchor), _tensors(loop.state.params)
    for k in params:
        assert torch.equal(anchor[k], params[k]), k
        assert anchor[k].data_ptr() != params[k].data_ptr(), k
    assert any(not torch.equal(anchor[k], snap0[k]) for k in anchor)
    # the next in-place update moves the params, not the anchor
    frozen = {k: v.clone() for k, v in anchor.items()}
    b, s = 2, 12
    train_step(loop.state, loop.model_config, None,
               torch.ones((b, s), dtype=torch.long),
               torch.ones((b, s), dtype=torch.bool),
               torch.tensor([1.0, -1.0]), torch.zeros((b,), dtype=torch.long))
    assert any(not torch.equal(params[k], frozen[k]) for k in params)
    for k in anchor:
        assert torch.equal(anchor[k], frozen[k]), k


class _Engine:
    """Engine stand-in that records what it is told to serve."""

    def __init__(self):
        self.published = []

    def update_params(self, params):
        self.published.append(params)


def test_resume_restores_everything_bit_for_bit(tmp_path, init):
    rules = ["verify the diff with tests first"]
    state, cfg, collector, service, make_session = _stack(
        "port", tmp_path, init, tag="a", gates_open=False, salt=True)
    service.segments.install_rules(list(rules))
    mgr = CheckpointManager(str(tmp_path / "ck"), keep_last=1)
    kw = dict(group_size=2, max_len=1024, max_parallel=1,
              reward_override=spread, grpo_config=GRPOConfig(kl_coef=0.05),
              anchor_every=10**6)               # anchor == init, kept
    template = make_train_state(cfg, params=params_from_numpy(
        init[1], device="cpu"), learning_rate=LR)
    init_params = {k: v.clone() for k, v in _tensors(state.params).items()}
    loop1 = OnlineImprovementLoop(state, cfg, None, make_session, ["t"],
                                  apo=service, collector=collector,
                                  checkpoint_manager=mgr, checkpoint_every=1,
                                  **kw)
    r0 = loop1.run(1)[0]
    assert r0.checkpointed and r0.rules == rules
    assert os.path.exists(os.path.join(mgr.root, "step_1", ANCHOR_FILE))
    assert loop1._session_ids.peek() == 3       # two sessions handed out
    saved = {k: v.clone() for k, v in _tensors(loop1.state.params).items()}
    saved_mu = {k: v.clone() for k, v in
                _tensors(loop1.state.opt_state.mu).items()}
    saved_nu = {k: v.clone() for k, v in
                _tensors(loop1.state.opt_state.nu).items()}

    _, _, collector2, service2, make_session2 = _stack(
        "port", tmp_path, init, tag="b", gates_open=False, salt=True)
    assert service2.get_optimized_rules() == []
    engine = _Engine()
    loop2 = OnlineImprovementLoop.resume(
        mgr, template, cfg, None, make_session2, ["t"], apo=service2,
        collector=collector2, engine=engine, **kw)
    assert loop2._round == 1
    assert loop2.current_rules() == rules
    assert loop2._session_ids.peek() == 3
    assert int(loop2.state.step) == 1 and loop2.state.opt_state.count == 1
    for got, want in ((loop2.state.params, saved),
                      (loop2.state.opt_state.mu, saved_mu),
                      (loop2.state.opt_state.nu, saved_nu),
                      (loop2._anchor, init_params)):
        got = _tensors(got)
        for k in want:
            assert torch.equal(got[k], want[k]), k
    assert engine.published == [loop2.state.params]   # restored, served
    # the resumed round equals the uninterrupted one: the same episodes
    # and rewards; the metrics within the trainer's tolerance (CPU BLAS
    # may round a sum differently over differently aligned buffers)
    a, b = loop1.run(1)[0], loop2.run(1)[0]
    assert a.round_idx == b.round_idx == 1
    assert (a.rules, a.episodes) == (b.rules, b.episodes)
    assert a.reward_mean == b.reward_mean
    assert sorted(a.train_metrics) == sorted(b.train_metrics)
    for k, v in a.train_metrics.items():
        assert b.train_metrics[k] == pytest.approx(
            v, abs=METRIC_TOL, rel=METRIC_TOL), k

    # no anchor file (a preemption between meta.json and the anchor):
    # re-anchor at the restored params, as a copy
    os.remove(os.path.join(mgr.root, "step_2", ANCHOR_FILE))
    loop3 = OnlineImprovementLoop.resume(
        mgr, template, cfg, None, make_session2, ["t"], apo=service2,
        collector=collector2, **kw)
    _assert_equal(loop3._anchor, loop3.state.params)
    assert loop3._anchor["embed"].data_ptr() != \
        loop3.state.params["embed"].data_ptr()


def test_loop_on_the_port_engine(tmp_path, init):
    """Plumbing on the port's own engine: real (random-init) policy
    samples every episode through ``EnginePolicyClient``, the collector
    scores them, GRPO steps, and with the gates lowered the loop's APO
    half analyzes and runs its beam; the publish goes to the engine."""
    cfg = tiny_test()
    tok = ByteTokenizer()
    params = params_from_numpy(init[1], device="cpu")
    engine = RolloutEngine(params, cfg, num_slots=4, max_len=512,
                           sample=SampleParams(), eos_id=tok.eos_id,
                           seed=0, device="cpu")
    collector = TraceCollector(
        reward_fn=functools.partial(score_trace, device="cpu"))
    n = [0]

    def make_session(rules=None, thread_id=None):
        n[0] += 1
        client = EnginePolicyClient(engine, tok, default_max_new_tokens=8,
                                    record_calls=True)
        return RolloutSession(client, str(tmp_path / f"ws{n[0]}"),
                              apo_rules=list(rules or []),
                              thread_id=thread_id or f"t{n[0]}",
                              collector=collector,
                              include_tool_definitions=False,
                              system_message_override="Answer briefly.")

    service = apo.make_local_apo(
        collector, EnginePolicyClient(engine, tok),
        config=apo.APOConfig(beam_width=2, branch_factor=2, **APO_GATES),
        make_session=make_session, eval_tasks=TASKS2[:1], max_tokens=8,
        device="cpu")
    loop = OnlineImprovementLoop(
        make_train_state(cfg, params=params, learning_rate=LR), cfg, None,
        make_session, TASKS2, apo=service, collector=collector,
        engine=engine, group_size=2, max_len=512, max_parallel=4,
        feedback_fn=outcome_feedback)
    r0 = loop.run_round()
    assert r0.episodes == 4 and r0.analyzed and r0.beam_ran
    assert np.isfinite(r0.train_metrics["loss"])
    assert engine.params is loop.state.params
    assert all(t.summary.final_reward is not None
               for t in collector.get_all_traces())
    engine._alloc.check_leaks()
