"""The port's ``OnlineImprovementLoop`` under the chaos schedule of
``tests/test_resilience.py::test_chaos_rounds_complete_and_resume_reproduces``:
one raising episode, one hanging episode and one NaN reward across a
3-round run. Every assertion of that test holds on the port: all rounds
complete, only the poisoned update is vetoed, the injected counts match,
and a fresh-process resume from the post-round-1 checkpoint reproduces
round 2's reward mean bit for bit."""

import functools
import math
import re

import jax  # noqa: F401  (test files import both frameworks)
import pytest
import torch

from senweaver_ide_tpu_torch import obs
from senweaver_ide_tpu_torch.apo.eval import RuleSensitivePolicy
from senweaver_ide_tpu_torch.apo.local import make_local_apo
from senweaver_ide_tpu_torch.apo.types import APOConfig
from senweaver_ide_tpu_torch.models import get_config
from senweaver_ide_tpu_torch.models.tokenizer import ByteTokenizer
from senweaver_ide_tpu_torch.resilience import (REASON_NONFINITE_LOSS,
                                                FaultPlan, FaultSpec,
                                                ResilienceConfig)
from senweaver_ide_tpu_torch.rewards import score_trace
from senweaver_ide_tpu_torch.rollout.session import RolloutSession
from senweaver_ide_tpu_torch.traces.collector import TraceCollector
from senweaver_ide_tpu_torch.training import (CheckpointManager,
                                              OnlineImprovementLoop,
                                              make_train_state)
from senweaver_ide_tpu_torch.training.trainer import flatten_params


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny-model steps are thousands of small ops: with several
    pytest-xdist workers, torch's default thread pool in each of them
    oversubscribes the host's cores. The previous setting is restored for
    the next module."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _fresh_obs():
    obs._reset_for_tests()
    yield
    obs._reset_for_tests()


def _build_stack(tmp_path, tag):
    """A fresh 'process': own collector (scoring on the CPU), scripted
    client, APO service (gates pinned shut so determinism reduces to
    rewards + GRPO math), and recording session factory."""
    collector = TraceCollector(
        reward_fn=functools.partial(score_trace, device="cpu"))
    client = RuleSensitivePolicy()
    tok = ByteTokenizer()
    n = [0]

    class Recording:
        def __init__(self, inner):
            self.inner = inner
            self.call_log = []

        def chat(self, messages, **kw):
            r = self.inner.chat(messages, **kw)
            self.call_log.append(
                (tok.encode("\n".join(m.content for m in messages))[-96:],
                 tok.encode(r.text)[:48]))
            return r

    def make_session(rules=None, thread_id=None):
        n[0] += 1
        s = RolloutSession(client, str(tmp_path / f"{tag}-ws{n[0]}"),
                           apo_rules=list(rules or []),
                           thread_id=thread_id or f"{tag}-t{n[0]}",
                           collector=collector,
                           include_tool_definitions=False,
                           loop_sleep=lambda _s: None)
        s.workspace.write_file("app.py", "x = 1\n")
        s.client = Recording(client)
        s.loop.client = s.client
        return s

    apo = make_local_apo(
        collector, client,
        config=APOConfig(min_traces_for_analysis=10**9,
                         min_feedbacks_for_analysis=10**9), device="cpu")
    return collector, apo, make_session


def _round_reward(ti, g, session):
    """Deterministic in (round, task, g): the round index comes from the
    loop's thread-id scheme, so a resumed loop reproduces a round's
    rewards iff it restored the round cursor correctly."""
    m = re.search(r"-r(\d+)-", session.thread_id)
    rnd = int(m.group(1)) if m else 0
    return 0.1 * rnd + 0.5 * ti - 0.25 * g + 0.125


def _state(cfg):
    return make_train_state(cfg, torch.Generator().manual_seed(0), None,
                            learning_rate=1e-3, device="cpu")


def test_chaos_rounds_complete_and_resume_reproduces(tmp_path):
    cfg = get_config("tiny-test")
    mgr = CheckpointManager(str(tmp_path / "ck"), keep_last=3)
    res = ResilienceConfig(episode_timeout_s=0.5, episode_retries=1,
                           retry_base_delay_s=0.01,
                           retry_max_delay_s=0.02,
                           min_group_survivors=2)
    faults = [FaultSpec(0, 0, 0, "raise", times=2),   # quarantined
              FaultSpec(0, 1, 0, "hang", times=1, hang_s=3.0),  # retried
              FaultSpec(1, 0, 1, "nan_reward", times=1)]        # vetoed
    tasks = ["alpha", "beta"]

    collector1, apo1, make_session1 = _build_stack(tmp_path, "p1")
    plan1 = FaultPlan(faults)
    loop1 = OnlineImprovementLoop(
        _state(cfg), cfg, None, plan1.wrap_factory(make_session1), tasks,
        apo=apo1, collector=collector1, group_size=2, max_len=1024,
        max_parallel=1,
        reward_override=plan1.wrap_reward(_round_reward),
        resilience=res, checkpoint_manager=mgr, checkpoint_every=1)

    r01 = loop1.run(2)                     # no exception escapes
    assert [r.round_idx for r in r01] == [0, 1]
    # round 0: (0,0,0) raised twice -> quarantined, its group dropped;
    # (0,1,0) hung past the timeout once, then the retry succeeded
    assert r01[0].failed_episodes == 1
    assert r01[0].episodes == 2            # only task 1's group survived
    assert r01[0].update_skipped is None
    assert r01[0].reward_mean == pytest.approx(0.5)
    assert int(loop1.state.step) == 1
    # round 1: the NaN reward propagated into a NaN loss; exactly that
    # update was vetoed -- params and step untouched
    assert r01[1].update_skipped == REASON_NONFINITE_LOSS
    assert r01[1].episodes == 4
    assert math.isnan(r01[1].reward_mean)
    assert int(loop1.state.step) == 1
    assert plan1.injected_counts() == {"raise": 2, "hang": 1,
                                       "nan_reward": 1}
    assert r01[0].checkpointed and r01[1].checkpointed

    ckpt_step = mgr.latest_step()          # post-round-1 checkpoint
    assert ckpt_step == 1
    # the trainer steps params in place: snapshot them before round 2
    at_ckpt = {k: v.clone() for k, v in flatten_params(loop1.state.params)}

    r2 = loop1.run(1)[0]                   # round 2: clean
    assert r2.round_idx == 2
    assert r2.update_skipped is None and r2.failed_episodes == 0
    assert r2.episodes == 4
    assert int(loop1.state.step) == 2
    assert r2.reward_mean == pytest.approx(0.45)

    # -- preemption: fresh-process posture (new collector/apo/sessions/
    # plan), resume from the post-round-1 checkpoint, re-run round 2 --
    collector2, apo2, make_session2 = _build_stack(tmp_path, "p2")
    plan2 = FaultPlan(faults)              # same schedule, fresh budgets
    loop2 = OnlineImprovementLoop.resume(
        mgr, _state(cfg), cfg, None, plan2.wrap_factory(make_session2),
        tasks, step=ckpt_step,
        apo=apo2, collector=collector2, group_size=2, max_len=1024,
        max_parallel=1,
        reward_override=plan2.wrap_reward(_round_reward),
        resilience=res, checkpoint_every=1)
    assert loop2._round == 2               # resumes AT the killed round
    assert int(loop2.state.step) == 1
    resumed = dict(flatten_params(loop2.state.params))
    assert sorted(resumed) == sorted(at_ckpt)
    for k, v in at_ckpt.items():
        assert torch.equal(resumed[k], v), k

    r2b = loop2.run(1)[0]
    assert r2b.round_idx == 2
    assert r2b.reward_mean == r2.reward_mean    # bit-for-bit
    assert r2b.episodes == r2.episodes
    assert int(loop2.state.step) == 2
    # round 2 sits past every scheduled fault: the fresh plan stays idle
    assert plan2.injected_counts() == {}
