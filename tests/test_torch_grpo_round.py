"""One GRPO round of the port against the JAX package, end to end on the
same weights and prompts (fp32 tiny-test config, greedy): each side's
RolloutEngine (paged, block_size 4) samples completions with behaviour
log-probs, the batch goes through make_batch / make_batch_logps, each
side's train_step (attn_impl "flash") updates the policy, and
update_params publishes it back into the engine, which serves the next
round."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from senweaver_ide_tpu import obs
from senweaver_ide_tpu.models import forward as jax_forward
from senweaver_ide_tpu.models import init_params as jax_init_params
from senweaver_ide_tpu.models import tiny_test as jax_tiny_test
from senweaver_ide_tpu.rollout import EngineConfig as JaxEngineConfig
from senweaver_ide_tpu.rollout import RolloutEngine as JaxEngine
from senweaver_ide_tpu.rollout.sampler import SampleParams as JaxSample
from senweaver_ide_tpu.training import data as jdata
from senweaver_ide_tpu.training import trainer as jtr
from senweaver_ide_tpu_torch.models import params_from_numpy, tiny_test
from senweaver_ide_tpu_torch.models.transformer import forward
from senweaver_ide_tpu_torch.rollout import (EngineConfig, RolloutEngine,
                                             SampleParams)
from senweaver_ide_tpu_torch.training import data as tdata
from senweaver_ide_tpu_torch.training import trainer as ttr

# two prompt groups of three members; members differ in their last
# prompt token so greedy completions (and rewards) differ within a group
BASES = [[5, 9, 2, 7, 11], [40, 3, 8, 1, 7, 7, 30]]
GROUP = 3
NEW_TOKENS = 6
LR = 1e-3
# behaviour log-probs (paged path) against the trainer's first-step
# log-probs (no-cache path), both fp32: ratio_mean is 1 within 1e-5
RATIO_TOL = 1e-5
# first-step loss and metrics: see tests/test_torch_trainer.py
METRIC_TOL = 1e-5
# second-round engine log-probs after update_params: the two sides'
# params differ by up to a fraction of an Adam step (sign-like where
# |g| ~ eps, see tests/test_torch_trainer.py), which moves fp32
# log-probs by ~1e-5; 1e-4 as in tests/test_torch_engine.py
LOGP_ATOL = 1e-4
LOGITS_ATOL = 1e-4


def _reward(tokens):
    """Stand-in reward from the completion tokens (the reward head comes
    with the sessions slice)."""
    return float(np.mean(np.asarray(tokens) % 7) / 6.0)


def _prompts():
    return [b + [60 + m] for b in BASES for m in range(GROUP)]


@pytest.fixture(autouse=True)
def _fresh_obs():
    obs._reset_for_tests()
    yield
    obs._reset_for_tests()


@pytest.fixture(scope="module")
def round_one():
    jcfg = dataclasses.replace(jax_tiny_test(), attn_impl="flash")
    tcfg = dataclasses.replace(tiny_test(), attn_impl="flash")
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(11))
    tparams = params_from_numpy(jax.device_get(jparams), device="cpu")
    jeng = JaxEngine(jparams, jcfg, num_slots=3, max_len=32,
                     sample=JaxSample(0.0, 0, 1.0),
                     engine_config=JaxEngineConfig(kv_layout="paged",
                                                   block_size=4))
    teng = RolloutEngine(tparams, tcfg, num_slots=3, max_len=32,
                         sample=SampleParams(0.0, 0, 1.0),
                         engine_config=EngineConfig(block_size=4),
                         device="cpu")
    side = {}
    for name, eng, D in (("jax", jeng, jdata), ("torch", teng, tdata)):
        rids = [eng.submit(p, max_new_tokens=NEW_TOKENS) for p in _prompts()]
        eng.run()
        trajs = [D.Trajectory(prompt_ids=p, completion_ids=eng.result(r),
                              reward=_reward(eng.result(r)),
                              group_id=i // GROUP,
                              behavior_logp=eng.result_logps(r))
                 for i, (p, r) in enumerate(zip(_prompts(), rids))]
        batch = D.make_batch(trajs, pad_id=0)
        side[name] = dict(eng=eng, trajs=trajs, batch=batch,
                          old=D.make_batch_logps(trajs, batch[0], batch[1]))
    js = jtr.make_train_state(jcfg, None, params=jparams, learning_rate=LR)
    js, jm = jtr.train_step(js, jcfg, None, *side["jax"]["batch"],
                            old_logp=jnp.asarray(side["jax"]["old"]),
                            num_groups=len(BASES), accum_steps=2)
    ts = ttr.make_train_state(tcfg, params=tparams, learning_rate=LR)
    ts, tm = ttr.train_step(ts, tcfg, None, *side["torch"]["batch"],
                            old_logp=side["torch"]["old"],
                            num_groups=len(BASES), accum_steps=2)
    jeng.update_params(js.params)
    teng.update_params(ts.params)
    return dict(side=side, jm=jm, tm=tm, js=js, ts=ts, jcfg=jcfg, tcfg=tcfg)


def test_completions_and_batches_identical(round_one):
    side = round_one["side"]
    for jt, tt in zip(side["jax"]["trajs"], side["torch"]["trajs"]):
        assert tt.completion_ids == jt.completion_ids
        assert len(tt.completion_ids) == NEW_TOKENS
        np.testing.assert_allclose(tt.behavior_logp, jt.behavior_logp,
                                   atol=LOGP_ATOL)
    for a, b in zip(side["torch"]["batch"], side["jax"]["batch"]):
        np.testing.assert_array_equal(a, b)
    # greedy streams differ within each group, so advantages are live
    rewards = side["torch"]["batch"][2].reshape(len(BASES), GROUP)
    assert (rewards.std(axis=1) > 0).all()


def test_behaviour_logps_equal_first_step_logps(round_one):
    tm = round_one["tm"]
    assert abs(float(tm["ratio_mean"]) - 1.0) < RATIO_TOL
    assert float(tm["clip_frac"]) == 0.0


def test_loss_and_metrics_match_jax(round_one):
    jm, tm = round_one["jm"], round_one["tm"]
    assert sorted(tm) == sorted(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                   atol=METRIC_TOL, rtol=METRIC_TOL,
                                   err_msg=k)
    assert float(tm["grad_norm"]) > 0.0


def test_next_round_after_update_params_matches_jax(round_one):
    side = round_one["side"]
    jeng, teng = side["jax"]["eng"], side["torch"]["eng"]
    assert teng.params is round_one["ts"].params
    prompts = [p + c for p, c in zip(_prompts(), (
        t.completion_ids for t in side["torch"]["trajs"]))][::2]
    rids = [(jeng.submit(p, max_new_tokens=4),
             teng.submit(p, max_new_tokens=4)) for p in prompts]
    jeng.run()
    teng.run()
    for rj, rt in rids:
        assert teng.result(rt) == jeng.result(rj)
        np.testing.assert_allclose(teng.result_logps(rt),
                                   jeng.result_logps(rj), atol=LOGP_ATOL)
    teng._alloc.check_leaks()
    # the published weights' logits over the first round's sequences
    tokens = side["torch"]["batch"][0]
    jl, _ = jax_forward(round_one["js"].params, round_one["jcfg"],
                        jnp.asarray(tokens))
    tl = forward(round_one["ts"].params, round_one["tcfg"],
                 params_from_numpy({"t": tokens}, device="cpu")["t"].long())
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl),
                               atol=LOGITS_ATOL, rtol=LOGITS_ATOL)
    # and the update moved them
    t0 = params_from_numpy(jax.device_get(jax_init_params(
        round_one["jcfg"], jax.random.PRNGKey(11))), device="cpu")
    before = forward(t0, round_one["tcfg"],
                     params_from_numpy({"t": tokens}, device="cpu")["t"]
                     .long())
    assert float((before - tl).abs().max()) > 1e-3
