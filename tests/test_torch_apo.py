"""The port's ``apo/`` against the JAX package's, on the same inputs.

- ``corpus_score_fn`` (the reward head over a trace corpus, on the CPU
  here) within 1e-6 of JAX's on the six-pattern corpus.
- ``evaluate_rules`` under the scripted ``RuleSensitivePolicy``: the same
  score within 1e-6 for no rules, one rule class and both, and the graded
  contract (``tests/test_apo_eval.py``) holds on the port.
- ``beam_search``: the fake-LLM search of ``tests/test_apo.py`` gives the
  same beam; the prompt-conditioned local APO picks the same best rules
  and score as JAX's; ``run_uplift_eval`` (plain and hold-out) reports
  the same numbers; the service's gates and the local full cycle
  (``tests/test_apo_local.py``) behave the same.
- The proposer: the corpus is the same, ``train_rule_proposer``'s loss
  curve stays within 1e-4 of JAX's over 10 steps from the same init
  (both curves are rounded to 4 decimals, as the JAX function rounds
  them), and ``LMProposer`` at temperature 0 writes the same text on both
  sides over the same weights.

Sessions on the port score traces on the CPU
(``TraceCollector(reward_fn=partial(score_trace, device="cpu"))``); the
port's scorers default to the card. The scripted policy's failing
patterns exhaust the agent loop's retries, so every session here sleeps
through ``loop_sleep=lambda _s: None`` on both sides.
"""

import dataclasses
import functools
import random

import jax
import numpy as np
import pytest
import torch

from senweaver_ide_tpu import apo as japo
from senweaver_ide_tpu.apo import proposer as jproposer
from senweaver_ide_tpu.apo import synthetic as jsynth
from senweaver_ide_tpu.agents.llm import ChatMessage as JaxChatMessage
from senweaver_ide_tpu.rollout import RolloutSession as JaxSession
from senweaver_ide_tpu.traces import TraceCollector as JaxCollector
from senweaver_ide_tpu_torch import apo
from senweaver_ide_tpu_torch.agents.llm import (ChatMessage, LLMResponse,
                                                LLMUsage)
from senweaver_ide_tpu_torch.apo import proposer
from senweaver_ide_tpu_torch.apo import synthetic
from senweaver_ide_tpu_torch.models import params_from_numpy
from senweaver_ide_tpu_torch.prompts import render_apo_rules
from senweaver_ide_tpu_torch.rewards import score_trace
from senweaver_ide_tpu_torch.rollout import RolloutSession
from senweaver_ide_tpu_torch.traces import TraceCollector

SCORE_TOL = 1e-6           # the reward head's tolerance
LOSS_TOL = 1e-4
# the uplift report rounds to 4 decimals: one step of that grid
ROUNDED_TOL = 1e-4 + 1e-9
TASKS = apo.SIX_PATTERN_TASKS[:3]


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


def cpu_collector(**kw):
    return TraceCollector(
        reward_fn=functools.partial(score_trace, device="cpu"), **kw)


def _corpus(mod, collector, per_pattern=2, good=2):
    for p in range(1, 7):
        mod.generate_pattern_traces(p, per_pattern, collector, mode="agent")
    mod.generate_good_traces(good, collector, mode="agent")
    return collector


def _factories(tmp_path):
    """Session factories over the scripted policy on both sides."""
    jclient, tclient = japo.RuleSensitivePolicy(), apo.RuleSensitivePolicy()
    n = [0]

    def jax_session(rules, collector=None):
        n[0] += 1
        s = JaxSession(jclient, str(tmp_path / f"j{n[0]}"),
                       apo_rules=list(rules), collector=collector,
                       include_tool_definitions=False,
                       loop_sleep=lambda _s: None)
        s.workspace.write_file("app.py", "def run():\n    return 1\n")
        return s

    def port_session(rules, collector=None):
        n[0] += 1
        s = RolloutSession(tclient, str(tmp_path / f"t{n[0]}"),
                           apo_rules=list(rules),
                           collector=(collector if collector is not None
                                      else cpu_collector()),
                           include_tool_definitions=False,
                           loop_sleep=lambda _s: None)
        s.workspace.write_file("app.py", "def run():\n    return 1\n")
        return s

    return (jclient, jax_session), (tclient, port_session)


def test_corpus_score_fn_matches_jax():
    want = japo.corpus_score_fn(
        _corpus(jsynth, JaxCollector(max_traces=10_000)).get_all_traces())
    traces = _corpus(synthetic, cpu_collector(max_traces=10_000)
                     ).get_all_traces()
    got = apo.corpus_score_fn(traces, device="cpu")
    assert -1.0 <= got(["any"]) <= 1.0
    assert got(["any"]) == pytest.approx(want(["any"]), abs=SCORE_TOL)
    assert apo.corpus_score_fn([], device="cpu")(["x"]) == 0.0
    live = cpu_collector(max_traces=10_000)
    score = apo.corpus_score_from_collector(live, device="cpu")
    assert score(["x"]) == 0.0             # re-read on every call
    _corpus(synthetic, live)
    assert score(["x"]) == pytest.approx(got(["x"]), abs=SCORE_TOL)


def test_evaluate_rules_matches_jax_and_is_graded(tmp_path):
    (_, jmake), (_, tmake) = _factories(tmp_path)
    got = {}
    for name, rules in (
            ("base", []),
            ("verify", ["Always verify inputs before taking any action."]),
            ("eff", ["Use the minimum number of tool calls needed."]),
            ("full", list(apo.GOOD_RULESET))):
        want = japo.evaluate_rules(rules, jmake, TASKS)
        got[name] = apo.evaluate_rules(rules, tmake, TASKS, device="cpu")
        assert got[name] == pytest.approx(want, abs=SCORE_TOL), name
    assert got["full"] > got["base"] + 0.3
    assert got["base"] < got["verify"] < got["full"]
    assert got["base"] < got["eff"] < got["full"]
    score = apo.make_rollout_score_fn(tmake, apo.SIX_PATTERN_TASKS[:2],
                                      device="cpu")
    assert score(apo.GOOD_RULESET) != score(["Be helpful."])


def test_fake_llm_beam_search_matches_jax():
    def fake_llm(prompt: str) -> str:
        if prompt.startswith("Revise the given prompt rules"):
            return ("- Cap tool calls at 8 per task\n"
                    "- Verify failures once then ask")
        return "- reduce redundant tool calls"

    def score(rules):
        return float(sum("Verify" in r for r in rules))

    jc = _corpus(jsynth, JaxCollector(max_traces=10_000))
    tc = _corpus(synthetic, cpu_collector(max_traces=10_000))
    jroll = japo.traces_to_rollouts(jc.get_all_traces()[:4])
    troll = apo.traces_to_rollouts(tc.get_all_traces()[:4])
    assert [r.final_reward for r in troll] == pytest.approx(
        [r.final_reward for r in jroll], abs=SCORE_TOL)
    want = japo.beam_search("- be concise", jroll, fake_llm, score,
                            japo.APOConfig(beam_rounds=2, beam_width=2,
                                           branch_factor=2))
    got = apo.beam_search("- be concise", troll, fake_llm, score,
                          apo.APOConfig(beam_rounds=2, beam_width=2,
                                        branch_factor=2))
    assert got.history_best_score == want.history_best_score >= 1.0
    assert got.history_best_prompt.content == want.history_best_prompt.content
    assert got.current_round == want.current_round == 2
    assert [(c.content, c.score) for c in got.beam] == \
        [(c.content, c.score) for c in want.beam]


def test_local_beam_picks_the_same_rules(tmp_path):
    (jclient, jmake), (tclient, tmake) = _factories(tmp_path)
    out = {}
    for side, client, make, corpus, mod in (
            ("jax", jclient, jmake, JaxCollector(), japo),
            ("port", tclient, tmake, cpu_collector(), apo)):
        for task in apo.SIX_PATTERN_TASKS[:4]:
            s = make([], collector=corpus)
            s.run_turn(task)
            s.record_feedback("bad")
            s.close()
        kw = {"device": "cpu"} if side == "port" else {}
        svc = mod.make_local_apo(corpus, client,
                                 config=mod.APOConfig(beam_rounds=1),
                                 make_session=make, eval_tasks=TASKS, **kw)
        state = svc.run_beam_search(seed_prompt="")
        out[side] = (state.history_best_prompt.content,
                     state.history_best_score, svc.get_optimized_rules())
    assert out["port"][0] == out["jax"][0]
    assert "verify" in out["port"][0].lower()
    assert out["port"][1] == pytest.approx(out["jax"][1], abs=SCORE_TOL)
    assert out["port"][1] > 0.3
    assert out["port"][2] == out["jax"][2]


@pytest.mark.parametrize("holdout", [False, True])
def test_run_uplift_eval_matches_jax(tmp_path, holdout):
    rounds = 4 if holdout else 1
    want = japo.run_uplift_eval(str(tmp_path / "j"), beam_rounds=rounds,
                                holdout=holdout)
    got = apo.run_uplift_eval(str(tmp_path / "t"), beam_rounds=rounds,
                              holdout=holdout, device="cpu")
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if isinstance(v, float):
            assert got[k] == pytest.approx(v, abs=ROUNDED_TOL), k
        elif k == "beam_round_best_scores":
            assert got[k] == pytest.approx(v, abs=ROUNDED_TOL)
        else:
            assert got[k] == v, k
    assert got["uplift_delta"] > 0.3
    if holdout:
        assert got["searched"] and got["uplift_ratio_shifted"] >= 2.0


def test_service_gates_and_flow():
    c = _corpus(synthetic, cpu_collector(max_traces=10_000), 4, 6)
    svc = apo.APOService(c, generate_fn=lambda p: "- always verify edits",
                         config=apo.APOConfig(auto_analyze_interval_ms=0))
    assert svc.should_auto_analyze()
    assert svc.maybe_auto_analyze() is not None
    assert svc.should_auto_gradient()
    assert len(svc.textual_gradients) == 1
    assert any(s.suggested_content
               for s in svc.segments.get_pending_suggestions())
    assert svc.get_stats()["current_good_rate"] == pytest.approx(0.2)
    small = apo.APOService(_corpus(synthetic, cpu_collector(), 1, 1),
                           config=apo.APOConfig(auto_analyze_interval_ms=0))
    assert not small.should_auto_analyze()


class _OptimizerClient:
    """Scripted optimizer policy: critique, then rule-list edits."""

    def __init__(self):
        self.n = 0

    def chat(self, messages, *, temperature=None, max_tokens=None):
        self.n += 1
        prompt = messages[-1].content
        if "critique" in prompt.lower() or "weaknesses" in prompt.lower():
            text = (f"Critique {self.n}: tool calls fail repeatedly; "
                    "verification is missing.")
        else:
            text = (f"- Verify every edit with read_file (v{self.n})\n"
                    "- Keep tool calls under the step budget\n"
                    "- Re-read files before SEARCH/REPLACE edits")
        return LLMResponse(text=text, usage=LLMUsage(50, 30), model="opt")


def test_local_full_cycle():
    collector = _corpus(synthetic, cpu_collector(max_traces=10_000), 4, 8)
    svc = apo.make_local_apo(collector, _OptimizerClient(), device="cpu")
    assert svc.should_auto_analyze()
    report = svc.analyze()
    assert report.total_conversations >= 30 and len(report.patterns) >= 4
    tg = svc.request_textual_gradient()
    assert tg is not None and "Critique" in tg.critique
    state = svc.run_beam_search("- Always answer helpfully")
    assert state.history_best_prompt is not None
    assert state.current_round == svc.config.beam_rounds
    section = render_apo_rules(svc.get_optimized_rules())
    assert section.startswith("# APO Optimized Rules")
    assert len(section) <= 2000
    empty = apo.make_local_apo(cpu_collector(), _OptimizerClient(),
                               device="cpu")
    assert empty.request_textual_gradient() is None


def test_scorers_refuse_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        apo.corpus_score_fn([])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        proposer.train_rule_proposer(steps=1)


# -- the proposer -------------------------------------------------------------

def test_proposer_corpus_matches_jax():
    for held in (((0, 0),), ((0, 0), (2, 3))):
        a = proposer.ProposerCorpus.build(held)
        b = jproposer.ProposerCorpus.build(held)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert a.docs(rng=random.Random(0), n=64) == \
            b.docs(rng=random.Random(0), n=64)


def test_train_rule_proposer_and_lm_proposer_match_jax():
    steps = 10
    jp, jcfg, jtok, jcorpus, want = jproposer.train_rule_proposer(
        steps=steps, batch_size=4, log_every=1, seed=0)
    from senweaver_ide_tpu.models import init_params as jax_init
    init = params_from_numpy(jax.device_get(
        jax_init(jcfg, jax.random.PRNGKey(0))), device="cpu")
    tp, tcfg, ttok, tcorpus, got = proposer.train_rule_proposer(
        steps=steps, batch_size=4, log_every=1, seed=0, device="cpu",
        params=init)
    assert len(got) == len(want) == steps
    # both curves are rounded to 4 decimals: allow the rounding's ulp
    np.testing.assert_allclose(got, want, rtol=0, atol=LOSS_TOL + 1e-9)
    assert got[-1] < got[0]
    # the port's own init (a generator seeded with ``seed``) trains too
    _, _, _, _, own = proposer.train_rule_proposer(
        steps=2, batch_size=2, log_every=1, seed=1, device="cpu")
    assert len(own) == 2 and all(c > 0 for c in own)

    # serving: the JAX-trained weights on both sides, greedy
    served = params_from_numpy(jax.device_get(jp), device="cpu")
    tprop = proposer.LMProposer(served, tcfg, ttok, tcorpus, temperature=0.0,
                                max_new_tokens=24, device="cpu")
    jprop = jproposer.LMProposer(jp, jcfg, jtok, jcorpus, temperature=0.0,
                                 max_new_tokens=24)
    crit = tprop.chat([ChatMessage("user", "critique this prompt")])
    assert crit.text == jprop.chat(
        [JaxChatMessage("user", "critique this prompt")]).text
    assert tprop.generation_log == []
    edit = tprop.chat([ChatMessage("user", "x\n## Critique\ny")])
    jedit = jprop.chat([JaxChatMessage("user", "x\n## Critique\ny")])
    assert edit.text == jedit.text
    assert tprop.generation_log == jprop.generation_log
    assert set(tprop.generation_log[0]) == {"raw", "rules", "novel",
                                            "in_train_corpus"}
