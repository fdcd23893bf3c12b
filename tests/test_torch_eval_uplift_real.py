"""torch_eval_uplift_real.py, the base of the real-policy evals, against
eval_uplift_real.py: its host-pure parts (the rule bank, the prompts,
``frac_low``, ``minimal_sysmsg``, ``BankProposer``'s answers) equal JAX's
exactly; the scorer, the probes, the pretraining and the whole APO cycle
run on a tiny real (random-init or briefly trained) policy on the CPU and
report JAX's keys within the reward head's range. Stands in for
tests/test_uplift_real.py on the port."""

import jax  # noqa: F401  (test files import both frameworks)
import pytest
import torch

from torch_eval_helpers import (jax_report_keys, no_backoff_sleep,  # noqa
                                one_torch_thread, pretrained_policy,
                                small_recipe_patch)

import eval_uplift_real as J
import torch_eval_uplift_real as T
from senweaver_ide_tpu.agents.llm import ChatMessage as JaxChatMessage
from senweaver_ide_tpu.apo.gradient import (build_apply_edit_prompt,
                                            build_textual_gradient_prompt,
                                            parse_rules)
from senweaver_ide_tpu_torch.agents.llm import ChatMessage

CONSTANTS = ("RULE_LOW", "RULE_HIGH", "DECOY_RULE", "RULE_BANK",
             "PRETRAIN_TEXTS", "EVAL_TEXTS", "LOW_CLASS",
             "DEFAULT_MAX_ATTEMPTS", "RETRY_FOLLOWUP")


@pytest.mark.parametrize("name", CONSTANTS)
def test_rule_bank_and_prompts_equal_jax(name):
    assert getattr(T, name) == getattr(J, name)


@pytest.mark.parametrize("prefix", [0, 1, 64, 448, 1792, 10 ** 9])
def test_minimal_sysmsg_and_prefix_equal_jax(prefix):
    for rules in ([], [T.RULE_LOW], [T.RULE_HIGH, T.DECOY_RULE]):
        assert T.minimal_sysmsg(rules, prefix_bytes=prefix) == \
            J.minimal_sysmsg(rules, prefix_bytes=prefix)
    assert T.realistic_prefix(prefix) == J.realistic_prefix(prefix)


@pytest.mark.parametrize("ids", [[], [65, 66, 200, 256, 258], [300, 400],
                                 list(range(0, 300, 7)), [0, 127, 128]])
def test_frac_low_equals_jax(ids):
    assert T.frac_low(ids) == J.frac_low(ids)


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_bank_proposer_answers_equal_jax(seed):
    grad = build_textual_gradient_prompt([""], [])
    edit = build_apply_edit_prompt([""], "some critique")
    port, ref = T.BankProposer(T.RULE_BANK, seed), J.BankProposer(
        J.RULE_BANK, seed)
    for prompt in (grad, edit, edit, grad, edit, edit, edit):
        got = port.chat([ChatMessage("user", prompt)]).text
        want = ref.chat([JaxChatMessage("user", prompt)]).text
        assert got == want
        if "## Critique" in prompt:
            assert parse_rules(got) and all(r in T.RULE_BANK
                                            for r in parse_rules(got))


@pytest.fixture(scope="module")
def tiny_engine():
    from senweaver_ide_tpu_torch.models import get_config, init_params
    from senweaver_ide_tpu_torch.models.tokenizer import ByteTokenizer
    from senweaver_ide_tpu_torch.rollout import RolloutEngine
    config = get_config("tiny-test")
    params = init_params(config, torch.Generator().manual_seed(0),
                         device="cpu")
    engine = RolloutEngine(params, config, num_slots=8, max_len=2048,
                           eos_id=None, seed=0, device="cpu")
    return engine, ByteTokenizer()


def test_rule_scorer_scores_logs_and_memoizes(tiny_engine, tmp_path):
    engine, tok = tiny_engine
    log = []
    corpus = T.device_collector("cpu")
    score = T.make_rule_scorer(engine, tok, str(tmp_path), target_low=True,
                               eval_tasks=("emit bytes", "write data"),
                               max_attempts=2, score_log=log, corpus=corpus)
    s1 = score([T.DECOY_RULE])
    assert -1.0 <= s1 <= 1.0
    assert log[0]["rules"] == [T.DECOY_RULE]
    assert 1.0 <= log[0]["mean_attempts"] <= 2.0
    assert score([T.DECOY_RULE]) == s1 and len(log) == 1
    # one trace per conversation: follow-ups stay inside it, each scored
    traces = corpus.get_all_traces()
    assert len(traces) == 2
    for tr in traces:
        assert tr.user_message_count == tr.summary.total_llm_calls
        assert 1 <= tr.summary.total_llm_calls <= 2
        assert -1.0 <= tr.summary.final_reward <= 1.0


def test_full_cycle_structure_random_policy(tiny_engine):
    """A shrunken APO cycle on the random-init real policy: JAX's keys,
    scores in the head's range, candidates from the bank."""
    engine, tok = tiny_engine
    report = T.run_real_uplift(engine, tok, beam_rounds=1,
                               eval_tasks=("emit bytes", "write data"),
                               max_attempts=2, probe_episodes=2)
    assert set(report) == jax_report_keys("eval_uplift_real.py",
                                          "run_real_uplift")
    assert report["target_class"] in ("low", "high")
    assert len(report["beam_round_best_scores"]) == 1
    assert report["candidates_scored"] >= 1
    for k in ("baseline_final_reward", "optimized_final_reward"):
        assert -1.0 <= report[k] <= 1.0
    for v in report["probes_frac_low"].values():
        assert 0.0 <= v <= 1.0
    for entry in report["score_log"]:
        assert all(r in T.RULE_BANK or r == "" for r in entry["rules"])
        assert -1.0 <= entry["score"] <= 1.0


def test_pretrain_saves_and_load_policy_restores(pretrained_policy):
    """Two pretraining rounds through the real stack (the shared
    pretrained_policy: its curve in range), a checkpoint of the port's
    own format, and load_policy serving the restored weights."""
    path, state = pretrained_policy
    st2, eng2, _tok, cfg2 = T.load_policy(path, device="cpu")
    assert cfg2.name == "tiny-test" and eng2.device.type == "cpu"
    for (_, a), (_, b) in zip(sorted(_flat(state.params)),
                              sorted(_flat(st2.params))):
        assert torch.equal(a, b)


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + k + "/")
        else:
            yield prefix + k, v


def test_script_runs_on_the_cpu(monkeypatch, tmp_path):
    """The script end to end with --cpu at its smallest knobs (the recipe
    at test size, small_recipe_patch): pretrain (every retry), a saved
    checkpoint, the APO cycle; JAX's keys."""
    import contextlib
    import io
    import sys

    from torch_eval_helpers import last_json
    small_recipe_patch(monkeypatch)
    monkeypatch.setattr(sys, "argv", [
        "torch_eval_uplift_real.py", "--rounds", "1", "--group-size", "2",
        "--beam-rounds", "1", "--max-attempts", "2", "--save-dir",
        str(tmp_path / "ck"), "--cpu"])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        T.main()              # the module's main: the patched recipe
    report = last_json(buf.getvalue())
    want = jax_report_keys("eval_uplift_real.py", "run_real_uplift") | \
        jax_report_keys("eval_uplift_real.py", "main")
    assert set(report) == want
    assert report["pretrain"]["loaded_from"] is None
    assert len(report["pretrain"]["attempts"]) == 3
    assert (tmp_path / "ck").is_dir()
