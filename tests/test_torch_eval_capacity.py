"""The evals that pretrain rule-following through
torch_eval_uplift_real.py, on the CPU at the smallest knobs that reach
every branch: the prompt-length frontier, the seed-robustness sweep, the
generative proposer's uplift, and the capacity curriculum whose
per-stage and final checkpoints the capacity probe and a second
curriculum resume. Each report carries its JAX script's keys; rewards,
fractions and deltas stay in range."""

import jax  # noqa: F401  (test files import both frameworks)
import pytest

from torch_eval_helpers import (jax_report_keys, no_backoff_sleep,  # noqa
                                one_torch_thread, pretrained_policy,
                                run_report, small_recipe_patch)


@pytest.fixture(autouse=True)
def small_recipe(monkeypatch):
    """The scripts' fixed recipe at test size (small_recipe in
    torch_eval_helpers)."""
    small_recipe_patch(monkeypatch)


def test_prompt_frontier_point_structure(monkeypatch):
    report = run_report(monkeypatch, "torch_eval_prompt_frontier.py",
                        "--lengths", "0,64", "--rounds", "1", "--attempts",
                        "1", "--cpu")
    assert set(report) == jax_report_keys("eval_prompt_frontier.py",
                                          "run_frontier")
    assert [p["prefix_bytes"] for p in report["points"]] == [0, 64]
    for p in report["points"]:
        assert set(p) >= {"sysmsg_bytes", "train_tail_mean",
                          "attempt_tails", "probe_frac_low",
                          "conditioning_delta", "conditioned"}
        assert -1.0 <= p["conditioning_delta"] <= 1.0
    assert report["full_prompt_bytes"] > 1500


def test_seed_robustness_cells(monkeypatch):
    report = run_report(monkeypatch, "torch_eval_seed_robustness.py",
                        "--seeds", "10,11", "--rounds", "1", "--configs",
                        "baseline,entropy", "--group-size", "2", "--cpu")
    assert set(report) == jax_report_keys("eval_seed_robustness.py", "main")
    assert [(c["config"], c["seed"]) for c in report["cells"]] == [
        ("baseline", 10), ("baseline", 11), ("entropy", 10),
        ("entropy", 11)]
    for c in report["cells"]:
        assert c["rounds_run"] == 1 and -1.0 <= c["tail_mean"] <= 1.0
    assert report["best_config"] in ("baseline", "entropy")
    assert report["by_config"]["baseline"]["of"] == 2


def test_generative_uplift_structure(monkeypatch, pretrained_policy):
    """The frozen policy is the shared pretrained one (--load-dir); the
    proposer LM samples 16 tokens a call (its default 96)."""
    from senweaver_ide_tpu_torch.apo.proposer import LMProposer
    monkeypatch.setitem(LMProposer.__init__.__kwdefaults__,
                        "max_new_tokens", 16)
    report = run_report(monkeypatch, "torch_eval_uplift_generative.py",
                        "--load-dir", pretrained_policy[0],
                        "--beam-rounds", "1", "--proposer-steps", "10",
                        "--max-attempts", "2", "--cpu")
    want = (jax_report_keys("eval_uplift_real.py", "run_real_uplift")
            | jax_report_keys("eval_uplift_generative.py", "main"))
    assert set(report) == want
    assert report["metric"] == "uplift_generative"
    assert report["pretrain"]["loaded_from"] == pretrained_policy[0]
    assert report["proposer"]["steps"] == 10
    assert len(report["proposer"]["loss_curve"]) >= 1
    audit = report["generation_audit"]
    assert audit["rules_generated"] >= audit["distinct_rules_generated"]
    for k in ("baseline_final_reward", "optimized_final_reward"):
        assert -1.0 <= report[k] <= 1.0


def test_capacity_curriculum_and_probe_resume(monkeypatch, tmp_path):
    """Two curriculum stages banked as checkpoints, the final state saved;
    the probe restores it and measures each prefix; a stage checkpoint
    resumes as the next curriculum's stage 0 (--init-from)."""
    save = str(tmp_path / "cap")
    report = run_report(monkeypatch, "torch_eval_capacity.py", "--schedule",
                        "0,64", "--stage0-rounds", "1", "--stage-rounds",
                        "1", "--attempts", "1", "--group-size", "2",
                        "--save-dir", save, "--cpu")
    assert set(report) == jax_report_keys(
        "eval_capacity.py", "run_capacity") | {"checkpoint_dir"}
    assert [s["prefix_bytes"] for s in report["stages"]] == [0, 64]
    assert (tmp_path / "cap" / "stage0").is_dir()
    assert (tmp_path / "cap" / "stage64").is_dir()
    assert -2.0 <= report["conditioning_delta"] <= 2.0
    probe = run_report(monkeypatch, "torch_eval_capacity_probe.py",
                       "--load-dir", save, "--prefixes", "0,64",
                       "--episodes", "2", "--cpu")
    assert set(probe) == jax_report_keys("eval_capacity_probe.py", "main")
    assert [p["prefix_bytes"] for p in probe["points"]] == [0, 64]
    for p in probe["points"]:
        assert p["delta"] == pytest.approx(p["rule_low"] - p["rule_high"],
                                           abs=1e-4)
    again = run_report(monkeypatch, "torch_eval_capacity.py", "--schedule",
                       "64", "--stage-rounds", "1", "--group-size", "2",
                       "--init-from", str(tmp_path / "cap" / "stage0"),
                       "--cpu")
    assert again["stages"][0]["attempts"] == [
        {"loaded_from": str(tmp_path / "cap" / "stage0")}]
