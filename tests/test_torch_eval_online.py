"""torch_eval_online_real.py, the online loop on real weights, on the CPU
at JAX's test knobs (the APO gates open inside the run; the script from a
checkpoint through a task shift is tests/test_torch_eval_online_resume.py):
JAX's report keys, rewards and rates in range. Token parity with JAX at
temperature > 0 is not asked for (the two frameworks draw different
sample streams). Stands in for tests/test_online_real.py on the port."""

import jax  # noqa: F401  (test files import both frameworks)
import pytest

from torch_eval_helpers import (jax_report_keys, no_backoff_sleep,  # noqa
                                one_torch_thread, small_recipe_patch)

import torch_eval_online_real


@pytest.fixture
def small_recipe(monkeypatch):
    """The scripts' fixed recipe at test size (small_recipe in
    torch_eval_helpers)."""
    small_recipe_patch(monkeypatch, torch_eval_online_real)


def test_online_loop_real_weights_plumbing(small_recipe):
    # 4 rounds x (3 tasks x 2 group) = 24 traces: crosses the APO
    # auto-analyze gate (20 traces / 10 feedbacks) inside the run
    report = torch_eval_online_real.run_online_eval(
        rounds=4, ckpt=None, pretrain_rounds=1, group_size=2,
        max_attempts=2, device="cpu")
    assert set(report) == jax_report_keys("eval_online_real.py",
                                          "run_online_eval")
    assert report["rounds"] == 4 and len(report["curve"]) == 4
    assert report["reward_source"].startswith("9-dim reward head")
    assert report["policy"].startswith("real transformer")
    for p in report["per_round"]:
        assert 0.0 <= p["good_rate"] <= 1.0
        assert 1.0 <= p["mean_attempts"] <= 2.0
        assert -1.0 <= p["reward_mean"] <= 1.0
        assert isinstance(p["rules_active"], list)
    assert any(p["analyzed"] for p in report["per_round"])
    assert 0.0 <= report["prior_frac_low_initial"] <= 1.0
