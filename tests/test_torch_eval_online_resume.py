"""torch_eval_online_real.py as a script from a saved checkpoint through
a task shift (tests/test_torch_eval_online.py runs the loop at JAX's
test knobs): the demanded class flips, the shift's probes are reported.
A file of its own: --dist loadfile puts a file on one worker."""

import jax  # noqa: F401  (test files import both frameworks)
import pytest

from torch_eval_helpers import (no_backoff_sleep,  # noqa: F401
                                one_torch_thread, pretrained_policy,
                                run_report, small_recipe_patch)

import torch_eval_online_real


@pytest.fixture
def small_recipe(monkeypatch):
    """The scripts' fixed recipe at test size (small_recipe in
    torch_eval_helpers)."""
    small_recipe_patch(monkeypatch, torch_eval_online_real)


def test_online_script_task_shift_from_a_checkpoint(monkeypatch,
                                                    small_recipe,
                                                    pretrained_policy):
    """The script from a saved checkpoint (the shared pretrained policy;
    one episode a task a round): a task shift at round 1 flips the
    demanded class."""
    path, _state = pretrained_policy
    report = run_report(monkeypatch, "torch_eval_online_real.py",
                        "--rounds", "2", "--ckpt", path,
                        "--group-size", "1", "--shift-round", "1",
                        "--cpu")
    assert report["pretrained"] == {"loaded_from": path}
    assert report["shift_round"] == 1
    assert report["target_class_initial"] != report["target_class_final"]
    assert set(report["shift_probes_frac_low"]) == {
        "frac_low_rule_low", "frac_low_rule_high", "frac_low_no_rules"}
