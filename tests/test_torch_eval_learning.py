"""torch_eval_learning.py against eval_learning.py.

The learning proof's assertion (the curve rises by 0.5 to above 0.3 with
tests/test_learning.py's arguments) runs on the card in chip_smoke.py's
phase_eval; here each mode (full, LoRA, QLoRA, contextual, anchored)
runs one or two short rounds on the CPU with JAX's report keys and rewards in
[-1, 1]; the full mode on the assembled agent prompt, the others on the
short one."""

import jax  # noqa: F401  (test files import both frameworks)
import pytest

from torch_eval_helpers import (jax_report_keys,  # noqa: F401
                                no_backoff_sleep, one_torch_thread,
                                run_report)

import torch_eval_learning

SHORT = dict(short_prompt=True)
MODES = {"full": {}, "lora": dict(lora_rank=4, lr=0.1, **SHORT),
         "qlora": dict(lora_rank=4, qlora=True, lr=0.1, **SHORT),
         "contextual": dict(contextual=True, **SHORT),
         "anchored": dict(anchor_kl=0.02, anchor_every=1, **SHORT)}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_learning_modes_run_with_jax_keys(mode):
    rounds = 2 if mode in ("full", "contextual") else 1
    report = torch_eval_learning.run_learning_eval(
        rounds=rounds, group_size=2, max_new_tokens=4, ppo_epochs=1,
        max_parallel=1, device="cpu", **MODES[mode])
    want = jax_report_keys("eval_learning.py", "run_learning_eval")
    if not MODES[mode].get("contextual"):
        want -= {"per_task_curve", "peak_window_mean", "conditioned",
                 "both_tasks_improved"}
    assert set(report) == want
    assert len(report["curve"]) == rounds
    assert all(-1.0 <= r <= 1.0 for r in report["curve"])
    assert report["config"]["lora_rank"] == MODES[mode].get("lora_rank", 0)
    assert isinstance(report["learned"], bool)
    assert len(report["training_health"]["rounds"]) == rounds


def test_qlora_requires_a_rank():
    with pytest.raises(ValueError, match="lora_rank"):
        torch_eval_learning.run_learning_eval(rounds=1, qlora=True,
                                              device="cpu")


def test_learning_script_runs_on_the_cpu(monkeypatch):
    """The CLI with --cpu (and --accel, which changes nothing)."""
    report = run_report(monkeypatch, "torch_eval_learning.py", "--rounds",
                        "1", "--group-size", "2", "--max-new-tokens", "4",
                        "--ppo-epochs", "1", "--short-prompt", "--accel",
                        "--cpu")
    assert report["rounds"] == 1
