"""The port's quickstarts (``examples/torch_*.py``) on the CPU, in this
process, against the JAX ones (``examples/*.py``, held runnable by
``tests/test_examples.py``).

Each port example runs as ``__main__`` with ``--cpu`` and
``tests/test_examples.py``'s arguments and must print the JAX example's
marker. The scripted policy's rewards do not depend on the weights: the
lines ``torch_train_grpo.py`` and ``torch_online_cycle.py`` print about
them equal the JAX example's, run here through the JAX package. The
numbers that depend on the weights come from JAX's initial weights
carried across with ``params_from_numpy``: the GRPO round's loss and
grad norm within 1e-5. (``tests/test_torch_qlora_example.py`` has the
QLoRA quickstart.) Last, a rehearsal of ``chip_smoke.py``'s entry
ledger: a batch scored on the host through any of the head's importers
must fail its device check.

The agent loop's retry backoffs sleep tens of seconds on the scripted
policy's failing patterns; both sides skip them here.
"""

import importlib.util
import os
import types

import pytest
import torch

import senweaver_ide_tpu.training as jax_training
import senweaver_ide_tpu_torch.training as port_training
from torch_examples_run import (adopt, lines, run_example, skip_backoff,
                                spy, to_numpy)


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
def _no_backoff_sleep(monkeypatch):
    skip_backoff(monkeypatch)


def test_serve_example(monkeypatch, capsys):
    out = run_example(monkeypatch, capsys, "torch_serve.py", "--cpu",
                      "--max-new-tokens", "8")
    # sampled eos can end decode early; count is <= the budget
    assert "[tiny-test]" in out and "tokens:" in out
    n = int(out.split("[tiny-test]")[1].split()[0])
    assert 0 < n <= 8


def test_train_grpo_example_matches_jax(monkeypatch, capsys):
    states, rounds = [], []
    spy(monkeypatch, jax_training, "make_train_state", states)
    spy(monkeypatch, jax_training, "grpo_round", rounds)
    want = run_example(monkeypatch, capsys, "train_grpo.py")
    assert "GRPO ROUND OK" in want and len(rounds) == 1
    adopt(monkeypatch, to_numpy(states[0].params))
    port_rounds = []
    spy(monkeypatch, port_training, "grpo_round", port_rounds)
    got = run_example(monkeypatch, capsys, "torch_train_grpo.py", "--cpu")
    assert "GRPO ROUND OK" in got
    assert lines(got, ("episodes:",)) == lines(want, ("episodes:",))
    jm, tm = rounds[0].metrics, port_rounds[0].metrics
    for k in ("loss", "grad_norm"):
        assert abs(float(tm[k]) - float(jm[k])) <= 1e-5, (k, tm[k], jm[k])
    assert int(port_rounds[0].state.step) == int(rounds[0].state.step) == 1


def test_online_cycle_example_matches_jax(monkeypatch, capsys):
    states = []
    spy(monkeypatch, jax_training, "make_train_state", states)
    want = run_example(monkeypatch, capsys, "online_cycle.py", "--rounds",
                       "2")
    assert "ONLINE CYCLE OK" in want
    adopt(monkeypatch, to_numpy(states[0].params))
    got = run_example(monkeypatch, capsys, "torch_online_cycle.py",
                      "--rounds", "2", "--cpu")
    assert "ONLINE CYCLE OK" in got
    keep = ("round ", "optimized rules:")
    assert len(lines(want, keep)) == 3
    assert lines(got, keep) == lines(want, keep)


def test_control_plane_example(monkeypatch, capsys):
    from senweaver_ide_tpu_torch.runtime.native import ctl_binary_path
    if ctl_binary_path() is None:
        pytest.skip("senweaver-ctl not built (no C++ toolchain)")
    out = run_example(monkeypatch, capsys, "torch_control_plane.py",
                      "--cpu")
    assert "JOBS SESSION OK" in out
    assert "-> done" in out and "eval_rules finalReward:" in out


def test_dashboard_demo_example(monkeypatch, capsys):
    out = run_example(monkeypatch, capsys, "torch_dashboard_demo.py",
                      "--once", "--cpu")
    assert "DASHBOARD STATE OK" in out


# One reward-head call on the host, through each name a scorer reaches it
# by: score_trace's head, the ProfiledFunction batch scorer that
# score_traces uses, and that object as apo.eval (evaluate_rules) and
# apo.beam imported it.
HOST_SCORERS = {
    "rewards.head.reward_head": "head.reward_head(feats[0])",
    "rewards.head.reward_head_batch": "head.reward_head_batch(feats)",
    "apo.eval.reward_head_batch": "apo_eval.reward_head_batch(feats)",
    "apo.beam.reward_head_batch": "apo_beam.reward_head_batch(feats)",
}


@pytest.mark.parametrize("scorer", sorted(HOST_SCORERS))
def test_entry_ledger_catches_a_host_scored_batch(tmp_path, capsys,
                                                  scorer):
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from senweaver_ide_tpu_torch.apo import beam, eval as apo_eval
    from senweaver_ide_tpu_torch.models import transformer
    from senweaver_ide_tpu_torch.rewards import head
    before = (head.reward_head, head.reward_head_batch._fn,
              transformer.paged_flash_decode)
    script = tmp_path / "entry.py"
    script.write_text(
        "import torch\n"
        "from senweaver_ide_tpu_torch.apo import beam as apo_beam\n"
        "from senweaver_ide_tpu_torch.apo import eval as apo_eval\n"
        "from senweaver_ide_tpu_torch.rewards import head\n"
        "from senweaver_ide_tpu_torch.traces.features import N_FEATURES\n"
        "feats = torch.zeros(2, N_FEATURES)\n"
        f"{HOST_SCORERS[scorer]}\n"
        "print('SCORED')\n")
    no_card = types.SimpleNamespace(
        cuda=types.SimpleNamespace(synchronize=lambda: None))
    with pytest.raises(SystemExit) as e:
        smoke._entry_run(no_card, scorer, str(script), [], "SCORED")
    assert e.value.code == 1
    assert "tensors on ['cpu'], expected the card" in capsys.readouterr().err
    assert (head.reward_head, head.reward_head_batch._fn,
            transformer.paged_flash_decode) == before
    assert apo_eval.reward_head_batch is beam.reward_head_batch is \
        head.reward_head_batch
