"""The comparison that decides ``correct`` fails what it must: the fp8
control in the program's place, and the timed path broken underneath in
each way the cells can break (a step that leaves its state unchanged,
half of the batch left out, a token altered where it is produced, a
token drawn from another row's distribution). On
the tiny model on the CPU; the same runs at the cells' own sizes were
made on the card (PERF.md)."""

from __future__ import annotations

import dataclasses

import pytest
import torch

from benchmark import core
from benchmark.tests import tiny
from benchmark.tests.test_bm_harness import CELLS, SEED, TINY_LIMITS


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bmc"),
                          limits={c: TINY_LIMITS for c in CELLS})


def _run(root, cell, control=None):
    res, readings = core.run(cell, SEED, 1.0, False, device="cpu",
                             control=control, root=root)
    return res, readings


@pytest.mark.parametrize("cell", CELLS)
def test_the_fp8_control_is_not_correct(root, cell):
    res, readings = _run(root, cell, control="fp8")
    assert not res["correct"], res["checks"]
    assert readings["control"] != readings["program"]


SERVING = [c for c in CELLS if "grpo" not in c]
TRAINING = [c for c in CELLS if "grpo" in c]


@pytest.mark.parametrize("cell", SERVING)
def test_a_token_altered_where_it_is_produced(root, cell, monkeypatch):
    from senweaver_ide_tpu_torch.rollout import engine as eng
    orig = eng._paged_fused_step

    def altered(*a, **k):
        tok, logp, pool = orig(*a, **k)
        return (tok + 1) % tiny.TINY["vocab_size"], logp, pool

    monkeypatch.setattr(eng, "_paged_fused_step", altered)
    res, readings = _run(root, cell)
    assert not res["correct"], readings


@pytest.mark.parametrize("cell", SERVING)
def test_a_token_sampled_from_another_row(root, cell, monkeypatch):
    """The token comes from another row's distribution while its recorded
    log-prob is its own row's: the log-prob gap cannot see it, the
    sampling check does."""
    from senweaver_ide_tpu_torch.rollout import engine as eng
    monkeypatch.setattr(eng, "sample_token", eng.sample_token)
    res, readings = _run(root, cell, control="wrong_row")
    assert not res["correct"], readings
    checks = res["checks"]
    assert checks["logp_gap"]["value"] <= checks["logp_gap"]["limit"]
    assert checks["sample_z"]["value"] > checks["sample_z"]["limit"]


@pytest.mark.parametrize("cell", SERVING)
def test_a_step_that_leaves_the_cache_unchanged(root, cell, monkeypatch):
    from senweaver_ide_tpu_torch.rollout import engine as eng
    orig = eng._paged_fused_step

    def no_writes(params, config, toks, tables, seq_row, positions,
                  write_block, write_off, pool, *a, **k):
        dropped = torch.full_like(write_block, pool.num_blocks)
        return orig(params, config, toks, tables, seq_row, positions,
                    dropped, write_off, pool, *a, **k)

    monkeypatch.setattr(eng, "_paged_fused_step", no_writes)
    res, readings = _run(root, cell)
    assert not res["correct"], readings


@pytest.mark.parametrize("cell", TRAINING)
def test_a_step_that_returns_its_state_unchanged(root, cell, monkeypatch):
    from senweaver_ide_tpu_torch.training import trainer
    orig = trainer.train_step

    def unchanged(state, *a, **k):
        copy = dataclasses.replace(
            state, params=trainer.clone_params(state.params),
            opt_state=dataclasses.replace(
                state.opt_state, mu=trainer.clone_params(state.opt_state.mu),
                nu=trainer.clone_params(state.opt_state.nu)))
        _, metrics = orig(copy, *a, **k)
        return state, metrics

    monkeypatch.setattr(trainer, "train_step", unchanged)
    res, readings = _run(root, cell)
    assert not res["correct"], readings
    assert readings["program"]["change_gap"] == pytest.approx(1.0)


@pytest.mark.parametrize("cell", TRAINING)
def test_half_of_the_batch_left_out(root, cell, monkeypatch):
    from senweaver_ide_tpu_torch.training import trainer
    orig = trainer.train_step

    def half(state, config, mesh, tokens, mask, rewards, gids, **k):
        h = tokens.shape[0] // 2
        return orig(state, config, mesh, tokens[:h], mask[:h], rewards[:h],
                    gids[:h], **k)

    monkeypatch.setattr(trainer, "train_step", half)
    res, readings = _run(root, cell)
    assert not res["correct"], readings
