"""The port's train-state checkpoints (``training/checkpoint.py``),
mirroring ``tests/test_checkpoint.py``'s train-state cases on the CPU.

- Save → restore is bit-identical: params, both AdamW moments, the
  optimizer's count and the step, each on the template's device; the
  state file is a plain safetensors file (``safetensors`` reads it).
- A restored state's next ``train_step`` equals the uninterrupted run's
  bit for bit (deterministic resume).
- ``keep_last`` GC, torn step dirs (no ``meta.json``) reclaimed without
  evicting complete ones and invisible to ``latest_step``, the errors for
  an empty root and a missing step, and a template that does not match.
- An adapter-only (LoRA) state round-trips and trains on.
"""

import dataclasses

import numpy as np
import pytest
import safetensors.numpy as stnp
import torch

from senweaver_ide_tpu_torch.models import init_params, tiny_test
from senweaver_ide_tpu_torch.training import (CheckpointManager,
                                              make_lora_train_state,
                                              make_train_state, train_step)
from senweaver_ide_tpu_torch.training.checkpoint import STATE_FILE
from senweaver_ide_tpu_torch.training.trainer import flatten_params


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


def _state(seed=0):
    cfg = tiny_test()
    return cfg, make_train_state(cfg, torch.Generator().manual_seed(seed),
                                 None, learning_rate=1e-3, device="cpu")


def _batch():
    b, s = 4, 16
    return (torch.ones((b, s), dtype=torch.long),
            torch.ones((b, s), dtype=torch.bool),
            torch.linspace(-1, 1, b), torch.zeros((b,), dtype=torch.long))


def _advance(cfg, state, steps=1, **kw):
    for _ in range(steps):
        state, _ = train_step(state, cfg, None, *_batch(), **kw)
    return state


def _copy(state):
    """A deep copy: train_step writes params and moments in place."""
    clone = lambda tree: {k: clone(v) if isinstance(v, dict)  # noqa: E731
                          else v.clone() for k, v in tree.items()}
    return dataclasses.replace(
        state, params=clone(state.params),
        opt_state=dataclasses.replace(state.opt_state,
                                      mu=clone(state.opt_state.mu),
                                      nu=clone(state.opt_state.nu)))


def assert_states_equal(a, b):
    assert int(a.step) == int(b.step)
    assert a.opt_state.count == b.opt_state.count
    for ta, tb in ((a.params, b.params), (a.opt_state.mu, b.opt_state.mu),
                   (a.opt_state.nu, b.opt_state.nu)):
        fa, fb = dict(flatten_params(ta)), dict(flatten_params(tb))
        assert sorted(fa) == sorted(fb)
        for k in fa:
            assert fa[k].dtype == fb[k].dtype and fa[k].device == \
                fb[k].device, k
            assert torch.equal(fa[k], fb[k]), k


def test_save_restore_roundtrip(tmp_path):
    cfg, state0 = _state()
    template = _copy(state0)
    state1 = _advance(cfg, state0, 2)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    step_dir = mgr.save(state1, data_cursor=128, extra_meta={"tag": "x"})
    restored, meta = mgr.restore(template)
    assert meta["data_cursor"] == 128 and meta["tag"] == "x"
    assert meta["step"] == 2 and meta["format"] == "safetensors"
    assert restored.opt is template.opt
    assert_states_equal(restored, state1)
    # the restored tensors are new ones, not the template's
    assert restored.params["embed"].data_ptr() != \
        template.params["embed"].data_ptr()
    # a plain safetensors file, readable without the port
    raw = stnp.load_file(f"{step_dir}/{STATE_FILE}")
    assert int(raw["step"]) == 2 and int(raw["count"]) == 2
    np.testing.assert_array_equal(raw["params/layers/wq"],
                                  state1.params["layers"]["wq"].numpy())
    np.testing.assert_array_equal(raw["nu/embed"],
                                  state1.opt_state.nu["embed"].numpy())


def test_resume_continues_identically(tmp_path):
    """save@N → restore → step == just stepping (deterministic resume)."""
    cfg, state0 = _state()
    template = _copy(state0)
    s_n = _advance(cfg, state0, 2)
    mgr = CheckpointManager(str(tmp_path / "ck2"))
    mgr.save(s_n)
    restored, _ = mgr.restore(template)
    a = _advance(cfg, s_n, 1)
    b = _advance(cfg, restored, 1)
    assert_states_equal(a, b)


def test_gc_keeps_last(tmp_path):
    cfg, state = _state()
    mgr = CheckpointManager(str(tmp_path / "ck3"), keep_last=2)
    for _ in range(4):
        state = _advance(cfg, state, 1)
        mgr.save(state)
    steps = sorted(int(p.name.split("_")[1])
                   for p in (tmp_path / "ck3").iterdir()
                   if p.name.startswith("step_"))
    assert steps == [3, 4]
    assert mgr.latest_step() == 4


def test_gc_reclaims_torn_dirs_without_evicting_complete(tmp_path):
    cfg, state0 = _state()
    template = _copy(state0)
    mgr = CheckpointManager(str(tmp_path / "ck4"), keep_last=2)
    s1 = _advance(cfg, state0, 1)
    mgr.save(s1)
    s2 = _advance(cfg, s1, 1)
    mgr.save(s2)
    root = tmp_path / "ck4"
    (root / "step_0").mkdir()                      # torn, old
    (root / "step_0" / STATE_FILE).write_bytes(b"torn")
    (root / "step_9").mkdir()                      # torn, newest
    (root / "step_9" / STATE_FILE).write_bytes(b"torn")
    assert mgr.latest_step() == 2                  # torn dirs invisible
    s3 = _advance(cfg, s2, 1)
    mgr.save(s3)                                   # triggers gc
    assert {p.name for p in root.iterdir()} == {"step_2", "step_3",
                                                "step_9"}
    restored, meta = mgr.restore(template)
    assert meta["step"] == 3 and int(restored.step) == 3


def test_latest_step_ignores_torn_dirs_and_missing_raises(tmp_path):
    _, state0 = _state()
    mgr = CheckpointManager(str(tmp_path / "ck5"))
    (tmp_path / "ck5" / "step_7").mkdir()          # no meta.json
    assert mgr.latest_step() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore(state0)
    with pytest.raises(FileNotFoundError, match="step 7"):
        mgr.restore(state0, step=7)
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(state0)


def test_restore_refuses_a_mismatched_template(tmp_path):
    cfg, state0 = _state()
    mgr = CheckpointManager(str(tmp_path / "ck6"))
    mgr.save(_advance(cfg, _copy(state0), 1))
    wide = make_train_state(
        dataclasses.replace(cfg, intermediate_size=cfg.intermediate_size * 2),
        torch.Generator().manual_seed(0), None, device="cpu")
    with pytest.raises(ValueError, match="w_down"):
        mgr.restore(wide)
    bf16 = dataclasses.replace(cfg, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bfloat16"):
        mgr.restore(make_train_state(bf16, torch.Generator().manual_seed(0),
                                     None, device="cpu"))


def test_lora_state_roundtrip(tmp_path):
    """Adapter-only states checkpoint and resume like any other."""
    cfg = tiny_test()
    base = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    state0 = make_lora_train_state(cfg, base, torch.Generator().manual_seed(1),
                                   rank=4, learning_rate=0.05)
    template = _copy(state0)
    state1 = _advance(cfg, state0, 1, lora_base=base)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(state1)
    restored, _ = mgr.restore(template)
    assert int(restored.step) == 1
    assert_states_equal(restored, state1)
    state2, metrics = train_step(restored, cfg, None, *_batch(),
                                 lora_base=base)
    assert torch.isfinite(metrics["loss"])
    assert int(state2.step) == 2
