"""The port's QLoRA quickstart (``examples/torch_qlora_quickstart.py``)
on the CPU, in this process, against the JAX one: it prints the JAX
example's marker, and from JAX's initial weights (carried across with
``params_from_numpy``) the same int8 and full byte counts and the same
trainable adapter count, exactly. The round's loss depends on the
engine's sampled tokens, which come from each framework's own generator,
so it is only required to be finite. A file of its own: the round trains
at 2048 positions and takes most of a minute on one CPU thread.
"""

import jax
import numpy as np
import pytest
import torch

import senweaver_ide_tpu_torch.models as port_models
from senweaver_ide_tpu_torch.models import params_from_numpy
from torch_examples_run import lines, run_example, skip_backoff, to_numpy


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


def test_qlora_quickstart_counts_match_jax(monkeypatch, capsys):
    from senweaver_ide_tpu.models import (get_config, init_params,
                                          quantize_weights_int8,
                                          quantized_bytes)
    from senweaver_ide_tpu.training import (lora_param_count,
                                            make_lora_train_state)
    cfg = get_config("tiny-test")
    full = init_params(cfg, jax.random.PRNGKey(0))
    base = quantize_weights_int8(full)
    lora = make_lora_train_state(cfg, base, jax.random.PRNGKey(1), rank=4,
                                 learning_rate=0.1).params
    want = (f"base: {quantized_bytes(base):,} bytes int8 (vs "
            f"{quantized_bytes(full):,} full) | trainable adapter params: "
            f"{lora_param_count(lora):,}")
    host = to_numpy(full)
    monkeypatch.setattr(
        port_models, "init_params",
        lambda config, generator, *, device: params_from_numpy(
            host, device=device))
    got = run_example(monkeypatch, capsys, "torch_qlora_quickstart.py",
                      "--rounds", "1", "--rank", "4", "--cpu")
    assert want in got.splitlines()
    assert "folded int8 policy" in got
    loss = float(lines(got, ("round 0:",))[0].split("loss=")[1])
    assert np.isfinite(loss)
