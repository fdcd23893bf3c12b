"""torch_eval_sevenb.py against eval_sevenb.py: the sizing table's byte
counts equal JAX's key for key (the budget is the card's own memory, so
``card`` / ``hbm_gb`` / ``fits_card`` and the decode slots are the port's,
None on the CPU, where JAX has its 16 GB TPU figures); the layer-streamed
int8 init equals JAX's bit for bit (values, scales, the bf16 embedding)
at DeepSeek-Coder-6.7B's width with one layer and a 4096-entry
vocabulary; the script serves and takes its QLoRA step on a small
LLaMA-shaped config on the CPU."""

import dataclasses

import jax  # noqa: F401  (test files import both frameworks)
import numpy as np
import pytest
import torch

from torch_eval_helpers import (jax_report_keys, one_torch_thread,  # noqa
                                run_report)

import eval_sevenb as J
import torch_eval_sevenb as T
from senweaver_ide_tpu.models import get_config as jax_config
from senweaver_ide_tpu.models.config import ModelConfig as JaxModelConfig
from senweaver_ide_tpu_torch.models import get_config as port_config
from senweaver_ide_tpu_torch.models.config import ModelConfig

BUDGET_KEYS = {"card", "hbm_gb", "fits_card", "decode_slots_at_4k"}


def _small(model_config):
    """tests/test_sevenb.py's small LLaMA-shaped config."""
    return model_config(
        name="sevenb-slice-test", vocab_size=512, hidden_size=64,
        intermediate_size=160, num_layers=2, num_heads=4, num_kv_heads=4,
        head_dim=16, max_seq_len=512, kv_quant=True)


@pytest.mark.parametrize("which", ["deepseek-coder-6.7b", "small"])
def test_sizing_table_byte_counts_equal_jax(which):
    if which == "small":
        jc, tc = _small(JaxModelConfig), _small(ModelConfig)
    else:
        jc, tc = jax_config(which), port_config(which)
    want, got = J.sizing_table(jc), T.sizing_table(tc, device="cpu")
    assert set(got) - BUDGET_KEYS == set(want) - {"fits_16gb",
                                                  "decode_slots_at_4k"}
    for k in set(got) - BUDGET_KEYS:
        assert got[k] == want[k], k
    assert all(got[k] is None for k in BUDGET_KEYS)


def test_sizing_table_against_a_card(monkeypatch):
    """On a card the plans are held to its memory (an 80 GB stand-in)."""
    class Props:
        name, total_memory = "stand-in card", 80 * 1024 ** 3
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda _d: Props)
    got = T.sizing_table(port_config("deepseek-coder-6.7b"))
    assert got["card"] == "stand-in card" and got["hbm_gb"] == 80.0
    assert got["fits_card"]["qlora_int8_base"]
    assert got["fits_card"]["serve_int8"]
    assert got["decode_slots_at_4k"]["serve_int8_int8kv"] > 0


def test_streamed_int8_init_equals_jax_bit_for_bit():
    over = dict(num_layers=1, vocab_size=4096)
    jc = dataclasses.replace(jax_config("deepseek-coder-6.7b"), **over)
    tc = dataclasses.replace(port_config("deepseek-coder-6.7b"), **over)
    want = J.streamed_int8_init(jc, seed=3)
    got = T.streamed_int8_init(tc, seed=3, device="cpu")
    assert sorted(got["layers"]) == sorted(want["layers"])
    for k, w in want["layers"].items():
        g = got["layers"][k]
        w = np.asarray(w)
        if g.dtype == torch.bfloat16:
            assert np.array_equal(g.view(torch.int16).numpy(),
                                  w.view(np.int16)), k
        else:
            assert g.numpy().dtype == w.dtype and np.array_equal(
                g.numpy(), w), k
    for k in ("lm_head", "lm_head_scale"):
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
    for k in ("embed", "final_norm"):
        assert np.array_equal(got[k].view(torch.int16).numpy(),
                              np.asarray(want[k]).view(np.int16)), k


def test_script_serves_and_steps_on_a_small_config(monkeypatch):
    """The script's whole path on the CPU at a small LLaMA-shaped config
    (its get_config patched): sizing, the streamed init, the specs, the
    int8 serve through the paged int8 pool and the QLoRA step."""
    import senweaver_ide_tpu_torch.models as models
    monkeypatch.setattr(models, "get_config", lambda n: _small(ModelConfig))
    report = run_report(monkeypatch, "torch_eval_sevenb.py",
                        "--update-step", "--update-seq", "32", "--cpu")
    assert set(report) == jax_report_keys("eval_sevenb.py", "main") | {
        "peak_cuda_gb"}
    assert report["int8_init"]["is_quantized"]
    dec = report["cpu_decode"]
    assert dec["tokens_out"] == 4
    assert dec["engine_stats"]["weight_quant"] == 1
    assert dec["engine_stats"]["kv_paged"] == 1
    upd = report["qlora_update"]
    assert upd["batch_shape"] == [2, 32]
    assert np.isfinite(upd["loss"]) and upd["grad_norm"] > 0
    assert report["sharding"]["leaves_with_specs"] > 20
