"""torch_eval_uplift.py and torch_eval_hf_roundtrip.py against their JAX
scripts on the CPU.

The scripted-policy uplift (deterministic policy, the reward head on the
CPU) equals JAX's scores within 1e-5 and picks the same rules; the
``--model-dir`` leg serves an HF-layout tiny checkpoint end to end (it
stands in for
tests/test_apo_eval.py::test_real_policy_uplift_path_end_to_end). The HF
round trip's leg 1 from JAX's own tiny weights gives the same parity
flags, prompt ids and greedy tokens as JAX's; without ``tokenizers`` the
script exits 1 with JAX's error line naming the package (the card's
machine lacks it, so this script runs here only)."""

import os
import sys

os.environ.setdefault("USE_TF", "0")    # transformers would import TF

import jax
import pytest
import torch

from torch_eval_helpers import (carried, no_backoff_sleep,  # noqa: F401
                                one_torch_thread, run_report, run_script)

import eval_hf_roundtrip as JH
import torch_eval_hf_roundtrip as TH
from senweaver_ide_tpu.apo import run_uplift_eval as jax_uplift
from senweaver_ide_tpu.apo.eval import SIX_PATTERN_TASKS


@pytest.fixture(autouse=True)
def jax_sleep_skipped(monkeypatch):
    from senweaver_ide_tpu.agents.loop import AgentLoop
    monkeypatch.setitem(AgentLoop.__init__.__kwdefaults__, "sleep",
                        lambda _s: None)


def test_scripted_uplift_equals_jax(monkeypatch, tmp_path):
    report = run_report(monkeypatch, "torch_eval_uplift.py", "--tasks",
                        "2", "--beam-rounds", "1", "--cpu")
    want = jax_uplift(str(tmp_path), tasks=tuple(SIX_PATTERN_TASKS[:2]),
                      beam_rounds=1)
    assert set(report) == set(want) | {"training_health"}
    for k in ("baseline_final_reward", "optimized_final_reward",
              "uplift_delta"):
        assert report[k] == pytest.approx(want[k], abs=1e-5), k
    assert report["optimized_rules"] == want["optimized_rules"]
    assert report["training_health"]["rounds"] == []


def test_model_dir_leg_end_to_end(monkeypatch, tmp_path):
    """The optimizer role's generations at 16 tokens (make_local_apo asks
    the real policy for 512)."""
    from senweaver_ide_tpu_torch.apo.local import make_local_apo
    from senweaver_ide_tpu_torch.models import get_config, init_params
    from senweaver_ide_tpu_torch.models.load import export_hf_params
    monkeypatch.setitem(make_local_apo.__kwdefaults__, "max_tokens", 16)
    cfg = get_config("tiny-test")
    export_hf_params(init_params(cfg, torch.Generator().manual_seed(7),
                                 device="cpu"), cfg, str(tmp_path / "ckpt"))
    report = run_report(monkeypatch, "torch_eval_uplift.py", "--model-dir",
                        str(tmp_path / "ckpt"), "--config", "tiny-test",
                        "--beam-rounds", "1", "--max-new-tokens", "8",
                        "--tasks", "1", "--engine-max-len", "2048", "--cpu")
    assert report["policy"]["config"] == "tiny-test"
    assert -1.0 <= report["baseline_final_reward"] <= 1.0


def test_hf_tokenizer_dir_is_real(tmp_path):
    from senweaver_ide_tpu_torch.models.tokenizer import HFTokenizer
    d = TH.build_hf_tokenizer_dir(str(tmp_path / "tok"))
    tok = HFTokenizer(d)
    ids = tok.encode("def main():", add_bos=True)
    assert ids[0] == tok.bos_id and tok.decode(ids) == "def main():"
    assert all(0 <= i < 512 for i in ids)


def test_roundtrip_leg1_equals_jax_from_carried_weights(tmp_path):
    from senweaver_ide_tpu.models import get_config as jax_config
    from senweaver_ide_tpu.models.transformer import init_params
    from senweaver_ide_tpu_torch.models import get_config
    jp = init_params(jax_config("tiny-test"), jax.random.PRNGKey(0))
    tok_dir = TH.build_hf_tokenizer_dir(str(tmp_path / "tok"))
    want = JH.roundtrip(jax_config("tiny-test"), jp, tok_dir=tok_dir,
                        label="t", decode_tokens=6)
    got = TH.roundtrip(get_config("tiny-test"), carried(jp),
                       tok_dir=tok_dir, label="t", decode_tokens=6)
    assert set(got) == set(want)
    assert got["params_exact_parity"] and got["decode_parity"]
    for k in ("params_exact_parity", "decode_parity", "hf_keys",
              "safetensors", "tokenizer", "decoded_text", "decode_tokens",
              "config", "param_mismatches"):
        assert got[k] == want[k], k


def test_missing_tokenizers_exits_with_jax_error_line(monkeypatch):
    monkeypatch.setitem(sys.modules, "tokenizers", None)
    code, out = run_script(monkeypatch, "torch_eval_hf_roundtrip.py",
                           "--cpu")
    assert code == 1
    assert out.strip().splitlines()[-1].startswith('{"error": ')
    assert "tokenizers" in out
