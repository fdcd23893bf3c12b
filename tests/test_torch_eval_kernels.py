"""torch_eval_flash_chip.py and torch_eval_onepointfiveb.py on the CPU.

The flash eval's sections 1-2 go through the kernels' plain versions
here (the wrappers on CPU tensors) and are held against JAX's
``ops.attention`` reference on the same inputs at the eval's 3e-2;
sections 3-4 run at tiny-test's shape for their structure (the 1.5B
shape runs on the card in chip_smoke.py's phase_eval). The 1.5B GRPO
round's script runs with ``--model tiny-test`` in both modes and
reports JAX's keys plus peak CUDA memory."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_eval_helpers import (jax_report_keys, one_torch_thread,  # noqa
                                run_report, run_script)

import torch_eval_flash_chip as F
from senweaver_ide_tpu.ops.attention import attention as jax_attention
from senweaver_ide_tpu_torch.models import get_config

CPU = torch.device("cpu")


def _jnp(t):
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def test_attention_section_against_jax_reference():
    q, k, v = F.attention_inputs(CPU)
    from senweaver_ide_tpu_torch.ops.flash_attention import flash_attention
    got = flash_attention(q, k, v, causal=True).float().numpy()
    want = np.asarray(jax_attention(_jnp(q), _jnp(k), _jnp(v), causal=True),
                      np.float32)
    assert np.abs(got - want).max() < F.PARITY_TOL


@pytest.mark.parametrize("hq,hkv", F.DECODE_HEADS)
def test_decode_section_against_jax_reference(hq, hkv):
    from senweaver_ide_tpu_torch.ops.flash_decode import flash_decode
    q, kc, vc, lengths = F.decode_inputs(CPU, hq, hkv)
    got = flash_decode(q, kc, vc, lengths, block_kv=128).float().numpy()
    lens = jnp.asarray(lengths.numpy())
    want = np.asarray(jax_attention(_jnp(q), _jnp(kc), _jnp(vc),
                                    q_offset=lens - 1, causal=True),
                      np.float32)
    assert np.abs(got - want).max() < F.PARITY_TOL


def test_kernel_parity_keys_and_flags():
    out = F.kernel_parity(CPU)
    want = {"flash_attention_lowered_s", "flash_attention_parity_max_err",
            "flash_attention_ok"}
    for hq, hkv in F.DECODE_HEADS:
        want |= {f"flash_decode_parity_hq{hq}_hkv{hkv}",
                 f"flash_decode_ok_hq{hq}_hkv{hkv}"}
    assert set(out) == want
    assert all(v for k, v in out.items() if "_ok" in k)


def test_benches_at_tiny_shape():
    base = get_config("tiny-test")
    fwd = F.forward_bench(base, CPU, s_long=64)
    assert set(fwd) == {"fwd4k_einsum_ms", "fwd4k_flash_ms",
                        "fwd4k_flash_speedup"}
    assert fwd["fwd4k_einsum_ms"] > 0 and fwd["fwd4k_flash_ms"] > 0
    rate = F._decode_rate(base, 2, 8, 2, 12, 64, CPU)
    assert rate > 0


def test_main_writes_its_file_and_keys(monkeypatch, tmp_path):
    """main() on the CPU (the benches at tiny-test's shape, the decode
    slope stubbed): JAX's keys but interpret_mode and lowered_on_tpu,
    which become the card's name, its power limit and kernels_ok; the
    JSON lands in OUT_PATH."""
    import senweaver_ide_tpu_torch.models as models
    monkeypatch.setattr(models, "get_config",
                        lambda name: get_config("tiny-test"))
    bench = F.forward_bench
    monkeypatch.setattr(F, "forward_bench",
                        lambda base, dev: bench(base, dev, s_long=64))
    monkeypatch.setattr(F, "decode_bench",
                        lambda base, dev: {"decode_einsum_tok_s": 1.0,
                                           "decode_flash_tok_s": 1.0,
                                           "decode_flash_speedup": 1.0})
    monkeypatch.setattr(F, "OUT_PATH", str(tmp_path / "FLASH_torch.json"))
    out = F.main(["--cpu"])
    want = jax_report_keys("eval_flash_chip.py", "main", var="out") - {
        "interpret_mode", "lowered_on_tpu", "decode_bench_error",
        "fwd_bench_error"}
    want |= {"card", "power_limit", "kernels_ok"}
    assert set(out) - {k for k in out if "hq" in k} == {
        k for k in want if "hq" not in k}
    assert out["kernels_ok"] and out["card"] is None
    assert (tmp_path / "FLASH_torch.json").is_file()


def test_a_failing_section_raises(monkeypatch, tmp_path):
    """JAX's script catches sections 3-4 into *_error keys; the port lets
    them raise and writes no file."""
    def broken(base, dev):
        raise RuntimeError("slope not positive")
    monkeypatch.setattr(F, "decode_bench", broken)
    monkeypatch.setattr(F, "OUT_PATH", str(tmp_path / "FLASH_torch.json"))
    with pytest.raises(RuntimeError, match="slope"):
        F.main(["--cpu"])
    assert not (tmp_path / "FLASH_torch.json").exists()


@pytest.mark.parametrize("mode", ["full", "qlora"])
def test_onepointfiveb_round_at_tiny_shape(monkeypatch, mode):
    report = run_report(monkeypatch, "torch_eval_onepointfiveb.py",
                        "--model", "tiny-test", "--mode", mode, "--cpu")
    assert set(report) == jax_report_keys("eval_onepointfiveb.py",
                                          "main") | {"peak_cuda_gb"}
    assert report["peak_cuda_gb"] is None
    train = report["phases"]["train"]
    assert len(train["losses"]) == 2 and train["update_signal"]
    assert all(np.isfinite(train["losses"] + train["grad_norms"]))
    roll = report["phases"]["rollout"]
    assert roll["episodes"] == 4 and roll["tokens_sampled"] == 32
    assert all(-1.0 <= r <= 1.0 for r in roll["rewards"])
    assert ("quantize" in report["phases"]) == (mode == "qlora")


def test_onepointfiveb_error_line(monkeypatch):
    code, out = run_script(monkeypatch, "torch_eval_onepointfiveb.py",
                           "--model", "no-such-model", "--cpu")
    assert code == 1 and '"error"' in out
