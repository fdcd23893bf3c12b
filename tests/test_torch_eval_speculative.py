"""torch_eval_moe_int8.py and torch_eval_speculative.py against their JAX
scripts: the int8 MoE comparison and the speculative eval's numbers
before distillation come from JAX's own weights and equal JAX's within
1e-5, token ids exactly; the scripts run on the CPU with JAX's keys.
Stands in for
tests/test_speculative.py::test_eval_speculative_script_reports_gain."""

import jax
import pytest

from torch_eval_helpers import (carried, jax_report_keys,  # noqa: F401
                                no_backoff_sleep, one_torch_thread,
                                run_report)

import eval_moe_int8
import eval_speculative
import torch_eval_moe_int8
import torch_eval_speculative
from senweaver_ide_tpu.models import get_config as jax_config
from senweaver_ide_tpu.models import init_params as jax_init
from senweaver_ide_tpu.models.tokenizer import ByteTokenizer as JaxTok
from senweaver_ide_tpu_torch.models import get_config
from senweaver_ide_tpu_torch.models.tokenizer import ByteTokenizer


@pytest.fixture(scope="module")
def moe_weights():
    params = jax_init(jax_config("tiny-moe-test"), jax.random.PRNGKey(0))
    return params, carried(params)


def test_compare_int8_equals_jax_from_carried_weights(moe_weights,
                                                      monkeypatch):
    """JAX's forward jitted per shape (eager, it retraces its layer scan
    on every call)."""
    import senweaver_ide_tpu.models.transformer as jt
    monkeypatch.setattr(jt, "forward", jax.jit(jt.forward,
                                               static_argnums=(1,)))
    jp, tp = moe_weights
    want = eval_moe_int8.compare_int8(jp, jax_config("tiny-moe-test"),
                                      JaxTok(), decode_tokens=3)
    got = torch_eval_moe_int8.compare_int8(tp, get_config("tiny-moe-test"),
                                           ByteTokenizer(), decode_tokens=3)
    assert set(got) == set(want)
    assert got["argmax_agreement"] == pytest.approx(
        want["argmax_agreement"], abs=1e-5)
    assert got["relative_logit_error"] == pytest.approx(
        want["relative_logit_error"], abs=1e-5)
    for k in ("greedy_decode_tokens", "greedy_first_divergence",
              "greedy_exact_match"):
        assert got[k] == want[k], k


def test_train_tiny_moe_runs_the_real_stack():
    params, config, tok, curve = torch_eval_moe_int8.train_tiny_moe(
        rounds=1, group_size=4, max_new_tokens=4, device="cpu")
    assert len(curve) == 1 and -1.0 <= curve[0] <= 1.0
    assert params["layers"]["router"].ndim == 3
    m = torch_eval_moe_int8.compare_int8(params, config, tok,
                                         decode_tokens=4)
    assert 0.0 <= m["argmax_agreement"] <= 1.0


def test_moe_int8_script_keys(monkeypatch):
    report = run_report(monkeypatch, "torch_eval_moe_int8.py", "--rounds",
                        "1", "--cpu")
    assert set(report) == jax_report_keys("eval_moe_int8.py", "main")
    assert set(report["trained"]) == set(report["random_init_baseline"])


def _adopt_jax_inits(monkeypatch, calls):
    """The JAX eval's init_params records each tree; the port's returns
    the next recorded one as CPU tensors (target first, then draft)."""
    import senweaver_ide_tpu.models as jm
    import senweaver_ide_tpu_torch.models as tm
    real = jm.init_params

    def spy(config, key, *a, **kw):
        calls.append(real(config, key, *a, **kw))
        return calls[-1]
    monkeypatch.setattr(jm, "init_params", spy)
    taken = iter(range(2))
    monkeypatch.setattr(tm, "init_params",
                        lambda config, g, device=None: carried(
                            calls[next(taken)]))


def test_speculative_eval_equals_jax_before_distillation(monkeypatch):
    """From JAX's target and draft weights: the greedy outputs (every
    prompt's tokens), the acceptance and verify rounds before
    distillation and the first distillation loss equal JAX's; outputs
    stay exact after distillation on both sides."""
    calls = []
    _adopt_jax_inits(monkeypatch, calls)
    from senweaver_ide_tpu.rollout.speculative import \
        SpeculativeDecoder as JaxDecoder
    from senweaver_ide_tpu_torch.rollout.speculative import SpeculativeDecoder
    outs = {"jax": [], "port": []}
    for side, cls in (("jax", JaxDecoder), ("port", SpeculativeDecoder)):
        real = cls.generate

        def gen(self, *a, _real=real, _side=side, **kw):
            out = _real(self, *a, **kw)
            outs[_side].append(list(out))
            return out
        monkeypatch.setattr(cls, "generate", gen)
    kw = dict(n_prompts=1, max_new_tokens=8, k=4, distill_steps=1)
    want = eval_speculative.run_speculative_eval(**kw)
    got = torch_eval_speculative.run_speculative_eval(device="cpu", **kw)
    assert set(got) == set(want)
    assert outs["port"][:1] == outs["jax"][:1]
    for k in ("acceptance_before", "verify_rounds_before", "outputs_exact",
              "config"):
        assert got[k] == want[k], k
    assert got["distill_loss_first"] == pytest.approx(
        want["distill_loss_first"], abs=1e-5)
    assert got["outputs_exact"]


def test_speculative_script_reports_gain(monkeypatch):
    """The script at a short distillation: the draft learns, outputs stay
    exactly the target's (JAX's script test, on the port)."""
    report = run_report(monkeypatch, "torch_eval_speculative.py",
                        "--prompts", "4", "--distill-steps", "30", "--cpu")
    assert report["outputs_exact"]
    assert report["distill_loss_last"] < report["distill_loss_first"]
    assert report["acceptance_after"] > report["acceptance_before"]


def _host_speculative_decoder():
    import torch
    from senweaver_ide_tpu_torch.models import init_params
    from senweaver_ide_tpu_torch.rollout.speculative import \
        SpeculativeDecoder
    cfg = get_config("tiny-test")
    p = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    SpeculativeDecoder(p, cfg, p, cfg, k=2)


def _host_generate_scan():
    import torch
    from senweaver_ide_tpu_torch.models import init_params
    from senweaver_ide_tpu_torch.models.transformer import init_kv_cache
    from senweaver_ide_tpu_torch.rollout.sampler import generate_scan
    cfg = get_config("tiny-test")
    p = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    with torch.no_grad():
        generate_scan(p, cfg, torch.ones((1, 3), dtype=torch.int64),
                      init_kv_cache(cfg, 1, 8, device="cpu"),
                      max_new_tokens=2)


@pytest.mark.parametrize("run", [_host_speculative_decoder,
                                 _host_generate_scan],
                         ids=["speculative_decoder", "generate_scan"])
def test_smoke_ledger_sees_an_eval_on_the_host(capsys, run):
    """chip_smoke.py's entry ledger records the device of a speculative
    decoder's params (torch_eval_speculative.py builds no engine) and of
    a generate_scan decode (torch_eval_flash_chip.py's): either on the
    host fails the run, and the ledger puts both names back."""
    import importlib.util
    import os
    import types

    from senweaver_ide_tpu_torch.rollout import sampler
    from senweaver_ide_tpu_torch.rollout.speculative import \
        SpeculativeDecoder
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    before = (SpeculativeDecoder.__init__, sampler.generate_scan)
    no_card = types.SimpleNamespace(
        cuda=types.SimpleNamespace(synchronize=lambda: None))

    def entry():
        run()
        print("RAN")
    with pytest.raises(SystemExit) as e:
        smoke._entry_call(no_card, run.__name__, entry, "RAN")
    assert e.value.code == 1
    assert "tensors on ['cpu'], expected the card" in capsys.readouterr().err
    assert (SpeculativeDecoder.__init__, sampler.generate_scan) == before
