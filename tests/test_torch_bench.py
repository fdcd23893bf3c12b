"""torch_bench.py (the port's counterpart of bench.py) against the JAX
version on the same weights.

The protocol cases decode greedily, so their counts (prefills, FLOPs
avoided, blocks, bytes per block, evictions, outputs_exact) are held
exactly against JAX's ``bench._measure_*`` at reduced knobs, both sides
on the JAX tiny-test PRNGKey(0) tree; their rates are not comparable
across frameworks. The decode rows sample at temperature 0.8 and are
held by their invariants (a positive rate, the timing stamp); main()'s
line by its keys, with the measures stubbed."""

import importlib.util
import json
import os
import runpy
import sys

import jax
import numpy as np
import pytest
import torch

from senweaver_ide_tpu.models import init_params as jax_init_params
from senweaver_ide_tpu.models import tiny_test as jax_tiny_test

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch_bench as tb  # noqa: E402


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


# one compile of the whole init instead of an eager compile per op
_jax_init = jax.jit(jax_init_params, static_argnums=0)


@pytest.fixture(scope="module")
def jbench():
    """The JAX bench.py as a module (its measures import JAX lazily)."""
    spec = importlib.util.spec_from_file_location(
        "bench_jax_reference", os.path.join(ROOT, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_params():
    """JAX's tiny-test PRNGKey(0) tree as numpy: the weights JAX's
    protocol cases draw for themselves."""
    return jax.tree_util.tree_map(np.asarray, jax.device_get(
        _jax_init(jax_tiny_test(), jax.random.PRNGKey(0))))


# case -> (reduced knobs, the keys that must equal JAX's)
PROTOCOL = {
    "prefix_fleet": (dict(n_replicas=2, prefix_len=16, n_requests=4),
                     ("replicas", "prefix_len", "prefix_prefills_lazy",
                      "prefix_prefills_broadcast", "prefills_avoided",
                      "prefill_flops_avoided")),
    "paged_vs_slots": (dict(num_slots=2, prompt_len=8, decode_tokens=4),
                       ("num_slots", "decode_tokens", "outputs_exact",
                        "kv_preemptions", "kv_blocks_total")),
    "group_rollout": (dict(group_size=2, prompt_len=8, decode_tokens=4),
                      ("group_size", "prompt_len", "outputs_exact",
                       "shared_prefills", "independent_prefills",
                       "prefill_tokens_avoided", "cow_copies")),
    # 2x over the bf16 pool: evictions and preemptions on that rung
    "kv_quant": (dict(num_requests=4, prefix_len=16, decode_tokens=12),
                 ("num_requests", "kv_bytes_budget", "bf16_blocks",
                  "int8_blocks", "evictions_bf16", "evictions_int8",
                  "preemptions_bf16", "preemptions_int8",
                  "pressure_events_bf16", "pressure_events_int8",
                  "token_match_rate", "bytes_per_block_bf16",
                  "bytes_per_block_int8")),
}


@pytest.mark.parametrize("case", sorted(PROTOCOL))
def test_protocol_case_counts_equal_jax(case, jbench, jax_params,
                                        monkeypatch):
    knobs, exact = PROTOCOL[case]
    # JAX's measures draw their weights through the package's init_params
    # (imported at call time): the jitted init gives the same values from
    # the same key, with one compile instead of one per eager op
    import senweaver_ide_tpu.models as jax_models
    monkeypatch.setattr(jax_models, "init_params", _jax_init)
    want = getattr(jbench, f"_measure_{case}")(**knobs)
    got = getattr(tb, f"_measure_{case}")(params=jax_params, device="cpu",
                                          **knobs)
    assert set(got) == set(want)
    assert {k: got[k] for k in exact} == {k: want[k] for k in exact}
    assert got.get("outputs_exact", True) is True
    if case == "kv_quant":
        assert got["pressure_events_bf16"] > got["pressure_events_int8"]
    assert case in tb.TIMINGS and tb.TIMINGS[case]["step_s"] > 0


def test_decode_rows_and_train_hold_their_invariants(jbench, monkeypatch):
    """The sampled decode rows (slope-timed scan over one timed run a
    length, per-step with the int8 KV cache and int8 weights) give
    positive rates and stamp their timing; the int8 serving tree has
    JAX's keys, shapes and dtypes; the train measure counts JAX's
    parameters."""
    monkeypatch.setattr(tb, "TIMED_ITERS", 1)
    assert tb._measure("tiny-test", 2, 16, 8, timing_key="t_scan",
                       device="cpu") > 0
    assert tb._measure_steps("tiny-test", 2, 16, 8, quantized=True,
                             weight_quant=True, timing_key="t_steps",
                             device="cpu") > 0
    assert {"t_scan", "t_steps"} <= set(tb.TIMINGS)
    cfg = jax_tiny_test()
    want = jax.tree_util.tree_map(
        lambda a: (tuple(a.shape), str(a.dtype)),
        jax.eval_shape(lambda k: jbench._init_int8_params(cfg, k),
                       jax.random.PRNGKey(0)))
    from senweaver_ide_tpu_torch.models import tiny_test
    got = tb._init_int8_params(tiny_test(), torch.Generator().manual_seed(0))
    got = {k: ({n: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
                for n, t in v.items()} if isinstance(v, dict)
               else (tuple(v.shape), str(v.dtype).replace("torch.", "")))
           for k, v in got.items()}
    assert got == want
    train = tb._measure_train("tiny-test", 2, 16, iters=1, device="cpu")
    assert train["n_params"] == sum(
        a.size for a in jax.tree_util.tree_leaves(jax.eval_shape(
            lambda k: jax_init_params(cfg, k), jax.random.PRNGKey(0))))
    assert train["tokens_per_sec"] > 0 and "mfu" not in train


def test_main_prints_the_jax_line(monkeypatch, capsys):
    """main --cpu prints one JSON line under JAX's metric name and unit,
    with JAX's extra keys less the artifact summaries and plus the
    device; the measures are stubbed here."""
    monkeypatch.setattr(tb, "_measure", lambda *a, **k: 120.0)
    monkeypatch.setattr(tb, "_measure_train", lambda *a, **k: {"x": 1})
    for name in ("prefix_fleet", "paged_vs_slots", "kv_pressure",
                 "kv_quant", "spec_adaptive", "multi_lora",
                 "group_rollout", "fleet_remote", "learner_publish",
                 "streaming_grpo"):
        monkeypatch.setattr(tb, f"_measure_{name}", lambda **k: {"x": 1})
    tb.main(["--cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line["metric"] == \
        "decode_tokens_per_sec_per_chip[tiny-test,b8,p512]"
    assert line["unit"] == "tokens/sec/chip" and line["value"] == 120.0
    assert line["vs_baseline"] == round(120.0 / tb._baseline(), 3)
    assert set(line["extra"]) == {
        "train_tiny", "prefix_fleet", "paged_vs_slots", "kv_pressure",
        "kv_quant", "spec_adaptive", "multi_lora", "group_rollout",
        "fleet_remote", "learner_publish", "streaming_grpo", "timing",
        "device"}
    assert line["extra"]["device"] == {"platform": "cpu"}
    assert line["extra"]["streaming_grpo"]["accel_tunnel_reachable"] is False


def test_bench_refuses_without_a_card(monkeypatch, capsys):
    """With no card and no --cpu the script raises, naming CUDA, and
    prints no line: nothing replayed, nothing measured on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = os.path.join(ROOT, "torch_bench.py")
    monkeypatch.setattr(sys, "argv", [path])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        runpy.run_path(path, run_name="__main__")
    assert capsys.readouterr().out == ""


def test_a_failing_case_raises(monkeypatch, capsys):
    """A case that fails raises out of main (no error string in the
    line, no cache): the script exits non-zero with the traceback."""
    monkeypatch.setattr(tb, "_measure", lambda *a, **k: 120.0)

    def broken(*a, **k):
        raise ValueError("broken case")
    monkeypatch.setattr(tb, "_measure_train", broken)
    with pytest.raises(ValueError, match="broken case"):
        tb.main(["--cpu"])
    assert capsys.readouterr().out == ""


def test_streaming_arm_ends_when_groups_land_together(monkeypatch):
    """A streaming step trains every group ready by then, so a slow
    learner takes two groups in one step; the arm counts trained
    episodes and ends (a loop of n_rounds steps, as JAX's arm runs,
    would wait forever for steps that never come)."""
    import time as _time

    from senweaver_ide_tpu_torch.serve import StreamingLearnerService
    real = StreamingLearnerService.run_step
    sizes, idle = [], [0]

    def slow_step(self):
        if self.queue.stats()["ready_groups"]:
            _time.sleep(0.05)           # a slow learner: groups pile up
        res = real(self)
        if res is not None:
            sizes.append(res["episodes"])
            idle[0] = 0
        else:
            idle[0] += 1                # an arm waiting for nothing
            assert idle[0] < 4000, "the arm waits for a step that never comes"
        return res
    monkeypatch.setattr(StreamingLearnerService, "run_step", slow_step)
    out = tb._measure_streaming_grpo(n_rounds=3, group_size=4,
                                     decode_tokens=2, remote_rtt_s=0.0,
                                     device="cpu")
    assert out["episode_budget_per_arm"] == 16
    assert sum(sizes) == 2 * 16 and max(sizes) > 4
