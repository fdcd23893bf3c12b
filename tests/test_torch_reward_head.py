"""The port's 9-dimension reward head against the JAX head (jitted,
``jax.vmap`` for batches) and the pure-Python oracle
``rewards/reference_impl.py`` (the port's copy scores the port's traces,
and on the boundary fixtures equals the JAX package's): on the boundary
fixtures of ``tests/test_reward_head.py`` and on 512 seeded random
feature rows in both chat modes. Dims and presence mask must equal the
JAX head's exactly; final rewards agree within 1e-6 (XLA's CPU code fuses
the weighted sum's multiply-adds, so the last bit of the f32 sum may
differ). Against the f64 oracle every value agrees within 1e-6, the
tolerance of the JAX package's own golden tests."""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from senweaver_ide_tpu import obs as jobs
from senweaver_ide_tpu.rewards import head as jhead
from senweaver_ide_tpu.rewards import reference_impl as jref
from senweaver_ide_tpu.traces import TraceCollector as JaxCollector
from senweaver_ide_tpu.traces import features as jfeat
from senweaver_ide_tpu_torch import obs
from senweaver_ide_tpu_torch.rewards import (DIM_NAMES, N_DIMS, reward_head,
                                             reward_head_batch, score_trace,
                                             score_traces)
from senweaver_ide_tpu_torch.rewards.reference_impl import \
    compute_reward_signals
from senweaver_ide_tpu_torch.traces.schema import SpanType
from senweaver_ide_tpu_torch.traces import TraceCollector, batch_features
from senweaver_ide_tpu_torch.traces import features as tfeat
from test_reward_head import BOUNDARY_CASES

FINAL_TOL = 1e-6
REF_TOL = 1e-6
N_RANDOM = 512

_jax_batch = jax.jit(jax.vmap(jhead.reward_head))


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


@pytest.fixture(autouse=True)
def _fresh_obs():
    obs._reset_for_tests()
    jobs._reset_for_tests()
    yield


def _mk_trace(collector, *, mode="normal", feedback=None, ended=True,
              errors=False, tool_ok=0, tool_fail=0, tool_dur=0.0,
              llm_calls=0, tokens=0, user_msgs=0, asst_msgs=0):
    """``tests/test_reward_head.py::_mk_trace`` over either package's
    collector (both have the same API)."""
    c, tid = collector, "t"
    c.start_trace(tid, metadata={"chatMode": mode})
    for i in range(user_msgs):
        c.record_user_message(tid, i, f"user {i}")
    for i in range(asst_msgs):
        c.record_assistant_message(tid, i, f"asst {i}")
    for ok, n, name in ((True, tool_ok, "read_file"),
                        (False, tool_fail, "run_command")):
        for _ in range(n):
            c.record_tool_call(tid, 0, tool_name=name, tool_success=ok,
                               duration_ms=tool_dur
                               / max(tool_ok + tool_fail, 1))
    for _ in range(llm_calls):
        c.record_llm_call(tid, 0, input_tokens=tokens // max(llm_calls, 1)
                          // 2,
                          output_tokens=tokens // max(llm_calls, 1)
                          - tokens // max(llm_calls, 1) // 2)
    if errors:
        c.record_error(tid, 0, "boom")
    if feedback:
        c.record_user_feedback(tid, 0, feedback)
    tr = c.get_all_traces()[0]
    if ended:
        c.end_trace(tr.id)
    else:
        tr.end_time = None
    return tr


def _case_kwargs(case):
    mode, fb, ended, errs, ok, fail, dur, llm, tok, u, a = case
    return dict(mode=mode, feedback=fb, ended=ended, errors=errs,
                tool_ok=ok, tool_fail=fail, tool_dur=dur, llm_calls=llm,
                tokens=tok, user_msgs=u, asst_msgs=a)


def _dims(trace):
    return {d["name"]: d["value"] for d in trace.summary.reward_dimensions}


@pytest.mark.parametrize("case", BOUNDARY_CASES,
                         ids=range(len(BOUNDARY_CASES)))
def test_boundary_fixtures_match_jax_and_reference(case):
    kw = _case_kwargs(case)
    jtr = _mk_trace(JaxCollector(), **kw)      # scored by the JAX head
    ttr = _mk_trace(TraceCollector(reward_fn=functools.partial(
        score_trace, device="cpu")), **kw)
    np.testing.assert_array_equal(tfeat.trace_features(ttr),
                                  jfeat.trace_features(jtr))
    # score_trace writes the JAX head's reward_dimensions
    assert _dims(ttr) == _dims(jtr)
    assert ttr.summary.final_reward == pytest.approx(
        jtr.summary.final_reward, abs=FINAL_TOL)
    ref_dims, ref_final = compute_reward_signals(ttr)
    assert (ref_dims, ref_final) == jref.compute_reward_signals(jtr)
    want = {d["name"]: d["value"] for d in ref_dims}
    assert set(_dims(ttr)) == set(want)
    for name, v in want.items():
        assert _dims(ttr)[name] == pytest.approx(v, abs=REF_TOL), name
    assert ttr.summary.final_reward == pytest.approx(ref_final, abs=REF_TOL)


def _random_rows(seed=0, n=N_RANDOM):
    """Consistent feature rows (ok + fail = calls), both chat modes."""
    rng = np.random.default_rng(seed)
    f = np.zeros((n, tfeat.N_FEATURES), np.float32)
    calls = rng.integers(0, 32, n) * (rng.random(n) < 0.8)
    ok = np.minimum(calls, rng.integers(0, 32, n))
    f[:, tfeat.F_FEEDBACK] = rng.choice([-1.0, 0.0, 1.0], n)
    f[:, tfeat.F_ENDED] = rng.integers(0, 2, n)
    f[:, tfeat.F_HAS_ERRORS] = rng.integers(0, 2, n)
    f[:, tfeat.F_TOOL_CALLS] = calls
    f[:, tfeat.F_TOOL_OK] = ok
    f[:, tfeat.F_TOOL_FAIL] = calls - ok
    f[:, tfeat.F_TOOL_DURATION_MS] = (rng.uniform(0, 4e5, n)
                                      * (rng.random(n) < 0.7))
    f[:, tfeat.F_LLM_CALLS] = rng.integers(0, 12, n)
    f[:, tfeat.F_TOKENS] = rng.integers(0, 40000, n) * (rng.random(n) < 0.9)
    f[:, tfeat.F_USER_MSGS] = rng.integers(0, 13, n)
    f[:, tfeat.F_ASSISTANT_MSGS] = rng.integers(0, 13, n)
    f[:, tfeat.F_IS_AGENT] = rng.integers(0, 2, n)
    return f


def _oracle_trace(row):
    """A stand-in trace carrying exactly one feature row, for the
    reference implementation."""
    fb = {1.0: "good", -1.0: "bad"}.get(float(row[tfeat.F_FEEDBACK]))
    summary = types.SimpleNamespace(
        user_feedback=fb, has_errors=bool(row[tfeat.F_HAS_ERRORS]),
        total_tool_calls=int(row[tfeat.F_TOOL_CALLS]),
        tool_calls_succeeded=int(row[tfeat.F_TOOL_OK]),
        tool_calls_failed=int(row[tfeat.F_TOOL_FAIL]),
        total_tool_duration_ms=float(row[tfeat.F_TOOL_DURATION_MS]),
        total_llm_calls=int(row[tfeat.F_LLM_CALLS]),
        total_tokens=int(row[tfeat.F_TOKENS]))
    spans = ([types.SimpleNamespace(type=SpanType.USER_MESSAGE)]
             * int(row[tfeat.F_USER_MSGS])
             + [types.SimpleNamespace(type=SpanType.ASSISTANT_MESSAGE)]
             * int(row[tfeat.F_ASSISTANT_MSGS]))
    return types.SimpleNamespace(
        summary=summary, spans=spans,
        end_time=1.0 if row[tfeat.F_ENDED] else None,
        chat_mode="agent" if row[tfeat.F_IS_AGENT] else "normal")


def test_random_rows_match_jax_and_reference():
    f = _random_rows()
    assert 0 < f[:, tfeat.F_IS_AGENT].sum() < N_RANDOM     # both modes
    jo = _jax_batch(jnp.asarray(f))
    to = reward_head(torch.from_numpy(f))
    np.testing.assert_array_equal(to.dims.numpy(), np.asarray(jo.dims))
    np.testing.assert_array_equal(to.mask.numpy(), np.asarray(jo.mask))
    np.testing.assert_allclose(to.final_reward.numpy(),
                               np.asarray(jo.final_reward), rtol=0,
                               atol=FINAL_TOL)
    for i, row in enumerate(f):
        ref_dims, ref_final = compute_reward_signals(_oracle_trace(row))
        got = {DIM_NAMES[j]: float(to.dims[i, j]) for j in range(N_DIMS)
               if to.mask[i, j] > 0.5}
        want = {d["name"]: d["value"] for d in ref_dims}
        assert set(got) == set(want), i
        for name, v in want.items():
            assert got[name] == pytest.approx(v, abs=REF_TOL), (i, name)
        assert float(to.final_reward[i]) == pytest.approx(ref_final,
                                                          abs=REF_TOL)


def test_one_row_and_batch_agree():
    f = torch.from_numpy(_random_rows(seed=1, n=16))
    batch = reward_head(f)
    for i in range(f.shape[0]):
        one = reward_head(f[i])
        assert one.dims.shape == (N_DIMS,) and one.final_reward.shape == ()
        assert torch.equal(one.dims, batch.dims[i])
        assert torch.equal(one.mask, batch.mask[i])
        assert torch.equal(one.final_reward, batch.final_reward[i])


def test_score_traces_batch_matches_single_and_is_profiled():
    traces = [_mk_trace(TraceCollector(reward_fn=functools.partial(
        score_trace, device="cpu")), **_case_kwargs(c))
        for c in BOUNDARY_CASES]
    singles = [t.summary.final_reward for t in traces]
    dims = [_dims(t) for t in traces]
    out = score_traces(traces, device="cpu")
    assert out.shape == (len(traces),) and out.device.type == "cpu"
    np.testing.assert_array_equal(out.numpy(),
                                  np.asarray(singles, np.float32))
    assert [_dims(t) for t in traces] == dims
    assert obs.get_profiler().ledger()["reward.head_batch"]["calls"] == 1
    ho = reward_head_batch(torch.from_numpy(batch_features(traces)))
    assert ho.dims.shape == (len(traces), N_DIMS)
    assert score_traces([], device="cpu").shape == (0,)


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tr = _mk_trace(TraceCollector(reward_fn=lambda t: None), llm_calls=1,
                   tokens=10, user_msgs=1, asst_msgs=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        score_trace(tr)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        score_traces([tr])
    # the collector's default scorer is the card head, too
    c = TraceCollector()
    c.start_trace("x", metadata={"chatMode": "normal"})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        c.end_trace_for_thread("x")
