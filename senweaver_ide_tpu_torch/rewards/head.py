"""The 9-dimension chatMode-adaptive reward head (PyTorch port).

Bit-level semantic port of ``_computeRewardSignals``
(``common/traceCollectorService.ts:668-788``), as the JAX package's
``rewards/head.py`` writes it. The TS implementation builds a
*variable-length* list of (name, value) dims — dims appear only when their
denominators are nonzero — and renormalizes weights over the *present* dims
(:777-784). The head keeps a fixed-width ``(9,)`` dim vector plus a
``(9,)`` presence mask, so the computation is branchless ``torch.where``
over the feature axis: one function scores one ``(N_FEATURES,)`` row or a
``(..., N_FEATURES)`` batch (the JAX package's ``jax.vmap``), while
``finalReward`` is numerically the TS weighted renormalized sum.

Threshold tables (traceCollectorService.ts:701-762, BASELINE.md):

==========================  =================  =================
quantity                    agent mode         normal mode
==========================  =================  =================
tool-fail severe/mod/minor  5 / 3 / 2          3 / 2 / 1
tool-count exc/good/fair    8 / 15 / 25        3 / 6 / 10
token exc/good/fair         5k / 15k / 30k     2k / 5k / 10k
LLM-call threshold T        3                  1
turn threshold T            3                  2
==========================  =================  =================

``score_trace`` / ``score_traces`` run the head on the card unless the
caller passes ``device="cpu"`` (the JAX head ran on the default
backend, the accelerator); there is no silent CPU path.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..device import resolve_device
from ..obs.runtime_profile import ProfiledFunction
from ..traces import features as F
from ..traces.schema import Trace
from ..traces.features import trace_features

# Dim indices in the fixed-width reward vector.
D_USER_FEEDBACK = 0
D_TASK_COMPLETION = 1
D_TOOL_SUCCESS_RATE = 2
D_TOOL_CALL_RELIABILITY = 3
D_TOOL_CALL_EFFICIENCY = 4
D_TOOL_DURATION_EFFICIENCY = 5
D_RESPONSE_EFFICIENCY = 6
D_TOKEN_EFFICIENCY = 7
D_CONVERSATION_EFFICIENCY = 8
N_DIMS = 9

DIM_NAMES = (
    "user_feedback",
    "task_completion",
    "tool_success_rate",
    "tool_call_reliability",
    "tool_call_efficiency",
    "tool_duration_efficiency",
    "response_efficiency",
    "token_efficiency",
    "conversation_efficiency",
)

# finalReward weights (traceCollectorService.ts:766-776); moved to the
# features' device per call.
WEIGHTS = torch.tensor([0.25, 0.18, 0.12, 0.08, 0.05, 0.05, 0.08, 0.08,
                        0.11], dtype=torch.float32)

# Threshold tables, (normal, agent) per quantity.
_FAIL_T = ((3.0, 2.0, 1.0), (5.0, 3.0, 2.0))          # severe/moderate/minor
_COUNT_T = ((3.0, 6.0, 10.0), (8.0, 15.0, 25.0))      # excellent/good/fair
_TOKEN_T = ((2000.0, 5000.0, 10000.0),
            (5000.0, 15000.0, 30000.0))               # excellent/good/fair
_LLM_T = (1.0, 3.0)
_TURN_T = (2.0, 3.0)
# the f32 value of the response-efficiency slope 0.4, as a Python float
_F32_0_4 = float(torch.tensor(0.4, dtype=torch.float32))


class RewardOutput(NamedTuple):
    """Fixed-width reward head output for one trace or a batch."""

    dims: torch.Tensor          # (..., 9) dim values; 0 where absent
    mask: torch.Tensor          # (..., 9) 1.0 where the dim is present
    final_reward: torch.Tensor  # (...) weight-renormalized sum over present


def _by_mode(agent: torch.Tensor, table, i=None) -> torch.Tensor:
    """The agent/normal row's entry ``i`` of a threshold table, per row."""
    normal, agent_v = (table[0], table[1]) if i is None else (
        table[0][i], table[1][i])
    return torch.where(agent, torch.tensor(agent_v, dtype=torch.float32,
                                           device=agent.device),
                       torch.tensor(normal, dtype=torch.float32,
                                    device=agent.device))


def _bands(x: torch.Tensor, edges, values) -> torch.Tensor:
    """``values[0] if x > edges[0] else values[1] if x > edges[1] ...``,
    last value otherwise, branchless (``edges`` are tensors or floats,
    compared in the given order)."""
    out = torch.full_like(x, values[-1])
    for e, v in zip(reversed(edges), reversed(values[:-1])):
        out = torch.where(x > e, torch.full_like(x, v), out)
    return out


def reward_head(feat: torch.Tensor) -> RewardOutput:
    """Compute the 9-dim reward vector from ``(..., N_FEATURES)`` feature
    rows: one row or a batch. Pure and branchless."""
    feat = feat.float()
    agent = feat[..., F.F_IS_AGENT].to(torch.int32) != 0   # else normal
    fb = feat[..., F.F_FEEDBACK]
    ended = feat[..., F.F_ENDED] > 0.5
    has_err = feat[..., F.F_HAS_ERRORS] > 0.5
    tool_calls = feat[..., F.F_TOOL_CALLS]
    tool_ok = feat[..., F.F_TOOL_OK]
    tool_fail = feat[..., F.F_TOOL_FAIL]
    tool_dur = feat[..., F.F_TOOL_DURATION_MS]
    llm_calls = feat[..., F.F_LLM_CALLS]
    tokens = feat[..., F.F_TOKENS]
    turns = torch.minimum(feat[..., F.F_USER_MSGS],
                          feat[..., F.F_ASSISTANT_MSGS])
    good = fb > 0.5
    full = lambda v: torch.full_like(fb, v)                 # noqa: E731

    # Dim 1: user feedback (ref :677-679). Always present.
    d_feedback = fb

    # Dim 2: task completion (ref :682-692). Always present. The TS applies
    # the branches in source order, so `good` overrides everything.
    d_completion = full(0.5)
    d_completion = torch.where(ended & ~has_err, full(0.8), d_completion)
    d_completion = torch.where(has_err, full(-0.5), d_completion)
    d_completion = torch.where(good, full(1.0), d_completion)

    # Dim 3: tool success rate → [-1, 1] (ref :697-698).
    safe_calls = torch.clamp_min(tool_calls, 1.0)
    d_success = (tool_ok / safe_calls) * 2.0 - 1.0

    # Dim 4: tool-call reliability, adaptive fail thresholds (ref :701-708).
    ft = [_by_mode(agent, _FAIL_T, i) for i in range(3)]
    d_reliability = torch.where(
        tool_fail >= ft[0], full(-1.0),
        torch.where(tool_fail >= ft[1], full(-0.5),
                    torch.where(tool_fail >= ft[2], full(-0.2),
                                full(1.0))))

    # Dim 5: tool-call count efficiency (ref :710-718).
    ct = [_by_mode(agent, _COUNT_T, i) for i in range(3)]
    d_count = _bands(tool_calls, (ct[2], ct[1], ct[0]),
                     (-0.8, -0.3, 0.3, 1.0))

    # Dim 5b: tool duration efficiency, avg-duration bands (ref :721-729).
    avg_dur = tool_dur / safe_calls
    d_duration = _bands(avg_dur, (10000.0, 3000.0, 1000.0),
                        (-0.5, 0.0, 0.5, 1.0))

    # Dim 6: response efficiency (ref :733-737). 1 - n * 0.4 with one
    # rounding to f32, as a fused multiply-add gives it (XLA's CPU code
    # for the JAX head): n * f32(0.4) and the difference are exact in f64.
    llm_t = _by_mode(agent, _LLM_T)
    over = torch.clamp_min(llm_calls - llm_t, 0.0).double()
    d_response = torch.clamp_min(
        (1.0 - over * _F32_0_4).float(), -1.0)

    # Dim 7: token efficiency (ref :740-749).
    tt = [_by_mode(agent, _TOKEN_T, i) for i in range(3)]
    d_token = _bands(tokens, (tt[2], tt[1], tt[0]), (-0.5, 0.0, 0.5, 1.0))

    # Dim 8: conversation efficiency, turn bands (ref :752-763).
    turn_t = _by_mode(agent, _TURN_T)
    d_turns = _bands(turns, (turn_t * 3.0, turn_t * 2.0, turn_t),
                     (-0.8, -0.3, 0.3, 1.0))

    dims = torch.stack([d_feedback, d_completion, d_success, d_reliability,
                        d_count, d_duration, d_response, d_token, d_turns],
                       dim=-1)

    # Presence mask — dims appear only when denominators are nonzero
    # (ref: `if (s.totalToolCalls > 0)` :696, `totalToolDurationMs > 0` :720,
    # `totalLLMCalls > 0` :732, `totalTokens > 0` :739, `turns > 0` :755).
    has_tools = tool_calls > 0.0
    mask = torch.stack([
        full(1.0),                              # user_feedback: always
        full(1.0),                              # task_completion: always
        has_tools.float(),                      # tool_success_rate
        has_tools.float(),                      # tool_call_reliability
        has_tools.float(),                      # tool_call_efficiency
        (has_tools & (tool_dur > 0.0)).float(),
        (llm_calls > 0.0).float(),              # response_efficiency
        (tokens > 0.0).float(),                 # token_efficiency
        (turns > 0.0).float(),                  # conversation_efficiency
    ], dim=-1)

    w = WEIGHTS.to(feat.device)
    dims = dims * mask
    total_w = (w * mask).sum(dim=-1)
    final = (dims * w).sum(dim=-1) / torch.clamp_min(total_w, 1e-12)
    return RewardOutput(dims=dims, mask=mask, final_reward=final)


# Batch scorer: (B, N_FEATURES) -> RewardOutput of (B, 9)/(B, 9)/(B,).
# Profiled (obs/runtime_profile.py): batch-size variety is the expected
# signature axis here — the ledger shows whether callers bucket batches.
reward_head_batch = ProfiledFunction(reward_head, "reward.head_batch",
                                     storm_threshold=32)


def _write_summaries(traces, out: RewardOutput) -> None:
    """One device→host copy of (dims, mask, final) for every row, then
    the reference's mutation of each ``trace.summary``."""
    host = torch.cat([out.dims, out.mask, out.final_reward[..., None]],
                     dim=-1).reshape(len(traces), 2 * N_DIMS + 1).cpu()
    for tr, row in zip(traces, host.tolist()):
        tr.summary.reward_dimensions = [
            {"name": DIM_NAMES[j], "value": float(row[j])}
            for j in range(N_DIMS) if row[N_DIMS + j] > 0.5
        ]
        tr.summary.final_reward = float(row[2 * N_DIMS])


def score_trace(trace: Trace, *, device="cuda") -> float:
    """Score one host-side trace in place on ``device``, mirroring the
    reference's mutation of ``trace.summary`` (``_computeRewardSignals``
    writes ``rewardDimensions`` + ``finalReward``,
    traceCollectorService.ts:786-787)."""
    dev = resolve_device(device)
    feat = torch.from_numpy(trace_features(trace)).to(dev)
    _write_summaries([trace], reward_head(feat))
    return trace.summary.final_reward


def score_traces(traces, *, device="cuda") -> torch.Tensor:
    """Batch-score traces on ``device``; returns the (B,) finalReward
    tensor (on ``device``) and updates each host trace's summary."""
    from ..traces.features import batch_features

    dev = resolve_device(device)
    traces = list(traces)
    feats = batch_features(traces)
    if feats.shape[0] == 0:
        return torch.zeros((0,), dtype=torch.float32, device=dev)
    out = reward_head_batch(torch.from_numpy(feats).to(dev))
    _write_summaries(traces, out)
    return out.final_reward
