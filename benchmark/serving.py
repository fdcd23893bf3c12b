"""What the serving drivers share: the engine built from the cell's traffic
file, the pool sized to the card's memory, the per-step record the traced
run keeps, and the comparison of served tokens with the reference.

The comparison: for a sample of the requests the window finished, drawn
from the seed with the longest among them, the reference computes in
float32 the distribution of every served token given the prompt and the
tokens served before it. The traffic samples its tokens, so two numbers
are compared (``compare``): the widest gap between the log-probability
the program recorded for a served token (``result_logps``) and the
reference's, and how far the served tokens are from samples of the
reference's distributions.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np


def kv_bytes_per_block(cfg: dict, block_size: int) -> int:
    return (cfg["num_hidden_layers"] * block_size
            * cfg["num_key_value_heads"] * cfg["head_dim"] * 2 * 2)


def build_engine(ctx, params):
    """The RolloutEngine the traffic file describes, with the pool sized
    to the memory left after the weights and ``workspace_gib`` for the
    step's activations (never above the engine's own default size)."""
    import torch

    from senweaver_ide_tpu_torch.rollout import (EngineConfig,
                                                 RolloutEngine, SampleParams)
    t = ctx.traffic
    if ctx.control == "wrong_row":
        plant_wrong_row_sampler()
    slots, max_len, bs = t["num_slots"], t["max_len"], t["block_size"]
    blocks = (slots + 4) * -(-max_len // bs)
    if ctx.device != "cpu":
        free, _total = torch.cuda.mem_get_info()
        room = free - int(t["workspace_gib"] * 2 ** 30)
        blocks = min(blocks, room // kv_bytes_per_block(ctx.cfg, bs))
    s = t["sampling"]
    return RolloutEngine(
        params, ctx.model_config(), num_slots=slots, max_len=max_len,
        sample=SampleParams(temperature=s["temperature"], top_k=s["top_k"],
                            top_p=s["top_p"]),
        seed=ctx.seed, device=ctx.device,
        max_prefixes=t.get("max_prefixes", 8),
        engine_config=EngineConfig(block_size=bs, num_blocks=int(blocks),
                                   step_tokens=t["step_tokens"]))


def record_steps(engine, steps: List[dict]) -> None:
    """Keep each fused step's token counts for the readers: tokens in the
    flat batch, the sum of their visible contexts (keys attended, itself
    included), and each row's reads (the positions its tokens attend,
    sorted). The driver adds what of those reads its traffic shares
    (``note_sharing``). Installed in the traced run only; reads the
    step's host-side lists and nothing else of the engine."""
    orig = engine._fused_step

    def spy(toks_l, rows_l, pos_l, wb_l, wo_l):
        reads: Dict[int, int] = {}
        for r, p in zip(rows_l, pos_l):
            if p >= reads.get(r, -1):
                reads[r] = p
        steps.append({"tokens": len(toks_l),
                      "context_sum": sum(pos_l) + len(pos_l),
                      "reads": sorted(p + 1 for p in reads.values())})
        return orig(toks_l, rows_l, pos_l, wb_l, wo_l)

    engine._fused_step = spy


def note_sharing(step: dict, common: int, within: int = 0) -> None:
    """The distinct K/V positions ``step`` needs, by the traffic's own
    record: every prompt begins with the same ``common`` tokens (a
    system prompt), read once for all rows; ``within`` more positions
    are shared inside groups (a group's prompt past the common part, once
    per group). What is left is each row's own."""
    reads = step["reads"]
    head = [min(r, common) for r in reads]
    overlap = sum(head) - max(head, default=0)
    step["distinct"] = sum(reads) - overlap - within


def check_record(steps: List[dict], stats: Dict[str, float]) -> None:
    """The step record has to hold every fused step the engine counted:
    a record that missed steps would leave the readers wrong or silent."""
    want = int(stats.get("decode_steps", 0))
    if want <= 0 or len(steps) != want:
        raise RuntimeError(
            f"the step record holds {len(steps)} steps and the engine "
            f"counted {want}: the harness no longer sees the engine's "
            f"fused steps (RolloutEngine._fused_step)")


def stats_delta(before: Dict, after: Dict) -> Dict[str, float]:
    return {k: after[k] - before[k] for k in after
            if isinstance(after[k], (int, float)) and k in before}


def free_memory() -> None:
    """Return the program's freed state to the card once the caller has
    dropped its last reference to it."""
    import gc

    import torch
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def sample(seed: int, finished: List[dict], k: int) -> List[dict]:
    """``k`` finished requests drawn from the seed, and the one with the
    most served tokens (the longest prompt among those)."""
    if not finished:
        return []
    rng = np.random.default_rng([seed, 1])
    longest = max(range(len(finished)),
                  key=lambda i: (len(finished[i]["tokens"]),
                                 len(finished[i]["prompt"])))
    idx = {longest}
    idx.update(int(i) for i in rng.choice(len(finished),
                                          size=min(k, len(finished)),
                                          replace=False))
    return [finished[i] for i in sorted(idx)]


def compare(ctx, reqs: List[dict]) -> Dict[str, object]:
    """The served tokens of the sampled requests against the float32
    reference, whose weights are made again from the seed:

    - ``logp_gap``: the widest gap between the log-probability the
      program recorded for a served token and the reference's;
    - ``sample_z``: whether the served tokens are samples of the
      reference's distribution at all. At temperature 1 a token drawn
      from p has E[log p(token)] = -H(p), so the sum over the served
      tokens of log p(token) + H, over the square root of the summed
      variances of log p, is a z-score near N(0, 1); a token drawn from
      another row's distribution or at another temperature reads far
      from 0 even where its recorded log-prob is right.

    With a control, the control's ``logp_gap`` against the reference."""
    import torch

    from benchmark.reference.model import no_tf32, token_logprobs
    from benchmark.weights import make_weights
    s = ctx.traffic["sampling"]
    if (s["temperature"], s["top_k"], s["top_p"]) != (1.0, 0, 1.0):
        raise ValueError("the sampling check holds for plain sampling at "
                         "temperature 1 only")
    no_tf32()
    params = make_weights(ctx.cfg, ctx.seed, ctx.device)
    prog = ctrl = 0.0
    dev_sum = var_sum = 0.0
    n_tok = 0
    if not reqs:
        prog = ctrl = math.inf
    for r in reqs:
        seq = r["prompt"] + r["tokens"]
        ref, ent, var = token_logprobs(ctx.cfg, params, seq,
                                       len(r["prompt"]), spread=True)
        got = torch.tensor(r["logps"], dtype=torch.float32,
                           device=ref.device)
        if got.shape != ref.shape:
            prog = math.inf
            continue
        prog = max(prog, float((got - ref).abs().max()))
        dev_sum += float((ref + ent).sum())
        var_sum += float(var.sum())
        n_tok += len(r["tokens"])
        if ctx.control == "fp8":
            low = token_logprobs(ctx.cfg, params, seq, len(r["prompt"]),
                                 quant="fp8")
            ctrl = max(ctrl, float((low - ref).abs().max()))
    z = abs(dev_sum) / math.sqrt(var_sum) if var_sum > 0 else math.inf
    program = {"logp_gap": prog, "sample_z": z}
    control = None
    if ctx.control == "fp8":
        control = {"logp_gap": ctrl}
    elif ctx.control == "wrong_row":
        control = program
    del params
    return {"program": program, "control": control,
            "tokens_compared": n_tok}


def plant_wrong_row_sampler() -> None:
    """Calibration only (``--control wrong_row``): the program's sampler
    draws each token from the next row's logits of the flat batch, while
    the engine still records the log-prob of that token under its own
    row, the fault that ``logp_gap`` cannot see."""
    import torch

    from senweaver_ide_tpu_torch.rollout import engine as eng
    orig = eng.sample_token

    def wrong_row(logits, *a, **k):
        return orig(torch.roll(logits, 1, dims=0), *a, **k)

    eng.sample_token = wrong_row
