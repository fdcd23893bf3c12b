"""The GRPO update: optimizer steps back to back, each over groups of
trajectories built by the trainer's own ``training.make_batch`` and
taken by ``training.trainer.train_step``.

Every prompt begins with the same ``system_tokens`` ids (the agent's
system message, drawn once from the seed), then a task of its own. Every
step has the same set of task and completion lengths (their stratified
draws), in an order, with token ids and rewards, that the seed chooses;
every row of every step differs. Set-up builds the one train
state, takes the first ``reference_steps`` steps through the same call
and feed as the window (the first builds the kernels), and keeps what
the comparison reads: each step's loss, the first gradient as the
optimizer holds it (its first moment after one step over 1 - b1), and
each leaf's change over those steps. The window then runs steps until
``--seconds`` have passed.

End to end: ``train_tok_s``, the non-padding positions of the steps
finished in the window over the time from its start to the last step's
synchronised end.
"""

from __future__ import annotations

import statistics
import time

import numpy as np

from benchmark import serving, traffic
from benchmark.core import Window
from benchmark.weights import leaves, make_weights


class _Batches:
    """The seed's endless sequence of steps: lists of (tokens, prompt
    length, reward, group id)."""

    def __init__(self, ctx):
        t = ctx.traffic
        self.t, self.vocab = t, ctx.cfg["vocab_size"]
        self.rng = np.random.default_rng([ctx.seed, 0])
        self.system = traffic.token_ids(self.rng, t["system_tokens"],
                                        self.vocab)
        n, g = t["prompts_per_step"], t["group_size"]
        self.prompts = traffic.Stream(self.rng, t["prompt_tokens"], n)
        self.completions = traffic.Stream(self.rng, t["completion_tokens"],
                                          n * g)

    def next(self):
        t, rng = self.t, self.rng
        rows = []
        for gid in range(t["prompts_per_step"]):
            prompt = self.system + traffic.token_ids(
                rng, self.prompts.next(), self.vocab)
            for _ in range(t["group_size"]):
                comp = traffic.token_ids(rng, self.completions.next(),
                                         self.vocab)
                rows.append((prompt + comp, len(prompt),
                             float(rng.standard_normal()), gid))
        return rows


class _State:
    def __init__(self, ctx):
        from senweaver_ide_tpu_torch.training.trainer import (TrainState,
                                                              make_optimizer)
        o = ctx.traffic["optimizer"]
        self.mcfg = ctx.model_config()
        self.opt = make_optimizer(o["learning_rate"],
                                  weight_decay=o["weight_decay"],
                                  max_grad_norm=o["max_grad_norm"])
        params = make_weights(ctx.cfg, ctx.seed, ctx.device)
        self.train = TrainState(params=params,
                                opt_state=self.opt.init(params), step=0,
                                opt=self.opt)
        self.batches = _Batches(ctx)

    def step(self, ctx, rows):
        """One update through the trainer; returns its loss (a host float,
        which waits for the step's end)."""
        from senweaver_ide_tpu_torch.training import Trajectory, make_batch
        from senweaver_ide_tpu_torch.training.trainer import train_step
        with ctx.span("make_batch"):
            trajs = [Trajectory(prompt_ids=tok[:p], completion_ids=tok[p:],
                                reward=r, group_id=g)
                     for tok, p, r, g in rows]
            tokens, mask, rewards, gids = make_batch(trajs, pad_id=0)
        with ctx.span("train_step"):
            self.train, metrics = train_step(
                self.train, self.mcfg, None, tokens, mask, rewards, gids,
                optimizer=self.opt,
                num_groups=ctx.traffic["prompts_per_step"],
                accum_steps=ctx.traffic["accum_steps"])
            return float(metrics["loss"])


def _norms(tree, scale=1.0):
    return {k: float(t.float().norm()) * scale
            for k, t in leaves(tree).items()}


def setup(ctx):
    st = _State(ctx)
    start = {k: t.clone() for k, t in leaves(st.train.params).items()}
    st.first = {"batches": [], "loss": []}
    b1 = ctx.traffic["optimizer"]["b1"]
    for i in range(ctx.traffic["reference_steps"]):
        rows = st.batches.next()
        st.first["batches"].append(rows)
        st.first["loss"].append(st.step(ctx, rows))
        if i == 0:
            st.first["grad_norm"] = _norms(st.train.opt_state.mu,
                                           1.0 / (1.0 - b1))
    st.first["change_norm"] = {
        k: float((t.float() - start[k].float()).norm())
        for k, t in leaves(st.train.params).items()}
    del start
    return st


def window(ctx, st, seconds):
    lens = []
    positions = 0
    with ctx.span("window"):
        t0 = time.perf_counter()
        while True:
            rows = st.batches.next()
            st.step(ctx, rows)
            lens.append([len(r[0]) for r in rows])
            positions += sum(lens[-1])
            t1 = time.perf_counter()
            if t1 - t0 >= seconds:
                break
    return Window(values={"train_tok_s": positions / (t1 - t0)},
                  attempted=len(lens), failed=0,
                  record={"steps": lens, "window_s": t1 - t0,
                          "diag": {"steps": len(lens)}})


def _gaps(prog: dict, ref: dict) -> dict:
    """The program's numbers against the reference's: each step's loss
    (absolute gap), and the gap of each leaf's first-gradient norm and
    change norm over the reference's norm of that leaf or of the median
    leaf, whichever is larger: by the worst leaf, and for the gradient
    also by the median leaf (the worst is one small leaf's noise, PERF.md).
    Leaves whose reference gradient is under a thousandth of the median
    leaf's move by round-off alone and are left out of the change."""
    g_med = statistics.median(ref["grad_norm"].values())
    c_med = statistics.median(ref["change_norm"].values())
    moved = [k for k, v in ref["grad_norm"].items() if v >= 1e-3 * g_med]

    def each(name, keys, med):
        return [abs(prog[name][k] - ref[name][k]) / max(ref[name][k], med)
                for k in keys]

    grad = each("grad_norm", ref["grad_norm"], g_med)
    return {"loss_gap": max(abs(a - b)
                            for a, b in zip(prog["loss"], ref["loss"])),
            "grad_gap": max(grad),
            "grad_gap_median": statistics.median(grad),
            "change_gap": max(each("change_norm", moved, c_med))}


def finish(ctx, st, win):
    from benchmark.reference import grpo
    from benchmark.reference.model import no_tf32
    first = st.first
    st.train = None
    serving.free_memory()
    no_tf32()
    params = make_weights(ctx.cfg, ctx.seed, ctx.device)
    opt = ctx.traffic["optimizer"]
    ref = grpo.train(ctx.cfg, params, first["batches"], opt)
    out = {"program": _gaps(first, ref), "control": None}
    if ctx.control == "fp8":
        low = grpo.train(ctx.cfg, params, first["batches"], opt,
                         quant="fp8")
        out["control"] = _gaps(low, ref)
    if ctx.control in ("fp8", "half_batch"):
        # a fault planted in the reference put in the program's place:
        # each step over its first half (whole groups), the mean taken
        # over that half
        half = [rows[:len(rows) // 2] for rows in first["batches"]]
        out["half_batch"] = _gaps(grpo.train(ctx.cfg, params, half, opt),
                                  ref)
        if ctx.control == "half_batch":
            out["control"] = out["half_batch"]
    return out
