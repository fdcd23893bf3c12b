"""GRPO collection: groups of sampled completions of one prompt each,
submitted with ``RolloutEngine.submit_group`` (one prefill, the members
forked from it), with ``min_queue`` groups kept queued (the engine
queues a group's donor; its followers wait on the donor's prefill), as a
round that submits all of its groups at once.

Every prompt begins with the same ``system_tokens`` ids (the agent's
system message, drawn once from the seed), then a task of its own. The
sizes are the same in every run (``sizes_seed``); the ids are the
seed's. Each
member's completion length is drawn from the seed and the member is
ended there as an end-of-sequence token would end it: its tokens and
log-probs are read, then ``release_request`` frees its row. The group is
submitted with the longest member's length as its budget.

End to end: ``rollout_tok_s`` (tokens generated in the window over its
time). The record also keeps ``itl_p95_ms`` (the 95th percentile of the
gaps between consecutive tokens of every request, both tokens in the
window), which its per-layer reader reports.
"""

from __future__ import annotations

import time

import numpy as np

from benchmark import serving, traffic
from benchmark.core import Window
from benchmark.weights import make_weights
from benchmark.yardstick import percentile


class _Groups:
    """The seed's endless sequence of groups: (prompt, member lengths)."""

    def __init__(self, ctx):
        t = ctx.traffic
        self.rng = np.random.default_rng([ctx.seed, 0])
        self.t = t
        self.vocab = ctx.cfg["vocab_size"]
        self.system = traffic.token_ids(self.rng, t["system_tokens"],
                                        self.vocab)
        # the sizes come from ``sizes_seed``: every run serves the same
        # sizes in the same order, so the scheduler's pipeline, which a
        # different order of the same sizes moves between rates ~25%
        # apart, is the same in every run; the token ids stay the seed's
        sizes = np.random.default_rng([t["sizes_seed"]])
        self.prompts = traffic.Stream(sizes, t["prompt_tokens"],
                                      t["strata"])
        # each group's members take the same set of lengths
        self.members = traffic.Stream(sizes, t["completion_tokens"],
                                      t["group_size"])

    def next(self):
        prompt = self.system + traffic.token_ids(
            self.rng, self.prompts.next(), self.vocab)
        return prompt, [self.members.next()
                        for _ in range(self.t["group_size"])]


class _State:
    def __init__(self, ctx, engine):
        self.engine = engine
        self.groups = _Groups(ctx)
        self.common = len(self.groups.system)
        self.live = {}          # rid -> request record
        self.finished = []      # records of members ended in the window
        self.min_queue = ctx.traffic["min_queue"]
        self.steps = None       # the step record, once a window keeps one

    def refill(self, ctx) -> None:
        while self.engine.queue_depth < self.min_queue:
            prompt, lens = self.groups.next()
            with ctx.span("engine.submit_group"):
                rids = self.engine.submit_group(
                    prompt, len(lens), max_new_tokens=max(lens))
            group = {"prompt": len(prompt)}
            for rid, n in zip(rids, lens):
                self.live[rid] = {"prompt": prompt, "target": n,
                                  "tokens": [], "last": None,
                                  "group": group}

    def step(self, ctx, t_window=None, gaps=None) -> int:
        """One engine step; returns the tokens it emitted. Members that
        reached their length are read and released."""
        self.refill(ctx)
        n_steps = len(self.steps) if self.steps is not None else 0
        with ctx.span("engine.step"):
            out = self.engine.step()
        now = time.perf_counter()
        n = 0
        decoding = {}           # id(group) -> (rows that read its prompt)
        for rid, toks in out.items():
            req = self.live[rid]
            k = len(toks)
            n += k
            if len(req["tokens"]) or k > 1:
                g = req["group"]
                decoding[id(g)] = (g, decoding.get(id(g), (g, 0))[1] + 1)
            last = req["last"]
            if gaps is not None and last is not None and last >= t_window:
                gaps.append(now - last)
                if k > 1:
                    gaps.extend([0.0] * (k - 1))
            req["last"] = now
            req["tokens"].extend(toks)
            if len(req["tokens"]) >= req["target"]:
                with ctx.span("engine.release"):
                    logps = self.engine.result_logps(rid)[:req["target"]]
                    self.engine.release_request(rid)
                del self.live[rid]
                if t_window is not None:
                    self.finished.append(
                        {"prompt": req["prompt"], "logps": logps,
                         "tokens": req["tokens"][:req["target"]]})
        if self.steps is not None and len(self.steps) > n_steps:
            # a group's prompt past the common part is read once for all
            # of its rows that read it in this step
            within = sum((rows - 1) * (g["prompt"] - self.common)
                         for g, rows in decoding.values())
            serving.note_sharing(self.steps[-1], self.common, within)
        return n


def setup(ctx):
    params = make_weights(ctx.cfg, ctx.seed, ctx.device)
    st = _State(ctx, serving.build_engine(ctx, params))
    for _ in range(ctx.traffic["warmup_steps"]):
        st.step(ctx)
    return st


def window(ctx, st, seconds):
    if ctx.trace and st.steps is None:
        st.steps = []
        serving.record_steps(st.engine, st.steps)
    if st.steps is not None:
        st.steps.clear()
    before = st.engine.stats()
    n_finished = len(st.finished)
    gaps = []
    durations = []
    tokens = n_steps = 0
    with ctx.span("window"):
        t0 = t1 = time.perf_counter()
        while True:
            tokens += st.step(ctx, t0, gaps)
            n_steps += 1
            t_prev, t1 = t1, time.perf_counter()
            durations.append(t1 - t_prev)
            if t1 - t0 >= seconds:
                break
    stats = serving.stats_delta(before, st.engine.stats())
    steps = list(st.steps) if st.steps is not None else []
    if st.steps is not None:
        serving.check_record(steps, stats)
    return Window(values={"rollout_tok_s": tokens / (t1 - t0)},
                  attempted=len(st.finished) - n_finished, failed=0,
                  record={"stats": stats, "steps": steps,
                          "window_s": t1 - t0,
                          "itl_p95_ms": (percentile(gaps, 95) * 1e3
                                         if gaps else None),
                          "diag": {"steps": n_steps, "tokens": tokens,
                                   "gaps": len(gaps),
                                   "gap_ms": _quantiles(gaps),
                                   "step_ms": _quantiles(durations),
                                   "steps_over_100ms": sum(
                                       d > 0.1 for d in durations),
                                   "stats": {k: stats.get(k) for k in (
                                       "prefill_tokens", "kv_preemptions",
                                       "group_prefill_tokens_avoided")}}})


def _quantiles(xs):
    """The 50th, 90th, 95th and 99th percentiles and the largest of
    ``xs`` (seconds), in ms, for the run's diagnostics on stderr."""
    if not xs:
        return None
    return [round(percentile(xs, q) * 1e3, 3) for q in (50, 90, 95, 99)] + [
        round(max(xs) * 1e3, 3)]


def finish(ctx, st, win):
    reqs = serving.sample(ctx.seed, st.finished,
                          ctx.traffic["check"]["requests"])
    st.engine = None
    serving.free_memory()
    return serving.compare(ctx, reqs)
