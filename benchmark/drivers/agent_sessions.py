"""The IDE coding agent's tool loop: a closed loop of sessions, each
waiting for its reply and then sending its next call at once.

Every session starts from one shared system prompt, registered once with
``register_prefix`` and passed as ``prefix_id`` (as an ``auto_prefix``
client does, re-registering if the engine dropped it), then a task. Each
call submits the whole conversation so far with ``submit``; the reply's
length is drawn from the seed and a tool result is appended after it. A
session ends after its drawn number of turns, or when its next prompt
would pass ``max_prompt``; a new session takes its place. The first
sessions start at a turn drawn from the seed (stratified shares of their
turns), with a history made from the seed, so the window is steady from
its start.

End to end: ``rollout_tok_s`` (tokens generated in the window over its
time) and ``ttft_p95_ms`` (the 95th percentile, over every call submitted
in the window, of the time from its submission to its first token; the
run waits past the window for the last first tokens, up to
``drain_seconds``, and a call that fails counts as missing).
"""

from __future__ import annotations

import time

import numpy as np

from benchmark import serving, traffic
from benchmark.core import Window
from benchmark.weights import make_weights
from benchmark.yardstick import percentile


class _Sessions:
    """The seed's sessions: the shared system prompt, then per session a
    task, a number of turns, replies and tool results."""

    def __init__(self, ctx):
        t = ctx.traffic
        self.t, self.vocab = t, ctx.cfg["vocab_size"]
        self.rng = np.random.default_rng([ctx.seed, 0])
        n = t["strata"]
        self.task = traffic.Stream(self.rng, t["task_tokens"], n)
        self.turns = traffic.Stream(self.rng, t["turns"], n)
        self.reply = traffic.Stream(self.rng, t["reply_tokens"], n)
        self.tool = traffic.Stream(self.rng, t["tool_tokens"], n)
        self.system = self.ids(t["system_tokens"])

    def ids(self, n):
        return traffic.token_ids(self.rng, n, self.vocab)

    def new(self, warm: float = 0.0) -> dict:
        """A session, already the share ``warm`` of its turns in (a
        history of made-up replies and tool results)."""
        s = {"history": self.system + self.ids(self.task.next()),
             "turns": self.turns.next(), "done": 0}
        if warm:
            for _ in range(int(warm * s["turns"])):
                turn = self.ids(self.reply.next()) + self.ids(
                    self.tool.next())
                if len(s["history"]) + len(turn) > self.t["max_prompt"]:
                    break
                s["history"] += turn
                s["done"] += 1
        return s


class _State:
    def __init__(self, ctx, engine):
        self.engine = engine
        self.gen = _Sessions(ctx)
        self.pid = engine.register_prefix(self.gen.system)
        self.calls = {}        # rid -> call record, while in flight
        self.window_calls = []  # calls submitted in the window
        self.finished = []     # calls finished in the window
        self.failed = 0
        self.submitting = True
        self.parked = []       # sessions whose next call waits for a window
        self.steps = None      # the step record, once a window keeps one
        # the first sessions' progress: stratified shares of their turns
        n = ctx.traffic["sessions"]
        warm = (np.arange(n) + 0.5) / n
        self.gen.rng.shuffle(warm)
        for w in warm:
            self.submit(ctx, self.gen.new(float(w)), None)

    def submit(self, ctx, session, t_window) -> None:
        target = self.gen.reply.next()
        prompt = list(session["history"])
        call = {"session": session, "prompt": prompt, "target": target,
                "tokens": [], "t_first": None, "in_window": False}
        try:
            with ctx.span("engine.submit"):
                try:
                    rid = self.engine.submit(prompt, max_new_tokens=target,
                                             prefix_id=self.pid)
                except KeyError:
                    self.pid = self.engine.register_prefix(self.gen.system)
                    rid = self.engine.submit(prompt, max_new_tokens=target,
                                             prefix_id=self.pid)
        except (ValueError, RuntimeError):
            if t_window is not None:
                self.failed += 1
            return
        call["t_submit"] = time.perf_counter()
        if t_window is not None:
            call["in_window"] = True
            self.window_calls.append(call)
        self.calls[rid] = call

    def next_turn(self, ctx, call, t_window) -> None:
        s = call["session"]
        s["done"] += 1
        s["history"] = (call["prompt"] + call["tokens"]
                        + self.gen.ids(self.gen.tool.next()))
        if (s["done"] >= s["turns"]
                or len(s["history"]) > ctx.traffic["max_prompt"]):
            s = self.gen.new()
        if self.submitting:
            self.submit(ctx, s, t_window)
        else:
            self.parked.append(s)

    def step(self, ctx, t_window=None) -> int:
        n_steps = len(self.steps) if self.steps is not None else 0
        with ctx.span("engine.step"):
            out = self.engine.step()
        if self.steps is not None and len(self.steps) > n_steps:
            # every call's prompt begins with the registered system prompt
            serving.note_sharing(self.steps[-1], len(self.gen.system))
        now = time.perf_counter()
        n = 0
        for rid, toks in out.items():
            call = self.calls[rid]
            n += len(toks)
            if call["t_first"] is None:
                call["t_first"] = now
            call["tokens"].extend(toks)
            if (len(call["tokens"]) >= call["target"]
                    or self.engine.is_done(rid)):
                del self.calls[rid]
                if t_window is not None:
                    self.finished.append(
                        {"prompt": call["prompt"], "tokens": call["tokens"],
                         "logps": self.engine.result_logps(rid)})
                self.next_turn(ctx, call, t_window)
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
    # the sessions held back at the end of an earlier window go on
    st.submitting = True
    parked, st.parked = st.parked, []
    st.window_calls, st.failed = [], 0
    before = st.engine.stats()
    tokens = n_steps = 0
    with ctx.span("window"):
        t0 = time.perf_counter()
        while True:
            while parked:
                st.submit(ctx, parked.pop(), t0)
            tokens += st.step(ctx, t0)
            n_steps += 1
            t1 = time.perf_counter()
            if t1 - t0 >= seconds:
                break
    stats = serving.stats_delta(before, st.engine.stats())
    steps = list(st.steps) if st.steps is not None else []
    if st.steps is not None:
        serving.check_record(steps, stats)
    # the calls of the window that have no first token yet: wait for them
    st.submitting = False
    deadline = time.perf_counter() + ctx.traffic["drain_seconds"]
    while (any(c["t_first"] is None for c in st.window_calls)
           and time.perf_counter() < deadline):
        st.step(ctx)
    ttft = [c["t_first"] - c["t_submit"] for c in st.window_calls
            if c["t_first"] is not None]
    missing = len(st.window_calls) - len(ttft) + st.failed
    ttft += [float("inf")] * missing
    values = {"rollout_tok_s": tokens / (t1 - t0),
              "ttft_p95_ms": percentile(ttft, 95) * 1e3 if ttft else None}
    return Window(values=values, attempted=len(st.window_calls) + st.failed,
                  failed=missing,
                  record={"stats": stats, "steps": steps,
                          "window_s": t1 - t0,
                          "diag": {"steps": n_steps, "tokens": tokens,
                                   "calls": len(st.window_calls)}})


def finish(ctx, st, win):
    reqs = serving.sample(ctx.seed, st.finished,
                          ctx.traffic["check"]["requests"])
    st.engine = None
    serving.free_memory()
    return serving.compare(ctx, reqs)
