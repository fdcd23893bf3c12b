"""North-star uplift on REAL weights: beam-found rules steer a real policy.

The r3 gap (VERDICT r3 missing #1): the ≥2× APO uplift existed only on a
scripted stand-in whose behavior contract made the winning rules
discoverable by construction. This eval closes it with a real transformer
end to end:

1. **Pretrain rule-following** (GRPO through the real engine): the system
   message carries an '# APO Optimized Rules' section (the reference's
   injection point, ``convertToLLMMessageService.ts:834-856``) containing
   one of two CONTRASTIVE style rules; the user message is IDENTICAL
   across both groups, so the rule text in the system prompt is the only
   signal that distinguishes them. Reward = agreement with the rule's
   demanded byte class. This gives the tiny byte-level policy the
   instruction-following a production LLM ships with.
2. **Freeze the weights.** From here on, no weight update ever runs.
3. **Probe conditioning**: measured low-byte fraction under each trained
   rule, under NO rules, and under a decoy — the artifact's causal
   evidence that the rule TEXT moves the sampled tokens.
4. **Run the full APO cycle** against the frozen policy: baseline
   rollouts (no rules) with a symmetric outcome judge → textual-gradient
   beam search whose candidate rule-sets are scored by RE-ROLLING the
   task suite on the real engine and batch-scoring the traces with the
   jit reward head → re-roll under the winning rules. The optimizer role
   (the reference keeps it on a backend LLM, ``apoService.ts:992-1215``)
   is a deterministic vocabulary-bank proposer: candidate DISCOVERY
   happens in the scorer, which only real sampled tokens can satisfy.

The eval task suite uses HELD-OUT user texts (never seen in pretraining)
and targets whichever byte class the frozen policy's no-rule prior does
NOT produce — so the baseline is honestly bad and only a rule-set that
actually steers the real policy can win.

    python torch_eval_uplift_real.py [--rounds 60] [--save-dir DIR | --load-dir DIR] [--cpu]

Prints ONE JSON line (the UPLIFT_REALPOLICY_r04 artifact).
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import os
import random
import sys
import tempfile
import time
from typing import List, Optional, Sequence

# The two contrastive rules the policy is pretrained to follow. Byte
# classes partition the space, so no unconditional policy satisfies both.
RULE_LOW = "Respond using plain ascii text only."
RULE_HIGH = "Respond using binary high bytes only."
DECOY_RULE = "Always verify inputs before acting."

# Optimizer vocabulary bank: the trained rules, paraphrases (which may or
# may not steer the policy — measured, not assumed), and agent-flavored
# decoys that cannot. Beam search must find the steering subset by score.
RULE_BANK = [
    RULE_LOW,
    RULE_HIGH,
    "Respond in plain ascii text.",
    "Use binary high bytes in replies.",
    DECOY_RULE,
    "Use the minimum number of tool calls needed.",
    "Be concise and direct in every answer.",
    "Read the target file before editing it.",
    "Never retry a failing call blindly.",
    "Prefer structured output over prose.",
]

# Pretraining user texts. The default recipe (tasks_per_class=1) trains
# on the FIRST text only — the user text is identical across contrastive
# classes either way, so it carries no class signal, and held-out probes
# verify generalization; pass tasks_per_class=2 to add text variety at
# 2x the per-round episode cost. EVAL_TEXTS are never seen in training.
PRETRAIN_TEXTS = ["write an output record", "emit the data bytes"]
EVAL_TEXTS = ["write the log line", "emit the payload",
              "produce the message body", "write the record",
              "output the data stream", "emit the response"]

LOW_CLASS = frozenset(range(0, 128))

# User-patience bound per episode (see --max-attempts help): one source
# of truth for the argparse default and both scorer entry points.
DEFAULT_MAX_ATTEMPTS = 8


def realistic_prefix(n_bytes: int) -> str:
    """First ``n_bytes`` of the REAL assembled agent system message —
    the filler for prompt-length frontier experiments (VERDICT r3 #4:
    conditioning proven at ~30 bytes, unproven under the ~1.8k-byte
    production prompt; the frontier measures where it breaks)."""
    from senweaver_ide_tpu_torch.prompts.system import chat_system_message

    text = chat_system_message(
        chat_mode="agent", workspace_folders=("/workspace",),
        directory_str="src/\n  app.py\n  lib.py\n  tests/\n    test_app.py",
        include_tool_definitions=True)
    return text[:max(0, n_bytes)]


def minimal_sysmsg(rules: Sequence[str], *, prefix_bytes: int = 0) -> str:
    """System message with the REAL APO-rules rendering.

    ``prefix_bytes == 0``: a ~25-byte base — the proven-conditioning
    regime (eval_learning --short-prompt). ``prefix_bytes > 0``: that
    many bytes of the REAL assembled prompt precede the rules section
    (rules stay LAST, exactly where production assembly puts them —
    prompts/system.py chat_system_message), so the frontier varies
    prefix LENGTH alone."""
    from senweaver_ide_tpu_torch.prompts.system import render_apo_rules

    base = (realistic_prefix(prefix_bytes) if prefix_bytes > 0
            else "You are a byte emitter.")
    apo = render_apo_rules(list(rules))
    return base + ("\n\n" + apo if apo else "")


def frac_low(ids: Sequence[int]) -> float:
    toks = [t for t in ids if 0 <= t < 256]
    if not toks:
        return 0.0
    return sum(1 for t in toks if t in LOW_CLASS) / len(toks)


class BankProposer:
    """Deterministic optimizer-role client for beam search.

    ``propose_candidates`` (apo/beam.py) drives it with textual-gradient
    critique and apply-edit prompts; it answers apply-edit calls with a
    1-2 rule subset sampled from the vocabulary bank. The reference's
    analogue is the backend optimizer LLM — in both designs the
    SELECTION signal (candidate scores from real rollouts through the
    reward head) is what finds the winner."""

    def __init__(self, bank: Sequence[str], seed: int = 0):
        from senweaver_ide_tpu_torch.agents.llm import LLMResponse, LLMUsage
        self._resp = lambda text: LLMResponse(
            text=text, usage=LLMUsage(0, 0), model="bank-proposer")
        self.bank = list(bank)
        self.rng = random.Random(seed)

    def chat(self, messages, *, temperature=None, max_tokens=None,
             on_text=None):
        prompt = messages[-1].content if messages else ""
        if "## Critique" in prompt:       # apply-edit call → candidate rules
            rules = self.rng.sample(self.bank, self.rng.choice([1, 2]))
            return self._resp("\n".join(f"- {r}" for r in rules))
        return self._resp(                # critique call
            "- The response style does not match what the tasks demand; "
            "try explicit response-style rules with alternative phrasings.")


def device_collector(device, **kw):
    """A trace collector whose reward head scores each finished trace on
    ``device`` (the run's device: the card unless the caller asks for the
    CPU)."""
    import functools

    from senweaver_ide_tpu_torch.rewards.head import score_trace
    from senweaver_ide_tpu_torch.traces.collector import TraceCollector
    return TraceCollector(
        reward_fn=functools.partial(score_trace, device=device), **kw)


def load_policy(load_dir: str, *, model: str = "tiny-test", seed: int = 0,
                lr: float = 0.02, num_slots: int = 8, max_len: int = 4096,
                device="cuda"):
    """Restore a pretrained policy checkpoint into a serving stack:
    (state, engine, tok, config). One definition for the load-and-serve
    boilerplate every eval shares (uplift/online/generative/probe)."""
    import torch

    from senweaver_ide_tpu_torch.device import resolve_device
    from senweaver_ide_tpu_torch.models import get_config
    from senweaver_ide_tpu_torch.models.tokenizer import ByteTokenizer
    from senweaver_ide_tpu_torch.rollout import RolloutEngine
    from senweaver_ide_tpu_torch.training import make_train_state
    from senweaver_ide_tpu_torch.training.checkpoint import CheckpointManager

    config = get_config(model)
    dev = resolve_device(device)
    template = make_train_state(
        config, torch.Generator(device=dev.type).manual_seed(seed), None,
        learning_rate=lr, device=dev)
    state, _meta = CheckpointManager(load_dir).restore(template)
    tok = ByteTokenizer()
    engine = RolloutEngine(state.params, config, num_slots=num_slots,
                           max_len=max_len, eos_id=None, seed=seed,
                           device=dev)
    return state, engine, tok, config


# ---------------------------------------------------------------------------
# Phase 1: pretrain rule-following on the real stack
# ---------------------------------------------------------------------------

def pretrain_rule_policy(*, rounds: int = 80, lr: float = 0.02,
                         group_size: int = 16, max_new_tokens: int = 16,
                         seed: int = 0, max_parallel: int = 8,
                         anchor_kl: float = 0.02, anchor_every: int = 5,
                         entropy_coef: float = 0.02,
                         stop_mean: float = 0.9, stop_window: int = 4,
                         tasks_per_class: int = 1, prefix_bytes: int = 0,
                         model: str = "tiny-test", max_len: int = 2048,
                         state=None, engine=None, device="cuda"):
    """GRPO-pretrain rule-conditional byte emission; returns
    (state, engine, tok, config, curve).

    ``rounds`` is a CAP: training stops early once the rolling
    ``stop_window``-round reward mean exceeds ``stop_mean`` (conditioned
    and stable). Concurrent episode collection makes runs
    non-deterministic even at a fixed seed — some runs see-saw in the
    contrastive phase far longer than others (observed r4) — so callers
    should check the final window and retry with a fresh seed rather
    than assume convergence.

    ``tasks_per_class`` defaults to 1: the r3 contextual recipe's
    proven regime is 2 contrastive groups x group 16 (splitting the
    episode budget over more groups thins per-group advantages and
    drops the convergence rate to ~1 in 4, observed r4). Rule-vs-user-
    text disentanglement does not need text variety — the user text is
    IDENTICAL across classes either way — and generalization to unseen
    texts is verified by the held-out probes afterwards. The run is on
    ``device`` (a given state and engine must live there)."""
    import torch

    from senweaver_ide_tpu_torch.device import resolve_device
    from senweaver_ide_tpu_torch.models import get_config
    from senweaver_ide_tpu_torch.models.tokenizer import ByteTokenizer
    from senweaver_ide_tpu_torch.rollout import (EnginePolicyClient, RolloutEngine,
                                           RolloutSession)
    from senweaver_ide_tpu_torch.training import grpo_round, make_train_state
    from senweaver_ide_tpu_torch.training.grpo import GRPOConfig

    config = get_config(model)
    tok = ByteTokenizer()
    dev = resolve_device(device)
    if state is None:
        state = make_train_state(
            config, torch.Generator(device=dev.type).manual_seed(seed),
            None, learning_rate=lr, device=dev)
    if engine is None:
        engine = RolloutEngine(state.params, config, num_slots=8,
                               max_len=max(4096, max_len), eos_id=None,
                               seed=seed, device=dev)
    workdir = tempfile.mkdtemp(prefix="uplift_pretrain_")

    # 'low|<text>' → RULE_LOW in the system message; the key is stripped
    # before the user message reaches the policy, so both groups see the
    # SAME user text and only the rules section differs.
    rule_of_key = {"low": [RULE_LOW], "high": [RULE_HIGH]}
    tasks = [f"{key}|{text}"
             for text in PRETRAIN_TEXTS[:max(1, tasks_per_class)]
             for key in ("low", "high")]

    class RuleTaskSession(RolloutSession):
        def run_turn(self, user_message: str):
            key, _, text = user_message.partition("|")
            self.system_message_override = minimal_sysmsg(
                rule_of_key.get(key, []), prefix_bytes=prefix_bytes)
            return super().run_turn(text)

    ws = itertools.count()

    def make_session():
        client = EnginePolicyClient(engine, tok,
                                    default_max_new_tokens=max_new_tokens,
                                    record_calls=True, auto_prefix=True)
        return RuleTaskSession(client, f"{workdir}/ws{next(ws)}",
                               include_tool_definitions=False,
                               collector=device_collector(dev))

    def reward(task_idx, g, session):
        ids = session.client.call_log[-1][1]
        if not ids:
            return -1.0
        f = frac_low(ids)
        want_low = tasks[task_idx].startswith("low|")
        return 2.0 * (f if want_low else 1.0 - f) - 1.0

    gcfg = GRPOConfig(kl_coef=anchor_kl, entropy_coef=entropy_coef)
    anchor = state.params if anchor_kl > 0 else None
    curve: List[float] = []
    for r in range(rounds):
        out = grpo_round(state, config, None, make_session, tasks,
                         group_size=group_size, pad_id=tok.pad_id,
                         max_len=max_len, grpo_config=gcfg, ppo_epochs=2,
                         max_parallel=max_parallel,
                         reward_override=reward, ref_params=anchor)
        state = out.state
        engine.update_params(state.params)
        if anchor is not None and anchor_every > 0 \
                and (r + 1) % anchor_every == 0:
            anchor = state.params
        ep = [e.reward for e in out.episodes]
        curve.append(round(sum(ep) / len(ep), 4))
        print(f"[pretrain seed={seed}] round {r + 1}/{rounds} "
              f"reward {curve[-1]}", file=sys.stderr, flush=True)
        if (len(curve) >= stop_window
                and sum(curve[-stop_window:]) / stop_window >= stop_mean):
            break
    return state, engine, tok, config, curve


def pretrain_with_retries(*, max_attempts: int = 3, seed: int = 0,
                          seed_stride: int = 1, accept_tail: float = 0.75,
                          tail_window: int = 4, **pretrain_kw):
    """Run ``pretrain_rule_policy`` up to ``max_attempts`` times with
    strided seeds, keeping the BEST attempt by final-window reward mean
    (concurrent collection makes convergence stochastic; the frozen
    phase must never run on a policy that cannot follow rules).

    Returns (state, engine, tok, config, curve, seed_used, attempts_log).
    """
    best = None
    attempts = []
    for a in range(max_attempts):
        s = seed + seed_stride * a
        state, engine, tok, config, curve = pretrain_rule_policy(
            seed=s, **pretrain_kw)
        tail = (sum(curve[-tail_window:])
                / max(len(curve[-tail_window:]), 1))
        attempts.append({"seed": s, "rounds_run": len(curve),
                         "final_window_mean": round(tail, 4)})
        print(f"[pretrain] attempt seed={s} tail={tail:.3f}",
              file=sys.stderr, flush=True)
        if best is None or tail > best[0]:
            best = (tail, state, engine, tok, config, curve, s)
        if tail >= accept_tail:
            break
    _tail, state, engine, tok, config, curve, seed_used = best
    return state, engine, tok, config, curve, seed_used, attempts


# ---------------------------------------------------------------------------
# Phase 3/4: frozen-policy probes + the APO cycle
# ---------------------------------------------------------------------------

def probe_frac_low(engine, tok, rules: Sequence[str], *, episodes: int = 8,
                   max_new_tokens: int = 16, prefix_bytes: int = 0,
                   user_text: str = "write the response bytes") -> float:
    """Mean low-byte fraction of real sampled episodes under ``rules``."""
    from senweaver_ide_tpu_torch.rollout import EnginePolicyClient, RolloutSession

    workdir = tempfile.mkdtemp(prefix="uplift_probe_")
    fracs = []
    for i in range(episodes):
        client = EnginePolicyClient(engine, tok,
                                    default_max_new_tokens=max_new_tokens,
                                    record_calls=True, auto_prefix=True)
        sess = RolloutSession(client, f"{workdir}/p{i}",
                              include_tool_definitions=False,
                              system_message_override=minimal_sysmsg(
                                  rules, prefix_bytes=prefix_bytes),
                              collector=device_collector(engine.device))
        try:
            sess.run_turn(user_text)
            ids = client.call_log[-1][1] if client.call_log else []
            fracs.append(frac_low(ids))
        finally:
            sess.close()
    return sum(fracs) / max(len(fracs), 1)


RETRY_FOLLOWUP = "That is not right. Follow the required style and emit again."


def make_rule_scorer(engine, tok, workdir: str, *, target_low: bool,
                     eval_tasks: Sequence[str] = tuple(EVAL_TEXTS),
                     max_new_tokens: int = 16, good_threshold: float = 0.75,
                     max_attempts: int = DEFAULT_MAX_ATTEMPTS,
                     corpus=None, score_log: Optional[list] = None,
                     memoize: bool = True):
    """Prompt-conditioned ScoreFn on the REAL policy: re-roll the held-out
    suite under the candidate rules, judge each episode from its sampled
    tokens (symmetric outcome feedback, the reference's highest-weight
    reward dim), and batch-score the traces with the jit reward head.

    Each episode models the reference's retry dynamics: a judge-failed
    output draws a user follow-up inside the SAME conversation trace (up
    to ``max_attempts`` turns) — exactly the P4 "blind retries" / P5
    "poor first-attempt resolution" shapes (apoService.ts:712-750). An
    un-steered policy therefore pays real llm-call/turn-count reward
    penalties, while a steered one answers on the first attempt; good
    feedback additionally requires success within 2 attempts.

    Candidate scores are memoized by rule-set content (``memoize``):
    beam search re-proposes duplicate candidates across rounds and a
    frozen policy's score estimate does not change. Callers whose
    engine weights move between scoring passes (the online loop) must
    pass ``memoize=False``.

    ``target_low`` may be a bool or a 0-arg callable returning one —
    the callable form serves task-shift evals where the demanded byte
    class changes mid-run (the scorer re-reads it on every call). Traces
    are scored on the engine's device."""
    import torch

    from senweaver_ide_tpu_torch.rewards.head import reward_head_batch
    from senweaver_ide_tpu_torch.rollout import EnginePolicyClient, RolloutSession
    from senweaver_ide_tpu_torch.traces.features import batch_features

    counter = itertools.count()
    cache: dict = {}

    def score(rules: Sequence[str]) -> float:
        tl = target_low() if callable(target_low) else target_low
        key = (tuple(rules), tl)   # class flips invalidate cached scores
        if memoize and key in cache:
            return cache[key]
        traces = []
        goods = 0
        attempts_used: List[int] = []
        for task in eval_tasks:
            client = EnginePolicyClient(
                engine, tok, default_max_new_tokens=max_new_tokens,
                record_calls=True, auto_prefix=True)
            sess = RolloutSession(
                client, os.path.join(workdir, f"ev{next(counter)}"),
                include_tool_definitions=False,
                system_message_override=minimal_sysmsg(rules),
                collector=(corpus if corpus is not None
                           else device_collector(engine.device)))

            def agreement() -> float:
                ids = client.call_log[-1][1] if client.call_log else []
                f = frac_low(ids)
                return f if tl else 1.0 - f

            attempts = [1]

            def follow_up(_turn_result, _turn):
                if agreement() >= good_threshold:
                    return None          # passed — no follow-up needed
                attempts[0] += 1
                return RETRY_FOLLOWUP

            try:
                out = sess.run_conversation(task, next_message=follow_up,
                                            max_turns=max_attempts)
                ok = agreement() >= good_threshold
                fb = "good" if ok and attempts[0] <= 2 else "bad"
                goods += fb == "good"
                attempts_used.append(attempts[0])
                sess.record_feedback(fb)
                trace = (sess.collector.get_trace(out.trace.id)
                         if out.trace is not None else None)
                if trace is not None:
                    traces.append(trace)
            finally:
                sess.close()
        if not traces:
            return 0.0
        feats = torch.as_tensor(batch_features(traces), device=engine.device)
        s = float(reward_head_batch(feats).final_reward.mean())
        cache[key] = s
        if score_log is not None:
            score_log.append({
                "rules": list(rules), "score": round(s, 4),
                "good_rate": round(goods / len(eval_tasks), 3),
                "mean_attempts": round(sum(attempts_used)
                                       / max(len(attempts_used), 1), 2)})
        return s

    return score


def run_real_uplift(engine, tok, *, beam_rounds: int = 3,
                    proposer_seed: int = 0,
                    good_threshold: float = 0.75,
                    eval_tasks: Sequence[str] = tuple(EVAL_TEXTS),
                    max_attempts: int = DEFAULT_MAX_ATTEMPTS,
                    probe_episodes: int = 8,
                    proposer=None) -> dict:
    """Probes + full APO cycle on the frozen engine params; returns the
    report dict (no weight update happens anywhere in here)."""
    from senweaver_ide_tpu_torch.apo.local import make_local_apo
    from senweaver_ide_tpu_torch.apo.types import APOConfig
    # the corpus scores its traces on the engine's device (device_collector)

    t0 = time.monotonic()
    probes = {
        "rule_low": probe_frac_low(engine, tok, [RULE_LOW],
                                   episodes=probe_episodes),
        "rule_high": probe_frac_low(engine, tok, [RULE_HIGH],
                                    episodes=probe_episodes),
        "no_rules": probe_frac_low(engine, tok, [],
                                   episodes=probe_episodes),
        "decoy": probe_frac_low(engine, tok, [DECOY_RULE],
                                episodes=probe_episodes),
    }
    # Target the class the frozen prior does NOT produce: the baseline
    # (no rules) must fail on its own merits for uplift to be meaningful.
    target_low = probes["no_rules"] < 0.5
    conditioning_delta = probes["rule_low"] - probes["rule_high"]

    workdir = tempfile.mkdtemp(prefix="uplift_real_")
    score_log: List[dict] = []
    corpus = device_collector(engine.device)
    # Baseline pass populates the APO corpus (feedback'd traces feed the
    # textual-gradient prompts, as in run_uplift_eval).
    baseline = make_rule_scorer(engine, tok, workdir, target_low=target_low,
                                good_threshold=good_threshold,
                                eval_tasks=eval_tasks,
                                max_attempts=max_attempts,
                                corpus=corpus)([])
    score_fn = make_rule_scorer(engine, tok, workdir, target_low=target_low,
                                good_threshold=good_threshold,
                                eval_tasks=eval_tasks,
                                max_attempts=max_attempts,
                                score_log=score_log)
    apo = make_local_apo(
        corpus, proposer or BankProposer(RULE_BANK, seed=proposer_seed),
        config=APOConfig(beam_rounds=1), score_fn=score_fn,
        device=engine.device)
    # One visible round at a time: the per-round best-score progression is
    # the "search matters" evidence (VERDICT r3 weak #3).
    round_best: List[float] = []
    state = None
    for _ in range(beam_rounds):
        state = apo.run_beam_search(seed_prompt="")
        round_best.append(round(state.history_best_score, 4))
    optimized_rules = apo.get_optimized_rules()
    optimized = make_rule_scorer(engine, tok, workdir, target_low=target_low,
                                 good_threshold=good_threshold,
                                 eval_tasks=eval_tasks,
                                 max_attempts=max_attempts)(optimized_rules)
    return {
        "metric": "uplift_realpolicy",
        "probes_frac_low": {k: round(v, 4) for k, v in probes.items()},
        "conditioning_delta": round(conditioning_delta, 4),
        "target_class": "low" if target_low else "high",
        "baseline_final_reward": round(baseline, 4),
        "optimized_final_reward": round(optimized, 4),
        "uplift_delta": round(optimized - baseline, 4),
        "uplift_ratio_shifted": round((optimized + 1.0)
                                      / max(baseline + 1.0, 1e-6), 4),
        "optimized_rules": list(optimized_rules),
        "beam_round_best_scores": round_best,
        "searched": bool(round_best and round_best[0]
                         < round_best[-1] - 1e-9),
        "candidates_scored": len(score_log),
        "score_log": score_log,
        "tasks": list(eval_tasks),
        "evaluator": ("symmetric outcome feedback from sampled tokens "
                      f"(agreement >= {good_threshold}; judge-failed "
                      "attempts draw user follow-ups in the same trace, "
                      "good requires success within 2 attempts)"),
        "evaluator_config": {"max_attempts": max_attempts,
                             "good_threshold": good_threshold,
                             "probe_episodes": probe_episodes,
                             "beam_rounds": beam_rounds},
        "policy": "real transformer, frozen after pretraining",
        "uplift_wall_s": round(time.monotonic() - t0, 1),
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=80,
                    help="pretraining GRPO rounds")
    ap.add_argument("--group-size", type=int, default=16)
    ap.add_argument("--lr", type=float, default=0.02)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--beam-rounds", type=int, default=3)
    ap.add_argument("--max-attempts", type=int,
                    default=DEFAULT_MAX_ATTEMPTS,
                    help="user-patience bound per episode: a judge-"
                         "failed output draws follow-ups in the same "
                         "trace until this many attempts; 8 puts an "
                         "un-steered episode's llm-call count at the "
                         "agent-mode response-efficiency floor (T=3, "
                         "-0.4/extra call) — the severity band the "
                         "reference's P4 retries pattern describes")
    ap.add_argument("--model", default="tiny-test",
                    help="pretrain model preset (small-test = the "
                         "capacity fallback when tiny cannot condition)")
    ap.add_argument("--save-dir", default=None,
                    help="save the pretrained checkpoint here")
    ap.add_argument("--load-dir", default=None,
                    help="skip pretraining; restore checkpoint from here")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA card)")
    args = ap.parse_args()

    from senweaver_ide_tpu_torch.device import resolve_device
    device = resolve_device("cpu" if args.cpu else "cuda")

    t0 = time.monotonic()
    if args.load_dir:
        state, engine, tok, config = load_policy(
            args.load_dir, model=args.model, seed=args.seed, lr=args.lr,
            device=device)
        curve = []
    else:
        # Pretraining is stochastic (concurrent collection): retry with
        # fresh seeds until the final window shows conditioning, so the
        # frozen-policy phase never runs on a policy that cannot follow
        # rules (that measures nothing).
        state, engine, tok, config, curve, seed, attempts = \
            pretrain_with_retries(seed=args.seed, rounds=args.rounds,
                                  lr=args.lr, group_size=args.group_size,
                                  model=args.model, device=device)
        if args.save_dir:
            from senweaver_ide_tpu_torch.training.checkpoint import \
                CheckpointManager
            CheckpointManager(args.save_dir).save(
                state, extra_meta={"eval": "uplift_real_pretrain"})
    pretrain_wall = time.monotonic() - t0

    report = run_real_uplift(engine, tok, beam_rounds=args.beam_rounds,
                             proposer_seed=args.seed,
                             max_attempts=args.max_attempts)
    report["pretrain"] = {
        "rounds": len(curve), "curve": curve,
        "group_size": args.group_size, "lr": args.lr,
        # the seed the CONVERGED attempt ran with (the retry loop may
        # have moved past args.seed) — what a reproduction needs
        "seed": (args.seed if args.load_dir else seed),
        "wall_s": round(pretrain_wall, 1),
        "loaded_from": args.load_dir,
        "attempts": attempts if not args.load_dir else None,
    }
    print(json.dumps(report))


if __name__ == "__main__":
    try:
        main()
    except Exception as e:   # always leave a JSON line for the caller
        print(json.dumps({"error": f"{type(e).__name__}: {e}"}))
        sys.exit(1)
