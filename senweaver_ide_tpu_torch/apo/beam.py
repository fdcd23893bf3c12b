"""Beam-Search prompt optimization, executed locally against the policy.

In the reference, beam search lives on the backend (``POST /api/apo/optimize``,
``common/apoService.ts:992-1215``) and the client only keeps ``BeamSearchState``
(:156-165) and applies the winner (:1219-1264). The TPU build in-trees the whole
loop (SURVEY.md §3.3): candidate prompts are produced by Textual-Gradient
critique+edit against the *local* policy LLM, and candidates are scored by
batched evaluation: the port's reward head runs over the eval corpus's
feature rows in one batched pass on ``device`` (the card unless the caller
names the CPU).

Defaults follow the reference: beamWidth=4, branchFactor=4, beamRounds=3,
gradientBatchSize=4 (apoService.ts:287-291).
"""

from __future__ import annotations

import logging
import time
from typing import Callable, List, Optional, Sequence

import torch

from ..device import resolve_device
from ..obs import get_tracer
from ..rewards.head import reward_head_batch
from ..traces.schema import Trace
from ..traces.features import batch_features
from .gradient import (build_apply_edit_prompt, build_textual_gradient_prompt,
                       parse_rules)
from .types import APOConfig, BeamState, PromptVersion, RolloutResult

# Type of the policy text interface: prompt -> completion.
GenerateFn = Callable[[str], str]
# Candidate scorer: rules -> scalar score (higher is better).
ScoreFn = Callable[[Sequence[str]], float]


def corpus_score_fn(traces: List[Trace], *, device="cuda") -> ScoreFn:
    """Fallback scorer: mean finalReward of an eval corpus.

    This is prompt-INDEPENDENT (one batched reward-head pass on ``device``,
    computed once): it establishes the corpus baseline but cannot rank
    candidates, so a beam search run with it degenerates to keeping the
    seed. Real candidate ranking comes from a prompt-conditioned scorer that
    re-rolls the corpus under each candidate with the policy (rollout
    engine); the interface is identical.
    """
    dev = resolve_device(device)
    feats = torch.from_numpy(batch_features(traces)).to(dev)
    if feats.shape[0] == 0:
        baseline = 0.0
    else:
        baseline = float(torch.mean(reward_head_batch(feats).final_reward))

    def score(_rules: Sequence[str]) -> float:
        return baseline

    return score


def propose_candidates(
    parent: PromptVersion,
    rollouts: Sequence[RolloutResult],
    generate_fn: GenerateFn,
    branch_factor: int,
    state: BeamState,
) -> List[PromptVersion]:
    """Textual-gradient branch expansion: critique the parent against a batch
    of rollouts, then apply-edit to produce ``branch_factor`` children."""
    with get_tracer().span("apo.propose", parent=parent.version,
                           branch_factor=branch_factor):
        return _propose_candidates_impl(parent, rollouts, generate_fn,
                                        branch_factor, state)


def _propose_candidates_impl(
    parent: PromptVersion,
    rollouts: Sequence[RolloutResult],
    generate_fn: GenerateFn,
    branch_factor: int,
    state: BeamState,
) -> List[PromptVersion]:
    parent_rules = parse_rules(parent.content) or (
        [parent.content] if parent.content else [])
    children: List[PromptVersion] = []
    seen = set()
    # Branch diversity: a deterministic (greedy-decoded) policy would return
    # identical critiques for identical prompts, collapsing the branch factor
    # to 1 — steer each branch at a different focus area of the critique task.
    focus_cycle = ("structural issues", "instruction quality",
                   "control and behavior", "input/output specification",
                   "scope and safety")
    for b in range(branch_factor):
        base = build_textual_gradient_prompt(parent_rules, rollouts)
        steer = (f"\n\nFor this critique, weight focus area "
                 f"'{focus_cycle[b % len(focus_cycle)]}' most heavily "
                 f"(branch {b + 1} of {branch_factor}).")
        critique = generate_fn(base + steer)
        edited = generate_fn(build_apply_edit_prompt(parent_rules, critique))
        rules = parse_rules(edited)
        content = "\n".join(f"- {r}" for r in rules) if rules else edited.strip()
        if not content or content in seen:
            continue
        seen.add(content)
        children.append(PromptVersion(
            version=state.next_version(), content=content,
            parent_version=parent.version))
    return children


def beam_search(
    seed_prompt: str,
    rollouts: Sequence[RolloutResult],
    generate_fn: GenerateFn,
    score_fn: ScoreFn,
    config: Optional[APOConfig] = None,
    state: Optional[BeamState] = None,
) -> BeamState:
    """Run beamRounds of expand→score→top-k; returns the final BeamState with
    ``history_best_prompt`` set (ref backend beamUpdate → _applyBeamBestPrompt)."""
    cfg = config or APOConfig()
    st = state or BeamState(total_rounds=cfg.beam_rounds)
    if state is not None:
        # Resumed search: extend the horizon so current_round never exceeds
        # total_rounds (the reference tracks currentRound against totalRounds,
        # apoService.ts:1143-1157).
        st.total_rounds = max(st.total_rounds, st.current_round + cfg.beam_rounds)
    if not st.beam:
        seed = PromptVersion(version=st.next_version(), content=seed_prompt)
        seed.score = score_fn(parse_rules(seed.content) or [seed.content])
        st.beam = [seed]
        if seed.score > st.history_best_score:
            st.history_best_score = seed.score
            st.history_best_prompt = seed

    tracer = get_tracer()
    while st.current_round < st.total_rounds:
        st.current_round += 1
        with tracer.span("apo.beam_round", round=st.current_round,
                         beam=len(st.beam)):
            candidates: List[PromptVersion] = list(st.beam)
            for parent in st.beam:
                candidates.extend(propose_candidates(
                    parent, rollouts, generate_fn, cfg.branch_factor, st))
            with tracer.span("apo.score", candidates=len(candidates)):
                for cand in candidates:
                    if cand.score is None:
                        cand.score = score_fn(parse_rules(cand.content)
                                              or [cand.content])
            candidates.sort(key=lambda c: c.score if c.score is not None
                            else float("-inf"), reverse=True)
        st.beam = candidates[: cfg.beam_width]
        if st.beam and st.beam[0].score is not None \
                and st.beam[0].score > st.history_best_score:
            st.history_best_score = st.beam[0].score
            st.history_best_prompt = st.beam[0]
        st.last_updated_at = time.time() * 1000.0
    return st
