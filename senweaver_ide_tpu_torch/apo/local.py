"""Local-policy APO execution: the optimizer LLM moves in-tree.

In the reference the critique/edit/beam models live on the backend
(`apoService.ts:992-1215` POST /api/apo/optimize, :1268-1343 POST
/api/apo/gradient — SURVEY.md §3.3 'the optimizer LLM lives on the
backend'). Here the same prompts run against the LOCAL policy through any
PolicyClient — the full APO cycle (analyze → textual gradient → beam
search → segment apply → rule injection) needs no network:

    apo = make_local_apo(collector, client)
    apo.maybe_auto_analyze()
    apo.request_textual_gradient()
    best = apo.run_beam_search()
    rules = apo.get_optimized_rules()      # → prompts.render_apo_rules
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

from ..agents.llm import ChatMessage, PolicyClient
from ..traces.collector import TraceCollector
from .service import APOService
from .types import APOConfig


def policy_generate_fn(client: PolicyClient, *,
                       max_tokens: int = 512,
                       temperature: float = 0.7
                       ) -> Callable[[str], str]:
    """Adapt a PolicyClient to APO's GenerateFn (prompt str → text).

    Temperature defaults >0: beam branches need diversity on top of the
    focus-area steering (beam.propose_candidates)."""
    def generate(prompt: str) -> str:
        try:
            resp = client.chat([ChatMessage("user", prompt)],
                               temperature=temperature,
                               max_tokens=max_tokens)
            return resp.text
        except Exception:
            return ""          # ref: failed backend call → no suggestion
    return generate


def corpus_score_from_collector(collector: TraceCollector, *,
                                device="cuda"
                                ) -> Callable[[Sequence[str]], float]:
    """Score candidate rule-sets against the LIVE trace corpus: the
    collector is re-read on every call, so traces gathered after
    construction count (a startup-time snapshot would bake an empty
    baseline forever). The reward head runs on ``device``."""
    from .beam import corpus_score_fn

    def score(rules: Sequence[str]) -> float:
        return corpus_score_fn(collector.get_all_traces(),
                               device=device)(rules)

    return score


def make_local_apo(collector: TraceCollector, client: PolicyClient, *,
                   config: Optional[APOConfig] = None,
                   score_fn: Optional[Callable[[Sequence[str]], float]]
                   = None,
                   make_session: Optional[Callable] = None,
                   eval_tasks: Optional[Sequence[str]] = None,
                   max_tokens: int = 512,
                   device="cuda") -> APOService:
    """Fully-local APOService: policy-backed generation + candidate scoring.

    Scoring priority: explicit ``score_fn`` > prompt-conditioned rollout
    scorer (when ``make_session`` is given — re-rolls ``eval_tasks`` under
    each candidate; apo/eval.py) > the prompt-independent corpus baseline
    (which cannot rank candidates; beam degenerates to the seed). The
    two built-in scorers run the reward head on ``device``."""
    if score_fn is None and make_session is not None:
        from .eval import SIX_PATTERN_TASKS, make_rollout_score_fn
        score_fn = make_rollout_score_fn(
            make_session, tuple(eval_tasks or SIX_PATTERN_TASKS),
            device=device)
    return APOService(
        collector,
        generate_fn=policy_generate_fn(client, max_tokens=max_tokens),
        score_fn=score_fn or corpus_score_from_collector(collector,
                                                         device=device),
        config=config)
