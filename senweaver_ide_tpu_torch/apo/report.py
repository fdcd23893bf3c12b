"""Effectiveness-report builder + local suggestion generation.

Semantics of ``_buildReport`` (``common/apoService.ts:498-625``) and
``_generateLocalSuggestions`` (:775-862): goodRate, per-mode stats, reward
dimension aggregates, pattern detection, and rule-based suggestions.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

from ..traces.schema import Trace, new_id
from .patterns import analyze_patterns, reward_dimension_patterns
from .types import (DIM_CATEGORY_MAP, EffectivenessReport, IssuePattern,
                    ModeStats, Suggestion, new_suggestion)


def _extract_mode(trace: Trace) -> str:
    """Ref ``_extractMode`` (:627-633): metadata chatMode or 'unknown'."""
    mode = trace.metadata.get("chatMode")
    return str(mode) if mode else "unknown"


def reward_by_dimension(traces: List[Trace]) -> Dict[str, Dict[str, float]]:
    """Per-dimension {sum, count, avg} aggregates (ref :556-568)."""
    agg: Dict[str, Dict[str, float]] = {}
    for t in traces:
        if t.summary.final_reward is None:
            continue
        for dim in t.summary.reward_dimensions:
            d = agg.setdefault(dim["name"], {"sum": 0.0, "count": 0, "avg": 0.0})
            d["sum"] += dim["value"]
            d["count"] += 1
    for d in agg.values():
        d["avg"] = d["sum"] / d["count"] if d["count"] > 0 else 0.0
    return agg


def build_report(traces: List[Trace]) -> EffectivenessReport:
    """Build the full effectiveness report over a trace window (ref :498-625)."""
    now = time.time() * 1000.0
    good = bad = none = 0
    by_mode: Dict[str, ModeStats] = {}
    oldest, newest = float("inf"), 0.0

    for t in traces:
        oldest = min(oldest, t.start_time)
        newest = max(newest, t.start_time)
        fb = t.summary.user_feedback
        if fb == "good":
            good += 1
        elif fb == "bad":
            bad += 1
        else:
            none += 1
        mode = by_mode.setdefault(_extract_mode(t), ModeStats())
        mode.total += 1
        if fb == "good":
            mode.good += 1
        if fb == "bad":
            mode.bad += 1

    for m in by_mode.values():
        with_fb = m.good + m.bad
        m.good_rate = m.good / with_fb if with_fb > 0 else 0.0

    with_fb = good + bad
    good_rate = good / with_fb if with_fb > 0 else 0.0

    with_reward = [t for t in traces if t.summary.final_reward is not None]
    avg_reward = (sum(t.summary.final_reward for t in with_reward) / len(with_reward)
                  if with_reward else None)
    rbd = reward_by_dimension(traces)

    patterns = analyze_patterns(traces)
    patterns.extend(reward_dimension_patterns(rbd))

    suggestions = generate_local_suggestions(good_rate, patterns, by_mode,
                                             avg_reward, rbd)

    return EffectivenessReport(
        id=new_id(),
        generated_at=now,
        period_from=now if oldest == float("inf") else oldest,
        period_to=newest or now,
        total_conversations=len(traces),
        good_feedback_count=good,
        bad_feedback_count=bad,
        no_feedback_count=none,
        good_rate=good_rate,
        by_mode=by_mode,
        patterns=patterns,
        suggestions=suggestions,
        avg_reward=avg_reward,
        reward_by_dimension=rbd,
    )


def generate_local_suggestions(
        good_rate: float,
        patterns: List[IssuePattern],
        by_mode: Dict[str, ModeStats],
        avg_reward: Optional[float] = None,
        reward_by_dim: Optional[Dict[str, Dict[str, float]]] = None,
) -> List[Suggestion]:
    """Rule-based suggestion generation (ref :775-862)."""
    out: List[Suggestion] = []

    # Overall goodRate < 0.5 → systemic issue (ref :784-797).
    if 0.0 < good_rate < 0.5:
        reward_info = (f" (avg reward: {avg_reward:.3f})"
                       if avg_reward is not None else "")
        out.append(new_suggestion(
            target_category="core_behavior", type="modify", priority="high",
            description=(f"Overall approval rate is only {good_rate * 100:.1f}%"
                         f"{reward_info}, comprehensive prompt optimization needed"),
            reasoning=("Approval rate below 50% indicates systemic issues with "
                       "the current prompt; run deep APO optimization"),
            estimated_impact="Expected to improve approval rate by 10-20%",
        ))

    # Negative dim averages with n≥3 → targeted suggestion (ref :800-830).
    if reward_by_dim:
        for name, stats in reward_by_dim.items():
            if stats["avg"] < 0 and stats["count"] >= 3:
                out.append(new_suggestion(
                    target_category=DIM_CATEGORY_MAP.get(name, "core_behavior"),
                    type="modify",
                    priority="high" if stats["avg"] < -0.5 else "medium",
                    description=(f"{name} dimension performing poorly "
                                 f"(avg: {stats['avg']:.3f}, n={int(stats['count'])})"),
                    reasoning=("This reward dimension is consistently negative; "
                               f"prompt guidance needs improvement for {name}"),
                    estimated_impact=(f"Expected to improve {name} dimension "
                                      "reward by 0.2-0.5"),
                ))

    # High-severity patterns → targeted suggestion (ref :833-846).
    for p in patterns:
        if p.severity == "high":
            out.append(new_suggestion(
                target_category=p.related_category, type="modify", priority="high",
                description=(f"High-frequency issue: {p.description} "
                             f"(occurred {p.frequency} times)"),
                reasoning=("This problem pattern occurs frequently with high "
                           "severity; optimize the related prompt rules"),
                estimated_impact=(f"Expected to reduce {min(p.frequency, 5)} "
                                  "similar issues"),
            ))

    # Per-mode goodRate < 0.3 with n≥5 (ref :849-861).
    for mode, stats in by_mode.items():
        if stats.total >= 5 and stats.good_rate < 0.3:
            out.append(new_suggestion(
                target_category="mode_specific", type="modify", priority="medium",
                description=(f"{mode} mode approval rate is only "
                             f"{stats.good_rate * 100:.1f}%, prompt optimization "
                             "needed for this mode"),
                reasoning=("This mode's approval rate is significantly below "
                           "average; mode-specific prompt rules may need adjustment"),
                estimated_impact=f"Expected to improve {mode} mode approval rate",
            ))

    return out
