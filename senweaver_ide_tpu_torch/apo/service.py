"""APOService — the orchestrator of the online prompt-optimization loop.

Semantics of ``common/apoService.ts`` (class APOService): analysis gates
(≥20 traces, ≥10 feedbacks, 1 h interval, :282-284,:454-472), report
building + suggestion generation, trace→rollout conversion, textual-gradient
requests, and beam-search application — with the backend LLM replaced by a
local policy callable (the TPU-hosted model), closing the loop in-tree.
"""

from __future__ import annotations

import logging
import time
from typing import List, Optional

from ..traces.collector import TraceCollector
from ..traces.schema import new_id
from .beam import GenerateFn, ScoreFn, beam_search, corpus_score_fn
from .gradient import build_apply_edit_prompt, build_textual_gradient_prompt
from .report import build_report
from .rollouts import traces_to_rollouts
from .segments import SegmentStore
from .types import (APOConfig, BeamState, EffectivenessReport, MAX_REPORTS,
                    TextualGradient, new_suggestion)

_log = logging.getLogger(__name__)


class APOService:
    def __init__(self, collector: TraceCollector,
                 generate_fn: Optional[GenerateFn] = None,
                 score_fn: Optional[ScoreFn] = None,
                 config: Optional[APOConfig] = None,
                 segment_store: Optional[SegmentStore] = None):
        self.collector = collector
        self.generate_fn = generate_fn
        self.score_fn = score_fn
        self.config = config or APOConfig()
        self.segments = segment_store or SegmentStore()
        self.reports: List[EffectivenessReport] = []
        self.textual_gradients: List[TextualGradient] = []
        self.beam_state: Optional[BeamState] = None
        self._last_analysis_ms: Optional[float] = None

    # --- gates (ref _tryAutoAnalyze :454-472) ---

    def should_auto_analyze(self, now_ms: Optional[float] = None) -> bool:
        if not (self.config.enabled and self.config.auto_analyze_enabled):
            return False
        now_ms = now_ms if now_ms is not None else time.time() * 1000.0
        if (self._last_analysis_ms is not None
                and now_ms - self._last_analysis_ms
                < self.config.auto_analyze_interval_ms):
            return False
        stats = self.collector.get_stats()
        return (stats["total_traces"] >= self.config.min_traces_for_analysis
                and stats["total_feedbacks"] >= self.config.min_feedbacks_for_analysis)

    def should_auto_gradient(self) -> bool:
        """Gradient trigger: goodRate < 0.7 with ≥15 feedbacks (ref :468-472)."""
        report = self.get_latest_report()
        if report is None:
            return False
        feedbacks = report.good_feedback_count + report.bad_feedback_count
        return (report.good_rate < self.config.gradient_good_rate_threshold
                and feedbacks >= self.config.gradient_min_feedbacks)

    # --- analysis (ref analyzePromptEffectiveness :477-496) ---

    def analyze(self) -> EffectivenessReport:
        report = build_report(self.collector.get_all_traces())
        self.reports.append(report)
        del self.reports[:-MAX_REPORTS]
        self.segments.add_suggestions(report.suggestions)
        self._last_analysis_ms = time.time() * 1000.0
        return report

    def maybe_auto_analyze(self) -> Optional[EffectivenessReport]:
        if not self.should_auto_analyze():
            return None
        report = self.analyze()
        if self.should_auto_gradient():
            self.request_textual_gradient()
        return report

    # --- textual gradient against the local policy (ref :1268-1343) ---

    def request_textual_gradient(self) -> Optional[TextualGradient]:
        if self.generate_fn is None:
            return None
        recent = sorted(
            (t for t in self.collector.get_all_traces()
             if t.summary.user_feedback is not None),
            key=lambda t: t.start_time, reverse=True,
        )[: self.config.gradient_batch_size]
        if len(recent) < 2:  # ref :1277
            return None
        rollouts = traces_to_rollouts(recent)
        rules = self.segments.get_optimized_rules()
        critique = self.generate_fn(
            build_textual_gradient_prompt(rules, rollouts))
        if not critique:
            return None
        rewards = [r.final_reward or 0.0 for r in rollouts]
        tg = TextualGradient(
            id=new_id(),
            prompt_version=(self.beam_state.history_best_prompt.version
                            if self.beam_state and self.beam_state.history_best_prompt
                            else "v0"),
            critique=critique,
            rollout_summary=(f"Based on {len(rollouts)} rollouts, avg reward: "
                             f"{sum(rewards) / len(rewards):.3f}"),
        )
        self.textual_gradients.append(tg)

        edited = self.generate_fn(build_apply_edit_prompt(rules, critique))
        if edited:
            self.segments.add_suggestions([new_suggestion(
                target_category="core_behavior", type="modify", priority="high",
                description=f"Textual Gradient: {critique[:100]}...",
                suggested_content=edited,
                reasoning=critique,
                estimated_impact="Prompt optimization based on Textual Gradient",
                prompt_version=tg.prompt_version,
            )])
        return tg

    # --- beam search (in-treed backend optimize path, ref :992-1215) ---

    def run_beam_search(self, seed_prompt: Optional[str] = None) -> BeamState:
        if self.generate_fn is None:
            raise RuntimeError("beam search needs a generate_fn (policy LLM)")
        traces = [t for t in self.collector.get_all_traces()
                  if t.summary.user_feedback is not None]
        rollouts = traces_to_rollouts(
            sorted(traces, key=lambda t: t.start_time, reverse=True)[:20])
        score = self.score_fn
        if score is None:
            _log.warning(
                "run_beam_search: no score_fn set — falling back to the "
                "prompt-independent corpus baseline; candidates will tie and "
                "the seed prompt will win. Wire a rollout-engine scorer for "
                "real optimization.")
            score = corpus_score_fn(self.collector.get_all_traces())
        seed = seed_prompt if seed_prompt is not None else "\n".join(
            f"- {r}" for r in self.segments.get_optimized_rules())
        self.beam_state = beam_search(seed, rollouts, self.generate_fn, score,
                                      self.config, self.beam_state)
        if self.beam_state.history_best_prompt is not None:
            self.segments.apply_beam_best_prompt(
                self.beam_state.history_best_prompt)
        return self.beam_state

    # --- queries (ref getStats :1470-1508) ---

    def get_latest_report(self) -> Optional[EffectivenessReport]:
        return self.reports[-1] if self.reports else None

    def get_optimized_rules(self) -> List[str]:
        return self.segments.get_optimized_rules()

    def get_stats(self) -> dict:
        report = self.get_latest_report()
        traces = self.collector.get_all_traces()
        with_reward = [t for t in traces if t.summary.final_reward is not None]
        return {
            "total_reports": len(self.reports),
            "total_suggestions": len(self.segments.suggestions),
            "applied_suggestions": sum(1 for s in self.segments.suggestions
                                       if s.status == "applied"),
            "rejected_suggestions": sum(1 for s in self.segments.suggestions
                                        if s.status == "rejected"),
            "active_segments": len(self.segments.get_active_segments()),
            "optimized_segments": len(self.segments.get_optimized_rules()),
            "last_analysis_time": self._last_analysis_ms,
            "current_good_rate": report.good_rate if report else None,
            "beam_search_active": self.beam_state is not None,
            "beam_current_round": (self.beam_state.current_round
                                   if self.beam_state else None),
            "beam_best_score": (self.beam_state.history_best_score
                                if self.beam_state
                                and self.beam_state.history_best_prompt else None),
            "total_textual_gradients": len(self.textual_gradients),
            "avg_final_reward": (sum(t.summary.final_reward for t in with_reward)
                                 / len(with_reward) if with_reward else None),
        }


def install_apo_channel(server, apo: "APOService") -> None:
    """Expose APO operator actions over the control plane (JSON-RPC).

    The reference UI drives its APO service directly from the renderer
    (suggestion apply/reject buttons, manual analyze — apoService.ts
    segment lifecycle :1375-1458); here the same operations ride the
    control socket so BOTH the CLI and the dashboard's action endpoint
    can drive them, under the server's auth token. Mirrors
    services.config.install_config_channel's pattern."""

    def _suggestion_row(s) -> dict:
        return {"id": s.id, "status": s.status, "priority": s.priority,
                "type": s.type, "category": s.target_category,
                "description": s.description,
                "content": s.suggested_content}

    def _stats(_params):
        out = dict(apo.get_stats())
        out["optimized_rules"] = apo.get_optimized_rules()
        return out

    def _analyze(_params):
        report = apo.analyze()
        return {"good_rate": report.good_rate,
                "total_conversations": report.total_conversations,
                "patterns": len(report.patterns),
                "suggestions": [_suggestion_row(s)
                                for s in report.suggestions]}

    def _gradient(_params):
        tg = apo.request_textual_gradient()
        if tg is None:
            return {"requested": False}
        return {"requested": True, "critique": tg.critique}

    def _suggestions(_params):
        return [_suggestion_row(s) for s in apo.segments.suggestions]

    def _lifecycle(fn):
        def handler(params):
            sid = params.get("id") if isinstance(params, dict) \
                else (str(params) if params is not None else None)
            if not sid:
                raise ValueError("missing suggestion id")
            ok = fn(sid)
            if not ok:
                raise KeyError(f"suggestion not actionable: {sid}")
            return {"id": sid, "rules": apo.get_optimized_rules()}
        return handler

    server.register("apo.stats", _stats)
    server.register("apo.analyze", _analyze)
    server.register("apo.gradient", _gradient)
    server.register("apo.suggestions", _suggestions)
    server.register("apo.apply", _lifecycle(apo.segments.apply_suggestion))
    server.register("apo.reject", _lifecycle(apo.segments.reject_suggestion))
    server.register("apo.revert", _lifecycle(apo.segments.revert_suggestion))


# APO → system prompt injection budget (convertToLLMMessageService.ts:835).
APO_RULES_MAX_CHARS = 2000


def format_apo_rules_section(rules: List[str],
                             max_chars: int = APO_RULES_MAX_CHARS) -> str:
    """Render optimized rules as the '# APO Optimized Rules' system-message
    section under the 2000-char budget (convertToLLMMessageService.ts:834-856)."""
    if not rules:
        return ""
    lines = ["# APO Optimized Rules"]
    used = len(lines[0])
    for rule in rules:
        line = f"- {rule}"
        if used + len(line) + 1 > max_chars:
            break
        lines.append(line)
        used += len(line) + 1
    return "\n".join(lines) if len(lines) > 1 else ""
