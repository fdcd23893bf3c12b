"""Prompt-segment store: apply / reject / revert lifecycle with versioning.

Semantics of the segment management block in ``common/apoService.ts``:
``getActiveSegments``/``getOptimizedRules`` (:1356-1372), ``applySuggestion``
(:1375-1413), ``rejectSuggestion`` (:1416-1423), ``revertSuggestion``
(:1426-1462), and beam best-prompt application ``_applyBeamBestPrompt``
(:1219-1264).
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional

from ..traces.schema import new_id
from .types import MAX_SUGGESTIONS, PromptSegment, PromptVersion, Suggestion


def _now_ms() -> float:
    return time.time() * 1000.0


class SegmentStore:
    """Versioned prompt segments + suggestion lifecycle."""

    def __init__(self, path: Optional[str] = None):
        self.segments: List[PromptSegment] = []
        self.suggestions: List[Suggestion] = []
        self._path = path
        if path and os.path.exists(path):
            self._load()

    # --- queries (ref :1356-1372) ---

    def get_active_segments(self) -> List[PromptSegment]:
        return [s for s in self.segments if s.is_active]

    def get_optimized_prompt_for_category(self, category: str) -> Optional[str]:
        for s in self.segments:
            if s.is_active and s.is_optimized and s.category == category:
                return s.content
        return None

    def get_optimized_rules(self) -> List[str]:
        return [s.content for s in self.segments if s.is_active and s.is_optimized]

    # --- suggestion lifecycle (ref :1375-1462) ---

    def add_suggestions(self, suggestions: List[Suggestion]) -> None:
        self.suggestions.extend(suggestions)
        del self.suggestions[:-MAX_SUGGESTIONS]  # bound, ref apoService.ts:276
        self._save()

    def _find_suggestion(self, sid: str) -> Optional[Suggestion]:
        return next((s for s in self.suggestions if s.id == sid), None)

    def apply_suggestion(self, sid: str) -> bool:
        sug = self._find_suggestion(sid)
        if sug is None or sug.status != "pending":
            return False
        sug.status = "applied"
        sug.applied_at = _now_ms()
        if sug.suggested_content:
            target = None
            if sug.target_segment_id:
                target = next((s for s in self.segments
                               if s.id == sug.target_segment_id), None)
            else:
                target = next((s for s in self.segments
                               if s.category == sug.target_category and s.is_active),
                              None)
            if target is not None and sug.type == "modify":
                target.original_content = target.original_content or target.content
                target.content = sug.suggested_content
                target.is_optimized = True
                target.version += 1
                target.updated_at = _now_ms()
            elif sug.type == "add":
                self.segments.append(PromptSegment(
                    id=new_id(), category=sug.target_category,
                    content=sug.suggested_content, is_active=True,
                    is_optimized=True))
        self._save()
        return True

    def reject_suggestion(self, sid: str) -> bool:
        sug = self._find_suggestion(sid)
        if sug is None or sug.status != "pending":
            return False
        sug.status = "rejected"
        self._save()
        return True

    def revert_suggestion(self, sid: str) -> bool:
        sug = self._find_suggestion(sid)
        if sug is None or sug.status != "applied":
            return False
        if sug.target_segment_id:
            seg = next((s for s in self.segments if s.id == sug.target_segment_id),
                       None)
            self._rollback(seg)
        elif sug.type == "modify":
            seg = next((s for s in self.segments
                        if s.category == sug.target_category and s.is_active
                        and s.is_optimized), None)
            self._rollback(seg)
        elif sug.type == "add":
            self.segments = [
                s for s in self.segments
                if not (s.category == sug.target_category and s.is_optimized
                        and s.content == sug.suggested_content)]
        sug.status = "reverted"
        self._save()
        return True

    def _rollback(self, seg: Optional[PromptSegment]) -> None:
        if seg is not None and seg.original_content:
            seg.content = seg.original_content
            seg.original_content = None
            seg.is_optimized = False
            seg.version += 1
            seg.updated_at = _now_ms()

    def get_pending_suggestions(self) -> List[Suggestion]:
        return [s for s in self.suggestions if s.status == "pending"]

    # --- beam best-prompt application (ref :1219-1264) ---

    def apply_beam_best_prompt(self, best: PromptVersion) -> None:
        """Install the beam winner as the ACTIVE optimized rule-set.

        The winner is a COMPLETE rule-set, not a delta: previously
        beam-applied segments that are not part of it retire, so
        repeated ``run_beam_search`` calls (resumed searches, the online
        loop's auto-gradient ticks) converge on the current best instead
        of accumulating every past round's winner into the prompt."""
        rules = [line for line in best.content.splitlines()
                 if line.strip().startswith("- ")]
        if not rules and best.content.strip():
            # Freeform winner (no '- ' lines): one core_behavior segment
            # carries the whole prompt text, updated in place; other
            # beam-applied segments retire (the winner is complete here
            # too — leaving old bullets active would mix rule-sets).
            existing = next((s for s in self.segments
                             if s.category == "core_behavior" and s.is_active),
                            None)
            if existing is not None:
                existing.original_content = (existing.original_content
                                             or existing.content)
                existing.content = best.content
                existing.is_optimized = True
                existing.version += 1
                existing.updated_at = _now_ms()
            else:
                existing = PromptSegment(
                    id=new_id(), category="core_behavior", content=best.content,
                    is_active=True, is_optimized=True)
                self.segments.append(existing)
            for s in self.segments:
                if (s is not existing and s.is_active and s.is_optimized
                        and s.category == "core_behavior"):
                    s.is_active = False
                    s.updated_at = _now_ms()
            self._save()
            return
        new_contents = {r.strip()[2:].strip() for r in rules}
        new_contents.discard("")
        for s in self.segments:
            if (s.is_active and s.is_optimized
                    and s.category == "core_behavior"
                    and s.content not in new_contents):
                s.is_active = False
                s.updated_at = _now_ms()
        for content in [r.strip()[2:].strip() for r in rules]:
            if not content:
                continue
            if not any(s.is_active and s.content == content
                       for s in self.segments):
                self.segments.append(PromptSegment(
                    id=new_id(), category="core_behavior", content=content,
                    is_active=True, is_optimized=True))
        self._save()

    def install_rules(self, rules: List[str]) -> None:
        """Install ``rules`` as the exact ACTIVE optimized rule-set.

        The checkpoint-resume path: OnlineImprovementLoop persists
        ``get_optimized_rules()`` alongside the train state and replays
        it through here, so a resumed loop's sessions render the same
        system prompt the preempted process was serving. Delegates to
        the beam applier — identical complete-set semantics (rules not
        in the list retire, duplicates are not re-added)."""
        self.apply_beam_best_prompt(PromptVersion(
            version="resume",
            content="\n".join(f"- {r}" for r in rules)))

    # --- persistence ---

    def _save(self) -> None:
        if not self._path:
            return
        data = {
            "segments": [vars(s) for s in self.segments],
            "suggestions": [vars(s) for s in self.suggestions],
        }
        tmp = self._path + ".tmp"
        os.makedirs(os.path.dirname(self._path) or ".", exist_ok=True)
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(data, f)
        os.replace(tmp, self._path)

    def _load(self) -> None:
        try:
            with open(self._path, "r", encoding="utf-8") as f:
                data = json.load(f)
            self.segments = [PromptSegment(**s) for s in data.get("segments", [])]
            self.suggestions = [Suggestion(**s) for s in data.get("suggestions", [])]
        except Exception:
            self.segments, self.suggestions = [], []
