"""APO data model.

Host-side dataclasses mirroring the reference type definitions in
``common/apoService.ts:20-200`` (PromptSegment, PromptIssuePattern,
PromptOptimizationSuggestion, RolloutResultForAPO, VersionedPromptTemplate,
TextualGradient, BeamSearchState, APOConfig).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

from ..traces.schema import new_id

# PromptSegmentCategory (apoService.ts:22-29)
CATEGORIES = (
    "core_behavior", "code_quality", "tool_usage", "output_format",
    "context_management", "mode_specific", "user_instructions",
)

# Reward-dim → segment-category map (apoService.ts:576-586).
DIM_CATEGORY_MAP: Dict[str, str] = {
    "tool_success_rate": "tool_usage",
    "tool_call_reliability": "tool_usage",
    "tool_call_efficiency": "tool_usage",
    "tool_duration_efficiency": "tool_usage",
    "token_efficiency": "context_management",
    "response_efficiency": "core_behavior",
    "conversation_efficiency": "core_behavior",
    "task_completion": "core_behavior",
    "user_feedback": "core_behavior",
}

MAX_REPORTS = 50        # apoService.ts:275
MAX_SUGGESTIONS = 200   # apoService.ts:276


def _now_ms() -> float:
    return time.time() * 1000.0


@dataclasses.dataclass
class PromptSegment:
    """Independently optimizable prompt unit (apoService.ts:32-43)."""

    id: str
    category: str
    content: str
    is_active: bool = True
    is_optimized: bool = False
    original_content: Optional[str] = None
    version: int = 1
    created_at: float = dataclasses.field(default_factory=_now_ms)
    updated_at: float = dataclasses.field(default_factory=_now_ms)


@dataclasses.dataclass
class PatternExample:
    thread_id: str
    user_message_preview: str
    assistant_message_preview: str
    feedback: Optional[str]


@dataclasses.dataclass
class IssuePattern:
    """Common problem extracted from bad feedback (apoService.ts:73-86)."""

    id: str
    description: str
    frequency: int
    severity: str  # 'low' | 'medium' | 'high'
    related_category: str
    examples: List[PatternExample] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Suggestion:
    """Prompt optimization suggestion (apoService.ts:88-104)."""

    id: str
    target_category: str
    type: str  # 'add' | 'modify' | 'remove' | 'reorder'
    priority: str  # 'low' | 'medium' | 'high'
    description: str
    reasoning: str
    estimated_impact: str
    status: str = "pending"  # 'pending' | 'applied' | 'rejected' | 'reverted'
    target_segment_id: Optional[str] = None
    suggested_content: Optional[str] = None
    applied_at: Optional[float] = None
    prompt_version: Optional[str] = None
    validation_score: Optional[float] = None


@dataclasses.dataclass
class ModeStats:
    total: int = 0
    good: int = 0
    bad: int = 0
    good_rate: float = 0.0


@dataclasses.dataclass
class EffectivenessReport:
    """Prompt effectiveness report (apoService.ts:45-71)."""

    id: str
    generated_at: float
    period_from: float
    period_to: float
    total_conversations: int
    good_feedback_count: int
    bad_feedback_count: int
    no_feedback_count: int
    good_rate: float
    by_mode: Dict[str, ModeStats]
    patterns: List[IssuePattern]
    suggestions: List[Suggestion]
    avg_reward: Optional[float] = None
    reward_by_dimension: Dict[str, Dict[str, float]] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class RolloutMessage:
    role: str  # 'user' | 'assistant' | 'tool'
    content: str
    tool_name: Optional[str] = None
    tool_success: Optional[bool] = None


@dataclasses.dataclass
class RolloutResult:
    """Trace converted for APO consumption (``RolloutResultForAPO``,
    apoService.ts:108-135)."""

    trace_id: str
    thread_id: str
    status: str  # 'succeeded' | 'failed' | 'unknown'
    final_reward: Optional[float]
    reward_dimensions: List[Dict[str, float]]
    messages: List[RolloutMessage]
    chat_mode: str
    tool_call_stats: Dict[str, Any]
    llm_stats: Dict[str, Any]


@dataclasses.dataclass
class PromptVersion:
    """Versioned prompt template (apoService.ts:137-145)."""

    version: str
    content: str
    score: Optional[float] = None
    parent_version: Optional[str] = None
    created_at: float = dataclasses.field(default_factory=_now_ms)


@dataclasses.dataclass
class TextualGradient:
    """LLM critique of a prompt version (apoService.ts:147-154)."""

    id: str
    prompt_version: str
    critique: str
    rollout_summary: str
    created_at: float = dataclasses.field(default_factory=_now_ms)


@dataclasses.dataclass
class BeamState:
    """Beam-search state (apoService.ts:156-165)."""

    current_round: int = 0
    total_rounds: int = 3
    beam: List[PromptVersion] = dataclasses.field(default_factory=list)
    history_best_prompt: Optional[PromptVersion] = None
    history_best_score: float = float("-inf")
    version_counter: int = 0
    started_at: float = dataclasses.field(default_factory=_now_ms)
    last_updated_at: float = dataclasses.field(default_factory=_now_ms)

    def next_version(self) -> str:
        v = f"v{self.version_counter}"
        self.version_counter += 1
        return v


@dataclasses.dataclass
class APOConfig:
    """APO configuration with reference defaults (apoService.ts:278-292)."""

    enabled: bool = True
    auto_analyze_enabled: bool = True
    auto_analyze_interval_ms: float = 3_600_000.0  # 1 h
    min_traces_for_analysis: int = 20
    min_feedbacks_for_analysis: int = 10
    auto_apply_suggestions: bool = False
    beam_width: int = 4
    branch_factor: int = 4
    beam_rounds: int = 3
    gradient_batch_size: int = 4
    # Auto-gradient trigger (apoService.ts:468-472).
    gradient_good_rate_threshold: float = 0.7
    gradient_min_feedbacks: int = 15


def new_suggestion(**kw) -> Suggestion:
    kw.setdefault("id", new_id())
    return Suggestion(**kw)
