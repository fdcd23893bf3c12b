"""Conversation-trace schema.

Semantics mirror the reference trace collector
(``src/vs/workbench/contrib/senweaver/common/traceCollectorService.ts:20-109``):
8 span types, per-span data payload with 500-char content previews, and a
per-trace aggregated summary feeding the reward head.

The representation here is host-side (plain dataclasses). The device-side
representation is the fixed-width feature vector produced by
:mod:`senweaver_ide_tpu_torch.traces.features`, which the jit reward head consumes.
"""

from __future__ import annotations

import dataclasses
import enum
import time
import uuid
from typing import Any, Dict, List, Optional

# Bounds, matching traceCollectorService.ts:218-221.
CONTENT_PREVIEW_CHARS = 500
MAX_TRACES = 1000
MAX_SPANS_PER_TRACE = 200
FLUSH_INTERVAL_S = 30.0


class SpanType(str, enum.Enum):
    """The 8 span types (traceCollectorService.ts:20-28)."""

    LLM_CALL = "llm_call"
    TOOL_CALL = "tool_call"
    USER_MESSAGE = "user_message"
    ASSISTANT_MESSAGE = "assistant_message"
    USER_FEEDBACK = "user_feedback"
    EDIT_PREDICTION = "edit_prediction"
    CHECKPOINT = "checkpoint"
    ERROR = "error"


class Feedback(str, enum.Enum):
    """User feedback (traceCollectorService.ts:31)."""

    GOOD = "good"
    BAD = "bad"


class ChatMode(str, enum.Enum):
    """Chat modes with adaptive reward thresholds (traceCollectorService.ts:672-674)."""

    NORMAL = "normal"
    AGENT = "agent"
    GATHER = "gather"
    DESIGNER = "designer"


def _now_ms() -> float:
    return time.time() * 1000.0


def new_id() -> str:
    return uuid.uuid4().hex


def preview(content: Optional[str], max_len: int = CONTENT_PREVIEW_CHARS) -> str:
    """Truncate content to a preview, '...'-suffixed when cut
    (traceCollectorService.ts:260-263 ``_truncate``)."""
    if not content:
        return ""
    return content[:max_len] + "..." if len(content) > max_len else content


@dataclasses.dataclass
class SpanData:
    """Per-span payload (traceCollectorService.ts:50-81)."""

    model: Optional[str] = None
    provider: Optional[str] = None
    input_tokens: Optional[int] = None
    output_tokens: Optional[int] = None
    temperature: Optional[float] = None
    content_preview: Optional[str] = None
    content_length: Optional[int] = None
    tool_name: Optional[str] = None
    tool_params: Optional[str] = None
    tool_result: Optional[str] = None
    tool_success: Optional[bool] = None
    feedback: Optional[str] = None
    error_message: Optional[str] = None
    metadata: Optional[Dict[str, Any]] = None

    def to_dict(self) -> Dict[str, Any]:
        return {k: v for k, v in dataclasses.asdict(self).items() if v is not None}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "SpanData":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})


@dataclasses.dataclass
class Span:
    """A single trace span (traceCollectorService.ts:41-81)."""

    id: str
    trace_id: str
    thread_id: str
    message_idx: int
    type: SpanType
    timestamp: float
    duration_ms: Optional[float] = None
    data: SpanData = dataclasses.field(default_factory=SpanData)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "id": self.id,
            "trace_id": self.trace_id,
            "thread_id": self.thread_id,
            "message_idx": self.message_idx,
            "type": self.type.value,
            "timestamp": self.timestamp,
            "duration_ms": self.duration_ms,
            "data": self.data.to_dict(),
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Span":
        return cls(
            id=d["id"],
            trace_id=d["trace_id"],
            thread_id=d["thread_id"],
            message_idx=d.get("message_idx", 0),
            type=SpanType(d["type"]),
            timestamp=d["timestamp"],
            duration_ms=d.get("duration_ms"),
            data=SpanData.from_dict(d.get("data", {})),
        )


@dataclasses.dataclass
class ToolNameStats:
    total: int = 0
    succeeded: int = 0
    failed: int = 0


@dataclasses.dataclass
class TraceSummary:
    """Aggregated per-trace stats (traceCollectorService.ts:95-108)."""

    total_llm_calls: int = 0
    total_tool_calls: int = 0
    total_tokens: int = 0
    user_feedback: Optional[str] = None  # 'good' | 'bad' | None
    has_errors: bool = False
    tool_calls_succeeded: int = 0
    tool_calls_failed: int = 0
    tool_calls_by_name: Dict[str, ToolNameStats] = dataclasses.field(default_factory=dict)
    total_tool_duration_ms: float = 0.0
    final_reward: Optional[float] = None
    reward_dimensions: List[Dict[str, float]] = dataclasses.field(default_factory=list)

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["tool_calls_by_name"] = {
            k: dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v
            for k, v in self.tool_calls_by_name.items()
        }
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TraceSummary":
        by_name = {
            k: ToolNameStats(**v) if isinstance(v, dict) else v
            for k, v in d.get("tool_calls_by_name", {}).items()
        }
        return cls(
            total_llm_calls=d.get("total_llm_calls", 0),
            total_tool_calls=d.get("total_tool_calls", 0),
            total_tokens=d.get("total_tokens", 0),
            user_feedback=d.get("user_feedback"),
            has_errors=d.get("has_errors", False),
            tool_calls_succeeded=d.get("tool_calls_succeeded", 0),
            tool_calls_failed=d.get("tool_calls_failed", 0),
            tool_calls_by_name=by_name,
            total_tool_duration_ms=d.get("total_tool_duration_ms", 0.0),
            final_reward=d.get("final_reward"),
            reward_dimensions=list(d.get("reward_dimensions", [])),
        )


@dataclasses.dataclass
class Trace:
    """A complete conversation-turn trace (traceCollectorService.ts:84-109)."""

    id: str
    thread_id: str
    start_time: float
    end_time: Optional[float] = None
    spans: List[Span] = dataclasses.field(default_factory=list)
    metadata: Dict[str, Any] = dataclasses.field(default_factory=dict)
    summary: TraceSummary = dataclasses.field(default_factory=TraceSummary)

    @property
    def chat_mode(self) -> str:
        return str(self.metadata.get("chatMode", "normal"))

    @property
    def user_message_count(self) -> int:
        return sum(1 for s in self.spans if s.type is SpanType.USER_MESSAGE)

    @property
    def assistant_message_count(self) -> int:
        return sum(1 for s in self.spans if s.type is SpanType.ASSISTANT_MESSAGE)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "id": self.id,
            "thread_id": self.thread_id,
            "start_time": self.start_time,
            "end_time": self.end_time,
            "spans": [s.to_dict() for s in self.spans],
            "metadata": self.metadata,
            "summary": self.summary.to_dict(),
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Trace":
        return cls(
            id=d["id"],
            thread_id=d["thread_id"],
            start_time=d["start_time"],
            end_time=d.get("end_time"),
            spans=[Span.from_dict(s) for s in d.get("spans", [])],
            metadata=dict(d.get("metadata", {})),
            summary=TraceSummary.from_dict(d.get("summary", {})),
        )


def make_trace(thread_id: str, *, chat_mode: str = "normal",
               metadata: Optional[Dict[str, Any]] = None,
               start_time: Optional[float] = None) -> Trace:
    md = dict(metadata or {})
    md.setdefault("chatMode", chat_mode)
    return Trace(
        id=new_id(),
        thread_id=thread_id,
        start_time=_now_ms() if start_time is None else start_time,
        metadata=md,
    )
