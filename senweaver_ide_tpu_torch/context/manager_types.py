"""Shared context-manager types and the priority/limit tables.

SMART_CONTEXT_CONFIG (smartContextManager.ts:19-103): token limits, sliding
window, priorities (100→40), compression thresholds, OVERFLOW_THRESHOLD
0.55, PRUNE config, and model context limits.
"""

from __future__ import annotations

import dataclasses
from types import MappingProxyType
from typing import Optional

DEFAULT_MAX_TOKENS = 15_000
MIN_CONTEXT_TOKENS = 5_000
RESERVED_OUTPUT_TOKENS = 4_000

MIN_RECENT_TURNS = 4
MAX_RECENT_TURNS = 8
RECENT_TOKEN_RATIO = 0.6

PRIORITY = MappingProxyType({
    "SYSTEM_PROMPT": 100,
    "CURRENT_INPUT": 99,
    "RECENT_2_TURNS": 95,
    "RECENT_4_TURNS": 85,
    "CODE_CONTEXT": 75,
    "COMPRESSED_SUMMARY": 60,
    "OLDER_HISTORY": 50,
    "TOOL_RESULTS": 40,
})

COMPRESSION_THRESHOLD_MESSAGES = 10
TOKEN_BUFFER_RATIO = 0.15

OVERFLOW_THRESHOLD = 0.55          # compaction trigger (ref :59)

PRUNE = MappingProxyType({
    "PROTECT_TOKENS": 20_000,
    "MINIMUM_TOKENS": 15_000,
    "PROTECT_RECENT_TURNS": 3,
    "PROTECTED_TOOLS": ("search_pathnames_only",),
    "LARGE_OUTPUT_THRESHOLD": 50_000,
})

def model_context_limit(model_name: str) -> int:
    """Per-model context window. The reference keeps a second table in
    smartContextManager.ts:76-103; this build has ONE source of truth —
    the capability DB (models/capabilities.py) — so the compaction budget
    and the transport layer can never disagree about a model's window."""
    from ..models.capabilities import get_model_capabilities
    return get_model_capabilities(model_name).context_window


@dataclasses.dataclass
class MessageInput:
    """MessageInput (ref :128-135)."""
    role: str                      # 'system' | 'user' | 'assistant' | 'tool'
    content: str
    timestamp: Optional[float] = None
    tool_name: Optional[str] = None
    tool_id: Optional[str] = None


@dataclasses.dataclass
class ContextPart:
    """ContextPart (ref :106-119)."""
    type: str
    content: str
    tokens: int
    priority: int
    compressible: bool = True
    timestamp: Optional[float] = None
    turn_index: Optional[int] = None
    tool_name: Optional[str] = None
    is_recent: bool = False


@dataclasses.dataclass
class ContextBuildResult:
    parts: list
    total_tokens: int
    original_tokens: int
    compression_ratio: float
    removed_count: int
    summary_generated: bool


@dataclasses.dataclass
class TokenUsageInfo:
    total_tokens: int
    context_limit: int
    usage_percentage: float
    needs_compaction: bool
    available_tokens: int


@dataclasses.dataclass
class PruneResult:
    pruned_count: int
    pruned_tokens: int
    remaining_tokens: int
