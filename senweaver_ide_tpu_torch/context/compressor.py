"""Message/tool-result compression.

SmartCompressor (smartContextManager.ts:185-305) + MessageCompressor
(`common/messageCompressor.ts`, 294 LoC) semantics:

- history → short topic summary built only from user messages (the
  reference deliberately excludes assistant 'actions' so the model is not
  misled into resuming stale work)
- tool-result compression keeps important lines (errors, warnings, file
  paths, bullets) and an elision marker
- assistant-message compression keeps head + tail around an elision marker
- importance-weighted truncate/summarize per message class
"""

from __future__ import annotations

import re
from typing import List, Sequence

from .manager_types import MessageInput

SUMMARY_MAX_LENGTH = 400          # SMART_CONTEXT_CONFIG.COMPRESSION
TOOL_RESULT_MAX_LENGTH = 3000
ASSISTANT_MAX_LENGTH = 4000

_PATH_RE = re.compile(r"[/\\][\w/\\.-]+\.\w+")
_WORD_RE = re.compile(r"[A-Za-z_][A-Za-z0-9_]{3,}")


def extract_keywords(text: str, limit: int = 8) -> List[str]:
    seen: List[str] = []
    for w in _WORD_RE.findall(text):
        lw = w.lower()
        if lw not in seen:
            seen.append(lw)
        if len(seen) >= limit:
            break
    return seen


def compress_history_to_summary(messages: Sequence[MessageInput]) -> str:
    """compressHistoryToSummary (ref :190-225): user topics only."""
    if not messages:
        return ""
    topics: List[str] = []
    user_questions: List[str] = []
    for m in messages:
        if m.role == "user":
            for k in extract_keywords(m.content):
                if k not in topics:
                    topics.append(k)
            if len(m.content) < 100:
                user_questions.append(m.content.strip())
    parts: List[str] = []
    if user_questions:
        parts.append("Earlier user questions: "
                     + "; ".join(user_questions[-2:]))
    elif topics:
        parts.append("Earlier topics: " + ", ".join(topics[:3]))
    parts.append(f"({len(messages)} earlier messages compressed)")
    return "\n".join(parts)[:SUMMARY_MAX_LENGTH]


def _is_important_line(line: str) -> bool:
    s = line.strip()
    return ("error" in line or "Error" in line or "warning" in line
            or bool(_PATH_RE.search(line))
            or s.startswith(("•", "-", "*")))


def compress_tool_result(content: str,
                         max_length: int = TOOL_RESULT_MAX_LENGTH) -> str:
    """compressToolResult (ref :230-268): keep important lines + ~30% head
    budget, stop at 80%, append an elision marker."""
    if len(content) <= max_length:
        return content
    lines = content.split("\n")
    kept: List[str] = []
    cur = 0
    for line in lines:
        if _is_important_line(line) or cur < max_length * 0.3:
            kept.append(line)
            cur += len(line)
        if cur >= max_length * 0.8:
            break
    if len(kept) < len(lines):
        kept.append(f"\n... ({len(lines) - len(kept)} lines omitted)")
    return "\n".join(kept)[:max_length]


def compress_assistant_message(content: str,
                               max_length: int = ASSISTANT_MAX_LENGTH) -> str:
    """Head + tail around an elision marker (messageCompressor truncate
    strategy)."""
    if len(content) <= max_length:
        return content
    head = int(max_length * 0.6)
    tail = int(max_length * 0.3)
    return (content[:head] + "\n... (middle omitted) ...\n"
            + content[-tail:])


def compress_message(m: MessageInput, *, aggressive: bool = False
                     ) -> MessageInput:
    """Importance-weighted per-message compression
    (messageCompressor.ts): tool results hardest, assistant messages next,
    user messages only under aggressive mode."""
    scale = 0.5 if aggressive else 1.0
    if m.role == "tool":
        new = compress_tool_result(m.content,
                                   int(TOOL_RESULT_MAX_LENGTH * scale))
    elif m.role == "assistant":
        new = compress_assistant_message(m.content,
                                        int(ASSISTANT_MAX_LENGTH * scale))
    elif m.role == "user" and aggressive:
        new = compress_assistant_message(m.content,
                                         int(ASSISTANT_MAX_LENGTH * scale))
    else:
        return m
    if new is m.content:
        return m
    return MessageInput(role=m.role, content=new, timestamp=m.timestamp,
                        tool_name=m.tool_name, tool_id=m.tool_id)
