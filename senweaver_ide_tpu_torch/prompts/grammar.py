"""Streaming grammar extraction: think-tags and XML tool calls.

The local policy has no native tool-call API, so — like the reference's
providers without one — tool calls ride in the text stream as XML:
``<tool_name><param>value</param>...</tool_name>``. This module reproduces
`electron-main/llmMessage/extractGrammar.ts`:

- ``ReasoningExtractor`` — extractReasoningWrapper (:17-150): split
  think-tag content out of the visible stream, holding back partial-tag
  suffixes until disambiguated.
- ``parse_tool_call`` / ``ToolCallExtractor`` — extractXMLToolsWrapper
  (:324+) + parseXMLPrefixToToolCall (:210-320): first tool tag wins, param
  alias normalization (PARAM_ALIASES :172-207), newline-trimmed values,
  done/partial param tracking for streaming UIs.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Sequence, Tuple

from ..tools.registry import TOOL_SCHEMAS

THINK_TAGS = ("<think>", "</think>")

# PARAM_ALIASES (extractGrammar.ts:172-207) — only unambiguous aliases; the
# reference deliberately excludes 'file'/'folder'/'content'/... because
# models emit them as metadata tags.
PARAM_ALIASES: Dict[str, str] = {
    "path": "uri", "file_path": "uri", "filepath": "uri",
    "directory": "uri", "dir": "uri", "target": "uri", "location": "uri",
    "file_content": "new_content",
    "search": "query", "search_query": "query", "keyword": "query",
    "keywords": "query", "term": "query",
    "blocks": "search_replace_blocks", "changes": "search_replace_blocks",
    "edits": "search_replace_blocks",
    "replacements": "search_replace_blocks",
    "recursive": "is_recursive", "isRecursive": "is_recursive",
    "regex": "is_regex", "isRegex": "is_regex", "use_regex": "is_regex",
}


def _trim_newlines(value: str) -> str:
    """Strip whitespace at/before the first newline and after the last
    (trimBeforeAndAfterNewLines semantics): tag layout whitespace is not
    part of the value, interior whitespace is."""
    m = re.match(r"^[ \t]*\n", value)
    if m:
        value = value[m.end():]
    m = re.search(r"\n[ \t]*$", value)
    if m:
        value = value[:m.start()]
    return value


@dataclasses.dataclass
class RawToolCall:
    name: str
    params: Dict[str, str]
    done_params: List[str]
    is_done: bool
    raw: str = ""


def _param_name_map(tool_name: str) -> Dict[str, str]:
    schema = TOOL_SCHEMAS.get(tool_name)
    if schema is None:
        return {}
    mapping = {p: p for p in schema.params}
    for alias, standard in PARAM_ALIASES.items():
        if standard in schema.params:
            mapping[alias] = standard
    return mapping


def parse_tool_call(text: str, *,
                    tool_names: Optional[Sequence[str]] = None
                    ) -> Optional[RawToolCall]:
    """Parse the FIRST tool call appearing in ``text``
    (parseXMLPrefixToToolCall). Returns None when no tool tag present."""
    names = tool_names if tool_names is not None else list(TOOL_SCHEMAS)
    first: Optional[Tuple[int, str]] = None
    for name in names:
        i = text.find(f"<{name}>")
        if i != -1 and (first is None or i < first[0]):
            first = (i, name)
    if first is None:
        return None
    start, name = first
    open_tag, close_tag = f"<{name}>", f"</{name}>"
    body_start = start + len(open_tag)
    j = text.find(close_tag, body_start)   # first close: first call wins
    is_done = j != -1
    body = text[body_start:j if is_done else len(text)]
    raw = text[start:(j + len(close_tag)) if is_done else len(text)]

    mapping = _param_name_map(name)
    params: Dict[str, str] = {}
    done_params: List[str] = []
    pos = 0
    # Sequential param scan, one tag at a time (ref's SurroundingsRemover
    # loop). Unknown tags inside a param value are treated as content.
    while True:
        next_open: Optional[Tuple[int, str]] = None
        for tag_name in mapping:
            k = body.find(f"<{tag_name}>", pos)
            if k != -1 and (next_open is None or k < next_open[0]):
                next_open = (k, tag_name)
        if next_open is None:
            break
        k, tag_name = next_open
        standard = mapping[tag_name]
        vstart = k + len(tag_name) + 2
        vend = body.find(f"</{tag_name}>", vstart)
        if vend == -1:
            # Unterminated (still streaming): rest of body is the value.
            params[standard] = _trim_newlines(body[vstart:])
            pos = len(body)
            break
        params[standard] = _trim_newlines(body[vstart:vend])
        done_params.append(standard)
        pos = vend + len(tag_name) + 3
    return RawToolCall(name=name, params=params, done_params=done_params,
                       is_done=is_done, raw=raw)


def strip_tool_call(text: str, call: RawToolCall) -> str:
    """Visible assistant text = everything outside the tool-call block."""
    if not call.raw:
        return text
    i = text.find(call.raw)
    if i == -1:
        return text
    return (text[:i] + text[i + len(call.raw):]).strip()


class ReasoningExtractor:
    """Incremental think-tag splitter. feed(full_text) with the cumulative
    stream; read .text/.reasoning; finish() flushes held-back suffixes."""

    def __init__(self, think_tags: Tuple[str, str] = THINK_TAGS):
        if not think_tags[0] or not think_tags[1]:
            raise ValueError(f"think tags must be non-empty: {think_tags}")
        self.tags = think_tags
        self.text = ""
        self.reasoning = ""
        self._found_open = False
        self._found_close = False
        self._consumed = 0          # chars of the full stream consumed

    @staticmethod
    def _partial_suffix(s: str, tag: str) -> int:
        """Length of the longest strict-prefix of ``tag`` that ``s`` ends
        with (endsWithAnyPrefixOf) — held back until disambiguated."""
        for n in range(min(len(tag) - 1, len(s)), 0, -1):
            if s.endswith(tag[:n]):
                return n
        return 0

    def feed(self, full_text: str) -> None:
        open_tag, close_tag = self.tags
        if self._found_close:
            self.text += full_text[self._consumed:]
            self._consumed = len(full_text)
            return
        if not self._found_open:
            # Held-back partial-tag chars are never consumed, so the tag —
            # if present — always starts at or after self._consumed.
            i = full_text.find(open_tag, self._consumed)
            if i != -1:
                self._found_open = True
                self.text += full_text[self._consumed:i]
                self._consumed = i + len(open_tag)
                self.feed(full_text)
                return
            hold = self._partial_suffix(full_text, open_tag)
            self.text += full_text[self._consumed:len(full_text) - hold]
            self._consumed = len(full_text) - hold
            return
        j = full_text.find(close_tag, self._consumed)
        if j != -1:
            self._found_close = True
            self.reasoning += full_text[self._consumed:j]
            self._consumed = j + len(close_tag)
            self.feed(full_text)
            return
        hold = self._partial_suffix(full_text, close_tag)
        self.reasoning += full_text[self._consumed:len(full_text) - hold]
        self._consumed = len(full_text) - hold

    def finish(self, full_text: str) -> Tuple[str, str]:
        """Flush at stream end; unterminated reasoning stays reasoning
        (ref final-message path)."""
        self.feed(full_text)
        rest = full_text[self._consumed:]
        if self._found_open and not self._found_close:
            self.reasoning += rest
        else:
            self.text += rest
        self._consumed = len(full_text)
        return self.text.strip(), self.reasoning.strip()


def extract_reasoning_and_tool_call(
        full_text: str, *, tool_names: Optional[Sequence[str]] = None,
        think_tags: Tuple[str, str] = THINK_TAGS
) -> Tuple[str, str, Optional[RawToolCall]]:
    """Batch path used by the rollout engine: returns (visible_text,
    reasoning, tool_call or None). Only COMPLETE tool calls are stripped
    from the text — a partial call (generation budget hit mid-XML) stays
    in the visible text so history and RL traces keep exactly what the
    policy generated."""
    text, reasoning = ReasoningExtractor(think_tags).finish(full_text)
    call = parse_tool_call(text, tool_names=tool_names)
    if call is not None and call.is_done:
        text = strip_tool_call(text, call)
    return text, reasoning, call
