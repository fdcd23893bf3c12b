"""Fast-apply: SEARCH/REPLACE edits with retry-on-malformed regeneration.

Mirrors `browser/editCodeService.ts`'s apply pipeline:
- fast path (:1275-1296 enableFastApply/instantlyApplySearchReplaceBlocks):
  blocks already in hand → extract + apply instantly (pure string work,
  tools/search_replace.py)
- slow path (:1832-1835 searchReplaceGivenDescription_* prompts): ask the
  policy to EMIT blocks for a described change, then apply; malformed or
  non-matching blocks trigger regeneration with the error appended
  (:1997 retry-on-malformed), up to ``max_retries``.

Every successful apply reports CodeChangeStats (lines added/removed —
toolsServiceTypes.ts:13-17), which the edit_agent tool surfaces.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from ..agents.llm import ChatMessage, PolicyClient
from ..tools.sandbox import Workspace
from ..tools.search_replace import (MalformedBlocksError,
                                    SearchNotFoundError,
                                    apply_search_replace,
                                    surrounding_blocks_format_doc)

MAX_APPLY_RETRIES = 3


@dataclasses.dataclass
class ApplyResult:
    uri: str
    applied: bool
    lines_added: int = 0
    lines_removed: int = 0
    retries: int = 0
    error: Optional[str] = None


def _stats(old: str, new: str) -> tuple[int, int]:
    """Real per-line diff counts (CodeChangeStats semantics) — a
    same-line-count substitution is added+removed, not a no-op.
    SequenceMatcher opcodes, not ndiff: this runs on the agent-loop hot
    path and ndiff's intraline analysis is quadratic on big files."""
    import difflib
    sm = difflib.SequenceMatcher(None, old.splitlines(), new.splitlines(),
                                 autojunk=False)
    added = removed = 0
    for op, i1, i2, j1, j2 in sm.get_opcodes():
        if op in ("replace", "delete"):
            removed += i2 - i1
        if op in ("replace", "insert"):
            added += j2 - j1
    return added, removed


def instantly_apply_blocks(workspace: Workspace, uri: str,
                           blocks_text: str) -> ApplyResult:
    """The fast path: no model call."""
    old = workspace.read_text(uri)
    new = apply_search_replace(old, blocks_text)
    workspace.write_file(uri, new)
    added, removed = _stats(old, new)
    return ApplyResult(uri=uri, applied=True, lines_added=added,
                       lines_removed=removed)


def _apply_system_message() -> str:
    return (
        "You convert a described code change into SEARCH/REPLACE blocks.\n"
        "Output ONLY blocks in exactly this format, nothing else:\n"
        + surrounding_blocks_format_doc()
        + "\nRules: ORIGINAL text must be copied EXACTLY from the given "
          "file (whitespace included) and must be unique; keep blocks "
          "small; use multiple blocks for multiple edits.")


def apply_described_edit(client: PolicyClient, workspace: Workspace,
                         uri: str, instructions: str, *,
                         max_retries: int = MAX_APPLY_RETRIES
                         ) -> ApplyResult:
    """The slow path: policy generates blocks, malformed output retries
    with the error fed back."""
    old = workspace.read_text(uri)
    history: List[ChatMessage] = [
        ChatMessage("system", _apply_system_message()),
        ChatMessage("user",
                    f"File `{uri}`:\n```\n{old}\n```\n\n"
                    f"Change to make:\n{instructions}"),
    ]
    last_err = ""
    for attempt in range(max_retries + 1):
        try:
            resp = client.chat(history, temperature=0.0)
        except Exception as e:
            return ApplyResult(uri=uri, applied=False, retries=attempt,
                               error=f"llm error: {e}")
        try:
            new = apply_search_replace(old, resp.text)
            workspace.write_file(uri, new)
            added, removed = _stats(old, new)
            return ApplyResult(uri=uri, applied=True, lines_added=added,
                               lines_removed=removed, retries=attempt)
        except (MalformedBlocksError, SearchNotFoundError) as e:
            last_err = str(e)
            history.append(ChatMessage("assistant", resp.text))
            history.append(ChatMessage(
                "user",
                f"Those blocks failed to apply: {e}\nRegenerate the "
                "SEARCH/REPLACE blocks, copying ORIGINAL text exactly "
                "from the file above."))
    return ApplyResult(uri=uri, applied=False, retries=max_retries,
                       error=last_err or "failed to apply")
