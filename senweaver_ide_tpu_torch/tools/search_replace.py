"""SEARCH/REPLACE block extraction + application.

Implements the reference's fast-apply edit format: blocks delimited by
``<<<<<<< ORIGINAL`` / ``=======`` / ``>>>>>>> UPDATED`` markers
(prompt/prompts.ts:38-40), extracted as in
`browser/helpers/extractCodeFromResult.ts` and applied as in
`editCodeService.ts:1296` (instantlyApplySearchReplaceBlocks). Matching is
exact-first with a whitespace-tolerant fallback so minor indentation drift in
model output still applies — malformed blocks raise, and the agent loop's
retry policy (editCodeService.ts:1997 retry-on-malformed) regenerates.
"""

from __future__ import annotations

import dataclasses
import re
from typing import List

ORIGINAL = "<<<<<<< ORIGINAL"
DIVIDER = "======="
FINAL = ">>>>>>> UPDATED"


class MalformedBlocksError(ValueError):
    pass


class SearchNotFoundError(ValueError):
    pass


@dataclasses.dataclass
class SearchReplaceBlock:
    original: str
    updated: str


def extract_blocks(text: str) -> List[SearchReplaceBlock]:
    """Parse all SEARCH/REPLACE blocks out of model output.

    Tolerates surrounding prose and code fences; raises MalformedBlocksError
    when markers are absent or unbalanced (the validate-time error of
    toolsService.ts:1257-1283)."""
    if ORIGINAL not in text:
        preview = text[:100]
        raise MalformedBlocksError(
            f'search/replace blocks must contain "{ORIGINAL}" markers. '
            f'Received: "{preview}...". To replace an entire file use '
            f"rewrite_file; otherwise use the {ORIGINAL} / {DIVIDER} / "
            f"{FINAL} format.")
    blocks: List[SearchReplaceBlock] = []
    # Scan line-wise so ======= inside code doesn't split a block.
    lines = text.split("\n")
    i = 0
    while i < len(lines):
        if lines[i].strip() != ORIGINAL:
            i += 1
            continue
        orig: List[str] = []
        upd: List[str] = []
        i += 1
        while i < len(lines) and lines[i].strip() != DIVIDER:
            if lines[i].strip() == ORIGINAL or lines[i].strip() == FINAL:
                raise MalformedBlocksError(
                    f"unbalanced block: expected {DIVIDER} before "
                    f"{lines[i].strip()}")
            orig.append(lines[i])
            i += 1
        if i >= len(lines):
            raise MalformedBlocksError(f"missing {DIVIDER} divider")
        i += 1
        while i < len(lines) and lines[i].strip() != FINAL:
            if lines[i].strip() in (ORIGINAL, DIVIDER):
                raise MalformedBlocksError(
                    f"unbalanced block: expected {FINAL} before "
                    f"{lines[i].strip()}")
            upd.append(lines[i])
            i += 1
        if i >= len(lines):
            raise MalformedBlocksError(f"missing {FINAL} terminator")
        i += 1
        blocks.append(SearchReplaceBlock("\n".join(orig), "\n".join(upd)))
    if not blocks:
        raise MalformedBlocksError("no complete SEARCH/REPLACE blocks found")
    return blocks


def _find_whitespace_tolerant(content: str, needle: str) -> tuple[int, int]:
    """Locate needle ignoring per-line leading/trailing whitespace; returns
    (start, end) char offsets in content, or (-1, -1)."""
    c_lines = content.split("\n")
    n_lines = [ln.strip() for ln in needle.split("\n")]
    # Drop leading/trailing blank needle lines for matching purposes.
    while n_lines and not n_lines[0]:
        n_lines.pop(0)
    while n_lines and not n_lines[-1]:
        n_lines.pop()
    if not n_lines:
        return -1, -1
    stripped = [ln.strip() for ln in c_lines]
    for start in range(len(c_lines) - len(n_lines) + 1):
        if stripped[start:start + len(n_lines)] == n_lines:
            off = sum(len(ln) + 1 for ln in c_lines[:start])
            end = off + sum(len(ln) + 1
                            for ln in c_lines[start:start + len(n_lines)]) - 1
            return off, end
    return -1, -1


def apply_blocks(content: str, blocks: List[SearchReplaceBlock]) -> str:
    """Apply blocks in order; each ORIGINAL must match exactly once (first
    occurrence wins, as in the reference's sequential apply)."""
    for b in blocks:
        if b.original == "" or b.original.strip() == "":
            # Empty ORIGINAL ⇒ append (create-into-empty-file semantics).
            content = content + b.updated if content else b.updated
            continue
        idx = content.find(b.original)
        if idx >= 0:
            content = content[:idx] + b.updated + content[idx +
                                                          len(b.original):]
            continue
        s, e = _find_whitespace_tolerant(content, b.original)
        if s < 0:
            snippet = b.original.strip().split("\n")[0][:80]
            raise SearchNotFoundError(
                f"ORIGINAL text not found in file (starts with: "
                f'"{snippet}"). Re-read the file and use exact text.')
        content = content[:s] + b.updated + content[e:]
    return content


def apply_search_replace(content: str, blocks_text: str) -> str:
    """extract + apply in one step (the edit_file tool path)."""
    return apply_blocks(content, extract_blocks(blocks_text))


def surrounding_blocks_format_doc() -> str:
    """The format documentation injected into edit prompts
    (searchReplaceBlockTemplate, prompts.ts:44-57)."""
    return (f"{ORIGINAL}\n<exact text from read_file output>\n{DIVIDER}\n"
            f"<modified version of the text>\n{FINAL}")
