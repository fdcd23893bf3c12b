"""Edit prediction: propose the next edit locations after a change.

Mirrors `browser/editPredictionService.ts` (1441 LoC, Zed-style
multi-location prediction, header :50-57): after the user (or an agent)
edits a symbol, predict the other locations that need the same change —
e.g. renaming a function means its call sites follow.

The location pass is deterministic (symbol extraction + workspace search
— cheap, no model); the optional content pass asks the policy what each
location should become. The rollout engine uses this to pre-seed
edit-agent tasks after a rename-style edit.
"""

from __future__ import annotations

import dataclasses
import re
from typing import List, Optional

from ..tools.sandbox import Workspace

_IDENT = re.compile(r"[A-Za-z_][A-Za-z0-9_]{2,}")
MAX_PREDICTIONS = 8


@dataclasses.dataclass
class EditPrediction:
    uri: str
    line: int                      # 1-based
    symbol: str
    preview: str
    suggested: Optional[str] = None


def changed_symbols(before: str, after: str) -> List[str]:
    """Identifiers present in the removed text but gone from the added
    text (rename/deletion candidates) plus newly-introduced ones."""
    b = set(_IDENT.findall(before))
    a = set(_IDENT.findall(after))
    removed = b - a
    added = a - b
    # A rename pairs one removed with one added; removed symbols are the
    # ones whose other occurrences now need attention.
    return sorted(removed) + sorted(added - removed)[:2]


def predict_edit_locations(workspace: Workspace, uri: str, before: str,
                           after: str, *,
                           max_predictions: int = MAX_PREDICTIONS
                           ) -> List[EditPrediction]:
    """Deterministic pass: every other occurrence of a changed symbol.
    One workspace grep for ALL symbols at once (Workspace.search_lines) —
    this hook runs after every agent edit, so per-symbol re-walks would
    scale quadratically with sandbox size."""
    symbols = changed_symbols(before, after)
    if not symbols:
        return []
    pattern = re.compile(
        r"\b(" + "|".join(re.escape(s) for s in symbols) + r")\b")
    out: List[EditPrediction] = []
    edited = workspace.display(workspace.resolve(uri))
    for path, ln, line in workspace.search_lines(pattern.pattern):
        # Every DISTINCT changed symbol on the line gets its own
        # prediction; a symbol already handled by the edit itself is
        # skipped without suppressing the line's other symbols.
        for symbol in dict.fromkeys(m.group(1)
                                    for m in pattern.finditer(line)):
            if path == edited and symbol in after:
                continue
            out.append(EditPrediction(uri=path, line=ln, symbol=symbol,
                                      preview=line.strip()[:120]))
            if len(out) >= max_predictions:
                return out
    return out


def suggest_contents(client, predictions: List[EditPrediction], before: str,
                     after: str) -> List[EditPrediction]:
    """Optional content pass: one policy call proposes the updated line
    for each predicted location."""
    if not predictions:
        return predictions
    from ..agents.llm import ChatMessage
    listing = "\n".join(f"{i}. {p.uri}:{p.line}: {p.preview}"
                        for i, p in enumerate(predictions))
    resp = client.chat([ChatMessage(
        "user",
        "An edit changed this code:\n"
        f"BEFORE:\n{before}\nAFTER:\n{after}\n\n"
        "These other locations reference the changed symbols:\n"
        f"{listing}\n\n"
        "For each numbered location output `<n>: <updated line>` (one "
        "per line), or `<n>: SKIP` if no change is needed.")],
        temperature=0.0)
    for line in resp.text.split("\n"):
        m = re.match(r"\s*(\d+)\s*:\s*(.*)", line)
        if not m:
            continue
        i = int(m.group(1))
        if 0 <= i < len(predictions) and m.group(2).strip() != "SKIP":
            predictions[i].suggested = m.group(2)
    return predictions
