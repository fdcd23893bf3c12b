"""Shared finding/baseline machinery for the static-analysis passes.

A :class:`Finding` is one rule violation at a source location; the
baseline (``analysis/baseline.json``) is the checked-in allowlist of
DOCUMENTED-intentional findings that keeps the tier-1 gate green while
real violations stay loud. Baseline entries match on
``(rule, path, symbol)`` — deliberately NOT on line numbers, so an
unrelated edit above a baselined site doesn't churn the file.

Every entry must carry a ``reason``; the gate treats a reason-less
entry as invalid (an allowlist nobody can audit is how invariants rot
back into tribal knowledge).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation.

    rule    -- rule id (e.g. ``JIT101``, ``LOCK101``)
    path    -- repo-relative posix path of the offending file
    line    -- 1-based line of the offending node
    symbol  -- qualified name anchoring the finding (``Class.method`` /
               ``function`` / ``Class.attr``); the baseline key
    message -- what is wrong
    hint    -- how to fix it
    """

    rule: str
    path: str
    line: int
    symbol: str
    message: str
    hint: str = ""

    def key(self) -> Tuple[str, str, str]:
        return (self.rule, self.path, self.symbol)

    def format(self) -> str:
        loc = f"{self.path}:{self.line}"
        out = f"{loc}: {self.rule} [{self.symbol}] {self.message}"
        if self.hint:
            out += f"\n    hint: {self.hint}"
        return out

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


class BaselineError(ValueError):
    """Malformed baseline file (bad JSON, missing fields, no reason)."""


def default_baseline_path() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "baseline.json")


def load_baseline(path: Optional[str] = None) -> List[Dict[str, str]]:
    """Load and validate the allowlist. Every entry needs ``rule``,
    ``path``, ``symbol`` and a non-empty ``reason``."""
    path = path or default_baseline_path()
    if not os.path.exists(path):
        return []
    with open(path, "r", encoding="utf-8") as f:
        try:
            raw = json.load(f)
        except json.JSONDecodeError as e:
            raise BaselineError(f"{path}: invalid JSON: {e}") from e
    entries = raw.get("entries", raw) if isinstance(raw, dict) else raw
    if not isinstance(entries, list):
        raise BaselineError(f"{path}: expected a list of entries")
    for i, e in enumerate(entries):
        for field in ("rule", "path", "symbol", "reason"):
            if not isinstance(e.get(field), str) or not e[field].strip():
                raise BaselineError(
                    f"{path}: entry {i} missing non-empty {field!r} "
                    f"(every allowlisted finding must be documented)")
    return entries


@dataclasses.dataclass
class BaselineResult:
    """Findings split against the allowlist."""

    new: List[Finding]                  # not allowlisted — the gate fails
    baselined: List[Finding]            # matched a documented entry
    stale: List[Dict[str, str]]         # entries matching nothing (drift)


def apply_baseline(findings: Sequence[Finding],
                   entries: Sequence[Dict[str, str]]) -> BaselineResult:
    allow = {(e["rule"], e["path"], e["symbol"]) for e in entries}
    matched = set()
    new: List[Finding] = []
    baselined: List[Finding] = []
    for f in findings:
        if f.key() in allow:
            matched.add(f.key())
            baselined.append(f)
        else:
            new.append(f)
    stale = [e for e in entries
             if (e["rule"], e["path"], e["symbol"]) not in matched]
    return BaselineResult(new=new, baselined=baselined, stale=stale)
