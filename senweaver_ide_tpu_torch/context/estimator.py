"""Token estimation — host-side, code-aware.

TokenEstimator (smartContextManager.ts:137-180): ~3.5 chars/token with a
1.2× density bump when text looks like code, plus a bounded memo cache. The
rollout path uses this for context budgeting before the real tokenizer runs
(exactly the reference's role for it); training-side token counts come from
the actual tokenizer, never this estimate.
"""

from __future__ import annotations

import math
import re
from collections import OrderedDict

CHARS_PER_TOKEN = 3.5

_CODE_INDICATORS = [
    re.compile(r"function\s+\w+"),
    re.compile(r"class\s+\w+"),
    re.compile(r"import\s+"),
    re.compile(r"export\s+"),
    re.compile(r"const\s+\w+\s*="),
    re.compile(r"let\s+\w+\s*="),
    re.compile(r"=>"),
    re.compile(r"\{\s*\n"),
    re.compile(r"def\s+\w+"),
    re.compile(r"return\s"),
]


def looks_like_code(text: str) -> bool:
    return any(p.search(text) for p in _CODE_INDICATORS)


class TokenEstimator:
    """Memoized estimator; cache keyed by a (prefix, length) fingerprint and
    halved when it exceeds 1000 entries (ref :157-162)."""

    def __init__(self) -> None:
        self._cache: OrderedDict[str, int] = OrderedDict()

    def estimate(self, text: str) -> int:
        if not text:
            return 0
        key = text if len(text) <= 100 else text[:100] + str(len(text))
        hit = self._cache.get(key)
        if hit is not None:
            return hit
        tokens = math.ceil(len(text) / CHARS_PER_TOKEN)
        if looks_like_code(text):
            tokens = math.ceil(tokens * 1.2)
        if len(self._cache) > 1000:
            for _ in range(500):
                self._cache.popitem(last=False)
        self._cache[key] = tokens
        return tokens


_default = TokenEstimator()


def estimate_tokens(text: str) -> int:
    return _default.estimate(text)
