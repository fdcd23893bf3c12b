"""FIM autocomplete: prompt building, caching, postprocessing.

Mirrors `browser/autocompleteService.ts` (981 LoC) semantics:
- prefix/suffix context capped at MAX_PREFIX_SUFFIX_CHARS=20k
  (prompts.ts:35, trimmed whole-lines-first :1446-1457)
- FIM prompt built with the model's own FIM tokens (capability DB), for
  models without FIM a pseudo-FIM chat prompt
- preprocessing gates (:58-61): no completion mid-word; single-line mode
  when text sits right of the cursor
- postprocessing (:45-56): trim extra closing brackets, stop at the
  suffix's first matching character in single-line mode, trim to one
  leading/trailing space
- LRU cache keyed by trimmed prefix (:66-69)
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..context.cache import LRUTTLCache
from ..context.token_config import MAX_PREFIX_SUFFIX_CHARS
from ..models.capabilities import get_model_capabilities

_OPEN = {"(": ")", "[": "]", "{": "}"}
_CLOSE = {v: k for k, v in _OPEN.items()}


@dataclasses.dataclass
class FimPrompt:
    text: str
    single_line: bool


def _cap_context(text: str, *, from_end: bool) -> str:
    """Whole-line trim to the char budget (prompts.ts:1446-1457)."""
    if len(text) <= MAX_PREFIX_SUFFIX_CHARS:
        return text
    lines = text.split("\n")
    out: list[str] = []
    total = 0
    src = reversed(lines) if from_end else iter(lines)
    for line in src:
        if total + len(line) + 1 > MAX_PREFIX_SUFFIX_CHARS:
            break
        out.append(line)
        total += len(line) + 1
    if from_end:
        out.reverse()
    return "\n".join(out)


def should_complete(prefix: str, suffix: str = "") -> bool:
    """Preprocessing gates (ref :58-61): don't generate at the very
    beginning of an un-indented empty line (nothing to anchor on), and
    don't generate mid-word when text continues immediately to the right
    (completing inside an identifier splits it)."""
    if not prefix:
        return False
    last_line = prefix.rsplit("\n", 1)[-1]
    if last_line == "":
        return False          # column 0 of an empty, un-indented line
    if (last_line and (last_line[-1].isalnum() or last_line[-1] == "_")
            and suffix[:1] and (suffix[0].isalnum() or suffix[0] == "_")):
        return False          # cursor splits an identifier
    return True


def build_fim_prompt(model_name: str, prefix: str,
                     suffix: str) -> FimPrompt:
    caps = get_model_capabilities(model_name)
    prefix = _cap_context(prefix, from_end=True)
    suffix = _cap_context(suffix, from_end=False)
    single_line = bool(suffix.split("\n", 1)[0].strip())
    if caps.supports_fim and caps.fim_tokens:
        pre, suf, mid = caps.fim_tokens
        text = f"{pre}{prefix}{suf}{suffix}{mid}"
    else:
        text = (f"Complete the code at <CURSOR>. Output ONLY the inserted "
                f"text.\n```\n{prefix}<CURSOR>{suffix}\n```")
    return FimPrompt(text=text, single_line=single_line)


def postprocess_completion(completion: str, prefix: str, suffix: str, *,
                           single_line: bool) -> str:
    """The reference's postprocessing pipeline (:45-56)."""
    out = completion
    if single_line:
        out = out.split("\n", 1)[0]
        # Stop at the suffix's first non-space char if we regenerate it
        # ("complete up to first matchup character").
        nxt = suffix.lstrip()[:1]
        if nxt:
            i = out.find(nxt)
            if i != -1:
                out = out[:i]
    # Trim closing brackets that have no opener in prefix+completion.
    depth = {c: 0 for c in _OPEN}
    for ch in prefix[-2000:]:
        if ch in _OPEN:
            depth[ch] += 1
        elif ch in _CLOSE and depth[_CLOSE[ch]] > 0:
            depth[_CLOSE[ch]] -= 1
    kept: list[str] = []
    for ch in out:
        if ch in _OPEN:
            depth[ch] += 1
        elif ch in _CLOSE:
            if depth[_CLOSE[ch]] > 0:
                depth[_CLOSE[ch]] -= 1
            else:
                break          # unmatched closer: trim from here
        kept.append(ch)
    out = "".join(kept)
    # At most one leading/trailing space survives.
    out = out.strip("\n") if single_line else out
    while out.startswith("  "):
        out = out[1:]
    while out.endswith("  "):
        out = out[:-1]
    return out


class AutocompleteService:
    """Caching FIM completion front-end over a policy client."""

    def __init__(self, client, model_name: str, *, cache_size: int = 64):
        self.client = client
        self.model_name = model_name
        self._cache: LRUTTLCache[str] = LRUTTLCache(
            max_size=cache_size, default_ttl_s=120.0)

    def complete(self, prefix: str, suffix: str, *,
                 max_tokens: int = 64) -> Optional[str]:
        if not should_complete(prefix, suffix):
            return None
        key = prefix.rstrip("\n")[-500:]         # prefix-keyed cache
        cached = self._cache.get(key)
        if cached is not None:
            return cached
        fp = build_fim_prompt(self.model_name, prefix, suffix)
        from ..agents.llm import ChatMessage
        resp = self.client.chat([ChatMessage("user", fp.text)],
                                temperature=0.0, max_tokens=max_tokens)
        out = postprocess_completion(resp.text, prefix, suffix,
                                     single_line=fp.single_line)
        if out:
            self._cache.put(key, out)
        return out or None
