"""Token-optimization constant tables.

Mirrors the reference's `common/tokenOptimizationConfig.ts` (257 LoC): directory
caps (:14-33), system-message caps (:35-53), aggressive-trim thresholds (:55+),
OUTPUT_RESERVE_RATIO (:126-128), tool-result caps (:148-170), overall targets
incl. TARGET_REDUCTION=0.60 (:172-186), and code-editing safe mode (:188+).

These are plain constants: the reward head, context manager, and tool-result
stringifier all read from here so the semantics stay in one place (the same
role the TS const tables play for chatThreadService/toolsService).
"""

from __future__ import annotations

from types import MappingProxyType

# ---- directory stringification caps (tokenOptimizationConfig.ts:14-33 and
#      prompt/prompts.ts:19-22) ----
DIRECTORY_OPTIMIZATION = MappingProxyType({
    "MAX_DIRSTR_CHARS_TOTAL_BEGINNING": 20_000,
    "MAX_DIRSTR_CHARS_TOTAL_TOOL": 20_000,
    "MAX_DIRSTR_RESULTS_TOTAL_BEGINNING": 100,
    "MAX_DIRSTR_RESULTS_TOTAL_TOOL": 100,
    "MAX_DEPTH": 6,
    "DIRECTORY_CACHE_TTL_S": 60.0,
    "FILE_CONTENT_CACHE_TTL_S": 30.0,
    "FILE_CONTENT_CACHE_MAX_SIZE": 20,
})

# ---- per-tool page caps (prompt/prompts.ts:25-31) ----
MAX_FILE_CHARS_PAGE = 500_000
MAX_CHILDREN_URIS_PAGE = 500
MAX_TERMINAL_CHARS = 100_000
MAX_TERMINAL_INACTIVE_TIME_S = 8.0
MAX_TERMINAL_BG_COMMAND_TIME_S = 5.0
MAX_PREFIX_SUFFIX_CHARS = 20_000

# ---- tool-result stringification caps (tokenOptimizationConfig.ts:148-170) ----
TOOL_RESULT_OPTIMIZATION = MappingProxyType({
    "MAX_TOOL_RESULT_CHARS": 15_000,
    "TRUNCATE_LARGE_RESULTS": True,
    "SHOW_RESULT_STATS": True,
    "SEARCH_RESULT_MAX_MATCHES": 10,
    "LS_DIR_MAX_ITEMS": 20,
    "WEB_SEARCH_MAX_CHARS": 8_000,
    "FETCH_URL_MAX_CHARS": 10_000,
    "FILE_READ_MAX_CHARS": 15_000,
    "TERMINAL_OUTPUT_MAX_CHARS": 5_000,
    "CONSECUTIVE_TOOL_COMPRESSION": True,
    "CONSECUTIVE_COMPRESSION_RATIO": 0.4,
})

# ---- output reservation (tokenOptimizationConfig.ts:126-128) ----
OUTPUT_RESERVE_RATIO = 0.20

# ---- overall targets (tokenOptimizationConfig.ts:172-186) ----
OPTIMIZATION_TARGETS = MappingProxyType({
    "TARGET_REDUCTION": 0.60,
    "MAX_PREPARATION_TIME_MS": 2_000,
    "PRESERVE_CONTEXT_QUALITY": True,
    "ENABLE_MONITORING": True,
    "CODE_EDITING_SAFE_MODE": True,
})


def cap_text(text: str, max_chars: int, *, marker: str = "...") -> str:
    """Truncate ``text`` to ``max_chars`` with an explicit truncation marker
    that reports how much was dropped (SHOW_RESULT_STATS semantics)."""
    if len(text) <= max_chars:
        return text
    kept = max(0, max_chars - 80)
    dropped = len(text) - kept
    return (text[:kept]
            + f"\n{marker} [truncated: {dropped} of {len(text)} chars omitted]")
