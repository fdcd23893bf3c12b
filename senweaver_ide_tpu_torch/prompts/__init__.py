"""Prompt engine: system-message assembly, message fitting, grammar.

The TPU-build analogue of L3 in the reference
(`browser/convertToLLMMessageService.ts`, `common/prompt/prompts.ts`,
`electron-main/llmMessage/extractGrammar.ts`): build the system message
(tool grammar, rules, multi-agent section, APO rules), guarantee prompts
fit the window via the 4-phase pipeline, and parse think-tags + XML tool
calls out of policy output.
"""

from .fitting import (CHARS_PER_TOKEN, TRIM_TO_LEN, FitResult, fit_messages)
from .grammar import (PARAM_ALIASES, THINK_TAGS, RawToolCall,
                      ReasoningExtractor, extract_reasoning_and_tool_call,
                      parse_tool_call, strip_tool_call)
from .system import (APO_RULES_MAX_CHARS, chat_system_message,
                     render_apo_rules, render_tool_definitions)

__all__ = [
    "CHARS_PER_TOKEN", "TRIM_TO_LEN", "FitResult", "fit_messages",
    "PARAM_ALIASES", "THINK_TAGS", "RawToolCall", "ReasoningExtractor",
    "extract_reasoning_and_tool_call", "parse_tool_call",
    "strip_tool_call", "APO_RULES_MAX_CHARS", "chat_system_message",
    "render_apo_rules", "render_tool_definitions",
]
