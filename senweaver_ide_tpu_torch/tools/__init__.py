"""Hermetic tool sandbox for agent rollouts.

The TPU-build analogue of the reference's tool stack
(`browser/toolsService.ts` + `common/toolsServiceTypes.ts` +
`prompt/prompts.ts` builtinTools): same 31-tool API surface, validation and
result-cap semantics, confined to a reproducible sandbox so rollout rewards
are valid (SURVEY.md §7).
"""

from .documents import (DocumentServices, docx_write, image_info,
                        minipdf_extract_pages, minipdf_write, pptx_text,
                        pptx_write, xlsx_write)
from .registry import TOOL_SCHEMAS, ToolSchema
from .sandbox import SandboxViolation, Workspace
from .search_replace import (DIVIDER, FINAL, ORIGINAL, MalformedBlocksError,
                             SearchNotFoundError, SearchReplaceBlock,
                             apply_blocks, apply_search_replace,
                             extract_blocks)
from .service import ToolsService
from .terminal import CommandResult, TerminalManager
from .types import (APPROVAL_TYPE_OF_TOOL, BUILTIN_TOOL_NAMES, ApprovalType,
                    ToolDeniedError, ToolResult, ToolUnavailableError,
                    ToolValidationError)

__all__ = [
    "DocumentServices", "docx_write", "image_info",
    "minipdf_extract_pages", "minipdf_write", "pptx_text", "pptx_write",
    "xlsx_write",
    "TOOL_SCHEMAS", "ToolSchema", "SandboxViolation", "Workspace",
    "ORIGINAL", "DIVIDER", "FINAL", "MalformedBlocksError",
    "SearchNotFoundError", "SearchReplaceBlock", "apply_blocks",
    "apply_search_replace", "extract_blocks", "ToolsService",
    "CommandResult", "TerminalManager", "APPROVAL_TYPE_OF_TOOL",
    "BUILTIN_TOOL_NAMES", "ApprovalType", "ToolDeniedError", "ToolResult",
    "ToolUnavailableError", "ToolValidationError",
]
