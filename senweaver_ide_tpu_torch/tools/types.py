"""Tool-system types: names, approval classes, results, errors.

Mirrors the reference's `common/toolsServiceTypes.ts`: the 31 active builtin
tool names (BuiltinToolCallParams :51-162), the approval-type map
(approvalTypeOfBuiltinToolName :28-37 — edits / terminal / MCP tools), and the
result envelope the agent loop consumes. The TPU build's rollout sandbox keeps
the same names and approval classes so traces produced here feed the same
reward dimensions (tool_success_rate etc., traceCollectorService.ts:697-729).
"""

from __future__ import annotations

import dataclasses
import enum
import time
from typing import Any, Dict, Optional

# The 31 active builtin tools (toolsServiceTypes.ts:51-162; registry rendered
# into the system prompt from prompt/prompts.ts:225-718 `builtinTools`).
CONTEXT_TOOLS = (
    "read_file", "ls_dir", "get_dir_tree", "search_pathnames_only",
    "search_for_files", "search_in_file", "read_lint_errors",
)
EDIT_TOOLS = (
    "create_file_or_folder", "delete_file_or_folder", "edit_file",
    "rewrite_file",
)
TERMINAL_TOOLS = (
    "run_command", "run_persistent_command", "open_persistent_terminal",
    "kill_persistent_terminal",
)
NETWORK_TOOLS = (
    "open_browser", "fetch_url", "web_search", "analyze_image",
    "screenshot_to_code", "api_request",
)
DOCUMENT_TOOLS = (
    "read_document", "edit_document", "create_document", "pdf_operation",
    "document_convert", "document_merge", "document_extract",
)
AGENT_TOOLS = ("spawn_subagent", "edit_agent", "skill")

BUILTIN_TOOL_NAMES = (CONTEXT_TOOLS + EDIT_TOOLS + TERMINAL_TOOLS
                      + NETWORK_TOOLS + DOCUMENT_TOOLS + AGENT_TOOLS)


class ApprovalType(str, enum.Enum):
    """Approval classes gating tool execution
    (toolsServiceTypes.ts:28-44)."""
    EDITS = "edits"
    TERMINAL = "terminal"
    MCP = "MCP tools"


# approvalTypeOfBuiltinToolName (toolsServiceTypes.ts:28-37): only edit and
# terminal tools require approval; everything else auto-runs.
APPROVAL_TYPE_OF_TOOL: Dict[str, ApprovalType] = {
    "create_file_or_folder": ApprovalType.EDITS,
    "delete_file_or_folder": ApprovalType.EDITS,
    "rewrite_file": ApprovalType.EDITS,
    "edit_file": ApprovalType.EDITS,
    "edit_document": ApprovalType.EDITS,
    "create_document": ApprovalType.EDITS,
    "run_command": ApprovalType.TERMINAL,
    "run_persistent_command": ApprovalType.TERMINAL,
    "open_persistent_terminal": ApprovalType.TERMINAL,
    "kill_persistent_terminal": ApprovalType.TERMINAL,
}


class ToolValidationError(ValueError):
    """Raised by validate_params — maps to the reference's throw-in-validate
    pattern (toolsService.ts:860-934); the agent loop feeds the message back
    to the model as a tool error (chatThreadService.ts:963-982)."""


class ToolDeniedError(PermissionError):
    """Tool required approval and the rollout policy denied it
    (approval gate, chatThreadService.ts:984-992)."""


class ToolUnavailableError(RuntimeError):
    """Tool exists in the registry but its backend is not available in the
    hermetic sandbox (network/document sidecars, start*.cjs — absent here
    unless an external handler is registered)."""


@dataclasses.dataclass
class ToolResult:
    """Envelope returned by ToolsService.call_tool — the analogue of the
    {result, interrupted} shape _runToolCall builds
    (chatThreadService.ts:1089-1167)."""
    tool: str
    params: Dict[str, Any]
    result: Any = None
    error: Optional[str] = None
    duration_ms: float = 0.0
    started_at: float = dataclasses.field(default_factory=time.time)

    @property
    def ok(self) -> bool:
        return self.error is None
