"""ToolsService: validate → approve → execute → stringify.

The sandboxed analogue of `browser/toolsService.ts` (3947 LoC):
- ``validate_params`` coerces/validates raw (string-valued) model params
  per tool (validateParams, toolsService.ts:1138; error style :860-934).
- ``call_tool`` dispatches with the approval gate collapsed to policy flags
  (auto-approve map, chatThreadService.ts:984-992 + settings key
  autoApprove) — a denied call returns a ToolDeniedError result, which the
  trace records as a failed tool call (reward dim 3/4 inputs).
- ``string_of_result`` renders results for the model under the
  TOOL_RESULT_OPTIMIZATION caps (stringOfResult, toolsService.ts:3265;
  caps tokenOptimizationConfig.ts:148-170).

Network/document tools are registered (full API surface) but their backends
— the reference's Node sidecar servers (start*.cjs, SURVEY §2.5) — are
external processes; handlers can be plugged in via ``register_handler``.
Unplugged, they fail deterministically as unavailable, keeping rollouts
hermetic.
"""

from __future__ import annotations

import json
import time
from typing import Any, Callable, Dict, List, Optional

from ..context.token_config import TOOL_RESULT_OPTIMIZATION, cap_text
from .registry import TOOL_SCHEMAS
from .sandbox import Workspace
from .search_replace import apply_search_replace
from .terminal import TerminalManager
from .types import (APPROVAL_TYPE_OF_TOOL, ApprovalType, ToolDeniedError,
                    ToolResult, ToolUnavailableError, ToolValidationError)

_TRUTHY = {"true", "1", "yes", "y"}


def _as_bool(v: Any, default: bool = False) -> bool:
    if v is None or v == "":
        return default
    if isinstance(v, bool):
        return v
    return str(v).strip().lower() in _TRUTHY


def _as_int(v: Any, name: str, default: Optional[int] = None,
            minimum: Optional[int] = None) -> Optional[int]:
    if v is None or v == "":
        return default
    try:
        i = int(str(v).strip())
    except ValueError:
        raise ToolValidationError(
            f"param {name} must be an integer, got: {v!r}")
    if minimum is not None and i < minimum:
        raise ToolValidationError(f"param {name} must be >= {minimum}: {i}")
    return i


def _req_str(params: Dict[str, Any], name: str) -> str:
    v = params.get(name)
    if v is None:
        raise ToolValidationError(
            f"required param {name} was not provided")
    if not isinstance(v, str):
        raise ToolValidationError(
            f"param {name} must be a string, got {type(v).__name__}: "
            f"{json.dumps(v, default=str)[:100]}")
    if not v.strip():
        raise ToolValidationError(f"param {name} must not be empty")
    return v


class ToolsService:
    """One instance per rollout sandbox."""

    def __init__(self, workspace: Workspace, *,
                 auto_approve: Optional[Dict[ApprovalType, bool]] = None,
                 terminal_isolation: str = "auto"):
        self.workspace = workspace
        self.terminals = TerminalManager(str(workspace.root),
                                         isolation=terminal_isolation)
        # Rollout policy defaults: file/edit tools auto-approve (they are
        # sandbox-confined), but terminal-class tools auto-approve ONLY
        # when the shell is namespace-isolated (no network) — an
        # unconfined model-generated shell breaks both hermeticity and
        # safety. Callers may override explicitly via ``auto_approve``.
        self.auto_approve = {t: True for t in ApprovalType}
        self.auto_approve[ApprovalType.TERMINAL] = self.terminals.isolated
        if auto_approve:
            self.auto_approve.update(auto_approve)
        self._handlers: Dict[str, Callable[[Dict[str, Any]], Any]] = {}
        self._lint_provider: Optional[Callable[[str], List[str]]] = None
        self._pre_execute_hooks: List[
            Callable[[str, Dict[str, Any]], None]] = []
        self.call_log: List[ToolResult] = []

    # -- extension points --------------------------------------------------
    def register_handler(self, tool: str,
                         fn: Callable[[Dict[str, Any]], Any]) -> None:
        """Plug in a backend for a gated tool (network/document/agents) —
        the analogue of the sidecar servers + subagent/skill services."""
        if tool not in TOOL_SCHEMAS:
            raise KeyError(f"unknown tool: {tool}")
        self._handlers[tool] = fn

    def set_lint_provider(self, fn: Callable[[str], List[str]]) -> None:
        self._lint_provider = fn

    def add_pre_execute_hook(
            self, fn: Callable[[str, Dict[str, Any]], None]) -> None:
        """Called with (tool, validated_params) after validation+approval,
        before execution — e.g. before-edit file snapshots. Hook errors
        are swallowed (observers must not fail the tool call)."""
        self._pre_execute_hooks.append(fn)

    # -- validation --------------------------------------------------------
    def validate_params(self, tool: str,
                        raw: Dict[str, Any]) -> Dict[str, Any]:
        schema = TOOL_SCHEMAS.get(tool)
        if schema is None:
            raise ToolValidationError(f"unknown tool name: {tool}")
        # Per-tool coercion into typed params; required params are enforced
        # by the _req_str calls inside each branch.
        p: Dict[str, Any] = {}
        get = raw.get
        if tool == "read_file":
            p["uri"] = _req_str(raw, "uri")
            p["start_line"] = _as_int(get("start_line"), "start_line",
                                      minimum=1)
            p["end_line"] = _as_int(get("end_line"), "end_line", minimum=1)
            p["page_number"] = _as_int(get("page_number"), "page_number", 1,
                                       minimum=1)
        elif tool == "ls_dir":
            p["uri"] = str(get("uri") or "")
            p["page_number"] = _as_int(get("page_number"), "page_number", 1,
                                       minimum=1)
        elif tool == "get_dir_tree":
            p["uri"] = _req_str(raw, "uri")
        elif tool == "search_pathnames_only":
            p["query"] = _req_str(raw, "query")
            p["include_pattern"] = get("include_pattern") or None
            p["page_number"] = _as_int(get("page_number"), "page_number", 1,
                                       minimum=1)
        elif tool == "search_for_files":
            p["query"] = _req_str(raw, "query")
            p["is_regex"] = _as_bool(get("is_regex"))
            p["search_in_folder"] = get("search_in_folder") or None
            p["page_number"] = _as_int(get("page_number"), "page_number", 1,
                                       minimum=1)
        elif tool == "search_in_file":
            p["uri"] = _req_str(raw, "uri")
            p["query"] = _req_str(raw, "query")
            p["is_regex"] = _as_bool(get("is_regex"))
        elif tool == "read_lint_errors":
            p["uri"] = _req_str(raw, "uri")
        elif tool == "create_file_or_folder":
            p["uri"] = _req_str(raw, "uri")
        elif tool == "delete_file_or_folder":
            p["uri"] = _req_str(raw, "uri")
            p["is_recursive"] = _as_bool(get("is_recursive"))
        elif tool == "edit_file":
            p["uri"] = _req_str(raw, "uri")
            blocks = _req_str(raw, "search_replace_blocks")
            if "<<<<<<< ORIGINAL" not in blocks:
                preview = blocks[:100]
                raise ToolValidationError(
                    'search_replace_blocks must contain "<<<<<<< ORIGINAL" '
                    f'markers. You provided: "{preview}...". To replace an '
                    "entire file use rewrite_file instead.")
            p["search_replace_blocks"] = blocks
        elif tool == "rewrite_file":
            p["uri"] = _req_str(raw, "uri")
            nc = raw.get("new_content")
            if nc is None or not isinstance(nc, str):
                raise ToolValidationError(
                    "required param new_content must be a string")
            p["new_content"] = nc
        elif tool == "run_command":
            p["command"] = _req_str(raw, "command")
            p["cwd"] = get("cwd") or None
        elif tool == "open_persistent_terminal":
            p["cwd"] = get("cwd") or None
        elif tool == "run_persistent_command":
            p["command"] = _req_str(raw, "command")
            p["persistent_terminal_id"] = _req_str(
                raw, "persistent_terminal_id")
        elif tool == "kill_persistent_terminal":
            p["persistent_terminal_id"] = _req_str(
                raw, "persistent_terminal_id")
        elif tool in ("open_browser", "fetch_url", "api_request"):
            url = _req_str(raw, "url")
            if not url.startswith(("http://", "https://")):
                raise ToolValidationError(
                    f"Invalid URL: must start with http:// or https://. "
                    f"Got: {url}")
            p = dict(raw)
        elif tool == "web_search":
            p["query"] = _req_str(raw, "query")
            mr = _as_int(get("max_results"), "max_results", 10, minimum=1)
            if mr is not None and mr > 50:
                raise ToolValidationError(
                    f"max_results must be between 1 and 50. Got: {mr}")
            p["max_results"] = mr
        elif tool in ("analyze_image", "screenshot_to_code", "read_document",
                      "edit_document", "create_document", "pdf_operation",
                      "document_convert", "document_merge",
                      "document_extract"):
            for r in TOOL_SCHEMAS[tool].required:
                _req_str(raw, r)
            p = dict(raw)
        elif tool == "spawn_subagent":
            p["agent_type"] = _req_str(raw, "agent_type")
            p["task"] = _req_str(raw, "task")
            p["context"] = get("context") or ""
        elif tool == "edit_agent":
            p["uri"] = _req_str(raw, "uri")
            p["instructions"] = _req_str(raw, "instructions")
            p["mode"] = get("mode") or "edit"
        elif tool == "skill":
            p["name"] = _req_str(raw, "name")
        else:  # pragma: no cover
            p = dict(raw)
        return p

    # -- execution ---------------------------------------------------------
    def call_tool(self, tool: str, raw_params: Dict[str, Any]) -> ToolResult:
        started = time.time()
        t0 = time.monotonic()
        try:
            params = self.validate_params(tool, raw_params)
            approval = APPROVAL_TYPE_OF_TOOL.get(tool)
            if approval is not None and not self.auto_approve.get(approval,
                                                                  False):
                raise ToolDeniedError(
                    f"tool {tool} requires '{approval.value}' approval, "
                    "which this rollout policy denies")
            for hook in self._pre_execute_hooks:
                try:
                    hook(tool, params)
                except Exception:
                    pass
            result = self._execute(tool, params)
            tr = ToolResult(tool=tool, params=params, result=result,
                            started_at=started,
                            duration_ms=(time.monotonic() - t0) * 1e3)
        except Exception as e:
            tr = ToolResult(tool=tool, params=dict(raw_params),
                            error=f"{type(e).__name__}: {e}",
                            started_at=started,
                            duration_ms=(time.monotonic() - t0) * 1e3)
        self.call_log.append(tr)
        return tr

    def _execute(self, tool: str, p: Dict[str, Any]) -> Any:
        ws = self.workspace
        if tool in self._handlers:
            return self._handlers[tool](p)
        if tool == "read_file":
            text, more = ws.read_file(p["uri"], start_line=p["start_line"],
                                      end_line=p["end_line"],
                                      page_number=p["page_number"])
            return {"contents": text, "has_next_page": more}
        if tool == "ls_dir":
            children, more = ws.ls(p["uri"], page_number=p["page_number"])
            return {"children": children, "has_next_page": more}
        if tool == "get_dir_tree":
            return {"tree": ws.dir_tree(p["uri"])}
        if tool == "search_pathnames_only":
            hits, more = ws.search_pathnames(
                p["query"], include_pattern=p["include_pattern"],
                page_number=p["page_number"])
            return {"uris": hits, "has_next_page": more}
        if tool == "search_for_files":
            hits, more = ws.search_files(
                p["query"], is_regex=p["is_regex"],
                search_in_folder=p["search_in_folder"],
                page_number=p["page_number"])
            return {"uris": hits, "has_next_page": more}
        if tool == "search_in_file":
            return {"lines": ws.search_in_file(p["uri"], p["query"],
                                               is_regex=p["is_regex"])}
        if tool == "read_lint_errors":
            if self._lint_provider is None:
                return {"lint_errors": []}
            return {"lint_errors": self._lint_provider(p["uri"])}
        if tool == "create_file_or_folder":
            path = ws.create(p["uri"])
            return {"created": ws.display(path)}
        if tool == "delete_file_or_folder":
            ws.delete(p["uri"], is_recursive=p["is_recursive"])
            return {"deleted": p["uri"]}
        if tool == "edit_file":
            text = ws.read_text(p["uri"])
            new_text = apply_search_replace(text, p["search_replace_blocks"])
            ws.write_file(p["uri"], new_text)
            old_lines, new_lines = text.count("\n"), new_text.count("\n")
            return {"applied": p["uri"],
                    "lines_added": max(0, new_lines - old_lines),
                    "lines_removed": max(0, old_lines - new_lines)}
        if tool == "rewrite_file":
            existed = True
            try:
                ws.read_text(p["uri"])
            except FileNotFoundError:
                existed = False
            ws.write_file(p["uri"], p["new_content"])
            return {"rewrote": p["uri"], "is_new_file": not existed}
        if tool == "run_command":
            cwd = str(ws.resolve(p["cwd"])) if p["cwd"] else None
            r = self.terminals.run_command(p["command"], cwd=cwd)
            return {"output": r.output, "resolve_reason": r.resolve_reason,
                    "exit_code": r.exit_code,
                    "duration_s": round(r.duration_s, 3)}
        if tool == "open_persistent_terminal":
            cwd = str(ws.resolve(p["cwd"])) if p["cwd"] else None
            return {"persistent_terminal_id":
                    self.terminals.open_persistent(cwd=cwd)}
        if tool == "run_persistent_command":
            r = self.terminals.run_persistent(p["persistent_terminal_id"],
                                              p["command"])
            return {"output": r.output, "resolve_reason": r.resolve_reason}
        if tool == "kill_persistent_terminal":
            self.terminals.kill_persistent(p["persistent_terminal_id"])
            return {"killed": p["persistent_terminal_id"]}
        # Gated tools without a registered handler:
        raise ToolUnavailableError(
            f"tool {tool} has no backend in this hermetic sandbox "
            "(register a handler to enable it)")

    # -- stringification ---------------------------------------------------
    def string_of_result(self, tr: ToolResult) -> str:
        """Render a ToolResult for the model, applying per-tool caps."""
        caps = TOOL_RESULT_OPTIMIZATION
        if tr.error is not None:
            return f"Error calling {tr.tool}: {tr.error}"
        r = tr.result
        if tr.tool == "read_file":
            body = cap_text(r["contents"], caps["FILE_READ_MAX_CHARS"])
            more = "\n(more pages available)" if r["has_next_page"] else ""
            return body + more
        if tr.tool == "ls_dir":
            items = r["children"][:caps["LS_DIR_MAX_ITEMS"]]
            lines = [name for name, _ in items]
            extra = len(r["children"]) - len(items)
            if extra > 0 or r["has_next_page"]:
                lines.append(f"... ({extra} more entries; paginate for the "
                             "rest)")
            return "\n".join(lines) if lines else "(empty folder)"
        if tr.tool == "get_dir_tree":
            return cap_text(r["tree"], caps["MAX_TOOL_RESULT_CHARS"])
        if tr.tool in ("search_pathnames_only", "search_for_files"):
            hits = r["uris"][:caps["SEARCH_RESULT_MAX_MATCHES"]]
            out = "\n".join(hits) if hits else "(no matches)"
            extra = len(r["uris"]) - len(hits)
            if extra > 0 or r["has_next_page"]:
                out += f"\n... ({extra} more matches; paginate or narrow " \
                       "the query)"
            return out
        if tr.tool == "search_in_file":
            return ("match at lines: "
                    + ", ".join(map(str, r["lines"]))) if r["lines"] \
                else "(no matches)"
        if tr.tool == "read_lint_errors":
            errs = r["lint_errors"]
            return "\n".join(errs) if errs else "(no lint errors)"
        if tr.tool in ("run_command", "run_persistent_command"):
            out = cap_text(r["output"], caps["TERMINAL_OUTPUT_MAX_CHARS"])
            tail = ""
            if r["resolve_reason"] == "timeout":
                tail = "\n(command timed out after 8s of inactivity)"
            elif r["resolve_reason"] == "bgtimeout":
                tail = "\n(command still running in background)"
            elif r.get("exit_code") is not None:
                tail = f"\n(exit code {r['exit_code']})"
            return (out or "(no output)") + tail
        if tr.tool == "web_search":
            return cap_text(str(r), caps["WEB_SEARCH_MAX_CHARS"])
        if tr.tool == "fetch_url":
            return cap_text(str(r), caps["FETCH_URL_MAX_CHARS"])
        if isinstance(r, str):
            return cap_text(r, caps["MAX_TOOL_RESULT_CHARS"])
        return cap_text(json.dumps(r, default=str),
                        caps["MAX_TOOL_RESULT_CHARS"])

    def close(self) -> None:
        self.terminals.close()
