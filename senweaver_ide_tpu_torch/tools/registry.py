"""Builtin tool schema registry — rendered into the system prompt.

The analogue of `prompt/prompts.ts:225-718` (builtinTools): one entry per
active tool with a description and named params. The agent loop renders
these as the XML tool-call grammar the local policy emits (the reference
renders them for providers without native tool APIs via
extractXMLToolsWrapper, extractGrammar.ts:324 — the local-policy path here
always uses that grammar).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Sequence

from .types import BUILTIN_TOOL_NAMES


@dataclasses.dataclass(frozen=True)
class ToolSchema:
    name: str
    description: str
    params: Mapping[str, str]          # param name → description
    required: Sequence[str] = ()


_URI = "Full sandbox path to the target."
_PAGE = "Optional 1-based page number for paginated results."

TOOL_SCHEMAS: Dict[str, ToolSchema] = {s.name: s for s in [
    # --- context gathering ---
    ToolSchema("read_file", "Read the contents of a file.",
               {"uri": _URI,
                "start_line": "Optional first line (1-based).",
                "end_line": "Optional last line (inclusive).",
                "page_number": _PAGE}, ("uri",)),
    ToolSchema("ls_dir", "List the files and folders in a directory.",
               {"uri": "Optional folder path; empty for workspace root.",
                "page_number": _PAGE}),
    ToolSchema("get_dir_tree",
               "Print a bounded tree diagram of a folder — an efficient "
               "way to learn the layout of the workspace.",
               {"uri": _URI}, ("uri",)),
    ToolSchema("search_pathnames_only",
               "Find files whose NAME or path matches the query.",
               {"query": "Substring or glob to match against pathnames.",
                "include_pattern": "Optional glob filter over results.",
                "page_number": _PAGE}, ("query",)),
    ToolSchema("search_for_files",
               "Find files whose CONTENT matches the query.",
               {"query": "Substring or regex to search for.",
                "is_regex": "Optional bool; default false.",
                "search_in_folder": "Optional folder to restrict the search.",
                "page_number": _PAGE}, ("query",)),
    ToolSchema("search_in_file",
               "Return the 1-based line numbers where the query matches "
               "inside one file.",
               {"uri": _URI,
                "query": "Substring or regex.",
                "is_regex": "Optional bool; default false."},
               ("uri", "query")),
    ToolSchema("read_lint_errors", "Read lint diagnostics for a file.",
               {"uri": _URI}, ("uri",)),
    # --- edits ---
    ToolSchema("create_file_or_folder",
               "Create a file or folder (missing parents are created). A "
               "trailing slash means folder; no trailing slash means file.",
               {"uri": _URI}, ("uri",)),
    ToolSchema("delete_file_or_folder", "Delete a file or folder.",
               {"uri": _URI,
                "is_recursive": "Optional bool; delete folders recursively."},
               ("uri",)),
    ToolSchema("edit_file",
               "Apply SEARCH/REPLACE block edits to a file. Provide one "
               "string containing <<<<<<< ORIGINAL / ======= / "
               ">>>>>>> UPDATED blocks whose ORIGINAL text is copied "
               "exactly from read_file output.",
               {"uri": _URI,
                "search_replace_blocks": "The SEARCH/REPLACE block string."},
               ("uri", "search_replace_blocks")),
    ToolSchema("rewrite_file", "Replace the entire contents of a file.",
               {"uri": _URI, "new_content": "The complete new file text."},
               ("uri", "new_content")),
    # --- terminal ---
    ToolSchema("run_command",
               "Run a shell command and wait for it (times out after 8s of "
               "output inactivity).",
               {"command": "The shell command.",
                "cwd": "Optional working directory."}, ("command",)),
    ToolSchema("open_persistent_terminal",
               "Open a long-lived background shell; returns its ID.",
               {"cwd": "Optional working directory."}),
    ToolSchema("run_persistent_command",
               "Run a command in a persistent terminal; returns output "
               "after 5s while the command keeps running.",
               {"command": "The shell command.",
                "persistent_terminal_id": "ID from "
                                          "open_persistent_terminal."},
               ("command", "persistent_terminal_id")),
    ToolSchema("kill_persistent_terminal",
               "Kill a persistent terminal by ID.",
               {"persistent_terminal_id": "The terminal ID."},
               ("persistent_terminal_id",)),
    # --- network (gated in the hermetic sandbox) ---
    ToolSchema("open_browser", "Open a URL in a browser session.",
               {"url": "http(s) URL.", "headless": "Optional bool."},
               ("url",)),
    ToolSchema("fetch_url", "Fetch a URL and return readable content.",
               {"url": "http(s) URL.", "max_length": "Optional char cap.",
                "start_index": "Optional offset into the content."},
               ("url",)),
    ToolSchema("web_search", "Search the web.",
               {"query": "The search query.",
                "max_results": "Optional, 1-50."}, ("query",)),
    ToolSchema("analyze_image", "Analyze an image with a vision model.",
               {"image_data": "Base64 image.",
                "prompt": "Optional instruction."}, ("image_data",)),
    ToolSchema("screenshot_to_code",
               "Generate UI code from a screenshot or URL.",
               {"source": "'image' or 'url'.", "image_data": "Base64 image.",
                "url": "Source URL.", "stack": "Target framework."},
               ("source",)),
    ToolSchema("api_request", "Make an HTTP API request.",
               {"url": "http(s) URL.", "method": "GET/POST/…",
                "headers": "Optional JSON object.",
                "body": "Optional request body."}, ("url",)),
    # --- documents (gated) ---
    ToolSchema("read_document",
               "Read text from a document (docx/xlsx/pptx/pdf).",
               {"uri": _URI, "start_index": "Optional offset.",
                "max_length": "Optional char cap."}, ("uri",)),
    ToolSchema("edit_document", "Edit a document's text content.",
               {"uri": _URI, "content": "New content.",
                "replacements": "Optional find/replace list."}, ("uri",)),
    ToolSchema("create_document", "Create a new document.",
               {"type": "'word' | 'excel' | 'ppt'.",
                "file_path": "Target path.",
                "document_data": "Structured content."},
               ("type", "file_path", "document_data")),
    ToolSchema("pdf_operation", "Merge/split/watermark PDFs.",
               {"operation": "'merge' | 'split' | 'watermark'.",
                "input_files": "Inputs.", "output_path": "Output."},
               ("operation",)),
    ToolSchema("document_convert", "Convert a document between formats.",
               {"input_file": "Source.", "output_path": "Target.",
                "format": "Optional target format."},
               ("input_file", "output_path")),
    ToolSchema("document_merge", "Merge multiple documents into one.",
               {"input_files": "Inputs.", "output_path": "Output."},
               ("input_files", "output_path")),
    ToolSchema("document_extract", "Extract structured data from documents.",
               {"input_file": "Source.", "extract_type": "What to extract."},
               ("input_file",)),
    # --- agents ---
    ToolSchema("spawn_subagent",
               "Spawn a specialized subagent to work on a subtask in "
               "parallel; returns its final report.",
               {"agent_type": "One of the registered subagent types.",
                "task": "The subtask description.",
                "context": "Optional extra context."},
               ("agent_type", "task")),
    ToolSchema("edit_agent",
               "Delegate a code edit to the dedicated edit agent.",
               {"uri": _URI, "instructions": "What to change.",
                "mode": "'edit' | 'create' | 'overwrite'."},
               ("uri", "instructions")),
    ToolSchema("skill",
               "Load a named skill's full instructions on demand.",
               {"name": "The skill name."}, ("name",)),
]}

assert set(TOOL_SCHEMAS) == set(BUILTIN_TOOL_NAMES), (
    set(TOOL_SCHEMAS) ^ set(BUILTIN_TOOL_NAMES))
