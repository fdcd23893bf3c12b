"""System-message assembly for agent rollouts.

The analogue of `chat_systemMessage` (prompt/prompts.ts:806-1180) plus the
assembly pipeline of `browser/convertToLLMMessageService.ts:735-862`:

  header (per chat mode) → system info → XML tool definitions → per-mode
  rules → workspace directory tree (capped) → '# Multi-Agent System'
  section (:788-832) → '# APO Optimized Rules' under a 2000-char budget
  (:834-856, APO_RULES_MAX_CHARS).

The text is this framework's own condensed wording of the same behavioral
contract (tool discipline, progressive exploration, edit precision,
verification) — prompt text is policy, and the APO loop exists to rewrite
it, so fidelity here means structure + rule semantics, not byte equality.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from ..agents.scheduler import AgentScheduler
from ..tools.registry import TOOL_SCHEMAS

APO_RULES_MAX_CHARS = 2000        # convertToLLMMessageService.ts:835

_HEADERS: Dict[str, str] = {
    "agent": (
        "You are an expert coding agent working inside the user's "
        "workspace. You accomplish tasks end-to-end by calling tools: "
        "explore, plan, edit, run, and verify until the task is complete."),
    "normal": (
        "You are an expert coding assistant. You discuss code and answer "
        "questions precisely; you read context but do not modify files."),
    "gather": (
        "You are a context-gathering assistant. Use read/search tools "
        "extensively to collect the information needed to answer "
        "thoroughly, citing file paths."),
    "designer": (
        "You are an expert UI/UX designer and frontend developer. You "
        "produce complete, production-grade interface systems: plan every "
        "required page first, then generate each page fully."),
}

_COMMON_RULES = [
    "Use only information from the workspace; never invent file paths, "
    "functions, or code.",
    "Never emit internal think tags in the visible reply.",
    "Call ONE tool at a time and wait for its result.",
    "Only call tools listed under Available tools.",
    "Progressive exploration: orient with the directory tree, search to "
    "locate, read only what the current step needs (use line ranges for "
    "large files), then act.",
]

_AGENT_RULES = [
    "Take actions with tools; when asked to change code, make the change — "
    "do not just describe it.",
    "Complete the ENTIRE task before stopping: create, integrate, verify.",
    "Gather enough context to be certain before editing; copy exact text "
    "from read_file output into SEARCH blocks and keep them small.",
    "After editing, verify: check lint errors and re-read the changed "
    "region.",
    "Prefer edit_file for targeted changes; rewrite_file only for full "
    "rewrites or after repeated edit failures; new files: "
    "create_file_or_folder then rewrite_file with complete content.",
    "Your context budget is shared across the conversation: avoid "
    "re-reading files and pre-reading everything upfront.",
]

_NORMAL_RULES = [
    "If more context is needed, ask the user to reference files with @.",
    "Provide complete solutions: reasoning, examples, edge cases.",
]

_GATHER_RULES = [
    "You MUST use tools to gather information before answering.",
    "Read and search extensively; answer with thorough explanations and "
    "file citations.",
]


def render_tool_definitions(tool_names: Optional[Sequence[str]] = None
                            ) -> str:
    """XML tool-call grammar section (systemToolsXMLPrompt role)."""
    names = tool_names if tool_names is not None else list(TOOL_SCHEMAS)
    lines = [
        "# Available tools",
        "Call a tool by emitting exactly one XML block:",
        "<tool_name>",
        "<param_name>value</param_name>",
        "</tool_name>",
        "Available tools:",
    ]
    for n in names:
        s = TOOL_SCHEMAS.get(n)
        if s is None:
            continue
        lines.append(f"\n## {s.name}")
        lines.append(s.description)
        for p, desc in s.params.items():
            req = " (required)" if p in s.required else ""
            lines.append(f"- {p}{req}: {desc}")
    return "\n".join(lines)


def chat_system_message(*, chat_mode: str = "agent",
                        workspace_folders: Sequence[str] = (),
                        directory_str: str = "",
                        active_uri: Optional[str] = None,
                        persistent_terminal_ids: Sequence[str] = (),
                        tool_names: Optional[Sequence[str]] = None,
                        include_tool_definitions: bool = True,
                        include_multi_agent: bool = True,
                        apo_rules: Sequence[str] = (),
                        current_datetime: str = "") -> str:
    parts: List[str] = [_HEADERS.get(chat_mode, _HEADERS["agent"])]

    info = ["\n# System information"]
    if current_datetime:
        info.append(f"Current time: {current_datetime}")
    if workspace_folders:
        info.append("Workspace folders: " + ", ".join(workspace_folders))
    if active_uri:
        info.append(f"Active file: {active_uri}")
    if persistent_terminal_ids:
        info.append("Open persistent terminals: "
                    + ", ".join(persistent_terminal_ids))
    if len(info) > 1:
        parts.append("\n".join(info))

    if include_tool_definitions:
        parts.append("\n" + render_tool_definitions(tool_names))

    rules = list(_COMMON_RULES)
    if chat_mode == "agent":
        rules += _AGENT_RULES
    elif chat_mode == "gather":
        rules += _GATHER_RULES
    elif chat_mode == "normal":
        rules += _NORMAL_RULES
    parts.append("\n# Rules\n" + "\n".join(f"- {r}" for r in rules))

    if directory_str:
        parts.append("\n# Workspace structure\n" + directory_str)

    if include_multi_agent and chat_mode in ("agent", "designer"):
        parts.append("\n" + AgentScheduler.enhanced_system_prompt(chat_mode))

    apo_section = render_apo_rules(apo_rules)
    if apo_section:
        parts.append("\n" + apo_section)
    return "\n".join(parts)


def render_apo_rules(rules: Sequence[str],
                     max_chars: int = APO_RULES_MAX_CHARS) -> str:
    """'# APO Optimized Rules' injection under the 2000-char budget
    (convertToLLMMessageService.ts:834-856): whole rules only, in order,
    until the budget is exhausted."""
    if not rules:
        return ""
    header = "# APO Optimized Rules"
    out: List[str] = [header]
    used = len(header)
    for r in rules:
        line = f"- {r.strip()}"
        if used + len(line) + 1 > max_chars:
            break
        out.append(line)
        used += len(line) + 1
    if len(out) == 1:
        return ""
    return "\n".join(out)
