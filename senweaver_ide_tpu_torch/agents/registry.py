"""Multi-agent registry: definitions, permissions, compositions.

The declarative agent system of `common/agentService.ts`:
- AgentPermission / AgentDefinition (:40-77)
- BUILTIN_AGENTS (:166-460): primary agents (build maxSteps 50, chat 20,
  designer 100), subagents (explore/plan/code/review/test/ui/api with
  per-agent tool allowlists + temperatures), system agents
  (compaction/summary/title, hidden)
- AGENT_COMPOSITIONS per ChatMode (:486-522): agent mode = build +
  [explore, plan, code, review, test] maxParallel 3; designer maxParallel 4
- keyword-based recommend_subagents (:583-613) and complexity gate
  should_use_subagents (:643-665)

In the TPU build these registries parameterize rollouts: each agent is a
(system prompt, tool filter, temperature, step budget) bundle the rollout
engine samples under, and nested spawns follow the same composition rules —
so trace statistics (and therefore rewards) are produced under the same
policy the reference uses.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

ChatMode = str  # 'normal' | 'agent' | 'designer' | 'gather'


@dataclasses.dataclass(frozen=True)
class AgentPermission:
    """agentService.ts:40-52."""
    can_read: bool = True
    can_write: bool = True
    can_delete: bool = True
    allowed_tools: Union[str, Tuple[str, ...]] = "*"   # '*' or tool names
    denied_tools: Tuple[str, ...] = ()
    can_access_network: bool = True
    can_execute_terminal: bool = True
    can_use_mcp: bool = True


FULL = AgentPermission()
READ_ONLY = AgentPermission(
    can_write=False, can_delete=False,
    allowed_tools=("read_file", "ls_dir", "get_dir_tree",
                   "search_pathnames_only", "search_for_files",
                   "search_in_file", "read_lint_errors", "web_search",
                   "fetch_url"),
    can_access_network=False, can_execute_terminal=False, can_use_mcp=False)
EXPLORE_PERM = AgentPermission(
    can_write=False, can_delete=False,
    allowed_tools=("read_file", "ls_dir", "get_dir_tree",
                   "search_pathnames_only", "search_for_files",
                   "search_in_file", "web_search", "fetch_url"),
    can_access_network=True, can_execute_terminal=False, can_use_mcp=False)
SYSTEM_PERM = AgentPermission(
    can_write=False, can_delete=False, allowed_tools=(),
    can_access_network=False, can_execute_terminal=False, can_use_mcp=False)


@dataclasses.dataclass(frozen=True)
class AgentDefinition:
    """agentService.ts:57-77."""
    id: str
    name: str
    description: str
    mode: str                                  # 'primary'|'subagent'|'system'
    permission: AgentPermission
    system_prompt: Optional[str] = None
    temperature: Optional[float] = None
    max_steps: Optional[int] = None
    hidden: bool = False


_EXPLORE_PROMPT = """\
You are a code-exploration agent. Explore the codebase quickly and \
efficiently: search pathnames and contents, read files, inspect directory \
structure. You cannot modify any files. Focus on finding the relevant code \
and reporting a clear, well-cited analysis."""

_PLAN_PROMPT = """\
You are a task-planning agent. Analyze the request and produce a clear \
execution plan: understand the goal, survey the current code, break the \
work into concrete ordered steps, and flag risks and dependencies. Output \
sections: Task Analysis, Execution Plan (numbered), Notes (risks)."""

_CODE_PROMPT = """\
You are a coding agent. Complete code-writing and modification tasks with \
high quality: follow the existing style, keep changes clear and minimal, \
add necessary error handling, never delete existing comments, and check \
lint errors after editing."""

_REVIEW_PROMPT = """\
You are a code-review agent. Review the code for correctness, performance, \
security, style, and best practices. Output sections: Review Summary, \
Issues Found (each with a suggestion), Improvement Suggestions."""

_UI_PROMPT = """\
You are a UI design and development agent. Build clean, usable interfaces: \
modern visual style, responsive layout, good UX, design-system consistency, \
and accessibility."""

# BUILTIN_AGENTS (agentService.ts:166-460).
BUILTIN_AGENTS: Dict[str, AgentDefinition] = {a.id: a for a in [
    # -- primary --
    AgentDefinition("build", "Build Agent",
                    "Primary build agent with full permissions: read/write "
                    "files, run commands, call every tool.",
                    "primary", FULL, max_steps=50),
    AgentDefinition("chat", "Chat Agent",
                    "Conversation agent for code discussion and Q&A; reads "
                    "files but does not modify them.",
                    "primary",
                    dataclasses.replace(READ_ONLY, can_access_network=True),
                    max_steps=20),
    AgentDefinition("designer", "Designer Agent",
                    "Design-focused primary agent for UI, components, and "
                    "front/backend interface work.",
                    "primary", FULL, max_steps=100),
    # -- subagents --
    AgentDefinition("explore", "Explore Agent",
                    "Fast read-only codebase exploration: find files, "
                    "search code, map structure.",
                    "subagent", EXPLORE_PERM, system_prompt=_EXPLORE_PROMPT,
                    max_steps=15, temperature=0.3),
    AgentDefinition("plan", "Plan Agent",
                    "Analyzes complex tasks and produces step-by-step "
                    "execution plans.",
                    "subagent",
                    dataclasses.replace(READ_ONLY, allowed_tools=(
                        "read_file", "ls_dir", "get_dir_tree",
                        "search_pathnames_only", "search_for_files")),
                    system_prompt=_PLAN_PROMPT, max_steps=10,
                    temperature=0.2),
    AgentDefinition("code", "Code Agent",
                    "Focused code writing and modification.",
                    "subagent",
                    AgentPermission(
                        can_delete=False,
                        allowed_tools=("read_file", "edit_file",
                                       "rewrite_file",
                                       "create_file_or_folder",
                                       "search_for_files", "search_in_file",
                                       "read_lint_errors"),
                        denied_tools=("delete_file_or_folder",
                                      "run_command"),
                        can_access_network=False, can_execute_terminal=False,
                        can_use_mcp=False),
                    system_prompt=_CODE_PROMPT, max_steps=30,
                    temperature=0.1),
    AgentDefinition("review", "Review Agent",
                    "Code review: quality, problems, best practices.",
                    "subagent", READ_ONLY, system_prompt=_REVIEW_PROMPT,
                    max_steps=10, temperature=0.2),
    AgentDefinition("test", "Test Agent",
                    "Writes and runs unit/integration tests to verify "
                    "correctness.",
                    "subagent",
                    AgentPermission(
                        can_delete=False,
                        allowed_tools=("read_file", "edit_file",
                                       "rewrite_file",
                                       "create_file_or_folder",
                                       "search_for_files", "run_command"),
                        denied_tools=("delete_file_or_folder",),
                        can_access_network=False, can_execute_terminal=True,
                        can_use_mcp=False),
                    max_steps=20, temperature=0.1),
    AgentDefinition("ui", "UI Agent",
                    "Interface design, component development, styling.",
                    "subagent",
                    AgentPermission(
                        can_delete=False,
                        allowed_tools=("read_file", "edit_file",
                                       "rewrite_file",
                                       "create_file_or_folder",
                                       "search_for_files", "web_search",
                                       "fetch_url"),
                        denied_tools=("delete_file_or_folder",
                                      "run_command"),
                        can_access_network=True, can_execute_terminal=False,
                        can_use_mcp=False),
                    system_prompt=_UI_PROMPT, max_steps=30, temperature=0.3),
    AgentDefinition("api", "API Agent",
                    "Backend API design, development, and docs.",
                    "subagent",
                    AgentPermission(
                        can_delete=False,
                        allowed_tools=("read_file", "edit_file",
                                       "rewrite_file",
                                       "create_file_or_folder",
                                       "search_for_files", "web_search"),
                        denied_tools=("delete_file_or_folder",),
                        can_access_network=True, can_execute_terminal=False,
                        can_use_mcp=False),
                    max_steps=25, temperature=0.1),
    # -- system --
    AgentDefinition("compaction", "Compaction Agent",
                    "Generates concise summaries of conversation history.",
                    "system", SYSTEM_PERM, hidden=True, temperature=0.3),
    AgentDefinition("summary", "Summary Agent",
                    "Generates task-execution summary reports.",
                    "system", SYSTEM_PERM, hidden=True, temperature=0.3),
    AgentDefinition("title", "Title Agent",
                    "Generates short conversation titles.",
                    "system", SYSTEM_PERM, hidden=True, temperature=0.5),
]}


@dataclasses.dataclass(frozen=True)
class AgentComposition:
    """agentService.ts:471-484."""
    primary_agent: str
    available_subagents: Tuple[str, ...]
    enable_parallel: bool
    max_parallel: int
    auto_select_subagents: bool


# AGENT_COMPOSITIONS (agentService.ts:486-522).
AGENT_COMPOSITIONS: Dict[ChatMode, AgentComposition] = {
    "normal": AgentComposition("chat", ("explore",), False, 1, False),
    "agent": AgentComposition(
        "build", ("explore", "plan", "code", "review", "test"), True, 3,
        True),
    "designer": AgentComposition(
        "designer", ("explore", "plan", "ui", "api", "code", "review"),
        True, 4, True),
    "gather": AgentComposition("chat", ("explore",), False, 1, False),
}


def get_agent(agent_id: str) -> Optional[AgentDefinition]:
    return BUILTIN_AGENTS.get(agent_id)


def get_composition(chat_mode: ChatMode) -> AgentComposition:
    return AGENT_COMPOSITIONS.get(chat_mode, AGENT_COMPOSITIONS["normal"])


def can_agent_use_tool(agent_id: str, tool_name: str) -> bool:
    """agentService.ts:556-577: denied list first, then '*' or allowlist."""
    agent = get_agent(agent_id)
    if agent is None:
        return False
    perm = agent.permission
    if tool_name in perm.denied_tools:
        return False
    if perm.allowed_tools == "*":
        return True
    return tool_name in perm.allowed_tools


# Keyword rules (agentService.ts:593-602). The reference matches both CJK
# and English keywords; keep both sets for parity with its traces.
_KEYWORD_RULES: Sequence[Tuple[Tuple[str, ...], str]] = (
    (("搜索", "查找", "找到", "探索", "search", "find", "explore",
      "locate"), "explore"),
    (("计划", "规划", "设计方案", "plan", "design"), "plan"),
    (("编写", "修改", "实现", "代码", "code", "implement", "write",
      "modify"), "code"),
    (("审查", "检查", "优化", "review", "check", "optimize"), "review"),
    (("测试", "验证", "test", "verify"), "test"),
    (("界面", "ui", "组件", "样式", "component", "style", "layout"), "ui"),
    (("接口", "api", "后端", "backend", "endpoint"), "api"),
)

_COMPLEX_KEYWORDS = (
    "重构", "优化", "实现", "创建", "设计",
    "refactor", "optimize", "implement", "create", "design",
    "多个文件", "整个项目", "全面",
    "multiple files", "entire project", "comprehensive",
)


def recommend_subagents(task: str, chat_mode: ChatMode) -> List[str]:
    """agentService.ts:583-613: keyword rules → dedup → cap at
    max_parallel."""
    comp = get_composition(chat_mode)
    if not comp.auto_select_subagents:
        return []
    lower = task.lower()
    rec: List[str] = []
    for keywords, agent_id in _KEYWORD_RULES:
        if any(kw in lower for kw in keywords):
            if agent_id in comp.available_subagents and agent_id not in rec:
                rec.append(agent_id)
    return rec[:comp.max_parallel]


def should_use_subagents(task: str, chat_mode: ChatMode) -> bool:
    """agentService.ts:643-665: auto-select on, ≥50 chars, complex
    keyword."""
    comp = get_composition(chat_mode)
    if not comp.auto_select_subagents:
        return False
    if len(task) < 50:
        return False
    lower = task.lower()
    return any(kw in lower for kw in _COMPLEX_KEYWORDS)
