"""AgentScheduler: session planning, parallel subagent execution, merging.

Reproduces `common/agentScheduler.ts` (505 LoC):
- start_session (:100) / plan_subagents (:125): keyword-recommended
  subagent tasks for a user request under the mode's composition
- execute (:203-258): chunked parallel execution respecting max_parallel
- merge_results (:314): combined report from subagent outputs
- enhanced_system_prompt (:425-462): primary-agent role + subagent catalog
  appended to the system message (also convertToLLMMessageService.ts:788-832
  '# Multi-Agent System' section)
- tool filter per mode (:496-505)
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

from .registry import (BUILTIN_AGENTS, ChatMode, get_agent, get_composition,
                       recommend_subagents, should_use_subagents)
from .subagent import SubagentResult, SubagentRunner


@dataclasses.dataclass
class ScheduledTask:
    agent_type: str
    task: str
    context: str = ""


@dataclasses.dataclass
class AgentSession:
    session_id: str
    chat_mode: ChatMode
    user_request: str
    planned: List[ScheduledTask] = dataclasses.field(default_factory=list)
    results: List[SubagentResult] = dataclasses.field(default_factory=list)
    started_at: float = dataclasses.field(default_factory=time.time)


class AgentScheduler:
    """Singleton-style planner/executor (getAgentScheduler,
    agentScheduler.ts:410)."""

    def __init__(self, runner: SubagentRunner):
        self.runner = runner
        self._sessions: Dict[str, AgentSession] = {}
        self._next = 1

    def start_session(self, user_request: str,
                      chat_mode: ChatMode = "agent") -> AgentSession:
        sid = f"session-{self._next}"
        self._next += 1
        s = AgentSession(sid, chat_mode, user_request)
        self._sessions[sid] = s
        return s

    def plan_subagents(self, session: AgentSession) -> List[ScheduledTask]:
        """planSubAgents (agentScheduler.ts:125): gate on complexity, then
        one task per recommended subagent."""
        if not should_use_subagents(session.user_request, session.chat_mode):
            session.planned = []
            return []
        rec = recommend_subagents(session.user_request, session.chat_mode)
        session.planned = [
            ScheduledTask(agent_type=a,
                          task=session.user_request,
                          context=f"You handle the '{a}' aspect of this "
                                  "request.")
            for a in rec]
        return session.planned

    def execute(self, session: AgentSession) -> List[SubagentResult]:
        """executeSubAgentTasks (agentScheduler.ts:203-258): chunked
        parallel with the mode's max_parallel."""
        comp = get_composition(session.chat_mode)
        reqs = [{"agent_type": t.agent_type, "task": t.task,
                 "context": t.context} for t in session.planned]
        session.results = self.runner.spawn_many(
            reqs, max_parallel=comp.max_parallel
            if comp.enable_parallel else 1)
        return session.results

    @staticmethod
    def merge_results(results: List[SubagentResult]) -> str:
        """mergeSubAgentResults (agentScheduler.ts:314)."""
        if not results:
            return ""
        parts = ["# Subagent Reports"]
        for r in results:
            status = "ok" if r.success else f"FAILED ({r.error})"
            parts.append(f"\n## {r.agent_type} [{status}]\n"
                         f"{r.output if r.success else ''}".rstrip())
        return "\n".join(parts)

    @staticmethod
    def enhanced_system_prompt(chat_mode: ChatMode) -> str:
        """getEnhancedSystemPrompt (agentScheduler.ts:425-462) — the
        '# Multi-Agent System' section."""
        comp = get_composition(chat_mode)
        primary = get_agent(comp.primary_agent)
        lines = [
            "# Multi-Agent System",
            f"You are the primary agent ({primary.name if primary else comp.primary_agent}).",
        ]
        if comp.available_subagents:
            lines.append("You can delegate focused subtasks with the "
                         "spawn_subagent tool. Available subagents:")
            for a in comp.available_subagents:
                ag = BUILTIN_AGENTS[a]
                lines.append(f"- {a}: {ag.description}")
            if comp.enable_parallel:
                lines.append(f"Up to {comp.max_parallel} subagents may run "
                             "in parallel.")
        return "\n".join(lines)

    @staticmethod
    def tool_filter_for_mode(chat_mode: ChatMode) -> Optional[List[str]]:
        """getToolFilterForMode (agentScheduler.ts:496-505): the primary
        agent's allowlist, or None for all tools."""
        comp = get_composition(chat_mode)
        primary = get_agent(comp.primary_agent)
        if primary is None or primary.permission.allowed_tools == "*":
            return None
        return [t for t in primary.permission.allowed_tools
                if t not in primary.permission.denied_tools]
