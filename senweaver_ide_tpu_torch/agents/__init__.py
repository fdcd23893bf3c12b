"""Multi-agent orchestration: registry, loop, subagents, scheduler.

The TPU-build analogue of the reference's agent layer
(`common/agentService.ts`, `common/agentScheduler.ts`,
`browser/subagentToolService.ts`, and the `_runChatAgent` loop in
`browser/chatThreadService.ts:1172-1763`), re-hosted over the local policy
and the hermetic tool sandbox.
"""

from .llm import (ChatMessage, ContextLengthError, LLMResponse, LLMUsage,
                  PolicyClient, RateLimitError, ToolCallRequest)
from .loop import (AgentLoop, AgentLoopResult, CHAT_RETRIES, retry_delay_s)
from .registry import (AGENT_COMPOSITIONS, BUILTIN_AGENTS, AgentComposition,
                       AgentDefinition, AgentPermission, can_agent_use_tool,
                       get_agent, get_composition, recommend_subagents,
                       should_use_subagents)
from .scheduler import AgentScheduler, AgentSession, ScheduledTask
from .subagent import (CONTEXT_LOW_THRESHOLD, DEFAULT_SUBAGENT_TIMEOUT_S,
                       MAX_PARALLEL_SUBAGENTS, MAX_SUBAGENT_DEPTH,
                       SubagentResult, SubagentRunner,
                       build_subagent_system_prompt)

__all__ = [
    "ChatMessage", "ContextLengthError", "LLMResponse", "LLMUsage",
    "PolicyClient", "RateLimitError", "ToolCallRequest", "AgentLoop",
    "AgentLoopResult", "CHAT_RETRIES", "retry_delay_s",
    "AGENT_COMPOSITIONS", "BUILTIN_AGENTS", "AgentComposition",
    "AgentDefinition", "AgentPermission", "can_agent_use_tool", "get_agent",
    "get_composition", "recommend_subagents", "should_use_subagents",
    "AgentScheduler", "AgentSession", "ScheduledTask",
    "CONTEXT_LOW_THRESHOLD", "DEFAULT_SUBAGENT_TIMEOUT_S",
    "MAX_PARALLEL_SUBAGENTS", "MAX_SUBAGENT_DEPTH", "SubagentResult",
    "SubagentRunner", "build_subagent_system_prompt",
]
