"""Subagent spawning with depth/parallel/timeout guards.

Reproduces `browser/subagentToolService.ts` (461 LoC):
- limits (:33-36): MAX_PARALLEL_SUBAGENTS=8, MAX_SUBAGENT_DEPTH=4,
  CONTEXT_LOW_THRESHOLD=0.25, DEFAULT_SUBAGENT_TIMEOUT=300 s
- spawn (:180-282): depth guard, parallel guard, timeout cancellation
- execution (:324-432): a single policy call with a constructed subagent
  system prompt (_buildSubagentSystemPrompt :437-458); context usage is
  estimated at ~4 chars/token against the assumed window (:361-366)

In the TPU build a spawned subagent is a nested rollout: it shares the
parent's sandbox (tools) and trace thread, and its policy call lands on the
same continuous-batching engine, so 8 parallel subagents interleave on one
chip the way the reference's 8 interleave on one event loop.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import threading
from typing import Dict, List, Optional

from ..tools.service import ToolsService
from .llm import ChatMessage, PolicyClient
from .registry import get_agent

MAX_PARALLEL_SUBAGENTS = 8        # subagentToolService.ts:33
MAX_SUBAGENT_DEPTH = 4            # :34
CONTEXT_LOW_THRESHOLD = 0.25      # :35
DEFAULT_SUBAGENT_TIMEOUT_S = 300  # :36
CHARS_PER_TOKEN_ESTIMATE = 4      # :361-366
ASSUMED_CONTEXT_TOKENS = 128_000  # :361-366


@dataclasses.dataclass
class SubagentResult:
    agent_type: str
    task: str
    success: bool
    output: str
    error: Optional[str] = None
    duration_s: float = 0.0


def build_subagent_system_prompt(agent_type: str, task: str,
                                 context: str = "") -> str:
    """_buildSubagentSystemPrompt (subagentToolService.ts:437-458)."""
    agent = get_agent(agent_type)
    base = (agent.system_prompt if agent and agent.system_prompt
            else f"You are a specialized '{agent_type}' subagent.")
    parts = [
        base,
        "",
        "You were spawned by a parent agent to complete ONE focused "
        "subtask. Work autonomously, do not ask questions, and end with a "
        "concise final report of what you found or did.",
        f"\n## Subtask\n{task}",
    ]
    if context:
        parts.append(f"\n## Context from parent\n{context}")
    return "\n".join(parts)


class SubagentRunner:
    """Tracks live subagents and enforces the reference's guards."""

    def __init__(self, client: PolicyClient, tools: ToolsService, *,
                 timeout_s: float = DEFAULT_SUBAGENT_TIMEOUT_S):
        self.client = client
        self.tools = tools
        self.timeout_s = timeout_s
        self._live = 0
        self._lock = threading.Lock()
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=MAX_PARALLEL_SUBAGENTS)

    def spawn(self, agent_type: str, task: str, *, context: str = "",
              depth: int = 0) -> SubagentResult:
        """Guarded spawn (subagentToolService.ts:180-282)."""
        if depth >= MAX_SUBAGENT_DEPTH:
            return SubagentResult(agent_type, task, False, "",
                                  error=f"max subagent depth "
                                        f"({MAX_SUBAGENT_DEPTH}) reached")
        agent = get_agent(agent_type)
        if agent is None or agent.mode != "subagent":
            return SubagentResult(agent_type, task, False, "",
                                  error=f"unknown subagent type: "
                                        f"{agent_type}")
        with self._lock:
            if self._live >= MAX_PARALLEL_SUBAGENTS:
                return SubagentResult(
                    agent_type, task, False, "",
                    error=f"max parallel subagents "
                          f"({MAX_PARALLEL_SUBAGENTS}) reached")
            self._live += 1
        fut = self._pool.submit(self._execute, agent_type, task, context)
        # _live tracks actual pool occupancy: a timed-out _execute cannot be
        # cancelled once running, so the slot is only released when the task
        # really finishes — otherwise zombies would silently eat the pool
        # while the guard reports free capacity.
        fut.add_done_callback(lambda _f: self._release())
        try:
            return fut.result(timeout=self.timeout_s)
        except concurrent.futures.TimeoutError:
            fut.cancel()   # frees the slot via callback if not yet started
            return SubagentResult(agent_type, task, False, "",
                                  error=f"subagent timed out after "
                                        f"{self.timeout_s:.0f}s")

    def _release(self) -> None:
        with self._lock:
            self._live -= 1

    def _execute(self, agent_type: str, task: str,
                 context: str) -> SubagentResult:
        """Single-shot policy call (the reference's _executeSubagent is one
        sendLLMMessage, :324-432)."""
        import time
        start = time.monotonic()
        agent = get_agent(agent_type)
        sysmsg = build_subagent_system_prompt(agent_type, task, context)
        # Context-low warning (:361-366): estimated prompt tokens vs window
        # (sysmsg already embeds the task and context).
        est_tokens = len(sysmsg) / CHARS_PER_TOKEN_ESTIMATE
        if est_tokens > ASSUMED_CONTEXT_TOKENS * (1 - CONTEXT_LOW_THRESHOLD):
            return SubagentResult(agent_type, task, False, "",
                                  error="subagent context too large")
        try:
            resp = self.client.chat(
                [ChatMessage("system", sysmsg), ChatMessage("user", task)],
                temperature=agent.temperature if agent else None)
            return SubagentResult(agent_type, task, True, resp.text,
                                  duration_s=time.monotonic() - start)
        except Exception as e:
            return SubagentResult(agent_type, task, False, "",
                                  error=f"{type(e).__name__}: {e}",
                                  duration_s=time.monotonic() - start)

    def spawn_many(self, requests: List[Dict[str, str]], *,
                   depth: int = 0,
                   max_parallel: int = MAX_PARALLEL_SUBAGENTS
                   ) -> List[SubagentResult]:
        """Chunked parallel spawn (agentScheduler.ts:203-258 chunked
        Promise.allSettled). Orchestration runs on a transient pool so the
        spawn() wrappers never compete with _execute() tasks for the shared
        worker pool (a full-width chunk would otherwise self-deadlock)."""
        results: List[SubagentResult] = []
        with concurrent.futures.ThreadPoolExecutor(
                max_workers=max(1, max_parallel)) as chunk_pool:
            for i in range(0, len(requests), max_parallel):
                chunk = requests[i:i + max_parallel]
                futs = [chunk_pool.submit(self.spawn, r["agent_type"],
                                          r["task"],
                                          context=r.get("context", ""),
                                          depth=depth)
                        for r in chunk]
                for f in futs:
                    results.append(f.result())
        return results

    def close(self) -> None:
        self._pool.shutdown(wait=False, cancel_futures=True)
