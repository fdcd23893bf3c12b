"""RolloutSession: one fully-wired agent session in a sandbox.

The composition root the reference assembles via VS Code DI
(senweaver.contribution.ts registering ~30 services): workspace sandbox,
ToolsService with the agent tools plugged in (spawn_subagent → guarded
SubagentRunner, edit_agent → fast-apply slow path, skill → SkillService),
trace collection with the jit reward head, conversation checkpoints with
before-edit snapshots, and the agent loop over a policy client.

This is the unit the RL data pipeline runs: ``session.run_turn()``
executes one user turn end-to-end and the resulting trace (with
final_reward) feeds GRPO.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

from ..agents.llm import ChatMessage, PolicyClient
from ..agents.loop import AgentLoop, AgentLoopResult
from ..agents.registry import get_composition
from ..agents.subagent import SubagentRunner
from ..editor.fast_apply import apply_described_edit
from ..prompts.system import chat_system_message
from ..rollout.checkpoints import ConversationCheckpoints
from ..services.skills import SkillService
from ..tools.sandbox import Workspace
from ..tools.service import ToolsService
from ..tools.documents import DocumentServices
from ..tools.types import APPROVAL_TYPE_OF_TOOL, ApprovalType
from ..tools.sidecars import SidecarServices
from ..traces.collector import TraceCollector
from ..traces.schema import Trace


@dataclasses.dataclass
class TurnResult:
    loop: AgentLoopResult
    trace: Optional[Trace]


class RolloutSession:
    def __init__(self, client: PolicyClient, workspace_root: str, *,
                 chat_mode: str = "agent",
                 thread_id: str = "rollout-0",
                 collector: Optional[TraceCollector] = None,
                 skills: Optional[SkillService] = None,
                 apo_rules: Optional[List[str]] = None,
                 include_tool_definitions: bool = True,
                 system_message_override: Optional[str] = None,
                 perf_monitor=None,
                 loop_sleep=None):
        self.client = client
        self.chat_mode = chat_mode
        self.thread_id = thread_id
        self.workspace = Workspace(workspace_root)
        self.tools = ToolsService(self.workspace)
        self.collector = collector or TraceCollector()
        self.skills = skills or SkillService()
        self.checkpoints = ConversationCheckpoints(self.workspace)
        self.subagents = SubagentRunner(client, self.tools)
        self.apo_rules = apo_rules or []
        self.perf_monitor = perf_monitor
        # Tiny-window policies (tests, byte-level tokenizers) can skip the
        # ~6k-char tool-grammar section; real rollouts keep it.
        self.include_tool_definitions = include_tool_definitions
        # Full replacement of the assembled system message (APO rules and
        # skills catalog included) — for controlled experiments that need
        # the prompt PREFIX pinned (e.g. eval_learning --short-prompt
        # isolating prompt length from model capacity). None = assemble.
        self.system_message_override = system_message_override
        self.history: List[ChatMessage] = []
        self._message_idx = 0
        self._wire_agent_tools()
        # loop_sleep: injectable retry-backoff sleep (AgentLoop's own
        # test seam). Hermetic eval harnesses pass a no-op so scripted
        # error-pattern episodes don't serve real exponential backoffs.
        loop_kw = {} if loop_sleep is None else {"sleep": loop_sleep}
        self.loop = AgentLoop(client, self.tools,
                              collector=self.collector,
                              thread_id=thread_id, **loop_kw)

    # -- tool wiring (the DI graph) ---------------------------------------
    def _wire_agent_tools(self) -> None:
        self.tools.register_handler("spawn_subagent", self._spawn_handler)
        self.tools.register_handler("edit_agent", self._edit_agent_handler)
        self.tools.register_handler("skill", self.skills.tool_handler)
        # In-process sidecar backends (fetch_url/api_request/read_document/
        # web_search — tools/sidecars.py). web_search degrades to an OK
        # empty result offline, so hermetic rollouts no longer book
        # spurious tool failures into reward dims 3/4.
        self.sidecars = SidecarServices(self.workspace)
        self.sidecars.install(self.tools)
        # Document family + browser/vision (tools/documents.py):
        # create/edit/convert/merge/extract, pdf ops, fetch-backed
        # open_browser; analyze_image degrades to header metadata and
        # screenshot_to_code stays gated without a vision_fn.
        self.documents = DocumentServices(self.workspace,
                                          sidecars=self.sidecars)
        self.documents.install(self.tools)
        # Snapshot files before any mutating tool touches them (the
        # before-edit capture of chatThreadService.ts:1062-1068). The edit
        # set derives from the approval map (every EDITS-class tool) plus
        # the document writers whose output lands at output_path — a
        # hand-rolled list here silently drifts as tools are added.
        edit_tools = {name for name, a in APPROVAL_TYPE_OF_TOOL.items()
                      if a is ApprovalType.EDITS}
        doc_tools = {"edit_document", "create_document", "pdf_operation",
                     "document_convert", "document_merge"}

        def snapshot_hook(tool: str, p: Dict[str, Any]) -> None:
            if tool in doc_tools:
                # mutation_targets mirrors each handler's real output-path
                # arithmetic (split's per-page files, convert's format
                # override) — p["output_path"] alone would miss them.
                for target in self.documents.mutation_targets(tool, p):
                    self.checkpoints.snapshotter.ensure_before_state(target)
            elif tool in edit_tools and p.get("uri"):
                self.checkpoints.snapshotter.ensure_before_state(p["uri"])

        self.tools.add_pre_execute_hook(snapshot_hook)

    def _spawn_handler(self, p: Dict[str, Any]) -> Dict[str, Any]:
        comp = get_composition(self.chat_mode)
        if p["agent_type"] not in comp.available_subagents:
            raise PermissionError(
                f"subagent '{p['agent_type']}' is not available in "
                f"{self.chat_mode} mode "
                f"(available: {', '.join(comp.available_subagents)})")
        res = self.subagents.spawn(p["agent_type"], p["task"],
                                   context=p.get("context", ""))
        if not res.success:
            raise RuntimeError(res.error or "subagent failed")
        return {"agent_type": res.agent_type, "report": res.output,
                "duration_s": round(res.duration_s, 2)}

    def _edit_agent_handler(self, p: Dict[str, Any]) -> Dict[str, Any]:
        """EditAgentService (editAgentService.ts:11-18): a dedicated
        edit-focused model call, modes edit/create/overwrite."""
        mode = p.get("mode", "edit")
        uri = p["uri"]
        self.checkpoints.snapshotter.ensure_before_state(uri)
        if mode in ("create", "overwrite"):
            # Full-content regeneration for both: 'overwrite' replaces the
            # whole file, so forcing the model to transcribe exact ORIGINAL
            # blocks would only add a failure mode.
            resp = self.client.chat([ChatMessage(
                "user",
                f"Write the complete contents of `{uri}` per these "
                f"instructions. Output ONLY the file body.\n\n"
                f"{p['instructions']}")], temperature=0.0)
            self.workspace.write_file(uri, resp.text)
            return {"uri": uri, "mode": mode, "applied": True}
        r = apply_described_edit(self.client, self.workspace, uri,
                                 p["instructions"])
        if not r.applied:
            raise RuntimeError(f"edit agent failed: {r.error}")
        return {"uri": uri, "mode": mode, "applied": True,
                "lines_added": r.lines_added,
                "lines_removed": r.lines_removed}

    # -- system message ----------------------------------------------------
    def system_message(self) -> str:
        import time as _time
        if self.system_message_override is not None:
            return self.system_message_override
        t0 = _time.monotonic()
        comp = get_composition(self.chat_mode)
        sysmsg = chat_system_message(
            chat_mode=self.chat_mode,
            workspace_folders=[self.workspace.display(self.workspace.root)],
            directory_str=self.workspace.dir_tree(),
            apo_rules=self.apo_rules,
            include_tool_definitions=self.include_tool_definitions)
        catalog = self.skills.catalog_for_prompt()
        if catalog:
            sysmsg += "\n\n" + catalog
        if self.perf_monitor is not None:
            # The reference's monitored stage (performanceMonitor.ts:46:
            # 2 s / 4k tokens on system-message prep); ~4 chars/token.
            self.perf_monitor.record_ms(
                "system_message_prep", (_time.monotonic() - t0) * 1000.0)
            self.perf_monitor.record_tokens("system_message_tokens",
                                            len(sysmsg) // 4)
        return sysmsg

    # -- turns -------------------------------------------------------------
    def run_turn(self, user_message: str) -> TurnResult:
        """One user turn: checkpoint → trace → agent loop → reward."""
        return self.run_conversation(user_message)

    def run_conversation(self, first_message: str, *,
                         next_message=None,
                         max_turns: int = 1) -> TurnResult:
        """Up to ``max_turns`` user turns inside ONE conversation trace.

        The reference's traces span a whole thread — its P4/P5 problem
        patterns count LLM calls and USER MESSAGES per trace ("poor
        first-attempt resolution" needs ≥4 user messages in one trace,
        apoService.ts:712-750) — so eval harnesses that model a user
        retrying must keep the trace open across the follow-ups;
        per-turn traces can never express those patterns.

        ``next_message(turn_result, turn_idx)`` supplies each follow-up
        (return None to stop early, e.g. once an evaluator passes the
        output). The trace ends once, after the last turn."""
        trace_id = self.collector.start_trace(
            self.thread_id, metadata={"chatMode": self.chat_mode})
        comp = get_composition(self.chat_mode)
        msg: Optional[str] = first_message
        result = None
        for turn in range(max(1, max_turns)):
            # Every user message gets its rewind point, follow-ups
            # included (same granularity run_turn always had).
            self.checkpoints.add_checkpoint(self._message_idx, "user_turn")
            result = self.loop.run(comp.primary_agent, msg,
                                   system_message=self.system_message(),
                                   history=self.history)
            self.history.append(ChatMessage("user", msg))
            if result.final_text:
                self.history.append(ChatMessage("assistant",
                                                result.final_text))
            self._message_idx = len(self.history)
            self.checkpoints.add_checkpoint(self._message_idx,
                                            "stream_end")
            if next_message is None or turn == max_turns - 1:
                break
            msg = next_message(TurnResult(loop=result, trace=None), turn)
            if msg is None:
                break
        self.collector.end_trace_for_thread(self.thread_id)
        trace = self.collector.get_trace(trace_id)
        return TurnResult(loop=result, trace=trace)

    def record_feedback(self, feedback: str) -> None:
        """good/bad user feedback — the highest-weight reward dim."""
        self.collector.record_user_feedback(self.thread_id,
                                            self._message_idx, feedback)

    def jump_to_turn(self, message_idx: int) -> None:
        """Rewind conversation + files (episode branching for GRPO group
        sampling)."""
        self.history = self.checkpoints.jump_to_before_message(
            message_idx, self.history)
        self._message_idx = len(self.history)

    def close(self) -> None:
        release = getattr(self.client, "release_held_slot", None)
        if release is not None:      # free a turn-continuation slot
            release()
        self.subagents.close()
        self.tools.close()
