"""Textual-Gradient and Apply-Edit prompt builders.

Functional equivalents of ``_buildTextualGradientPrompt``
(``common/apoService.ts:918-962``) and ``_buildApplyEditPrompt`` (:966-988):
same structure (current rules → sample-run experiments with real reward/tool
stats → critique task with the 5 focus areas, ≤350 words; then a revision
prompt constrained to '- ' rule lines). In the reference, these prompts go to
a backend LLM over HTTPS; here they go to the local TPU-hosted policy (or any
callable), which is how the APO loop is in-treed (SURVEY.md §3.3 note).
"""

from __future__ import annotations

from typing import List, Sequence

from .types import RolloutResult

NO_RULES_PLACEHOLDER = "(No optimized prompt rules currently active)"
MAX_CRITIQUE_WORDS = 350
MSG_PREVIEW_CHARS = 200  # per-message preview in the experiment block (ref :929)


def format_rollout(r: RolloutResult, index: int) -> str:
    """One experiment block with real reward/tool/LLM stats (ref :926-941)."""
    status = {"succeeded": "[OK] Succeeded", "failed": "[X] Failed"}.get(
        r.status, "[?] Unknown")
    reward = f"{r.final_reward:.3f}" if r.final_reward is not None else "N/A"
    msgs = "\n    ".join(
        f"[{m.role}] {m.content[:MSG_PREVIEW_CHARS]}" for m in r.messages)
    tc = r.tool_call_stats
    if tc["total_calls"] > 0:
        rate = (f"{tc['success_rate'] * 100:.0f}%"
                if tc["success_rate"] is not None else "N/A")
        tool_info = (f"Tool Calls: {tc['total_calls']} ({tc['succeeded']} succeeded, "
                     f"{tc['failed']} failed, rate: {rate}, "
                     f"duration: {tc['total_duration_ms']:.0f}ms)")
    else:
        tool_info = "Tool Calls: none"
    dims = ", ".join(f"{d['name']}={d['value']:.2f}" for d in r.reward_dimensions)
    dims_line = f"Reward Dims: {dims}" if dims else ""
    llm_info = (f"LLM Calls: {r.llm_stats['total_calls']}, "
                f"Tokens: {r.llm_stats['total_tokens']}")
    return (f"--- Experiment {index + 1} ---\n"
            f"Status: {status}\nFinal Reward: {reward}\n"
            f"Chat Mode: {r.chat_mode}\n{tool_info}\n{llm_info}\n{dims_line}\n"
            f"Messages:\n    {msgs}")


def build_textual_gradient_prompt(current_rules: Sequence[str],
                                  rollouts: Sequence[RolloutResult]) -> str:
    """Critique prompt over a gradient batch of rollouts (ref :918-962)."""
    rules = "\n".join(current_rules) if current_rules else NO_RULES_PLACEHOLDER
    experiments = "\n\n".join(format_rollout(r, i) for i, r in enumerate(rollouts))
    return f"""You are an expert prompt engineer optimizing a coding assistant's system prompt.

## Current Prompt Rules
{rules}

## Sample Runs with Current Prompt
{experiments}

## Your Task
Write a brief critique identifying concrete causes of the failures above and
ways to raise reward on the next runs. Answer as a bullet list of specific,
testable changes (format, constraints, ordering, definitions). Cover:
1. Structural issues: missing goals, contradictions, no stop conditions
2. Instruction quality: vague verbs, lack of hierarchy, overlapping scope
3. Control and behavior: tool limits, uncertainty handling, verbosity
4. Input/output specification: missing defaults, format inconsistency
5. Scope and safety: scope creep, unsafe actions, error handling

Be concise and direct. Less than {MAX_CRITIQUE_WORDS} words."""


def build_apply_edit_prompt(current_rules: Sequence[str], critique: str) -> str:
    """Revision prompt applying a critique (ref :966-988)."""
    rules = "\n".join(current_rules) if current_rules else NO_RULES_PLACEHOLDER
    return f"""Revise the given prompt rules using the critique as constraints and improvement guide.

## Revision Rules
1. Rewrite or restructure the prompt if the critique implies it.
2. Explicitly include any requested output format, structure, or word limit.
3. Prefer mechanism-first phrasing: define what to do, then how to do it.
4. Keep the new prompt close in tone, length, and structure to the original.
5. Focus on the single most critical issue from the critique.

## Current Prompt Rules
{rules}

## Critique
{critique}

Return only the improved prompt rules. Do not include explanations or headers.
Each rule must be on its own line, starting with "- "."""


def parse_rules(text: str) -> List[str]:
    """Extract '- ' rule lines from a model response
    (ref ``_applyBeamBestPrompt`` rule split, apoService.ts:1221)."""
    return [line.strip()[2:].strip() for line in text.splitlines()
            if line.strip().startswith("- ") and line.strip()[2:].strip()]
