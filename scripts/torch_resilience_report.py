#!/usr/bin/env python3
"""Per-round resilience summary of a training metrics JSONL.

Usage::

    python scripts/resilience_report.py metrics.jsonl [--last 50]

Companion to ``scripts/obs_report.py`` (latency) — this one answers
"what did the fault boundary absorb?": per round, how many episodes
failed, how many retries were burned, which task groups were dropped,
and whether the update guard vetoed the optimizer step. Reads the
"GRPO Round Done" / "GRPO Round Empty" events the MetricsService sink
streams live, so it works mid-run on a partially written file.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Any, Dict, List

# Allow running from a source checkout without installation.
sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from senweaver_ide_tpu_torch.services.metrics import load_jsonl_metrics  # noqa: E402

ROUND_EVENTS = ("GRPO Round Done", "GRPO Round Empty",
                "Async GRPO Round")


def summarize(path: str) -> List[Dict[str, Any]]:
    rows = []
    for e in load_jsonl_metrics(path):
        if e.get("event") not in ROUND_EVENTS:
            continue
        p = e.get("properties", e)
        rows.append({
            "round": len(rows),
            "event": "empty" if e.get("event") == "GRPO Round Empty"
                     else "done",
            "episodes": p.get("episodes", 0),
            "failed": p.get("failed_episodes", 0),
            "retries": p.get("episode_retries", 0),
            "dropped": p.get("groups_dropped", 0),
            "skipped": p.get("update_skipped") or "",
            "reward_mean": p.get("reward_mean"),
        })
    return rows


def render(rows: List[Dict[str, Any]]) -> str:
    headers = ("round", "event", "episodes", "failed", "retries",
               "dropped_groups", "update_skipped", "reward_mean")
    table = [headers] + [
        (str(r["round"]), r["event"], str(r["episodes"]),
         str(r["failed"]), str(r["retries"]), str(r["dropped"]),
         r["skipped"] or "-",
         "-" if r["reward_mean"] is None else f"{r['reward_mean']:.4f}")
        for r in rows]
    widths = [max(len(row[i]) for row in table)
              for i in range(len(headers))]
    lines = []
    for i, row in enumerate(table):
        lines.append("  ".join(cell.rjust(widths[j])
                               for j, cell in enumerate(row)))
        if i == 0:
            lines.append("  ".join("-" * w for w in widths))
    return "\n".join(lines)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Per-round fault-boundary summary of a metrics "
                    "JSONL.")
    parser.add_argument("path", help="metrics JSONL from "
                        "MetricsService(jsonl_path=...)")
    parser.add_argument("--last", type=int, default=0,
                        help="show only the last N rounds (0 = all)")
    args = parser.parse_args(argv)

    if not os.path.exists(args.path):
        print(f"resilience_report: no such file: {args.path}",
              file=sys.stderr)
        return 2
    rows = summarize(args.path)
    if not rows:
        print("resilience_report: no round events found "
              "(empty or torn file)")
        return 0
    if args.last > 0:
        rows = rows[-args.last:]
    print(render(rows))
    failed = sum(r["failed"] for r in rows)
    retries = sum(r["retries"] for r in rows)
    dropped = sum(r["dropped"] for r in rows)
    vetoed = sum(1 for r in rows if r["skipped"])
    print(f"\n{len(rows)} rounds: {failed} failed episodes, "
          f"{retries} retries, {dropped} dropped groups, "
          f"{vetoed} vetoed updates")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
