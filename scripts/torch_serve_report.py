#!/usr/bin/env python3
"""Serving-fleet summary of a training metrics JSONL.

Usage::

    python scripts/serve_report.py metrics.jsonl [--last 50]

Companion to ``scripts/resilience_report.py`` (fault boundary) and
``scripts/obs_report.py`` (latency) — this one answers "what did the
serving plane do?": per snapshot, live replicas, queue depth, completed
vs shed, retries burned, weight publishes, version skew, and the
running TTFT / e2e latency means. Reads the "Serving Snapshot" events a
``ServingFleet(metrics_service=...)`` captures (the online loop records
one after every weight publish, next to its "Weights Published" event),
so it works mid-run on a partially written file.
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

SNAPSHOT_EVENT = "Serving Snapshot"
PUBLISH_EVENT = "Weights Published"


def summarize(path: str) -> List[Dict[str, Any]]:
    rows = []
    version = None
    for e in load_jsonl_metrics(path):
        p = e.get("properties", e)
        if e.get("event") == PUBLISH_EVENT:
            version = p.get("weight_version")
            continue
        if e.get("event") != SNAPSHOT_EVENT:
            continue
        ttft_n = p.get("ttft_count") or 0
        e2e_n = p.get("e2e_count") or 0
        rows.append({
            "snap": len(rows),
            "replicas": p.get("replicas_live", 0),
            "queue": p.get("queue_depth", 0),
            "completed": p.get("completed", 0),
            "shed": p.get("shed", 0),
            "retries": p.get("retries", 0),
            "publishes": p.get("publishes", 0),
            "version": version,
            "skew": p.get("weight_version_skew", 0),
            "ttft_ms": (p.get("ttft_ms_sum", 0.0) / ttft_n
                        if ttft_n else None),
            "e2e_ms": (p.get("e2e_ms_sum", 0.0) / e2e_n
                       if e2e_n else None),
        })
    return rows


def _fmt(v: Any) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:.1f}"
    return str(v)


def render(rows: List[Dict[str, Any]]) -> str:
    headers = ("snap", "replicas", "queue", "completed", "shed",
               "retries", "publishes", "version", "skew", "ttft_ms",
               "e2e_ms")
    table = [headers] + [
        tuple(_fmt(r[h]) for h in headers) for r in rows]
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
        description="Serving-fleet snapshot summary of a metrics JSONL.")
    parser.add_argument("path", help="metrics JSONL from "
                        "MetricsService(jsonl_path=...)")
    parser.add_argument("--last", type=int, default=0,
                        help="show only the last N snapshots (0 = all)")
    args = parser.parse_args(argv)

    if not os.path.exists(args.path):
        print(f"serve_report: no such file: {args.path}",
              file=sys.stderr)
        return 2
    rows = summarize(args.path)
    if not rows:
        print("serve_report: no serving snapshots found "
              "(empty or torn file, or no fleet metrics_service wired)")
        return 0
    if args.last > 0:
        rows = rows[-args.last:]
    print(render(rows))
    # Counters in snapshots are cumulative: the last row is the totals.
    final = rows[-1]
    print(f"\n{len(rows)} snapshots: {_fmt(final['completed'])} "
          f"completed, {_fmt(final['shed'])} shed, "
          f"{_fmt(final['retries'])} retries, "
          f"{_fmt(final['publishes'])} publishes "
          f"(final skew {_fmt(final['skew'])}, "
          f"ttft {_fmt(final['ttft_ms'])} ms, "
          f"e2e {_fmt(final['e2e_ms'])} ms)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
