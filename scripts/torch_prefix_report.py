#!/usr/bin/env python3
"""Shared-prefix economics report: JSON summary of a metrics JSONL.

Usage::

    python scripts/prefix_report.py metrics.jsonl [--pretty]

Companion to ``scripts/serve_report.py`` (tables for humans) — this one
emits a single JSON object (for dashboards / CI checks) answering "what
did the fleet-shared prefix store buy?": prefix prefills avoided by the
one-prefill broadcast, install latency, broadcast failures and
invalidations, plus TTFT p50/p95 per priority class derived from the
cumulative histogram buckets each "Serving Snapshot" event carries.

Counters in snapshots are cumulative, so the LAST snapshot is the
totals; the report also keeps the per-snapshot avoided-prefill series so
a regression (broadcast silently degrading to lazy prefill) shows up as
a flat line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict, List, Optional

# Allow running from a source checkout without installation.
sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from senweaver_ide_tpu_torch.services.metrics import load_jsonl_metrics  # noqa: E402

SNAPSHOT_EVENT = "Serving Snapshot"


def _quantile_from_buckets(buckets: Dict[str, float], count: int,
                           q: float) -> Optional[float]:
    """Upper-bound estimate of the q-quantile from CUMULATIVE bucket
    counts (Prometheus-style): the smallest bucket boundary whose
    cumulative count covers q×count. Infinite for the tail bucket —
    reported as None (the histogram can't resolve it)."""
    if not count or not buckets:
        return None
    target = q * count
    pairs = sorted((float(le), c) for le, c in buckets.items())
    for le, cum in pairs:
        if cum >= target:
            return None if le == float("inf") else le
    return None


def summarize(path: str) -> Dict[str, Any]:
    snaps: List[Dict[str, Any]] = []
    for e in load_jsonl_metrics(path):
        if e.get("event") != SNAPSHOT_EVENT:
            continue
        snaps.append(e.get("properties", e))
    if not snaps:
        return {}
    final = snaps[-1]
    install_n = final.get("prefix_install_count") or 0
    ttft: Dict[str, Any] = {}
    for priority, snap in (final.get("ttft_by_priority") or {}).items():
        count = snap.get("count", 0)
        buckets = snap.get("buckets", {})
        ttft[priority] = {
            "count": count,
            "mean_ms": (snap.get("sum", 0.0) / count) if count else None,
            "p50_ms": _quantile_from_buckets(buckets, count, 0.50),
            "p95_ms": _quantile_from_buckets(buckets, count, 0.95),
        }
    return {
        "snapshots": len(snaps),
        "prefix_prefills_avoided": final.get(
            "prefix_prefills_avoided", 0),
        "prefix_broadcasts": final.get("prefix_broadcasts", 0),
        "prefix_broadcast_failures": final.get(
            "prefix_broadcast_failures", 0),
        "prefix_invalidations": final.get("prefix_invalidations", 0),
        "prefix_install_ms_mean": (
            final.get("prefix_install_ms_sum", 0.0) / install_n
            if install_n else None),
        "prefix_installs": install_n,
        "ttft_ms_by_priority": ttft,
        "avoided_series": [s.get("prefix_prefills_avoided", 0)
                           for s in snaps],
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Shared-prefix store JSON summary of a metrics "
                    "JSONL.")
    parser.add_argument("path", help="metrics JSONL from "
                        "MetricsService(jsonl_path=...)")
    parser.add_argument("--pretty", action="store_true",
                        help="indent the JSON output")
    args = parser.parse_args(argv)

    if not os.path.exists(args.path):
        print(f"prefix_report: no such file: {args.path}",
              file=sys.stderr)
        return 2
    report = summarize(args.path)
    if not report:
        print("prefix_report: no serving snapshots found "
              "(empty or torn file, or no fleet metrics_service wired)",
              file=sys.stderr)
        return 0
    print(json.dumps(report, indent=2 if args.pretty else None))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
