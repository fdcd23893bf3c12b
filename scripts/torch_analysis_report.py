#!/usr/bin/env python3
"""Static-analysis summary of the package's linter findings.

Usage::

    python scripts/analysis_report.py [--root senweaver_ide_tpu_torch]
        [--baseline senweaver_ide_tpu_torch/analysis/baseline.json] [--json]

Companion to ``scripts/serve_report.py`` and friends — this one answers
"what does the linter see?": every current finding from the JIT purity,
lock-discipline, rpc-idempotency, metric-contract, and
resource-lifetime passes, rolled up per rule and per module, plus the
delta against the checked-in baseline (new findings that would fail the
gate, entries the baseline still carries, and stale entries whose code
has since been fixed). Clean rule families are listed too, so the
report names what was checked, not just what failed. ``--json`` emits
the same summary as a machine-readable object for CI artifacts.

Exit codes follow the gate: 0 when the package is clean modulo the
baseline, 1 when there are new or stale findings, 2 on bad inputs.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
from typing import Any, Dict

# Allow running from a source checkout without installation.
sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from senweaver_ide_tpu_torch import analysis  # noqa: E402
from senweaver_ide_tpu_torch.analysis.findings import (  # noqa: E402
    BaselineError, apply_baseline, load_baseline)


def summarize(root: str, baseline_path: str) -> Dict[str, Any]:
    found = analysis.collect_findings(root)
    baseline = load_baseline(baseline_path)
    result = apply_baseline(found, baseline)

    by_rule: Dict[str, int] = collections.Counter()
    by_module: Dict[str, int] = collections.Counter()
    for f in found:
        by_rule[f.rule] += 1
        # Module = top-level subpackage under the lint root; keeps the
        # breakdown readable (rollout/, serve/, ...) instead of
        # one row per file.
        rel = os.path.relpath(f.path, os.path.dirname(root))
        parts = rel.split(os.sep)
        by_module[parts[1] if len(parts) > 2 else parts[-1]] += 1

    # Family rollup over ALL registered rules (JIT/LOCK/RPC/MET/RES),
    # so a clean family still shows up as checked-and-zero.
    by_family: Dict[str, int] = {}
    for rid in analysis.RULES:
        family = rid.rstrip("0123456789")
        by_family.setdefault(family, 0)
    for rid, n in by_rule.items():
        by_family[rid.rstrip("0123456789")] = (
            by_family.get(rid.rstrip("0123456789"), 0) + n)

    return {
        "root": root,
        "baseline": baseline_path,
        "total_findings": len(found),
        "by_family": dict(sorted(by_family.items())),
        "by_rule": dict(sorted(by_rule.items())),
        "by_module": dict(sorted(by_module.items())),
        "rules": {rid: analysis.RULES[rid]
                  for rid in sorted(by_rule) if rid in analysis.RULES},
        "baseline_delta": {
            "new": [f.to_dict() for f in result.new],
            "baselined": [f.to_dict() for f in result.baselined],
            "stale": [dict(e) for e in result.stale],
        },
        "gate_passes": not result.new and not result.stale,
    }


def render(summary: Dict[str, Any]) -> str:
    lines = [f"analysis report for {summary['root']}",
             f"  findings: {summary['total_findings']}  "
             f"(gate {'PASS' if summary['gate_passes'] else 'FAIL'})",
             "", "  by family:"]
    for fam, n in summary["by_family"].items():
        lines.append(f"    {fam:<6} {n:>3}")
    lines.append("")
    lines.append("  by rule:")
    for rid, n in summary["by_rule"].items():
        desc = summary["rules"].get(rid, "")
        lines.append(f"    {rid}  {n:>3}  {desc}")
    lines.append("")
    lines.append("  by module:")
    for mod, n in summary["by_module"].items():
        lines.append(f"    {mod:<16} {n:>3}")
    delta = summary["baseline_delta"]
    lines.append("")
    lines.append(f"  baseline: {len(delta['baselined'])} carried, "
                 f"{len(delta['new'])} new, "
                 f"{len(delta['stale'])} stale")
    for f in delta["new"]:
        lines.append(f"    NEW   {f['rule']} {f['path']}:{f['line']} "
                     f"({f['symbol']})")
    for e in delta["stale"]:
        lines.append(f"    STALE {e['rule']} {e['path']} "
                     f"({e['symbol']}) — fixed? prune the entry")
    return "\n".join(lines)


def main(argv=None) -> int:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    parser = argparse.ArgumentParser(
        description="Summary of static-analysis findings vs baseline.")
    parser.add_argument("--root",
                        default=os.path.join(here, "senweaver_ide_tpu_torch"),
                        help="package root to lint")
    parser.add_argument("--baseline", default=None,
                        help="baseline JSON (default: the checked-in "
                        "analysis/baseline.json)")
    parser.add_argument("--json", action="store_true",
                        help="emit machine-readable JSON")
    args = parser.parse_args(argv)

    baseline = args.baseline or os.path.join(
        args.root, "analysis", "baseline.json")
    if not os.path.isdir(args.root):
        print(f"analysis_report: no such package root: {args.root}",
              file=sys.stderr)
        return 2
    try:
        summary = summarize(args.root, baseline)
    except BaselineError as e:
        print(f"analysis_report: bad baseline: {e}", file=sys.stderr)
        return 2

    if args.json:
        print(json.dumps(summary, indent=2, sort_keys=True))
    else:
        print(render(summary))
    return 0 if summary["gate_passes"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
