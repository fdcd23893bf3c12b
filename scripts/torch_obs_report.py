#!/usr/bin/env python3
"""Summarize a span JSONL (obs.Tracer stream/export) into a per-stage
latency table.

Usage::

    python scripts/obs_report.py spans.jsonl [--top 20] [--sort total]
    python scripts/obs_report.py spans.jsonl --health health.jsonl

Columns: count, total ms, mean, p50, p95, max — the quick answer to
"where did the round go?" without loading the Chrome trace into
Perfetto. Reads the same JSONL that ``obs.enable(span_jsonl=...)``
streams live, so it works mid-run on a partially written file.

``--health`` appends a training-health block from a per-round ring
JSONL (``TrainingHealthMonitor.export_jsonl``): signal last/min/max
and detector trigger counts — the latency table's companion question,
"and was the learning signal any good while it ran?".

``--runtime`` appends a compile/retrace ledger block from a runtime
profile JSONL (``RuntimeProfiler.export_jsonl``): per profiled
function, calls vs compiles vs distinct signatures, compile wall time,
transfer bytes, and any retrace storms — the OTHER companion question,
"and did the device spend its time executing or recompiling?".

When the file contains cross-process rpc spans (``rpc.client.*`` /
``rpc.server.*`` — see ``obs/propagation.py``), a span-stitching
section follows the table: how many server spans attached under their
client parent, traces spanning both sides of the wire, idempotent
replays, and the worst observed clock skew.

``--fleet`` appends a fleet-federation block from a fleet-obs JSONL:
lines are either incident records (``IncidentCorrelator.
export_jsonl``) or snapshot records carrying ``rollups`` (a
``FleetMetricsStore.summary()``) and/or ``alerts`` (an
``AlertManager.summary()``) — federated rollups with the worst replica
named, currently-firing alerts, and the last K incidents as triage
one-liners. The companion question across processes: "and how was the
REST of the fleet doing while it ran?".

``--contract`` needs no JSONL at all: it prints the STATIC metric
contract — the emitted inventory scanned from registry call sites
(``analysis/metric_lint.build_inventory``), the documented rows from
``docs/observability.md``, the dashboard's name reads, and the diff
between the three sides. A non-empty diff is the same drift the
``MET101``/``MET102`` gate fails in tier-1; this is the interactive
view of it. Exit code 1 when the contract does not round-trip.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, List

# Allow running from a source checkout without installation.
sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from senweaver_ide_tpu_torch.obs import load_span_jsonl, stitch_summary  # noqa: E402

SORT_KEYS = ("total", "count", "mean", "max", "name")


def percentile(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank percentile of an already-sorted list."""
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1,
              max(0, int(round(q * (len(sorted_vals) - 1)))))
    return sorted_vals[idx]


def summarize(path: str) -> List[Dict[str, float]]:
    return summarize_spans(load_span_jsonl(path))


def summarize_spans(spans) -> List[Dict[str, float]]:
    by_name: Dict[str, List[float]] = {}
    for span in spans:
        by_name.setdefault(span.name, []).append(span.duration_ms)
    rows = []
    for name, durs in by_name.items():
        durs.sort()
        total = sum(durs)
        rows.append({
            "name": name, "count": len(durs), "total": total,
            "mean": total / len(durs), "p50": percentile(durs, 0.50),
            "p95": percentile(durs, 0.95), "max": durs[-1],
        })
    return rows


def render(rows: List[Dict[str, float]]) -> str:
    headers = ("stage", "count", "total_ms", "mean_ms", "p50_ms",
               "p95_ms", "max_ms")
    table = [headers] + [
        (str(r["name"]), str(r["count"]), f"{r['total']:.1f}",
         f"{r['mean']:.2f}", f"{r['p50']:.2f}", f"{r['p95']:.2f}",
         f"{r['max']:.2f}") for r in rows]
    widths = [max(len(row[i]) for row in table)
              for i in range(len(headers))]
    lines = []
    for i, row in enumerate(table):
        lines.append("  ".join(
            cell.ljust(widths[j]) if j == 0 else cell.rjust(widths[j])
            for j, cell in enumerate(row)))
        if i == 0:
            lines.append("  ".join("-" * w for w in widths))
    return "\n".join(lines)


def render_health(summary: Dict) -> str:
    """Compact text block from a summarize_ring() result."""
    lines = [f"training health: {summary['rounds']} round(s)"]
    for key, s in sorted(summary["signals"].items()):
        lines.append(f"  {key}: last {s.get('last', 0.0):.4f} "
                     f"(min {s['min']:.4f}, max {s['max']:.4f})")
    trig = summary["trigger_counts"]
    lines.append("  triggers: " + (", ".join(
        f"{k}={v}" for k, v in sorted(trig.items())) if trig else "none"))
    return "\n".join(lines)


def summarize_runtime(path: str) -> List[Dict]:
    """Rows from a RuntimeProfiler.export_jsonl file (one profiled
    function per line; torn/blank lines skipped like the span loader)."""
    import json

    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if isinstance(rec, dict) and "fn" in rec:
                rows.append(rec)
    rows.sort(key=lambda r: r.get("compile_ms", 0.0), reverse=True)
    return rows


def render_runtime(rows: List[Dict]) -> str:
    """Compile/retrace ledger table + storm verdict line."""
    headers = ("profiled fn", "calls", "compiles", "sigs", "compile_ms",
               "last_step_ms", "h2d_kb", "d2h_kb", "storms")
    table = [headers] + [
        (str(r["fn"]), str(r.get("calls", 0)),
         str(r.get("compiles", 0)),
         str(len(r.get("signatures", []))),
         f"{r.get('compile_ms', 0.0):.1f}",
         f"{r.get('last_step_ms', 0.0):.3f}",
         f"{r.get('h2d_bytes', 0) / 1024.0:.1f}",
         f"{r.get('d2h_bytes', 0) / 1024.0:.1f}",
         str(r.get("storms", 0))) for r in rows]
    widths = [max(len(row[i]) for row in table)
              for i in range(len(headers))]
    lines = ["runtime ledger:"]
    for i, row in enumerate(table):
        lines.append("  " + "  ".join(
            cell.ljust(widths[j]) if j == 0 else cell.rjust(widths[j])
            for j, cell in enumerate(row)))
        if i == 0:
            lines.append("  " + "  ".join("-" * w for w in widths))
    storming = [r["fn"] for r in rows if r.get("storms", 0)]
    lines.append(
        "  retrace storms: " + (", ".join(storming) + " — see "
                                "docs/observability.md runbook"
                                if storming else "none"))
    return "\n".join(lines)


def load_fleet_jsonl(path: str) -> Dict:
    """Split a fleet-obs JSONL into {incidents, rollups, alerts}.

    Incident lines come from ``IncidentCorrelator.export_jsonl`` (they
    carry ``alert`` + ``candidates``); snapshot lines carry ``rollups``
    (``FleetMetricsStore.summary()``) and/or ``alerts``
    (``AlertManager.summary()``) — the LAST snapshot wins, incidents
    accumulate. Torn/blank lines are skipped like the span loader."""
    import json

    incidents: List[Dict] = []
    rollups: Dict = {}
    peers: Dict = {}
    alerts: Dict = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if not isinstance(rec, dict):
                continue
            if "candidates" in rec and "alert" in rec:
                incidents.append(rec)
                continue
            if "rollups" in rec:
                rollups = rec["rollups"] or {}
                peers = rec.get("peers") or {}
            if "alerts" in rec:
                alerts = rec["alerts"] or {}
    return {"incidents": incidents, "rollups": rollups,
            "peers": peers, "alerts": alerts}


def render_fleet(fleet: Dict, *, last_k: int = 5) -> str:
    """Federated rollups + active alerts + last K incidents."""
    lines = ["fleet federation:"]
    peers = fleet.get("peers") or {}
    if peers:
        stale = sorted(p for p, e in peers.items() if e.get("stale"))
        lines.append(f"  peers: {len(peers)}"
                     + (f" ({len(stale)} stale: {', '.join(stale)})"
                        if stale else " (none stale)"))
    rollups = fleet.get("rollups") or {}
    if rollups:
        headers = ("metric", "sum", "min", "max", "worst replica")
        table = [headers]
        for metric, entry in sorted(rollups.items()):
            worst = (f"{entry['worst_peer']}={entry['worst_value']:.3g}"
                     if entry.get("worst_peer") is not None else "-")
            table.append((metric,
                          *(f"{entry[s]:.4g}" if s in entry else "-"
                            for s in ("sum", "min", "max")), worst))
        widths = [max(len(row[i]) for row in table)
                  for i in range(len(headers))]
        for i, row in enumerate(table):
            lines.append("  " + "  ".join(
                cell.ljust(widths[j]) if j in (0, 4) else
                cell.rjust(widths[j]) for j, cell in enumerate(row)))
            if i == 0:
                lines.append("  " + "  ".join("-" * w for w in widths))
    else:
        lines.append("  no rollup snapshot in file")
    alerts = fleet.get("alerts") or {}
    firing = sorted(n for n, st in alerts.items() if st.get("firing"))
    if alerts:
        lines.append("  active alerts: " + (", ".join(
            f"{n} (value {alerts[n].get('value', 0.0):.3g})"
            for n in firing) if firing else "none"))
    incidents = fleet.get("incidents") or []
    if incidents:
        lines.append(f"  incidents: {len(incidents)} total, last "
                     f"{min(last_k, len(incidents))}:")
        for rec in incidents[-last_k:]:
            summary = rec.get("summary") or (
                f"{rec.get('alert', '?')} fired")
            lines.append(f"    #{rec.get('incident_id', '?')} {summary}")
    else:
        lines.append("  incidents: none recorded")
    return "\n".join(lines)


def render_contract(package_root: str) -> "tuple":
    """(text, clean) — the static metric-contract inventory diff."""
    from senweaver_ide_tpu_torch.analysis import metric_lint

    sites, consumers, rows = metric_lint.build_inventory(package_root)
    findings = metric_lint.cross_check(sites, rows, consumers)

    def _star(name, wild):
        return name + ("*" if wild else "")

    emitted = sorted({(_star(s.name, s.wildcard), s.mtype)
                      for s in sites if s.name is not None})
    lines = ["metric contract:",
             f"  emitted: {len(emitted)} distinct name(s) from "
             f"{len(sites)} call site(s)"]
    for name, mtype in emitted:
        lines.append(f"    {mtype:<9} {name}")
    lines.append(f"  documented rows: "
                 f"{len({(r.name, r.wildcard) for r in rows})}   "
                 f"dashboard reads: "
                 f"{len({(c.name, c.wildcard) for c in consumers})}")
    drift = [f for f in findings if f.rule in ("MET101", "MET102")]
    conflicts = [f for f in findings if f.rule == "MET103"]
    if not drift and not conflicts:
        lines.append("  round-trip: EXACT — code, docs, and dashboard "
                     "agree")
    else:
        lines.append(f"  round-trip: DRIFTED — {len(drift)} mismatch(es)"
                     f", {len(conflicts)} conflict(s)")
        for f in drift + conflicts:
            lines.append(f"    {f.rule} {f.path}:{f.line}  {f.message}")
    return "\n".join(lines), not drift and not conflicts


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Per-stage latency summary of an obs span JSONL.")
    parser.add_argument("path", nargs="?", default=None,
                        help="span JSONL from obs.enable("
                        "span_jsonl=...) or Tracer.export_jsonl(); "
                        "optional when only companion sections "
                        "(--health/--runtime/--fleet) are requested")
    parser.add_argument("--top", type=int, default=0,
                        help="show only the first N stages (0 = all)")
    parser.add_argument("--sort", choices=SORT_KEYS, default="total",
                        help="sort column (default: total)")
    parser.add_argument("--health", default=None,
                        help="training-health ring JSONL "
                             "(TrainingHealthMonitor.export_jsonl) to "
                             "summarize after the latency table")
    parser.add_argument("--runtime", default=None,
                        help="runtime profile JSONL "
                             "(RuntimeProfiler.export_jsonl) to "
                             "summarize after the latency table")
    parser.add_argument("--fleet", default=None,
                        help="fleet-obs JSONL (incident records from "
                             "IncidentCorrelator.export_jsonl and/or "
                             "store/alert summary snapshots) to "
                             "summarize after the latency table")
    parser.add_argument("--incidents", type=int, default=5,
                        help="incidents to show in the --fleet block "
                             "(default: 5)")
    parser.add_argument("--contract", action="store_true",
                        help="print the static metric-contract "
                             "inventory (emissions vs docs vs "
                             "dashboard) — no JSONL needed; exit 1 on "
                             "drift")
    args = parser.parse_args(argv)

    if args.path is None and not (args.health or args.runtime
                                  or args.fleet or args.contract):
        print("obs_report: need a span JSONL path or at least one of "
              "--health/--runtime/--fleet/--contract", file=sys.stderr)
        return 2
    contract_clean = True
    if args.contract:
        pkg = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "senweaver_ide_tpu_torch")
        text, contract_clean = render_contract(pkg)
        print(text)
    spans = []
    if args.path is not None:
        if not os.path.exists(args.path):
            print(f"obs_report: no such file: {args.path}",
                  file=sys.stderr)
            return 2
        spans = load_span_jsonl(args.path)
    rows = summarize_spans(spans)
    if not rows:
        # Keep going: the --health/--runtime/--fleet companion
        # sections are still meaningful without a span file.
        if args.path is not None:
            print("obs_report: no spans found (empty or torn file)")
    else:
        reverse = args.sort != "name"
        rows.sort(key=lambda r: r[args.sort], reverse=reverse)
        if args.top > 0:
            rows = rows[: args.top]
        print(render(rows))
        total_ms = sum(r["total"] for r in rows)
        total_spans = sum(r["count"] for r in rows)
        print(f"\n{total_spans} spans, {total_ms:.1f} ms total "
              f"(sorted by {args.sort})")
    stitch = stitch_summary(spans)
    if stitch["client_spans"] or stitch["server_spans"]:
        print(
            f"\nstitching: {stitch['stitched_server_spans']}/"
            f"{stitch['server_spans']} server spans under a client "
            f"parent, {stitch['cross_process_traces']}/"
            f"{stitch['traces']} traces cross the rpc boundary, "
            f"{stitch['replayed_server_spans']} idempotent replays, "
            f"max clock skew {stitch['clock_skew_s_max'] * 1000:.3f} ms")
    if args.health:
        if not os.path.exists(args.health):
            print(f"obs_report: no such file: {args.health}",
                  file=sys.stderr)
            return 2
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        from torch_training_health_report import summarize_ring
        print("\n" + render_health(summarize_ring(args.health)))
    if args.runtime:
        if not os.path.exists(args.runtime):
            print(f"obs_report: no such file: {args.runtime}",
                  file=sys.stderr)
            return 2
        print("\n" + render_runtime(summarize_runtime(args.runtime)))
    if args.fleet:
        if not os.path.exists(args.fleet):
            print(f"obs_report: no such file: {args.fleet}",
                  file=sys.stderr)
            return 2
        print("\n" + render_fleet(load_fleet_jsonl(args.fleet),
                                  last_k=args.incidents))
    return 0 if contract_clean else 1


if __name__ == "__main__":
    raise SystemExit(main())
