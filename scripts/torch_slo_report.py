#!/usr/bin/env python3
"""Per-commit SLO report: latency percentiles, violations, exemplars.

Usage::

    python scripts/slo_report.py exemplars.jsonl
    python scripts/slo_report.py --selftest [--replicas 2] [--out FILE]

The ROADMAP's million-user item asks for a per-commit SLO artifact
(TTFT/TPOT percentiles, shed rate) next to BENCH_*.json — this script
emits it as one JSON document.

Two modes:

- **JSONL**: reads an exemplar-timeline JSONL
  (``SLOTracker.export_jsonl``) and summarizes the derived latencies,
  violations, and milestones it contains.
- **--selftest**: builds a hermetic loopback remote fleet (card/CPU, tiny
  model, tracing ON, ``NetworkFaultPlan`` lost-response chaos and a
  mid-run weight publish), drives interactive + train_rollout traffic
  to completion, and emits the full report: per-class latency
  percentiles derived from the ``senweaver_serve_*_seconds``
  histograms, the SLO tracker summary, span-stitching stats, and the
  worst exemplar timelines. Raises on any violated invariant — chaos
  retries must leave exactly one timeline per request and replayed
  RPCs must never double-execute — so CI gets a non-zero exit.
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

from senweaver_ide_tpu_torch.device import resolve_device  # noqa: E402
from senweaver_ide_tpu_torch.obs.scope import preserved_obs  # noqa: E402

SLO_KEYS = ("ttft_s", "tpot_s", "queue_wait_s", "e2e_s")
PERCENTILES = (0.5, 0.95, 0.99)


def bucket_percentile(snapshot: Dict[str, Any], q: float
                      ) -> Optional[float]:
    """Upper-bound estimate of the ``q`` percentile from a cumulative
    bucket snapshot (``Histogram.snapshot``). None when empty or when
    the rank lands past the largest finite bucket (the honest answer —
    not a number the data can't support)."""
    count = snapshot.get("count", 0)
    if not count:
        return None
    rank = q * count
    for ub, cum in sorted(snapshot.get("buckets", {}).items()):
        if cum >= rank:
            return None if ub == float("inf") else float(ub)
    return None


def histogram_percentiles(registry) -> Dict[str, Any]:
    """Per-priority percentile table from the SLO seconds histograms."""
    out: Dict[str, Any] = {}
    for key in SLO_KEYS:
        hist = registry.get(f"senweaver_serve_{key.rsplit('_', 1)[0]}"
                            "_seconds")
        if hist is None or not hasattr(hist, "snapshot"):
            continue
        per_priority: Dict[str, Any] = {}
        # Label values actually observed, from the raw cells.
        priorities = sorted({k[0] for k in hist.samples() if k})
        for p in priorities:
            snap = hist.snapshot(priority=p)
            if not snap["count"]:
                continue
            per_priority[p] = {
                "count": snap["count"],
                "mean_s": round(snap["sum"] / snap["count"], 6),
                **{f"p{int(q * 100)}_le_s": bucket_percentile(snap, q)
                   for q in PERCENTILES},
            }
        if per_priority:
            out[key] = per_priority
    return out


def summarize_jsonl(path: str) -> Dict[str, Any]:
    """Aggregate an exemplar-timeline JSONL (one timeline per line)."""
    timelines: List[Dict[str, Any]] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue            # torn tail line from a crash
            if isinstance(rec, dict):
                timelines.append(rec)
    by_class: Dict[str, Dict[str, Any]] = {}
    for tl in timelines:
        cls = by_class.setdefault(str(tl.get("priority")), {
            "timelines": 0, "violating": 0, "violations": {},
            "derived": {k: [] for k in SLO_KEYS}})
        cls["timelines"] += 1
        if tl.get("violations"):
            cls["violating"] += 1
            for v in tl["violations"]:
                cls["violations"][v] = cls["violations"].get(v, 0) + 1
        for k in SLO_KEYS:
            v = (tl.get("derived") or {}).get(k)
            if v is not None:
                cls["derived"][k].append(float(v))
    for cls in by_class.values():
        cls["derived"] = {
            k: {"count": len(vs), "max_s": round(max(vs), 6),
                "mean_s": round(sum(vs) / len(vs), 6)}
            for k, vs in cls["derived"].items() if vs}
    return {"mode": "jsonl", "path": path,
            "timelines": len(timelines), "per_class": by_class}


@preserved_obs()
def selftest(replicas: int = 2, device="cuda") -> Dict[str, Any]:
    """Hermetic fleet run; returns the SLO report (raises on violated
    invariants — a non-zero exit for CI)."""
    device = resolve_device(device)
    import torch

    from senweaver_ide_tpu_torch import obs
    from senweaver_ide_tpu_torch.models import (init_params, params_from_numpy,
                                                tiny_test)
    from senweaver_ide_tpu_torch.obs.slo import SLOConfig, SLOTarget
    from senweaver_ide_tpu_torch.resilience import (NetworkFault,
                                              NetworkFaultPlan,
                                              RetryPolicy)
    from senweaver_ide_tpu_torch.rollout import RolloutEngine
    from senweaver_ide_tpu_torch.rollout.sampler import SampleParams
    from senweaver_ide_tpu_torch.serve import (Completed, EngineRpcHandler,
                                         LoopbackTransport,
                                         RemoteReplica, ServingFleet)

    obs._reset_for_tests()
    obs.enable()                      # stitched traces need spans
    config = tiny_test()
    params = params_from_numpy(init_params(
        config, torch.Generator().manual_seed(0), device="cpu"),
        device=device)
    greedy = SampleParams(temperature=0.0, top_k=0, top_p=1.0)

    class Clock:
        t = 100.0

        def __call__(self):
            return self.t

    clock = Clock()
    plan = NetworkFaultPlan([
        # One lost submit response: executed server-side, retried
        # client-side, replayed from the idempotency cache — the
        # exactly-one-timeline invariant under its nastiest input.
        NetworkFault(kind="drop_response", method="submit", call_idx=0)])
    policy = RetryPolicy(max_retries=3, base_delay_s=0.0, jitter=False)
    handlers = [
        EngineRpcHandler(RolloutEngine(params, config, num_slots=2,
                                       max_len=64, sample=greedy,
                                       device=device))
        for _ in range(replicas)]
    # Tight interactive targets so the run PRODUCES violations (the
    # report must demonstrate the violation/exemplar path, not just
    # zeros); train_rollout keeps the default generous budget.
    slo = SLOConfig(interactive=SLOTarget(ttft_s=0.005, tpot_s=0.005,
                                          queue_wait_s=0.005, e2e_s=0.02),
                    exemplar_k=4)
    fleet = ServingFleet(
        [RemoteReplica(f"replica-{i}",
                       LoopbackTransport(h, target=f"replica-{i}",
                                         fault_plan=plan,
                                         wire_codec=True),
                       policy=policy, clock=clock,
                       sleep=lambda s: None)
         for i, h in enumerate(handlers)],
        clock=clock, retry_base_delay_s=0.0, max_retries=4,
        probe_interval_s=0.0, slo=slo)

    tickets = [fleet.submit([3 + i, 5 + i, 7 + i], max_new_tokens=4,
                            priority="interactive")
               for i in range(replicas)]
    tickets += [fleet.submit([20 + i, 30 + i], max_new_tokens=4)
                for i in range(replicas)]
    # One mid-run rolling publish, so at least one timeline overlaps a
    # publish-pause window.
    fleet.step()
    fleet.begin_publish(params)
    for _ in range(200):
        if not fleet.pending() and not fleet.publisher.in_progress:
            break
        clock.t += 0.01               # 10ms per pump → ms-scale latencies
        fleet.step()
    assert not fleet.pending(), "fleet did not drain"
    outs = {t: fleet.outcome(t) for t in tickets}
    assert all(isinstance(o, Completed) for o in outs.values()), \
        "an admitted request was lost"

    reg = obs.get_registry()

    def total(name: str, **labels) -> float:
        m = reg.get(name)
        if m is None:
            return 0.0
        if labels:
            return float(m.value(**labels))
        return sum(float(v) for v in m.samples().values())

    # -- invariants ----------------------------------------------------------
    executed = sum(h.executed.get("submit", 0) for h in handlers)
    replayed = sum(h.replays for h in handlers)
    assert replayed >= 1, "chaos never exercised the replay path"
    assert executed == len(tickets), (
        f"submit executed {executed}x for {len(tickets)} requests — "
        f"a replayed RPC double-executed")
    finished = total("senweaver_serve_timelines_total")
    assert finished == len(tickets), (
        f"{finished} finished timelines for {len(tickets)} requests — "
        f"chaos duplicated or dropped a timeline")
    assert fleet.timelines.live_count() == 0
    slo_requests = total("senweaver_serve_slo_requests_total")
    assert slo_requests == len(tickets)

    stitch = obs.stitch_summary(obs.get_tracer().spans())
    assert stitch["cross_process_traces"] >= len(tickets), \
        "dispatch traces did not stitch across the rpc boundary"
    assert stitch["replayed_server_spans"] >= 1, \
        "the replayed RPC's server span lost its replay annotation"

    exemplars = fleet.slo.exemplars()
    assert exemplars, "no exemplar timelines captured"
    assert any(e["violations"] for e in exemplars), \
        "tight targets produced no violating exemplar"

    report = {
        "mode": "selftest",
        "replicas": replicas,
        "requests": len(tickets),
        "completed": int(total("senweaver_serve_completed_total")),
        "percentiles": histogram_percentiles(reg),
        "slo": fleet.slo.summary(),
        "violations_total": int(
            total("senweaver_serve_slo_violations_total")),
        "publish_windows": int(
            total("senweaver_serve_publish_windows_total")),
        "stitch": stitch,
        "server_submit_executions": executed,
        "server_idempotent_replays": replayed,
        "chaos_injected": plan.injected_counts(),
        # Worst first; full stitched timelines (milestones + events +
        # trace_id) — the concrete requests behind the percentiles.
        "exemplars": exemplars[:3],
    }
    return report


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Per-commit SLO report (JSON): percentiles, "
                    "violations, exemplar timelines.")
    parser.add_argument("path", nargs="?",
                        help="exemplar JSONL from "
                             "SLOTracker.export_jsonl()")
    parser.add_argument("--selftest", action="store_true",
                        help="run the hermetic fleet scenario instead "
                             "of reading a file")
    parser.add_argument("--cpu", action="store_true",
                        help="run the selftest on the CPU (default: "
                             "the CUDA card)")
    parser.add_argument("--replicas", type=int, default=2,
                        help="selftest fleet size (default 2)")
    parser.add_argument("--out", help="also write the report JSON here")
    args = parser.parse_args(argv)

    if args.selftest:
        device = "cpu" if args.cpu else "cuda"
        report = selftest(args.replicas, device=device)
    elif not args.path:
        parser.error("an exemplar JSONL path or --selftest is required")
    elif not os.path.exists(args.path):
        print(f"slo_report: no such file: {args.path}", file=sys.stderr)
        return 2
    else:
        report = summarize_jsonl(args.path)
    text = json.dumps(report, indent=2)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
