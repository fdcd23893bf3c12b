#!/usr/bin/env python3
"""Cross-host fleet health summary: JSONL snapshots or a live selftest.

Usage::

    python scripts/remote_fleet_report.py metrics.jsonl
    python scripts/remote_fleet_report.py --selftest [--replicas 3]

Companion to ``scripts/serve_report.py`` (the general serving plane) —
this one answers "what did the WIRE do?": remote RPC volume, transient
retries burned, calls that exhausted their budget, circuit-breaker
opens, publish quarantines, and held-slot continuation replays.

Two modes:

- **JSONL**: reads the "Serving Snapshot" events a
  ``ServingFleet(metrics_service=...)`` captures and emits a JSON
  summary of the remote-fleet fields (cumulative counters — the last
  snapshot is the total).
- **--selftest**: builds a hermetic loopback remote fleet (card/CPU, tiny
  model, ``NetworkFaultPlan`` chaos: one lost response, one mid-decode
  partition), drives it to completion, and emits the same JSON summary
  plus the chaos ledger — a zero-infrastructure smoke test that the
  retry/idempotency/failover machinery holds (CI runs it after the
  remote-fleet test job).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict

# Allow running from a source checkout without installation.
sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from senweaver_ide_tpu_torch.device import resolve_device  # noqa: E402
from senweaver_ide_tpu_torch.obs.scope import preserved_obs  # noqa: E402

SNAPSHOT_EVENT = "Serving Snapshot"

REMOTE_FIELDS = ("remote_rpcs", "remote_rpc_retries",
                 "remote_rpc_errors", "breaker_opens",
                 "continuation_replays", "publish_quarantined")


def summarize_jsonl(path: str) -> Dict[str, Any]:
    from senweaver_ide_tpu_torch.services.metrics import load_jsonl_metrics

    last: Dict[str, Any] = {}
    snapshots = 0
    for e in load_jsonl_metrics(path):
        if e.get("event") != SNAPSHOT_EVENT:
            continue
        snapshots += 1
        p = e.get("properties", e)
        for f in REMOTE_FIELDS:
            if f in p:
                last[f] = p[f]
    return {"mode": "jsonl", "path": path, "snapshots": snapshots,
            **{f: last.get(f, 0) for f in REMOTE_FIELDS}}


@preserved_obs()
def selftest(replicas: int = 3, device="cuda") -> Dict[str, Any]:
    """Loopback chaos scenario; returns the JSON summary (raises on any
    violated invariant — a non-zero exit for CI)."""
    device = resolve_device(device)
    import torch

    from senweaver_ide_tpu_torch import obs
    from senweaver_ide_tpu_torch.models import (init_params, params_from_numpy,
                                                tiny_test)
    from senweaver_ide_tpu_torch.resilience import (NetworkFault,
                                              NetworkFaultPlan,
                                              RetryPolicy)
    from senweaver_ide_tpu_torch.rollout import RolloutEngine
    from senweaver_ide_tpu_torch.rollout.sampler import SampleParams
    from senweaver_ide_tpu_torch.serve import (Completed, DEAD,
                                         EngineRpcHandler,
                                         LoopbackTransport,
                                         RemoteReplica, ServingFleet)

    obs._reset_for_tests()
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
        # client-side, replayed from the idempotency cache.
        NetworkFault(kind="drop_response", method="submit", call_idx=0)])
    policy = RetryPolicy(max_retries=3, base_delay_s=0.0, jitter=False)
    handlers = [
        EngineRpcHandler(RolloutEngine(params, config, num_slots=2,
                                       max_len=64, sample=greedy,
                                       device=device))
        for _ in range(replicas)]
    fleet = ServingFleet(
        [RemoteReplica(f"replica-{i}",
                       LoopbackTransport(h, target=f"replica-{i}",
                                         fault_plan=plan),
                       policy=policy, clock=clock,
                       sleep=lambda s: None)
         for i, h in enumerate(handlers)],
        clock=clock, retry_base_delay_s=0.0, max_retries=6,
        probe_interval_s=1.0)

    held = fleet.submit([5, 9, 2, 7], max_new_tokens=4, hold_slot=True)
    load = [fleet.submit([11 + i, 22 + i, 33 + i], max_new_tokens=4)
            for i in range(2 * replicas - 1)]
    fleet.step()
    holder = fleet._requests[held].replica_id
    plan.partition(holder)              # the holder goes silent
    for _ in range(120):
        if not fleet.pending():
            break
        clock.t += 1.0                  # next probe window
        fleet.step()
    assert not fleet.pending(), "fleet did not drain under chaos"
    outs = {t: fleet.outcome(t) for t in [held] + load}
    assert all(isinstance(o, Completed) for o in outs.values()), \
        "an admitted request was lost"

    # Held-slot continuation replays on a survivor: the death retry
    # re-held the slot on a live replica, so kill THAT holder too
    # (operator hook) before continuing the conversation.
    holder2 = fleet._requests[held].replica_id
    if fleet._replica_by_id(holder2).state != DEAD:
        fleet.kill_replica(holder2)
    full2 = [5, 9, 2, 7] + list(outs[held].tokens) + [6, 1]
    t2 = fleet.submit(full2, max_new_tokens=4, continue_from=held)
    for _ in range(60):
        if not fleet.pending():
            break
        clock.t += 1.0
        fleet.step()
    assert isinstance(fleet.outcome(t2), Completed)

    reg = obs.get_registry()

    def total(name: str) -> float:
        m = reg.get(name)
        return 0 if m is None else sum(
            float(v) for v in m.samples().values())

    executed = sum(h.executed.get("submit", 0) for h in handlers)
    replayed = sum(h.replays for h in handlers)
    summary = {
        "mode": "selftest",
        "replicas": replicas,
        "requests": len(outs) + 1,
        "completed": int(total("senweaver_serve_completed_total")),
        "replica_deaths": int(
            total("senweaver_serve_replica_deaths_total")),
        "remote_rpcs": int(total("senweaver_serve_remote_rpcs_total")),
        "remote_rpc_retries": int(
            total("senweaver_serve_remote_rpc_retries_total")),
        "remote_rpc_errors": int(
            total("senweaver_serve_remote_rpc_errors_total")),
        "breaker_opens": int(
            total("senweaver_serve_remote_breaker_opens_total")),
        "continuation_replays": int(
            total("senweaver_serve_continuation_replays_total")),
        "publish_quarantined": int(
            total("senweaver_serve_publish_quarantined_total")),
        "server_submit_executions": executed,
        "server_idempotent_replays": replayed,
        "chaos_injected": plan.injected_counts(),
        "dead_replicas": [r.replica_id for r in fleet.replicas
                          if r.state == DEAD],
    }
    assert summary["continuation_replays"] >= 1
    assert summary["server_idempotent_replays"] >= 1
    assert summary["completed"] == summary["requests"]
    return summary


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Remote-fleet wire-health summary (JSON).")
    parser.add_argument("path", nargs="?",
                        help="metrics JSONL from "
                             "MetricsService(jsonl_path=...)")
    parser.add_argument("--selftest", action="store_true",
                        help="run the hermetic loopback chaos scenario "
                             "instead of reading a file")
    parser.add_argument("--cpu", action="store_true",
                        help="run the selftest on the CPU (default: "
                             "the CUDA card)")
    parser.add_argument("--replicas", type=int, default=3,
                        help="selftest fleet size (default 3)")
    args = parser.parse_args(argv)

    if args.selftest:
        device = "cpu" if args.cpu else "cuda"
        print(json.dumps(selftest(args.replicas, device=device), indent=2))
        return 0
    if not args.path:
        parser.error("a metrics JSONL path or --selftest is required")
    if not os.path.exists(args.path):
        print(f"remote_fleet_report: no such file: {args.path}",
              file=sys.stderr)
        return 2
    print(json.dumps(summarize_jsonl(args.path), indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
