#!/usr/bin/env python3
"""Disaggregated-learner health summary: JSONL snapshots or a live
chaos selftest.

Usage::

    python scripts/learner_report.py metrics.jsonl
    python scripts/learner_report.py --selftest [--replicas 3]

Companion to ``scripts/remote_fleet_report.py`` (the wire) — this one
answers "what did the LEARNER do?": fenced publishes, stale-writer
rejections, lease epochs, crash/resume republishes, and autoscaler
actions.

Two modes:

- **JSONL**: reads the "Serving Snapshot" events a
  ``ServingFleet(metrics_service=...)`` captures and emits a JSON
  summary of the learner/publication fields (cumulative counters — the
  last snapshot is the total).
- **--selftest**: builds a hermetic loopback learner→fleet stack (card/CPU,
  tiny model) and replays the acceptance chaos: a learner killed
  mid-publish, a successor republishing its durable version at a higher
  lease epoch, and a zombie fenced fleet-wide — then asserts no version
  mixing survived. Zero infrastructure; CI runs it after the learner
  test job.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from typing import Any, Dict

# Allow running from a source checkout without installation.
sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from senweaver_ide_tpu_torch.device import resolve_device  # noqa: E402
from senweaver_ide_tpu_torch.obs.scope import preserved_obs  # noqa: E402

SNAPSHOT_EVENT = "Serving Snapshot"

LEARNER_FIELDS = ("weight_version", "publish_epoch", "stale_publishes",
                  "autoscale_actions", "learner_publishes")


def summarize_jsonl(path: str) -> Dict[str, Any]:
    from senweaver_ide_tpu_torch.services.metrics import load_jsonl_metrics

    last: Dict[str, Any] = {}
    snapshots = 0
    for e in load_jsonl_metrics(path):
        if e.get("event") != SNAPSHOT_EVENT:
            continue
        snapshots += 1
        p = e.get("properties", e)
        for f in LEARNER_FIELDS:
            if f in p:
                last[f] = p[f]
    return {"mode": "jsonl", "path": path, "snapshots": snapshots,
            **{f: last.get(f, 0) for f in LEARNER_FIELDS}}


@preserved_obs()
def selftest(replicas: int = 3, device="cuda") -> Dict[str, Any]:
    """Loopback learner chaos scenario; returns the JSON summary
    (raises on any violated invariant — a non-zero exit for CI)."""
    device = resolve_device(device)
    import torch

    from senweaver_ide_tpu_torch import obs
    from senweaver_ide_tpu_torch.models import (init_params, params_from_numpy,
                                                tiny_test)
    from senweaver_ide_tpu_torch.resilience import LeaseLost, RetryPolicy
    from senweaver_ide_tpu_torch.rollout import RolloutEngine
    from senweaver_ide_tpu_torch.rollout.sampler import SampleParams
    from senweaver_ide_tpu_torch.serve import (DEAD, FleetPublishClient,
                                         FleetRpcHandler, LearnerConfig,
                                         LearnerService,
                                         LoopbackTransport, ServingFleet,
                                         StalePublishError)
    from senweaver_ide_tpu_torch.training.trainer import (flatten_params,
                                                          unflatten_params)

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
    policy = RetryPolicy(max_retries=3, base_delay_s=0.0, jitter=False)

    class Trainer:
        class _State:
            def __init__(self, p):
                self.params = p

        def __init__(self, p):
            self.state = self._State(p)

        def run_round(self):
            self.state.params = unflatten_params(
                (k, x + 0.001) for k, x in flatten_params(self.state.params))

    fleet = ServingFleet(
        [RolloutEngine(params, config, num_slots=2, max_len=64,
                       sample=greedy, device=device)
         for _ in range(replicas)],
        clock=clock, retry_base_delay_s=0.0, probe_interval_s=0.0)
    handler = FleetRpcHandler(fleet, clock=clock)
    state_path = os.path.join(tempfile.mkdtemp(prefix="learner-report-"),
                              "learner_state.json")

    def make_learner(name):
        client = FleetPublishClient(
            LoopbackTransport(handler, target="fleet-gw"), name=name,
            policy=policy, clock=clock, sleep=lambda s: None)
        return client, LearnerService(
            Trainer(params), client, clock=clock, sleep=lambda s: None,
            config=LearnerConfig(holder="learner-0",
                                 state_path=state_path))

    # Two clean rounds, then a publish torn by a mid-roll crash.
    client_a, a = make_learner("learner-a")
    a.start()
    a.run_round()
    a.run_round()
    client_a.publish(a.trainer.state.params, epoch=a.epoch, version=3)
    fleet.step()                        # one replica swaps — mixed fleet
    versions = sorted(r.weight_version for r in fleet.replicas
                      if r.state != DEAD)
    assert len(set(versions)) > 1, "selftest wants a torn roll"

    # The successor republishes the durable v2 at a higher epoch.
    client_b, b = make_learner("learner-b")
    epoch_b = b.start()
    assert epoch_b == 2 and b.version == 2
    versions = sorted(r.weight_version for r in fleet.replicas
                      if r.state != DEAD)
    assert versions == [2] * len(versions), \
        f"version mixing survived recovery: {versions}"

    # The zombie is fenced fleet-wide.
    fenced = 0
    try:
        client_a.publish(params, epoch=1, version=99)
    except (LeaseLost, StalePublishError):
        fenced += 1
    try:
        client_b.publish(params, epoch=epoch_b, version=1)
    except StalePublishError:
        fenced += 1
    assert fenced == 2, "a stale writer reached the fleet"
    assert b.run_round() == 3           # training continues above v2

    reg = obs.get_registry()

    def total(name: str) -> float:
        m = reg.get(name)
        return 0 if m is None else sum(
            float(v) for v in m.samples().values())

    summary = {
        "mode": "selftest",
        "replicas": replicas,
        "weight_version": fleet.publisher.version,
        "publish_epoch": fleet.publisher.epoch,
        "version_skew": fleet.publisher.skew(),
        "learner_publishes": int(
            total("senweaver_learner_publishes_total")),
        "resume_republishes": int(
            total("senweaver_learner_resume_republishes_total")),
        "stale_publishes": int(
            total("senweaver_serve_stale_publish_total")),
        "lease_epoch": handler.lease_store.current_epoch,
        "lease_acquires": int(total("senweaver_lease_acquires_total")),
        "lease_lost": int(total("senweaver_lease_lost_total")),
        "server_idempotent_replays": handler.replays,
    }
    assert summary["version_skew"] == 0
    assert summary["resume_republishes"] == 1
    assert summary["stale_publishes"] >= 1
    return summary


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Disaggregated-learner health summary (JSON).")
    parser.add_argument("path", nargs="?",
                        help="metrics JSONL from "
                             "MetricsService(jsonl_path=...)")
    parser.add_argument("--selftest", action="store_true",
                        help="run the hermetic loopback learner chaos "
                             "scenario instead of reading a file")
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
        print(f"learner_report: no such file: {args.path}",
              file=sys.stderr)
        return 2
    print(json.dumps(summarize_jsonl(args.path), indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
