#!/usr/bin/env python3
"""Live-migration acceptance report: a hermetic chaos fleet proving no
request is ever truncated, drained-out, or lost.

Usage::

    python scripts/migration_report.py --selftest [--requests 8]

Companion to ``scripts/remote_fleet_report.py`` (the wire) and
``scripts/serve_report.py`` (the serving plane) — this one answers
"did every decode survive its migration?": handoffs started/completed,
aborts by fence / install / snapshot, rescues after target death, and
the exactly-once + leak-free ledger that CI gates on.

``--selftest`` builds a loopback remote fleet (card/CPU, tiny model), runs
mixed decode load while the coordinator migrates requests between
replicas, injects install-drop chaos against one handoff and a
partition against a migration target, then audits:

- every admitted ticket completes EXACTLY once (no losses, no
  duplicates, no truncation below its requested length);
- aborted handoffs finish on their source (never lost in transit);
- every replica engine's KV block allocator balances at teardown.
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


class _FakeClock:
    def __init__(self, t: float = 100.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        self.t += dt
        return self.t


@preserved_obs()
def selftest(requests: int = 8, device="cuda") -> Dict[str, Any]:
    """Chaos migration scenario; raises on any violated invariant — a
    non-zero exit for CI."""
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
    clock = _FakeClock()
    # Chaos: the first install attempt toward any target is dropped on
    # the wire (the idempotency-keyed retry must land it — or the
    # coordinator aborts and the source finishes the decode).
    plan = NetworkFaultPlan([
        NetworkFault(kind="drop", method="restore_checkpoint",
                     call_idx=0)])
    fast = RetryPolicy(max_retries=2, base_delay_s=0.0, jitter=False)

    handlers, replicas = [], []
    for i in range(3):
        h = EngineRpcHandler(RolloutEngine(
            params, config, num_slots=4, max_len=64, sample=greedy,
            device=device))
        tr = LoopbackTransport(h, target=f"replica-{i}",
                               fault_plan=plan, wire_codec=True)
        replicas.append(RemoteReplica(
            f"replica-{i}", tr, policy=fast, clock=clock,
            sleep=lambda s: None))
        handlers.append(h)
    fleet = ServingFleet(replicas, clock=clock, retry_base_delay_s=0.0,
                         probe_interval_s=0.5)
    mig = fleet.attach_migration()

    tickets = [fleet.submit([3 + i, 9, 2, 7, 1], max_new_tokens=8)
               for i in range(requests)]
    for _ in range(2):
        clock.advance(1.0)
        fleet.step()

    # Force handoffs: migrate every in-flight decode off replica-0.
    source = fleet._replica_by_id("replica-0")
    moved = mig.evacuate(source, reason="selftest", now=clock())

    # Partition one migration TARGET before its first post-handoff
    # token can ack — death triage must rescue those decodes back onto
    # their frozen source copies.
    partitioned = None
    for pend in mig.pending.values():
        partitioned = pend.target.replica_id
        break
    if partitioned is not None:
        plan.partition(partitioned)

    for _ in range(300):
        if not fleet.pending():
            break
        clock.advance(1.0)
        fleet.step()
    if fleet.pending():
        raise AssertionError(
            f"fleet failed to drain: {fleet.pending()} pending")

    outcomes = {t: fleet.outcome(t) for t in tickets}
    lost = [t for t, o in outcomes.items() if o is None]
    if lost:
        raise AssertionError(f"lost tickets: {lost}")
    not_completed = [t for t, o in outcomes.items()
                     if not isinstance(o, Completed)]
    if not_completed:
        raise AssertionError(f"tickets not completed: {not_completed}")
    truncated = [t for t, o in outcomes.items() if len(o.tokens) != 8]
    if truncated:
        raise AssertionError(f"truncated tickets: {truncated}")
    if len(fleet._outcomes) != len(fleet._requests) != len(tickets):
        raise AssertionError("outcome ledger does not match admissions")
    mixed = [t for t, o in outcomes.items()
             if o.weight_version != o.weight_version_at_finish]
    if mixed:
        raise AssertionError(f"version-mixed tickets: {mixed}")
    if mig.pending:
        raise AssertionError(
            f"handoffs never acked: {sorted(mig.pending)}")

    # Leak audit: heal the partition, release anything stranded on the
    # zombie (its janitor's job in production), then balance every
    # allocator.
    plan.heal()
    for h in handlers:
        eng = h.engine
        for rid, r in list(eng._requests.items()):
            if not r.done:
                eng.release_request(rid)
        eng._alloc.check_leaks()

    reg = obs.get_registry()
    migs = reg.get("senweaver_serve_migrations_total")
    by_outcome: Dict[str, float] = {}
    if migs is not None:
        for labels, v in migs.samples().items():
            d = dict(zip(("reason", "outcome"), labels))
            by_outcome[d.get("outcome", "?")] = \
                by_outcome.get(d.get("outcome", "?"), 0) + v
    deaths = reg.get("senweaver_serve_replica_deaths_total")
    return {
        "mode": "selftest",
        "requests": len(tickets),
        "completed": len(tickets),
        "lost": 0,
        "duplicated": 0,
        "truncated": 0,
        "migrations_moved": moved,
        "migrations_by_outcome": by_outcome,
        "partitioned_target": partitioned,
        "replica_deaths": (sum(deaths.samples().values())
                           if deaths is not None else 0),
        "chaos_injected": plan.injected_counts(),
        "leak_free": True,
    }


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--selftest", action="store_true",
                        help="run the hermetic chaos-fleet acceptance")
    parser.add_argument("--cpu", action="store_true",
                        help="run the selftest on the CPU (default: "
                             "the CUDA card)")
    parser.add_argument("--requests", type=int, default=8,
                        help="selftest load size (default 8)")
    args = parser.parse_args()
    if args.selftest:
        device = "cpu" if args.cpu else "cuda"
        print(json.dumps(selftest(args.requests, device=device), indent=2))
        return
    parser.error("--selftest is required (no snapshot mode yet)")


if __name__ == "__main__":
    main()
