#!/usr/bin/env python3
"""Per-commit GRPO training-health report: detectors, ring, mitigations.

Usage::

    python scripts/training_health_report.py health.jsonl
    python scripts/training_health_report.py --selftest [--out FILE]

The ROADMAP's "GRPO statistical health at scale" item asks for the
training plane's counterpart to BENCH_*.json / the SLO report — this
script emits it as one JSON document.

Two modes:

- **JSONL**: reads a per-round health ring
  (``TrainingHealthMonitor.export_jsonl``) and summarizes the signal
  ranges, trigger counts, and worst rounds it contains.
- **--selftest**: hermetic on card/CPU, no model weights. Drives the jitted
  diagnostics head (``training/diagnostics.py``) with two synthetic
  batches — a DEGENERATE one (most groups reward-tied, the rest
  epsilon-split under the std floor, all sharing one mask profile, so
  the group-by-position advantage matrix is rank-1) and a HEALTHY one
  (spread rewards, varied masks) — through the full observatory:
  monitor gauges/ring/worst-K, streak-hysteresis mitigation
  (``resilience.HealthMitigator``), and the group-size scheduler.
  Asserts the acceptance criteria: the degenerate run trips the
  rank-collapse AND zero-group detectors, the healthy run trips
  nothing, enabling the leave-one-out mitigation measurably changes
  the degenerate advantage rank spectrum, and ``analysis`` lint
  reports no new findings (the head stays host-sync clean). Raises on
  any violated invariant so CI gets a non-zero exit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from typing import Any, Dict, List

# Allow running from a source checkout without installation.
sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from senweaver_ide_tpu_torch.device import resolve_device  # noqa: E402
from senweaver_ide_tpu_torch.obs.scope import preserved_obs  # noqa: E402

GROUPS = 8
GROUP_SIZE = 4
SEQ = 24


def _batches():
    """(degenerate, healthy) synthetic batches: (rewards, gids, mask)."""
    import numpy as np
    b = GROUPS * GROUP_SIZE
    gids = np.repeat(np.arange(GROUPS), GROUP_SIZE)

    # Degenerate: 5 groups exactly tied (zero advantage), 3 groups
    # split only by an epsilon far below the min-std floor — std
    # normalization saturates them onto ONE shared pattern, so the
    # group-by-position advantage matrix is rank-1.
    rewards = np.ones(b)
    mask = np.zeros((b, SEQ), dtype=bool)
    lens = (24, 20, 16, 12)
    for g in range(GROUPS):
        for i in range(GROUP_SIZE):
            mask[g * GROUP_SIZE + i, : lens[i]] = True
    for g in (5, 6, 7):
        rewards[g * GROUP_SIZE:(g + 1) * GROUP_SIZE] = (0.0, 0.0, 0.0,
                                                        1e-6)
    degenerate = (rewards, gids, mask)

    # Healthy: spread rewards, varied completion lengths.
    rng = np.random.default_rng(0)
    rewards2 = rng.normal(size=b)
    mask2 = np.zeros((b, SEQ), dtype=bool)
    for row in range(b):
        mask2[row, : int(rng.integers(6, SEQ + 1))] = True
    return degenerate, (rewards2, gids, mask2)


def _round_health(batch, config, device) -> Dict[str, float]:
    from senweaver_ide_tpu_torch.training.diagnostics import (
        dispatch_round_health, finalize_round_health)
    rewards, gids, mask = batch
    return finalize_round_health(
        dispatch_round_health(rewards, gids, mask, config=config,
                              device=device))


@preserved_obs()
def selftest(device="cuda") -> Dict[str, Any]:
    from senweaver_ide_tpu_torch import analysis, obs
    from senweaver_ide_tpu_torch.resilience import (HealthMitigator,
                                              MITIGATION_LEAVE_ONE_OUT)
    from senweaver_ide_tpu_torch.training import GroupSizeScheduler
    from senweaver_ide_tpu_torch.training.diagnostics import DiagnosticsConfig
    from senweaver_ide_tpu_torch.training.grpo import GRPOConfig

    device = resolve_device(device)
    obs._reset_for_tests()
    monitor = obs.get_health_monitor()
    degenerate, healthy = _batches()
    grpo_config = GRPOConfig()
    base_cfg = DiagnosticsConfig.from_grpo(grpo_config)

    # -- healthy run: no detector may trip -------------------------------
    healthy_health = _round_health(healthy, base_cfg, device)
    healthy_triggers = monitor.observe(healthy_health, round_index=0)
    assert healthy_triggers == [], (
        f"healthy batch tripped detectors: {healthy_triggers}")

    # -- degenerate run: rank collapse + zero groups must trip -----------
    mitigator = HealthMitigator(
        enabled=True,
        allow={MITIGATION_LEAVE_ONE_OUT: True},
        trigger_rounds=2)
    scheduler = GroupSizeScheduler(GROUP_SIZE, max_size=16)
    rounds: List[Dict[str, Any]] = []
    effective = grpo_config
    for r in range(1, 4):
        cfg = DiagnosticsConfig.from_grpo(
            mitigator.effective(grpo_config))
        health = _round_health(degenerate, cfg, device)
        triggers = obs.evaluate_health(health, monitor.config)
        effective, events = mitigator.apply(grpo_config, triggers)
        monitor.observe(health, round_index=r, triggers=triggers,
                        events=events)
        scheduler.update(mitigator.group_size_active())
        rounds.append({"round": r, "health": health,
                       "triggers": triggers, "events": events})
    first = rounds[0]
    assert "rank_collapse" in first["triggers"], first
    assert "zero_groups" in first["triggers"], first
    assert first["health"]["rank_fraction"] <= 0.25, first
    assert first["health"]["zero_advantage_group_fraction"] > 0.5, first
    # Streak hysteresis: round 1 observes, round 2 enables.
    assert rounds[0]["events"] == []
    assert ("mitigation_enabled:leave_one_out" in rounds[1]["events"]), \
        rounds[1]
    assert effective.leave_one_out

    # -- acceptance: LOO measurably changes the rank spectrum ------------
    base = rounds[0]["health"]
    loo = _round_health(degenerate, DiagnosticsConfig.from_grpo(effective),
                        device)
    sv_change = (base["top_singular_value"]
                 / max(loo["top_singular_value"], 1e-30))
    assert sv_change > 10.0 or sv_change < 0.1, (
        f"LOO left the spectrum unchanged: {base['top_singular_value']} "
        f"-> {loo['top_singular_value']}")

    # -- observatory surfaces: gauges, ring, worst-K ---------------------
    registry = obs.get_registry()
    assert registry.get("senweaver_grpo_health_rank_fraction").value() \
        == rounds[-1]["health"]["rank_fraction"]
    trig_counter = registry.get("senweaver_grpo_health_triggers_total")
    trig_totals = {k[0]: v for k, v in trig_counter.samples().items()}
    assert trig_totals.get("rank_collapse", 0) >= 3, trig_totals
    worst = monitor.worst_rounds()
    assert worst and worst[0]["triggers"], worst
    with tempfile.TemporaryDirectory() as td:
        ring_path = monitor.export_jsonl(os.path.join(td, "ring.jsonl"))
        with open(ring_path) as f:
            ring = [json.loads(line) for line in f if line.strip()]
    assert len(ring) == 4 and ring[0]["triggers"] == []

    # -- jit purity: the head adds no new findings ------------------------
    lint = analysis.run_package()
    assert not lint.new, [f.format() for f in lint.new]

    return {
        "mode": "selftest",
        "healthy": {"health": healthy_health,
                    "triggers": healthy_triggers},
        "degenerate_rounds": rounds,
        "loo_spectrum": {
            "top_singular_value_before": base["top_singular_value"],
            "top_singular_value_after": loo["top_singular_value"],
            "advantage_std_before": base["advantage_std"],
            "advantage_std_after": loo["advantage_std"],
        },
        "mitigations": mitigator.active,
        "group_size": scheduler.current,
        "trigger_totals": trig_totals,
        "monitor": monitor.summary(),
        "lint": {"new": 0, "baselined": len(lint.baselined)},
    }


def summarize_ring(path: str) -> Dict[str, Any]:
    """Summarize an exported health ring JSONL: per-signal min/max/last,
    trigger counts, and the worst rounds by trigger count."""
    rounds: List[Dict[str, Any]] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                rounds.append(json.loads(line))
    signals: Dict[str, Dict[str, float]] = {}
    trigger_counts: Dict[str, int] = {}
    for rec in rounds:
        for key, value in (rec.get("health") or {}).items():
            s = signals.setdefault(key, {"min": value, "max": value})
            s["min"] = min(s["min"], value)
            s["max"] = max(s["max"], value)
            s["last"] = value
        for t in rec.get("triggers", ()):
            trigger_counts[t] = trigger_counts.get(t, 0) + 1
    worst = sorted(rounds, key=lambda r: len(r.get("triggers", ())),
                   reverse=True)[:5]
    return {"mode": "jsonl", "rounds": len(rounds), "signals": signals,
            "trigger_counts": trigger_counts, "worst_rounds": worst}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="GRPO training-health report / hermetic selftest.")
    parser.add_argument("path", nargs="?",
                        help="health ring JSONL from "
                             "TrainingHealthMonitor.export_jsonl()")
    parser.add_argument("--selftest", action="store_true",
                        help="run the hermetic selftest scenario")
    parser.add_argument("--cpu", action="store_true",
                        help="run the selftest on the CPU (default: "
                             "the CUDA card)")
    parser.add_argument("--out", default=None,
                        help="also write the JSON report here")
    args = parser.parse_args(argv)

    if args.selftest:
        device = "cpu" if args.cpu else "cuda"
        report = selftest(device=device)
    elif args.path:
        if not os.path.exists(args.path):
            print(f"training_health_report: no such file: {args.path}",
                  file=sys.stderr)
            return 2
        report = summarize_ring(args.path)
    else:
        parser.error("a health JSONL path or --selftest is required")
    body = json.dumps(report, indent=2, sort_keys=True, default=str)
    print(body)
    if args.out:
        with open(args.out, "w") as f:
            f.write(body + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
