#!/usr/bin/env python3
"""Quantized-KV-ladder report: JSONL summary or a hermetic selftest of
the int8 serving rung (quantized-KV acceptance).

Usage::

    python scripts/kv_quant_report.py metrics.jsonl
    python scripts/kv_quant_report.py --selftest

Companion to ``scripts/kv_pressure_report.py`` (what did pressure do?)
— this one answers "what did PRECISION buy?": bytes per block down the
ladder, the capacity payoff at the same device byte budget, and proof
that quantization stays inside its declared divergence budget while
every movement path (swap, export, migrate) preserves the flavor.

Two modes:

- **JSONL**: scans a metrics JSONL for KV byte-ledger fields and emits
  the last observed values.
- **--selftest**: hermetic card/CPU proof of the ladder, zero
  infrastructure (CI runs it after the kv-quant test job):

  1. *Capacity*: at one device byte budget the int8 pool holds ≥ 2x
     the blocks of the bf16 pool (scales included — the ratio is
     honest about the f32 scale overhead).
  2. *Parity budget*: greedy streams from the int8 rung track the
     full-width golden stream within the declared token-match budget,
     leak-free on both sides.
  3. *Flavor preservation*: a swapped-out prefix stays quantized in
     host RAM and exports quantized; a migration checkpoint carries
     the ladder stamp + scale tensors; restoring it onto a different
     ladder takes the recompute path (zero install copies — foreign
     bytes are NEVER spliced).
  4. *Pressure payoff*: the 2x-over-capacity shared-prefix workload
     records strictly fewer evictions + preemptions on int8 than on
     bf16 at the same byte budget.
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

KV_FIELDS = ("kv_dtype", "kv_bytes_per_block", "kv_bytes_device",
             "kv_bytes_host", "prefix_evictions", "kv_preemptions")

MATCH_BUDGET = 0.6   # declared greedy divergence budget (tiny model)


def summarize_jsonl(path: str) -> Dict[str, Any]:
    from senweaver_ide_tpu_torch.services.metrics import load_jsonl_metrics

    last: Dict[str, Any] = {}
    events = 0
    for e in load_jsonl_metrics(path):
        p = e.get("properties", e)
        hit = False
        for f in KV_FIELDS:
            if f in p:
                last[f] = p[f]
                hit = True
        events += hit
    return {"mode": "jsonl", "path": path, "events_with_kv": events,
            **{f: last.get(f) for f in KV_FIELDS}}


@preserved_obs()
def selftest(device="cuda") -> Dict[str, Any]:
    """Hermetic proof of the quantized KV ladder; raises on any
    violated invariant (non-zero exit for CI)."""
    device = resolve_device(device)
    import torch

    from senweaver_ide_tpu_torch import obs
    from senweaver_ide_tpu_torch.models import (init_params, params_from_numpy,
                                                tiny_test)
    from senweaver_ide_tpu_torch.rollout import (EngineConfig, RolloutEngine,
                                           migration)
    from senweaver_ide_tpu_torch.rollout.paged_kv import (init_paged_pool,
                                                    pool_bytes_per_block)
    from senweaver_ide_tpu_torch.rollout.sampler import SampleParams

    greedy = SampleParams(temperature=0.0, top_k=0, top_p=1.0)
    config = tiny_test()
    params = params_from_numpy(init_params(
        config, torch.Generator().manual_seed(0), device="cpu"),
        device=device)
    hot = [(j * 11) % 200 + 2 for j in range(16)]   # 4 blocks @ bs 4
    prompts = [hot + [i + 1, 3] for i in range(6)]

    def engine(kv_dtype="bf16", num_blocks=None, **cfg_kw):
        cfg = EngineConfig(kv_layout="paged", block_size=4,
                           kv_dtype=kv_dtype,
                           **({"num_blocks": num_blocks}
                              if num_blocks else {}), **cfg_kw)
        return RolloutEngine(params, config, num_slots=2,
                             max_len=64, sample=greedy, device=device,
                             engine_config=cfg)

    # -- 1. capacity: blocks per byte budget down the ladder --------------
    obs._reset_for_tests()
    bpb_full = pool_bytes_per_block(
        init_paged_pool(config, 8, 4, device=device))
    bpb_q8 = pool_bytes_per_block(
        init_paged_pool(config, 8, 4, kv_dtype="int8", device=device))
    budget = bpb_full * 10
    blocks_full, blocks_q8 = budget // bpb_full, budget // bpb_q8
    assert blocks_q8 >= 2 * blocks_full, \
        f"int8 holds {blocks_q8} blocks vs bf16 {blocks_full} in the " \
        f"same {budget} bytes — expected >= 2x"

    capacity = {
        "bytes_budget": int(budget),
        "bytes_per_block_bf16": int(bpb_full),
        "bytes_per_block_int8": int(bpb_q8),
        "blocks_bf16": int(blocks_full),
        "blocks_int8": int(blocks_q8),
        "capacity_ratio": round(blocks_q8 / blocks_full, 2),
    }

    # -- 2. parity budget: greedy streams across the rungs ----------------
    def streams(kv_dtype):
        obs._reset_for_tests()
        eng = engine(kv_dtype)
        rids = [eng.submit(p, max_new_tokens=8) for p in prompts]
        out = eng.run()
        eng._alloc.check_leaks()
        return [out[r] for r in rids]

    golden = streams("bf16")
    quant = streams("int8")
    total = sum(len(s) for s in golden)
    match = sum(int(a == b) for s1, s2 in zip(golden, quant)
                for a, b in zip(s1, s2))
    rate = match / max(1, total)
    assert rate >= MATCH_BUDGET, \
        f"int8 token-match rate {rate:.3f} below budget {MATCH_BUDGET}"

    parity = {"tokens": total, "matched": match,
              "match_rate": round(rate, 3),
              "declared_budget": MATCH_BUDGET}

    # -- 3. flavor preservation: swap, export, migrate ---------------------
    obs._reset_for_tests()
    eng = engine("int8")
    pid = eng.register_prefix(hot)
    r0 = eng.submit(hot + [1, 3], max_new_tokens=8, prefix_id=pid)
    ref = eng.run()[r0]
    eng._swap_out_prefix(pid)
    hp = eng._prefix_host[pid]
    assert (hp.quantized and hp.k.dtype == torch.int8
            and hp.k.device.type == "cpu"), \
        "host-tier payload was dequantized on the way out"
    toks, kv, _ = eng.export_prefix(pid)
    assert kv.quantized and kv.k.device.type == "cpu", \
        "host export of a quantized prefix must ship int8 + scales"
    r1 = eng.submit(hot + [1, 3], max_new_tokens=8, prefix_id=pid)
    assert eng.run()[r1] == ref, "post-restore decode diverged in-rung"
    eng.release_prefix(pid)
    eng._alloc.check_leaks()

    src = engine("int8")
    rid = src.submit(hot + [1, 3], max_new_tokens=8)
    for _ in range(3):
        src.step()
    ckpt = src.checkpoint_request(rid)
    assert ckpt.kv_dtype == "int8" and ckpt.kv_k_scale is not None, \
        "checkpoint lost the ladder stamp or its scales"
    ckpt = migration.DecodeCheckpoint.from_wire(ckpt.to_wire())
    src.release_request(rid)
    cross = engine("bf16")
    new_rid = cross.restore_request(ckpt)
    out = cross.run()[new_rid]
    assert len(out) == 8, "cross-ladder restore lost the decode"
    assert cross.stats()["kv_install_copies"] == 0, \
        "cross-ladder restore SPLICED foreign quantized bytes"
    cross._alloc.check_leaks()

    movement = {
        "host_tier_quantized": True,
        "export_quantized": True,
        "restore_token_exact": True,
        "checkpoint_kv_dtype": "int8",
        "cross_ladder_install_copies":
            cross.stats()["kv_install_copies"],
        "cross_ladder_recomputed": True,
    }

    # -- 4. pressure payoff at the same byte budget ------------------------
    def pressured(kv_dtype, num_blocks):
        obs._reset_for_tests()
        eng = engine(kv_dtype, num_blocks=num_blocks, host_tier=False)
        pid = eng.register_prefix(hot)
        rids = [eng.submit(p, max_new_tokens=12, prefix_id=pid)
                for p in prompts]
        out = eng.run()
        st = eng.stats()
        if pid in eng._prefixes:
            eng.release_prefix(pid)
        eng._alloc.check_leaks()
        # every ticket reaches an outcome; the storm cap may
        # truncate-finish (possibly to zero tokens) under sustained
        # pressure, but no ticket may be LOST
        assert all(r in out for r in rids)
        full = sum(len(out[r]) == 12 for r in rids)
        return (st.get("prefix_evictions", 0)
                + st.get("kv_preemptions", 0)), full

    press_full, done_full = pressured("bf16", int(blocks_full))
    press_q8, done_q8 = pressured("int8", int(blocks_q8))
    assert press_full >= 1, "the bf16 rung never hit pressure — the " \
        "workload is not over capacity"
    assert press_q8 < press_full, \
        f"int8 pressure events {press_q8} not strictly below bf16 " \
        f"{press_full} at the same byte budget"
    assert done_q8 >= done_full, \
        "the roomier int8 pool finished FEWER requests in full"

    payoff = {"pressure_events_bf16": int(press_full),
              "pressure_events_int8": int(press_q8),
              "completed_full_bf16": int(done_full),
              "completed_full_int8": int(done_q8)}

    return {
        "mode": "selftest",
        "capacity": capacity,
        "parity": parity,
        "movement": movement,
        "pressure_payoff": payoff,
        "ok": True,
    }


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("path", nargs="?", help="metrics JSONL to scan")
    parser.add_argument("--selftest", action="store_true",
                        help="run the hermetic kv-quant selftest")
    parser.add_argument("--cpu", action="store_true",
                        help="run the selftest on the CPU (default: "
                             "the CUDA card)")
    args = parser.parse_args()
    if args.selftest:
        device = "cpu" if args.cpu else "cuda"
        print(json.dumps(selftest(device=device), indent=2))
        return
    if not args.path:
        parser.error("need a metrics JSONL path (or --selftest)")
    print(json.dumps(summarize_jsonl(args.path), indent=2))


if __name__ == "__main__":
    main()
