#!/usr/bin/env python3
"""Where a serving step of the PyTorch port spends its time.

    python3 scripts/torch_serving_profile.py [--seed 0] [--steps 20]
    python3 scripts/torch_serving_profile.py --slots [--steps 20]

Default (paged layout): builds qwen2.5-coder-1.5b at full width (random
weights from --seed) on one CUDA card, submits the chip_smoke.py serving
mix (32 requests, prompts 128-1024 tokens, 128 new tokens,
SampleParams()), runs 60 fused steps to warm up, then records
``--steps`` steps under torch.profiler.

``--slots`` (slot layout): builds mistral-7b at full width, serves from
its 4096-position ring cache with decode_attn_impl="flash" (kernel K3),
16 slots, and submits chip_smoke.py's slot mix (24 requests); after 60
warm-up steps (every slot decoding) it records ``--steps`` decode steps
the same way.
Prints the host wall time of the window, the summed device time of all
kernels, the device idle share (1 - busy / wall; one stream, so kernel
times do not overlap), and the kernels with the most device time. The
profiler slows the host, so the window's wall time (and idle share) is
an upper bound on the unprofiled run's.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--slots", action="store_true",
                    help="profile the mistral-7b ring slot engine (K3)")
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from chip_smoke import slots_requests
    from senweaver_ide_tpu_torch.models import (init_params, mistral_7b,
                                                qwen2_5_coder_1_5b)
    from senweaver_ide_tpu_torch.ops import flash_decode as fd_mod
    from senweaver_ide_tpu_torch.ops import paged_attention as pa_mod
    from senweaver_ide_tpu_torch.rollout import RolloutEngine
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(args.seed)
    if args.slots:
        cfg = dataclasses.replace(mistral_7b(), decode_attn_impl="flash")
        traffic = slots_requests(rng, cfg.sliding_window)
        engine_kw = dict(num_slots=16, max_len=8192)
    else:
        cfg = qwen2_5_coder_1_5b()
        traffic = [(int(n), 128) for n in rng.integers(128, 1025, size=32)]
        engine_kw = dict(num_slots=16, max_len=2048)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(
        args.seed), device="cuda")
    engine = RolloutEngine(params, cfg, seed=args.seed, device="cuda",
                           **engine_kw)
    print(f"{cfg.name}, kv_layout {engine.kv_layout} (fallback: "
          f"{engine.kv_layout_fallback}), {len(traffic)} requests")
    for n, new in traffic:
        engine.submit(rng.integers(0, cfg.vocab_size, size=n).tolist(),
                      max_new_tokens=new)
    for _ in range(60):
        engine.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            engine.step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.key_averages()
              if _device_us(e) > 0 and e.device_type.name == "CUDA"]
    busy_us = sum(_device_us(e) for e in events)
    print(f"window: {args.steps} steps, wall {wall_us / 1e3:.2f} ms "
          f"({wall_us / 1e3 / args.steps:.2f} ms/step), device busy "
          f"{busy_us / 1e3:.2f} ms, idle share {1 - busy_us / wall_us:.3f}")
    events.sort(key=_device_us, reverse=True)
    for e in events[:15]:
        print(f"  {_device_us(e) / 1e3:9.3f} ms  {e.count:6d} calls  "
              f"{_device_us(e) / busy_us:6.3f}  {e.key[:90]}")
    name, tags = (("flash_decode (K3)", fd_mod.KERNEL_NAMES) if args.slots
                  else ("paged_flash_decode (K1)", pa_mod.KERNEL_NAMES))
    per_tag = {tag: sum(_device_us(e) for e in events if tag in e.key)
               for tag in tags}
    attn = sum(per_tag.values())
    gemm = sum(_device_us(e) for e in events
               if any(w in e.key.lower() for w in ("gemm", "nvjet",
                                                    "cutlass")))
    print(f"{name} kernels {attn / 1e3:.2f} ms ({attn / busy_us:.3f} of "
          f"busy; " + ", ".join(f"{tag} {us / 1e3:.2f} ms"
                                for tag, us in per_tag.items() if us)
          + f"), matmul kernels {gemm / 1e3:.2f} ms "
          f"({gemm / busy_us:.3f} of busy)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
