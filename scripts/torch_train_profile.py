#!/usr/bin/env python3
"""Where a GRPO train step of the PyTorch port spends its time.

    python3 scripts/torch_train_profile.py [--seed 0] [--steps 1]

Builds qwen2.5-coder-1.5b at full width (random weights from --seed) on
one CUDA card and the batch shape of chip_smoke.py's training phase: 16
trajectories of 1024 tokens (random prompts of 256-768 tokens followed by
128 completion tokens, 4 groups of 4, random rewards), attn_impl="flash",
remat, accum_steps 4. Runs one train_step to warm up, then records
``--steps`` steps under torch.profiler. Prints the host wall time of the
window, the summed device time of all kernels, the device idle share
(1 - busy / wall; one stream, so kernel times do not overlap), the
kernels with the most device time, and the shares of the flash-attention
kernels (K2), the matmuls and the rest. The profiler slows the host, so
the window's wall time (and idle share) is an upper bound on the
unprofiled run's.
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
    ap.add_argument("--steps", type=int, default=1)
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from senweaver_ide_tpu_torch.models import (init_params,
                                                qwen2_5_coder_1_5b)
    from senweaver_ide_tpu_torch.ops import flash_attention as fa_mod
    from senweaver_ide_tpu_torch.training import (make_optimizer,
                                                  make_train_state,
                                                  train_step)
    from torch.profiler import ProfilerActivity, profile

    cfg = dataclasses.replace(qwen2_5_coder_1_5b(), attn_impl="flash",
                              remat=True)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(
        args.seed), device="cuda")
    rng = np.random.default_rng(args.seed)
    b, s, new = 16, 1024, 128
    tokens = np.zeros((b, s), np.int32)
    mask = np.zeros((b, s), bool)
    for i, n in enumerate(rng.integers(256, 769, size=b)):
        tokens[i, :n + new] = rng.integers(0, cfg.vocab_size, size=n + new)
        mask[i, n:n + new] = True
    rewards = rng.random(b).astype(np.float32)
    gids = np.repeat(np.arange(4, dtype=np.int32), 4)
    state = make_train_state(cfg, params=params,
                             optimizer=make_optimizer(1e-5))

    def step(state):
        state, m = train_step(state, cfg, None, tokens, mask, rewards, gids,
                              num_groups=4, accum_steps=4)
        float(m["loss"])
        return state

    state = step(state)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            state = step(state)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.key_averages()
              if _device_us(e) > 0 and e.device_type.name == "CUDA"]
    busy_us = sum(_device_us(e) for e in events)
    print(f"window: {args.steps} train step(s), batch {b} x {s}, wall "
          f"{wall_us / 1e3:.2f} ms ({wall_us / 1e3 / args.steps:.2f} "
          f"ms/step), device busy {busy_us / 1e3:.2f} ms, idle share "
          f"{1 - busy_us / wall_us:.3f}")
    events.sort(key=_device_us, reverse=True)
    for e in events[:20]:
        print(f"  {_device_us(e) / 1e3:9.3f} ms  {e.count:6d} calls  "
              f"{_device_us(e) / busy_us:6.3f}  {e.key[:90]}")
    groups = {"flash fwd (K2)": fa_mod.KERNEL_NAMES["fwd"],
              "flash dK/dV (K2)": fa_mod.KERNEL_NAMES["dkdv"],
              "flash dQ (K2)": fa_mod.KERNEL_NAMES["dq"],
              "matmuls": ("gemm", "nvjet", "cutlass", "sm90_xmma")}
    rest = busy_us
    for name, keys in groups.items():
        us = sum(_device_us(e) for e in events
                 if any(k in e.key.lower() for k in keys))
        rest -= us
        print(f"{name}: {us / 1e3:.2f} ms ({us / busy_us:.3f} of busy)")
    print(f"everything else: {rest / 1e3:.2f} ms ({rest / busy_us:.3f} of "
          f"busy)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
