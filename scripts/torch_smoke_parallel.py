#!/usr/bin/env python3
"""Runs chip_smoke.py's ``phase_parallel`` alone on one card.

    python3 scripts/torch_smoke_parallel.py

The device and build phases first (the card's name and power limit, the
kernels built with nvcc), then the tie tolerance that ``phase_spec``
measures (``_spec_tie_atol`` on the same seeded weights and draws), then
``phase_parallel`` (checks (a)-(g): two ranks on the card over gloo) at
qwen2.5-coder-1.5b width with seed 0: the quick call after editing that
phase, instead of the whole script. Exits 1 when a check fails; prints
the card's name and power limit last.
"""

import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import chip_smoke as cs  # noqa: E402

SEED = 0


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_smoke_parallel: CUDA is not available", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    smi = cs.phase_device(torch)
    cs.phase_build()
    from senweaver_ide_tpu_torch.models import (init_params,
                                                qwen2_5_coder_1_5b)
    cfg = qwen2_5_coder_1_5b()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(
        SEED), device="cuda")
    # phase_spec's first draws from default_rng(seed + 10)
    tie_atol, tie_diff = cs._spec_tie_atol(
        torch, params, cfg, np.random.default_rng(SEED + 10))
    del params
    torch.cuda.empty_cache()
    cs.log(f"[tie] max |diff| between logit paths {tie_diff:.4f}; "
           f"SPEC_TIE_ATOL {tie_atol:.4f}")
    cs.phase_parallel(torch, cfg, SEED, smi, tie_atol, cs.Timer(torch))
    cs.log(f"[done] {time.perf_counter() - t0:.1f} s")
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
