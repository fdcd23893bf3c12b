#!/usr/bin/env python3
"""Host time of one paged_flash_decode (K1) call at the mixed step
(T = 64, Qwen2.5-Coder-1.5B heads, bf16 pool) without query tiles, with
host tiles (checked and copied to the card on every call) and with
tiles already on the card (as forward_paged passes them, moved once a
forward), and of the check, the copy and the tile builder alone:
microseconds a call, the best of five rounds of back-to-back calls.

    python3 scripts/torch_k1_host_cost.py     # from the repo root

Needs a CUDA card."""

import os
import sys
import time


def host_us(torch, fn, n=2000):
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    best = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        best.append((time.perf_counter() - t0) / n * 1e6)
        torch.cuda.synchronize()
    return min(best)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    import chip_smoke as c
    from senweaver_ide_tpu_torch.models import qwen2_5_coder_1_5b
    from senweaver_ide_tpu_torch.ops import paged_attention as pam
    cfg = qwen2_5_coder_1_5b()
    rep = cfg.num_heads // cfg.num_kv_heads
    g = torch.Generator(device="cuda").manual_seed(1)
    decode = torch.linspace(128, 2048, 16).round().int().tolist()
    q, pool, tables, lengths, seq_row, pos = c._k1_seq_batch(
        torch, g, "bf16", cfg, *c.k1_mixed_entries(decode))
    tiles = pam.query_tiles(seq_row, pos, rep)
    tiles_dev = tiles.cuda()
    args = (q, pool[0], pool[1], tables, lengths, pool[2], pool[3])
    for name, fn, n in (
            ("untiled call", lambda: pam.paged_flash_decode(*args), 2000),
            ("tiled call, host tiles", lambda: pam.paged_flash_decode(
                *args, q_tiles=tiles), 2000),
            ("tiled call, device tiles", lambda: pam.paged_flash_decode(
                *args, q_tiles=tiles_dev), 2000),
            ("check", lambda: pam.check_query_tiles(tiles, q.shape[0], rep),
             2000),
            ("copy", lambda: tiles.to("cuda", non_blocking=True), 2000),
            ("build", lambda: pam.query_tiles(seq_row, pos, rep), 500)):
        print(f"{name} us {host_us(torch, fn, n)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
