"""On-card attention-kernel revalidation: the flash-attention kernel, the
slot-cache flash-decode kernel and what each buys at model level.

This script runs on the CUDA card (``--cpu`` runs the plain versions the
kernels' wrappers use on CPU tensors) and records, in ``OUT_PATH``:

  1. ``flash_attention`` (prefill/training path) matches the plain
     attention in bf16 at qwen-1.5b head geometry.
  2. ``flash_decode`` matches the plain cache attention at GQA heads
     (Hq=12, Hkv=2), one query head per KV head (8/8) and one KV head
     for four query heads (4/1).
  3. Model-level decode throughput, einsum vs flash
     (``decode_attn_impl``), via the slope method.
  4. Long-context forward wall-clock, einsum vs flash attention.

A failure in any section raises: the run exits non-zero and writes no
file. The JSON carries the card's name and power limit and
``kernels_ok``, every parity flag of sections 1-2 together.

Run:  python torch_eval_flash_chip.py [--cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import time

OUT_PATH = "FLASH_torch.json"
TIMED_ITERS = 3
# sections 1-2: bf16 accumulation noise against the fp32 plain version
PARITY_TOL = 3e-2
DECODE_HEADS = ((12, 2), (8, 8), (4, 1))
DECODE_LENGTHS = (5, 512, 1024)


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def attention_inputs(device, *, b=2, s=1024, hq=12, hkv=2, d=128, seed=0):
    """Section 1's q, k, v: normal bf16 from a seeded generator on
    ``device``."""
    import torch
    g = torch.Generator(device=device.type).manual_seed(seed)

    def rnd(h):
        return torch.randn(b, s, h, d, generator=g, device=device,
                           dtype=torch.bfloat16)
    return rnd(hq), rnd(hkv), rnd(hkv)


def decode_inputs(device, hq, hkv, *, d=128, smax=1024, seed=0):
    """Section 2's q (B, 1, Hq, D), caches (B, Smax, Hkv, D) and the
    per-slot lengths ``DECODE_LENGTHS``."""
    import torch
    g = torch.Generator(device=device.type).manual_seed(seed)
    b = len(DECODE_LENGTHS)
    q = torch.randn(b, 1, hq, d, generator=g, device=device,
                    dtype=torch.bfloat16)
    k = torch.randn(b, smax, hkv, d, generator=g, device=device,
                    dtype=torch.bfloat16)
    v = torch.randn(b, smax, hkv, d, generator=g, device=device,
                    dtype=torch.bfloat16)
    lengths = torch.tensor(DECODE_LENGTHS, dtype=torch.int32, device=device)
    return q, k, v, lengths


def _max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def kernel_parity(device) -> dict:
    """Sections 1 and 2: each kernel against the plain attention on the
    same inputs (fp32 copies)."""
    from senweaver_ide_tpu_torch.ops.attention import attention
    from senweaver_ide_tpu_torch.ops.flash_attention import flash_attention
    from senweaver_ide_tpu_torch.ops.flash_decode import flash_decode

    out = {}
    q, k, v = attention_inputs(device)
    t0 = time.perf_counter()
    fa = flash_attention(q, k, v, causal=True)
    _sync(device)
    # the first call: the kernel's build (nvcc) and its launch
    out["flash_attention_lowered_s"] = round(time.perf_counter() - t0, 2)
    ref = attention(q.float(), k.float(), v.float(), causal=True)
    err = _max_err(fa, ref)
    out["flash_attention_parity_max_err"] = err
    out["flash_attention_ok"] = err < PARITY_TOL

    for hq, hkv in DECODE_HEADS:
        q1, kc, vc, lengths = decode_inputs(device, hq, hkv)
        fd = flash_decode(q1, kc, vc, lengths, block_kv=128)
        rf = attention(q1.float(), kc.float(), vc.float(),
                       q_offset=lengths - 1, causal=True)
        err = _max_err(fd, rf)
        out[f"flash_decode_parity_hq{hq}_hkv{hkv}"] = err
        out[f"flash_decode_ok_hq{hq}_hkv{hkv}"] = err < PARITY_TOL
    return out


def _decode_rate(config, batch, prompt_len, n_lo, n_hi, max_len,
                 device) -> float:
    """Slope-method decode tokens/sec: the time of ``n_hi`` tokens less
    that of ``n_lo`` over the extra tokens, so prefill and launch costs
    cancel."""
    import torch

    from senweaver_ide_tpu_torch.models import init_params
    from senweaver_ide_tpu_torch.models.transformer import init_kv_cache
    from senweaver_ide_tpu_torch.rollout.sampler import (SampleParams,
                                                         generate_scan)

    params = init_params(config, torch.Generator(
        device=device.type).manual_seed(0), device=device)
    prompt = torch.ones((batch, prompt_len), dtype=torch.int64,
                        device=device)
    sample = SampleParams(temperature=0.8, top_k=0, top_p=0.0)

    def run(seed, n):
        cache = init_kv_cache(config, batch, max_len, device=device)
        gen = torch.Generator(device=device.type).manual_seed(seed)
        with torch.no_grad():
            toks, _ = generate_scan(params, config, prompt, cache, gen,
                                    max_new_tokens=n, sample=sample)
        return toks.cpu()

    run(1, n_lo)
    run(1, n_hi)

    def timed_pair():
        t0 = time.perf_counter()
        for i in range(TIMED_ITERS):
            run(2 + i, n_lo)
        t_lo = time.perf_counter() - t0
        t0 = time.perf_counter()
        for i in range(TIMED_ITERS):
            run(2 + i, n_hi)
        return t_lo, time.perf_counter() - t0

    t_lo, t_hi = timed_pair()
    if t_hi <= t_lo * 1.02:
        t_lo, t_hi = timed_pair()
    if t_hi <= t_lo * 1.02:
        raise RuntimeError(f"slope not positive (t_lo={t_lo:.3f} "
                           f"t_hi={t_hi:.3f})")
    return batch * (n_hi - n_lo) * TIMED_ITERS / (t_hi - t_lo)


def decode_bench(base, device) -> dict:
    """Section 3 at ``base``'s shape: batch 8, 512-token prompts, the
    slope between 16 and 144 new tokens."""
    batch, prompt_len, n_lo, n_hi = 8, 512, 16, 144
    max_len = 768          # 128-aligned so the flash decode path engages
    rate_e = _decode_rate(base, batch, prompt_len, n_lo, n_hi, max_len,
                          device)
    rate_f = _decode_rate(
        dataclasses.replace(base, decode_attn_impl="flash"),
        batch, prompt_len, n_lo, n_hi, max_len, device)
    return {"decode_einsum_tok_s": round(rate_e, 1),
            "decode_flash_tok_s": round(rate_f, 1),
            "decode_flash_speedup": round(rate_f / rate_e, 3)}


def forward_bench(base, device, s_long: int = 4096) -> dict:
    """Section 4: one (1, ``s_long``) no-cache forward at ``base``'s
    shape, einsum against flash attention."""
    import torch

    from senweaver_ide_tpu_torch.models import init_params
    from senweaver_ide_tpu_torch.models.transformer import forward
    cfg_e = dataclasses.replace(base, max_seq_len=s_long)
    cfg_f = dataclasses.replace(cfg_e, attn_impl="flash")
    params = init_params(cfg_e, torch.Generator(
        device=device.type).manual_seed(0), device=device)
    toks = torch.ones((1, s_long), dtype=torch.int64, device=device)

    def timed_fwd(cfg):
        with torch.no_grad():
            forward(params, cfg, toks)             # first call: kernel build
            _sync(device)
            t0 = time.perf_counter()
            for _ in range(TIMED_ITERS):
                forward(params, cfg, toks)
            _sync(device)
        return (time.perf_counter() - t0) / TIMED_ITERS

    te, tf = timed_fwd(cfg_e), timed_fwd(cfg_f)
    return {"fwd4k_einsum_ms": round(te * 1000.0, 1),
            "fwd4k_flash_ms": round(tf * 1000.0, 1),
            "fwd4k_flash_speedup": round(te / tf, 3)}


def card_info(device) -> dict:
    """The card's name and power limit as nvidia-smi reports them (None
    on the CPU)."""
    if device.type != "cuda":
        return {"card": None, "power_limit": None}
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    name, _, limit = line.rpartition(",")
    return {"card": name.strip(), "power_limit": limit.strip()}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA card)")
    args = ap.parse_args(argv)

    import torch

    from senweaver_ide_tpu_torch.device import resolve_device
    from senweaver_ide_tpu_torch.models import get_config

    device = resolve_device("cpu" if args.cpu else "cuda")
    out = {"device": (torch.cuda.get_device_name(device)
                      if device.type == "cuda" else "cpu"),
           "platform": "gpu" if device.type == "cuda" else "cpu",
           **card_info(device)}
    out.update(kernel_parity(device))
    out["kernels_ok"] = all(v for k, v in out.items() if "_ok" in k)
    base = get_config("qwen2.5-coder-1.5b")
    out.update(decode_bench(base, device))
    out.update(forward_bench(base, device))
    with open(OUT_PATH, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
