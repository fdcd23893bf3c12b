#!/usr/bin/env python3
"""The attention kernels of one tree, each on its own: K2 (flash
attention, bf16) by default, K3 (flash_decode) with ``--k3``, K1
(paged_flash_decode) with ``--k1``.

    python3 scripts/torch_flash_ab.py TAG [--k3 | --k1]  # from a tree's root

K2: holds the forward, the dK/dV and the dQ kernel separately against
their plain versions on the training path's shape and the tiles' edge
shapes (dK/dV and dQ fed the plain forward's lse and delta, so a fault in
one kernel does not hide another), requires two launches to be
bit-identical, then times forward, dK/dV and dQ at the training shape
(B=4, S=1023, Hq 12, Hkv 2, D 128, causal) with ``chip_smoke.Timer``,
once without its busy-wait before the start event (so the host's launch
latency is counted, as ``chip_smoke.py`` did before it had one) and
twice with it, beside SDPA, and reads each kernel's mean device time from
torch.profiler.

K3: holds flash_decode (bf16) against its plain version at lengths on
chunk and tile edges, short grids and a strided cache view (poisoned
tails and a second launch bit-identical), then times it the same way at
16 slots x 4096 positions (lengths 512..4096) at the Mistral-7B heads
(32/8) and the Qwen2.5-Coder-1.5B heads (12/2), beside SDPA with a length
mask.

K1: holds paged_flash_decode against its plain version on bf16, int8 and
fp8 pools (Qwen2.5-Coder-1.5B heads 12/2, D 128, block 16, 128 blocks a
table row) at lengths on chunk and tile edges and on the mixed step, in
query tiles where the tree has them (a second launch bit-identical),
then times it at the decode step (16 rows, lengths 128..2048) and the
mixed step (those rows plus a 40-token and an 8-token prefill segment,
T = 64) beside the bytes bound. The batches come from this script's own
tree's ``chip_smoke.py``, so both trees run the same inputs.

To compare two designs on one card, run it from both trees' roots in one
command; every line carries TAG. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import os
import re
import sys
import traceback

CASES = [("causal B=4 S=1024", dict(b=4, s=1024)),
         ("ragged B=2 S=1000", dict(b=2, s=1000)),
         ("kv_mask B=2 S=768", dict(b=2, s=768, pad_from=[768, 517])),
         ("window 256 B=2 S=1000", dict(b=2, s=1000, window=256)),
         ("D=64 window 37", dict(b=2, s=500, hq=14, d=64, window=37)),
         ("S=17", dict(b=2, s=17)), ("S=65", dict(b=2, s=65)),
         ("S=1025", dict(b=1, s=1025)),
         ("offsets q 40 kv -25, Skv 333",
          dict(b=1, s=300, skv=333, q_offset=40, kv_offset=-25)),
         ("MHA 16/16", dict(b=1, s=512, hq=16, hkv=16)),
         ("non-causal kv_mask", dict(b=2, s=200, causal=False,
                                     pad_from=[77, 0]))]
# K3: (label, (Hq, Hkv, D), Smax, strided, lengths)
K3_CASES = [
    ("mistral edges", (32, 8, 128), 4096, False,
     [1, 63, 64, 65, 255, 256, 257, 511, 512, 513, 4095, 4096]),
    ("qwen-1.5b edges, strided", (12, 2, 128), 3000, True,
     [1, 63, 64, 65, 127, 128, 129, 2999, 3000]),
    ("qwen-0.5b D=64", (14, 2, 64), 1024, False, [1, 65, 500, 1023, 1024]),
    ("short grid B=1", (12, 2, 128), 4096, False, [4096]),
    ("short grid B=2", (12, 2, 128), 4096, True, [129, 4095])]
K3_TIMINGS = [("mistral-7b heads 32/8", (32, 8, 128)),
              ("qwen2.5-coder-1.5b heads 12/2", (12, 2, 128))]


def _check(c, fa, torch, tag, label, args):
    """{kernel: ok} on one case, printing the errors."""
    q, k, v, gout, bias, kw = args
    r_out, r_lse, r_dq, r_dk, r_dv = c._fa_plain(fa, *args)
    delta = fa._delta(gout.float(), r_out)
    msgs, ok = [], {"fwd": True, "dkdv": True, "dq": True}
    runs = {
        "fwd": (lambda: fa.flash_attention_fwd(q, k, v, bias, **kw),
                ("out", "lse"), (r_out, r_lse)),
        "dkdv": (lambda: fa.flash_attention_bwd_dkdv(
            q, k, v, bias, gout, r_lse, delta, **kw), ("dk", "dv"),
            (r_dk, r_dv)),
        "dq": (lambda: (fa.flash_attention_bwd_dq(
            q, k, v, bias, gout, r_lse, delta, **kw),), ("dq",), (r_dq,)),
    }
    for kname, (fn, names, refs) in runs.items():
        try:
            got, again = fn(), fn()
            torch.cuda.synchronize()
            for n, a, r in zip(names, got, refs):
                e, good = c._fa_err(a, r, *c.FA_TOL[n])
                msgs.append(f"{n} {e:.3g}{'' if good else ' FAIL'}")
                ok[kname] &= good
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            ok[kname] &= same
            msgs.append(f"{kname} {'bit-identical' if same else 'DIFFERS'}")
        except Exception:  # report and go on to the other kernels
            ok[kname] = False
            msgs.append(f"{kname} raised "
                        f"{traceback.format_exc().splitlines()[-1]}")
    print(f"[{tag}] {label}: " + ", ".join(msgs), flush=True)
    return ok


def _profile(torch, timer, calls, pattern, tag):
    """Mean device time of each kernel whose name matches ``pattern``,
    over 20 rounds of ``calls``."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            timer.flush.zero_()
            for f in calls.values():
                f()
        torch.cuda.synchronize()
    for ev in prof.key_averages():
        name = re.search(pattern, ev.key)
        if name:
            us = getattr(ev, "device_time", None) or getattr(ev, "cuda_time",
                                                             0)
            print(f"[{tag}] profiler {name.group(0)}: {ev.count} launches, "
                  f"mean device {us / 1000:.4f} ms", flush=True)


def run_k2(c, torch, tag):
    import torch.nn.functional as F
    from senweaver_ide_tpu_torch.ops import flash_attention as fa
    g = torch.Generator(device="cuda").manual_seed(3)
    ok = {"fwd": True, "dkdv": True, "dq": True}
    for label, spec in CASES:
        spec = {"hq": 12, "hkv": 2, "d": 128, **spec}
        case_ok = _check(c, fa, torch, tag, label,
                         c._fa_case(torch, fa, g, **spec))
        ok = {n: ok[n] and case_ok[n] for n in ok}
    print(f"[{tag}] right: {ok}", flush=True)

    b, s, hq, hkv, d = 4, 1023, 12, 2, 128
    q, k, v, gout, bias, kw = c._fa_case(torch, fa, g, b, s, hq, hkv, d)
    out, lse = fa.flash_attention_fwd(q, k, v, bias, **kw)
    delta = fa._delta(gout, out)
    calls = {"fwd": lambda: fa.flash_attention_fwd(q, k, v, **kw),
             "dkdv": lambda: fa.flash_attention_bwd_dkdv(
                 q, k, v, None, gout, lse, delta, **kw),
             "dq": lambda: fa.flash_attention_bwd_dq(
                 q, k, v, None, gout, lse, delta, **kw)}
    calls = {n: f for n, f in calls.items() if ok[n]}
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, is_causal=True, enable_gqa=True)
    o_lib = sdpa()
    gt = gout.transpose(1, 2).contiguous()
    timer = c.Timer(torch)
    no_spin = c.Timer(torch)
    no_spin.spin = 0
    print(f"[{tag}] ms, no busy-wait before the start event: " + ", ".join(
        f"{n} {no_spin.ms(f):.4f}" for n, f in calls.items()), flush=True)
    for rnd in range(2):
        t = {n: timer.ms(f) for n, f in calls.items()}
        with torch.no_grad():
            t["sdpa_fwd"] = timer.ms(sdpa)
        t["sdpa_bwd"] = timer.ms(lambda: torch.autograd.grad(
            o_lib, (qt, kt, vt), gt, retain_graph=True))
        print(f"[{tag}] ms, round {rnd}: " + ", ".join(
            f"{n} {x:.4f}" for n, x in t.items()), flush=True)
    _profile(torch, timer, calls, r"fa_\w+", tag)
    if hasattr(fa, "kernel_resources"):
        print(f"[{tag}] resources {fa.kernel_resources(d)}", flush=True)
    return all(ok.values())


def run_k3(c, torch, tag, plans=(None,)):
    import torch.nn.functional as F
    from senweaver_ide_tpu_torch.ops import flash_decode as fdm
    from senweaver_ide_tpu_torch.ops.flash_decode import (flash_decode,
                                                          flash_decode_plain)
    g = torch.Generator(device="cuda").manual_seed(5)

    def batch(hq, hkv, d, smax, strided, lens):
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        b, rows = len(lens), smax + 64 if strided else smax
        q = torch.randn(b, hq, d, generator=g, device="cuda").bfloat16()
        k, v = (torch.randn(b, rows, hkv, d, generator=g,
                            device="cuda").bfloat16()[:, :smax]
                for _ in range(2))
        return q, k, v, lengths

    right = True
    for label, (hq, hkv, d), smax, strided, lens in K3_CASES:
        q, k, v, lengths = batch(hq, hkv, d, smax, strided, lens)
        kw = {"allow_pad_copy": smax % 128 != 0}
        try:
            out, again = (flash_decode(q, k, v, lengths, **kw)
                          for _ in range(2))
            kp, vp = k.clone(), v.clone()
            for i, n in enumerate(lens):
                kp[i, n:] = float("nan")
                vp[i, n:] = float("nan")
            poisoned = flash_decode(q, kp, vp, lengths, **kw)
            torch.cuda.synchronize()
            ref = flash_decode_plain(q.float(), k.float(), v.float(),
                                     lengths)
            diff = (out.float() - ref).abs()
            atol, rtol = c.FD_TOL["bf16"]
            good = bool((diff <= atol + rtol * ref.abs()).all())
            same = torch.equal(out, again) and torch.equal(out, poisoned)
            msg = (f"max err {float(diff.max()):.3g}"
                   f"{'' if good else ' FAIL'}, two launches and the "
                   f"poisoned tail {'bit-identical' if same else 'DIFFER'}")
            right &= good and same
        except Exception:  # report and go on
            right = False
            msg = f"raised {traceback.format_exc().splitlines()[-1]}"
        print(f"[{tag}] k3 {label}: {msg}", flush=True)
    print(f"[{tag}] k3 right: {right}", flush=True)
    if not right:
        return False

    timer = c.Timer(torch)
    no_spin = c.Timer(torch)
    no_spin.spin = 0
    default = getattr(fdm, "BLOCKS_PER_SM", None)
    for per_sm in plans:
        if per_sm is not None:
            if default is None:
                continue          # a tree without a split plan
            fdm.BLOCKS_PER_SM = per_sm
            print(f"[{tag}] k3 plan: BLOCKS_PER_SM {per_sm}", flush=True)
        _time_k3(c, torch, tag, timer, no_spin, batch, F, flash_decode)
    if default is not None:
        fdm.BLOCKS_PER_SM = default
    return True


def _time_k3(c, torch, tag, timer, no_spin, batch, F, flash_decode):
    for label, (hq, hkv, d) in K3_TIMINGS:
        b, smax = 16, 4096
        lengths = torch.linspace(512, 4096, b, device="cuda").round().to(
            torch.int32)
        q, k, v, _ = batch(hq, hkv, d, smax, False, [smax] * b)
        mask = (torch.arange(smax, device="cuda")[None, :]
                < lengths[:, None])[:, None, None, :]
        qq, kt, vt = q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2)
        calls = {"k3": lambda: flash_decode(q, k, v, lengths)}
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qq, kt, vt, attn_mask=mask, enable_gqa=True)
        nbytes = int(lengths.sum()) * hkv * d * 4 + 4 * q.numel() + 4 * b
        print(f"[{tag}] k3 {label} B={b} Smax={smax}, bytes bound "
              f"{nbytes / c.HBM_BYTES_PER_S * 1e3:.4f} ms; ms, no busy-wait:"
              f" {no_spin.ms(calls['k3']):.4f}", flush=True)
        for rnd in range(2):
            print(f"[{tag}] k3 {label} ms, round {rnd}: kernel "
                  f"{timer.ms(calls['k3']):.4f}, sdpa {timer.ms(sdpa):.4f}",
                  flush=True)
        _profile(torch, timer, calls, r"(?<![A-Za-z])fd_\w*?kernel", tag)


def _this_tree_smoke():
    """chip_smoke.py of the tree this script lives in (the batch functions
    of K1's cases), whichever tree's package is imported."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("k1_cases", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_k1(c, torch, tag, plans=(None,)):
    from senweaver_ide_tpu_torch.models import qwen2_5_coder_1_5b
    from senweaver_ide_tpu_torch.ops import flash_decode as fdm
    from senweaver_ide_tpu_torch.ops import paged_attention as pam
    cur = _this_tree_smoke()
    cfg = qwen2_5_coder_1_5b()
    rep = cfg.num_heads // cfg.num_kv_heads
    tiled = hasattr(pam, "query_tiles")
    g = torch.Generator(device="cuda").manual_seed(1)

    def call(q, pool, tables, lengths, tiles):
        kw = {} if tiles is None else {"q_tiles": tiles}
        return pam.paged_flash_decode(q, *pool[:2], tables, lengths,
                                      *pool[2:], **kw)

    def batch(variant, seq_lens, entries):
        q, pool, tables, lengths, seq_row, pos = cur._k1_seq_batch(
            torch, g, variant, cfg, seq_lens, entries)
        # on the card, as forward_paged passes them
        tiles = pam.query_tiles(seq_row, pos, rep).cuda() if tiled else None
        return q, pool, tables, lengths, tiles

    decode = torch.linspace(128, 2048, 16).round().int().tolist()
    lens = [1, 63, 64, 65, 127, 128, 129, 191, 192, 193, 257, 2047, 2048]
    right = True
    for variant in ("bf16", "int8", "fp8"):
        for label, spec in (
                ("edges", (lens, [(i, n - 1) for i, n in enumerate(lens)])),
                ("mixed step", cur.k1_mixed_entries(decode))):
            q, pool, tables, lengths, tiles = batch(variant, *spec)
            try:
                out, again = (call(q, pool, tables, lengths, tiles)
                              for _ in range(2))
                torch.cuda.synchronize()
                ref = pam.paged_flash_decode_plain(q.float(), *pool[:2],
                                                   tables, lengths,
                                                   *pool[2:])
                diff = (out.float() - ref).abs()
                good = bool((diff <= c.KERNEL_ATOL
                             + c.KERNEL_RTOL * ref.abs()).all())
                same = torch.equal(out, again)
                msg = (f"max err {float(diff.max()):.3g}"
                       f"{'' if good else ' FAIL'}, two launches "
                       f"{'bit-identical' if same else 'DIFFER'}")
                right &= good and same
            except Exception:  # report and go on
                right = False
                msg = f"raised {traceback.format_exc().splitlines()[-1]}"
            print(f"[{tag}] k1 {variant} {label}"
                  f"{' (tiled)' if tiles is not None else ''}: {msg}",
                  flush=True)
    print(f"[{tag}] k1 right: {right}", flush=True)
    if not right:
        return False
    timer = c.Timer(torch)
    default = getattr(fdm, "BLOCKS_PER_SM", None)
    for per_sm in plans:
        if per_sm is not None:
            fdm.BLOCKS_PER_SM = per_sm
            print(f"[{tag}] k1 plan: BLOCKS_PER_SM {per_sm}", flush=True)
        for variant in ("bf16", "int8", "fp8"):
            for label, spec in (
                    ("decode T=16", (decode, [(i, n - 1) for i, n in
                                              enumerate(decode)])),
                    ("mixed T=64", cur.k1_mixed_entries(decode))):
                q, pool, tables, lengths, tiles = batch(variant, *spec)
                reach = spec[0]
                nbytes, _ = cur._k1_bound(pool, q, lengths, reach,
                                          0 if tiles is None
                                          else tiles.shape[0])
                calls = {"k1": lambda: call(q, pool, tables, lengths,
                                            tiles)}
                ms = [timer.ms(calls["k1"]) for _ in range(2)]
                print(f"[{tag}] k1 {variant} {label}"
                      f"{' tiled' if tiles is not None else ''}: bytes "
                      f"bound {nbytes / c.HBM_BYTES_PER_S * 1e3:.4f} ms; "
                      f"ms, two rounds: {ms[0]:.4f}, {ms[1]:.4f}",
                      flush=True)
                _profile(torch, timer, calls, r"pfd_\w*?kernel", tag)
    if default is not None:
        fdm.BLOCKS_PER_SM = default
    return True


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("tag")
    ap.add_argument("--k3", action="store_true",
                    help="flash_decode (K3) instead of the K2 kernels")
    ap.add_argument("--k1", action="store_true",
                    help="paged_flash_decode (K1) instead of the K2 "
                         "kernels")
    ap.add_argument("--blocks-per-sm", default="",
                    help="K3 and K1: comma-separated BLOCKS_PER_SM values "
                         "of the split plan to time besides the tree's "
                         "own")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    import chip_smoke as c
    c.phase_device(torch)
    plans = [None] + [int(x) for x in args.blocks_per_sm.split(",") if x]
    if args.k3:
        ok = run_k3(c, torch, args.tag, plans)
    elif args.k1:
        ok = run_k1(c, torch, args.tag, plans)
    else:
        ok = run_k2(c, torch, args.tag)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
