#!/usr/bin/env python3
"""The bf16 flash-attention kernels (K2) of one tree, each on its own.

    python3 scripts/torch_flash_ab.py TAG        # from a tree's root

Holds the forward and the dK/dV kernel separately against their plain
versions on the training path's shape and the tiles' edge shapes (dK/dV
fed the plain forward's lse and delta, so a fault in one kernel does not
hide the other), requires two launches to be bit-identical, then times
forward, dK/dV and dQ at the training shape (B=4, S=1023, Hq 12, Hkv 2,
D 128, causal) with ``chip_smoke.Timer``, once without its busy-wait
before the start event (so the host's launch latency is counted, as
``chip_smoke.py`` did before it had one) and twice with it, beside SDPA,
and reads each kernel's mean device time from torch.profiler. To compare
two designs on one card, run it from both trees' roots in one command;
every line carries TAG. Needs a CUDA card.
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


def _check(c, fa, torch, tag, label, args):
    """(fwd ok, dkdv ok) on one case, printing the errors."""
    q, k, v, gout, bias, kw = args
    r_out, r_lse, _, r_dk, r_dv = c._fa_plain(fa, *args)
    msgs, ok = [], {"fwd": True, "dkdv": True}
    runs = {
        "fwd": (lambda: fa.flash_attention_fwd(q, k, v, bias, **kw),
                ("out", "lse"), (r_out, r_lse)),
        "dkdv": (lambda: fa.flash_attention_bwd_dkdv(
            q, k, v, bias, gout, r_lse, fa._delta(gout.float(), r_out),
            **kw), ("dk", "dv"), (r_dk, r_dv)),
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
        except Exception:  # report and go on to the other kernel
            ok[kname] = False
            msgs.append(f"{kname} raised "
                        f"{traceback.format_exc().splitlines()[-1]}")
    print(f"[{tag}] {label}: " + ", ".join(msgs), flush=True)
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("tag")
    args = ap.parse_args(argv)
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    import chip_smoke as c
    from senweaver_ide_tpu_torch.ops import flash_attention as fa
    tag = args.tag
    c.phase_device(torch)
    g = torch.Generator(device="cuda").manual_seed(3)
    ok = {"fwd": True, "dkdv": True}
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
    calls = {n: f for n, f in calls.items() if ok.get(n, True)}
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
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            timer.flush.zero_()
            for f in calls.values():
                f()
        torch.cuda.synchronize()
    for ev in prof.key_averages():
        name = re.search(r"fa_\w+", ev.key)
        if name:
            us = getattr(ev, "device_time", None) or getattr(ev, "cuda_time",
                                                             0)
            print(f"[{tag}] profiler {name.group(0)}: {ev.count} launches, "
                  f"mean device {us / 1000:.4f} ms", flush=True)
    if hasattr(fa, "kernel_resources"):
        print(f"[{tag}] resources {fa.kernel_resources(d)}", flush=True)
    return 0 if all(ok.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
