"""Probe a trained checkpoint's conditioning across prefix lengths.

Post-hoc companion to eval_capacity.py: loads the saved curriculum
checkpoint and measures the held-out conditioning delta at EACH given
prefix — the final state's conditioning frontier (the curriculum's
target-prefix probes alone cannot say where conditioning ends if the
last stage fell short).

    python torch_eval_capacity_probe.py --load-dir DIR \
        --prefixes 0,448,960,1792

Prints ONE JSON line (CAPACITY_PROBE_r05 artifact).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from torch_eval_capacity import probe_suite


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--load-dir", required=True,
                    help="the checkpoint dir torch_eval_capacity.py "
                         "saved (its --save-dir)")
    ap.add_argument("--model", default="tiny-test")
    ap.add_argument("--prefixes", default="0,448,960,1792")
    ap.add_argument("--episodes", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA card)")
    args = ap.parse_args()

    from senweaver_ide_tpu_torch.device import resolve_device
    device = resolve_device("cpu" if args.cpu else "cuda")

    from torch_eval_uplift_real import load_policy

    t0 = time.monotonic()
    _state, engine, tok, _config = load_policy(args.load_dir,
                                               model=args.model,
                                               seed=args.seed,
                                               device=device)

    points = []
    for n in (int(x) for x in args.prefixes.split(",") if x.strip()):
        p = probe_suite(engine, tok, n, episodes=args.episodes)
        points.append({"prefix_bytes": n, **p,
                       "conditioned": bool(p["delta"] > 0.5)})
        print(f"[probe] {json.dumps(points[-1])}", file=sys.stderr,
              flush=True)
    conditioned_up_to = max((p["prefix_bytes"] for p in points
                             if p["conditioned"]), default=None)
    print(json.dumps({
        "metric": f"capacity_probe[{args.model}]",
        "checkpoint": args.load_dir,
        "points": points,
        "conditioned_up_to_bytes": conditioned_up_to,
        "episodes_per_probe": args.episodes,
        "wall_s": round(time.monotonic() - t0, 1),
    }))


if __name__ == "__main__":
    try:
        main()
    except Exception as e:   # always leave a JSON line for the caller
        print(json.dumps({"error": f"{type(e).__name__}: {e}"}))
        sys.exit(1)
