#!/usr/bin/env python3
"""The port's mesh train step over NCCL, two ranks with a card each.

    python3 scripts/torch_mesh_nccl.py [--layers 4] [--seed 0] [--cpu]

Starts two ranks (spawn), each on its own CUDA card, on one NCCL process
group (``parallel.distributed.initialize``). Builds qwen2.5-coder-1.5b at
full width and ``--layers`` deep (random bf16 weights from --seed), with
attn_impl="flash" and remat, and the batch of chip_smoke.py's
``phase_parallel`` check (b): 4 x 1024, accum 2. Rank 0 takes the
one-rank step (mesh=None); then both ranks take a tp=2, an fsdp=2 and a
dp=2 step on the same weights and batch, then pp=2 gradients with
GPipe (M=2) and 1F1B (M=4) over the same batch (``parallel/pipeline.py``:
the stages' sends are NCCL point-to-point). Each mesh step's gathered
gradient is held per tensor (each layer's slice of a stacked one) to the
one-rank step's within chip_smoke's PAR_GRAD_TOL relative RMS, its loss
within PAR_LOSS_RTOL, and the ranks' metrics must be equal. A second step
on each mesh is timed (the first pays NCCL's communicator set-up). Prints
a line per mesh, the collective routes taken (``comm.ROUTES``) and one
JSON object last; exits 1 when a check fails.

``--cpu`` runs the same on gloo with CPU tensors at tiny_test size: a
rehearsal on a machine without cards.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
RANKS = 2


def _rank(rank, port, args, conn):
    try:
        sys.path.insert(0, ROOT)
        import dataclasses

        import torch
        import chip_smoke as cs
        from senweaver_ide_tpu_torch.models import (init_params,
                                                    qwen2_5_coder_1_5b,
                                                    tiny_test)
        from senweaver_ide_tpu_torch.parallel import (MeshConfig,
                                                      gather_params,
                                                      make_mesh,
                                                      make_named_mesh)
        from senweaver_ide_tpu_torch.parallel.pipeline import (
            place_pipeline_params, pp_gradients, split_layers_for_stages)
        from senweaver_ide_tpu_torch.parallel.comm import ROUTES
        from senweaver_ide_tpu_torch.parallel.distributed import (
            DistributedConfig, initialize, shutdown)
        from senweaver_ide_tpu_torch.training import (make_train_state,
                                                      place_batch_for_mesh)
        from senweaver_ide_tpu_torch.training.trainer import (
            apply_gradients, grpo_gradients)
        dev = "cpu" if args.cpu else "cuda"
        if args.cpu:
            torch.set_num_threads(1)
            cfg = dataclasses.replace(tiny_test(), remat=True)
            b, s = 4, 64
        else:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            cfg = dataclasses.replace(qwen2_5_coder_1_5b(),
                                      num_layers=args.layers,
                                      attn_impl="flash", remat=True)
            b, s = cs.PAR_B, cs.PAR_S
        accum = cs.PAR_ACCUM
        initialize(DistributedConfig(coordinator_address=f"127.0.0.1:{port}",
                                     num_processes=RANKS, process_id=rank,
                                     device=dev))

        def sync():
            if not args.cpu:
                torch.cuda.synchronize()

        params = init_params(cfg, torch.Generator(device=dev).manual_seed(
            args.seed), device=dev)
        batch = cs._par_batch(cfg, args.seed, b, s)
        out = {"backend": torch.distributed.get_backend(),
               "device": (torch.cuda.get_device_name() if not args.cpu
                          else "cpu")}
        if rank == 0:
            placed = place_batch_for_mesh(None, *batch, accum_steps=accum,
                                          device=dev)
            t0 = time.perf_counter()
            ref_g, ref_m = grpo_gradients(params, cfg, *placed[:4],
                                          accum_steps=accum)
            sync()
            out["one_rank_s"] = time.perf_counter() - t0
        for name, mcfg in (("tp2", MeshConfig(tp=2)),
                           ("fsdp2", MeshConfig(fsdp=2)),
                           ("dp2", MeshConfig(dp=2))):
            mesh = make_mesh(mcfg)
            state = make_train_state(cfg, mesh=mesh, params=params,
                                     learning_rate=cs.PAR_LR)
            placed = place_batch_for_mesh(mesh, *batch, accum_steps=accum,
                                          device=dev)
            grads, met = grpo_gradients(state.params, cfg, *placed[:4],
                                        accum_steps=accum, mesh=mesh)
            state = apply_gradients(state, grads, met["grad_norm"])
            full_g = gather_params(grads, mesh)
            sync()
            t0 = time.perf_counter()
            g2, m2 = grpo_gradients(state.params, cfg, *placed[:4],
                                    accum_steps=accum, mesh=mesh)
            state = apply_gradients(state, g2, m2["grad_norm"])
            sync()
            row = {"metrics": cs._par_floats(met),
                   "step_s": time.perf_counter() - t0}
            if rank == 0:
                pooled, each = cs._rel_rms(torch, full_g, ref_g)
                row["grad_rel_rms"] = pooled
                row["grad_worst"] = sorted(each.items(),
                                           key=lambda kv: -kv[1])[:4]
                row["loss_rel"] = abs(row["metrics"]["loss"] - float(
                    ref_m["loss"])) / max(abs(float(ref_m["loss"])), 1e-12)
            out[name] = row
            del state, grads, g2, full_g
        mesh = make_named_mesh({"pp": RANKS})
        staged = place_pipeline_params(split_layers_for_stages(params, RANKS),
                                       mesh)
        for name, schedule, m in (("pp2_gpipe", "gpipe", cs.PAR_PP_GPIPE_M),
                                  ("pp2_1f1b", "1f1b", cs.PAR_PP_1F1B_M)):
            grads, met = pp_gradients(staged, cfg, mesh, *batch,
                                      n_microbatches=m, schedule=schedule)
            full_g = cs._pp_full(grads, mesh)
            sync()
            t0 = time.perf_counter()
            pp_gradients(staged, cfg, mesh, *batch, n_microbatches=m,
                         schedule=schedule)
            sync()
            row = {"metrics": cs._par_floats(met),
                   "step_s": time.perf_counter() - t0}
            if rank == 0:
                pooled, each = cs._rel_rms(torch, full_g, ref_g)
                row["grad_rel_rms"] = pooled
                row["grad_worst"] = sorted(each.items(),
                                           key=lambda kv: -kv[1])[:4]
                row["loss_rel"] = abs(row["metrics"]["loss"] - float(
                    ref_m["loss"])) / max(abs(float(ref_m["loss"])), 1e-12)
            out[name] = row
            del grads, full_g
        out["routes"] = dict(ROUTES)
        shutdown()
        conn.send(("ok", out))
    except BaseException:
        conn.send(("err", traceback.format_exc()))
        raise


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import multiprocessing as mp

    import chip_smoke as cs
    smi = "cpu"
    if not args.cpu:
        import subprocess

        import torch
        from senweaver_ide_tpu_torch.ops import _build
        if torch.cuda.device_count() < RANKS:
            print(f"needs {RANKS} CUDA cards, found "
                  f"{torch.cuda.device_count()}", file=sys.stderr)
            return 1
        smi = "; ".join(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[:RANKS])
        _build.build_all()           # once, before the ranks launch K2
    ctx = mp.get_context("spawn")
    port = cs._free_port()
    conns, procs = [], []
    for r in range(RANKS):
        parent, child = ctx.Pipe()
        p = ctx.Process(target=_rank, args=(r, port, args, child),
                        daemon=True)
        p.start()
        conns.append(parent)
        procs.append(p)
    results, errors = [], []
    try:
        for r, c in enumerate(conns):
            got = None
            while got is None:
                if c.poll(1.0):
                    got = c.recv()
                elif not procs[r].is_alive():
                    got = ("err", f"rank {r} exited with code "
                                  f"{procs[r].exitcode}")
            if got[0] != "ok":
                errors.append(f"rank {r}: {got[1]}")
                break
            results.append(got[1])
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
    if errors:
        print("\n".join(errors), file=sys.stderr)
        return 1
    r0, r1 = results
    bad = []
    for name in ("tp2", "fsdp2", "dp2", "pp2_gpipe", "pp2_1f1b"):
        row = r0[name]
        if row["metrics"] != r1[name]["metrics"]:
            bad.append(f"{name}: the ranks' metrics differ")
        if row["grad_worst"][0][1] > cs.PAR_GRAD_TOL:
            bad.append(f"{name}: gradient relative RMS {row['grad_worst']}")
        if row["loss_rel"] > cs.PAR_LOSS_RTOL:
            bad.append(f"{name}: loss relative difference {row['loss_rel']}")
        print(f"{name} on {r0['backend']} ({r0['device']}, {smi}): gradient "
              f"relative RMS per tensor at most {row['grad_worst'][0][1]:.4g}"
              f" (tol {cs.PAR_GRAD_TOL}; the worst {row['grad_worst']}), "
              f"over every tensor {row['grad_rel_rms']:.4g}; loss rel "
              f"{row['loss_rel']:.3g} (tol {cs.PAR_LOSS_RTOL}); second step "
              f"{row['step_s']:.3f} / {r1[name]['step_s']:.3f} s (rank 0 / "
              f"1) against one rank's gradients {r0['one_rank_s']:.3f} s "
              f"(first call)")
    print(f"collective routes: {r0['routes']}")
    for b in bad:
        print(f"FAIL {b}", file=sys.stderr)
    print(json.dumps({"ok": not bad, "backend": r0["backend"],
                      "device": r0["device"], "smi": smi,
                      "layers": args.layers, "ranks": [r0, r1]}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
