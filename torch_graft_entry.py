"""Driver entry points.

- ``entry()`` → (fn, example_args): forward step of the flagship
  policy (Qwen2.5-Coder-1.5B architecture) on the CUDA card.
- ``dryrun_multichip(n)``: build an n-rank mesh over torch.distributed
  (one process a rank), run the FULL training step with real dp/fsdp/tp
  shardings, ONE step on tiny shapes, then the other layouts.

    python3 torch_graft_entry.py                    # on the card(s)
    python3 torch_graft_entry.py --cpu              # tiny-test on the host
"""

from __future__ import annotations

import os

import torch

# collectives and a rank's whole sequence give up after these
COLLECTIVE_TIMEOUT_S = 300
RANK_TIMEOUT_S = 900


def _placement(rank: int, n_devices: int, device: str):
    """(process-group backend, this rank's device, its description): a
    card each over NCCL when the ranks fit on the cards; every rank on
    card 0 over gloo when they do not (gloo moves CUDA tensors through
    host memory); gloo on CPU tensors for ``device="cpu"``, which only
    the caller chooses (the port never falls back to the host)."""
    if device == "cpu":
        return "gloo", torch.device("cpu"), "gloo on the host"
    if n_devices <= torch.cuda.device_count():
        return "nccl", torch.device("cuda", rank), f"nccl, cuda:{rank}"
    return ("gloo", torch.device("cuda", 0),
            f"gloo, cuda:0 shared by {n_devices} ranks")


def entry(*, device="cuda", params=None):
    """Single-card forward step on the flagship model; on the host
    (``device="cpu"``) the tiny-test model instead. ``params`` (a tree of
    numpy arrays or tensors) replaces the random init from seed 0."""
    from senweaver_ide_tpu_torch.device import resolve_device
    from senweaver_ide_tpu_torch.models import (forward, get_config,
                                                init_params,
                                                params_from_numpy)

    device = resolve_device(device)
    config = get_config("qwen2.5-coder-1.5b" if device.type == "cuda"
                        else "tiny-test")
    params = (init_params(config, torch.Generator(device=device).manual_seed(
        0), device=device) if params is None
        else params_from_numpy(params, device=device))
    tokens = torch.ones((1, 128), dtype=torch.long, device=device)

    def fn(params, tokens):
        with torch.no_grad():
            logits = forward(params, config, tokens)
        return logits

    return fn, (params, tokens)


def dryrun_multichip(n_devices: int, *, device="cuda") -> dict:
    """Run :func:`dryrun_rank` on ``n_devices`` ranks, one spawned
    process each on one process group (placed by :func:`_placement`),
    and return rank 0's losses by case after checking that every rank
    that ran a case reports the same loss. Every process it starts is
    stopped before it returns or raises."""
    import socket

    from senweaver_ide_tpu_torch.device import resolve_device
    resolve_device(device)              # no card: raise before spawning
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = torch.multiprocessing.get_context("spawn")
    conns, procs = [], []
    try:
        for r in range(n_devices):
            parent, child = ctx.Pipe()
            p = ctx.Process(target=_rank_main,
                            args=(r, n_devices, port, str(device), child),
                            daemon=True)
            p.start()
            conns.append(parent)
            procs.append(p)
        results = []
        for r, c in enumerate(conns):
            if not c.poll(RANK_TIMEOUT_S):
                raise TimeoutError(f"dryrun rank {r} did not finish in "
                                   f"{RANK_TIMEOUT_S} s")
            try:
                status, value = c.recv()
            except EOFError:
                raise RuntimeError(f"dryrun rank {r} exited without a "
                                   f"result") from None
            if status != "ok":
                raise RuntimeError(f"dryrun rank {r} failed:\n{value}")
            results.append(value)
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join()
    losses = results[0]["losses"]
    for r, res in enumerate(results):
        for case, loss in res["losses"].items():
            if case in losses and loss != losses[case]:
                raise RuntimeError(f"dryrun {case}: rank {r} loss {loss} "
                                   f"!= rank 0's {losses[case]}")
    return losses


def _rank_main(rank, n_devices, port, device, conn) -> None:
    """One spawned rank: join the group, run :func:`dryrun_rank`, send
    ("ok", record) or ("err", traceback) to the parent."""
    import datetime
    import traceback

    import torch.distributed as dist
    try:
        backend, dev, _ = _placement(rank, n_devices, device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend, init_method=f"tcp://127.0.0.1:{port}",
            world_size=n_devices, rank=rank,
            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
        try:
            conn.send(("ok", dryrun_rank(n_devices, device)))
        finally:
            dist.destroy_process_group()
    except BaseException:
        conn.send(("err", traceback.format_exc()))


def dryrun_rank(n_devices: int, device="cuda", weights=None) -> dict:
    """This rank's part of the dry run, in a process group of
    ``n_devices`` ranks: the dp/fsdp/tp train step, QLoRA on the same
    mesh, sp=2 ring attention (n % 4 == 0), the hybrid mesh (n % 8 == 0),
    and pp=2 (GPipe forward, 1F1B step) and ep=2 MoE on ranks 0-1
    (n % 2 == 0). Every rank builds every mesh (the ``new_group``
    contract); a rank outside one skips its case. ``weights`` may carry
    numpy trees for the pp=2 forward (``"pp"``, tiny-test params) and the
    ep=2 layer (``"moe"``) in place of their seeded inits. Prints a line
    a case, tagged with the rank and its placement; returns the losses by
    case, the pp=2 logits and this rank's ep=2 output rows and aux."""
    import numpy as np
    import torch.distributed as dist

    from senweaver_ide_tpu_torch.models import (init_params,
                                                params_from_numpy, tiny_test)
    from senweaver_ide_tpu_torch.parallel import (MeshConfig, gather_params,
                                                  make_mesh)
    from senweaver_ide_tpu_torch.training import (make_train_state,
                                                  place_batch_for_mesh,
                                                  train_step)

    rank = dist.get_rank()
    _, dev, where = _placement(rank, n_devices, str(device))
    tag = f"[rank {rank} (pid {os.getpid()}), {where}]"
    ranks = list(range(n_devices))
    out = {"rank": rank, "placement": where, "losses": {}}

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    def placed(mesh, tokens, mask, rewards, group_ids, accum=1):
        """This rank's part of a host batch, as train_step takes it."""
        return place_batch_for_mesh(mesh, tokens, mask, rewards, group_ids,
                                    accum_steps=accum, device=dev)[:4]

    # Factor n into (dp, fsdp, tp): tp innermost.
    tp = 2 if n_devices % 2 == 0 else 1
    rest = n_devices // tp
    fsdp = 2 if rest % 2 == 0 else 1
    dp = rest // fsdp
    mesh = make_mesh(MeshConfig(dp=dp, fsdp=fsdp, tp=tp),
                     devices=ranks)

    config = tiny_test()
    state = make_train_state(config, gen(0), mesh,
                             learning_rate=1e-4, device=dev)
    b, s = max(dp * fsdp, 2), 16
    tokens = np.ones((b, s), dtype=np.int32)
    rewards = np.linspace(-1.0, 1.0, b, dtype=np.float32)
    group_ids = np.zeros((b,), dtype=np.int32)
    mask = np.ones((b, s), dtype=np.bool_)
    state, metrics = train_step(state, config, mesh, *placed(
        mesh, tokens, mask, rewards, group_ids))
    out["losses"]["train"] = float(metrics["loss"])
    print(f"{tag} dryrun_multichip(n={n_devices}, mesh=dp{dp}/fsdp{fsdp}/"
          f"tp{tp}): loss={float(metrics['loss']):.4f} OK", flush=True)

    # QLoRA on the same mesh: int8-quantized frozen base + rank-r
    # adapters — the single-chip-per-replica 7B training recipe
    # (training/lora.py, models/quantize.py), run with
    # the full dp/fsdp/tp shardings (scale + adapter leaves have their
    # own PARAM_SPECS rules).
    from senweaver_ide_tpu_torch.models.quantize import quantize_weights_int8
    from senweaver_ide_tpu_torch.parallel.sharding import shard_params
    from senweaver_ide_tpu_torch.training import (make_lora_train_state,
                                            materialize_lora)
    qbase = shard_params(quantize_weights_int8(
        init_params(config, gen(7), device=dev)), mesh)
    lstate = make_lora_train_state(config, qbase, gen(8),
                                   mesh, rank=4, learning_rate=1e-3)
    lstate, lmetrics = train_step(lstate, config, mesh, *placed(
        mesh, tokens, mask, rewards, group_ids), lora_base=qbase)
    out["losses"]["qlora"] = float(lmetrics["loss"])
    # the fold into the whole base (its shards gathered first)
    served = materialize_lora(gather_params(qbase, mesh), lstate.params,
                              config)
    print(f"{tag} dryrun qlora (int8 base + rank-4 adapters) on "
          f"dp{dp}/fsdp{fsdp}/tp{tp}: loss={float(lmetrics['loss']):.4f} "
          f"fold int8={served['layers']['wq'].dtype == torch.int8} OK",
          flush=True)

    # Sequence-parallel (sp) ring-attention training step.
    if n_devices % 4 == 0:
        import dataclasses as _dc
        sp = 2
        sp_mesh = make_mesh(MeshConfig(dp=n_devices // (2 * sp), fsdp=2,
                                       sp=sp),
                            devices=ranks)
        ring_cfg = _dc.replace(config, attn_impl="ring")
        sp_state = make_train_state(ring_cfg, gen(3), sp_mesh,
                                    learning_rate=1e-4, device=dev)
        b2, s2 = 4, sp * 8 + 1       # training length (s2-1) divides by sp
        sp_state, sp_metrics = train_step(
            sp_state, ring_cfg, sp_mesh, *placed(
                sp_mesh, np.ones((b2, s2), np.int32),
                np.ones((b2, s2), np.bool_),
                np.linspace(-1.0, 1.0, b2, dtype=np.float32),
                np.zeros((b2,), np.int32)))
        out["losses"]["sp_ring"] = float(sp_metrics["loss"])
        print(f"{tag} dryrun sp={sp} ring-attention train step: "
              f"loss={float(sp_metrics['loss']):.4f} OK", flush=True)

    # Multi-slice hybrid mesh (dp over DCN, inner axes on ICI) with
    # gradient accumulation and per-layer remat — the 7B long-trajectory
    # training recipe, exercised end to end on the first 8 ranks.
    if n_devices % 8 == 0:
        import dataclasses as _dc2

        from senweaver_ide_tpu_torch.parallel.mesh import make_hybrid_mesh
        hy_mesh = make_hybrid_mesh(MeshConfig(dp=4, fsdp=2), num_slices=2,
                                   devices=ranks[:8])
        hy_cfg = _dc2.replace(config, remat=True)
        hb = 8
        if hy_mesh.is_member:
            hy_state = make_train_state(hy_cfg, gen(4), hy_mesh,
                                        learning_rate=1e-4, device=dev)
            hy_state, hy_metrics = train_step(
                hy_state, hy_cfg, hy_mesh, *placed(
                    hy_mesh, np.ones((hb, 16), np.int32),
                    np.ones((hb, 16), np.bool_),
                    np.linspace(-1.0, 1.0, hb, dtype=np.float32),
                    np.zeros((hb,), np.int32), accum=2),
                accum_steps=2)
            out["losses"]["hybrid"] = float(hy_metrics["loss"])
            print(f"{tag} dryrun hybrid dp4(2 slices)/fsdp2 + accum2 + "
                  f"remat: loss={float(hy_metrics['loss']):.4f} OK",
                  flush=True)

    # Pipeline (pp) and expert (ep) paths on sub-meshes.
    if n_devices % 2 == 0:
        from senweaver_ide_tpu_torch.parallel import (MoEConfig,
                                                      init_moe_params,
                                                      make_named_mesh,
                                                      moe_ffn_sharded,
                                                      pipeline_forward,
                                                      place_pipeline_params,
                                                      split_layers_for_stages)
        pp_mesh = make_named_mesh({"pp": 2}, devices=ranks[:2])
        if pp_mesh.is_member:
            full = (params_from_numpy(weights["pp"], device=dev)
                    if weights and "pp" in weights
                    else init_params(config, gen(1), device=dev))
            pp_params = place_pipeline_params(
                split_layers_for_stages(full, 2), pp_mesh)
            toks = torch.ones((4, 8), dtype=torch.long, device=dev)
            with torch.no_grad():
                logits = pipeline_forward(pp_params, config, toks,
                                          mesh=pp_mesh, n_microbatches=2)
            out["pp_logits"] = logits.cpu().numpy()
            print(f"{tag} dryrun pp=2 pipeline forward: logits "
                  f"{tuple(logits.shape)} OK", flush=True)

            # 1F1B schedule: interleaved fwd/bwd training step.
            from senweaver_ide_tpu_torch.parallel import (
                make_pp_train_state, pp_train_step)
            pp_state = make_pp_train_state(config, gen(5), pp_mesh,
                                           learning_rate=1e-4, device=dev)
            pp_state, ppm = pp_train_step(
                pp_state, config, pp_mesh,
                np.ones((4, 12), np.int32), np.ones((4, 12), np.bool_),
                np.linspace(-1.0, 1.0, 4, dtype=np.float32),
                np.zeros((4,), np.int32),
                n_microbatches=2, schedule="1f1b")
            out["losses"]["pp_1f1b"] = float(ppm["loss"])
            print(f"{tag} dryrun pp=2 1F1B train step: "
                  f"loss={float(ppm['loss']):.4f} OK", flush=True)

        ep_mesh = make_named_mesh({"ep": 2}, devices=ranks[:2])
        moe_cfg = MoEConfig(hidden_size=config.hidden_size,
                            intermediate_size=config.intermediate_size,
                            num_experts=4, top_k=2)
        if ep_mesh.is_member:
            moe_params = (params_from_numpy(weights["moe"], device=dev)
                          if weights and "moe" in weights
                          else init_moe_params(moe_cfg, gen(2), device=dev))
            x = torch.ones((4, 8, config.hidden_size), dtype=torch.float32,
                           device=dev)
            c = ep_mesh.coord("ep")     # this rank's 2 of the 4 rows
            with torch.no_grad():
                y, aux = moe_ffn_sharded(moe_params, moe_cfg,
                                         x[2 * c:2 * c + 2], mesh=ep_mesh)
            out["moe_out"], out["moe_aux"] = y.cpu().numpy(), float(aux)
            print(f"{tag} dryrun ep=2 MoE all-to-all: out rows "
                  f"{tuple(y.shape)} of (4, 8, {config.hidden_size}) "
                  f"aux={float(aux):.3f} OK", flush=True)
    return out


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the host: entry() on tiny-test, the "
                         "ranks on gloo over CPU tensors (default: the "
                         "CUDA cards)")
    args = ap.parse_args()
    dev = "cpu" if args.cpu else "cuda"
    fn, fargs = entry(device=dev)
    logits = fn(*fargs)
    print(f"entry() ran OK: logits {tuple(logits.shape)}, finite="
          f"{bool(torch.isfinite(logits).all())}", flush=True)
    # over the cards present; on the host, one rank
    dryrun_multichip(1 if args.cpu else torch.cuda.device_count(),
                     device=dev)
