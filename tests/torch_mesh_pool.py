"""A pool of gloo ranks for the port's mesh tests, and the rank side of
their scenarios.

``RankPool(n)`` spawns ``n`` processes (``torch.multiprocessing``'s spawn
context, one torch thread each) that join one gloo process group on a
free localhost port and then run scenario after scenario sent through a
pipe: ``pool.run(fn, *args)`` calls ``fn(*args)`` on every rank and
returns the per-rank results (or raises with the failing ranks'
tracebacks). Collectives time out after ``COLLECTIVE_TIMEOUT_S``, so a
scenario that fails on one rank fails the test instead of hanging it.

This module imports the port only: the ranks never import JAX. The test
files compute the JAX side in the parent and pass numpy inputs and
expected values to the ranks; each scenario below builds its mesh on
every rank of the pool (the ``new_group`` contract) and returns None on
ranks outside it.
"""

from __future__ import annotations

import dataclasses
import datetime
import socket
import traceback

import numpy as np
import torch

COLLECTIVE_TIMEOUT_S = 60
SCENARIO_TIMEOUT_S = 240


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, world: int, port: int, conn) -> None:
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world,
        rank=rank, timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    try:
        while True:
            msg = conn.recv()
            if msg is None:
                break
            fn, args, kwargs = msg
            try:
                conn.send(("ok", fn(*args, **kwargs)))
            except Exception:           # reported to the parent
                conn.send(("err", traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class RankPool:
    """``n`` gloo ranks that run scenarios on request."""

    def __init__(self, n: int):
        ctx = torch.multiprocessing.get_context("spawn")
        port = free_port()
        self.n = n
        self.conns, self.procs = [], []
        for r in range(n):
            parent, child = ctx.Pipe()
            p = ctx.Process(target=_rank_main, args=(r, n, port, child),
                            daemon=True)
            p.start()
            self.conns.append(parent)
            self.procs.append(p)
        self.broken = None

    def run(self, fn, *args, **kwargs):
        if self.broken:
            raise RuntimeError(f"rank pool broken by {self.broken}")
        for c in self.conns:
            c.send((fn, args, kwargs))
        out, errors = [], []
        for r, c in enumerate(self.conns):
            if not c.poll(SCENARIO_TIMEOUT_S):
                self.broken = f"{fn.__name__}: rank {r} timed out"
                raise TimeoutError(self.broken)
            status, value = c.recv()
            if status == "err":
                errors.append(f"--- rank {r} ---\n{value}")
            out.append(value)
        if errors:
            self.broken = fn.__name__
            raise AssertionError("\n".join(errors))
        return out

    def close(self) -> None:
        for c in self.conns:
            try:
                c.send(None)
            except (BrokenPipeError, OSError):
                pass
        for p in self.procs:
            p.join(timeout=10)
            if p.is_alive():
                p.terminate()


# ---- shared rank-side helpers ----

def np_tree(tree):
    """A tree of tensors as numpy (copies)."""
    if isinstance(tree, dict):
        return {k: np_tree(v) for k, v in tree.items()}
    return tree.detach().float().numpy().copy() if tree.dtype in (
        torch.bfloat16,) else tree.detach().numpy().copy()


def config(name: str, **over):
    from senweaver_ide_tpu_torch.models import config as C
    cfg = {"tiny-test": C.tiny_test, "small-test": C.small_test,
           "tiny-moe-test": C.tiny_moe_test}[name]()
    return dataclasses.replace(cfg, **over) if over else cfg


def tparams(np_params):
    from senweaver_ide_tpu_torch.models import params_from_numpy
    return params_from_numpy(np_params, device="cpu")


def mesh_of(kind: str, sizes: dict, ranks=None):
    """A mesh over the first ranks of the pool (``ranks`` by default),
    built alike on every rank."""
    if ranks is None:
        ranks = list(range(int(np.prod(list(sizes.values())))))
    from senweaver_ide_tpu_torch.parallel import (MeshConfig, make_mesh,
                                                  make_named_mesh)
    from senweaver_ide_tpu_torch.parallel.mesh import make_hybrid_mesh
    if kind == "mesh":
        return make_mesh(MeshConfig(**sizes), devices=ranks)
    if kind == "hybrid":
        return make_hybrid_mesh(MeshConfig(**sizes), num_slices=2,
                                devices=ranks)
    return make_named_mesh(sizes, devices=ranks)


def coords_of(mesh) -> dict:
    return {a: mesh.coord(a) for a in mesh.axis_names}


# ---- tests/test_torch_parallel.py ----

def sc_forward(np_params, cfg_name, sizes, tokens):
    """This rank's block of ``forward(mesh=)``'s logits."""
    from senweaver_ide_tpu_torch.models.transformer import forward
    from senweaver_ide_tpu_torch.parallel import data_sharding, shard_params
    mesh = mesh_of("mesh", sizes)
    params = shard_params(tparams(np_params), mesh)
    toks = data_sharding(mesh).local(torch.from_numpy(tokens).long())
    with torch.no_grad():
        logits = forward(params, config(cfg_name), toks, mesh=mesh)
    return {"coords": coords_of(mesh), "logits": logits.numpy()}


def sc_seq_parallel(kind, q, k, v, kv_mask, causal, sp):
    """Ring or Ulysses attention of this rank's sequence chunk, and the
    chunk's gradients of sum(out²) (the global loss is the sum of the
    ranks' terms)."""
    from senweaver_ide_tpu_torch.parallel import (make_ring_attention,
                                                  make_ulysses_attention)
    mesh = mesh_of("mesh", {"sp": sp}, ranks=list(range(sp)))
    if not mesh.is_member:
        return None
    c, n = mesh.coord("sp"), q.shape[1] // sp

    def local(a):
        return torch.from_numpy(a[:, c * n:(c + 1) * n]).requires_grad_()

    ql, kl, vl = local(q), local(k), local(v)
    if kind == "ring":
        if kv_mask is None:
            out = make_ring_attention(mesh, causal=causal)(ql, kl, vl)
        else:
            m = torch.from_numpy(kv_mask[:, c * n:(c + 1) * n])
            out = make_ring_attention(mesh, causal=causal,
                                      with_mask=True)(ql, kl, vl, m)
    else:
        out = make_ulysses_attention(mesh, causal=causal)(ql, kl, vl)
    (out ** 2).sum().backward()
    return {"c": c, "out": out.detach().numpy(), "dq": ql.grad.numpy(),
            "dk": kl.grad.numpy(), "dv": vl.grad.numpy()}


def sc_ulysses_heads(q, sp):
    """Ulysses refuses head counts that do not split over sp."""
    from senweaver_ide_tpu_torch.parallel import make_ulysses_attention
    mesh = mesh_of("mesh", {"sp": sp}, ranks=list(range(sp)))
    if not mesh.is_member:
        return None
    t = torch.from_numpy(q)
    try:
        make_ulysses_attention(mesh)(t, t[:, :, :2], t[:, :, :2])
    except ValueError as e:
        return str(e)
    return "no error"


def sc_moe_sharded(np_params, cfg_kw, x, ep, dtype):
    """``moe_ffn_sharded`` on this rank's rows, beside ``moe_ffn`` of the
    same rows on full banks and of the whole batch; the aux losses."""
    from senweaver_ide_tpu_torch.parallel import (MoEConfig, moe_ffn,
                                                  moe_ffn_sharded)
    mesh = mesh_of("named", {"ep": ep}, ranks=list(range(ep)))
    if not mesh.is_member:
        return None
    dt = getattr(torch, dtype)
    params = {n: (torch.from_numpy(a).to(dt) if a.dtype == np.float32
                  and not n.endswith("_scale") and n != "router"
                  else torch.from_numpy(a)) for n, a in np_params.items()}
    cfg = MoEConfig(dtype=dt, **cfg_kw)
    c, n = mesh.coord("ep"), x.shape[0] // ep
    xl = torch.from_numpy(x[c * n:(c + 1) * n]).to(dt)
    out, aux = moe_ffn_sharded(params, cfg, xl, mesh=mesh)
    dense, dense_aux = moe_ffn(params, cfg, xl)
    return {"c": c, "out": out.float().numpy(), "aux": float(aux),
            "local_dense": dense.float().numpy(),
            "local_aux": float(dense_aux)}


def sc_mesh_layout():
    """Mesh constructors on 8 ranks: coordinates, groups, JAX's errors."""
    from senweaver_ide_tpu_torch.parallel import MeshConfig, make_mesh
    from senweaver_ide_tpu_torch.parallel.comm import all_gather
    from senweaver_ide_tpu_torch.parallel.mesh import make_hybrid_mesh
    out = {}
    hy = make_hybrid_mesh(MeshConfig(dp=2, fsdp=2, tp=2), num_slices=2)
    out["axis_names"] = hy.axis_names
    out["devices"] = hy.devices.tolist()
    out["coords"] = coords_of(hy)
    out["data_group"] = all_gather(torch.tensor([hy.rank]), hy,
                                   ("dp", "fsdp"), 0).tolist()
    out["tp_group"] = all_gather(torch.tensor([hy.rank]), hy, "tp",
                                 0).tolist()
    errs = []
    for cfg, n in ((MeshConfig(dp=3, fsdp=2), 6), (MeshConfig(dp=2), 8)):
        try:
            make_hybrid_mesh(cfg, num_slices=2, devices=list(range(n)))
        except ValueError as e:
            errs.append(str(e))
    out["errors"] = errs
    try:
        make_mesh(MeshConfig(tp=4), devices=[0, 1])
    except ValueError as e:
        out["needs"] = str(e)
    return out


# ---- tests/test_torch_mesh_train.py ----

def sc_train(np_params, cfg_name, cfg_over, kind, sizes, batch, *,
             accum=1, steps=1, lr=1e-3, num_groups=None, lora_np=None,
             qlora=False, ranks=None, grads=False):
    """``steps`` mesh train steps on this rank's part of ``batch``; every
    rank's metrics per step and, from rank 0, the gathered params (the
    adapters for a LoRA run) and, with ``grads``, the first step's
    gathered gradients."""
    from senweaver_ide_tpu_torch.models.quantize import \
        quantize_weights_int8
    from senweaver_ide_tpu_torch.parallel import gather_params, shard_params
    from senweaver_ide_tpu_torch.training import (make_train_state,
                                                  place_batch_for_mesh,
                                                  train_step)
    mesh = mesh_of(kind, sizes, ranks)
    if not mesh.is_member:
        return None
    cfg = config(cfg_name, **cfg_over)
    full = tparams(np_params)
    base = None
    if lora_np is not None:
        if qlora:
            full = quantize_weights_int8(full)
        base = shard_params(full, mesh)
        state = make_train_state(cfg, mesh=mesh, params=tparams(lora_np),
                                 learning_rate=lr)
    else:
        state = make_train_state(cfg, mesh=mesh, params=full,
                                 learning_rate=lr)
    toks, mask, rew, gids, old = place_batch_for_mesh(
        mesh, batch["tokens"], batch["mask"], batch["rewards"],
        batch["group_ids"], batch.get("old_logp"), accum_steps=accum,
        device="cpu")
    first = None
    if grads:
        from senweaver_ide_tpu_torch.training import grpo_gradients
        g, _ = grpo_gradients(state.params, cfg, toks, mask, rew, gids,
                              old_logp=old, accum_steps=accum,
                              num_groups=num_groups, lora_base=base,
                              mesh=mesh)
        first = gather_params(g, mesh)
    hist = []
    for _ in range(steps):
        state, metrics = train_step(state, cfg, mesh, toks, mask, rew, gids,
                                    old_logp=old, accum_steps=accum,
                                    num_groups=num_groups, lora_base=base)
        hist.append({k: float(v) for k, v in metrics.items()})
    after = gather_params(state.params, mesh)
    layers = state.params["layers"]
    lead = mesh.rank == 0
    return {"metrics": hist,
            "local_shape": tuple(layers.get("w_gate", layers[next(iter(
                layers))]).shape),
            "params": np_tree(after) if lead else None,
            "grads": np_tree(first) if lead and grads else None}


def sc_place_batch(kind, sizes, batch, accum):
    """This rank's part of a placed batch, with its coordinates."""
    from senweaver_ide_tpu_torch.training import place_batch_for_mesh
    mesh = mesh_of(kind, sizes)
    if not mesh.is_member:
        return None
    out = place_batch_for_mesh(mesh, batch["tokens"], batch["mask"],
                               batch["rewards"], batch["group_ids"],
                               batch["old_logp"], accum_steps=accum,
                               device="cpu")
    return {"coords": coords_of(mesh),
            "arrays": [a.numpy() for a in out]}


# ---- tests/test_torch_mesh_engine.py ----

def sc_engine(np_params, cfg_name, kind, sizes, prompts, new_tokens, *,
              int8=False, publish_np=None, prefix=None, cfg_over=None):
    """A mesh engine, greedy, on every rank alike: each request's tokens
    and log-probs, the layout it fell back to, the local cache's heads;
    with ``publish_np`` a second wave after ``update_params``; with
    ``prefix`` a request through a registered prefix and the exported
    prefix's KV heads."""
    from senweaver_ide_tpu_torch.models.quantize import (
        is_quantized, quantize_weights_int8)
    from senweaver_ide_tpu_torch.rollout import RolloutEngine
    from senweaver_ide_tpu_torch.rollout.sampler import SampleParams
    mesh = mesh_of(kind, sizes)
    if not mesh.is_member:
        return None
    cfg = config(cfg_name, **(cfg_over or {}))
    params = tparams(np_params)
    if int8:
        params = quantize_weights_int8(params)
    eng = RolloutEngine(params, cfg, num_slots=4, max_len=64,
                        sample=SampleParams(0.0, 0, 1.0), seed=3, mesh=mesh,
                        device="cpu")

    def wave():
        rids = [eng.submit(p, max_new_tokens=new_tokens) for p in prompts]
        eng.run()
        return [(eng.result(r), eng.result_logps(r)) for r in rids]

    out = {"layout": (eng.kv_layout, eng.kv_layout_fallback),
           "cache_heads": int(eng.cache.k.shape[3]), "first": wave()}
    if prefix is not None:
        pid = eng.register_prefix(prefix)
        rid = eng.submit(prefix + [7, 9], max_new_tokens=new_tokens,
                         prefix_id=pid)
        eng.run()
        out["prefix"] = (eng.result(rid), eng.result_logps(rid))
        out["export_heads"] = int(eng.export_prefix(pid)[1].k.shape[3])
    if publish_np is not None:
        eng.update_params(tparams(publish_np))
        out["quantized_after_publish"] = is_quantized(eng.params)
        out["second"] = wave()
    return out


class ScriptedSession:
    """A session for ``collect_group_trajectories`` on either package:
    each turn logs one (prompt, completion) call whose tokens depend only
    on the task and the session's number (serial collection numbers
    them in order), so both packages collect the same batch."""

    def __init__(self, n: int):
        self.n = n
        self.client = type("Client", (), {})()
        self.client.call_log = []
        self.client.engine = None

    def run_turn(self, task):
        base = 10 + 7 * self.n + len(task)
        self.client.call_log.append(
            ([base + i for i in range(6)],
             [(base * 3 + 5 * i) % 200 + 1 for i in range(4 + self.n % 3)]))
        from types import SimpleNamespace
        return SimpleNamespace(trace=None, loop=SimpleNamespace(steps=1))

    def close(self):
        pass


def scripted_sessions():
    count = [0]

    def make():
        count[0] += 1
        return ScriptedSession(count[0])
    return make


def reward_by_member(task_idx, g, session):
    return float(g) - 0.5 * task_idx


def sc_grpo_round(np_params, cfg_over, kind, sizes, tasks, group_size):
    """One ``grpo_round`` on the mesh: the lead rank collects, all train;
    every rank's metrics and episode count."""
    from senweaver_ide_tpu_torch.training import make_train_state
    from senweaver_ide_tpu_torch.training.rl_loop import grpo_round
    mesh = mesh_of(kind, sizes)
    if not mesh.is_member:
        return None
    cfg = config("tiny-test", **cfg_over)
    state = make_train_state(cfg, mesh=mesh, params=tparams(np_params),
                             learning_rate=1e-3)
    out = grpo_round(state, cfg, mesh, scripted_sessions(), tasks,
                     group_size=group_size, max_parallel=1,
                     reward_override=reward_by_member)
    return {"metrics": out.metrics, "episodes": len(out.episodes),
            "lead": mesh.coord(mesh.axis_names) == 0}


def sc_async(np_params, sizes, tasks, rounds, publish):
    """``AsyncGRPOTrainer`` on the mesh for ``rounds`` rounds (importance
    correction off: each round's ratio is 1 at its own params); every
    rank's metrics, and the weights the lead rank published last."""
    from senweaver_ide_tpu_torch.training import make_train_state
    from senweaver_ide_tpu_torch.training.async_loop import AsyncGRPOTrainer
    mesh = mesh_of("mesh", sizes)
    if not mesh.is_member:
        return None
    cfg = config("tiny-test")
    state = make_train_state(cfg, mesh=mesh, params=tparams(np_params),
                             learning_rate=1e-3)
    published = []
    trainer = AsyncGRPOTrainer(
        state, cfg, mesh, scripted_sessions(), tasks, group_size=2,
        pad_id=0, max_len=64, reward_override=reward_by_member,
        max_parallel=1, importance_correction=False,
        publish_params=published.append if publish else None)
    results = trainer.run(rounds)
    last = None
    if published and mesh.coord(mesh.axis_names) == 0:
        last = np_tree(published[-1])
    return {"metrics": [r.metrics for r in results],
            "published": len(published), "last": last}


def sc_streaming_adapter(np_params, sizes, waves, lr):
    """StreamingTrainerAdapter.train_on_batch on the mesh, each wave's
    behaviour log-probs recomputed from the cached version its episodes
    name (this rank's rows of the padded batch); every rank's metrics."""
    from senweaver_ide_tpu_torch.training import make_train_state
    from senweaver_ide_tpu_torch.training.experience import (
        StreamedEpisode, StreamingTrainerAdapter)
    mesh = mesh_of("mesh", sizes)
    if not mesh.is_member:
        return None
    cfg = config("tiny-test")
    state = make_train_state(cfg, mesh=mesh, params=tparams(np_params),
                             learning_rate=lr)
    t = StreamingTrainerAdapter(state, cfg, mesh, max_len=64,
                                behavior_cache_size=4)
    out = []
    for i, rows in enumerate(waves):
        out.append(t.train_on_batch([StreamedEpisode(**r) for r in rows]))
        t.note_published(i + 1)
    return out


# ---- tests/test_torch_parallel.py: MoE over data axes, pipelines ----

def sc_moe_forward(np_params, cfg_over, sizes, tokens):
    """This rank's block of an MoE ``forward(mesh=)``'s logits, its aux
    loss, and the mesh=None logits and aux of the whole batch."""
    from senweaver_ide_tpu_torch.models.transformer import forward
    from senweaver_ide_tpu_torch.parallel import data_sharding, shard_params
    mesh = mesh_of("mesh", sizes)
    if not mesh.is_member:
        return None
    cfg = config("tiny-moe-test", **cfg_over)
    full = tparams(np_params)
    toks = torch.from_numpy(tokens).long()
    with torch.no_grad():
        logits, _, aux = forward(shard_params(full, mesh), cfg,
                                 data_sharding(mesh).local(toks),
                                 mesh=mesh, with_aux=True)
        one, _, one_aux = forward(full, cfg, toks, with_aux=True)
    return {"coords": coords_of(mesh), "logits": logits.numpy(),
            "aux": float(aux), "one": one.numpy(), "one_aux": float(one_aux)}


def _pp_mesh(pp, dp=1):
    """pp stages on the first ranks; with ``dp`` > 1 a dp x pp mesh."""
    sizes = {"dp": dp, "pp": pp} if dp > 1 else {"pp": pp}
    return mesh_of("named", sizes, ranks=list(range(dp * pp)))


def _pp_params(np_params, pp, split_np=None):
    """This stage's placed params: from JAX's split tree when given, else
    split here."""
    from senweaver_ide_tpu_torch.parallel import (place_pipeline_params,
                                                  split_layers_for_stages)
    mesh = _pp_mesh(pp)
    if not mesh.is_member:
        return mesh, None
    tree = (tparams(split_np) if split_np is not None
            else split_layers_for_stages(tparams(np_params), pp))
    return mesh, place_pipeline_params(tree, mesh)


def sc_pp_forward(np_params, pp, tokens, n_micro, mask=None, split_np=None):
    """``pipeline_forward``'s logits on this rank, and its stage's layer
    tensors (the split tree's, or the port's split of the full tree)."""
    from senweaver_ide_tpu_torch.parallel import pipeline_forward
    mesh, params = _pp_params(np_params, pp, split_np)
    if not mesh.is_member:
        return None
    with torch.no_grad():
        logits = pipeline_forward(
            params, config("tiny-test"), torch.from_numpy(tokens), mesh=mesh,
            n_microbatches=n_micro,
            attn_mask=None if mask is None else torch.from_numpy(mask))
    return {"stage": mesh.coord("pp"), "logits": logits.numpy(),
            "layers": np_tree(params["layers"])}


def sc_pp_grad_flow(np_params, pp, tokens, n_micro):
    """The gradients of mean(pipeline_forward(...)) on this rank: its
    stage's layers and the replicated tensors."""
    from senweaver_ide_tpu_torch.parallel import pipeline_forward
    from senweaver_ide_tpu_torch.training.trainer import (flatten_params,
                                                          unflatten_params)
    mesh, params = _pp_params(np_params, pp)
    if not mesh.is_member:
        return None
    pairs = [(n, t.requires_grad_()) for n, t in flatten_params(params)]
    pipeline_forward(params, config("tiny-test"), torch.from_numpy(tokens),
                     mesh=mesh, n_microbatches=n_micro).mean().backward()
    grads = unflatten_params((n, t.grad) for n, t in pairs)
    return {"stage": mesh.coord("pp"), "grads": np_tree(grads),
            "layers": sum(float(g.abs().sum())
                          for g in grads["layers"].values()),
            "finite": all(bool(torch.isfinite(t.grad).all())
                          for _, t in pairs)}


def sc_pp_steps(np_params, cfg_over, pp, batch, n_micro, schedules, *,
                steps=1, lr=1e-3, num_groups=None, dp=1):
    """``steps`` pp_train_steps per schedule, each from a fresh state, on
    pp stages (over a dp x pp mesh with ``dp`` > 1): every step's metrics
    and the updated params (stage split undone) from the first rank."""
    from senweaver_ide_tpu_torch.parallel import (make_pp_train_state,
                                                  pp_train_step)
    from senweaver_ide_tpu_torch.parallel.pipeline import \
        gather_pipeline_params
    mesh = _pp_mesh(pp, dp)
    if not mesh.is_member:
        return None
    cfg = config("tiny-test", **cfg_over)
    out = {}
    for schedule in schedules:
        state = make_pp_train_state(cfg, mesh=mesh, params=tparams(np_params),
                                    learning_rate=lr, device="cpu")
        hist = []
        for _ in range(steps):
            state, m = pp_train_step(
                state, cfg, mesh, batch["tokens"], batch["mask"],
                batch["rewards"], batch["group_ids"],
                n_microbatches=n_micro, schedule=schedule,
                num_groups=num_groups)
            hist.append({k: float(v) for k, v in m.items()})
        full = gather_pipeline_params(state.params, mesh)
        full["layers"] = {n: v.reshape((-1,) + tuple(v.shape[2:]))
                          for n, v in full["layers"].items()}
        out[schedule] = {"metrics": hist, "step": state.step,
                         "params": np_tree(full) if mesh.rank == 0 else None}
    try:
        pp_train_step(state, cfg, mesh, batch["tokens"], batch["mask"],
                      batch["rewards"], batch["group_ids"],
                      schedule="interleaved-nope")
    except ValueError as e:
        out["unknown"] = str(e)
    return out
