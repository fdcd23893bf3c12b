"""The port's GRPO train step on meshes against the JAX package's on the
same meshes, and against the port's own ``mesh=None`` step: dp2/fsdp2,
tp2, the hybrid dp2/fsdp2/tp2 mesh, sp2 with ring attention, with
accumulation and remat; LoRA and QLoRA on tp; the MoE step over ep × tp;
``place_batch_for_mesh``'s rows and padding; a size-1 mesh bit for bit;
two processes initialized from torchrun's environment variables.

The port's ranks run in a pool of gloo processes (``torch_mesh_pool``);
JAX runs here on the 8 virtual CPU devices of ``conftest.py``."""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_pool as tmp
from senweaver_ide_tpu.models import get_config as jget_config
from senweaver_ide_tpu.models import init_params as jax_init_params
from senweaver_ide_tpu.models import tiny_test as jax_tiny_test
from senweaver_ide_tpu.models.quantize import quantize_weights_int8
from senweaver_ide_tpu.parallel import MeshConfig as JMeshConfig
from senweaver_ide_tpu.parallel import make_mesh as jmake_mesh
from senweaver_ide_tpu.parallel import make_named_mesh as jnamed
from senweaver_ide_tpu.parallel.mesh import make_hybrid_mesh as jhybrid
from senweaver_ide_tpu.training import data as jdata
from senweaver_ide_tpu.training import lora as jlora
from senweaver_ide_tpu.training import trainer as jtr
from senweaver_ide_tpu_torch.models import params_from_numpy
from senweaver_ide_tpu_torch.models import config as tconfig
from senweaver_ide_tpu_torch.parallel import single_device_mesh
from senweaver_ide_tpu_torch.training import data as tdata
from senweaver_ide_tpu_torch.training import trainer as ttr

LR = 1e-3
# the first step's metrics: one fp32 loss through two frameworks' forward
# and backward, and through a sharded and an unsharded port step
# (tests/test_torch_trainer.py's bound, within the slice's 1e-4 relative)
STEP_ATOL = STEP_RTOL = 1e-5
# Adam's first steps are sign-like (u = g / (|g| + eps)): where |g| is
# within a few eps of 0, an fp32 rounding difference moves an element by
# up to one step of lr; tests/test_torch_trainer.py's bound
PARAM_ATOL = 0.25 * LR


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def pool():
    p = tmp.RankPool(8)
    yield p
    p.close()


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _batch(seed=0, cfg=None, b=8, s=12):
    """tests/test_accum_hybrid.py's batch."""
    rng = np.random.default_rng(seed)
    cfg = cfg or jax_tiny_test()
    mask = rng.random((b, s)) < 0.7
    mask[:, 0] = True
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(
                np.int32),
            "mask": mask,
            "rewards": rng.normal(size=(b,)).astype(np.float32),
            "group_ids": np.repeat(np.arange(b // 2), 2).astype(np.int32)}


def _jmesh(kind, sizes):
    n = int(np.prod(list(sizes.values())))
    devs = jax.devices()[:n]
    if kind == "mesh":
        return jmake_mesh(JMeshConfig(**sizes), devices=devs)
    if kind == "hybrid":
        return jhybrid(JMeshConfig(**sizes), num_slices=2, devices=devs)
    return jnamed(sizes, devices=devs)


def _jax_steps(cfg, params, kind, sizes, batch, accum, steps=1,
               lora=None, sgd=False):
    """JAX's step(s) on its mesh, from its own padded placement; with
    ``sgd`` the update is params − grads (optax.sgd(1.0)), so the
    gradients are the difference."""
    mesh = _jmesh(kind, sizes)
    toks, mask, rew, gids, _ = jdata.place_batch_for_mesh(
        mesh, batch["tokens"], batch["mask"], batch["rewards"],
        batch["group_ids"], accum_steps=accum)
    if sgd:
        import optax
        opt = optax.sgd(1.0)
        state = jtr.TrainState(params=params, opt_state=opt.init(params),
                               step=jnp.zeros((), jnp.int32), opt=opt)
    elif lora is None:
        state = jtr.make_train_state(cfg, None, mesh, params=params,
                                     learning_rate=LR)
    else:
        state = jtr.TrainState(params=lora[0], opt_state=jtr.make_optimizer(
            LR).init(lora[0]), step=jnp.zeros((), jnp.int32),
            opt=jtr.make_optimizer(LR))
    hist = []
    for _ in range(steps):
        state, m = jtr.train_step(state, cfg, mesh, toks, mask, rew, gids,
                                  accum_steps=accum,
                                  lora_base=None if lora is None
                                  else lora[1])
        hist.append({k: float(v) for k, v in m.items()})
    return state, hist, (np.asarray(toks), np.asarray(mask),
                         np.asarray(rew), np.asarray(gids))


def _port_none_steps(tcfg, params_np, placed, accum, steps=1, lora=None):
    """The port's mesh=None step(s) on JAX's padded batch."""
    if lora is None:
        state = ttr.make_train_state(tcfg, params=params_from_numpy(
            params_np, device="cpu"), learning_rate=LR)
        base = None
    else:
        state = ttr.make_train_state(tcfg, params=params_from_numpy(
            lora[0], device="cpu"), learning_rate=LR)
        base = lora[1]
    toks, mask, rew, gids, _ = tdata.place_batch_for_mesh(
        None, *placed, accum_steps=accum, device="cpu")
    hist = []
    for _ in range(steps):
        state, m = ttr.train_step(state, tcfg, None, toks, mask, rew, gids,
                                  accum_steps=accum, lora_base=base)
        hist.append({k: float(v) for k, v in m.items()})
    return state, hist


def _close_metrics(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=STEP_ATOL,
                                   rtol=STEP_RTOL, err_msg=k)


def _close_tree(got_np, want, atol=PARAM_ATOL):
    for path, leaf in jax.tree_util.tree_leaves_with_path(want):
        node = got_np
        for p in path:
            node = node[p.key]
        np.testing.assert_allclose(node, np.asarray(leaf, np.float32),
                                   atol=atol, err_msg=str(path))


# the MoE case's gradients against JAX's: fp32 sums through two
# frameworks (the metrics' bound), and JAX's read back as params − params
# after one sgd(1.0) step, exact to the params' fp32 rounding (~1e-8)
GRAD_ATOL = GRAD_RTOL = 1e-5


@pytest.mark.parametrize("kind,sizes,accum,over", [
    ("mesh", {"dp": 2, "fsdp": 2}, 2, {"remat": True}),
    ("mesh", {"tp": 2}, 1, {}),
    ("hybrid", {"dp": 2, "fsdp": 2, "tp": 2}, 2, {}),
    ("mesh", {"sp": 2}, 1, {"attn_impl": "ring", "remat": True}),
    ("mesh", {"dp": 2}, 1, {"config": "tiny-moe-test"}),
])
def test_mesh_train_step_matches_jax_and_unsharded(pool, kind, sizes,
                                                   accum, over):
    """One step on each mesh: the loss and every metric equal on every
    rank and within the bound of JAX's step on the same mesh and of the
    port's mesh=None step; the gathered params after the step within
    Adam's sign-step bound of both (tests/test_accum_hybrid.py:94, :175;
    the sp mesh pads S−1 to a multiple of 2). The tiny-moe-test case on
    dp=2 routes the global batch (capacity 1.25, drops present): its
    metrics include ``moe_aux``, and every gradient tensor is held
    against JAX's (JAX's step there is sgd(1.0), so its params are held
    to the port's mesh=None step alone)."""
    over = dict(over)
    name = over.pop("config", "tiny-test")
    moe = name != "tiny-test"
    jcfg = dataclasses.replace(jget_config(name), **over)
    params = jax_init_params(jcfg, jax.random.PRNGKey(2))
    batch = _batch()
    jstate, jhist, placed = _jax_steps(jcfg, params, kind, sizes, batch,
                                       accum, sgd=moe)
    # one rank attends the whole sequence: the ring's function is einsum's
    tcfg = dataclasses.replace(tmp.config(name), **dict(
        over, attn_impl="einsum"))
    nstate, nhist = _port_none_steps(tcfg, _np(params), placed, accum)
    outs = pool.run(tmp.sc_train, _np(params), name, over, kind,
                    sizes, batch, accum=accum, grads=moe)
    members = [o for o in outs if o is not None]
    assert len(members) == int(np.prod(list(sizes.values())))
    for o in members:
        assert o["metrics"] == members[0]["metrics"]     # equal on ranks
    got = members[0]["metrics"][0]
    _close_metrics(got, jhist[0])
    _close_metrics(got, nhist[0])
    if moe:
        want = jax.tree_util.tree_map(lambda a, b: np.asarray(a - b),
                                      _np(params), _np(jstate.params))
        for path, leaf in jax.tree_util.tree_leaves_with_path(want):
            node = outs[0]["grads"]
            for p in path:
                node = node[p.key]
            np.testing.assert_allclose(node, leaf, atol=GRAD_ATOL,
                                       rtol=GRAD_RTOL, err_msg=str(path))
    else:
        _close_tree(outs[0]["params"], _np(jstate.params))
    _close_tree(outs[0]["params"], {k: (v if not isinstance(v, dict) else
                                        {kk: vv.numpy() for kk, vv in
                                         v.items()})
                                    for k, v in nstate.params.items()
                                    if not isinstance(v, dict)} | {
        "layers": {k: v.numpy() for k, v in
                   nstate.params["layers"].items()}})


@pytest.mark.parametrize("qlora", [False, True])
def test_lora_and_qlora_step_on_tp_matches_jax(pool, qlora):
    """Two LoRA steps (rank 4, all seven targets) on a tp=2 mesh, over an
    fp32 base and over its int8 quantization (QLoRA): metrics against
    JAX's steps and the port's mesh=None steps, the adapters after."""
    jcfg = jax_tiny_test()
    params = jax_init_params(jcfg, jax.random.PRNGKey(4))
    targets = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
    lora = jlora.init_lora(jcfg, jax.random.PRNGKey(5), rank=4,
                           targets=targets)
    base = quantize_weights_int8(params) if qlora else params
    batch = _batch(1)
    jstate, jhist, placed = _jax_steps(jcfg, params, "mesh", {"tp": 2},
                                       batch, 1, steps=2,
                                       lora=(lora, base))
    tbase = params_from_numpy(_np(base), device="cpu")
    nstate, nhist = _port_none_steps(tconfig.tiny_test(), None, placed, 1,
                                     steps=2, lora=(_np(lora), tbase))
    outs = pool.run(tmp.sc_train, _np(params), "tiny-test", {}, "mesh",
                    {"tp": 2}, batch, steps=2, lora_np=_np(lora),
                    qlora=qlora, ranks=[0, 1])
    assert outs[0]["metrics"] == outs[1]["metrics"]
    for step in range(2):
        _close_metrics(outs[0]["metrics"][step], jhist[step])
        _close_metrics(outs[0]["metrics"][step], nhist[step])
    _close_tree(outs[0]["params"], _np(jstate.params))


def test_moe_train_step_on_ep_tp_mesh(pool):
    """tests/test_model.py:208 on the port: the MoE step over ep=2 × tp=2
    (banks split over ep, expert columns over tp), against JAX's step on
    that mesh and the port's mesh=None step."""
    jcfg = jget_config("tiny-moe-test")
    params = jax_init_params(jcfg, jax.random.PRNGKey(0))
    batch = _batch(2, jcfg, b=4, s=16)
    sizes = {"ep": 2, "tp": 2}
    jstate, jhist, placed = _jax_steps(jcfg, params, "named", sizes, batch,
                                       1)
    nstate, nhist = _port_none_steps(tconfig.tiny_moe_test(), _np(params),
                                     placed, 1)
    outs = pool.run(tmp.sc_train, _np(params), "tiny-moe-test", {}, "named",
                    sizes, batch, ranks=[0, 1, 2, 3])
    members = outs[:4]
    assert all(o["metrics"] == members[0]["metrics"] for o in members)
    # banks: (L, E/ep, D, F/tp) on each rank
    assert members[0]["local_shape"] == (2, 2, 64, 64)
    _close_metrics(members[0]["metrics"][0], jhist[0])
    _close_metrics(members[0]["metrics"][0], nhist[0])
    _close_tree(outs[0]["params"], _np(jstate.params))


def test_place_batch_rows_and_padding(pool):
    """tests/test_accum_hybrid.py:187's contract: S−1 padded to a multiple
    of sp with old_logp's columns, the rows to a multiple of the data
    ranks × accum_steps; each rank holds its rows of every microbatch and
    its sequence chunk (plus the next token)."""
    b, s, accum = 4, 32, 3
    rng = np.random.default_rng(3)
    batch = {"tokens": rng.integers(1, 500, (b, s)).astype(np.int32),
             "mask": np.ones((b, s), bool),
             "rewards": np.arange(b, dtype=np.float32),
             "group_ids": np.arange(b, dtype=np.int32),
             "old_logp": np.full((b, s - 1), -0.5, np.float32)}
    sizes = {"dp": 2, "sp": 2}
    full = tdata.pad_batch_for_mesh(batch["tokens"], batch["mask"],
                                    batch["rewards"], batch["group_ids"],
                                    batch_multiple=6, seq_multiple=2)
    assert full[0].shape == (6, 33)                 # lcm(2, 3) rows here
    outs = pool.run(tmp.sc_place_batch, "mesh", sizes, batch, accum)
    for o in outs[:4]:
        toks, mask, rew, gids, old = o["arrays"]
        d, c = o["coords"]["dp"], o["coords"]["sp"]
        assert toks.shape == (3, 17) and old.shape == (3, 16)
        rows = [i * 2 + d for i in range(accum)]     # mb 2, 1 row each
        np.testing.assert_array_equal(toks, full[0][rows, c * 16:c * 16
                                                    + 17])
        np.testing.assert_array_equal(rew, full[2][rows])
        pad_old = np.pad(batch["old_logp"], ((0, 2), (0, 1)))
        np.testing.assert_array_equal(old, pad_old[rows, c * 16:c * 16 + 16])
        assert not mask[[r for r, g in enumerate(rows) if g >= b]].any()


def test_size_one_mesh_is_bit_equal_to_no_mesh():
    """A one-rank mesh's step (this process, no process group) equals the
    mesh=None step bit for bit: loss, metrics, params and moments."""
    cfg = dataclasses.replace(tconfig.tiny_test(), remat=True)
    params = jax_init_params(jax_tiny_test(), jax.random.PRNGKey(6))
    batch = _batch(4)
    placed = tdata.place_batch_for_mesh(None, batch["tokens"],
                                        batch["mask"], batch["rewards"],
                                        batch["group_ids"], accum_steps=2,
                                        device="cpu")
    mesh = single_device_mesh()
    runs = []
    for m in (None, mesh):
        st = ttr.make_train_state(cfg, mesh=m, params=params_from_numpy(
            _np(params), device="cpu"), learning_rate=LR)
        st, met = ttr.train_step(st, cfg, m, *placed[:4], accum_steps=2)
        runs.append((st, met))
    (s0, m0), (s1, m1) = runs
    assert {k: float(v) for k, v in m0.items()} == \
        {k: float(v) for k, v in m1.items()}
    for (n, a), (_, b2) in zip(ttr.flatten_params(s0.params),
                               ttr.flatten_params(s1.params)):
        assert torch.equal(a, b2), n
    for (n, a), (_, b2) in zip(ttr.flatten_params(s0.opt_state.nu),
                               ttr.flatten_params(s1.opt_state.nu)):
        assert torch.equal(a, b2), n


_CHILD = r"""
import json, os, sys
import numpy as np
import torch
torch.set_num_threads(1)
from senweaver_ide_tpu_torch.parallel.distributed import (
    DistributedConfig, initialize, make_named_mesh)
from senweaver_ide_tpu_torch.models import tiny_test
from senweaver_ide_tpu_torch.training import (make_train_state,
                                              place_batch_for_mesh,
                                              train_step)
import torch.distributed as dist
# torchrun's variables; the CPU device's backend is gloo
initialize(DistributedConfig(device="cpu"))
initialize(DistributedConfig(device="cpu"))       # idempotent
mesh = make_named_mesh({"dp": 2})
cfg = tiny_test()
state = make_train_state(cfg, torch.Generator().manual_seed(0), mesh,
                         learning_rate=1e-3, device="cpu")
rng = np.random.RandomState(0)
B, S = 8, 16
placed = place_batch_for_mesh(
    mesh, rng.randint(0, 512, (B, S)).astype(np.int32), np.ones((B, S), bool),
    np.linspace(-1.0, 1.0, B).astype(np.float32),
    (np.arange(B) // 2).astype(np.int32), device="cpu")
state, metrics = train_step(state, cfg, mesh, *placed[:4])
print(json.dumps({"rank": dist.get_rank(), "world": dist.get_world_size(),
                  "backend": dist.get_backend(), "step": state.step,
                  "loss": float(metrics["loss"]),
                  "grad_norm": float(metrics["grad_norm"]),
                  "wq_sum": float(state.params["layers"]["wq"].sum())}),
      flush=True)
"""


def test_two_process_initialize_from_torchrun_env(tmp_path):
    """tests/test_distributed.py:102 on the port: two processes given
    torchrun's MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK initialize
    (gloo, the CPU device's backend), build a dp=2 mesh and take
    one step whose loss, gradient norm and updated params agree bit for
    bit across them."""
    child = tmp_path / "child.py"
    child.write_text(_CHILD)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    port = tmp.free_port()
    procs = []
    for r in range(2):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   WORLD_SIZE="2", RANK=str(r), LOCAL_RANK=str(r),
                   PYTHONPATH=root + os.pathsep + os.environ.get(
                       "PYTHONPATH", ""))
        procs.append(subprocess.Popen(
            [sys.executable, str(child)], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, env=env))
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("distributed processes timed out")
        assert p.returncode == 0, err[-3000:]
        outs.append(json.loads([ln for ln in out.splitlines()
                                if ln.startswith("{")][-1]))
    assert sorted(o["rank"] for o in outs) == [0, 1]
    assert all(o["world"] == 2 and o["backend"] == "gloo" and o["step"] == 1
               for o in outs)
    for k in ("loss", "grad_norm", "wq_sum"):
        assert outs[0][k] == outs[1][k]


def _jax_round(cfg, params, mesh, tasks, group_size):
    from senweaver_ide_tpu.training.rl_loop import grpo_round as jround
    state = jtr.make_train_state(cfg, None, mesh, params=params,
                                 learning_rate=LR)
    return jround(state, cfg, mesh, tmp.scripted_sessions(), tasks,
                  group_size=group_size, max_parallel=1,
                  reward_override=tmp.reward_by_member)


def test_grpo_round_and_async_trainer_on_meshes(pool):
    """tests/test_parallel_rollout.py:99 and tests/test_async_loop.py:121
    on the port. A grpo_round over a dp2/fsdp2/sp2 mesh with ring
    attention (S−1 padded to a multiple of sp): the lead rank collects
    scripted sessions and broadcasts them, every rank reports the same
    metrics, within the step bound of JAX's round on the same mesh over
    the same sessions. Then AsyncGRPOTrainer over dp2/fsdp2 for two
    rounds: every rank's metrics equal, round by round within the bounds
    of JAX's trainer and of the port's mesh=None trainer, and the lead
    rank publishes gathered full weights equal to the mesh=None run's."""
    from senweaver_ide_tpu.training.async_loop import \
        AsyncGRPOTrainer as JAsync
    from senweaver_ide_tpu_torch.training.async_loop import AsyncGRPOTrainer
    params = jax_init_params(jax_tiny_test(), jax.random.PRNGKey(7))
    tasks = ["fix the bug", "add a test"]
    jcfg = dataclasses.replace(jax_tiny_test(), attn_impl="ring")
    jout = _jax_round(jcfg, params, _jmesh("mesh", {"dp": 2, "fsdp": 2,
                                                    "sp": 2}), tasks, 2)
    outs = pool.run(tmp.sc_grpo_round, _np(params), {"attn_impl": "ring"},
                    "mesh", {"dp": 2, "fsdp": 2, "sp": 2}, tasks, 2)
    assert [o["lead"] for o in outs] == [True] + [False] * 7
    for o in outs:
        assert o["episodes"] == len(jout.episodes) == 4
        assert o["metrics"] == outs[0]["metrics"]
    _close_metrics(outs[0]["metrics"], {k: float(v)
                                        for k, v in jout.metrics.items()})

    jmesh = _jmesh("mesh", {"dp": 2, "fsdp": 2})
    jtrainer = JAsync(jtr.make_train_state(jax_tiny_test(), None, jmesh,
                                           params=params, learning_rate=LR),
                      jax_tiny_test(), jmesh, tmp.scripted_sessions(), tasks,
                      group_size=2, pad_id=0, max_len=64,
                      reward_override=tmp.reward_by_member, max_parallel=1,
                      importance_correction=False)
    jres = jtrainer.run(2)
    published = []
    ttrainer = AsyncGRPOTrainer(
        ttr.make_train_state(tconfig.tiny_test(), params=params_from_numpy(
            _np(params), device="cpu"), learning_rate=LR),
        tconfig.tiny_test(), None, tmp.scripted_sessions(), tasks,
        group_size=2, pad_id=0, max_len=64,
        reward_override=tmp.reward_by_member, max_parallel=1,
        importance_correction=False, publish_params=published.append)
    tres = ttrainer.run(2)
    outs = pool.run(tmp.sc_async, _np(params), {"dp": 2, "fsdp": 2}, tasks,
                    2, True)
    for o in outs[:4]:
        assert o["metrics"] == outs[0]["metrics"]
    # the lead rank publishes (latest wins at round boundaries; the last
    # publish carries the final weights); the others never call it
    assert outs[0]["published"] >= 2
    assert [o["published"] for o in outs[1:4]] == [0, 0, 0]
    for rnd in range(2):
        tol = STEP_ATOL if rnd == 0 else 5e-4
        for want in (jres[rnd].metrics, tres[rnd].metrics):
            got = outs[0]["metrics"][rnd]
            assert sorted(got) == sorted(want)
            for k in want:
                np.testing.assert_allclose(got[k], float(want[k]), atol=tol,
                                           rtol=tol, err_msg=f"{rnd} {k}")
    last = outs[0]["last"]
    for name, t in ttr.flatten_params(published[-1]):
        node = last
        for p in name.split("/"):
            node = node[p]
        np.testing.assert_allclose(node, t.numpy(), atol=PARAM_ATOL,
                                   err_msg=name)


def test_streaming_adapter_recomputes_on_a_mesh(pool):
    """StreamingTrainerAdapter over a dp2 x tp2 mesh: two waves of streamed
    episodes without recorded log-probs, the second mixing two behaviour
    versions, each recomputed on this rank's rows of the batch; every
    rank's metrics equal, and within the step bounds of the mesh=None
    adapter on the same episodes (tests/test_torch_streaming.py holds that
    one to JAX's)."""
    from senweaver_ide_tpu_torch.training.experience import (
        StreamedEpisode, StreamingTrainerAdapter)
    params = _np(jax_init_params(jax_tiny_test(), jax.random.PRNGKey(8)))
    rs = np.random.default_rng(9)
    waves = []
    for w in range(2):
        waves.append([dict(episode_id=f"s/w{w}/i{i}", group_key=f"s/g{i // 2}",
                           prompt_ids=[3, 4, 5 + i],
                           completion_ids=[int(x) for x in
                                           rs.integers(1, 200, 4 + i)],
                           reward=float((i + w) % 3), epoch=0,
                           version=(i % 2) * w)
                      for i in range(8)])
    ref = StreamingTrainerAdapter(
        ttr.make_train_state(tconfig.tiny_test(), params=params_from_numpy(
            params, device="cpu"), learning_rate=LR),
        tconfig.tiny_test(), None, max_len=64, behavior_cache_size=4)
    want = []
    for i, rows in enumerate(waves):
        want.append(ref.train_on_batch([StreamedEpisode(**r) for r in rows]))
        ref.note_published(i + 1)
    outs = pool.run(tmp.sc_streaming_adapter, params, {"dp": 2, "tp": 2},
                    waves, LR)
    for o in outs[:4]:
        assert o == outs[0]
    for step, tol in ((0, STEP_ATOL), (1, 5e-4)):
        got = outs[0][step]
        assert sorted(got) == sorted(want[step])
        for k in want[step]:
            np.testing.assert_allclose(got[k], want[step][k], atol=tol,
                                       rtol=tol, err_msg=f"{step} {k}")
