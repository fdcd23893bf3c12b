"""The port's live migration of in-flight decodes against the JAX
package's, on the same weights (fp32 ``tiny_test`` bridged through
``params_from_numpy``, greedy, paged).

Mirrors the engine-level tests of tests/test_migration.py (its fleet,
coordinator and chaos cases wait for the port's serving layer): every
scenario runs on both packages and must give the same streams, the same
checkpoint contents (tokens, log-probs within 1e-4, KV lengths, block
size, flavour, adapter binding), the same shared ``stats()`` counters,
and leak-free block pools; every migrated decode must equal the decode
that never moved. Also, across the packages: a JAX checkpoint finishing on
a port engine and a port checkpoint finishing on a JAX engine, token-exact
(fp32 and the int8 ladder), and a bf16 payload whose raw ``uint16`` bits
on the port's wire equal JAX's ``ml_dtypes`` payload bit for bit.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from senweaver_ide_tpu import obs as jobs
from senweaver_ide_tpu.models import init_params as jax_init_params
from senweaver_ide_tpu.models import tiny_test as jax_tiny_test
from senweaver_ide_tpu.rollout import AdapterPool as JaxPool
from senweaver_ide_tpu.rollout import AdapterPoolConfig as JaxPoolConfig
from senweaver_ide_tpu.rollout import EngineConfig as JaxEngineConfig
from senweaver_ide_tpu.rollout import RolloutEngine as JaxEngine
from senweaver_ide_tpu.rollout import migration as jmig
from senweaver_ide_tpu.rollout.sampler import SampleParams as JaxSample
from senweaver_ide_tpu_torch import obs
from senweaver_ide_tpu_torch.models import params_from_numpy, tiny_test
from senweaver_ide_tpu_torch.rollout import (AdapterPool, AdapterPoolConfig,
                                             EngineConfig, RolloutEngine,
                                             SampleParams)
from senweaver_ide_tpu_torch.rollout import migration as tmig

PROMPT = [5, 9, 2, 7, 1, 3]
LOGP_ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny-model engine steps are thousands of small ops: with several
    pytest-xdist workers, torch's default thread pool in each of them
    oversubscribes the host's cores and spins, several times slower than
    one thread. The previous setting is restored for the next module."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _fresh_obs():
    obs._reset_for_tests()
    jobs._reset_for_tests()
    yield
    obs._reset_for_tests()
    jobs._reset_for_tests()


def _models(dtype=None):
    jcfg = jax_tiny_test()
    tcfg = tiny_test()
    if dtype is not None:
        jcfg = dataclasses.replace(jcfg, dtype=dtype[0])
        tcfg = dataclasses.replace(tcfg, dtype=dtype[1])
    jt = jax_init_params(jcfg, jax.random.PRNGKey(0))
    return dict(jt=jt, jcfg=jcfg, tcfg=tcfg,
                tt=params_from_numpy(jax.device_get(jt), device="cpu"))


@pytest.fixture(scope="module")
def models():
    return _models()


def _lora(cfg, seed=3, rank=4, scale=0.05):
    """Nonzero-B adapter as numpy arrays (init_lora's B = 0 would make the
    adapter parity vacuous)."""
    rng = np.random.default_rng(seed)
    dims = {"wq": (cfg.hidden_size, cfg.q_dim),
            "wk": (cfg.hidden_size, cfg.kv_dim),
            "wv": (cfg.hidden_size, cfg.kv_dim),
            "wo": (cfg.q_dim, cfg.hidden_size)}
    out = {}
    for t, (d_in, d_out) in dims.items():
        out[t + "_lora_a"] = (rng.standard_normal(
            (cfg.num_layers, d_in, rank)) * 2.0 / d_in ** 0.5).astype(
                np.float32)
        out[t + "_lora_b"] = (rng.standard_normal(
            (cfg.num_layers, rank, d_out)) * scale).astype(np.float32)
    return out


class Side:
    """One package's engine factory and migration module, so a scenario
    written once runs on both."""

    def __init__(self, name, m):
        self.name, self.m = name, m
        self.mig = jmig if name == "jax" else tmig

    def engine(self, num_slots=2, max_len=64, block_size=16,
               kv_dtype="bf16", pool=False, temperature=0.0, num_blocks=None):
        m = self.m
        if self.name == "jax":
            return JaxEngine(
                m["jt"], m["jcfg"], num_slots=num_slots, max_len=max_len,
                sample=JaxSample(temperature, 0, 1.0),
                adapter_pool=(JaxPool(m["jcfg"], JaxPoolConfig())
                              if pool else None),
                engine_config=JaxEngineConfig(
                    kv_layout="paged", block_size=block_size,
                    kv_dtype=kv_dtype, num_blocks=num_blocks))
        return RolloutEngine(
            m["tt"], m["tcfg"], num_slots=num_slots, max_len=max_len,
            sample=SampleParams(temperature, 0, 1.0),
            adapter_pool=(AdapterPool(m["tcfg"], AdapterPoolConfig(),
                                      device="cpu") if pool else None),
            engine_config=EngineConfig(block_size=block_size,
                                       kv_dtype=kv_dtype,
                                       num_blocks=num_blocks),
            device="cpu")

    def lora(self, **kw):
        arrs = _lora(self.m["tcfg"], **kw)
        if self.name == "jax":
            return {"layers": {k: jax.numpy.asarray(v)
                               for k, v in arrs.items()}}
        return {"layers": {k: torch.from_numpy(v) for k, v in arrs.items()}}

    def reference(self, prompt=PROMPT, max_new=12, **kw):
        eng = self.engine(**kw)
        rid = eng.submit(list(prompt), max_new_tokens=max_new)
        return eng.run()[rid]


def _ckpt_view(ck):
    """What must agree between the packages' checkpoints of one decode."""
    if ck is None:
        return None
    kv = None if ck.kv_k is None else tuple(np.shape(ck.kv_k))
    return (ck.format_version, ck.rid, ck.prompt, ck.tokens,
            ck.max_new_tokens, ck.eos_id, ck.preempt_count, ck.temperature,
            ck.top_k, ck.top_p, ck.adapter_id, ck.adapter_version,
            ck.kv_len, ck.block_size, kv, ck.kv_dtype, ck.hi_layers,
            ck.kv_k_scale is None)


def both(models, scenario, *args):
    """Run ``scenario(side, *args)`` on both packages; its returned dict's
    streams, checkpoints, stats and flags must agree."""
    out = {}
    for name in ("jax", "port"):
        out[name] = scenario(Side(name, models), *args)
    j, t = out["jax"], out["port"]
    assert sorted(t) == sorted(j)
    for k in j:
        if k.startswith("ckpt"):
            assert _ckpt_view(t[k]) == _ckpt_view(j[k]), k
            if t[k] is not None:
                np.testing.assert_allclose(t[k].logps, j[k].logps,
                                           atol=LOGP_ATOL)
        elif k.startswith("stats"):
            shared = sorted(set(t[k]) & set(j[k]))
            assert {s: t[k][s] for s in shared} == \
                {s: j[k][s] for s in shared}, k
        else:
            assert t[k] == j[k], k
    return t


# ---- token-exact checkpoint/restore, on both packages ---------------------------

def _any_step(S, steps):
    ref = S.reference()
    a, b = S.engine(), S.engine()
    rid = a.submit(PROMPT, max_new_tokens=12)
    for _ in range(steps):
        a.step()
    ckpt = a.checkpoint_request(rid)
    new_rid = b.restore_request(ckpt)
    released = a.release_request(rid)
    out = b.run()[new_rid]
    assert out == ref
    a._alloc.check_leaks()
    b._alloc.check_leaks()
    return dict(out=out, ckpt=ckpt, released=released, stats_a=a.stats(),
                stats_b=b.stats(), new_rid=new_rid)


@pytest.mark.parametrize("steps", [1, 3, 6, 10])
def test_migrated_decode_token_exact_at_any_step(models, steps):
    r = both(models, _any_step, steps)
    assert r["ckpt"].format_version == tmig.CHECKPOINT_FORMAT == 2
    assert r["stats_a"]["migrations_out"] == 1
    assert r["stats_b"]["migrations_in"] == 1
    assert r["released"] is True


def _recompute(S):
    ref = S.reference()
    a = S.engine()
    rid = a.submit(PROMPT, max_new_tokens=12)
    for _ in range(5):
        a.step()
    ckpt = a.checkpoint_request(rid)
    assert ckpt.kv_k is not None
    stripped = S.mig.DecodeCheckpoint.from_wire(
        {**ckpt.to_wire(), "kv_k": None, "kv_v": None, "kv_len": 0})
    a.release_request(rid)
    b = S.engine()
    new_rid = b.restore_request(stripped)
    out = b.run()[new_rid]
    assert out == ref
    b._alloc.check_leaks()
    return dict(out=out, ckpt=stripped, stats=b.stats())


def test_recompute_path_token_exact_without_kv_payload(models):
    r = both(models, _recompute)
    assert r["stats"]["kv_install_copies"] == 0


def _block_size_mismatch(S):
    ref = S.reference()
    a, b = S.engine(block_size=4), S.engine(block_size=8)
    rid = a.submit(PROMPT, max_new_tokens=12)
    for _ in range(4):
        a.step()
    ckpt = a.checkpoint_request(rid)
    a.release_request(rid)
    new_rid = b.restore_request(ckpt)
    out = b.run()[new_rid]
    assert out == ref
    a._alloc.check_leaks()
    b._alloc.check_leaks()
    return dict(out=out, ckpt=ckpt, stats=b.stats())


def test_block_size_mismatch_falls_back_to_recompute(models):
    assert both(models, _block_size_mismatch)["stats"][
        "kv_install_copies"] == 0


def _kv_dtype_fence(S):
    ref = S.reference(kv_dtype="int8", block_size=4)
    a = S.engine(kv_dtype="int8", block_size=4)
    rid = a.submit(PROMPT, max_new_tokens=12)
    for _ in range(4):
        a.step()
    ckpt = a.checkpoint_request(rid)
    assert ckpt.kv_dtype == "int8"
    assert ckpt.kv_k_scale is not None and ckpt.kv_v_scale is not None
    assert ckpt.kv_k.dtype == np.int8
    ckpt = S.mig.DecodeCheckpoint.from_wire(ckpt.to_wire())
    a.release_request(rid)
    # same ladder: the quantized payload splices in, exact within the rung
    b = S.engine(kv_dtype="int8", block_size=4)
    b_rid = b.restore_request(ckpt)
    out = b.run()[b_rid]
    assert out == ref
    assert b.stats()["kv_install_copies"] == ckpt.kv_k.shape[1]
    # another ladder: the fence drops the payload and re-prefills
    c = S.engine(block_size=4)
    c_rid = c.restore_request(ckpt)
    out_c = c.run()[c_rid]
    assert len(out_c) == 12 and out_c[:len(ckpt.tokens)] == ckpt.tokens
    assert c.stats()["kv_install_copies"] == 0
    for e in (a, b, c):
        e._alloc.check_leaks()
    return dict(out=out, out_c=out_c, ckpt=ckpt, stats_b=b.stats(),
                stats_c=c.stats(),
                scales=np.asarray(ckpt.kv_k_scale).shape)


def test_kv_dtype_fence_falls_back_to_recompute(models):
    both(models, _kv_dtype_fence)


def _v1_wire(S):
    a = S.engine()
    rid = a.submit(PROMPT, max_new_tokens=12)
    for _ in range(3):
        a.step()
    wire = a.checkpoint_request(rid).to_wire()
    assert wire["format_version"] == 2
    v1 = {k: v for k, v in wire.items()
          if k not in ("kv_dtype", "hi_layers", "kv_k_scale",
                       "kv_v_scale", "kv_k_hi", "kv_v_hi")}
    v1["format_version"] = 1
    old = S.mig.DecodeCheckpoint.from_wire(v1)
    assert old.kv_dtype == "bf16" and old.hi_layers == 0
    assert old.kv_k_scale is None
    a.release_request(rid)
    b = S.engine()
    b_rid = b.restore_request(old)
    out = b.run()[b_rid]
    assert out == S.reference()
    assert b.stats()["kv_install_copies"] > 0   # fast path, not replay
    b._alloc.check_leaks()
    return dict(out=out, ckpt=old, stats=b.stats())


def test_v1_checkpoint_wire_still_decodes(models):
    both(models, _v1_wire)


def _paused(S):
    ref = S.reference()
    a = S.engine(num_slots=3)
    rid = a.submit(PROMPT, max_new_tokens=12)
    other = a.submit([4, 4, 8, 1], max_new_tokens=12)
    queued = a.submit([2, 3], max_new_tokens=4)
    for _ in range(3):
        a.step()
    ckpt = a.checkpoint_request(rid)            # pauses
    frozen_at = len(a.result(rid))
    a.pause_request(queued)
    for _ in range(4):                          # others decode; rid not
        a.step()
    assert len(a.result(rid)) == frozen_at
    a.resume_request(rid)
    a.resume_request(queued)
    out = a.run()
    assert out[rid] == ref and len(out[other]) == 12
    a._alloc.check_leaks()
    with pytest.raises(S.mig.MigrationError):
        a.pause_request(rid)                    # finished
    with pytest.raises(S.mig.MigrationError):
        a.resume_request(999)                   # unknown
    return dict(out=[out[rid], out[other], out[queued]], ckpt=ckpt,
                frozen_at=frozen_at, stats=a.stats())


def test_paused_request_is_frozen_until_resume(models):
    both(models, _paused)


def _adapter(S):
    def adapter_engine():
        eng = S.engine(pool=True, block_size=4)
        eng.publish_adapter("t1", S.lora())
        return eng

    ref_eng = adapter_engine()
    ref_rid = ref_eng.submit(PROMPT, max_new_tokens=10, adapter_id="t1")
    ref = ref_eng.run()[ref_rid]
    a, b = adapter_engine(), adapter_engine()
    rid = a.submit(PROMPT, max_new_tokens=10, adapter_id="t1")
    for _ in range(4):
        a.step()
    ckpt = a.checkpoint_request(rid)
    assert ckpt.adapter_id == "t1" and ckpt.adapter_version == 1
    b_rid = b.restore_request(ckpt)
    out = b.run()[b_rid]
    assert out == ref
    assert a.release_request(rid)
    a._alloc.check_leaks()
    b._alloc.check_leaks()
    # version drift: the target republished t1, so no cross-version splice
    c = adapter_engine()
    c.publish_adapter("t1", S.lora())           # now v2
    with pytest.raises(S.mig.MigrationError):
        c.restore_request(ckpt)
    # the refused restore must not leak the transient acquire
    occupants = [o for rung in c.adapter_pool.stats()["rungs"]
                 for o in rung["occupants"]]
    assert all(o["refs"] == 0 for o in occupants)
    # a target without a pool refuses a bound checkpoint
    with pytest.raises(S.mig.MigrationError):
        S.engine(block_size=4).restore_request(ckpt)
    return dict(out=out, ref=ref, ckpt=ckpt,
                adapters=[e.adapter_stats() for e in (a, b, c)])


def test_migrate_under_active_adapter(models):
    r = both(models, _adapter)
    assert r["out"] != Side("port", models).reference(max_new=10)


def _spec_either_side(S):
    ref = S.reference()
    m = S.m
    params, cfg = ((m["jt"], m["jcfg"]) if S.name == "jax"
                   else (m["tt"], m["tcfg"]))
    outs = []
    for spec_source, spec_target in [(True, False), (False, True),
                                     (True, True)]:
        a, b = S.engine(), S.engine()
        if spec_source:
            a.enable_speculation(params, cfg, depth=4)
        if spec_target:
            b.enable_speculation(params, cfg, depth=4)
        rid = a.submit(PROMPT, max_new_tokens=12)
        for _ in range(3):
            a.step()
        ckpt = a.checkpoint_request(rid)
        a.release_request(rid)
        b_rid = b.restore_request(ckpt)
        out = b.run()[b_rid]
        assert out == ref
        for e in (a, b):
            e._alloc.check_leaks()
            e.spec_check_leaks()
        outs.append((out, len(ckpt.tokens), b.spec_stats().get("rounds", 0)))
    return dict(outs=outs)


def test_migrate_with_speculation_on_either_side(models):
    both(models, _spec_either_side)


def _refusals(S):
    a = S.engine()
    E = S.mig.MigrationError
    with pytest.raises(E):
        a.checkpoint_request(999)               # unknown rid
    rid = a.submit(PROMPT, max_new_tokens=2)
    a.run()
    with pytest.raises(E):
        a.checkpoint_request(rid)               # already finished
    held = a.submit(PROMPT, max_new_tokens=2, hold_slot=True)
    with pytest.raises(E):
        a.checkpoint_request(held)              # held slots are pinned
    a.release_slot(held)
    b = S.engine()
    rid2 = b.submit(PROMPT, max_new_tokens=8)
    b.step()
    ckpt = b.checkpoint_request(rid2)
    for bad in ({"format_version": 99}, {"mystery_field": 1}):
        with pytest.raises(E):
            S.mig.DecodeCheckpoint.from_wire({**ckpt.to_wire(), **bad})
    with pytest.raises(E):
        S.mig.DecodeCheckpoint.from_wire([1, 2])
    # sampler mismatch: token-exactness is meaningless across samplers
    with pytest.raises(E):
        S.engine(temperature=0.8).restore_request(ckpt)
    # a payload from another model's layout is always an error
    with pytest.raises(E):
        S.engine().restore_request(dataclasses.replace(
            ckpt, kv_k=ckpt.kv_k[:, :, :, :1], kv_v=ckpt.kv_v[:, :, :, :1]))
    b.release_request(rid2)
    b._alloc.check_leaks()
    return dict(ckpt=ckpt, stats=b.stats())


def test_checkpoint_and_wire_refusals(models):
    both(models, _refusals)


def _release(S):
    a = S.engine()
    rid = a.submit(PROMPT, max_new_tokens=12)
    queued = a.submit(PROMPT, max_new_tokens=12)
    late = a.submit(PROMPT, max_new_tokens=12)
    for _ in range(3):
        a.step()
    ckpt = a.checkpoint_request(rid)
    # a queued request checkpoints host state only (restore recomputes)
    ckpt_q = a.checkpoint_request(late)
    flags = [a.release_request(rid), a.release_request(rid),
             a.release_request(late)]
    assert rid not in a._requests               # fully forgotten
    out = a.run()[queued]
    a._alloc.check_leaks()
    return dict(flags=flags, ckpt=ckpt, ckpt_q=ckpt_q, out=out,
                stats=a.stats())


def test_release_request_is_idempotent_and_leak_free(models):
    r = both(models, _release)
    assert r["flags"] == [True, False, True]
    assert r["ckpt_q"].kv_k is None and r["ckpt_q"].tokens == []


def _pressure(S):
    """A request that outgrows the whole pool is offered for migration
    instead of truncated (paused, its blocks freed), migrates by
    recomputation to a roomier engine and finishes exact; a second trip
    through the ladder truncates as before."""
    a = S.engine(block_size=4, num_blocks=4)
    a.migrate_on_pressure = True
    rid = a.submit(PROMPT, max_new_tokens=14)
    while not a.take_pressure_migrations():
        a.step()
    req = a._requests[rid]
    assert req.paused and req.slot is None and a._alloc.free_blocks == 4
    ckpt = a.checkpoint_request(rid)
    b = S.engine(block_size=4)
    b_rid = b.restore_request(ckpt)
    out = b.run()[b_rid]
    assert out == S.reference(max_new=14, block_size=4)
    a.release_request(rid)
    # declined: the coordinator resumes it locally, it caps and truncates
    again = a.submit(PROMPT, max_new_tokens=14)
    while not a.take_pressure_migrations():
        a.step()
    a.resume_request(again)
    short = a.run()[again]
    assert 0 < len(short) < 14
    a._alloc.check_leaks()
    return dict(out=out, short=short, ckpt=ckpt, stats=a.stats())


def test_pressure_ladder_offers_migration_before_truncating(models):
    both(models, _pressure)


def _forked_row(S):
    ref = S.reference()
    a, b = S.engine(num_slots=4, block_size=4), S.engine(block_size=4)
    donor, leaf = a.submit_group(PROMPT, 2, max_new_tokens=12)
    for _ in range(4):
        a.step()
    assert a.stats()["group_prefills"] == 1     # the spine really shared
    ckpt = a.checkpoint_request(leaf)
    new_rid = b.restore_request(ckpt)
    assert a.release_request(leaf)              # a refcount drop only
    out_a, out_b = a.run(), b.run()
    assert out_a[donor] == ref and out_b[new_rid] == ref
    a._alloc.check_leaks()
    b._alloc.check_leaks()
    return dict(out=out_b[new_rid], ckpt=ckpt, stats_a=a.stats(),
                stats_b=b.stats())


def test_forked_row_checkpoint_is_unshared_deep_copy(models):
    both(models, _forked_row)


def _forked_child(S):
    a = S.engine(num_slots=4, block_size=4)
    root = a.submit(PROMPT, max_new_tokens=12)
    while len(a.result(root)) < 4:
        a.step()
    child = a.fork_request(root, token=7)
    for _ in range(3):
        a.step()
    ckpt = a.checkpoint_request(child)
    with pytest.raises(ValueError, match="paused"):
        a.fork_request(child)                   # a paused parent
    stream = list(a._requests[child].prompt)
    b = S.engine(block_size=4)
    new_rid = b.restore_request(ckpt)
    a.release_request(child)
    out_a, out_b = a.run(), b.run()
    assert out_b[new_rid] == S.reference(prompt=stream,
                                         max_new=len(out_b[new_rid]))
    assert out_a[root] == S.reference()
    a._alloc.check_leaks()
    b._alloc.check_leaks()
    return dict(out=out_b[new_rid], ckpt=ckpt, stats=a.stats())


def test_forked_branch_child_checkpoint_midstream(models):
    both(models, _forked_child)


# ---- across the packages ----------------------------------------------------------

@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoint_crosses_packages_token_exact(models, direction,
                                                 kv_dtype):
    """A decode checkpointed mid-stream by one package finishes on the
    other's engine through the fast path, token-exact against a
    never-migrated run on either side (fp32 model; "bf16" is the
    full-width rung)."""
    src, dst = ((Side("jax", models), Side("port", models))
                if direction == "jax_to_port"
                else (Side("port", models), Side("jax", models)))
    kw = dict(kv_dtype=kv_dtype, block_size=4)
    ref = src.reference(**kw)
    assert dst.reference(**kw) == ref
    a, b = src.engine(**kw), dst.engine(**kw)
    rid = a.submit(PROMPT, max_new_tokens=12)
    for _ in range(5):
        a.step()
    wire = a.checkpoint_request(rid).to_wire()
    new_rid = b.restore_request(dst.mig.DecodeCheckpoint.from_wire(wire))
    assert b.stats()["kv_install_copies"] == np.shape(wire["kv_k"])[1]
    a.release_request(rid)
    assert b.run()[new_rid] == ref
    np.testing.assert_allclose(b.result_logps(new_rid)[:len(wire["logps"])],
                               wire["logps"], atol=0)
    a._alloc.check_leaks()
    b._alloc.check_leaks()


def test_bf16_payload_raw_bits_equal_jax_ml_dtypes():
    """On a bf16 model the JAX checkpoint carries ``ml_dtypes.bfloat16``
    arrays, the port's the same bits as ``uint16``. A JAX checkpoint
    installed on a port engine and checkpointed again there comes back
    as raw bits equal to JAX's payload viewed as ``uint16``; a port
    checkpoint installs on a JAX engine the same way."""
    m = _models(dtype=(jax.numpy.bfloat16, torch.bfloat16))
    J, T = Side("jax", m), Side("port", m)
    a = J.engine(block_size=4)
    rid = a.submit(PROMPT, max_new_tokens=12)
    for _ in range(5):
        a.step()
    jck = a.checkpoint_request(rid)
    assert jck.kv_k.dtype.name == "bfloat16" and jck.kv_k.dtype.itemsize == 2
    b = T.engine(block_size=4)
    new_rid = b.restore_request(tmig.DecodeCheckpoint.from_wire(
        jck.to_wire()))
    tck = b.checkpoint_request(new_rid)
    assert tck.kv_k.dtype == np.uint16 and tck.kv_v.dtype == np.uint16
    assert np.array_equal(tck.kv_k, jck.kv_k.view(np.uint16))
    assert np.array_equal(tck.kv_v, jck.kv_v.view(np.uint16))
    assert (tck.tokens, tck.kv_len) == (jck.tokens, jck.kv_len)
    # and back: the port's raw bits, viewed as ml_dtypes (the JAX
    # package reads no raw bits), land in a JAX pool bit for bit
    c = J.engine(block_size=4)
    wire = tck.to_wire()
    for name in ("kv_k", "kv_v"):
        wire[name] = wire[name].view(jck.kv_k.dtype)
    back = c.restore_request(wire)
    jck2 = c.checkpoint_request(back)
    assert np.array_equal(jck2.kv_k.view(np.uint16), tck.kv_k)
    # a float16 payload is not bf16 bits: refused, not reinterpreted
    with pytest.raises(tmig.MigrationError, match="dtype"):
        T.engine(block_size=4).restore_request(dataclasses.replace(
            tck, kv_k=tck.kv_k.view(np.float16),
            kv_v=tck.kv_v.view(np.float16)))
    for e in (a, b, c):
        for r in list(e._requests):
            e.release_request(r)
        e._alloc.check_leaks()
