"""The port's speculative decoding against the JAX package's, on the same
weights (fp32 ``tiny_test`` target, a 2-layer ``tiny-draft`` from seeded
JAX weights bridged through ``params_from_numpy``, greedy,
``matmul_precision="highest"``).

- The engine's fused speculation (``enable_speculation``): greedy
  streams token-exact against non-speculative decoding at depths
  {0, 2, 4, 8} on both sides, the perfect draft, eos inside a window, a
  mid-decode depth switch and draft swap, a publish marking the draft
  stale, exhaustion preempting exactly, a starved draft pool, the depth
  controller throttling; ``spec_stats()``, the shared ``stats()``
  counters, the harvested outcomes and ``check_leaks`` /
  ``spec_check_leaks`` equal to the JAX engine's each time. Mirrors
  tests/test_spec_engine.py and tests/test_spec_controller.py.
- The online distillers: a ``DraftDistiller`` and an
  ``OnlineDraftLearner`` on fixed batches, losses within 1e-5 of JAX's
  ``_distill_step`` over three steps.
- ``SpeculativeDecoder`` on both layouts (tests/test_speculative.py),
  int8 verify (tests/test_kv_quant.py) and the ring-config guard
  (tests/test_sliding_window.py).
- The ``senweaver_spec_*`` metrics, spans and runtime ledger entries of a
  speculating run, equal to a JAX run's.
- On a card (marked ``gpu``): K1 at the 0.5B draft's heads (14/2, D 64)
  and in the two-entry verify tiles of the 1.5B heads, against its plain
  version.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from senweaver_ide_tpu import obs as jobs
from senweaver_ide_tpu.models import init_params as jax_init_params
from senweaver_ide_tpu.models import tiny_test as jax_tiny_test
from senweaver_ide_tpu.obs import runtime_profile as jrp
from senweaver_ide_tpu.rollout import EngineConfig as JaxEngineConfig
from senweaver_ide_tpu.rollout import RolloutEngine as JaxEngine
from senweaver_ide_tpu.rollout import engine as jengine
from senweaver_ide_tpu.rollout import speculative as jspec
from senweaver_ide_tpu.rollout.sampler import SampleParams as JaxSample
from senweaver_ide_tpu.rollout.spec_controller import \
    SpecController as JaxController
from senweaver_ide_tpu.rollout.spec_controller import \
    SpecControllerConfig as JaxControllerConfig
from senweaver_ide_tpu.training.draft_distill import \
    DraftDistiller as JaxDistiller
from senweaver_ide_tpu_torch import obs
from senweaver_ide_tpu_torch.models import params_from_numpy, tiny_test
from senweaver_ide_tpu_torch.obs import runtime_profile as rp
from senweaver_ide_tpu_torch.rollout import (EngineConfig, OnlineDraftLearner,
                                             RolloutEngine, SampleParams,
                                             SpecController,
                                             SpecControllerConfig,
                                             SpeculativeDecoder)
from senweaver_ide_tpu_torch.rollout import engine as tengine
from senweaver_ide_tpu_torch.rollout import speculative as tspec
from senweaver_ide_tpu_torch.rollout.sampler import generate
from senweaver_ide_tpu_torch.training import DraftDistiller

LOGP_ATOL = 1e-4
LOSS_TOL = 1e-5
PROMPTS = [[5, 9, 2, 7, 1, 3], [1, 2, 3, 4], [8, 8, 1], [2, 4, 6, 8, 10]]


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


@pytest.fixture(scope="module")
def models():
    jcfg = jax_tiny_test()
    jdc = dataclasses.replace(jcfg, num_layers=2, name="tiny-draft")
    jt = jax_init_params(jcfg, jax.random.PRNGKey(0))
    jd = jax_init_params(jdc, jax.random.PRNGKey(1))
    tcfg = tiny_test()
    tdc = dataclasses.replace(tcfg, num_layers=2, name="tiny-draft")
    return dict(jt=jt, jcfg=jcfg, jd=jd, jdc=jdc,
                tt=params_from_numpy(jax.device_get(jt), device="cpu"),
                tcfg=tcfg,
                td=params_from_numpy(jax.device_get(jd), device="cpu"),
                tdc=tdc)


def _bridge(jparams):
    return params_from_numpy(jax.device_get(jparams), device="cpu")


class Pair:
    """A JAX and a port engine on the same weights (greedy, paged, 4-token
    blocks). ``do(fn)`` applies ``fn`` to both and requires the same
    return value."""

    def __init__(self, m, *, num_slots=2, max_len=96, num_blocks=None,
                 eos_id=None, params=None):
        jt, tt = params if params is not None else (m["jt"], m["tt"])
        self.m = m
        self.j = JaxEngine(jt, m["jcfg"], num_slots=num_slots,
                           max_len=max_len, sample=JaxSample(0.0, 0, 1.0),
                           eos_id=eos_id,
                           engine_config=JaxEngineConfig(
                               kv_layout="paged", block_size=4,
                               num_blocks=num_blocks))
        self.t = RolloutEngine(tt, m["tcfg"], num_slots=num_slots,
                               max_len=max_len,
                               sample=SampleParams(0.0, 0, 1.0),
                               eos_id=eos_id,
                               engine_config=EngineConfig(
                                   block_size=4, num_blocks=num_blocks),
                               device="cpu")

    def speculate(self, draft="weak", **kw):
        m = self.m
        if draft == "weak":
            self.j.enable_speculation(m["jd"], m["jdc"], **kw)
            self.t.enable_speculation(m["td"], m["tdc"], **kw)
        else:                       # self-draft: the target proposes
            self.j.enable_speculation(m["jt"], m["jcfg"], **kw)
            self.t.enable_speculation(m["tt"], m["tcfg"], **kw)

    def do(self, fn):
        a, b = fn(self.j), fn(self.t)
        assert a == b
        return b

    def steps(self, n=None):
        """Step both (to completion, or ``n`` times); the emitted dicts
        must be equal step by step."""
        i = 0
        while (self.j.has_work or self.t.has_work) and (n is None or i < n):
            assert self.j.step() == self.t.step()
            i += 1

    def check(self, rids):
        for rid in rids:
            assert self.t.result(rid) == self.j.result(rid), rid
            np.testing.assert_allclose(self.t.result_logps(rid),
                                       self.j.result_logps(rid),
                                       atol=LOGP_ATOL)
        js, ts = self.j.stats(), self.t.stats()
        shared = sorted(set(js) & set(ts))
        assert {k: ts[k] for k in shared} == {k: js[k] for k in shared}
        assert self.t.spec_stats() == self.j.spec_stats()
        for e in (self.j, self.t):
            e._alloc.check_leaks()
            e.spec_check_leaks()
        return ts


def reference(m, prompts=PROMPTS, max_new=12, eos_id=None, params=None):
    """Non-speculative greedy streams on the port."""
    eng = RolloutEngine(params or m["tt"], m["tcfg"], num_slots=2,
                        max_len=96, sample=SampleParams(0.0, 0, 1.0),
                        eos_id=eos_id,
                        engine_config=EngineConfig(block_size=4),
                        device="cpu")
    rids = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
    out = eng.run()
    return [out[r] for r in rids]


# ---- the engine's fused speculation ---------------------------------------

@pytest.mark.parametrize("depth", [0, 2, 4, 8])
def test_greedy_parity_weak_draft(models, depth):
    ref = reference(models)
    pair = Pair(models)
    pair.speculate(depth=depth)
    rids = [pair.do(lambda e, p=p: e.submit(p, max_new_tokens=12))
            for p in PROMPTS]
    pair.steps()
    assert [pair.t.result(r) for r in rids] == ref
    st = pair.check(rids)
    s = pair.t.spec_stats()
    assert s["enabled"] and s["depth"] == depth
    if depth:
        assert s["rounds"] > 0 and s["proposed"] == depth * s["rounds"]
        assert st["spec_rollbacks"] == s["rounds"]
        # harvested verification outcomes: the same on both sides
        assert (pair.t.drain_spec_outcomes()
                == pair.j.drain_spec_outcomes())
    else:
        assert s["rounds"] == 0


def test_perfect_draft_accepts_everything_fewer_rounds(models):
    ref = reference(models)
    rounds = {}
    for depth in (2, 8):
        pair = Pair(models)
        pair.speculate("self", depth=depth)
        rids = [pair.do(lambda e, p=p: e.submit(p, max_new_tokens=12))
                for p in PROMPTS]
        pair.steps()
        assert [pair.t.result(r) for r in rids] == ref
        pair.check(rids)
        s = pair.t.spec_stats()
        assert s["accepted"] == s["proposed"] > 0
        assert s["acceptance_ema"] == pytest.approx(1.0)
        rounds[depth] = s["rounds"]
    assert rounds[8] < rounds[2]


def test_eos_inside_speculation_window(models):
    eos = reference(models)[0][2]
    ref = reference(models, eos_id=eos)
    pair = Pair(models, eos_id=eos)
    pair.speculate("self", depth=8)
    rids = [pair.do(lambda e, p=p: e.submit(p, max_new_tokens=12))
            for p in PROMPTS]
    pair.steps()
    assert [pair.t.result(r) for r in rids] == ref
    assert pair.t.result(rids[0])[-1] == eos
    pair.check(rids)


def test_mid_decode_depth_switch_and_draft_swap(models):
    """Depth 8 -> 2 -> 0 -> 8 and a draft swap mid-decode never change
    the streams; the swap resets the EMA and stamps the version."""
    ref = reference(models, max_new=20)
    pair = Pair(models)
    pair.speculate(depth=8)
    rids = [pair.do(lambda e, p=p: e.submit(p, max_new_tokens=20))
            for p in PROMPTS]
    pair.steps(3)
    pair.do(lambda e: e.set_spec_depth(2))
    pair.steps(2)
    pair.j.update_draft_params(models["jd"], version=5)
    pair.t.update_draft_params(models["td"], version=5)
    s = pair.t.spec_stats()
    assert s == pair.j.spec_stats()
    assert s["draft_version"] == 5 and s["acceptance_ema"] is None
    pair.do(lambda e: e.set_spec_depth(0))
    pair.steps(2)
    pair.do(lambda e: e.set_spec_depth(8))
    pair.steps()
    assert [pair.t.result(r) for r in rids] == ref
    pair.check(rids)


def test_target_publish_marks_draft_stale_and_resets_ema(models):
    bumped_j = jax.tree_util.tree_map(lambda x: x + 0.01, models["jt"])
    bumped_t = _bridge(bumped_j)
    pair = Pair(models)
    pair.speculate(depth=4)
    r0 = pair.do(lambda e: e.submit(PROMPTS[0], max_new_tokens=8))
    pair.steps()
    assert pair.t.spec_stats()["acceptance_ema"] is not None
    pair.j.update_params(bumped_j)
    pair.t.update_params(bumped_t)
    s = pair.t.spec_stats()
    assert s == pair.j.spec_stats()
    assert s["draft_staleness"] == 1 and s["acceptance_ema"] is None
    # serving goes on exact on the NEW weights with the stale draft
    r1 = pair.do(lambda e: e.submit(PROMPTS[1], max_new_tokens=10))
    pair.steps()
    assert pair.t.result(r1) == reference(models, [PROMPTS[1]], 10,
                                          params=bumped_t)[0]
    pair.check([r0, r1])
    # a fleet publisher's begin() stamps first; the install then does not
    # count the same publish twice
    pair.do(lambda e: e.spec_note_publish_begin())
    pair.j.update_params(models["jt"])
    pair.t.update_params(models["tt"])
    assert pair.t.spec_stats()["draft_staleness"] == 2
    # installing a fresh draft clears the staleness debt
    pair.j.update_draft_params(models["jd"])
    pair.t.update_draft_params(models["td"])
    assert pair.t.spec_stats() == pair.j.spec_stats()
    assert pair.t.spec_stats()["draft_staleness"] == 0


@pytest.mark.parametrize("depth", [4, 8])
def test_exhaustion_preempts_speculating_rows_exactly(models, depth):
    prompts = [[5, 9, 2, 7], [11, 3, 8, 1]]
    solo = [reference(models, [p])[0] for p in prompts]
    pair = Pair(models, num_slots=2, max_len=64, num_blocks=6)
    pair.speculate("self", depth=depth)
    rids = [pair.do(lambda e, p=p: e.submit(p, max_new_tokens=12))
            for p in prompts]
    pair.steps()
    assert [pair.t.result(r) for r in rids] == solo
    assert pair.check(rids)["kv_preemptions"] >= 1


def test_draft_pool_exhaustion_never_blocks_target(models):
    ref = reference(models)
    pair = Pair(models)
    pair.speculate(depth=4, num_blocks=2)
    rids = [pair.do(lambda e, p=p: e.submit(p, max_new_tokens=12))
            for p in PROMPTS]
    pair.steps()
    assert [pair.t.result(r) for r in rids] == ref
    pair.check(rids)


def test_controller_throttles_under_load_and_recovers(models):
    pair = Pair(models)
    pair.j.enable_speculation(
        models["jt"], models["jcfg"],
        controller=JaxController(JaxControllerConfig(hysteresis_steps=1)))
    pair.t.enable_speculation(
        models["tt"], models["tcfg"],
        controller=SpecController(SpecControllerConfig(hysteresis_steps=1)))
    rids = [pair.do(lambda e, i=i: e.submit(
        [(3 * i + j) % 97 for j in range(5)], max_new_tokens=12))
        for i in range(10)]
    pair.do(lambda e: e.note_decode_load(4096.0))   # router backlog
    depths = []
    for _ in range(6):
        pair.steps(1)
        depths.append(pair.do(lambda e: e.spec_stats()["depth"]))
    assert min(depths) == 0                         # throttled to off
    pair.do(lambda e: e.note_decode_load(0.0))
    pair.steps()
    rids.append(pair.do(lambda e: e.submit([1, 2, 3], max_new_tokens=24)))
    pair.steps()
    assert pair.t.spec_stats()["depth"] > 0          # light load: back on
    pair.check(rids)


def test_spec_metric_span_and_ledger_names_match_jax(models):
    """A speculating run emits the JAX engine's senweaver_* series (the
    draft pool's under senweaver_spec_draft_kv_*), spans and runtime
    ledger entries."""
    for mod in (jengine, tengine, jspec, tspec):
        for fn in vars(mod).values():
            if isinstance(fn, (jrp.ProfiledFunction, rp.ProfiledFunction)):
                fn._mem_countdown = fn.mem_every
    out = {}
    for side, pkg in (("jax", jobs), ("port", obs)):
        pair = Pair(models)
        eng = pair.j if side == "jax" else pair.t
        tracer = pkg.enable()
        try:
            eng.enable_speculation(
                *((models["jd"], models["jdc"]) if side == "jax"
                  else (models["td"], models["tdc"])), depth=4)
            for p in PROMPTS:
                eng.submit(p, max_new_tokens=8)
            eng.run()
        finally:
            pkg.disable()
        names = {n for n in pkg.get_registry().snapshot()
                 if n.startswith("senweaver_")}
        out[side] = (names, {r.name for r in tracer.spans()},
                     set(pkg.get_profiler().ledger()))
    (jn, js, jl), (tn, ts, tl) = out["jax"], out["port"]
    assert {"senweaver_spec_depth", "senweaver_spec_acceptance_rate",
            "senweaver_spec_draft_staleness",
            "senweaver_spec_wasted_draft_tokens_total",
            "senweaver_spec_draft_kv_blocks_free"} <= jn
    assert tn == jn, (sorted(jn - tn), sorted(tn - jn))
    assert ts == js
    assert {"engine.spec_propose", "engine.spec_feed",
            "engine.fused_step"} <= tl
    assert tl == jl


# ---- the online distillers ------------------------------------------------

def _outcomes(n=12, seed=0):
    rng = np.random.default_rng(seed)
    return [([int(x) for x in rng.integers(1, 400, int(rng.integers(3, 40)))],
             [int(x) for x in rng.integers(1, 400, int(rng.integers(1, 6)))])
            for _ in range(n)]


def test_draft_distiller_steps_match_jax(models):
    jdist = JaxDistiller(models["jd"], models["jdc"], learning_rate=3e-3,
                         batch_size=4, max_len=48, seed=0)
    tdist = DraftDistiller(models["td"], models["tdc"], learning_rate=3e-3,
                           batch_size=4, max_len=48, seed=0)
    for ctx, tgt in _outcomes():
        jdist.observe(ctx, tgt)
        tdist.observe(ctx, tgt)
    assert jdist.buffer == tdist.buffer
    before = {k: v.clone() for k, v in models["td"]["layers"].items()}
    losses = [(jdist.step(), tdist.step()) for _ in range(3)]
    for jl, tl in losses:
        assert tl == pytest.approx(jl, abs=LOSS_TOL, rel=LOSS_TOL)
    assert losses[-1][1] < losses[0][1]
    # the distiller trains its own copy: the caller's draft is untouched
    for k, v in models["td"]["layers"].items():
        assert torch.equal(v, before[k]), k
    assert tdist.steps == 3
    reg = obs.get_registry()
    assert reg.get("senweaver_spec_distill_steps_total").value() == 3
    assert reg.get("senweaver_spec_distill_loss").value() == pytest.approx(
        losses[-1][1])
    assert DraftDistiller(models["td"], models["tdc"]).step() == 0.0


def test_distiller_round_installs_into_engines(models):
    """round(engines): harvest both engines, step, install one version
    everywhere; engines keep serving exactly."""
    pair = Pair(models)
    pair.speculate(depth=4)
    rids = [pair.do(lambda e, p=p: e.submit(p, max_new_tokens=10))
            for p in PROMPTS]
    pair.steps()
    jdist = JaxDistiller(models["jd"], models["jdc"], batch_size=4, seed=0)
    tdist = DraftDistiller(models["td"], models["tdc"], batch_size=4, seed=0)
    # one step: Adam's first update is about sign(g) * lr, so a gradient
    # element near zero may step either way on the two sides, and later
    # losses drift apart by more than a step's tolerance
    jloss = jdist.round([pair.j], steps=1)
    tloss = tdist.round([pair.t], steps=1)
    assert tloss == pytest.approx(jloss, abs=LOSS_TOL, rel=LOSS_TOL)
    assert tdist.harvested == jdist.harvested > 0
    assert tdist.version == jdist.version == 1
    s = pair.t.spec_stats()
    assert s == pair.j.spec_stats() and s["draft_version"] == 1
    assert pair.t.drain_spec_outcomes() == []
    # the engine holds a snapshot: further steps do not reach it
    installed = pair.t._spec.params["embed"].clone()
    tdist.step()
    assert torch.equal(pair.t._spec.params["embed"], installed)
    rids.append(pair.do(lambda e: e.submit(PROMPTS[0], max_new_tokens=10)))
    pair.steps()
    assert pair.t.result(rids[-1]) == pair.t.result(rids[0])
    pair.check(rids)


def test_online_draft_learner_steps_match_jax(models):
    jdec = jspec.SpeculativeDecoder(models["jt"], models["jcfg"],
                                    models["jd"], models["jdc"], k=4)
    tdec = SpeculativeDecoder(models["tt"], models["tcfg"], models["td"],
                              models["tdc"], k=4)
    jl = jspec.OnlineDraftLearner(jdec, learning_rate=3e-2, seed=0)
    tl = OnlineDraftLearner(tdec, learning_rate=3e-2, seed=0)
    assert tdec.dp is not models["td"]          # the learner's own copy
    for p, o in _outcomes(6, seed=1):
        jl.observe(p, o)
        tl.observe(p, o)
    losses = [(jl.step(batch_size=4), tl.step(batch_size=4))
              for _ in range(3)]
    for a, b in losses:
        assert b == pytest.approx(a, abs=LOSS_TOL, rel=LOSS_TOL)
    assert losses[-1][1] < losses[0][1]
    assert tl.steps == 3


# ---- SpeculativeDecoder ---------------------------------------------------

def _vanilla(m, prompt, n, max_len=64, eos_id=None):
    out = generate(m["tt"], m["tcfg"], torch.tensor([prompt]),
                   max_new_tokens=n, sample=SampleParams(0.0, 0, 1.0),
                   max_len=max_len, eos_id=eos_id)
    return out[0].tolist()


@pytest.mark.parametrize("layout", ["slots", "paged"])
@pytest.mark.parametrize("k", [1, 3, 4])
def test_decoder_greedy_equals_vanilla_and_jax(models, layout, k):
    m = models
    prompt = [5, 9, 2, 7, 1, 3]
    kw = dict(k=k, kv_layout=layout, block_size=4)
    jdec = jspec.SpeculativeDecoder(m["jt"], m["jcfg"], m["jd"], m["jdc"],
                                    **kw)
    tdec = SpeculativeDecoder(m["tt"], m["tcfg"], m["td"], m["tdc"], **kw)
    want = jdec.generate(prompt, max_new_tokens=12, max_len=64)
    got = tdec.generate(prompt, max_new_tokens=12, max_len=64)
    assert got == want == _vanilla(m, prompt, 12)
    assert (tdec.rounds, tdec.accepted, tdec.proposed) == (
        jdec.rounds, jdec.accepted, jdec.proposed)
    if layout == "paged":
        for kv in tdec._last_paged_kv:
            # exactly the live table is held: nothing orphaned by rollback
            assert kv.allocator.used_blocks == len(kv.table)
            assert kv.allocator.blocks_for(kv.length) == len(kv.table)
            kv.free()
            kv.allocator.check_leaks()


@pytest.mark.parametrize("layout", ["slots", "paged"])
def test_decoder_self_draft_accepts_everything(models, layout):
    m = models
    dec = SpeculativeDecoder(m["tt"], m["tcfg"], m["tt"], m["tcfg"], k=4,
                             kv_layout=layout)
    out = dec.generate([5, 9, 2, 7], max_new_tokens=16, max_len=64)
    assert out == _vanilla(m, [5, 9, 2, 7], 16)
    assert dec.acceptance_rate == 1.0
    assert dec.rounds <= -(-15 // 4) + 1


def test_decoder_eos_and_tight_max_len(models):
    m = models
    ref = _vanilla(m, [5, 9, 2, 7], 24)
    dec = SpeculativeDecoder(m["tt"], m["tcfg"], m["td"], m["tdc"], k=3)
    out = dec.generate([5, 9, 2, 7], max_new_tokens=24, eos_id=ref[5],
                       max_len=64)
    assert out == ref[:6] and out[-1] == ref[5]
    prompt = [5, 9, 2, 7, 1, 3]
    dec = SpeculativeDecoder(m["tt"], m["tcfg"], m["td"], m["tdc"], k=4)
    assert dec.generate(prompt, max_new_tokens=12,
                        max_len=len(prompt) + 12) == _vanilla(
                            m, prompt, 12, max_len=len(prompt) + 12)


def test_decoder_stochastic_paths(models):
    """Sampled streams differ from JAX's (numpy draws seeded differently),
    so the stochastic path is held to its invariants: a self-draft
    accepts everything; a distinct draft takes the residual branch."""
    m = models
    dec = SpeculativeDecoder(m["tt"], m["tcfg"], m["tt"], m["tcfg"], k=3)
    out = dec.generate([1, 2, 3], max_new_tokens=10, temperature=0.8,
                       rng=np.random.default_rng(3), max_len=64)
    assert len(out) == 10 and dec.acceptance_rate == 1.0
    dec = SpeculativeDecoder(m["tt"], m["tcfg"], m["td"], m["tdc"], k=3)
    out = dec.generate([4, 8, 6], max_new_tokens=24, temperature=1.0,
                       rng=np.random.default_rng(11), max_len=96)
    assert len(out) == 24
    assert all(0 <= t < m["tcfg"].vocab_size for t in out)
    assert 0.0 < dec.acceptance_rate < 1.0
    assert dec.proposed == dec.rounds * 3
    again = SpeculativeDecoder(m["tt"], m["tcfg"], m["td"], m["tdc"], k=3)
    assert again.generate([4, 8, 6], max_new_tokens=24, temperature=1.0,
                          rng=np.random.default_rng(11), max_len=96) == out


def test_decoder_int8_verify_is_draft_independent(models):
    m = models
    prompt = [5, 9, 2, 7, 1, 3]
    outs = []
    for draft, cfg, k in ((m["td"], m["tdc"], 3), (m["tt"], m["tcfg"], 4)):
        jdraft = m["jd"] if cfg is m["tdc"] else m["jt"]
        jcfg = m["jdc"] if cfg is m["tdc"] else m["jcfg"]
        kw = dict(k=k, kv_layout="paged", block_size=4, kv_dtype="int8")
        dec = SpeculativeDecoder(m["tt"], m["tcfg"], draft, cfg, **kw)
        out = dec.generate(prompt, max_new_tokens=12, max_len=64)
        jdec = jspec.SpeculativeDecoder(m["jt"], m["jcfg"], jdraft, jcfg,
                                        **kw)
        assert out == jdec.generate(prompt, max_new_tokens=12, max_len=64)
        t_kv, d_kv = dec._last_paged_kv
        assert t_kv.pool.quantized and not d_kv.pool.quantized
        for kv in (t_kv, d_kv):
            assert kv.allocator.used_blocks == len(kv.table)
            kv.free()
            kv.allocator.check_leaks()
        outs.append(out)
    assert outs[0] == outs[1] and len(outs[0]) == 12


def test_decoder_guards(models):
    m = models
    with pytest.raises(ValueError, match="k must be"):
        SpeculativeDecoder(m["tt"], m["tcfg"], m["tt"], m["tcfg"], k=0)
    bad = dataclasses.replace(m["tdc"], vocab_size=m["tdc"].vocab_size + 1)
    with pytest.raises(ValueError, match="vocabulary"):
        SpeculativeDecoder(m["tt"], m["tcfg"], m["td"], bad)
    with pytest.raises(ValueError, match="kv_layout"):
        SpeculativeDecoder(m["tt"], m["tcfg"], m["td"], m["tdc"],
                           kv_layout="ring")
    with pytest.raises(ValueError):
        SpeculativeDecoder(m["tt"], m["tcfg"], m["tt"], m["tcfg"], k=2,
                           kv_dtype="int8")
    ring = dataclasses.replace(m["tcfg"], sliding_window=4)
    for args in ((m["tt"], ring, m["td"], m["tdc"]),
                 (m["tt"], m["tcfg"], m["td"],
                  dataclasses.replace(m["tdc"], sliding_window=4))):
        with pytest.raises(ValueError, match="ring-cache"):
            SpeculativeDecoder(*args)


def test_engine_speculation_guards(models):
    m = models
    slots = RolloutEngine(m["tt"], m["tcfg"], num_slots=2, max_len=64,
                          sample=SampleParams(0.0, 0, 1.0),
                          engine_config=EngineConfig(kv_layout="slots"),
                          device="cpu")
    with pytest.raises(ValueError, match="paged"):
        slots.enable_speculation(m["td"], m["tdc"], depth=2)
    sampled = RolloutEngine(m["tt"], m["tcfg"], num_slots=2, max_len=64,
                            device="cpu")
    with pytest.raises(ValueError, match="greedy"):
        sampled.enable_speculation(m["td"], m["tdc"], depth=2)
    greedy = RolloutEngine(m["tt"], m["tcfg"], num_slots=2, max_len=64,
                           sample=SampleParams(0.0, 0, 1.0), device="cpu")
    bad = dataclasses.replace(m["tdc"], vocab_size=m["tdc"].vocab_size + 1)
    with pytest.raises(ValueError, match="vocab"):
        greedy.enable_speculation(m["td"], bad, depth=2)
    with pytest.raises(RuntimeError):
        greedy.update_draft_params(m["td"])
    assert greedy.spec_stats() == {"enabled": False}
    assert greedy.drain_spec_outcomes() == []


# ---- K1 on the card at the draft's heads and in verify tiles ---------------

@pytest.mark.gpu
@pytest.mark.parametrize("heads", [(14, 2, 64), (12, 2, 128)],
                         ids=["draft-0.5b", "verify-1.5b"])
def test_cuda_kernel_draft_heads_and_verify_tiles(heads):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from senweaver_ide_tpu_torch.ops import paged_attention as tpa
    hq, hkv, d = heads
    g = torch.Generator(device="cuda").manual_seed(0)
    nb, bs, mb, depth = 600, 16, 128, 4
    kp = torch.randn(nb, bs, hkv, d, generator=g, device="cuda").bfloat16()
    vp = torch.randn(nb, bs, hkv, d, generator=g, device="cuda").bfloat16()
    seq_tables = torch.randint(0, nb, (4, mb), generator=g, device="cuda",
                               dtype=torch.int32)
    # four rows' depth-4 verify windows, ending on a block edge, across
    # one, from position 0, and at the table's end
    starts = [12, 30, 0, mb * bs - depth]
    seq_row = torch.tensor([r for r in range(4) for _ in range(depth)])
    pos = torch.tensor([s + j for s in starts for j in range(depth)])
    tables = seq_tables[seq_row.cuda()].contiguous()
    lengths = (pos + 1).to(torch.int32).cuda()
    q = torch.randn(len(pos), hq, d, generator=g, device="cuda").bfloat16()
    tiles = tpa.query_tiles(seq_row, pos, hq // hkv)
    assert tiles[:, 1].max() == tpa.TILE_ROWS // (hq // hkv) == 2
    ref = tpa.paged_flash_decode_plain(q.float(), kp, vp, tables, lengths)
    for t in (tiles, None):
        out = tpa.paged_flash_decode(q, kp, vp, tables, lengths, q_tiles=t)
        torch.testing.assert_close(out.float(), ref, atol=1e-2, rtol=1e-2)
        assert torch.equal(out, tpa.paged_flash_decode(
            q, kp, vp, tables, lengths, q_tiles=t))
