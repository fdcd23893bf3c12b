"""Both packages' serving stacks side by side, for the fleet parity tests
(``test_torch_serve.py``, ``test_torch_remote_fleet.py``,
``test_torch_learner.py``).

A scenario is written once as ``scenario(S, ...)`` against a
:class:`Side` (``S.serve``, ``S.res``, ``S.engine()``, ``S.weights()``)
and :func:`both` runs it on the JAX package and on the port, on the same
weights (fp32 ``tiny_test`` with ``matmul_precision="highest"``, bridged
by ``params_from_numpy``), greedy, each on a fresh metrics registry. The
scenario returns a dict; ``both`` requires every entry equal, with
``stats*`` entries compared on the keys both sides have (the port's
keys must include JAX's), ``approx*`` entries within 1e-5, and the ``senweaver_*`` metric names, the
counter values and histogram counts of the serving, learner and chaos
series, and the span names the same on both sides.
"""

import dataclasses

import jax
import numpy as np
import torch

from senweaver_ide_tpu import obs as jobs
from senweaver_ide_tpu import resilience as jres
from senweaver_ide_tpu import serve as jserve
from senweaver_ide_tpu.models import init_params as jax_init_params
from senweaver_ide_tpu.obs import runtime_profile as jrp
from senweaver_ide_tpu.models import tiny_test as jax_tiny_test
from senweaver_ide_tpu.rollout import AdapterPool as JaxPool
from senweaver_ide_tpu.rollout import AdapterPoolConfig as JaxPoolConfig
from senweaver_ide_tpu.rollout import EngineConfig as JaxEngineConfig
from senweaver_ide_tpu.rollout import EnginePolicyClient as JaxPolicyClient
from senweaver_ide_tpu.rollout import RolloutEngine as JaxEngine
from senweaver_ide_tpu.rollout.sampler import SampleParams as JaxSample
from senweaver_ide_tpu.training import experience as jexp
from senweaver_ide_tpu_torch import obs as tobs
from senweaver_ide_tpu_torch import resilience as tres
from senweaver_ide_tpu_torch import serve as tserve
from senweaver_ide_tpu_torch.models import params_from_numpy, tiny_test
from senweaver_ide_tpu_torch.obs import runtime_profile as trp
from senweaver_ide_tpu_torch.rollout import (AdapterPool, AdapterPoolConfig,
                                             EngineConfig, EnginePolicyClient,
                                             RolloutEngine, SampleParams)
from senweaver_ide_tpu_torch.training import experience as texp

# stats keys measured on the host's clock (differ run to run)
WALL_CLOCK_KEYS = ("_ms", "_s", "seconds", "latency", "uptime")

# metric families whose counter values must agree between the packages
COMPARED_PREFIXES = ("senweaver_serve_", "senweaver_learner_",
                     "senweaver_chaos_")


class FakeClock:
    """Injectable monotonic clock: time moves only when told to."""

    def __init__(self, t: float = 100.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        self.t += dt
        return self.t


def one_torch_thread():
    """Body of each module's thread fixture: tiny-model engine steps are
    thousands of small ops, and under several pytest-xdist workers
    torch's default thread pool oversubscribes the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


class Models:
    """The tiny model's weights on both sides, one set per seed."""

    def __init__(self):
        self.jcfg = jax_tiny_test()
        self.tcfg = tiny_test()
        self._by_seed = {}
        self._draft = None

    def draft(self):
        """A 2-layer draft of the tiny model, (JAX, port, configs)."""
        if self._draft is None:
            jdc = dataclasses.replace(self.jcfg, num_layers=2,
                                      name="tiny-draft")
            tdc = dataclasses.replace(self.tcfg, num_layers=2,
                                      name="tiny-draft")
            jd = jax_init_params(jdc, jax.random.PRNGKey(1))
            self._draft = (jd, params_from_numpy(jax.device_get(jd),
                                                 device="cpu"), jdc, tdc)
        return self._draft

    def pair(self, seed: int):
        if seed not in self._by_seed:
            jt = jax_init_params(self.jcfg, jax.random.PRNGKey(seed))
            tt = params_from_numpy(jax.device_get(jt), device="cpu")
            self._by_seed[seed] = (jt, tt)
        return self._by_seed[seed]


def _bump_port(tree, eps):
    if isinstance(tree, dict):
        return {k: _bump_port(v, eps) for k, v in tree.items()}
    return tree + eps


def bump_in_place(tree, eps):
    """An optimizer step as the port's trainer takes it: in place."""
    with torch.no_grad():
        for v in tree.values():
            if isinstance(v, dict):
                bump_in_place(v, eps)
            else:
                v.add_(eps)


def as_numpy(tree):
    """A params tree (either package) as nested numpy copies, for
    bitwise comparison (a copy: a CPU tensor's ``.numpy()`` shares its
    memory, and the port's trainers write in place)."""
    if isinstance(tree, dict):
        return {k: as_numpy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy().copy()
    return np.asarray(jax.device_get(tree))


def trees_equal(a, b) -> bool:
    a, b = as_numpy(a), as_numpy(b)
    if isinstance(a, dict):
        return (isinstance(b, dict) and sorted(a) == sorted(b)
                and all(trees_equal(a[k], b[k]) for k in a))
    return a.dtype == b.dtype and np.array_equal(a, b)


class Side:
    """One package's serving stack: modules, engines, weights."""

    def __init__(self, name: str, models: Models):
        self.name, self.models = name, models
        self.is_jax = name == "jax"
        self.serve = jserve if self.is_jax else tserve
        self.res = jres if self.is_jax else tres
        self.obs = jobs if self.is_jax else tobs
        self.exp = jexp if self.is_jax else texp
        self.config = models.jcfg if self.is_jax else models.tcfg
        self.PolicyClient = JaxPolicyClient if self.is_jax \
            else EnginePolicyClient

    def weights(self, seed: int = 0):
        return self.models.pair(seed)[0 if self.is_jax else 1]

    @property
    def params(self):
        return self.weights(0)

    def draft(self):
        """``(params, config)`` of the 2-layer draft."""
        jd, td, jdc, tdc = self.models.draft()
        return (jd, jdc) if self.is_jax else (td, tdc)

    def pool(self):
        if self.is_jax:
            return JaxPool(self.config, JaxPoolConfig())
        return AdapterPool(self.config, AdapterPoolConfig(), device="cpu")

    def lora(self, seed: int, rank: int, scale: float = 0.05):
        """A LoRA with nonzero B from numpy (the same on both sides)."""
        cfg = self.models.tcfg
        rng = np.random.default_rng(seed)
        dims = {"wq": (cfg.hidden_size, cfg.q_dim),
                "wk": (cfg.hidden_size, cfg.kv_dim),
                "wv": (cfg.hidden_size, cfg.kv_dim),
                "wo": (cfg.q_dim, cfg.hidden_size)}
        arrs = {}
        for t, (d_in, d_out) in dims.items():
            arrs[t + "_lora_a"] = (rng.standard_normal(
                (cfg.num_layers, d_in, rank)) * 2.0 / d_in ** 0.5
            ).astype(np.float32)
            arrs[t + "_lora_b"] = (rng.standard_normal(
                (cfg.num_layers, rank, d_out)) * scale).astype(np.float32)
        conv = jax.numpy.asarray if self.is_jax else torch.from_numpy
        return {"layers": {k: conv(v) for k, v in arrs.items()}}

    def bump(self, params, eps: float):
        """A new tree ``params + eps`` (the JAX tests' FakeTrainer step);
        the same fp32 adds on both sides."""
        if self.is_jax:
            return jax.tree_util.tree_map(lambda x: x + eps, params)
        return _bump_port(params, eps)

    def engine(self, num_slots=2, max_len=64, *, params=None,
               block_size=16, num_blocks=None, pool=None, max_preempts=3,
               **kw):
        params = self.params if params is None else params
        if self.is_jax:
            return JaxEngine(params, self.config, num_slots=num_slots,
                             max_len=max_len,
                             sample=JaxSample(0.0, 0, 1.0),
                             adapter_pool=pool,
                             engine_config=JaxEngineConfig(
                                 kv_layout="paged", block_size=block_size,
                                 num_blocks=num_blocks,
                                 max_preempts=max_preempts), **kw)
        return RolloutEngine(params, self.config, num_slots=num_slots,
                             max_len=max_len,
                             sample=SampleParams(0.0, 0, 1.0),
                             adapter_pool=pool,
                             engine_config=EngineConfig(
                                 block_size=block_size,
                                 num_blocks=num_blocks,
                                 max_preempts=max_preempts),
                             device="cpu", **kw)

    def reference(self, prompt, max_new, *, params=None):
        eng = self.engine(params=params)
        rid = eng.submit(list(prompt), max_new_tokens=max_new)
        return eng.run()[rid]

    def counter_total(self, name: str) -> float:
        m = self.obs.get_registry().get(name)
        if m is None:
            return 0.0
        return sum(float(v) for v in m.samples().values())


def _observed(obs_mod):
    snap = obs_mod.get_registry().snapshot()
    names = {n for n in snap if n.startswith("senweaver_")}
    values = {}
    for n, m in snap.items():
        if not n.startswith(COMPARED_PREFIXES):
            continue
        if m["kind"] == "counter":
            values[n] = m["values"]
        elif m["kind"] == "histogram":
            values[n] = {k: c["count"] for k, c in m["values"].items()}
    spans = {rec.name for rec in obs_mod.get_tracer().spans()}
    return names, values, spans


def _same_stats(j, t, path):
    """Every key of JAX's (nested) stats is in the port's with the same
    value, except the wall-clock ones."""
    assert set(j) <= set(t), (path, sorted(set(j) - set(t)))
    for k, v in j.items():
        if isinstance(v, dict) and isinstance(t[k], dict):
            _same_stats(v, t[k], f"{path}/{k}")
        elif not any(w in str(k) for w in WALL_CLOCK_KEYS):
            assert t[k] == v, (f"{path}/{k}", t[k], v)


def _rearm_memory_sampling():
    """Each profiled function samples device memory every ``mem_every``
    calls on a countdown that outlives ``_reset_for_tests``: rewind them
    all so that both sides sample (and emit the memory gauges) at the
    same calls of a scenario."""
    import sys
    for name, mod in list(sys.modules.items()):
        if not name.startswith("senweaver_ide_tpu") or mod is None:
            continue
        for fn in list(vars(mod).values()):
            if isinstance(fn, (jrp.ProfiledFunction, trp.ProfiledFunction)):
                fn._mem_countdown = fn.mem_every


def both(models: Models, scenario, *args, metrics: bool = True):
    """Run ``scenario(side, *args)`` on the JAX package, then on the
    port; their returned dicts, metric names, serving counters and span
    names must agree. Returns the port's dict."""
    out, seen = {}, {}
    for name in ("jax", "port"):
        side = Side(name, models)
        side.obs._reset_for_tests()
        _rearm_memory_sampling()
        try:
            out[name] = scenario(side, *args)
            seen[name] = _observed(side.obs)
        finally:
            side.obs.disable()
            side.obs._reset_for_tests()
    j, t = out["jax"], out["port"]
    assert sorted(t) == sorted(j)
    for k in j:
        if k.startswith("stats"):
            _same_stats(j[k], t[k], k)
        elif k.startswith("approx"):
            np.testing.assert_allclose(t[k], j[k], atol=1e-5, err_msg=k)
        else:
            assert t[k] == j[k], (k, t[k], j[k])
    if metrics:
        (jn, jv, js), (tn, tv, ts) = seen["jax"], seen["port"]
        assert tn == jn, (sorted(jn - tn), sorted(tn - jn))
        assert tv == jv, {n: (tv.get(n), jv.get(n))
                          for n in set(tv) | set(jv)
                          if tv.get(n) != jv.get(n)}
        assert ts == js, (sorted(js - ts), sorted(ts - js))
    return t


def outcome_view(o):
    """What must agree between the packages' fleet outcomes."""
    if o is None:
        return None
    kind = type(o).__name__
    if kind == "Completed":
        return (kind, list(o.tokens), o.weight_version,
                o.weight_version_at_finish, o.attempts)
    return (kind, o.reason)


def engine_stats(fleet, key):
    """An engine stat summed over the fleet's live replicas."""
    return sum(r["engine"][key]
               for r in fleet.stats()["replicas"].values()
               if r["state"] != "dead"
               and isinstance(r["engine"], dict) and key in r["engine"])


def check_leaks_all(fleet, engines=None):
    """``check_leaks`` on every replica's engine (or the given engines),
    after releasing what a killed replica's rows stranded, held slots and
    registered prefixes."""
    engines = engines if engines is not None else [
        r.engine for r in fleet.replicas]
    for eng in engines:
        for rid, req in list(eng._requests.items()):
            if not req.done:
                eng.release_request(rid)
            elif req.hold_slot and req.slot is not None:
                eng.release_slot(rid)       # held KV is not a leak
        for pid in list(eng._prefixes):
            eng.release_prefix(pid)         # nor is a registered prefix
        eng._alloc.check_leaks()


__all__ = ["FakeClock", "Models", "Side", "both", "bump_in_place",
           "as_numpy", "trees_equal", "outcome_view", "engine_stats",
           "check_leaks_all", "one_torch_thread"]
