"""Runtime performance observatory for the port's hot callables.

The PyTorch counterpart of the JAX package's ``obs/runtime_profile.py``,
on the same interface and under the same ``senweaver_runtime_*`` metric
names. :class:`ProfiledFunction` wraps a callable (an engine step, the
GRPO gradient pass, the reward head) and keeps, per wrapped function:

- a **compile/signature ledger**: calls per distinct abstract signature
  (shape/dtype fingerprint of the tensor arguments) with a named storm
  detector (``senweaver_runtime_retrace_storms_total``) that fires when
  a new signature arrives past ``storm_threshold`` distinct ones and
  they outnumber reuse (eager PyTorch does not retrace, but a caller
  that feeds ever-new shapes defeats the kernels' plans and the
  allocator's caching all the same). The port has no jit, so there is
  no trace to count: a **compile** here is a kernel build by
  ``ops/_build.py`` (``nvcc``) that happens inside the call, reported
  through :func:`note_compile` with its wall time. The port uses no
  ``torch.compile``; a recompile hook would report through the same
  function;
- per-call **device-time histograms** — with ``block=True`` (the
  default) the wrapper waits for the outputs' device
  (``torch.cuda.synchronize``), so the window covers the device work, not
  just its launch. Every wired hot path syncs on its outputs right after
  the call anyway (the engine's one device→host copy per step), so
  waiting here moves that sync, it does not add one;
- **host→device transfer accounting**: bytes of host-resident leaves
  (numpy arrays always, CPU tensors when the call also takes CUDA
  tensors) fed per call. :func:`profiled_device_get` is the device→host
  counterpart;
- **FLOP counting** under ``torch.utils.flop_counter.FlopCounterMode``
  once per new signature (the counterpart of XLA's cost analysis), turned
  into achieved-vs-peak gauges against ``SENWEAVER_PEAK_FLOPS``. OFF by
  default (it runs the call once more under the counter) — enable with
  ``get_profiler().set_cost_analysis(True)`` or
  ``SENWEAVER_RUNTIME_COST_ANALYSIS=1``. Bytes accessed are not counted
  (the counter sees operations, not memory traffic);
- **device-memory watermark sampling** (:func:`sample_memory`):
  ``torch.cuda.memory_allocated`` / ``max_memory_allocated`` /
  ``mem_get_info`` with ``backend="cuda"``; on a host without a card the
  ``backend="cpu"`` gauges carry the bytes of the live tensors the
  garbage collector can see. The wrappers' periodic sample reads the
  CUDA counters only (a scan of every live object is too slow to run
  every few steps).

Everything exports as ``senweaver_runtime_*`` metrics through the
process-global registry (resolved per publish, so ``_reset_for_tests``
isolation works) and as a ledger snapshot (:meth:`RuntimeProfiler.ledger`).
Profiling is on by default (a handful of dict writes per call); ``SENWEAVER_RUNTIME_PROFILE=0`` or
``get_profiler().set_enabled(False)`` turns the wrappers into plain
pass-throughs.
"""

from __future__ import annotations

import dataclasses
import gc
import os
import threading
import time
from typing import (Any, Callable, Dict, List, Optional, Sequence, Tuple)

import numpy as np
import torch

from .metrics import DEFAULT_MS_BUCKETS

# Compile-time buckets: kernel builds run seconds, not microseconds.
COMPILE_MS_BUCKETS: Tuple[float, ...] = (
    10.0, 50.0, 100.0, 250.0, 500.0, 1_000.0, 2_500.0, 5_000.0,
    10_000.0, 30_000.0, 60_000.0, 300_000.0)

_tls = threading.local()


def _frames() -> List[Dict[str, float]]:
    st = getattr(_tls, "frames", None)
    if st is None:
        st = _tls.frames = []
    return st


def note_compile(seconds: float) -> None:
    """Attribute a kernel build (or a recompile) of ``seconds`` wall time
    to the innermost in-flight :class:`ProfiledFunction` call of THIS
    thread (builds run on the calling thread). No-op outside a call."""
    st = getattr(_tls, "frames", None)
    if st:
        st[-1]["compile_s"] += float(seconds)
        st[-1]["builds"] += 1


# -- abstract signatures -------------------------------------------------

def _tree_leaves(tree: Any) -> Tuple[Any, List[Any]]:
    """(structure, leaves) of a nested dict / list / tuple / NamedTuple /
    dataclass; anything else is a leaf."""
    if isinstance(tree, dict):
        keys = sorted(tree, key=repr)
        leaves: List[Any] = []
        subs = []
        for k in keys:
            s, ls = _tree_leaves(tree[k])
            subs.append((k, s))
            leaves += ls
        return ("dict", tuple(subs)), leaves
    if isinstance(tree, (list, tuple)):
        leaves = []
        subs = []
        for v in tree:
            s, ls = _tree_leaves(v)
            subs.append(s)
            leaves += ls
        return (type(tree).__name__, tuple(subs)), leaves
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        fields = [(f.name, getattr(tree, f.name))
                  for f in dataclasses.fields(tree)]
        s, leaves = _tree_leaves(dict(fields))
        return (type(tree).__name__, s), leaves
    return "*", [tree]


def _leaf_fingerprint(x: Any) -> Any:
    if isinstance(x, torch.Tensor):
        return ("t", tuple(x.shape), str(x.dtype), x.device.type)
    if isinstance(x, np.ndarray):
        return ("a", tuple(x.shape), str(x.dtype))
    if x is None or isinstance(x, (bool, int, float, str, bytes)):
        return x
    # static config objects (ModelConfig, SampleParams, optimizers):
    # identity by repr — good enough to separate signatures
    return repr(x)[:160]


def _scan(tree: Any) -> Tuple[Any, int, int, bool]:
    """(hashable fingerprint, numpy bytes, CPU-tensor bytes, has a CUDA
    tensor) of one argument."""
    struct, leaves = _tree_leaves(tree)
    fps = []
    np_bytes = cpu_bytes = 0
    cuda = False
    for leaf in leaves:
        fps.append(_leaf_fingerprint(leaf))
        if isinstance(leaf, np.ndarray):
            np_bytes += int(leaf.nbytes)
        elif isinstance(leaf, torch.Tensor):
            if leaf.device.type == "cuda":
                cuda = True
            else:
                cpu_bytes += leaf.numel() * leaf.element_size()
    return (struct, tuple(fps)), np_bytes, cpu_bytes, cuda


def signature_of(args: Sequence[Any], kwargs: Dict[str, Any],
                 skip_args: Sequence[int] = (),
                 skip_kwargs: Sequence[str] = ()) -> Tuple[Tuple, int]:
    """Abstract-signature fingerprint of a call + host-feed bytes.

    ``skip_args``/``skip_kwargs`` name shape-stable arguments (params
    trees, configs) excluded from the scan to keep the wrapper's cost off
    the hot path. Host-feed bytes are the numpy leaves' bytes, plus the
    CPU tensors' bytes when the scanned arguments hold a CUDA tensor (then
    the call moves them to the card)."""
    skip = frozenset(skip_args)
    skipk = frozenset(skip_kwargs)
    sig: List[Any] = []
    np_bytes = cpu_bytes = 0
    cuda = False
    items = [(i, a) for i, a in enumerate(args)]
    items += [(k, kwargs[k]) for k in sorted(kwargs)]
    for key, a in items:
        if (key in skip) if isinstance(key, int) else (key in skipk):
            sig.append(("skip", key))
            continue
        fp, nb, cb, cu = _scan(a)
        sig.append(fp if isinstance(key, int) else (key, fp))
        np_bytes += nb
        cpu_bytes += cb
        cuda = cuda or cu
    return tuple(sig), np_bytes + (cpu_bytes if cuda else 0)


def _cuda_devices(tree: Any) -> List[torch.device]:
    devs = []
    for leaf in _tree_leaves(tree)[1]:
        if (isinstance(leaf, torch.Tensor) and leaf.device.type == "cuda"
                and leaf.device not in devs):
            devs.append(leaf.device)
    return devs


# -- ledger --------------------------------------------------------------

class _SigEntry:
    __slots__ = ("calls", "compiles", "compile_ms")

    def __init__(self) -> None:
        self.calls = 0
        self.compiles = 0
        self.compile_ms = 0.0


class _FnLedger:
    """Per-wrapped-function ledger. All mutation happens under the
    owning profiler's lock."""

    def __init__(self, name: str, storm_threshold: int,
                 blocking: bool) -> None:
        self.name = name
        self.storm_threshold = storm_threshold
        self.blocking = blocking
        self.calls = 0
        self.compiles = 0
        self.compile_ms = 0.0
        self.storms = 0
        self.h2d_bytes = 0
        self.d2h_bytes = 0
        self.step_ms_sum = 0.0
        self.last_step_ms = 0.0
        self.signatures: Dict[Tuple, _SigEntry] = {}
        # FLOPs per signature: sig -> (flops, bytes) or None
        self.cost: Dict[Tuple, Optional[Tuple[float, float]]] = {}

    def snapshot(self) -> Dict[str, Any]:
        sigs = []
        for sig, e in self.signatures.items():
            sigs.append({"key": repr(sig), "calls": e.calls,
                         "compiles": e.compiles,
                         "compile_ms": round(e.compile_ms, 3)})
        costs = [c for c in self.cost.values() if c is not None]
        flops = max((c[0] for c in costs), default=None)
        cbytes = max((c[1] for c in costs), default=None)
        return {
            "fn": self.name, "calls": self.calls,
            "compiles": self.compiles,
            "compile_ms": round(self.compile_ms, 3),
            "storms": self.storms,
            "storm_threshold": self.storm_threshold,
            "h2d_bytes": self.h2d_bytes, "d2h_bytes": self.d2h_bytes,
            "step_ms_sum": round(self.step_ms_sum, 3),
            "last_step_ms": round(self.last_step_ms, 3),
            "blocking": self.blocking,
            "flops_per_call": flops, "cost_bytes_per_call": cbytes,
            "signatures": sigs,
        }


class RuntimeProfiler:
    """Process-global home of every :class:`ProfiledFunction` ledger.

    Publishes ``senweaver_runtime_*`` into the global metrics registry
    (re-resolved whenever the global is swapped, so test isolation via
    ``obs._reset_for_tests`` holds)."""

    def __init__(self, *, enabled: Optional[bool] = None,
                 cost_analysis: Optional[bool] = None):
        if enabled is None:
            enabled = os.environ.get(
                "SENWEAVER_RUNTIME_PROFILE", "1") != "0"
        if cost_analysis is None:
            cost_analysis = os.environ.get(
                "SENWEAVER_RUNTIME_COST_ANALYSIS", "0") == "1"
        self.enabled = enabled
        self._lock = threading.Lock()
        self._ledgers: Dict[str, _FnLedger] = {}    # guarded-by: _lock
        self._cost_analysis = cost_analysis
        self._registry = None                        # guarded-by: _lock
        self._instruments: Dict[str, Any] = {}       # guarded-by: _lock
        self._hbm_watermark: Dict[str, float] = {}   # guarded-by: _lock
        self.storm_events: List[Dict[str, Any]] = []  # guarded-by: _lock

    # -- switches ----------------------------------------------------------
    def set_enabled(self, on: bool) -> None:
        self.enabled = bool(on)

    def set_cost_analysis(self, on: bool) -> None:
        self._cost_analysis = bool(on)

    @property
    def cost_analysis_enabled(self) -> bool:
        return self._cost_analysis

    # -- instruments -------------------------------------------------------
    def _metrics(self) -> Dict[str, Any]:
        """Instrument cache keyed to the CURRENT global registry;
        rebuilt when the global is swapped (test isolation)."""
        from . import get_registry
        reg = get_registry()
        with self._lock:
            if reg is self._registry:
                return self._instruments
            ins = {
                "calls": reg.counter(
                    "senweaver_runtime_calls_total",
                    "Profiled callable invocations.",
                    labelnames=("fn",)),
                "compiles": reg.counter(
                    "senweaver_runtime_compiles_total",
                    "Compiles observed per profiled callable (kernel "
                    "builds inside the call).", labelnames=("fn",)),
                "compile_ms": reg.histogram(
                    "senweaver_runtime_compile_ms",
                    "Wall time of each observed compile (kernel builds "
                    "inside the call).",
                    labelnames=("fn",), buckets=COMPILE_MS_BUCKETS),
                "step_ms": reg.histogram(
                    "senweaver_runtime_step_ms",
                    "Per-call wall time (device window when the "
                    "wrapper waits for the outputs, launch otherwise).",
                    labelnames=("fn",), buckets=DEFAULT_MS_BUCKETS),
                "storms": reg.counter(
                    "senweaver_runtime_retrace_storms_total",
                    "Signature-storm detector trips: distinct signatures "
                    "exceeded the per-fn threshold AND outnumber reuse.",
                    labelnames=("fn",)),
                "transfer": reg.counter(
                    "senweaver_runtime_transfer_bytes_total",
                    "Host<->device bytes moved by profiled calls.",
                    labelnames=("fn", "direction")),
                "signatures": reg.gauge(
                    "senweaver_runtime_signatures",
                    "Distinct abstract signatures seen per callable.",
                    labelnames=("fn",)),
                "flops": reg.gauge(
                    "senweaver_runtime_flops_per_call",
                    "FlopCounterMode FLOPs of the largest counted "
                    "signature.", labelnames=("fn",)),
                "cost_bytes": reg.gauge(
                    "senweaver_runtime_bytes_per_call",
                    "Bytes accessed of the largest counted signature "
                    "(0: the FLOP counter sees no memory traffic).",
                    labelnames=("fn",)),
                "achieved": reg.gauge(
                    "senweaver_runtime_achieved_flops_per_sec",
                    "Counted FLOPs / measured device window of the last "
                    "profiled call.", labelnames=("fn",)),
                "roofline": reg.gauge(
                    "senweaver_runtime_roofline_utilization",
                    "Achieved / peak per resource (peaks from "
                    "SENWEAVER_PEAK_FLOPS and "
                    "SENWEAVER_PEAK_BYTES_PER_SEC).",
                    labelnames=("fn", "resource")),
            }
            self._registry = reg
            self._instruments = ins
            return ins

    # -- ledger access -----------------------------------------------------
    def _ledger(self, name: str, storm_threshold: int,
                blocking: bool) -> _FnLedger:
        with self._lock:
            led = self._ledgers.get(name)
            if led is None:
                led = self._ledgers[name] = _FnLedger(
                    name, storm_threshold, blocking)
            return led

    def ledger(self) -> Dict[str, Dict[str, Any]]:
        """JSON-friendly snapshot of every function's ledger."""
        with self._lock:
            return {name: led.snapshot()
                    for name, led in self._ledgers.items()}

    def flops_per_call(self, name: str) -> Optional[float]:
        """Largest counted FLOPs figure recorded for ``name`` (None until
        a signature was counted)."""
        with self._lock:
            led = self._ledgers.get(name)
            if led is None:
                return None
            costs = [c[0] for c in led.cost.values() if c is not None]
            return max(costs) if costs else None

    # -- recording ---------------------------------------------------------
    def account_transfer(self, name: str, nbytes: int,
                         direction: str = "h2d") -> None:
        if not self.enabled or nbytes <= 0:
            return
        led = self._ledger(name, 10, False)
        with self._lock:
            if direction == "d2h":
                led.d2h_bytes += int(nbytes)
            else:
                led.h2d_bytes += int(nbytes)
        self._metrics()["transfer"].inc(
            int(nbytes), fn=name, direction=direction)

    def maybe_cost_analysis(self, pf: "ProfiledFunction", sig: Tuple,
                            args: Tuple, kwargs: Dict[str, Any]
                            ) -> Optional[Tuple[float, float]]:
        """Once per new signature when enabled: run the wrapped callable
        under ``FlopCounterMode`` and read its FLOPs. The extra run
        writes what the timed call overwrites (the engine's pool rows),
        but a sampling step also draws from its generator: with cost
        analysis on, an engine samples another stream. Best-effort: any
        failure caches None so it is never retried per call."""
        led = self._ledger(pf.profile_name, pf.storm_threshold, pf.block)
        with self._lock:
            if not self._cost_analysis or sig in led.cost:
                return led.cost.get(sig)
        cost: Optional[Tuple[float, float]] = None
        try:
            from torch.utils.flop_counter import FlopCounterMode
            counter = FlopCounterMode(display=False)
            with counter:
                pf.wrapped(*args, **kwargs)
            cost = (float(counter.get_total_flops()), 0.0)
        except Exception:
            cost = None
        with self._lock:
            led.cost[sig] = cost
        return cost

    def record_call(self, pf: "ProfiledFunction", sig: Tuple, *,
                    compiled: bool, compile_s: float, step_ms: float,
                    h2d_bytes: int,
                    cost: Optional[Tuple[float, float]]) -> None:
        """``compiled``: a kernel build ran inside the call."""
        name = pf.profile_name
        led = self._ledger(name, pf.storm_threshold, pf.block)
        compile_ms = compile_s * 1_000.0
        storm = False
        with self._lock:
            led.calls += 1
            led.step_ms_sum += step_ms
            led.last_step_ms = step_ms
            led.h2d_bytes += h2d_bytes
            entry = led.signatures.get(sig)
            new_sig = entry is None
            if new_sig:
                entry = led.signatures[sig] = _SigEntry()
            entry.calls += 1
            if compiled:
                led.compiles += 1
                led.compile_ms += compile_ms
                entry.compiles += 1
                entry.compile_ms += compile_ms
            # Storm: the signature set exceeded its budget AND new
            # signatures outnumber reuse — a healthy bucket ladder
            # amortizes (calls >> signatures).
            n_sigs = len(led.signatures)
            if (new_sig and n_sigs >= led.storm_threshold
                    and n_sigs * 2 > led.calls):
                storm = True
                led.storms += 1
                self.storm_events.append({
                    "fn": name, "signatures": n_sigs,
                    "calls": led.calls, "signature": repr(sig)})
                del self.storm_events[:-50]
        ins = self._metrics()
        ins["calls"].inc(fn=name)
        ins["step_ms"].observe(step_ms, fn=name)
        ins["signatures"].set(n_sigs, fn=name)
        if h2d_bytes > 0:
            ins["transfer"].inc(h2d_bytes, fn=name, direction="h2d")
        if compiled:
            ins["compiles"].inc(fn=name)
            ins["compile_ms"].observe(compile_ms, fn=name)
        if storm:
            ins["storms"].inc(fn=name)
        if cost is not None:
            flops, cbytes = cost
            ins["flops"].set(flops, fn=name)
            ins["cost_bytes"].set(cbytes, fn=name)
            if pf.block and step_ms > 0:
                step_s = step_ms / 1_000.0
                ins["achieved"].set(flops / step_s, fn=name)
                peak = _env_float("SENWEAVER_PEAK_FLOPS")
                if peak:
                    ins["roofline"].set(flops / step_s / peak,
                                        fn=name, resource="flops")
                peak_bw = _env_float("SENWEAVER_PEAK_BYTES_PER_SEC")
                if peak_bw and cbytes:
                    ins["roofline"].set(cbytes / step_s / peak_bw,
                                        fn=name, resource="bytes")

    # -- device-memory watermarks ------------------------------------------
    def sample_memory(self, *, scan_host: bool = True
                      ) -> Dict[str, Dict[str, Any]]:
        """Per-backend memory watermarks, published with a ``backend``
        label: the CUDA allocator's counters for every card this process
        has initialized; on a host without one (or with none
        initialized), with ``scan_host``, the bytes of every live tensor
        the garbage collector can see under ``backend="cpu"``. Never
        raises."""
        from . import get_registry
        reg = get_registry()
        in_use = reg.gauge(
            "senweaver_runtime_hbm_bytes_in_use",
            "Device memory in use (the CUDA allocator's count where a "
            "card is initialized, live-tensor bytes otherwise).",
            labelnames=("backend",))
        limit_g = reg.gauge(
            "senweaver_runtime_hbm_bytes_limit",
            "Device memory capacity (cards only).",
            labelnames=("backend",))
        peak_g = reg.gauge(
            "senweaver_runtime_hbm_watermark_bytes",
            "High-water mark of device memory in use.",
            labelnames=("backend",))
        live_g = reg.gauge(
            "senweaver_runtime_live_buffer_bytes",
            "Bytes held by live tensors (the allocator's count on a "
            "card; the garbage collector's view on the host).",
            labelnames=("backend",))
        by_backend: Dict[str, Dict[str, Any]] = {}
        try:
            cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
        except Exception:
            cuda = False
        if cuda:
            agg = {"backend": "cuda", "source": "cuda_allocator",
                   "bytes_in_use": 0, "bytes_limit": 0, "peak_bytes": 0,
                   "live_buffer_bytes": 0}
            try:
                for i in range(torch.cuda.device_count()):
                    used = int(torch.cuda.memory_allocated(i))
                    agg["bytes_in_use"] += used
                    agg["live_buffer_bytes"] += used
                    agg["peak_bytes"] += int(
                        torch.cuda.max_memory_allocated(i))
                    agg["bytes_limit"] += int(torch.cuda.mem_get_info(i)[1])
                by_backend["cuda"] = agg
            except Exception:
                pass
        elif scan_host:
            live = 0
            try:
                for o in gc.get_objects():
                    if type(o) in (torch.Tensor, torch.nn.Parameter):
                        try:
                            live += o.numel() * o.element_size()
                        except Exception:
                            continue
            except Exception:
                live = 0
            by_backend["cpu"] = {"backend": "cpu", "source": "live_tensors",
                                 "bytes_in_use": live, "bytes_limit": 0,
                                 "peak_bytes": live,
                                 "live_buffer_bytes": live}
        for platform, agg in by_backend.items():
            with self._lock:
                peak = max(self._hbm_watermark.get(platform, 0.0),
                           float(agg["peak_bytes"]),
                           float(agg["bytes_in_use"]))
                self._hbm_watermark[platform] = peak
            agg["watermark_bytes"] = peak
            in_use.set(agg["bytes_in_use"], backend=platform)
            peak_g.set(peak, backend=platform)
            live_g.set(agg["live_buffer_bytes"], backend=platform)
            if agg["bytes_limit"]:
                limit_g.set(agg["bytes_limit"], backend=platform)
        return by_backend


def _env_float(name: str) -> Optional[float]:
    raw = os.environ.get(name)
    if not raw:
        return None
    try:
        return float(raw)
    except ValueError:
        return None


# -- the wrapper ---------------------------------------------------------

class ProfiledFunction:
    """Transparent profiling wrapper around a callable.

    Call syntax passes through untouched; other attributes delegate to
    the wrapped callable. The GLOBAL profiler is resolved per call (same
    pattern as ``obs.get_tracer``), so swapping it for test isolation
    works.

    ``skip_args``/``skip_kwargs`` name shape-stable arguments (params
    trees, static configs) left out of the per-call signature scan.
    ``block=False`` keeps asynchronous launch semantics (the trainer's
    gradient pass, whose metrics the caller syncs) at the price of the
    step histogram recording the launch rather than the device time.
    """

    def __init__(self, fn: Callable, name: str, *,
                 skip_args: Sequence[int] = (),
                 skip_kwargs: Sequence[str] = (),
                 block: bool = True,
                 storm_threshold: int = 10,
                 mem_every: int = 64):
        self._fn = fn
        self.profile_name = name
        self.skip_args = tuple(skip_args)
        self.skip_kwargs = tuple(skip_kwargs)
        self.block = block
        self.storm_threshold = int(storm_threshold)
        self.mem_every = int(mem_every)
        self._mem_countdown = int(mem_every)

    @property
    def wrapped(self) -> Callable:
        return self._fn

    @property
    def __wrapped__(self) -> Callable:
        return self._fn

    def __getattr__(self, item: str) -> Any:
        return getattr(self._fn, item)

    def __repr__(self) -> str:
        return f"ProfiledFunction({self.profile_name!r})"

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        prof = get_profiler()
        if not prof.enabled:
            return self._fn(*args, **kwargs)
        sig, h2d = signature_of(args, kwargs, self.skip_args,
                                self.skip_kwargs)
        # FLOP count BEFORE the timed call, so its work stays out of the
        # timed window.
        cost = prof.maybe_cost_analysis(self, sig, args, kwargs)
        frame = {"compile_s": 0.0, "builds": 0}
        st = _frames()
        st.append(frame)
        t0 = time.perf_counter()
        try:
            out = self._fn(*args, **kwargs)
            if self.block:
                for dev in _cuda_devices(out):
                    torch.cuda.synchronize(dev)
        finally:
            st.pop()
        step_ms = (time.perf_counter() - t0) * 1_000.0
        prof.record_call(self, sig, compiled=frame["builds"] > 0,
                         compile_s=frame["compile_s"], step_ms=step_ms,
                         h2d_bytes=h2d, cost=cost)
        self._mem_countdown -= 1
        if self._mem_countdown <= 0:
            self._mem_countdown = self.mem_every
            try:
                prof.sample_memory(scan_host=False)
            except Exception:
                pass
        return out


def _to_host(tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return tree.cpu()
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_to_host(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


def profiled_device_get(tree: Any, fn: str = "host") -> Any:
    """``.cpu()`` of every tensor in ``tree`` (dicts, lists, tuples) with
    the device→host bytes accounted to ``fn``
    (``senweaver_runtime_transfer_bytes_total{direction="d2h"}``). Tensors
    already on the host are returned as they are and count no bytes."""
    moved = sum(leaf.numel() * leaf.element_size()
                for leaf in _tree_leaves(tree)[1]
                if isinstance(leaf, torch.Tensor)
                and leaf.device.type != "cpu")
    out = _to_host(tree)
    prof = get_profiler()
    if prof.enabled:
        prof.account_transfer(fn, moved, direction="d2h")
    return out


# -- process-global profiler ---------------------------------------------

_profiler_lock = threading.Lock()
_profiler: Optional[RuntimeProfiler] = None


def get_profiler() -> RuntimeProfiler:
    global _profiler
    with _profiler_lock:
        if _profiler is None:
            _profiler = RuntimeProfiler()
        return _profiler


def set_profiler(profiler: Optional[RuntimeProfiler]) -> None:
    """Swap the global (None → rebuild lazily). Test isolation hook,
    called from ``obs._reset_for_tests``."""
    global _profiler
    with _profiler_lock:
        _profiler = profiler


def sample_memory() -> Dict[str, Dict[str, Any]]:
    """Module-level convenience: sample device-memory watermarks via the
    global profiler."""
    return get_profiler().sample_memory()
