"""One run of one cell: set-up, the measured window, the metrics, the
comparison that decides ``correct``, and the result line.

Everything a cell needs is found by name: its entry in ``BENCHMARK.json``,
``configs/<config>.json``, ``traffic/<traffic>.json`` (whose ``kind``
names ``drivers/<kind>.py``), ``limits/<cell>.json`` and one reader
``layer_metrics/<metric>.py`` for each per-layer metric.

A driver module has three functions:

- ``setup(ctx) -> state``: builds the system under test from the seed and
  warms up every shape the cell's traffic uses;
- ``window(ctx, state, seconds) -> Window``: drives the traffic for
  ``seconds`` inside one ``harness.window`` span;
- ``finish(ctx, state, win) -> {"program": {...}, "control": {...}}``:
  frees the program's state and compares what the window produced with
  the plain reference (and, when ``ctx.control`` is set, the control with
  it), returning each compared number by name.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import math
import os
import sys
import time
from typing import Dict, List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
# the JAX package and JAX itself: a run that loaded any of them is void
FORBIDDEN = ("jax", "jaxlib", "flax", "senweaver_ide_tpu")
# the traced run's two windows, in seconds at most each: an untraced one
# whose host clock the rate-based readers read, then the profiled one
# (the trace of a longer one takes minutes to read)
TRACE_SECONDS = 10


@dataclasses.dataclass
class Window:
    """What a driver's window returns: the end-to-end values it measured
    by name, the work attempted and failed, and the record the per-layer
    readers read (``stats``: the program's counter deltas; ``steps``: the
    harness's record of each step's shape; ``window_s``: the window's
    length on the host's clock; anything else the driver keeps)."""

    values: Dict[str, float]
    attempted: int
    failed: int
    record: dict


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]


class Ctx:
    """What a driver gets: the cell, the run's arguments and the spans."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool,
                 device: str, control: Optional[str]):
        self.cell, self.seed, self.seconds = cell, seed, seconds
        self.trace, self.device, self.control = trace, device, control
        self.cfg = cell.config
        self.traffic = cell.traffic
        # (name, start_ns, end_ns) on the clock of the profiler's trace
        self.spans: List[tuple] = []
        self.profiling = False

    @contextlib.contextmanager
    def span(self, name: str):
        """A harness span around a call into one layer (kept while the
        profiler records only)."""
        if not self.profiling:
            yield
            return
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.spans.append(("harness." + name, t0, time.time_ns()))

    def sync(self) -> None:
        import torch
        if self.device != "cpu":
            torch.cuda.synchronize()

    def model_config(self):
        return model_config(self.cfg)


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _named(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def load_cell(name: str, root: str = ROOT) -> Cell:
    spec = _load_json(os.path.join(root, "BENCHMARK.json"))
    wl = _named(spec["workloads"], name, "workload")
    cfg_entry = _named(spec["configs"], wl["config"], "config")
    bench = os.path.join(root, "benchmark")
    e2e = [m for m in spec["end_to_end"]
           if name in m.get("workloads", [name])]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in e2e_names)]
    limits_path = os.path.join(bench, "limits", f"{name}.json")
    return Cell(name=name, chips=int(wl["chips"]),
                config=_load_json(os.path.join(root, cfg_entry["file"])),
                traffic=_load_json(os.path.join(bench, "traffic",
                                                f"{wl['traffic']}.json")),
                limits=(_load_json(limits_path)
                        if os.path.exists(limits_path) else {}),
                end_to_end=e2e, per_layer=per_layer)


# The program's preset fields and the configuration file's keys.
_WIDTHS = {"vocab_size": "vocab_size", "hidden_size": "hidden_size",
           "intermediate_size": "intermediate_size",
           "num_layers": "num_hidden_layers",
           "num_heads": "num_attention_heads",
           "num_kv_heads": "num_key_value_heads", "head_dim": "head_dim",
           "rope_theta": "rope_theta", "rms_norm_eps": "rms_norm_eps",
           "max_seq_len": "max_position_embeddings",
           "tie_word_embeddings": "tie_word_embeddings",
           "qkv_bias": "attention_bias"}


def model_config(cfg: dict):
    """The program's preset named by the configuration file, checked to
    hold every width the file states, with the file's port settings."""
    import torch

    from senweaver_ide_tpu_torch.models import get_config
    mc = get_config(cfg["preset"])
    for field, key in _WIDTHS.items():
        if getattr(mc, field) != cfg[key]:
            raise ValueError(f"preset {cfg['preset']!r} has {field}="
                             f"{getattr(mc, field)!r}, the configuration "
                             f"file {key}={cfg[key]!r}")
    if mc.dtype != getattr(torch, cfg["torch_dtype"]):
        raise ValueError(f"preset dtype {mc.dtype} != {cfg['torch_dtype']}")
    return dataclasses.replace(mc, **cfg["port"])


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(kind: str, root: str = ROOT):
    return load_module(os.path.join(root, "benchmark", "drivers",
                                    f"{kind}.py"), f"_bench_driver_{kind}")


def reader(metric: str, root: str = ROOT):
    return load_module(os.path.join(root, "benchmark", "layer_metrics",
                                    f"{metric}.py"),
                       "_bench_metric_" + metric.replace(".", "_"))


class LayerInput:
    """What a per-layer reader gets from the traced run: ``host``, the
    record of its untraced window (counters, step shapes and its length
    on the host's clock, undisturbed by the profiler), and ``trace``,
    ``steps`` and ``stats`` of the profiled window after it."""

    def __init__(self, cell: Cell, trace, host: Window, win: Window,
                 peak: Optional[dict], mem_window_peak_bytes: int):
        self.cfg = cell.config
        self.traffic = cell.traffic
        self.trace = trace                  # profiling.DeviceTrace
        self.host = host.record
        self.stats = win.record.get("stats", {})
        self.steps = win.record.get("steps", [])
        self.peak = peak                    # yardstick.peak(), or None
        self.mem_window_peak_bytes = mem_window_peak_bytes


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def _checks(cell: Cell, values: Dict[str, float]) -> Dict[str, dict]:
    """Each compared number beside its limit. A number the cell's limits
    file names under ``not_compared`` (with the reason) is read but not
    held to a limit; any other number whose limit the file does not give
    has the limit None and fails."""
    limits = cell.limits.get("checks", {})
    skip = cell.limits.get("not_compared", {})
    return {k: {"value": v, "limit": limits.get(k, {}).get("limit")}
            for k, v in values.items() if k not in skip}


def _ok(check: dict) -> bool:
    v, lim = check["value"], check["limit"]
    return (lim is not None and v is not None and not math.isnan(v)
            and v <= lim)


def run(name: str, seed: int, seconds: float, trace: bool, *,
        device: str = "cuda", control: Optional[str] = None,
        root: str = ROOT, t_start: Optional[float] = None):
    """Run cell ``name`` once. Returns (result dict, readings), where
    ``readings`` has the program's compared numbers and, with
    ``control``, the control's."""
    import torch

    from . import profiling, yardstick
    t_start = time.perf_counter() if t_start is None else t_start
    cell = load_cell(name, root)
    ctx = Ctx(cell, seed, seconds, trace, device, control)
    drv = driver(cell.traffic["kind"], root)
    on_card = device != "cpu"
    if on_card:
        torch.cuda.set_device(0)
    state = drv.setup(ctx)
    ctx.sync()
    setup_s = time.perf_counter() - t_start
    setup_peak = torch.cuda.max_memory_allocated() if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    prof: dict = {}
    win_seconds = min(seconds, TRACE_SECONDS) if trace else seconds
    t_window = time.perf_counter()
    host = drv.window(ctx, state, win_seconds) if trace else None
    ctx.profiling = trace
    with profiling.profiled(trace, prof, ctx.spans):
        win = drv.window(ctx, state, win_seconds)
    ctx.profiling = False
    window_peak = torch.cuda.max_memory_allocated() if on_card else 0
    t_finish = time.perf_counter()
    readings = drv.finish(ctx, state, win)
    del state
    readings["diag"] = win.record.get("diag", {})
    readings["seconds"] = {"setup": setup_s,
                           "window": t_finish - t_window,
                           "compare": time.perf_counter() - t_finish}
    values = readings["control"] if control else readings["program"]
    checks = _checks(cell, values)
    attempted, failed = win.attempted, win.failed
    if host is not None:
        attempted, failed = attempted + host.attempted, failed + host.failed
    correct = (failed == 0 and bool(checks)
               and all(_ok(c) for c in checks.values()))
    dev_name = torch.cuda.get_device_name(0) if on_card else "cpu"
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": dev_name, "count": cell.chips,
                   "memory_peak_bytes": int(max(setup_peak, window_peak))}
    metrics: Dict[str, dict] = {}
    result = {"correct": correct, "attempted": attempted,
              "failed": failed, "metrics": metrics,
              "device": device_info}
    if not trace:
        vals = dict(win.values, setup_s=setup_s)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": vals[m["name"]],
                                  "unit": m["unit"]}
    else:
        tr = prof["trace"]
        readings["diag"]["trace_alignment_ms"] = tr.alignment_ms()
        device_info["busy_s"] = tr.busy_s
        device_info["window_s"] = tr.window_s
        inp = LayerInput(cell, tr, host, win, yardstick.peak(dev_name),
                         window_peak)
        for m in cell.per_layer:
            v = reader(m["name"], root).read(inp)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        result["breakdown"] = {"device_ops": tr.top_ops(),
                               "idle_gaps": tr.idle_gaps()}
    result["checks"] = checks
    return result, readings
