"""PerformanceMonitor: threshold-checked stage timings + profiler capture.

The trainer-side analogue of ``common/performanceMonitor.ts`` (271 LoC;
DEFAULT_THRESHOLDS :46 — system-message prep 2 s / 4k tokens): named
stages are timed, compared against thresholds, and over-threshold events
are captured to MetricsService as warnings. The trainer-side addition is
:func:`profile_capture` — a ``torch.profiler`` context writing a Chrome
trace (host and, with a card, CUDA activity) of any monitored region.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, Iterator, Optional

# Reference thresholds (performanceMonitor.ts:46-50) + trainer-side ones.
DEFAULT_THRESHOLDS_MS: Dict[str, float] = {
    "system_message_prep": 2_000.0,    # ref: sysmsg build 2 s
    "message_fitting": 2_000.0,
    "rollout_collect": 600_000.0,      # a full collection phase
    "batch_build": 5_000.0,
    "train_step": 300_000.0,
}
DEFAULT_TOKEN_THRESHOLDS: Dict[str, int] = {
    "system_message_tokens": 4_000,    # ref: sysmsg 4k tokens
}


class PerformanceMonitor:
    """Stage timing with threshold warnings, metric-bridged.

    Every recorded stage lands in the ``obs.MetricsRegistry`` plane:
    ``senweaver_stage_ms{stage=...}`` histograms and a
    ``senweaver_perf_warnings_total{stage=...}`` counter. ``registry``
    defaults to the PROCESS-GLOBAL registry (``obs.get_registry()``) so
    there is ONE exporter — the monitor's legacy snapshot()/warnings
    surface and the /metrics endpoint always describe the same data.
    Pass an explicit registry to bridge elsewhere, or ``registry=False``
    to keep a monitor off the metrics plane entirely. Instruments are
    cached at construction (the documented ``_reset_for_tests``
    contract: bridged monitors keep their registry by design)."""

    def __init__(self, metrics=None,
                 thresholds_ms: Optional[Dict[str, float]] = None,
                 token_thresholds: Optional[Dict[str, int]] = None,
                 registry=None):
        self.metrics = metrics
        self.thresholds_ms = {**DEFAULT_THRESHOLDS_MS,
                              **(thresholds_ms or {})}
        self.token_thresholds = {**DEFAULT_TOKEN_THRESHOLDS,
                                 **(token_thresholds or {})}
        self.timings: Dict[str, float] = {}       # last value per stage
        self.warnings: list = []
        self._stage_hist = self._warn_counter = None
        if registry is None:
            from ..obs import get_registry
            registry = get_registry()
        if registry is not False:
            self._stage_hist = registry.histogram(
                "senweaver_stage_ms",
                "PerformanceMonitor stage wall times.",
                labelnames=("stage",))
            self._warn_counter = registry.counter(
                "senweaver_perf_warnings_total",
                "Stages observed over their threshold.",
                labelnames=("stage",))

    @contextlib.contextmanager
    def stage(self, name: str, **extra: Any) -> Iterator[None]:
        t0 = time.monotonic()
        try:
            yield
        finally:
            ms = (time.monotonic() - t0) * 1000.0
            self.record_ms(name, ms, **extra)

    def record_ms(self, name: str, ms: float, **extra: Any) -> None:
        self.timings[name] = ms
        if self._stage_hist is not None:
            self._stage_hist.observe(ms, stage=name)
        limit = self.thresholds_ms.get(name)
        if limit is not None and ms > limit:
            self._warn(name, ms, limit, "ms", extra)

    def record_tokens(self, name: str, tokens: int, **extra: Any) -> None:
        # Token stages land in timings too — snapshot() must show every
        # recorded stage, not silently omit the token-threshold ones.
        self.timings[name] = float(tokens)
        limit = self.token_thresholds.get(name)
        if limit is not None and tokens > limit:
            self._warn(name, float(tokens), float(limit), "tokens", extra)

    def _warn(self, name: str, value: float, limit: float, unit: str,
              extra: Dict[str, Any]) -> None:
        record = {"stage": name, "value": round(value, 1),
                  "threshold": limit, "unit": unit, **extra}
        self.warnings.append(record)
        del self.warnings[:-100]
        if self._warn_counter is not None:
            self._warn_counter.inc(stage=name)
        if self.metrics is not None:
            self.metrics.capture("Performance Threshold Exceeded", record)

    def snapshot(self) -> Dict[str, float]:
        return {k: round(v, 1) for k, v in self.timings.items()}


@contextlib.contextmanager
def profile_capture(log_dir: Optional[str]) -> Iterator[None]:
    """``torch.profiler.profile`` over the wrapped region when ``log_dir``
    is set (no-op otherwise): CPU activity, plus CUDA activity when a card
    is present, written as a Chrome trace (``trace_<pid>_<ns>.json``, any
    Perfetto/chrome://tracing viewer loads it) into ``log_dir`` — the
    trainer's self-observability hook."""
    if not log_dir:
        yield
        return
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
