"""obs — unified tracing + metrics for the trainer/rollout plane.

Three pieces (docs/observability.md):

- :mod:`.tracing` — structured spans (``trace_id``/``span_id``/
  ``parent_id`` over contextvars) with JSONL + Chrome-trace exporters;
- :mod:`.metrics` — a Prometheus-style registry (Counter/Gauge/
  Histogram, labelled, thread-safe) rendered from ``GET /metrics``;
- :mod:`.telemetry` — per-round tokens/sec, step-time breakdown, and
  analytic MFU published into the registry.

Instrumented hot paths (rl_loop, trainer, engine, agent loop, beam
search, trace collector) fetch the PROCESS-GLOBAL tracer/registry via
:func:`get_tracer`/:func:`get_registry` at call time. Tracing defaults
OFF — a disabled tracer's ``span()`` returns a shared no-op context
manager, so instrumentation sites cost one branch. Enable with::

    from senweaver_ide_tpu_torch import obs
    obs.enable(span_jsonl="spans.jsonl")     # spans stream as they finish
    ... run a round ...
    obs.get_tracer().write_chrome_trace("trace.json")   # Perfetto-loadable

The registry is always live (per-round telemetry is a handful of dict
writes); only span recording and per-token engine counters gate on
:func:`is_enabled`.
"""

from __future__ import annotations

import threading
from typing import Optional

from .alerts import AlertManager, AlertRule, default_alert_rules
from .federation import (FleetMetricsStore, MetricsFederator,
                         MetricsScrapeMixin)
from .incidents import (EventJournal, Incident, IncidentCorrelator,
                        emit_event, get_event_journal, set_event_journal)
from .metrics import (Counter, DEFAULT_MS_BUCKETS, Gauge, Histogram,
                      MetricsRegistry)
from .propagation import (TraceContext, clock_skew_s, extract,
                          format_traceparent, inject, parse_traceparent,
                          server_span)
from .runtime_profile import (ProfiledFunction, RuntimeProfiler,
                              get_profiler, profiled_device_get,
                              sample_memory, set_profiler)
from .slo import (SECONDS_BUCKETS, SLOConfig, SLOTarget, SLOTracker)
from .telemetry import StepTelemetry, advantage_stats, estimate_mfu
from .training_health import (TrainingHealthConfig, TrainingHealthMonitor,
                              evaluate_health, get_health_monitor,
                              set_health_monitor)
from .timeline import RequestTimeline, TimelineRecorder
from .tracing import SpanRecord, Tracer, load_span_jsonl, stitch_summary

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "DEFAULT_MS_BUCKETS", "SECONDS_BUCKETS",
    "SpanRecord", "Tracer", "load_span_jsonl", "stitch_summary",
    "TraceContext", "format_traceparent", "parse_traceparent",
    "inject", "extract", "clock_skew_s", "server_span",
    "RequestTimeline", "TimelineRecorder",
    "SLOConfig", "SLOTarget", "SLOTracker",
    "FleetMetricsStore", "MetricsFederator", "MetricsScrapeMixin",
    "AlertManager", "AlertRule", "default_alert_rules",
    "EventJournal", "Incident", "IncidentCorrelator",
    "emit_event", "get_event_journal", "set_event_journal",
    "StepTelemetry", "advantage_stats", "estimate_mfu",
    "ProfiledFunction", "RuntimeProfiler", "get_profiler",
    "profiled_device_get", "sample_memory", "set_profiler",
    "TrainingHealthConfig", "TrainingHealthMonitor", "evaluate_health",
    "get_health_monitor", "set_health_monitor",
    "get_tracer", "get_registry", "enable", "disable", "is_enabled",
    "traced",
]

_lock = threading.Lock()
_tracer = Tracer(enabled=False)
_registry = MetricsRegistry()


def get_tracer() -> Tracer:
    return _tracer


def get_registry() -> MetricsRegistry:
    return _registry


def enable(span_jsonl: Optional[str] = None) -> Tracer:
    """Turn on span tracing process-wide (optionally streaming every
    finished span to ``span_jsonl``); returns the global tracer."""
    _tracer.enable(span_jsonl)
    return _tracer


def disable() -> None:
    _tracer.disable()


def is_enabled() -> bool:
    return _tracer.enabled


def traced(name: Optional[str] = None):
    """Decorator tracing a function under the GLOBAL tracer (resolved
    per call, so tests swapping the global see the right one)::

        @obs.traced("reward.score_trace")
        def score_trace(...): ...
    """
    import functools

    def deco(fn):
        span_name = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            t = _tracer
            if not t.enabled:
                return fn(*args, **kwargs)
            with t.span(span_name):
                return fn(*args, **kwargs)
        return wrapper
    return deco


def _reset_for_tests() -> None:
    """Swap in a fresh tracer + registry (test isolation only).

    Instrumented code fetches the globals at call time, so swapping is
    safe; objects that CACHED instruments at construction (bridged
    MetricsService/PerformanceMonitor built with an explicit registry)
    keep their own references by design.
    """
    global _tracer, _registry
    with _lock:
        old = _tracer
        _tracer = Tracer(enabled=False)
        _registry = MetricsRegistry()
    set_health_monitor(None)   # next get_health_monitor() rebuilds
    set_profiler(None)         # next get_profiler() rebuilds
    set_event_journal(None)    # next get_event_journal() rebuilds
    old.close()
