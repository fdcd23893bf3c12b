"""Structured span tracing for the training/rollout loop.

SURVEY.md §5 asks for first-class self-observability; the seed only had
flat stage timings (services/perf_monitor.py) with no correlation across
an episode (agent loop → rollout engine → reward head → train step).
This module supplies the missing trace layer: a :class:`Tracer` whose
spans carry ``trace_id``/``span_id``/``parent_id`` propagated through
``contextvars`` (so nesting is automatic within a thread and explicit
across threads via :meth:`Tracer.capture`/:meth:`Tracer.attach`), with
exporters for JSONL and the Chrome trace-event format — the latter loads
directly into Perfetto / ``chrome://tracing`` and is the repo's first
cross-component flamegraph of a full GRPO round.

Design constraints, in order:
1. Disabled tracing must be free: ``span()`` on a disabled tracer
   returns one shared no-op context manager (a bool check + two empty
   method calls on the hot path — RLAX/Podracer-style always-on
   instrumentation sites stay in the code, the cost does not).
2. Recording never raises into the instrumented caller.
3. Thread-safe: rollout episodes record from a thread pool.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import json
import os
import threading
import time
import uuid
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

# (trace_id, span_id) of the active span in this execution context.
_Ctx = Tuple[str, str]


def _new_id() -> str:
    return uuid.uuid4().hex[:16]


@dataclasses.dataclass
class SpanRecord:
    """One finished span. ``start_s`` is epoch seconds; durations are ms."""
    name: str
    trace_id: str
    span_id: str
    parent_id: Optional[str]
    start_s: float
    duration_ms: float
    thread: str
    tid: int
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


class _NoopSpan:
    """Shared do-nothing context manager — the disabled fast path."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP = _NoopSpan()


class _ActiveSpan:
    """Context manager for one live span on an enabled tracer."""
    __slots__ = ("_tracer", "_name", "_attrs", "_token", "_ctx", "_t0",
                 "_start_s")

    def __init__(self, tracer: "Tracer", name: str, attrs: Dict[str, Any]):
        self._tracer = tracer
        self._name = name
        self._attrs = attrs

    def __enter__(self) -> "_ActiveSpan":
        tracer = self._tracer
        parent = tracer._ctx.get()
        trace_id = parent[0] if parent else _new_id()
        span_id = _new_id()
        self._ctx = (trace_id, span_id,
                     parent[1] if parent else None)
        self._token = tracer._ctx.set((trace_id, span_id))
        self._start_s = time.time()
        self._t0 = time.perf_counter()
        return self

    def set_attr(self, key: str, value: Any) -> None:
        self._attrs[key] = value

    def __exit__(self, exc_type, exc, tb) -> bool:
        duration_ms = (time.perf_counter() - self._t0) * 1000.0
        tracer = self._tracer
        tracer._ctx.reset(self._token)
        if exc_type is not None:
            self._attrs["error"] = f"{exc_type.__name__}: {exc}"
        trace_id, span_id, parent_id = self._ctx
        cur = threading.current_thread()
        tracer._record(SpanRecord(
            name=self._name, trace_id=trace_id, span_id=span_id,
            parent_id=parent_id, start_s=self._start_s,
            duration_ms=duration_ms, thread=cur.name, tid=cur.ident or 0,
            attrs=self._attrs))
        return False


class Tracer:
    """Span recorder with contextvar propagation + bounded storage.

    ``max_spans`` bounds host memory (oldest spans drop first, like the
    trace collector's MAX_TRACES); ``jsonl_path`` additionally streams
    every finished span to an append-only JSONL file (flushed per span,
    so ``scripts/obs_report.py`` and ``tail -f`` see live data).
    """

    def __init__(self, *, enabled: bool = False, max_spans: int = 20_000,
                 jsonl_path: Optional[str] = None):
        self.enabled = enabled
        self._ctx: contextvars.ContextVar[Optional[_Ctx]] = \
            contextvars.ContextVar(f"senweaver_obs_{id(self):x}",
                                   default=None)
        self._spans: Deque[SpanRecord] = deque(maxlen=max_spans)
        self._lock = threading.Lock()
        self._jsonl_path = jsonl_path
        self._fh = None
        self._dropped = 0

    # -- recording ----------------------------------------------------------

    def span(self, name: str, **attrs: Any):
        """``with tracer.span("collect", tasks=3):`` — no-op when disabled."""
        if not self.enabled:
            return _NOOP
        return _ActiveSpan(self, name, attrs)

    def traced(self, name: Optional[str] = None) -> Callable:
        """Decorator form of :meth:`span`; enabled-check happens per call."""
        def deco(fn: Callable) -> Callable:
            import functools
            span_name = name or fn.__qualname__

            @functools.wraps(fn)
            def wrapper(*args, **kwargs):
                if not self.enabled:
                    return fn(*args, **kwargs)
                with self.span(span_name):
                    return fn(*args, **kwargs)
            return wrapper
        return deco

    def _record(self, rec: SpanRecord) -> None:
        try:
            with self._lock:
                if len(self._spans) == self._spans.maxlen:
                    self._dropped += 1
                    # Surface the eviction on /metrics — a silently
                    # truncated trace looks identical to a short one.
                    # Resolved per drop (rare path) so tests swapping
                    # the global registry see their own counter.
                    try:
                        from . import get_registry
                        get_registry().counter(
                            "senweaver_obs_spans_dropped_total",
                            "Spans evicted from the tracer's bounded "
                            "in-memory buffer (max_spans reached; the "
                            "JSONL stream, when enabled, still has "
                            "them).").inc()
                    except Exception:
                        pass
                self._spans.append(rec)
                if self._jsonl_path is not None:
                    if self._fh is None:
                        self._fh = open(self._jsonl_path, "a")
                    self._fh.write(json.dumps(rec.to_dict()) + "\n")
                    self._fh.flush()
        except Exception:
            pass                     # never raise into instrumented code

    # -- cross-thread propagation -------------------------------------------

    def capture(self) -> Optional[_Ctx]:
        """Snapshot the current span context for hand-off to a worker
        thread (contextvars do not cross ``ThreadPoolExecutor``)."""
        return self._ctx.get()

    def attach(self, ctx: Optional[_Ctx]):
        """Re-establish a captured context in another thread::

            ctx = tracer.capture()
            pool.submit(lambda: run_under(tracer, ctx))
        """
        if not self.enabled or ctx is None:
            return _NOOP
        return self._attach_cm(ctx)

    @contextlib.contextmanager
    def _attach_cm(self, ctx: _Ctx):
        token = self._ctx.set(ctx)
        try:
            yield
        finally:
            self._ctx.reset(token)

    # -- lifecycle ----------------------------------------------------------

    def enable(self, jsonl_path: Optional[str] = None) -> None:
        if jsonl_path is not None:
            self.set_jsonl_path(jsonl_path)
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def set_jsonl_path(self, path: Optional[str]) -> None:
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.close()
                except Exception:
                    pass
                self._fh = None
            self._jsonl_path = path

    def close(self) -> None:
        self.set_jsonl_path(self._jsonl_path)

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self._dropped = 0

    # -- export / query -----------------------------------------------------

    def spans(self) -> List[SpanRecord]:
        with self._lock:
            return list(self._spans)

    def summary(self, top: int = 5) -> Dict[str, Any]:
        """Aggregate view for dashboards: per-name counts/totals plus the
        ``top`` slowest individual spans."""
        spans = self.spans()
        by_name: Dict[str, Dict[str, float]] = {}
        for s in spans:
            agg = by_name.setdefault(s.name, {"count": 0, "total_ms": 0.0,
                                              "max_ms": 0.0})
            agg["count"] += 1
            agg["total_ms"] += s.duration_ms
            agg["max_ms"] = max(agg["max_ms"], s.duration_ms)
        for agg in by_name.values():
            agg["total_ms"] = round(agg["total_ms"], 3)
            agg["max_ms"] = round(agg["max_ms"], 3)
        slowest = sorted(spans, key=lambda s: s.duration_ms,
                         reverse=True)[:top]
        return {
            "enabled": self.enabled,
            "total_spans": len(spans),
            "dropped_spans": self._dropped,
            "by_name": by_name,
            "slowest": [{"name": s.name,
                         "duration_ms": round(s.duration_ms, 3),
                         "trace_id": s.trace_id} for s in slowest],
        }

    def chrome_trace(self) -> Dict[str, Any]:
        """Chrome trace-event JSON (``chrome://tracing`` / Perfetto).

        Spans become complete ("X") events; ``ts``/``dur`` are
        microseconds per the format. Thread-name metadata events label
        each host thread's track."""
        pid = os.getpid()
        events: List[Dict[str, Any]] = []
        named_tids = {}
        for s in self.spans():
            named_tids.setdefault(s.tid, s.thread)
            events.append({
                "name": s.name, "cat": "senweaver", "ph": "X",
                "ts": s.start_s * 1e6, "dur": s.duration_ms * 1e3,
                "pid": pid, "tid": s.tid,
                "args": {**s.attrs, "trace_id": s.trace_id,
                         "span_id": s.span_id,
                         "parent_id": s.parent_id},
            })
        for tid, name in named_tids.items():
            events.append({"name": "thread_name", "ph": "M", "pid": pid,
                           "tid": tid, "args": {"name": name}})
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def write_chrome_trace(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
        return path

    def export_jsonl(self, path: str) -> str:
        """One-shot dump of the in-memory spans (distinct from the live
        ``jsonl_path`` stream, which persists spans as they finish)."""
        with open(path, "w") as f:
            for s in self.spans():
                f.write(json.dumps(s.to_dict()) + "\n")
        return path


def stitch_summary(spans: List[SpanRecord]) -> Dict[str, Any]:
    """Cross-process stitching health of a span set.

    ``rpc.client.*`` spans are the caller side, ``rpc.server.*`` the
    receiver side (possibly another process — see ``propagation.py``).
    A server span is *stitched* when its ``parent_id`` is a client
    span's id, i.e. the traceparent survived the wire; replay-annotated
    spans are idempotency-cache hits (retried RPCs that did NOT
    re-execute). ``clock_skew_s_max`` is the largest wall-clock skew a
    receiver observed against its sender's anchor."""
    client_ids = set()
    server: List[SpanRecord] = []
    traces: Dict[str, List[str]] = {}
    replays = 0
    skews: List[float] = []
    for s in spans:
        traces.setdefault(s.trace_id, []).append(s.name)
        if s.name.startswith("rpc.client."):
            client_ids.add(s.span_id)
        elif s.name.startswith("rpc.server."):
            server.append(s)
            if s.attrs.get("replay"):
                replays += 1
            skew = s.attrs.get("clock_skew_s")
            if isinstance(skew, (int, float)):
                skews.append(float(skew))
    stitched = sum(1 for s in server if s.parent_id in client_ids)
    cross = sum(
        1 for names in traces.values()
        if any(n.startswith("rpc.client.") for n in names)
        and any(n.startswith("rpc.server.") for n in names))
    return {
        "spans": len(spans),
        "traces": len(traces),
        "client_spans": len(client_ids),
        "server_spans": len(server),
        "stitched_server_spans": stitched,
        "unstitched_server_spans": len(server) - stitched,
        "cross_process_traces": cross,
        "replayed_server_spans": replays,
        "clock_skew_s_max": (round(max(abs(x) for x in skews), 6)
                             if skews else 0.0),
    }


def load_span_jsonl(path: str) -> List[SpanRecord]:
    """Parse a span JSONL (live stream or export) back into records;
    torn tail lines from a crash mid-write are skipped."""
    out: List[SpanRecord] = []
    fields = {f.name for f in dataclasses.fields(SpanRecord)}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                d = json.loads(line)
                out.append(SpanRecord(
                    **{k: v for k, v in d.items() if k in fields}))
            except (json.JSONDecodeError, TypeError):
                pass
    return out
