"""Trace collector — host-side RL data infrastructure.

Semantics mirror ``common/traceCollectorService.ts`` (reference):
- fire-and-forget span recording that never throws into the caller
  (ref ``queueMicrotask`` at :430,:467,:492 — here a non-blocking in-process
  append; the hot path is synchronous-cheap, persistence is deferred),
- per-thread active trace with auto-create (``_getOrCreateTrace`` :265-273),
- bounded storage MAX_TRACES=1000 / MAX_SPANS_PER_TRACE=200 (:219-220),
- summary aggregation identical to recordLLMCall/recordToolCall/... (:459-570),
- reward computed on endTrace / recordUserFeedback (:408-417,:532-556) via the
  jit reward head,
- periodic flush (30 s, :221) to a JSONL WAL instead of browser storage.

TPU-first design note: the collector is pure host-side plumbing. Rewards are
computed by :func:`senweaver_ide_tpu_torch.rewards.head.compute_reward` — a jitted,
vmappable function — so batch re-scoring of the whole store is one vmap call.
"""

from __future__ import annotations

import json

import threading
import time
from typing import Any, Callable, Dict, List, Optional

from .schema import (
    FLUSH_INTERVAL_S,
    MAX_SPANS_PER_TRACE,
    MAX_TRACES,
    Span,
    SpanData,
    SpanType,
    ToolNameStats,
    Trace,
    TraceSummary,
    make_trace,
    new_id,
    preview,
)
from .store import TraceStore


def _now_ms() -> float:
    return time.time() * 1000.0


class TraceCollector:
    """In-memory trace collector with optional WAL persistence.

    All ``record_*`` methods are cheap, never raise, and may be called from
    any thread (a single lock guards the maps — the reference relies on the
    JS event loop; here we make thread-safety explicit since rollout workers
    are concurrent).
    """

    def __init__(self, store: Optional[TraceStore] = None,
                 reward_fn: Optional[Callable[[Trace], None]] = None,
                 max_traces: int = MAX_TRACES,
                 max_spans_per_trace: int = MAX_SPANS_PER_TRACE,
                 flush_interval_s: float = FLUSH_INTERVAL_S,
                 span_sink: Optional[Callable[[bytes], Any]] = None):
        self._traces: Dict[str, Trace] = {}     # guarded-by: _lock
        # thread_id -> trace_id
        self._active: Dict[str, str] = {}       # guarded-by: _lock
        # "thread:idx" -> feedback
        self._feedbacks: Dict[str, Optional[str]] = {}  # guarded-by: _lock
        self._lock = threading.RLock()
        self._store = store
        self._reward_fn = reward_fn
        self._max_traces = max_traces
        self._max_spans = max_spans_per_trace
        self._flush_interval_s = flush_interval_s
        # Optional low-latency span sink (e.g. runtime.TraceRing.append):
        # every accepted span is serialized and handed over, fire-and-forget
        # like the reference's queueMicrotask writes.
        self._span_sink = span_sink
        self._last_flush = time.time()          # guarded-by: _lock
        self._dirty = False                     # guarded-by: _lock
        if store is not None:
            for tr in store.load():
                self._traces[tr.id] = tr
            self._feedbacks.update(store.load_feedbacks())

    # --- lifecycle (ref traceCollectorService.ts:380-425) ---

    def start_trace(self, thread_id: str,
                    metadata: Optional[Dict[str, Any]] = None) -> str:
        with self._lock:
            tr = make_trace(thread_id, metadata=metadata)
            self._traces[tr.id] = tr
            self._active[thread_id] = tr.id
            self._dirty = True
            self._enforce_bounds()
            return tr.id

    def end_trace(self, trace_id: str) -> None:
        with self._lock:
            tr = self._traces.get(trace_id)
            if tr is None:
                return
            tr.end_time = _now_ms()
            self._compute_reward(tr)
            self._dirty = True
            self._maybe_flush()

    def end_trace_for_thread(self, thread_id: str) -> None:
        with self._lock:
            tid = self._active.get(thread_id)
            if tid:
                self.end_trace(tid)

    # --- span recording (ref :429-570; never raises) ---

    def record_user_message(self, thread_id: str, message_idx: int,
                            content: str) -> None:
        try:
            with self._lock:
                tr = self._get_or_create(thread_id)
                self._add_span(tr, self._span(tr, thread_id, message_idx,
                               SpanType.USER_MESSAGE,
                               SpanData(content_preview=preview(content),
                                        content_length=len(content))))
        except Exception:
            pass

    def record_assistant_message(self, thread_id: str, message_idx: int,
                                 content: str, model: Optional[str] = None,
                                 provider: Optional[str] = None) -> None:
        try:
            with self._lock:
                tr = self._get_or_create(thread_id)
                self._add_span(tr, self._span(tr, thread_id, message_idx,
                               SpanType.ASSISTANT_MESSAGE,
                               SpanData(content_preview=preview(content),
                                        content_length=len(content),
                                        model=model, provider=provider)))
        except Exception:
            pass

    def record_llm_call(self, thread_id: str, message_idx: int, *,
                        model: Optional[str] = None,
                        provider: Optional[str] = None,
                        input_tokens: int = 0, output_tokens: int = 0,
                        temperature: Optional[float] = None,
                        duration_ms: Optional[float] = None) -> None:
        try:
            with self._lock:
                tr = self._get_or_create(thread_id)
                sp = self._span(tr, thread_id, message_idx, SpanType.LLM_CALL,
                                SpanData(model=model, provider=provider,
                                         input_tokens=input_tokens,
                                         output_tokens=output_tokens,
                                         temperature=temperature))
                sp.duration_ms = duration_ms
                self._add_span(tr, sp)
                tr.summary.total_llm_calls += 1
                tr.summary.total_tokens += (input_tokens or 0) + (output_tokens or 0)
        except Exception:
            pass

    def record_tool_call(self, thread_id: str, message_idx: int, *,
                         tool_name: str, tool_params: Optional[str] = None,
                         tool_result: Optional[str] = None,
                         tool_success: bool = True,
                         duration_ms: Optional[float] = None) -> None:
        try:
            with self._lock:
                tr = self._get_or_create(thread_id)
                sp = self._span(tr, thread_id, message_idx, SpanType.TOOL_CALL,
                                SpanData(tool_name=tool_name,
                                         tool_params=preview(tool_params),
                                         tool_result=preview(tool_result),
                                         tool_success=tool_success))
                sp.duration_ms = duration_ms
                self._add_span(tr, sp)
                s = tr.summary
                s.total_tool_calls += 1
                if tool_success:
                    s.tool_calls_succeeded += 1
                else:
                    s.tool_calls_failed += 1
                stats = s.tool_calls_by_name.setdefault(tool_name, ToolNameStats())
                stats.total += 1
                if tool_success:
                    stats.succeeded += 1
                else:
                    stats.failed += 1
                if duration_ms and duration_ms > 0:
                    s.total_tool_duration_ms += duration_ms
                self._dirty = True
        except Exception:
            pass

    def record_user_feedback(self, thread_id: str, message_idx: int,
                             feedback: Optional[str]) -> None:
        """Feedback recompute is immediate (ref :532-556) — it is the
        highest-weight reward dimension."""
        try:
            with self._lock:
                self._feedbacks[f"{thread_id}:{message_idx}"] = feedback
                tr = self._get_or_create(thread_id)
                self._add_span(tr, self._span(tr, thread_id, message_idx,
                               SpanType.USER_FEEDBACK,
                               SpanData(feedback=feedback)))
                tr.summary.user_feedback = feedback
                self._dirty = True
                self._compute_reward(tr)
                self.flush()
        except Exception:
            pass

    def record_error(self, thread_id: str, message_idx: int,
                     error_message: str) -> None:
        try:
            with self._lock:
                tr = self._get_or_create(thread_id)
                self._add_span(tr, self._span(tr, thread_id, message_idx,
                               SpanType.ERROR,
                               SpanData(error_message=preview(error_message, 1000))))
                tr.summary.has_errors = True
        except Exception:
            pass

    # --- queries (ref :577-662) ---

    def get_feedback(self, thread_id: str, message_idx: int) -> Optional[str]:
        return self._feedbacks.get(f"{thread_id}:{message_idx}")

    def get_all_traces(self) -> List[Trace]:
        with self._lock:
            return list(self._traces.values())

    def get_trace(self, trace_id: str) -> Optional[Trace]:
        with self._lock:
            return self._traces.get(trace_id)

    def get_stats(self) -> Dict[str, Any]:
        with self._lock:
            traces = list(self._traces.values())
            feedbacks = list(self._feedbacks.values())
        total_spans = sum(len(t.spans) for t in traces)
        good = sum(1 for f in feedbacks if f == "good")
        bad = sum(1 for f in feedbacks if f == "bad")
        tool_calls = sum(t.summary.total_tool_calls for t in traces)
        tool_ok = sum(t.summary.tool_calls_succeeded for t in traces)
        tool_fail = sum(t.summary.tool_calls_failed for t in traces)
        with_reward = [t for t in traces if t.summary.final_reward is not None]
        return {
            "total_traces": len(traces),
            "total_spans": total_spans,
            "total_feedbacks": good + bad,
            "good_feedbacks": good,
            "bad_feedbacks": bad,
            "oldest_trace_time": min((t.start_time for t in traces), default=None),
            "newest_trace_time": max((t.start_time for t in traces), default=None),
            "total_tool_calls": tool_calls,
            "total_tool_succeeded": tool_ok,
            "total_tool_failed": tool_fail,
            "tool_success_rate": tool_ok / tool_calls if tool_calls > 0 else None,
            "avg_final_reward": (sum(t.summary.final_reward for t in with_reward)
                                 / len(with_reward)) if with_reward else None,
            "traces_with_reward": len(with_reward),
        }

    def clear_all(self) -> None:
        with self._lock:
            self._traces.clear()
            self._active.clear()
            self._feedbacks.clear()
            if self._store is not None:
                self._store.clear()

    def flush(self) -> None:
        with self._lock:
            if self._store is not None and self._dirty:
                self._store.save(list(self._traces.values()))
                self._store.save_feedbacks(dict(self._feedbacks))
            self._dirty = False
            self._last_flush = time.time()

    def get_active_trace(self, thread_id: str) -> Optional[Trace]:
        """The thread's CURRENT trace (the one feedback would land on).

        ``_active`` keeps pointing at the latest trace after
        ``end_trace_for_thread`` by design — the reference records
        post-turn user feedback against the finished conversation
        (``:532-556``), and the online loop reads the same handle to
        judge an episode just collected."""
        with self._lock:
            tid = self._active.get(thread_id)
            return self._traces.get(tid) if tid else None

    # --- internals ---

    def _get_or_create(self, thread_id: str) -> Trace:
        tid = self._active.get(thread_id)
        if tid and tid in self._traces:
            return self._traces[tid]
        return self._traces[self.start_trace(thread_id)]

    def _span(self, tr: Trace, thread_id: str, message_idx: int,
              type_: SpanType, data: SpanData) -> Span:
        return Span(id=new_id(), trace_id=tr.id, thread_id=thread_id,
                    message_idx=message_idx, type=type_,
                    timestamp=_now_ms(), data=data)

    def _add_span(self, tr: Trace, span: Span) -> None:
        # guarded-by: caller
        if len(tr.spans) >= self._max_spans:  # ref :275-277 overflow guard
            return
        tr.spans.append(span)
        # obs bridge (gated on tracing being enabled — this is a per-span
        # hot path): conversation-span volume by type on /metrics.
        from ..obs import get_registry, is_enabled
        if is_enabled():
            try:
                get_registry().counter(
                    "senweaver_trace_spans_total",
                    "Conversation spans accepted by TraceCollector.",
                    labelnames=("type",)).inc(type=span.type.value)
            except Exception:
                pass
        if self._span_sink is not None:
            try:
                self._span_sink(
                    json.dumps(span.to_dict()).encode("utf-8"))
            except Exception:
                pass  # fire-and-forget (ref silent catch :430-439)
        self._dirty = True
        self._maybe_flush()

    def _enforce_bounds(self) -> None:
        # guarded-by: caller
        if len(self._traces) <= self._max_traces:
            return
        # Keep the newest (ref _saveToStorage :339-349).
        keep = sorted(self._traces.values(), key=lambda t: t.start_time,
                      reverse=True)[: self._max_traces]
        self._traces = {t.id: t for t in keep}

    def _maybe_flush(self) -> None:
        if (self._store is not None
                and time.time() - self._last_flush >= self._flush_interval_s):
            self.flush()

    def _compute_reward(self, tr: Trace) -> None:
        if self._reward_fn is not None:
            self._reward_fn(tr)
        else:
            # Late import: rewards depends on traces.features, not vice versa.
            from ..rewards.head import score_trace
            score_trace(tr)
