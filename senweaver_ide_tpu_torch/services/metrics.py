"""MetricsService: event capture with opt-out + pluggable sink.

Mirrors `common/metricsService.ts` + `electron-main/metricsMainService.ts`
(162): ``capture(event, properties)`` flows to a sink (PostHog in the
reference, :30-40) unless the user opted out (OPT_OUT_KEY). Here the
default sink is a JSONL file; any callable(dict) works (e.g. a real
telemetry client).

The JSONL sink keeps a cached append handle (flushed per capture so
tails/readers see live data; ``close()`` releases it) instead of
reopening the file per event, and an optional ``registry``
(obs.MetricsRegistry) additionally counts every capture into
``senweaver_events_total{event=...}`` — the bridge that lets legacy
captures show up on the new ``/metrics`` endpoint.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional


class MetricsService:
    def __init__(self, sink: Optional[Callable[[Dict[str, Any]], None]]
                 = None, *, jsonl_path: Optional[str] = None,
                 opted_out: bool = False,
                 common_properties: Optional[Dict[str, Any]] = None,
                 registry=None):
        self._sink = sink
        self._jsonl_path = jsonl_path
        self.opted_out = opted_out
        self.common = dict(common_properties or {})
        self._lock = threading.Lock()
        self.captured_count = 0
        self._buffer: List[Dict[str, Any]] = []   # kept when no sink set
        # Cached append handle for the JSONL sink — opened lazily on
        # first capture, flushed per event, closed via close(). Its own
        # lock so slow disk I/O never serializes capture bookkeeping.
        self._fh = None
        self._io_lock = threading.Lock()
        self._events_counter = None
        if registry is not None:
            self._events_counter = registry.counter(
                "senweaver_events_total",
                "Events captured by MetricsService.",
                labelnames=("event",))

    def set_opt_out(self, opted_out: bool) -> None:
        self.opted_out = opted_out

    def capture(self, event: str,
                properties: Optional[Dict[str, Any]] = None) -> None:
        """Fire-and-forget: never raises into the caller
        (metricsMainService.ts catch-all)."""
        if self.opted_out:
            return
        record = {"event": event, "ts": time.time(),
                  **self.common, **(properties or {})}
        # Bookkeeping under the lock; sink/file I/O outside it — a slow
        # (or reentrant) sink must not serialize or deadlock capturers.
        with self._lock:
            self.captured_count += 1
            buffered = self._sink is None and not self._jsonl_path
            if buffered:
                self._buffer.append(record)
                if len(self._buffer) > 10_000:
                    del self._buffer[:5_000]
        try:
            if self._events_counter is not None:
                self._events_counter.inc(event=event)
            if buffered:
                return
            if self._sink is not None:
                self._sink(record)
            elif self._jsonl_path:
                self._write_jsonl(record)
        except Exception:
            pass

    def _write_jsonl(self, record: Dict[str, Any]) -> None:
        with self._io_lock:
            if self._fh is None:
                self._fh = open(self._jsonl_path, "a")
            self._fh.write(json.dumps(record) + "\n")
            self._fh.flush()

    def close(self) -> None:
        """Release the cached JSONL handle (captures after close simply
        reopen it)."""
        with self._io_lock:
            if self._fh is not None:
                try:
                    self._fh.close()
                finally:
                    self._fh = None

    def __enter__(self) -> "MetricsService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def drain(self) -> List[Dict[str, Any]]:
        with self._lock:
            out, self._buffer = self._buffer, []
            return out


def load_jsonl_metrics(path: str) -> List[Dict[str, Any]]:
    out: List[Dict[str, Any]] = []
    if not os.path.exists(path):
        return out
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                try:
                    out.append(json.loads(line))
                except json.JSONDecodeError:
                    pass           # torn tail line (crash mid-write)
    return out
