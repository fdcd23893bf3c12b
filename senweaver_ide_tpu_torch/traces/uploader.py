"""Incremental, deduplicated trace upload.

traceCollectorService.ts:797-899 (`_uploadTraces`): batch unsent traces to
POST /api/traces with fire-and-forget semantics, then persist uploaded IDs
(:944-966) so restarts never re-send. In the TPU build the 'backend' is a
pluggable transport — by default the training-side dataset ingest (the
GRPO data pipeline consumes traces instead of a SaaS endpoint), but any
callable(list[dict]) -> bool works (e.g. HTTP for a real fleet).
"""

from __future__ import annotations

import json
import os
import threading
from typing import Callable, Dict, Iterable, List, Optional

from .schema import Trace

UPLOAD_BATCH_SIZE = 50             # ref batches uploads


class TraceUploader:
    def __init__(self, transport: Callable[[List[Dict]], bool], *,
                 uploaded_ids_path: Optional[str] = None,
                 batch_size: int = UPLOAD_BATCH_SIZE):
        self.transport = transport
        self.batch_size = batch_size
        self._path = uploaded_ids_path
        self._uploaded: set[str] = set()
        self._in_flight: set[str] = set()
        self._lock = threading.Lock()
        if self._path and os.path.exists(self._path):
            try:
                with open(self._path) as f:
                    self._uploaded = set(json.load(f))
            except (OSError, json.JSONDecodeError):
                self._uploaded = set()

    @property
    def uploaded_count(self) -> int:
        return len(self._uploaded)

    def is_uploaded(self, trace_id: str) -> bool:
        return trace_id in self._uploaded

    def upload(self, traces: Iterable[Trace]) -> int:
        """Upload unsent, ended traces in batches; returns how many were
        newly uploaded. A failed batch marks nothing (retried next cycle —
        the reference's silent-catch + next-interval behavior)."""
        with self._lock:
            pending = [t for t in traces
                       if t.id not in self._uploaded
                       and t.id not in self._in_flight
                       and t.end_time is not None]
            # Claim before releasing the lock so concurrent upload() calls
            # cannot double-send the same traces.
            self._in_flight.update(t.id for t in pending)
        # Transport I/O runs OUTSIDE the lock (a slow HTTP POST must not
        # block other uploaders); the uploaded-set update re-acquires it.
        sent_ids: List[str] = []
        try:
            for i in range(0, len(pending), self.batch_size):
                batch = pending[i:i + self.batch_size]
                try:
                    ok = self.transport([t.to_dict() for t in batch])
                except Exception:
                    ok = False
                if not ok:
                    break
                sent_ids.extend(t.id for t in batch)
        finally:
            with self._lock:
                self._in_flight.difference_update(t.id for t in pending)
                if sent_ids:
                    self._uploaded.update(sent_ids)
                    self._persist()
        return len(sent_ids)

    def _persist(self) -> None:
        if not self._path:
            return
        tmp = self._path + ".tmp"
        try:
            with open(tmp, "w") as f:
                json.dump(sorted(self._uploaded), f)
            os.replace(tmp, self._path)
        except OSError:
            pass


def http_trace_transport(url: str, *, timeout: float = 10.0,
                         headers: Optional[Dict[str, str]] = None,
                         max_retries: int = 3,
                         retry_base_s: float = 0.5,
                         retry_max_s: float = 10.0,
                         sleep: Callable[[float], None] = None,
                         rng=None) -> Callable[[List[Dict]], bool]:
    """Real HTTP transport for the uploader: POST the batch as JSON to
    ``url`` (the reference's ``POST /api/traces`` shape,
    traceCollectorService.ts:797-899). 2xx → True. Stdlib urllib — no
    SDK dependency for the fleet ingest path.

    TRANSIENT failures (connection errors, timeouts, 5xx, and 429) are
    retried in-call up to ``max_retries`` times under the SHARED
    ``resilience.retry.RetryPolicy`` (the 1.5x exponential the episode
    boundary and the serving router also use) with 0.5–1.5x jitter —
    each retry increments ``senweaver_uploader_retries_total``. A
    ``Retry-After`` header on the response (5xx backpressure or 429
    throttling) is honored as a FLOOR under the backoff: the server's
    ask is never undercut by jitter. PERMANENT failures (other 4xx: the
    batch itself is rejected; malformed url) fail fast: retrying a
    client error only hammers the ingest endpoint. Exhausted retries
    return False — the uploader's own retry-next-cycle contract takes
    over, with nothing marked uploaded. ``sleep``/``rng`` are
    injectable for tests."""
    import random
    import time as _time
    import urllib.error
    import urllib.request

    from ..obs import get_registry
    from ..resilience.retry import (RetryBudget, RetryPolicy,
                                    parse_retry_after)

    sleep = sleep or _time.sleep
    rng = rng or random.Random()
    policy = RetryPolicy(max_retries=max_retries,
                         base_delay_s=retry_base_s,
                         max_delay_s=retry_max_s, jitter=True)
    retries_total = get_registry().counter(
        "senweaver_uploader_retries_total",
        "Transient-error retries inside the HTTP trace transport")

    def transport(batch: List[Dict]) -> bool:
        body = json.dumps({"traces": batch}).encode("utf-8")
        budget = RetryBudget(policy, now=_time.monotonic(), rng=rng)
        while True:
            req = urllib.request.Request(
                url, data=body, method="POST",
                headers={"Content-Type": "application/json",
                         **(headers or {})})
            retry_after = None
            try:
                with urllib.request.urlopen(req, timeout=timeout) as resp:
                    return 200 <= resp.status < 300
            except urllib.error.HTTPError as e:
                if e.code < 500 and e.code != 429:
                    return False        # 4xx: permanent, fail fast
                # 5xx / 429: transient; the server may name its own
                # backpressure interval.
                retry_after = parse_retry_after(
                    (getattr(e, "headers", None) or {}).get("Retry-After"))
            except ValueError:
                return False            # malformed url: permanent
            except (urllib.error.URLError, OSError):
                pass                    # transient: refused/timeout/DNS
            delay = budget.next_delay(now=_time.monotonic(),
                                      retry_after_s=retry_after)
            if delay is None:
                return False
            retries_total.inc()
            sleep(delay)

    return transport
