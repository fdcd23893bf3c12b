"""Trace persistence: JSONL write-ahead store.

Replaces the reference's browser ``IStorageService`` JSON blobs
(``traceCollectorService.ts:297-358``) with an append-friendly JSONL file +
atomic snapshot rewrite. A C++ mmap ring-buffer backend slots in behind the
same interface for the hot rollout path (see ``native/``).
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import List, Optional

from .schema import Trace


class TraceStore:
    """Snapshot-on-save JSONL store (one trace per line).

    Feedbacks are persisted in a sibling ``<path>.feedbacks.json`` file,
    mirroring the reference's separate TRACE_FEEDBACK_KEY blob
    (traceCollectorService.ts:216-217,:354-357).
    """

    def __init__(self, path: str):
        self.path = path
        self.feedbacks_path = path + ".feedbacks.json"
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def load(self) -> List[Trace]:
        if not os.path.exists(self.path):
            return []
        traces: List[Trace] = []
        with open(self.path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    traces.append(Trace.from_dict(json.loads(line)))
                except Exception:
                    continue  # tolerate torn tail writes
        return traces

    def save(self, traces: List[Trace]) -> None:
        d = os.path.dirname(self.path) or "."
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        try:
            with os.fdopen(fd, "w", encoding="utf-8") as f:
                for tr in traces:
                    f.write(json.dumps(tr.to_dict(), separators=(",", ":")))
                    f.write("\n")
            os.replace(tmp, self.path)
        except Exception:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def load_feedbacks(self) -> dict:
        if not os.path.exists(self.feedbacks_path):
            return {}
        try:
            with open(self.feedbacks_path, "r", encoding="utf-8") as f:
                return json.load(f)
        except Exception:
            return {}

    def save_feedbacks(self, feedbacks: dict) -> None:
        d = os.path.dirname(self.feedbacks_path) or "."
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        try:
            with os.fdopen(fd, "w", encoding="utf-8") as f:
                json.dump(feedbacks, f)
            os.replace(tmp, self.feedbacks_path)
        except Exception:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def append(self, trace: Trace) -> None:
        with open(self.path, "a", encoding="utf-8") as f:
            f.write(json.dumps(trace.to_dict(), separators=(",", ":")))
            f.write("\n")

    def clear(self) -> None:
        for p in (self.path, self.feedbacks_path):
            if os.path.exists(p):
                os.unlink(p)


def export_data(collector, version: str = "1.0.0") -> str:
    """JSON export mirroring ``exportData`` (traceCollectorService.ts:634-641)."""
    import datetime

    return json.dumps({
        "version": version,
        "export_time": datetime.datetime.now(datetime.timezone.utc).isoformat(),
        "stats": collector.get_stats(),
        "traces": [t.to_dict() for t in collector.get_all_traces()],
        "feedbacks": dict(collector._feedbacks),
    }, indent=2)
