"""Prometheus-style metrics registry: Counter / Gauge / Histogram.

The trainer-plane counterpart of the engine's ad-hoc ``stats()`` dict
(rollout/engine.py): metrics are named, labelled, thread-safe, and
render to the Prometheus text exposition format (v0.0.4) served from
``DashboardService``'s ``GET /metrics``. Naming convention:
``senweaver_<subsystem>_<what>[_total]`` (docs/observability.md).

No prometheus_client dependency — the container doesn't ship it, and
the subset needed here (labelled scalars + fixed-bucket histograms) is
small enough to own.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

# Default histogram buckets in MILLISECONDS — stage timings are the
# dominant histogram use here (train_step_ms, stage_ms, decode_step_ms).
DEFAULT_MS_BUCKETS: Tuple[float, ...] = (
    1.0, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0, 1_000.0, 2_500.0,
    5_000.0, 10_000.0, 30_000.0, 60_000.0, 300_000.0)


def _escape_label(value: Any) -> str:
    return (str(value).replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


def _format_value(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


class _Metric:
    """Base: value cells keyed by the label-value tuple (in labelnames
    order). The unlabelled metric uses the empty tuple."""

    kind = "untyped"

    def __init__(self, name: str, help_text: str,
                 labelnames: Sequence[str] = ()):
        self.name = name
        self.help = help_text
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._cells: Dict[Tuple[str, ...], Any] = {}  # guarded-by: _lock

    def _key(self, labels: Dict[str, Any]) -> Tuple[str, ...]:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: got labels {sorted(labels)}, "
                f"declared {sorted(self.labelnames)}")
        return tuple(str(labels[n]) for n in self.labelnames)

    def _suffix(self, key: Tuple[str, ...],
                extra: Iterable[Tuple[str, str]] = ()) -> str:
        pairs = [f'{n}="{_escape_label(v)}"'
                 for n, v in zip(self.labelnames, key)]
        pairs += [f'{n}="{_escape_label(v)}"' for n, v in extra]
        return "{" + ",".join(pairs) + "}" if pairs else ""

    def samples(self) -> Dict[Tuple[str, ...], Any]:
        with self._lock:
            return dict(self._cells)


class Counter(_Metric):
    kind = "counter"

    def inc(self, amount: float = 1.0, **labels: Any) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        key = self._key(labels)
        with self._lock:
            self._cells[key] = self._cells.get(key, 0.0) + amount

    def value(self, **labels: Any) -> float:
        with self._lock:
            return float(self._cells.get(self._key(labels), 0.0))

    def render(self) -> List[str]:
        with self._lock:
            return [f"{self.name}{self._suffix(k)} {_format_value(v)}"
                    for k, v in sorted(self._cells.items())]


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, **labels: Any) -> None:
        key = self._key(labels)
        with self._lock:
            self._cells[key] = float(value)

    def inc(self, amount: float = 1.0, **labels: Any) -> None:
        key = self._key(labels)
        with self._lock:
            self._cells[key] = self._cells.get(key, 0.0) + amount

    def dec(self, amount: float = 1.0, **labels: Any) -> None:
        self.inc(-amount, **labels)

    def value(self, **labels: Any) -> Optional[float]:
        with self._lock:
            v = self._cells.get(self._key(labels))
            return None if v is None else float(v)

    def render(self) -> List[str]:
        with self._lock:
            return [f"{self.name}{self._suffix(k)} {_format_value(v)}"
                    for k, v in sorted(self._cells.items())]


class Histogram(_Metric):
    """Fixed-bucket histogram. Cells hold ``[bucket_counts..., sum,
    count]``; exposition renders CUMULATIVE ``_bucket{le=...}`` series
    plus ``_sum``/``_count`` per Prometheus convention."""

    kind = "histogram"

    def __init__(self, name: str, help_text: str,
                 labelnames: Sequence[str] = (),
                 buckets: Sequence[float] = DEFAULT_MS_BUCKETS):
        super().__init__(name, help_text, labelnames)
        bs = sorted(float(b) for b in buckets)
        if not bs:
            raise ValueError("histogram needs at least one bucket")
        self.buckets = tuple(bs)

    def observe(self, value: float, **labels: Any) -> None:
        key = self._key(labels)
        with self._lock:
            cell = self._cells.get(key)
            if cell is None:
                cell = self._cells[key] = \
                    [0] * len(self.buckets) + [0.0, 0]
            for i, ub in enumerate(self.buckets):
                if value <= ub:
                    cell[i] += 1
                    break
            cell[-2] += float(value)
            cell[-1] += 1

    def snapshot(self, **labels: Any) -> Dict[str, Any]:
        """Cumulative bucket counts + sum/count for one label set."""
        with self._lock:
            cell = self._cells.get(self._key(labels))
            if cell is None:
                return {"buckets": {}, "sum": 0.0, "count": 0}
            cum, counts = 0, {}
            for i, ub in enumerate(self.buckets):
                cum += cell[i]
                counts[ub] = cum
            counts[float("inf")] = cell[-1]
            return {"buckets": counts, "sum": cell[-2], "count": cell[-1]}

    def render(self) -> List[str]:
        lines: List[str] = []
        with self._lock:
            for key, cell in sorted(self._cells.items()):
                cum = 0
                for i, ub in enumerate(self.buckets):
                    cum += cell[i]
                    le = self._suffix(key, [("le", _format_value(ub))])
                    lines.append(f"{self.name}_bucket{le} {cum}")
                le = self._suffix(key, [("le", "+Inf")])
                lines.append(f"{self.name}_bucket{le} {cell[-1]}")
                lines.append(f"{self.name}_sum{self._suffix(key)} "
                             f"{_format_value(cell[-2])}")
                lines.append(f"{self.name}_count{self._suffix(key)} "
                             f"{cell[-1]}")
        return lines


class MetricsRegistry:
    """Named metric registry. ``counter``/``gauge``/``histogram`` are
    idempotent — re-registering the same name returns the existing
    instrument (so per-round helpers like StepTelemetry can construct
    cheaply) and re-registering under a different type raises."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}  # guarded-by: _lock

    def _get_or_make(self, cls, name: str, help_text: str,
                     labelnames: Sequence[str], **kw) -> _Metric:
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if not isinstance(existing, cls):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{existing.kind}, not {cls.kind}")
                if tuple(labelnames) != existing.labelnames:
                    raise ValueError(
                        f"metric {name!r} already registered with labels "
                        f"{existing.labelnames}, not {tuple(labelnames)}")
                return existing
            m = cls(name, help_text, labelnames, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help_text: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_make(Counter, name, help_text, labelnames)

    def gauge(self, name: str, help_text: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_make(Gauge, name, help_text, labelnames)

    def histogram(self, name: str, help_text: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_MS_BUCKETS
                  ) -> Histogram:
        return self._get_or_make(Histogram, name, help_text, labelnames,
                                 buckets=buckets)

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def render(self) -> str:
        """Prometheus text exposition (v0.0.4) of every metric."""
        with self._lock:
            metrics = sorted(self._metrics.items())
        out: List[str] = []
        for name, m in metrics:
            if m.help:
                out.append(f"# HELP {name} {m.help}")
            out.append(f"# TYPE {name} {m.kind}")
            out.extend(m.render())
        return "\n".join(out) + ("\n" if out else "")

    def snapshot(self) -> Dict[str, Any]:
        """JSON-friendly view for the dashboard's /api/state."""
        with self._lock:
            metrics = sorted(self._metrics.items())
        out: Dict[str, Any] = {}
        for name, m in metrics:
            if isinstance(m, Histogram):
                cells = {",".join(k) or "": {"sum": c[-2], "count": c[-1]}
                         for k, c in m.samples().items()}
            else:
                cells = {",".join(k) or "": v
                         for k, v in m.samples().items()}
            out[name] = {"kind": m.kind, "labels": list(m.labelnames),
                         "values": cells}
        return out

    def snapshot_delta(self, since: Optional[Dict[str, Any]] = None
                       ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """``(delta, snapshot)`` against a prior :meth:`snapshot`.

        Federation scrapes ship the delta and keep the snapshot as the
        next cursor — both come from ONE snapshot pass, so the pair is
        race-free under concurrent ``inc``. The delta carries only
        changed cells: counter and histogram cells as INCREMENTS
        (histograms ``{"sum": Δ, "count": Δ}``), gauge cells as absolute
        values, metrics unseen in ``since`` whole. ``since=None``
        degenerates to ``(snapshot, snapshot)`` — a full resync."""
        snap = self.snapshot()
        if since is None:
            return snap, snap
        delta: Dict[str, Any] = {}
        for name, m in snap.items():
            old = since.get(name)
            if old is None:
                delta[name] = m
                continue
            old_values = old.get("values", {})
            changed: Dict[str, Any] = {}
            for cell, v in m["values"].items():
                ov = old_values.get(cell)
                if v == ov:
                    continue
                if m["kind"] == "counter":
                    changed[cell] = float(v) - float(ov or 0.0)
                elif m["kind"] == "histogram":
                    ov = ov or {"sum": 0.0, "count": 0}
                    changed[cell] = {"sum": v["sum"] - ov["sum"],
                                     "count": v["count"] - ov["count"]}
                else:
                    changed[cell] = v
            if changed:
                delta[name] = {"kind": m["kind"], "labels": m["labels"],
                               "values": changed}
        return delta, snap
