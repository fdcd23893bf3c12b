"""Cross-process trace propagation for the serving fleet's RPC plane.

The in-process :class:`~.tracing.Tracer` is a single-process contextvar affair:
spans nest automatically within a thread and explicitly across threads
via capture()/attach(), but a request's life goes dark the moment it
crosses a transport (``serve/rpc.py``). This module carries the span
context over the wire, W3C-traceparent style, so spans emitted on an
engine host or the learner stitch into the SAME trace the fleet opened
at dispatch.

The wire shape is one small JSON dict on the RPC frame::

    frame["trace"] = {
        "traceparent": "00-<trace_id>-<parent_span_id>-01",
        "wall_s": <sender time.time()>,       # clock anchors for
        "mono_s": <sender time.perf_counter()>  # skew-tolerant stitching
    }

Wall clocks across hosts disagree (NTP drift, VM pauses), so the sender
stamps BOTH its wall clock and its monotonic counter at injection; the
receiver records ``clock_skew_s = local_wall - sender_wall`` on the
server span. That value upper-bounds (true skew + one-way latency) —
enough for a report to re-anchor a remote host's spans onto the caller's
timeline instead of trusting absolute timestamps, the same trick
Podracer-style actor/learner stacks use for latency accounting.

Design constraints inherited from the tracer: injection on a disabled
tracer (or outside any span) returns ``None`` — transports then send no
``trace`` field and servers take the zero-cost path; extraction is
tolerant (a malformed dict yields ``None``, never a raise into the RPC
server); :func:`server_span` never raises either.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Dict, Optional, Tuple

from .tracing import Tracer

TRACEPARENT_VERSION = "00"


def _global_tracer() -> Tracer:
    from . import get_tracer          # runtime import: obs package
    return get_tracer()               # fully loaded by first call


@dataclasses.dataclass(frozen=True)
class TraceContext:
    """One hop's worth of propagated context, as parsed off the wire.

    ``span_id`` is the PARENT span id on the receiving side — the
    client-attempt span that physically carried this RPC. ``wall_s`` /
    ``mono_s`` are the sender's clock anchors at injection time."""

    trace_id: str
    span_id: str
    wall_s: float
    mono_s: float
    sampled: bool = True

    @property
    def ctx(self) -> Tuple[str, str]:
        """The ``(trace_id, span_id)`` tuple ``Tracer.attach`` takes."""
        return (self.trace_id, self.span_id)


def format_traceparent(trace_id: str, span_id: str,
                       sampled: bool = True) -> str:
    return (f"{TRACEPARENT_VERSION}-{trace_id}-{span_id}-"
            f"{'01' if sampled else '00'}")


def parse_traceparent(header: Any) -> Optional[Tuple[str, str, bool]]:
    """``(trace_id, span_id, sampled)`` or None on any malformation."""
    if not isinstance(header, str):
        return None
    parts = header.split("-")
    if len(parts) != 4:
        return None
    version, trace_id, span_id, flags = parts
    if version != TRACEPARENT_VERSION or not trace_id or not span_id:
        return None
    try:
        sampled = bool(int(flags, 16) & 1)
    except ValueError:
        return None
    return trace_id, span_id, sampled


def inject(tracer: Optional[Tracer] = None) -> Optional[Dict[str, Any]]:
    """Wire dict for the ACTIVE span context, or None when there is
    nothing to propagate (tracing disabled, or no span open — a server
    must not be told to stitch onto a span that was never recorded)."""
    t = tracer if tracer is not None else _global_tracer()
    if not t.enabled:
        return None
    ctx = t.capture()
    if ctx is None:
        return None
    return {"traceparent": format_traceparent(ctx[0], ctx[1]),
            "wall_s": time.time(), "mono_s": time.perf_counter()}


def extract(wire: Any) -> Optional[TraceContext]:
    """Parse a frame's ``trace`` dict; tolerant — None on any defect."""
    if not isinstance(wire, dict):
        return None
    parsed = parse_traceparent(wire.get("traceparent"))
    if parsed is None:
        return None
    trace_id, span_id, sampled = parsed
    try:
        wall_s = float(wire.get("wall_s", 0.0))
        mono_s = float(wire.get("mono_s", 0.0))
    except (TypeError, ValueError):
        wall_s = mono_s = 0.0
    return TraceContext(trace_id=trace_id, span_id=span_id,
                        wall_s=wall_s, mono_s=mono_s, sampled=sampled)


def clock_skew_s(ctx: TraceContext,
                 wall_now: Optional[float] = None) -> float:
    """Receiver-side skew estimate: local wall minus the sender's wall
    anchor. Upper-bounds (true skew + one-way latency); a report uses it
    to re-anchor remote spans rather than trusting absolute clocks."""
    now = time.time() if wall_now is None else wall_now
    return now - ctx.wall_s


@contextlib.contextmanager
def server_span(tracer: Optional[Tracer], wire: Any, name: str,
                **attrs: Any):
    """Open a server-side span for one handled RPC, attached under the
    propagated remote context when ``wire`` carries one (skew recorded
    as ``clock_skew_s``), as a local root otherwise. Yields the span
    (None when tracing is disabled) — callers annotate it with e.g.
    ``replay=True`` for idempotency-cache hits."""
    t = tracer if tracer is not None else _global_tracer()
    if not t.enabled:
        yield None
        return
    ctx = extract(wire)
    if ctx is None:
        with t.span(name, **attrs) as span:
            yield span
        return
    attrs.setdefault("remote", True)
    attrs["clock_skew_s"] = round(clock_skew_s(ctx), 6)
    with t.attach(ctx.ctx):
        with t.span(name, **attrs) as span:
            yield span
