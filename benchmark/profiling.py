"""The traced run's device trace: ``torch.profiler`` over the window, then
busy time, kernel time by name, the top device operations and the idle
gaps by what the host was doing.

Busy time is the union of the device's kernel, copy and set intervals
(one stream, so they rarely overlap; the union counts an overlap once).
The idle share is 1 - busy / window. On a card the profiler records the
device's activity only (recording every host operation as well cut the
host-bound engine's traced step rate by a further third). The host side
is the harness's own spans, taken with ``time.time_ns()``, the
Unix-epoch clock the profiler puts its events on.
"""

from __future__ import annotations

import bisect
import contextlib
from typing import Dict, Iterable, List, Optional, Tuple


DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")


def _on_device(ev) -> bool:
    """A kernel, copy or set on the device (older builds of the profiler
    name no activity type: there, any event off the host)."""
    kind = getattr(ev, "activity_type", None)
    if kind is not None:
        return str(kind()) in DEVICE_ACTIVITIES
    return not str(ev.device_type()).endswith("CPU")


class DeviceTrace:
    """What the readers get from the profiler: ``ops`` as (name, start_ns,
    duration_ns) on the device, the harness's spans as (name, start_ns,
    end_ns), and the window's bounds."""

    def __init__(self, ops: List[Tuple[str, int, int]],
                 spans: List[Tuple[str, int, int]],
                 window_ns: Tuple[int, int]):
        self.ops = sorted(ops, key=lambda o: o[1])
        self.spans = sorted(spans, key=lambda h: h[1])
        self.t0, self.t1 = window_ns

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def _merged(self) -> List[Tuple[int, int]]:
        out: List[List[int]] = []
        for _name, s, d in self.ops:
            e = s + d
            s, e = max(s, self.t0), min(e, self.t1)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(a, b) for a, b in out]

    def alignment_ms(self) -> Tuple[float, float]:
        """Milliseconds from the window's start to the first device
        operation's and from the last one's end to the window's end: both
        small and positive when the profiler's clock and the spans' agree."""
        if not self.ops:
            return (float("nan"), float("nan"))
        last = max(s + d for _n, s, d in self.ops)
        return ((self.ops[0][1] - self.t0) / 1e6, (self.t1 - last) / 1e6)

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self._merged()) / 1e9

    def kernel_seconds(self, names: Iterable[str]) -> float:
        """Device seconds of the operations that start in the window and
        whose name contains any of ``names``."""
        names = tuple(names)
        return sum(d for n, s, d in self.ops
                   if self.t0 <= s < self.t1
                   and any(k in n for k in names)) / 1e9

    def top_ops(self, k: int = 10) -> List[list]:
        by: Dict[str, int] = {}
        for n, s, d in self.ops:
            if self.t0 <= s < self.t1:
                by[n] = by.get(n, 0) + d
        top = sorted(by.items(), key=lambda kv: -kv[1])[:k]
        return [[n[:200], d / 1e9] for n, d in top]

    def idle_gaps(self, k: int = 10) -> List[list]:
        """Idle device time summed by what the host was doing in each gap:
        the innermost harness span that covers the gap's middle."""
        spans = [h for h in self.spans if h[0] != "harness.window"]
        starts = [h[1] for h in spans]
        by: Dict[str, int] = {}
        prev = self.t0
        merged = self._merged() + [(self.t1, self.t1)]
        for s, e in merged:
            if s > prev:
                label = (_cover(spans, starts, (s + prev) // 2)
                         or "between harness spans")
                by[label] = by.get(label, 0) + (s - prev)
            prev = max(prev, e)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:k]
        return [[n[:200], d / 1e9] for n, d in top]


def _cover(ranges, starts, t, lookback: int = 4000) -> Optional[str]:
    """Name of the latest-starting range that covers ``t``."""
    i = bisect.bisect_right(starts, t) - 1
    stop = max(-1, i - lookback)
    while i > stop:
        name, s, e = ranges[i]
        if e >= t:
            return name
        i -= 1
    return None


@contextlib.contextmanager
def profiled(enabled: bool, out: dict, spans: List[Tuple[str, int, int]]):
    """Profile the block when ``enabled``; ``out["trace"]`` is then a
    DeviceTrace of it, whose window is the block's ``harness.window``
    span (``spans``: the harness's spans, filled while the block runs)."""
    if not enabled:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = ([ProfilerActivity.CUDA] if torch.cuda.is_available()
            else [ProfilerActivity.CPU])
    with profile(activities=acts) as prof:
        yield
    ops = [(ev.name(), int(ev.start_ns()), int(ev.duration_ns()))
           for ev in prof.profiler.kineto_results.events()
           if _on_device(ev)]
    windows = [(h[1], h[2]) for h in spans if h[0] == "harness.window"]
    if len(windows) != 1:
        raise RuntimeError(f"the traced block has {len(windows)} "
                           f"harness.window spans, not one")
    out["trace"] = DeviceTrace(ops, spans, windows[0])
