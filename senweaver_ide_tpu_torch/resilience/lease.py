"""Single-writer leases with monotonically increasing fencing epochs.

A lease alone cannot make a disaggregated learner safe: the holder can
pause (GC, preemption, a wedged device transfer) past its TTL, a second
learner takes over, and then the FIRST one wakes up and keeps publishing
— the classic zombie writer. The fix is the classic one too (Chubby /
GFS fencing tokens): every acquisition hands out a strictly larger
``epoch``, every downstream write carries it, and every write surface
(:class:`~..serve.weights.WeightPublisher`, the remote engine handler)
rejects epochs below its high-water mark. The lease makes duplicates
RARE; the fencing epoch makes them HARMLESS.

The store is the authority the fleet-side gateway
(``serve.learner_server.FleetRpcHandler``) owns. It is deliberately
in-memory: the fleet process is the single serving authority already,
so colocating the lease with it gives single-writer semantics without a
coordination service. Epochs only ever increase — they survive release
and expiry — which is what makes them usable as fencing tokens.

Time is always the caller's ``now`` (monotonic seconds), never a wall
clock read, so every expiry/split-brain test runs on a fake clock.
"""

from __future__ import annotations

import dataclasses
import threading

from ..obs.incidents import emit_event
from typing import Optional


class LeaseLost(RuntimeError):
    """The caller's lease epoch has been superseded or has expired; the
    holder must stop writing and re-acquire (at a higher epoch)."""


class LeaseUnavailable(RuntimeError):
    """Another holder's unexpired lease is current; retry after its TTL
    (retriable — this is contention, not fencing)."""


@dataclasses.dataclass(frozen=True)
class Lease:
    holder: str
    epoch: int
    expires_at: float


class LeaseStore:
    """In-memory single-writer lease authority with fencing epochs."""

    def __init__(self, *, ttl_s: float = 30.0, registry=None):
        self.ttl_s = float(ttl_s)
        self._current: Optional[Lease] = None   # guarded-by: _lock
        self._epoch = 0                         # guarded-by: _lock
        self._lock = threading.Lock()
        if registry is None:
            from ..obs import get_registry
            registry = get_registry()
        self._acquires_total = registry.counter(
            "senweaver_lease_acquires_total",
            "Lease acquisitions granted (each bumps the fencing epoch).")
        self._lost_total = registry.counter(
            "senweaver_lease_lost_total",
            "Lease operations rejected as lost (superseded or expired "
            "epoch presented).")
        self._epoch_gauge = registry.gauge(
            "senweaver_lease_epoch",
            "Current fencing epoch (monotonic; never reused).")
        self._epoch_gauge.set(0)

    @property
    def current_epoch(self) -> int:
        with self._lock:
            return self._epoch

    def current(self) -> Optional[Lease]:
        with self._lock:
            return self._current

    def acquire(self, holder: str, *, now: float,
                steal: bool = False) -> Lease:
        """Grant the lease at a strictly higher epoch. Granted when the
        lease is free, expired, or held by ``holder`` itself (the
        restart path — a resumed learner re-acquires ABOVE its own old
        epoch, fencing out any zombie twin still holding it).
        ``steal=True`` preempts an unexpired foreign holder (operator
        action); without it that raises :class:`LeaseUnavailable`."""
        with self._lock:
            cur = self._current
            if (cur is not None and cur.expires_at > now
                    and cur.holder != holder and not steal):
                raise LeaseUnavailable(
                    f"lease held by {cur.holder!r} (epoch {cur.epoch}) "
                    f"for another {cur.expires_at - now:.1f}s")
            self._epoch += 1
            lease = Lease(holder=holder, epoch=self._epoch,
                          expires_at=now + self.ttl_s)
            self._current = lease
            self._acquires_total.inc()
            self._epoch_gauge.set(self._epoch)
            stolen = bool(cur is not None and cur.expires_at > now
                          and cur.holder != holder)
            emit_event("lease_acquired", holder=holder,
                       epoch=self._epoch, t=now, steal=stolen)
            return lease

    def renew(self, holder: str, epoch: int, *, now: float) -> Lease:
        """Extend the lease; strict — an expired lease cannot be
        renewed even if unclaimed (the holder cannot know a rival did
        not acquire in the gap; re-acquiring at a higher epoch is always
        safe, renewing across a gap never is)."""
        with self._lock:
            cur = self._current
            if (cur is None or cur.epoch != int(epoch)
                    or cur.holder != holder or cur.expires_at <= now):
                self._lost_total.inc()
                raise LeaseLost(
                    f"{holder!r} epoch {epoch} is not the live lease "
                    f"(current: {cur})")
            lease = Lease(holder=holder, epoch=cur.epoch,
                          expires_at=now + self.ttl_s)
            self._current = lease
            return lease

    def release(self, holder: str, epoch: int) -> bool:
        """Voluntary release; the epoch is retired, never reused."""
        with self._lock:
            cur = self._current
            if (cur is not None and cur.epoch == int(epoch)
                    and cur.holder == holder):
                self._current = None
                return True
            return False

    def validate(self, epoch: int, *, now: float) -> None:
        """Fencing check for a write carrying ``epoch``: raises
        :class:`LeaseLost` unless it is the live lease's epoch."""
        with self._lock:
            cur = self._current
            if (cur is None or cur.epoch != int(epoch)
                    or cur.expires_at <= now):
                self._lost_total.inc()
                raise LeaseLost(
                    f"epoch {epoch} is not the live lease "
                    f"(current: {cur})")
