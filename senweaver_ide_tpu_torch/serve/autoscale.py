"""Admission-driven autoscaling with hysteresis.

``fleet.add_replica`` has been the spawn half of autoscaling since the
fleet landed; this module is the long-promised trigger. The signals are
the admission queue's own: **queue depth** (work waiting that no replica
accepts) and **shed rate** (the ``senweaver_serve_shed_total`` counter's
derivative — admitted demand the fleet is actively refusing). Overload
that only sheds is a policy failure when capacity is one
``add_replica`` away.

Hysteresis is the whole design: naive threshold controllers flap — one
burst adds a replica, the queue drains, the controller immediately
drains the replica, the next burst sheds again. Three guards prevent
that:

- **sustain**: a signal must hold continuously for ``sustain_s``
  (overload) / ``idle_sustain_s`` (idle) before any action;
- **cooldown**: after ANY action, no further action for ``cooldown_s``;
- **bounds**: never below ``min_replicas`` or above ``max_replicas``,
  and never a drain while a weight publish is rolling (a retiring
  replica mid-roll would re-resume under the publisher).

Scale-down is two-phase: pick the least-loaded live replica, ``drain()``
it (stops accepting, keeps decoding its in-flight work), and only when
its outstanding count hits zero retire it through the fleet's normal
death path — zero orphans, zero sheds, by construction.

The controller is evaluated inside the fleet's pump (under the fleet
lock, manual ``step()`` and the dispatcher thread both), so it needs no
thread of its own and every test runs it on a fake clock.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from ..obs.incidents import emit_event
from .replica import DEAD, LIVE

ACTION_ADD = "add"
ACTION_DRAIN = "drain"


@dataclasses.dataclass(frozen=True)
class AutoscaleConfig:
    """Hysteresis knobs. Defaults are conservative for real clocks;
    tests tighten them against a fake clock."""

    min_replicas: int = 1
    max_replicas: int = 8
    # Overload when queue depth >= this OR shed rate (sheds/sec over the
    # evaluation window) >= shed_rate_high OR fleet KV pool pressure
    # (senweaver_kv_pressure, published by the fleet pump) >=
    # kv_pressure_high — the memory-pressure ladder's "scale" rung,
    # fired by the same gauge admission gates on, so capacity arrives
    # BEFORE BlocksExhausted starts preempting.
    queue_depth_high: int = 8
    shed_rate_high: float = 1.0
    kv_pressure_high: float = 0.9
    sustain_s: float = 2.0          # overload must hold this long
    idle_sustain_s: float = 10.0    # idleness must hold this long
    cooldown_s: float = 5.0         # min gap between ANY two actions
    evaluate_interval_s: float = 0.25


class AutoscaleController:
    """Queue-depth / shed-rate hysteresis driving add_replica + drain."""

    def __init__(self, fleet, spawn_engine, *,
                 config: AutoscaleConfig = AutoscaleConfig(),
                 registry=None, fleet_store=None):
        self.fleet = fleet
        self.spawn_engine = spawn_engine
        self.config = config
        # Optional FleetMetricsStore: when the fleet is federated the
        # controller reads the FLEET-WIDE rollups (sum of sheds, max KV
        # pressure across peers) instead of this process's local view —
        # capacity decisions see remote replicas' pressure too.
        self.fleet_store = fleet_store
        # Optional MigrationCoordinator (serve/scheduler.py), wired by
        # fleet.attach_migration(): when present, scale-down EVACUATES
        # the retiring replica's in-flight decodes to live peers
        # instead of waiting out a drain — retirement completes in one
        # pump tick and no request ever runs on borrowed time.
        self.migrator = None
        # All mutable state below is guarded-by: fleet._lock — evaluate()
        # only ever runs inside the fleet's pump, which holds it.
        self._last_eval_at: Optional[float] = None   # guarded-by: fleet._lock
        self._overload_since: Optional[float] = None  # guarded-by: fleet._lock
        self._idle_since: Optional[float] = None      # guarded-by: fleet._lock
        self._last_action_at: Optional[float] = None  # guarded-by: fleet._lock
        self._last_shed_total = 0.0                   # guarded-by: fleet._lock
        self._last_shed_at: Optional[float] = None    # guarded-by: fleet._lock
        self._retiring: Optional[str] = None          # guarded-by: fleet._lock
        self._spawned = 0                             # guarded-by: fleet._lock
        # (now, action) audit trail — what the flapping tests assert on.
        self.actions: List[Tuple[float, str]] = []    # guarded-by: fleet._lock
        if registry is None:
            from ..obs import get_registry
            registry = get_registry()
        self._registry = registry
        self._actions_total = registry.counter(
            "senweaver_serve_autoscale_actions_total",
            "Autoscaler actions taken (add = replica spawned, drain = "
            "replica retired).", labelnames=("action",))
        self._shed_rate_gauge = registry.gauge(
            "senweaver_serve_autoscale_shed_rate",
            "Shed rate (sheds/sec) the autoscaler last observed.")
        self._shed_rate_gauge.set(0.0)

    # -- signal plumbing -----------------------------------------------------
    def _shed_total(self) -> float:
        if self.fleet_store is not None:
            v = self.fleet_store.rollup_value(
                "senweaver_serve_shed_total", "sum")
            if v is not None:
                return float(v)
        m = self._registry.get("senweaver_serve_shed_total")
        if m is None:
            return 0.0
        return sum(float(v) for v in m.samples().values())

    def _live(self):
        return [r for r in self.fleet.replicas if r.state != DEAD]

    def _kv_pressure(self) -> float:
        if self.fleet_store is not None:
            v = self.fleet_store.rollup_value(
                "senweaver_kv_pressure", "max")
            if v is not None:
                return float(v)
        m = self._registry.get("senweaver_kv_pressure")
        if m is None:
            return 0.0
        vals = m.samples().values()
        return max((float(v) for v in vals), default=0.0)

    # -- the controller ------------------------------------------------------
    def evaluate(self, now: float) -> Optional[str]:
        """One hysteresis tick; returns the action taken (if any).
        Called from the fleet pump — the caller holds the lock
        (``fleet._lock``)."""
        cfg = self.config
        if (self._last_eval_at is not None
                and now - self._last_eval_at < cfg.evaluate_interval_s):
            return None
        # Shed rate over the window since the previous evaluation.
        shed_total = self._shed_total()
        if self._last_shed_at is None or now <= self._last_shed_at:
            shed_rate = 0.0
        else:
            shed_rate = ((shed_total - self._last_shed_total)
                         / (now - self._last_shed_at))
        self._last_shed_total = shed_total
        self._last_shed_at = now
        self._last_eval_at = now
        self._shed_rate_gauge.set(shed_rate)

        # Finish an in-progress retirement before considering anything
        # else: a drained replica at zero outstanding retires cleanly.
        action = self._pump_retirement(now)
        if action is not None:
            return action

        depth = self.fleet.admission.depth()
        live = self._live()
        kv_pressure = self._kv_pressure()
        overloaded = (depth >= cfg.queue_depth_high
                      or shed_rate >= cfg.shed_rate_high
                      or kv_pressure >= cfg.kv_pressure_high)
        idle = (depth == 0 and shed_rate == 0.0
                and kv_pressure < cfg.kv_pressure_high
                and all(r.outstanding == 0 for r in live))

        self._overload_since = (
            (self._overload_since if self._overload_since is not None
             else now) if overloaded else None)
        self._idle_since = (
            (self._idle_since if self._idle_since is not None else now)
            if idle else None)

        if (self._last_action_at is not None
                and now - self._last_action_at < cfg.cooldown_s):
            return None
        if (self._overload_since is not None
                and now - self._overload_since >= cfg.sustain_s
                and len(live) < cfg.max_replicas):
            return self._scale_up(now)
        if (self._idle_since is not None
                and now - self._idle_since >= cfg.idle_sustain_s
                and len(live) > cfg.min_replicas
                and self._retiring is None
                and not self.fleet.publisher.in_progress):
            return self._begin_retirement(now)
        return None

    def _scale_up(self, now: float) -> str:
        # guarded-by: caller
        self._spawned += 1
        replica_id = f"replica-as{self._spawned}"
        self.fleet.add_replica(self.spawn_engine(),
                               replica_id=replica_id)
        self._record(now, ACTION_ADD)
        return ACTION_ADD

    def _begin_retirement(self, now: float) -> Optional[str]:
        # guarded-by: caller
        live = [r for r in self._live() if r.state != DEAD]
        if len(live) <= self.config.min_replicas:
            return None
        victim = min(live, key=lambda r: r.outstanding)
        victim.drain()
        self._retiring = victim.replica_id
        self._record(now, ACTION_DRAIN)
        return ACTION_DRAIN

    def _pump_retirement(self, now: float) -> Optional[str]:
        # guarded-by: caller
        if self._retiring is None:
            return None
        rep = next((r for r in self.fleet.replicas
                    if r.replica_id == self._retiring), None)
        if rep is None or rep.state == DEAD:
            self._retiring = None
            return None
        if rep.outstanding > 0 and self.migrator is not None:
            # Live-migrate the stragglers off instead of draining them
            # out: whatever the fleet can place moves now; any
            # remainder keeps decoding here and the next tick retries.
            self.migrator.evacuate(rep, reason="scale_down", now=now)
        if (self.migrator is not None
                and self.migrator.has_pending_on(rep)):
            # Still the frozen SOURCE of an un-acked handoff: killing
            # it now would strand the fallback copy the exactly-once
            # guarantee depends on. Wait for the ack.
            return None
        if rep.state != DEAD and rep.outstanding == 0:
            # Drained dry — retire through the fleet's death path (no
            # orphans by construction). A publish roll may have resumed
            # it meanwhile; re-drain and wait in that case.
            if rep.state == LIVE:
                rep.drain()
                return None
            self.fleet.kill_replica(rep.replica_id)
            self._retiring = None
        return None

    def _record(self, now: float, action: str) -> None:
        # guarded-by: caller
        self._last_action_at = now
        self._overload_since = None
        self._idle_since = None
        self.actions.append((now, action))
        self._actions_total.inc(action=action)
        emit_event("autoscale_action", t=now, action=action)
