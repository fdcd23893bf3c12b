"""Operator dashboard: the L6 surface over the trainer control plane.

The reference ships ~20.3k LoC of React (``browser/react/src/`` — sidebar
chat, settings panes, trace/APO dashboards). The TPU-first re-design keeps
the operator surface but not the IDE chrome: one stdlib HTTP server
rendering a single self-contained page (zero egress — no CDN, no build
step) over the SAME stats surfaces the services already expose:

- trace statistics        → ``TraceCollector.get_stats()``
  (``traceCollectorService.ts:577-628`` getTraceStatistics analogue)
- APO state               → ``APOService.get_stats()`` / latest report /
  optimized rules (``apoService.ts:1470-1508`` getAPOStatistics)
- serving counters        → ``RolloutEngine.stats()``
- job queue               → ``ControlServer.list_jobs()``
- training curves         → the metrics JSONL sink's "GRPO Round Done" /
  "Async GRPO Round" events (``services/metrics.py``)

Everything is pluggable and optional: a dashboard over just a metrics
file is as valid as one over a live ``JobRunner`` stack. ``/api/state``
serves the JSON the page polls; tests consume it directly.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional


def _training_curves(metrics_path: Optional[str],
                     limit: int = 200) -> Dict[str, List[Any]]:
    """Per-round series from the metrics JSONL (newest ``limit`` rounds)."""
    if not metrics_path:
        return {"rounds": [], "reward_mean": [], "loss": []}
    from .metrics import load_jsonl_metrics
    try:
        events = load_jsonl_metrics(metrics_path)
    except Exception:
        events = []
    rounds: List[Dict[str, Any]] = [
        e.get("properties", e) for e in events
        if e.get("event") in ("GRPO Round Done", "Async GRPO Round")]
    total = len(rounds)
    rounds = rounds[-limit:]
    return {
        # True round indices survive truncation: a 300-round run shows
        # rounds 100-299, not a relabeled 0-199.
        "rounds": list(range(total - len(rounds), total)),
        "reward_mean": [r.get("reward_mean") for r in rounds],
        "loss": [r.get("loss") for r in rounds],
        "collect_s": [r.get("collect_s") for r in rounds],
        "episodes": [r.get("episodes") for r in rounds],
    }


class DashboardService:
    """Aggregates live service state and serves the operator page."""

    def __init__(self, *, collector=None, apo=None, engine=None,
                 control=None, metrics_path: Optional[str] = None,
                 onboarding=None, title: str = "senweaver-tpu trainer",
                 control_socket: Optional[str] = None,
                 tracer=None, registry=None, slo=None, incidents=None):
        self.collector = collector
        self.apo = apo
        self.engine = engine
        self.control = control
        self.metrics_path = metrics_path
        self.onboarding = onboarding
        self.title = title
        # Optional SLOTracker (obs/slo.py): the registry carries the
        # histograms/counters either way, but exemplar timelines live
        # only on the tracker object — pass the fleet's to see them.
        self.slo = slo
        # Optional IncidentCorrelator (obs/incidents.py): the fleet
        # tile's counters/gauges are registry-read, but the last
        # incident's one-liner lives only on the correlator object.
        self.incidents = incidents
        # Observability plane: defaults to the process-global tracer +
        # registry (obs/), so an instrumented trainer's spans and
        # telemetry show up with zero wiring; tests pass their own.
        if tracer is None or registry is None:
            from ..obs import get_registry, get_tracer
            tracer = tracer or get_tracer()
            registry = registry or get_registry()
        self.tracer = tracer
        self.registry = registry
        # Operator actions go over the control-plane SOCKET (never by
        # calling the services directly): the dashboard holds no
        # credentials — the operator's token travels request → RPC auth
        # field → ControlServer validation, so the HTTP port grants
        # nothing the socket wouldn't.
        self.control_socket = control_socket or getattr(
            control, "socket_path", None)
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    # -- state assembly ----------------------------------------------------
    def state(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"title": self.title}
        if self.collector is not None:
            try:
                out["traces"] = self.collector.get_stats()
            except Exception as e:
                out["traces"] = {"error": str(e)}
        if self.engine is not None:
            try:
                out["engine"] = self.engine.stats()
            except Exception as e:
                out["engine"] = {"error": str(e)}
        if self.apo is not None:
            try:
                apo_state: Dict[str, Any] = dict(self.apo.get_stats())
                apo_state["optimized_rules"] = self.apo.get_optimized_rules()
                report = self.apo.get_latest_report()
                # Suggestion rows with IDs: the action buttons need them
                # (apply/reject/revert go over the control plane by id).
                apo_state["suggestions"] = [
                    {"id": s.id, "status": s.status,
                     "priority": s.priority,
                     "description": s.description}
                    for s in self.apo.segments.suggestions]
                if report is not None:
                    apo_state["latest_report"] = {
                        "good_rate": report.good_rate,
                        "total_conversations": report.total_conversations,
                        "patterns": [
                            {"description": p.description,
                             "frequency": p.frequency,
                             "severity": p.severity}
                            for p in report.patterns],
                        "suggestions": [
                            {"description": s.description,
                             "priority": s.priority, "status": s.status}
                            for s in report.suggestions],
                        "avg_reward": report.avg_reward,
                    }
                out["apo"] = apo_state
            except Exception as e:
                out["apo"] = {"error": str(e)}
        if self.control is not None:
            try:
                out["jobs"] = self.control.list_jobs()
            except Exception as e:
                out["jobs"] = [{"error": str(e)}]
        if self.onboarding is not None:
            try:
                out["onboarding"] = self.onboarding.status()
            except Exception as e:
                out["onboarding"] = {"error": str(e)}
        out["training"] = _training_curves(self.metrics_path)
        out["obs"] = self._obs_summary()
        out["training_health"] = self._training_health_summary()
        out["resilience"] = self._resilience_summary()
        out["serving"] = self._serving_summary()
        out["kv_pool"] = self._kv_pool_summary()
        out["speculation"] = self._speculation_summary()
        out["adapters"] = self._adapter_summary()
        out["slo"] = self._slo_summary()
        out["runtime"] = self._runtime_summary()
        out["fleet"] = self._fleet_summary()
        return out

    def _resilience_summary(self) -> Dict[str, Any]:
        """Fault-boundary counter totals (resilience/ + rl_loop): the
        operator's at-a-glance degradation picture — all zeros on a
        healthy run. Labeled counters (skip/fail reasons, chaos kinds)
        sum across their label cells."""
        def total(name: str) -> float:
            m = self.registry.get(name)
            if m is None:
                return 0
            return sum(float(v) for v in m.samples().values())

        try:
            return {
                "episodes_failed":
                    total("senweaver_grpo_episodes_failed_total"),
                "episode_retries":
                    total("senweaver_grpo_episode_retries_total"),
                "groups_dropped":
                    total("senweaver_grpo_task_groups_dropped_total"),
                "rounds_skipped":
                    total("senweaver_grpo_rounds_skipped_total"),
                "updates_skipped":
                    total("senweaver_grpo_updates_skipped_total"),
                "uploader_retries":
                    total("senweaver_uploader_retries_total"),
                "chaos_injected":
                    total("senweaver_chaos_faults_injected_total"),
                # Per-reason guard skips: which tripwire fired —
                # nonfinite_loss vs nonfinite_grad_norm vs loss_spike.
                "guard_skip_reasons": self._label_totals(
                    "senweaver_guard_skips_total"),
            }
        except Exception as e:
            return {"error": str(e)}

    def _label_totals(self, name: str) -> Dict[str, float]:
        """A single-label counter's cells as ``{label_value: total}``."""
        m = self.registry.get(name)
        if m is None:
            return {}
        return {k[0]: float(v) for k, v in m.samples().items() if k}

    def _training_health_summary(self) -> Dict[str, Any]:
        """GRPO training-health tile row, read straight off the
        registry's ``senweaver_grpo_health_*`` series (zero wiring —
        any loop publishing through StepTelemetry.record_round shows
        up; all None/zero without one)."""
        def gauge(name: str) -> Optional[float]:
            m = self.registry.get(f"senweaver_grpo_health_{name}")
            return float(m.value()) if m is not None else None

        try:
            rounds = self.registry.get("senweaver_grpo_health_rounds_total")
            group_size = self.registry.get("senweaver_grpo_group_size")
            mit = self.registry.get(
                "senweaver_grpo_health_mitigations_total")
            return {
                "rounds": float(rounds.value()) if rounds else 0,
                "score": gauge("score"),
                "rank_fraction": gauge("rank_fraction"),
                "effective_rank": gauge("effective_rank"),
                "zero_group_fraction":
                    gauge("zero_advantage_group_fraction"),
                "credit_entropy": gauge("credit_entropy"),
                "grad_sparsity": gauge("grad_sparsity"),
                "policy_entropy": gauge("policy_entropy"),
                "kl_to_anchor": gauge("kl_to_anchor"),
                "nonfinite_fraction": gauge("nonfinite_reward_fraction"),
                "group_size": (float(group_size.value())
                               if group_size else None),
                "triggers": self._label_totals(
                    "senweaver_grpo_health_triggers_total"),
                "mitigations": ({"/".join(k): float(v)
                                 for k, v in mit.samples().items()}
                                if mit is not None else {}),
            }
        except Exception as e:
            return {"error": str(e)}

    def _serving_summary(self) -> Dict[str, Any]:
        """Serving-fleet tile row, read straight off the registry's
        ``senweaver_serve_*`` series (zero wiring — any ServingFleet in
        the process shows up; all None/zero without one). Labeled
        counters sum across cells; the TTFT/e2e histograms collapse to
        their running means."""
        def total(name: str) -> float:
            m = self.registry.get(name)
            if m is None:
                return 0
            return sum(float(v) for v in m.samples().values())

        def total_where(name: str, idx: int, want: str) -> float:
            """Sum only the cells whose ``idx``-th label == ``want``."""
            m = self.registry.get(name)
            if m is None:
                return 0
            return sum(float(v) for k, v in m.samples().items()
                       if len(k) > idx and k[idx] == want)

        def hist_mean(name: str) -> Optional[float]:
            m = self.registry.get(name)
            if m is None:
                return None
            s = c = 0.0
            for cell in m.samples().values():
                s += cell[-2]
                c += cell[-1]
            return (s / c) if c else None

        try:
            live = self.registry.get("senweaver_serve_replicas_live")
            versions = self.registry.get("senweaver_serve_weight_version")
            skew = self.registry.get(
                "senweaver_serve_weight_version_skew")
            return {
                "replicas_live": (None if live is None
                                  else live.value()),
                "queue_depth": total("senweaver_serve_queue_depth"),
                "completed": total("senweaver_serve_completed_total"),
                "shed": total("senweaver_serve_shed_total"),
                "retries": total("senweaver_serve_retries_total"),
                "replica_deaths":
                    total("senweaver_serve_replica_deaths_total"),
                "publishes": total("senweaver_serve_publishes_total"),
                "weight_version": (
                    max((float(v) for v in versions.samples().values()),
                        default=0) if versions is not None else 0),
                "version_skew": (skew.value()
                                 if skew is not None else 0),
                "ttft_ms_mean": hist_mean("senweaver_serve_ttft_ms"),
                "e2e_ms_mean": hist_mean("senweaver_serve_e2e_ms"),
                "prefix_broadcasts":
                    total("senweaver_serve_prefix_broadcasts_total"),
                "prefix_prefills_avoided": total(
                    "senweaver_serve_prefix_prefills_avoided_total"),
                "prefix_broadcast_failures": total(
                    "senweaver_serve_prefix_broadcast_failures_total"),
                "prefix_install_ms_mean":
                    hist_mean("senweaver_serve_prefix_install_ms"),
                "decode_tokens_outstanding": total(
                    "senweaver_serve_replica_decode_tokens"),
                "remote_rpcs": total(
                    "senweaver_serve_remote_rpcs_total"),
                "remote_rpc_retries": total(
                    "senweaver_serve_remote_rpc_retries_total"),
                "remote_rpc_errors": total(
                    "senweaver_serve_remote_rpc_errors_total"),
                "breaker_opens": total(
                    "senweaver_serve_remote_breaker_opens_total"),
                "probes_dead": total_where(
                    "senweaver_serve_remote_probes_total", 1, "dead"),
                "continuation_replays": total(
                    "senweaver_serve_continuation_replays_total"),
                "publish_quarantined": total(
                    "senweaver_serve_publish_quarantined_total"),
                "stale_publishes": total(
                    "senweaver_serve_stale_publish_total"),
                "lease_epoch": total("senweaver_lease_epoch"),
                "learner_rounds": total(
                    "senweaver_learner_rounds_total"),
                "learner_publishes": total(
                    "senweaver_learner_publishes_total"),
                "learner_publish_failures": total(
                    "senweaver_learner_publish_failures_total"),
                "learner_resume_republishes": total(
                    "senweaver_learner_resume_republishes_total"),
                "learner_lease_lost": total(
                    "senweaver_learner_lease_lost_total"),
                "learner_idle_fraction": total(
                    "senweaver_learner_idle_fraction"),
                "learner_streaming_mode": total(
                    "senweaver_learner_streaming_mode"),
                "stream_steps_streaming": total_where(
                    "senweaver_learner_stream_steps_total", 0,
                    "streaming"),
                "stream_steps_lockstep": total_where(
                    "senweaver_learner_stream_steps_total", 0,
                    "lockstep"),
                "experience_queue_depth": total(
                    "senweaver_learner_experience_queue_depth"),
                "experience_ready_groups": total(
                    "senweaver_learner_experience_ready_groups"),
                "stale_episodes": total(
                    "senweaver_learner_stale_episodes_total"),
                "duplicate_episodes": total(
                    "senweaver_learner_duplicate_episodes_total"),
                "collector_stall_fraction": total(
                    "senweaver_collector_stall_fraction"),
                "autoscale_adds": total_where(
                    "senweaver_serve_autoscale_actions_total", 0, "add"),
                "autoscale_drains": total_where(
                    "senweaver_serve_autoscale_actions_total", 0,
                    "drain"),
                "autoscale_shed_rate": total(
                    "senweaver_serve_autoscale_shed_rate"),
            }
        except Exception as e:
            return {"error": str(e)}

    def _kv_pool_summary(self) -> Dict[str, Any]:
        """Paged-KV pool tile, read straight off the registry's
        ``senweaver_kv_*`` series (zero wiring — any BlockAllocator in
        the process shows up; all None/zero under the slot layout).
        Block gauges sum across allocators; the utilization and
        fragmentation ratios report the WORST pool, since one starved
        engine stalls its replica no matter how empty the others are."""
        def total(name: str) -> float:
            m = self.registry.get(name)
            if m is None:
                return 0
            return sum(float(v) for v in m.samples().values())

        def worst(name: str) -> Optional[float]:
            m = self.registry.get(name)
            if m is None:
                return None
            vals = [float(v) for v in m.samples().values()]
            return max(vals) if vals else None

        try:
            return {
                "blocks_total": total("senweaver_kv_blocks_total"),
                "blocks_free": total("senweaver_kv_blocks_free"),
                "utilization": worst("senweaver_kv_pool_utilization"),
                "fragmentation": worst("senweaver_kv_fragmentation"),
                "cow_copies": total("senweaver_kv_cow_copies_total"),
                "prefix_grafts":
                    total("senweaver_kv_prefix_grafts_total"),
                "install_copies":
                    total("senweaver_kv_install_copies_total"),
                "exhaustion_rejections": total(
                    "senweaver_kv_exhaustion_rejections_total"),
                # memory-pressure ladder: how often each rung fired,
                # how much KV currently lives in the host tier, and
                # whether admission is shedding on pool pressure
                "pressure": worst("senweaver_kv_pressure"),
                "evictions": total("senweaver_kv_evictions_total"),
                "swaps_out": total("senweaver_kv_swaps_out_total"),
                "swaps_in": total("senweaver_kv_swaps_in_total"),
                "swapped_blocks": total("senweaver_kv_swapped_blocks"),
                # quantized-ladder byte ledger: device KV held by live
                # blocks and KV parked in the host tier, at whatever
                # rung each pool runs (int8 pools report ~3x fewer
                # bytes per block than bf16)
                "bytes_device": total("senweaver_kv_bytes_device"),
                "bytes_host": total("senweaver_kv_bytes_host"),
                "preemption_storms": total(
                    "senweaver_kv_preemption_storms_total"),
                "kv_gated": total("senweaver_serve_kv_gated"),
            }
        except Exception as e:
            return {"error": str(e)}

    def _speculation_summary(self) -> Dict[str, Any]:
        """Speculation tile, read straight off the registry's
        ``senweaver_spec_*`` series (zero wiring — all None/zero when
        no engine enabled speculation). Depth/load/staleness report
        the most recently stepped engine's gauge; acceptance reports
        the WORST replica, since the depth controller throttles on the
        replica that's wasting the most verify compute."""
        def total(name: str) -> float:
            m = self.registry.get(name)
            if m is None:
                return 0
            return sum(float(v) for v in m.samples().values())

        def gauge(name: str, pick=max) -> Optional[float]:
            m = self.registry.get(name)
            if m is None:
                return None
            vals = [float(v) for v in m.samples().values()]
            return pick(vals) if vals else None

        try:
            return {
                "depth": gauge("senweaver_spec_depth"),
                "controller_load":
                    gauge("senweaver_spec_controller_load"),
                "depth_changes":
                    total("senweaver_spec_depth_changes_total"),
                "acceptance_rate":
                    gauge("senweaver_spec_acceptance_rate", min),
                "draft_staleness":
                    gauge("senweaver_spec_draft_staleness"),
                "wasted_draft_tokens":
                    total("senweaver_spec_wasted_draft_tokens_total"),
                "distill_steps":
                    total("senweaver_spec_distill_steps_total"),
                "distill_loss": gauge("senweaver_spec_distill_loss"),
                "draft_publishes":
                    total("senweaver_serve_draft_publishes_total"),
                "draft_install_failures": total(
                    "senweaver_serve_draft_install_failures_total"),
                "draft_blocks_free":
                    total("senweaver_spec_draft_kv_blocks_free"),
            }
        except Exception as e:
            return {"error": str(e)}

    def _adapter_summary(self) -> Dict[str, Any]:
        """Multi-tenant tile: adapter-pool occupancy and churn, publish
        traffic (pool-level and fleet-level), tenant version skew, and
        the gathered-step overhead — all off the registry (the pool and
        WeightPublisher register these at construction)."""
        def total(name: str) -> float:
            m = self.registry.get(name)
            if m is None:
                return 0
            return sum(float(v) for v in m.samples().values())

        def gauge(name: str, pick=max) -> Optional[float]:
            m = self.registry.get(name)
            if m is None:
                return None
            vals = [float(v) for v in m.samples().values()]
            return pick(vals) if vals else None

        try:
            return {
                "pool_slots":
                    total("senweaver_serve_adapter_pool_slots"),
                "pool_resident":
                    total("senweaver_serve_adapter_pool_resident"),
                "publishes":
                    total("senweaver_serve_adapter_publishes_total"),
                "fleet_publishes": total(
                    "senweaver_serve_adapter_fleet_publishes_total"),
                "installs":
                    total("senweaver_serve_adapter_installs_total"),
                "evictions":
                    total("senweaver_serve_adapter_evictions_total"),
                "install_failures": total(
                    "senweaver_serve_adapter_install_failures_total"),
                "affinity_hits": total(
                    "senweaver_serve_adapter_affinity_hits_total"),
                "version_skew":
                    gauge("senweaver_serve_adapter_version_skew"),
                "gather_overhead": gauge(
                    "senweaver_serve_adapter_gather_overhead_ratio"),
            }
        except Exception as e:
            return {"error": str(e)}

    def _slo_summary(self) -> Dict[str, Any]:
        """SLO tile: request/violation totals, burn ratio, and the
        running means of the per-priority seconds histograms — all read
        off the registry (zero wiring). Exemplar timelines are only
        reachable through a live SLOTracker, so the worst-request rows
        appear when the fleet's tracker was passed at construction."""
        def total(name: str) -> float:
            m = self.registry.get(name)
            if m is None:
                return 0
            return sum(float(v) for v in m.samples().values())

        def hist_mean_s(name: str) -> Optional[float]:
            m = self.registry.get(name)
            if m is None:
                return None
            s = c = 0.0
            for cell in m.samples().values():
                s += cell[-2]
                c += cell[-1]
            return (s / c) if c else None

        try:
            burn = self.registry.get("senweaver_serve_slo_burn_ratio")
            # Per-priority gauge; the tile shows the WORST class's burn.
            burn_cells = ([float(v) for v in burn.samples().values()]
                          if burn is not None else [])
            out: Dict[str, Any] = {
                "requests": total("senweaver_serve_slo_requests_total"),
                "violations": total(
                    "senweaver_serve_slo_violations_total"),
                "burn_ratio": max(burn_cells) if burn_cells else None,
                "ttft_s_mean":
                    hist_mean_s("senweaver_serve_ttft_seconds"),
                "tpot_s_mean":
                    hist_mean_s("senweaver_serve_tpot_seconds"),
                "queue_wait_s_mean":
                    hist_mean_s("senweaver_serve_queue_wait_seconds"),
                "e2e_s_mean":
                    hist_mean_s("senweaver_serve_e2e_seconds"),
                "timelines_finished":
                    total("senweaver_serve_timelines_total"),
                "timelines_evicted":
                    total("senweaver_serve_timelines_evicted_total"),
                "publish_windows":
                    total("senweaver_serve_publish_windows_total"),
                "spans_dropped":
                    total("senweaver_obs_spans_dropped_total"),
            }
            if self.slo is not None:
                out["exemplars"] = [
                    {"ticket": e.get("ticket"),
                     "priority": e.get("priority"),
                     "violations": ",".join(e.get("violations") or [])
                                   or None,
                     "e2e_s": (e.get("derived") or {}).get("e2e_s"),
                     "ttft_s": (e.get("derived") or {}).get("ttft_s"),
                     "trace_id": e.get("trace_id")}
                    for e in self.slo.exemplars()[:5]]
            return out
        except Exception as e:
            return {"error": str(e)}

    def _fleet_summary(self) -> Dict[str, Any]:
        """Fleet-health tile: federation peer counts, worst-replica KV
        pressure, per-window SLO burn, and alerting state — read
        straight off the ``senweaver_fleet_*`` series any
        FleetMetricsStore / AlertManager in the process publishes (zero
        wiring). The last incident's one-liner needs the live
        correlator object, so it appears when one was passed at
        construction."""
        def gauge(name: str) -> Optional[float]:
            m = self.registry.get(name)
            return float(m.value()) if m is not None else None

        def cell(name: str, *labels: str) -> Optional[float]:
            m = self.registry.get(name)
            if m is None:
                return None
            v = m.samples().get(tuple(labels))
            return float(v) if v is not None else None

        try:
            active = self.registry.get("senweaver_fleet_alert_active")
            firing = sorted(
                k[0] for k, v in (active.samples().items()
                                  if active is not None else ())
                if float(v) >= 1.0)
            fired = self.registry.get(
                "senweaver_fleet_alerts_fired_total")
            out: Dict[str, Any] = {
                "peers": gauge("senweaver_fleet_peers"),
                "peers_stale": gauge("senweaver_fleet_peers_stale"),
                "worst_kv_pressure": cell(
                    "senweaver_fleet_rollup",
                    "senweaver_kv_pressure", "max"),
                "burn_fast": cell("senweaver_fleet_burn_ratio",
                                  "slo_burn_fast", "fast"),
                "burn_slow": cell("senweaver_fleet_burn_ratio",
                                  "slo_burn_fast", "slow"),
                "alerts_active": len(firing),
                "alerts_firing": firing,
                "alerts_fired": (sum(float(v) for v in
                                     fired.samples().values())
                                 if fired is not None else 0),
                "incidents": None,
                "last_incident": None,
            }
            if self.incidents is not None:
                inc = self.incidents.summary()
                out["incidents"] = inc.get("incidents")
                out["last_incident"] = inc.get("last")
            return out
        except Exception as e:
            return {"error": str(e)}

    def _runtime_summary(self) -> Dict[str, Any]:
        """Runtime observatory tile: compile/retrace ledger, transfer
        bytes, and device-memory watermarks from the global
        :class:`~..obs.runtime_profile.RuntimeProfiler` (zero wiring —
        any ProfiledFunction in the process shows up). Totals come from
        the ledger itself rather than the ``senweaver_runtime_*``
        series so the tile works even when profiling ran against a
        since-swapped registry; the watermark gauges are registry-read
        because memory sampling is per-backend."""
        def label_max(name: str) -> Optional[float]:
            m = self.registry.get(name)
            if m is None:
                return None
            vals = [float(v) for v in m.samples().values()]
            return max(vals) if vals else None

        try:
            from ..obs.runtime_profile import get_profiler
            mb = 1024.0 * 1024.0
            rows = []
            calls = compiles = storms = h2d = d2h = 0
            for name, snap in sorted(get_profiler().ledger().items()):
                calls += snap["calls"]
                compiles += snap["compiles"]
                storms += snap["storms"]
                h2d += snap["h2d_bytes"]
                d2h += snap["d2h_bytes"]
                rows.append({
                    "fn": name, "calls": snap["calls"],
                    "compiles": snap["compiles"],
                    "signatures": len(snap["signatures"]),
                    "compile_ms": snap["compile_ms"],
                    "last_step_ms": snap["last_step_ms"],
                    "storms": snap["storms"],
                })
            wm = label_max("senweaver_runtime_hbm_watermark_bytes")
            live = label_max("senweaver_runtime_live_buffer_bytes")
            return {
                "calls": calls, "compiles": compiles,
                "retrace_storms": storms,
                "h2d_mb": round(h2d / mb, 3),
                "d2h_mb": round(d2h / mb, 3),
                "hbm_watermark_mb":
                    round(wm / mb, 1) if wm is not None else None,
                "live_buffer_mb":
                    round(live / mb, 3) if live is not None else None,
                "roofline_utilization":
                    label_max("senweaver_runtime_roofline_utilization"),
                "functions": rows,
            }
        except Exception as e:
            return {"error": str(e)}

    def _obs_summary(self) -> Dict[str, Any]:
        """Span counts, top-5 slowest spans, and the live throughput
        gauges — the obs tile's data (and /api/state's view of what the
        /metrics endpoint serves in full)."""
        try:
            summary = self.tracer.summary(top=5)
            tps = self.registry.get("senweaver_tokens_per_sec")
            if tps is not None:
                summary["tokens_per_sec"] = tps.value(phase="train")
                summary["collect_tokens_per_sec"] = \
                    tps.value(phase="collect")
            else:
                summary["tokens_per_sec"] = None
            mfu = self.registry.get("senweaver_train_mfu")
            summary["mfu"] = mfu.value() if mfu is not None else None
            rounds = self.registry.get("senweaver_rounds_total")
            summary["rounds_total"] = (rounds.value()
                                       if rounds is not None else 0)
            return summary
        except Exception as e:
            return {"error": str(e)}

    # -- http --------------------------------------------------------------
    def start(self, host: str = "127.0.0.1", port: int = 0) -> int:
        """Serve in a daemon thread; returns the bound port (0 = ephemeral)."""
        service = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (stdlib casing)
                if self.path.startswith("/api/state"):
                    body = json.dumps(service.state()).encode()
                    ctype = "application/json"
                elif self.path == "/metrics":
                    # Prometheus text exposition of the obs registry —
                    # scrape-ready (format v0.0.4).
                    body = service.registry.render().encode()
                    ctype = "text/plain; version=0.0.4; charset=utf-8"
                elif self.path == "/" or self.path.startswith("/index"):
                    body = _PAGE.replace("__TITLE__", service.title).encode()
                    ctype = "text/html; charset=utf-8"
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):  # noqa: N802 (stdlib casing)
                if self.path != "/api/action":
                    self.send_error(404)
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(n) or b"{}")
                    method = req.get("method", "")
                    params = req.get("params")
                except Exception as e:
                    self._reply(400, {"ok": False,
                                      "error": f"bad request: {e}"})
                    return
                if not service.control_socket:
                    self._reply(503, {"ok": False,
                                      "error": "no control socket wired"})
                    return
                from ..runtime.control import ControlClient, ControlError
                token = self.headers.get("X-Auth-Token") or None
                try:
                    result = ControlClient(service.control_socket).call(
                        method, params, token=token)
                    self._reply(200, {"ok": True, "result": result})
                except ControlError as e:
                    status = 401 if e.code == -32001 else 400
                    self._reply(status, {"ok": False, "code": e.code,
                                         "error": str(e)})
                except (OSError, ValueError) as e:
                    # ValueError covers json.JSONDecodeError from an
                    # empty/truncated control-plane reply — every failure
                    # path must return the structured {ok: false} body.
                    self._reply(502, {"ok": False,
                                      "error": f"control plane: {e}"})

            def _reply(self, status: int, payload: Dict[str, Any]) -> None:
                body = json.dumps(payload).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # quiet: metrics JSONL is the log
                pass

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="senweaver-dashboard",
                                        daemon=True)
        self._thread.start()
        return self._httpd.server_address[1]

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


# Single-file page. Design per the repo's dataviz conventions: role-based
# CSS custom properties with selected light AND dark values, one accent
# series hue, text in text tokens (never series color), thin marks, a
# recessive grid, hover crosshair + tooltip on the curves, and a table
# view of the recent rounds under the charts.
_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8">
<title>__TITLE__</title>
<style>
:root { color-scheme: light dark; }
body {
  margin: 0; font: 14px/1.45 system-ui, sans-serif;
  background: #fcfcfb; color: #0b0b0b;
  --surface-2: #f1f0ee; --border: #dddcd8;
  --text-2: #52514e; --series-1: #2a78d6; --series-3: #1baf7a;
  --good: #008300; --bad: #e34948; --warn: #eda100;
}
@media (prefers-color-scheme: dark) { body {
  background: #1a1a19; color: #ffffff;
  --surface-2: #242423; --border: #3a3a38;
  --text-2: #c3c2b7; --series-1: #3987e5; --series-3: #199e70;
  --good: #00a300; --bad: #e66767; --warn: #c98500;
}}
header { padding: 14px 20px; border-bottom: 1px solid var(--border); }
header h1 { font-size: 16px; margin: 0; }
header .sub { color: var(--text-2); font-size: 12px; }
main { padding: 16px 20px; max-width: 1100px; }
section { margin-bottom: 22px; }
h2 { font-size: 13px; text-transform: uppercase; letter-spacing: .04em;
     color: var(--text-2); margin: 0 0 8px; }
.tiles { display: flex; flex-wrap: wrap; gap: 10px; }
.tile { background: var(--surface-2); border: 1px solid var(--border);
        border-radius: 8px; padding: 10px 14px; min-width: 120px; }
.tile .v { font-size: 22px; font-weight: 600; }
.tile .l { font-size: 11px; color: var(--text-2); }
table { border-collapse: collapse; font-size: 12.5px; }
td, th { padding: 3px 10px 3px 0; text-align: left; }
th { color: var(--text-2); font-weight: 500; }
tr { border-bottom: 1px solid var(--border); }
.chart-wrap { position: relative; display: inline-block; }
.tooltip { position: absolute; pointer-events: none; display: none;
           background: var(--surface-2); border: 1px solid var(--border);
           border-radius: 6px; padding: 4px 8px; font-size: 12px; }
.status { font-size: 12px; }
.status::before { content: "● "; }
.status.done::before, .status.good::before { color: var(--good); }
.status.failed::before, .status.stopped::before { color: var(--bad); }
.status.running::before, .status.queued::before { color: var(--warn); }
.muted { color: var(--text-2); }
.rules li { margin-bottom: 2px; }
button { font: inherit; font-size: 12px; padding: 2px 10px;
         border: 1px solid var(--border); border-radius: 6px;
         background: var(--surface-2); color: inherit; cursor: pointer; }
button:hover { border-color: var(--text-2); }
input[type=text], input[type=password], textarea {
  font: inherit; font-size: 12.5px; color: inherit;
  background: var(--surface-2); border: 1px solid var(--border);
  border-radius: 6px; padding: 3px 8px; }
.actionbar { display: flex; gap: 8px; align-items: center;
             flex-wrap: wrap; margin: 6px 0; }
#action-status { font-size: 12px; }
#action-status.err { color: var(--bad); }
#action-status.okk { color: var(--good); }
</style></head><body>
<header><h1>__TITLE__</h1>
<div class="sub">operator dashboard · polls /api/state
<span id="updated" class="muted"></span></div>
<div class="actionbar">
<label class="muted" for="tok">auth token</label>
<input type="password" id="tok" size="18"
  placeholder="control-plane token">
<span id="action-status"></span></div></header>
<main>
<section><h2>Traces</h2><div id="traces" class="tiles"></div></section>
<section><h2>Training</h2>
<div id="charts"></div>
<div id="rounds-table"></div></section>
<section><h2>Observability</h2>
<div id="obs" class="tiles"></div>
<div id="obs-spans"></div></section>
<section><h2>Training health</h2>
<div id="training-health" class="tiles"></div>
<div id="health-triggers"></div></section>
<section><h2>Resilience</h2><div id="resilience" class="tiles"></div>
<div id="guard-skips"></div></section>
<section><h2>Serving</h2><div id="serving" class="tiles"></div></section>
<section><h2>Speculation</h2><div id="speculation" class="tiles"></div></section>
<section><h2>Multi-tenant</h2><div id="adapters" class="tiles"></div></section>
<section><h2>SLO</h2>
<div id="slo" class="tiles"></div>
<div id="slo-exemplars"></div></section>
<section><h2>Fleet health</h2>
<div id="fleet" class="tiles"></div>
<div id="fleet-incident"></div></section>
<section><h2>Learner &amp; autoscaler</h2>
<div id="learner" class="tiles"></div></section>
<section><h2>Streaming experience</h2>
<div id="streaming" class="tiles"></div></section>
<section><h2>Runtime</h2>
<div id="runtime" class="tiles"></div>
<div id="runtime-fns"></div></section>
<section><h2>Engine serving counters</h2><div id="engine"></div></section>
<section><h2>APO</h2>
<div class="actionbar">
<button onclick="act('apo.analyze')">analyze now</button>
<button onclick="act('apo.gradient')">request gradient</button></div>
<div id="apo-suggestions"></div>
<div id="apo"></div></section>
<section><h2>Jobs</h2>
<div class="actionbar">
<input type="text" id="job-params" size="32"
  placeholder='job params JSON, e.g. {"kind": "grpo"}'>
<button onclick="submitJob()">submit job</button></div>
<div id="jobs"></div></section>
<section><h2>Live config</h2>
<div class="actionbar">
<input type="text" id="cfg-json" size="44"
  placeholder='config JSON, e.g. {"allowed_models": ["tiny-test"]}'>
<button onclick="pushConfig()">push config</button></div></section>
<section><h2>Setup</h2><div id="onboarding"></div></section>
</main>
<script>
"use strict";
// Everything rendered into innerHTML passes through esc(): APO rules and
// suggestion text come from an LLM — stored-XSS surface without it.
const esc = v => String(v).replace(/[&<>"']/g, c => ({
  "&": "&amp;", "<": "&lt;", ">": "&gt;",
  '"': "&quot;", "'": "&#39;"}[c]));
const fmt = v => v == null ? "–"
  : (typeof v === "number" && !Number.isInteger(v) ? v.toFixed(3) : esc(v));

function tiles(el, pairs) {
  el.innerHTML = pairs.map(([l, v]) =>
    `<div class="tile"><div class="v">${fmt(v)}</div>` +
    `<div class="l">${esc(l)}</div></div>`).join("");
}

// Rows are escaped per-cell; a cell may opt out via {html: "..."} for
// markup the PAGE generated itself (status spans) — never raw data.
function table(rows, headers) {
  if (!rows.length) return '<span class="muted">no data yet</span>';
  const cell = c => (c && typeof c === "object" && "html" in c)
    ? c.html : esc(fmt(c));
  const h = headers.map(x => `<th>${esc(x)}</th>`).join("");
  const b = rows.map(r =>
    `<tr>${r.map(c => `<td>${cell(c)}</td>`).join("")}</tr>`).join("");
  return `<table><tr>${h}</tr>${b}</table>`;
}

const statusSpan = s =>
  ({html: `<span class="status ${esc(s)}">${esc(s)}</span>`});

// Operator actions: POST /api/action → control-plane JSON-RPC. The
// token never persists server-side; it rides each request's header and
// the ControlServer validates it (no token → unauthorized).
const tokEl = () => document.getElementById("tok");
window.addEventListener("DOMContentLoaded", () => {
  tokEl().value = localStorage.getItem("senweaver-token") || "";
  tokEl().addEventListener("change", () =>
    localStorage.setItem("senweaver-token", tokEl().value));
});
async function act(method, params) {
  const st = document.getElementById("action-status");
  st.className = ""; st.textContent = `${method} …`;
  let body;
  try {
    const r = await fetch("/api/action", {
      method: "POST",
      headers: {"Content-Type": "application/json",
                "X-Auth-Token": tokEl().value},
      body: JSON.stringify({method, params})});
    body = await r.json();
  } catch (e) { body = {ok: false, error: String(e)}; }
  st.className = body.ok ? "okk" : "err";
  st.textContent = body.ok ? `${method}: ok`
    : `${method}: ${body.error || "failed"}`;
  refresh();
  return body;
}
function submitJob() {
  let p = document.getElementById("job-params").value.trim();
  try { p = p ? JSON.parse(p) : {}; }
  catch (e) {
    const st = document.getElementById("action-status");
    st.className = "err"; st.textContent = `params: ${e}`; return;
  }
  act("submit", p);
}
function pushConfig() {
  let p = document.getElementById("cfg-json").value.trim();
  try { p = JSON.parse(p || "{}"); }
  catch (e) {
    const st = document.getElementById("action-status");
    st.className = "err"; st.textContent = `config: ${e}`; return;
  }
  act("config.push", p);
}
// Action buttons carry ids via data- attributes (never inline JS with
// interpolated data — the id is LLM-adjacent data, same XSS posture).
document.addEventListener("click", e => {
  const b = e.target.closest("button[data-act]");
  if (!b) return;
  act(b.dataset.act, {id: b.dataset.id, job_id: b.dataset.id});
});
const actBtn = (method, id, label) =>
  ({html: `<button data-act="${esc(method)}" data-id="${esc(id)}">` +
          `${esc(label)}</button>`});

// Single-series line chart: thin 2px line, recessive grid, hover
// crosshair + tooltip, no legend (the title names the series).
function lineChart(xs, ys, label, color) {
  const W = 420, H = 120, P = 28;
  const pts = xs.map((x, i) => [x, ys[i]]).filter(p => p[1] != null);
  if (pts.length < 2)
    return `<div class="muted">${esc(label)}: need ≥2 rounds</div>`;
  const yv = pts.map(p => p[1]);
  const ymin = Math.min(...yv), ymax = Math.max(...yv);
  const yr = (ymax - ymin) || 1;
  const sx = i => P + (W - 2 * P) * i / (pts.length - 1);
  const sy = v => H - P - (H - 2 * P) * (v - ymin) / yr;
  const path = pts.map((p, i) =>
    `${i ? "L" : "M"}${sx(i).toFixed(1)},${sy(p[1]).toFixed(1)}`).join("");
  const grid = [ymin, (ymin + ymax) / 2, ymax].map(v =>
    `<line x1="${P}" x2="${W - P}" y1="${sy(v)}" y2="${sy(v)}"
      stroke="var(--border)" stroke-width="1"/>` +
    `<text x="${P - 4}" y="${sy(v) + 4}" text-anchor="end"
      font-size="10" fill="var(--text-2)">${v.toFixed(2)}</text>`).join("");
  const id = "c" + Math.random().toString(36).slice(2, 8);
  setTimeout(() => hoverLayer(id, pts, sx, sy, label), 0);
  return `<div class="chart-wrap" id="${id}">
    <svg width="${W}" height="${H}" role="img" aria-label="${esc(label)}">
    <text x="${P}" y="14" font-size="11"
      fill="var(--text-2)">${esc(label)}</text>
    ${grid}
    <path d="${path}" fill="none" stroke="${color}" stroke-width="2"/>
    <line class="xh" y1="${P}" y2="${H - P}" stroke="var(--text-2)"
      stroke-width="1" style="display:none"/>
    <circle class="pt" r="4" fill="${color}" stroke="var(--surface-2)"
      stroke-width="2" style="display:none"/>
    </svg><div class="tooltip"></div></div>`;
}

function hoverLayer(id, pts, sx, sy, label) {
  const wrap = document.getElementById(id);
  if (!wrap) return;
  const svg = wrap.querySelector("svg"), tip = wrap.querySelector(".tooltip");
  const xh = svg.querySelector(".xh"), dot = svg.querySelector(".pt");
  svg.addEventListener("mousemove", e => {
    const r = svg.getBoundingClientRect();
    const x = e.clientX - r.left;
    let best = 0, bd = 1e9;
    pts.forEach((p, i) => { const d = Math.abs(sx(i) - x);
                            if (d < bd) { bd = d; best = i; } });
    const px = sx(best), py = sy(pts[best][1]);
    xh.setAttribute("x1", px); xh.setAttribute("x2", px);
    xh.style.display = ""; dot.style.display = "";
    dot.setAttribute("cx", px); dot.setAttribute("cy", py);
    tip.style.display = "block";
    tip.style.left = (px + 10) + "px"; tip.style.top = (py - 10) + "px";
    tip.textContent =
      `round ${pts[best][0]} · ${label} ${fmt(pts[best][1])}`;
  });
  svg.addEventListener("mouseleave", () => {
    xh.style.display = "none"; dot.style.display = "none";
    tip.style.display = "none";
  });
}

async function refresh() {
  let s;
  try { s = await (await fetch("/api/state")).json(); }
  catch (e) { return; }
  document.getElementById("updated").textContent =
    " · updated " + new Date().toLocaleTimeString();
  const t = s.traces || {};
  tiles(document.getElementById("traces"), [
    ["traces", t.total_traces], ["spans", t.total_spans],
    ["good fb", t.good_feedbacks], ["bad fb", t.bad_feedbacks],
    ["tool success", t.tool_success_rate],
    ["avg finalReward", t.avg_final_reward]]);
  const tr = s.training || {rounds: []};
  document.getElementById("charts").innerHTML =
    lineChart(tr.rounds, tr.reward_mean || [], "reward_mean",
              "var(--series-1)") + " " +
    lineChart(tr.rounds, tr.loss || [], "loss", "var(--series-3)");
  // rounds holds TRUE indices (they survive truncation); the series are
  // positional — iterate positions and use rounds[pos] as the label.
  const nR = (tr.rounds || []).length;
  const positions = [...Array(nR).keys()].slice(-12);
  document.getElementById("rounds-table").innerHTML = table(
    positions.map(p => [tr.rounds[p], fmt((tr.reward_mean || [])[p]),
                        fmt((tr.loss || [])[p]),
                        fmt((tr.episodes || [])[p]),
                        fmt((tr.collect_s || [])[p])]),
    ["round", "reward_mean", "loss", "episodes", "collect_s"]);
  const ob_ = s.obs || {};
  tiles(document.getElementById("obs"), [
    ["tracing", ob_.enabled ? "on" : "off"],
    ["spans", ob_.total_spans],
    ["rounds", ob_.rounds_total],
    ["tokens/s train", ob_.tokens_per_sec],
    ["tokens/s collect", ob_.collect_tokens_per_sec],
    ["mfu", ob_.mfu]]);
  document.getElementById("obs-spans").innerHTML = table(
    (ob_.slowest || []).map(x => [x.name, x.duration_ms]),
    ["slowest span", "ms"]);
  const th = s.training_health || {};
  tiles(document.getElementById("training-health"), [
    ["health rounds", th.rounds],
    ["health score", th.score],
    ["rank fraction", th.rank_fraction],
    ["effective rank", th.effective_rank],
    ["zero-adv groups", th.zero_group_fraction],
    ["credit entropy", th.credit_entropy],
    ["grad sparsity", th.grad_sparsity],
    ["policy entropy", th.policy_entropy],
    ["kl to anchor", th.kl_to_anchor],
    ["nonfinite frac", th.nonfinite_fraction],
    ["group size", th.group_size]]);
  document.getElementById("health-triggers").innerHTML = table(
    Object.entries(th.triggers || {}).map(([k, v]) => [k, v])
      .concat(Object.entries(th.mitigations || {})
        .map(([k, v]) => ["mitigation " + k, v])),
    ["trigger / mitigation", "count"]);
  const res = s.resilience || {};
  tiles(document.getElementById("resilience"), [
    ["failed episodes", res.episodes_failed],
    ["episode retries", res.episode_retries],
    ["groups dropped", res.groups_dropped],
    ["rounds skipped", res.rounds_skipped],
    ["updates skipped", res.updates_skipped],
    ["uploader retries", res.uploader_retries],
    ["chaos injected", res.chaos_injected]]);
  document.getElementById("guard-skips").innerHTML = table(
    Object.entries(res.guard_skip_reasons || {}).map(([k, v]) => [k, v]),
    ["guard skip reason", "count"]);
  const sv = s.serving || {};
  tiles(document.getElementById("serving"), [
    ["replicas live", sv.replicas_live],
    ["queue depth", sv.queue_depth],
    ["completed", sv.completed],
    ["shed", sv.shed],
    ["retries", sv.retries],
    ["weight version", sv.weight_version],
    ["version skew", sv.version_skew],
    ["ttft ms (mean)", sv.ttft_ms_mean],
    ["e2e ms (mean)", sv.e2e_ms_mean],
    ["remote rpcs", sv.remote_rpcs],
    ["rpc retries", sv.remote_rpc_retries],
    ["breaker opens", sv.breaker_opens],
    ["probes dead", sv.probes_dead],
    ["continuation replays", sv.continuation_replays],
    ["publish quarantined", sv.publish_quarantined]]);
  const spec = s.speculation || {};
  tiles(document.getElementById("speculation"), [
    ["depth", spec.depth],
    ["controller load", spec.controller_load],
    ["depth changes", spec.depth_changes],
    ["acceptance (worst)", spec.acceptance_rate],
    ["draft staleness", spec.draft_staleness],
    ["wasted draft tokens", spec.wasted_draft_tokens],
    ["distill steps", spec.distill_steps],
    ["distill loss", spec.distill_loss],
    ["draft publishes", spec.draft_publishes],
    ["draft install failures", spec.draft_install_failures],
    ["draft blocks free", spec.draft_blocks_free]]);
  const ad = s.adapters || {};
  tiles(document.getElementById("adapters"), [
    ["pool slots", ad.pool_slots],
    ["resident", ad.pool_resident],
    ["publishes", ad.publishes],
    ["fleet publishes", ad.fleet_publishes],
    ["installs", ad.installs],
    ["evictions", ad.evictions],
    ["install failures", ad.install_failures],
    ["affinity hits", ad.affinity_hits],
    ["version skew", ad.version_skew],
    ["gather overhead", ad.gather_overhead]]);
  const slo = s.slo || {};
  tiles(document.getElementById("slo"), [
    ["slo requests", slo.requests],
    ["slo violations", slo.violations],
    ["burn ratio", slo.burn_ratio],
    ["ttft s (mean)", slo.ttft_s_mean],
    ["tpot s (mean)", slo.tpot_s_mean],
    ["queue wait s (mean)", slo.queue_wait_s_mean],
    ["e2e s (mean)", slo.e2e_s_mean],
    ["timelines", slo.timelines_finished],
    ["timelines evicted", slo.timelines_evicted],
    ["publish windows", slo.publish_windows],
    ["spans dropped", slo.spans_dropped]]);
  document.getElementById("slo-exemplars").innerHTML = table(
    (slo.exemplars || []).map(x => [x.ticket, x.priority, x.violations,
                                    x.ttft_s, x.e2e_s, x.trace_id]),
    ["worst request", "priority", "violated", "ttft_s", "e2e_s",
     "trace"]);
  const fl = s.fleet || {};
  tiles(document.getElementById("fleet"), [
    ["federated peers", fl.peers],
    ["stale peers", fl.peers_stale],
    ["worst kv pressure", fl.worst_kv_pressure],
    ["burn (fast 5m)", fl.burn_fast],
    ["burn (slow 1h)", fl.burn_slow],
    ["active alerts", fl.alerts_active],
    ["alerts fired", fl.alerts_fired],
    ["incidents", fl.incidents]]);
  document.getElementById("fleet-incident").innerHTML =
    (fl.alerts_firing || []).length || fl.last_incident
      ? table([[esc((fl.alerts_firing || []).join(", ") || "none"),
                esc(fl.last_incident || "none")]],
              ["firing", "last incident"])
      : "";
  tiles(document.getElementById("learner"), [
    ["lease epoch", sv.lease_epoch],
    ["learner rounds", sv.learner_rounds],
    ["learner publishes", sv.learner_publishes],
    ["publish failures", sv.learner_publish_failures],
    ["resume republishes", sv.learner_resume_republishes],
    ["lease lost", sv.learner_lease_lost],
    ["stale publishes fenced", sv.stale_publishes],
    ["autoscale adds", sv.autoscale_adds],
    ["autoscale drains", sv.autoscale_drains],
    ["shed rate (1/s)", sv.autoscale_shed_rate]]);
  tiles(document.getElementById("streaming"), [
    ["mode (1=streaming)", sv.learner_streaming_mode],
    ["learner idle fraction", sv.learner_idle_fraction],
    ["steps (streaming)", sv.stream_steps_streaming],
    ["steps (lockstep)", sv.stream_steps_lockstep],
    ["queue depth", sv.experience_queue_depth],
    ["ready groups", sv.experience_ready_groups],
    ["stale episodes dropped", sv.stale_episodes],
    ["duplicate episodes", sv.duplicate_episodes],
    ["collector stall fraction", sv.collector_stall_fraction]]);
  const rt = s.runtime || {};
  tiles(document.getElementById("runtime"), [
    ["profiled calls", rt.calls],
    ["compiles", rt.compiles],
    ["retrace storms", rt.retrace_storms],
    ["h2d MB", rt.h2d_mb],
    ["d2h MB", rt.d2h_mb],
    ["hbm watermark MB", rt.hbm_watermark_mb],
    ["live buffers MB", rt.live_buffer_mb],
    ["roofline util", rt.roofline_utilization]]);
  document.getElementById("runtime-fns").innerHTML = table(
    (rt.functions || []).map(f => [f.fn, f.calls, f.compiles,
                                   f.signatures, f.compile_ms,
                                   f.last_step_ms, f.storms]),
    ["profiled fn", "calls", "compiles", "sigs", "compile ms",
     "last step ms", "storms"]);
  const eng = s.engine || {};
  document.getElementById("engine").innerHTML = table(
    Object.entries(eng).map(([k, v]) => [k, fmt(v)]), ["counter", "value"]);
  const a = s.apo || {};
  let apoHtml = table(
    Object.entries(a).filter(([k, v]) => typeof v !== "object")
      .map(([k, v]) => [k, fmt(v)]), ["stat", "value"]);
  if ((a.optimized_rules || []).length)
    apoHtml += "<ul class='rules'>" + a.optimized_rules.map(r =>
      `<li>${esc(r)}</li>`).join("") + "</ul>";
  // (report-snapshot suggestions are NOT rendered here: the live
  // actionable table above supersedes them, and snapshot statuses go
  // stale the moment an apply/reject lands.)
  document.getElementById("apo").innerHTML = apoHtml;
  document.getElementById("apo-suggestions").innerHTML = table(
    (a.suggestions || []).map(x => [
      statusSpan(x.status), x.priority, x.description,
      x.status === "pending" ? actBtn("apo.apply", x.id, "apply") : "",
      x.status === "pending" ? actBtn("apo.reject", x.id, "reject")
        : (x.status === "applied" ? actBtn("apo.revert", x.id, "revert")
                                  : "")]),
    ["status", "priority", "suggestion", "", ""]);
  document.getElementById("jobs").innerHTML = table(
    (s.jobs || []).map(j =>
      [j.job_id, statusSpan(j.status),
       new Date(j.submitted_at * 1000).toLocaleTimeString(),
       ["queued", "running"].includes(j.status)
         ? actBtn("stop", j.job_id, "stop") : ""]),
    ["job", "status", "submitted", ""]);
  const ob = s.onboarding;
  document.getElementById("onboarding").innerHTML = !ob ? "" :
    ob.error ? `<p>onboarding source error: ${esc(ob.error)}</p>` :
    (ob.complete ? "<p>onboarding complete</p>"
                 : `<p>current step: <b>${esc(ob.current)}</b> — ` +
                   `${esc(ob.prompt || "")}</p>`) +
    table((ob.steps || []).map(st =>
      [st.name, st.done ? "done" : (st.optional ? "optional" : "pending"),
       String((ob.answers || {})[st.name] ?? "")]),
      ["step", "state", "answer"]);
}
refresh();
setInterval(refresh, 2500);
</script></body></html>
"""
