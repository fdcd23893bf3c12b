"""The closed GRPO loop: tasks → grouped rollouts → rewards → update.

This is the system SURVEY.md §7's architecture diagram describes end to
end: the rollout engine samples G trajectories per task (the GRPO group),
each driven through a fully-wired RolloutSession (tools, subagents,
traces), the 9-dim reward head scores each episode's trace, group-relative
advantages are computed per task, and the policy takes a clipped-objective
step — replacing the reference's backend-LLM prompt optimization with
local weight updates (apoService.ts:992-1215's optimizer moves in-tree).

Credit assignment: every LLM call inside an episode becomes one
trajectory carrying the episode's finalReward (the per-call token streams
come from EnginePolicyClient.record_calls — no re-tokenization drift);
group ids are per task so advantages compare alternative episodes of the
SAME task.

PyTorch port of the JAX package's ``training/rl_loop.py``: the same
functions, signatures, spans and metric names. Two things differ, both
because the port's optimizer updates the params and Adam moments IN
PLACE (training/trainer.py):

- the guard vetoes BEFORE the update: ``_grpo_round_impl`` computes the
  gradients, syncs the metrics to host floats, asks ``update_guard`` and
  only then applies them (``trainer.train_step_guarded``), so a vetoed
  epoch leaves params, moments and ``state.step`` exactly as they were —
  what the JAX loop gets by restoring the pre-step state;
- the engine that collected the round serves the very tensors the update
  writes. Rounds run in lockstep (collection has finished before the
  update starts), and ``RolloutEngine.update_params`` stays the publish
  that says so.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..obs import StepTelemetry, get_registry, get_tracer
from ..resilience.faults import (FailedEpisode, REASON_ERROR,
                                 REASON_TIMEOUT, ResilienceConfig,
                                 episode_retry_delay_s)
from ..rollout.session import RolloutSession
from .data import (Trajectory, make_batch, make_batch_logps,
                   make_branch_mask, place_batch_for_mesh)
from .grpo import GRPOConfig
from .trainer import TrainState, train_step_guarded


@dataclasses.dataclass
class EpisodeRecord:
    task_idx: int
    reward: float
    n_calls: int
    steps: int
    # (epoch, version) of the weights that SAMPLED this episode — the
    # behavior-policy stamp the streaming experience pipeline keys its
    # staleness bound and importance correction on. Lockstep rounds
    # stamp the round's published pair; 0/0 means "unstamped"
    # (in-process session with no versioned publisher).
    behavior_epoch: int = 0
    behavior_version: int = 0


@dataclasses.dataclass
class RoundResult:
    state: TrainState
    metrics: Dict[str, float]
    episodes: List[EpisodeRecord]
    trajectories: List[Trajectory]
    # Resilience surface (empty/None without a ResilienceConfig):
    failures: List[FailedEpisode] = dataclasses.field(default_factory=list)
    dropped_groups: List[int] = dataclasses.field(default_factory=list)
    update_skipped: Optional[str] = None
    # Training-health surface (empty for skipped/empty rounds): the
    # round's flat health dict (training/diagnostics + step metrics),
    # the detector triggers that fired, and any mitigation/veto events.
    health: Dict[str, float] = dataclasses.field(default_factory=dict)
    health_triggers: List[str] = dataclasses.field(default_factory=list)
    health_events: List[str] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class CollectResult:
    """Collection outcome + fault-boundary bookkeeping.

    Iterates as the historical ``(trajectories, episodes)`` pair so
    existing ``trajs, eps = collect_group_trajectories(...)`` call sites
    keep working; resilience-aware callers read the named fields."""

    trajectories: List[Trajectory]
    episodes: List[EpisodeRecord]
    failures: List[FailedEpisode] = dataclasses.field(default_factory=list)
    dropped_groups: List[int] = dataclasses.field(default_factory=list)
    retries: int = 0
    # Tree-planner shape summary (rollout.group_tree branch_stats) when
    # collection went through the shared-KV planner; empty for the
    # session path. Folded into round health as tree_* keys.
    branch_stats: Dict[str, float] = dataclasses.field(default_factory=dict)

    def __iter__(self):
        return iter((self.trajectories, self.episodes))


class GroupSizeScheduler:
    """Health-triggered group-size hook (the third health mitigation).

    A high zero-advantage-group fraction usually means the group is too
    SMALL to separate rewards — more samples per prompt restore a
    spread. While the ``group_size`` mitigation is active
    (resilience.HealthMitigator streak logic), :meth:`update` doubles
    the group size toward ``max_size``; once the mitigation clears it
    halves back toward the caller's baseline. The current size
    publishes as the ``senweaver_grpo_group_size`` gauge and every
    change is returned as a round event — the loop (training/online.py)
    feeds the returned size into its NEXT round's collection."""

    def __init__(self, group_size: int, *, min_size: int = 2,
                 max_size: int = 16, registry=None):
        if registry is None:
            registry = get_registry()
        self.base = max(1, int(group_size))
        self.min_size = max(1, int(min_size))
        self.max_size = max(self.min_size, int(max_size))
        self.current = min(max(self.base, self.min_size), self.max_size)
        self._gauge = registry.gauge(
            "senweaver_grpo_group_size",
            "Current GRPO group size (health scheduler may raise it).")
        self._gauge.set(float(self.current))

    @classmethod
    def from_config(cls, config: ResilienceConfig, group_size: int,
                    registry=None) -> "GroupSizeScheduler":
        return cls(group_size, min_size=config.group_size_min,
                   max_size=config.group_size_max, registry=registry)

    def update(self, mitigation_active: bool) -> Tuple[int, List[str]]:
        """One post-round tick; returns (next_group_size, events)."""
        events: List[str] = []
        if mitigation_active and self.current < self.max_size:
            self.current = min(self.current * 2, self.max_size)
            events.append(f"group_size_increased:{self.current}")
        elif not mitigation_active and self.current > self.base:
            self.current = max(self.base, self.current // 2)
            events.append(f"group_size_decreased:{self.current}")
        self._gauge.set(float(self.current))
        return self.current, events


def _params_device(params):
    """The device of the first tensor in a (nested) params dict."""
    while isinstance(params, dict):
        params = next(iter(params.values()))
    return params.device


class EpisodeTimeout(RuntimeError):
    """An episode attempt exceeded ResilienceConfig.episode_timeout_s."""


def _call_with_timeout(fn, timeout_s: Optional[float]):
    """Run ``fn()`` bounded by ``timeout_s`` wall seconds. Python can't
    kill a thread, so a timed-out attempt is ABANDONED on a daemon
    thread: its session still closes via _run_episode's finally when
    (if) the attempt eventually returns, but the boundary stops
    waiting."""
    if not timeout_s:
        return fn()
    box: Dict[str, object] = {}

    def target():
        try:
            box["ok"] = fn()
        except BaseException as e:          # re-raised on the caller
            box["err"] = e

    t = threading.Thread(target=target, daemon=True,
                         name="episode-attempt")
    t.start()
    t.join(timeout_s)
    if t.is_alive():
        raise EpisodeTimeout(f"episode exceeded {timeout_s}s")
    if "err" in box:
        raise box["err"]                    # type: ignore[misc]
    return box["ok"]


def _run_episode(make_session, task_idx: int, task: str, g: int,
                 reward_override, round_idx: int = 0
                 ) -> tuple[List[Trajectory], EpisodeRecord]:
    session = make_session()
    try:
        # Episode-aware sessions (the chaos harness's ChaosSession, or
        # any session wanting per-episode attribution) learn their exact
        # coordinates before the turn runs.
        bind = getattr(session, "bind_episode", None)
        if bind is not None:
            bind(round_idx, task_idx, g)
        client = session.client
        log_start = len(getattr(client, "call_log", []))
        out = session.run_turn(task)
        if reward_override is not None:
            reward = reward_override(task_idx, g, session)
        else:
            reward = (out.trace.summary.final_reward
                      if out.trace is not None else 0.0)
        calls = list(getattr(client, "call_log", []))[log_start:]
        trajectories = [
            Trajectory(prompt_ids=rec[0], completion_ids=rec[1],
                       reward=float(reward), group_id=task_idx,
                       behavior_logp=(list(rec[2]) if len(rec) > 2
                                      else None))
            for rec in calls]
        episode = EpisodeRecord(task_idx=task_idx, reward=float(reward),
                                n_calls=len(calls), steps=out.loop.steps)
        return trajectories, episode
    finally:
        session.close()


def collect_tree_trajectories(
        planner, prompts: Sequence[Sequence[int]], *, group_size: int,
        max_new_tokens: int = 128, eos_id: Optional[int] = None,
        adapter_id: Optional[str] = None,
        reward_fn: Optional[Callable[..., float]] = None,
) -> CollectResult:
    """Token-list collection through the shared-KV tree planner.

    ``planner`` is a ``rollout.group_tree.GroupRollout`` over a paged
    engine.

    The session path below runs G INDEPENDENT episodes per task — G
    prefills of the same prompt. This path routes token-list tasks
    through :class:`rollout.group_tree.GroupRollout` instead: one
    shared prefill per group (engine.submit_group block-table forks)
    plus BranchPolicy-driven tree splits, so a group of G leaves costs
    one prefill and only the divergent suffixes' decode. Each finished
    leaf becomes one Trajectory whose ``branch_points`` (0-based
    completion indices) carry the tree lineage into the batch
    (data.make_branch_mask → grpo_objective branch-credit sharpening),
    and the planner's ``branch_stats`` ride on the CollectResult for
    the round-health fold.

    ``reward_fn(task_idx, leaf_idx, record)`` scores a leaf record (the
    planner ``collect()`` dict: spliced ``tokens``/``logps`` plus
    lineage); without one every leaf gets reward 0.0 and the caller
    stamps rewards on the returned trajectories afterwards."""
    tracer = get_tracer()
    trajectories: List[Trajectory] = []
    episodes: List[EpisodeRecord] = []
    with tracer.span("tree_collect", tasks=len(prompts),
                     group_size=group_size):
        gids = [planner.submit_group(
                    list(p), group_size, max_new_tokens=max_new_tokens,
                    eos_id=eos_id, adapter_id=adapter_id)
                for p in prompts]
        planner.run()
        for ti, (prompt, gid) in enumerate(zip(prompts, gids)):
            for li, rec in enumerate(planner.collect(gid)):
                reward = (float(reward_fn(ti, li, rec))
                          if reward_fn is not None else 0.0)
                toks = list(rec["tokens"])
                # Planner branch positions are group-relative emitted
                # counts ("pos tokens out"); completion index = pos-1.
                pts = sorted({int(p) - 1 for p in rec["branch_points"]
                              if 1 <= int(p) <= len(toks)})
                trajectories.append(Trajectory(
                    prompt_ids=list(prompt), completion_ids=toks,
                    reward=reward, group_id=ti,
                    behavior_logp=list(rec["logps"]),
                    branch_points=pts or None))
                episodes.append(EpisodeRecord(
                    task_idx=ti, reward=reward, n_calls=1, steps=1))
    stats = {k: float(v) for k, v in planner.branch_stats().items()}
    return CollectResult(trajectories=trajectories, episodes=episodes,
                         branch_stats=stats)


def collect_group_trajectories(
        make_session: Callable[[], RolloutSession],
        tasks: Sequence[str], *, group_size: int,
        reward_override: Optional[Callable[[int, int, RolloutSession],
                                           float]] = None,
        max_parallel: int = 8,
        resilience: Optional[ResilienceConfig] = None,
        round_idx: int = 0,
        retry_sleep: Callable[[float], None] = time.sleep,
        planner=None,
) -> CollectResult:
    """Run group_size episodes per task; one Trajectory per LLM call.

    Episodes run CONCURRENTLY (up to ``max_parallel`` host threads — the
    reference's 8-way subagent posture, subagentToolService.ts:33): each
    thread drives its own session/agent loop while all their LLM calls
    interleave on the shared engine's slot pool (EnginePolicyClient.chat
    steps the engine until its own request finishes), so collection
    actually exploits continuous batching instead of keeping one slot busy.

    make_session must return a FRESH session per call — own workspace,
    collector, and client instance (``EnginePolicyClient(record_calls=True)``
    or compatible; the engine itself is shared and lock-serialized, but
    ``call_log`` slicing requires a client per episode).
    reward_override(task_idx, g, session) can replace the trace reward
    (evaluator-in-the-loop). Results are returned in deterministic
    (task_idx, g) order regardless of completion order.

    With a ``resilience`` config, each episode runs inside a FAULT
    BOUNDARY: per-attempt timeout (``episode_timeout_s``), bounded retry
    with backoff (``episode_retries``), and quarantine — a persistently
    failing episode becomes a :class:`FailedEpisode` record instead of
    an exception. Task groups keeping fewer than ``min_group_survivors``
    episodes are dropped whole (their advantages are degenerate), and a
    round losing every group returns empty — the caller's empty-batch
    path skips the update. Without a config the historical raise-on-
    first-error semantics hold (but in-flight work is drained first).

    With a ``planner`` (rollout.group_tree.GroupRollout) and TOKEN-LIST
    tasks, collection routes through :func:`collect_tree_trajectories`
    instead — one shared prefill per group via KV fork, tree branching
    per the planner's BranchPolicy; ``reward_override`` is then called
    as ``reward_override(task_idx, leaf_idx, leaf_record)``."""
    if planner is not None:
        if any(isinstance(t, str) for t in tasks):
            raise ValueError(
                "planner routing needs token-list tasks (the tree "
                "planner drives the engine directly; string tasks run "
                "through sessions — drop the planner argument)")
        return collect_tree_trajectories(
            planner, tasks, group_size=group_size,
            reward_fn=reward_override)
    import concurrent.futures as _fut

    # Span context must cross the pool explicitly (contextvars don't):
    # each episode span re-attaches the caller's context so the whole
    # group nests under the round's "collect" span in the flamegraph.
    tracer = get_tracer()
    parent_ctx = tracer.capture()
    registry = get_registry()
    failures: List[FailedEpisode] = []
    retries_total = [0]

    def _episode_job(ti: int, task: str, g: int):
        with tracer.attach(parent_ctx):
            with tracer.span("episode", task_idx=ti, g=g):
                return _run_episode(make_session, ti, task, g,
                                    reward_override, round_idx)

    def _guarded_job(ti: int, task: str, g: int):
        """The fault boundary: returns (result, None) or (None,
        FailedEpisode) — never raises."""
        assert resilience is not None
        t0 = time.monotonic()
        last_err: Optional[BaseException] = None
        attempts = 0
        while attempts <= resilience.episode_retries:
            attempts += 1
            try:
                out = _call_with_timeout(
                    lambda: _episode_job(ti, task, g),
                    resilience.episode_timeout_s)
                return out, None
            except Exception as e:
                last_err = e
            if attempts <= resilience.episode_retries:
                retries_total[0] += 1
                registry.counter(
                    "senweaver_grpo_episode_retries_total",
                    "Episode attempts retried by the fault boundary"
                ).inc()
                retry_sleep(episode_retry_delay_s(
                    attempts, base_s=resilience.retry_base_delay_s,
                    max_s=resilience.retry_max_delay_s))
        reason = (REASON_TIMEOUT if isinstance(last_err, EpisodeTimeout)
                  else REASON_ERROR)
        registry.counter(
            "senweaver_grpo_episodes_failed_total",
            "Episodes quarantined after exhausting retries",
            labelnames=("reason",)).inc(reason=reason)
        return None, FailedEpisode(
            task_idx=ti, g=g, round_idx=round_idx, reason=reason,
            error=repr(last_err), attempts=attempts,
            elapsed_s=time.monotonic() - t0)

    run_job = _episode_job if resilience is None else _guarded_job
    jobs = [(ti, task, g) for ti, task in enumerate(tasks)
            for g in range(group_size)]
    results: Dict[tuple, tuple] = {}
    if max_parallel <= 1 or len(jobs) <= 1:
        for ti, task, g in jobs:
            results[(ti, g)] = run_job(ti, task, g)
    else:
        with _fut.ThreadPoolExecutor(max_workers=max_parallel) as pool:
            futs = {pool.submit(run_job, ti, task, g): (ti, g)
                    for ti, task, g in jobs}
            try:
                for f in _fut.as_completed(futs):
                    results[futs[f]] = f.result()
            except BaseException:
                # Historical (no-resilience) crash path, fixed: cancel
                # episodes that haven't started and DRAIN the in-flight
                # ones before re-raising — their threads must not keep
                # stepping a shared engine the caller is about to tear
                # down, and _run_episode's finally closes each session
                # only when its thread finishes.
                for other in futs:
                    other.cancel()
                _fut.wait(list(futs))
                raise

    if resilience is not None:
        for (ti, g), (out, failure) in sorted(results.items()):
            if failure is not None:
                failures.append(failure)
        # Group-survivor threshold: group-relative advantages over 0-1
        # survivors are degenerate (vacuous or mean-centered to zero),
        # so a gutted group's trajectories only add noise to the batch.
        eff_min = min(resilience.min_group_survivors, group_size)
        dropped_groups: List[int] = []
        for ti in range(len(tasks)):
            survivors = [k for k, (out, fl) in results.items()
                         if k[0] == ti and fl is None]
            if len(survivors) < eff_min:
                dropped_groups.append(ti)
                for k in survivors:
                    del results[k]
        if dropped_groups:
            registry.counter(
                "senweaver_grpo_task_groups_dropped_total",
                "Task groups dropped below min_group_survivors"
            ).inc(len(dropped_groups))
        results = {k: v[0] for k, v in results.items()
                   if v[1] is None and k[0] not in dropped_groups}
    else:
        dropped_groups = []

    trajectories: List[Trajectory] = []
    episodes: List[EpisodeRecord] = []
    for key in sorted(results):
        trajs, episode = results[key]
        trajectories.extend(trajs)
        episodes.append(episode)
    return CollectResult(trajectories=trajectories, episodes=episodes,
                         failures=failures,
                         dropped_groups=dropped_groups,
                         retries=retries_total[0])


def is_lead_rank(mesh) -> bool:
    """True without a mesh, and on the rank at the mesh's origin: the one
    that collects and publishes for the mesh."""
    return mesh is None or mesh.coord(mesh.axis_names) == 0


def grpo_round(state: TrainState, model_config, mesh,
               make_session: Callable[[], RolloutSession],
               tasks: Sequence[str], *, group_size: int = 4,
               pad_id: int = 0, max_len: Optional[int] = None,
               grpo_config: GRPOConfig = GRPOConfig(),
               reward_override=None,
               max_parallel: int = 8,
               accum_steps: int = 1,
               ppo_epochs: int = 1,
               metrics_service=None,
               perf_monitor=None,
               engine=None,
               lora_base=None,
               ref_params=None,
               resilience: Optional[ResilienceConfig] = None,
               update_guard=None,
               health_mitigator=None,
               round_idx: int = 0,
               behavior_stamp: Optional[Tuple[int, int]] = None,
               planner=None,
               profile_dir: Optional[str] = None) -> RoundResult:
    """One on-policy round: collect → batch → GRPO update(s).

    ``metrics_service`` (services.MetricsService) observes the trainer
    itself (SURVEY.md §7 step 8): per-phase wall time, episode rewards,
    and the update's loss/grad metrics — the trainer-side counterpart of
    the agent loop's 'Agent Loop Done' capture
    (chatThreadService.ts:1742). ``perf_monitor``
    (services.PerformanceMonitor) threshold-checks each phase;
    ``profile_dir`` wraps the whole round in a ``torch.profiler`` capture
    (a Chrome trace with the card's timeline,
    services/perf_monitor.profile_capture).

    ``resilience`` arms the episode fault boundary in collection (see
    collect_group_trajectories) and — unless an explicit
    ``update_guard`` is passed — a fresh UpdateGuard vetoing NaN/Inf
    updates for this round. Loops spanning many rounds should build ONE
    resilience.UpdateGuard (UpdateGuard.from_config) and pass it in, so
    the loss-spike baseline accumulates across rounds. ``round_idx``
    tags FailedEpisode records and the chaos harness's injection
    coordinates.

    ``health_mitigator`` (resilience.HealthMitigator, one per run like
    the guard) lets persistent training-health triggers reshape the
    round's EFFECTIVE GRPOConfig (leave-one-out / token-level credit)
    under streak hysteresis; without one the diagnostics still run and
    publish, they just never change the objective.

    The params and Adam moments update in place, so a guard's veto is
    checked before the optimizer runs (``trainer.train_step_guarded``):
    a vetoed epoch leaves them, and ``state.step``, untouched. The
    ``engine`` (when shared for observability) serves those same tensors;
    ``engine.update_params(result.state.params)`` is the round's publish.

    On a ``mesh`` every rank of it calls ``grpo_round`` alike: the rank at
    the mesh's origin collects (its sessions drive its engine), the
    collection is broadcast, and every rank builds the batch, keeps its
    part (``data.place_batch_for_mesh``) and trains; the result's state
    holds each rank's shards (``parallel.gather_params`` rebuilds the full
    weights for a publish)."""
    if ppo_epochs < 1:
        raise ValueError(f"ppo_epochs must be >= 1, got {ppo_epochs}")
    if update_guard is None and resilience is not None:
        from ..resilience.guard import UpdateGuard
        update_guard = UpdateGuard.from_config(resilience)

    from ..services.perf_monitor import profile_capture
    with profile_capture(profile_dir), \
            get_tracer().span("grpo_round", tasks=len(tasks),
                              group_size=group_size):
        return _grpo_round_impl(
            state, model_config, mesh, make_session, tasks,
            accum_steps=accum_steps, ppo_epochs=ppo_epochs,
            group_size=group_size, pad_id=pad_id, max_len=max_len,
            grpo_config=grpo_config, reward_override=reward_override,
            max_parallel=max_parallel, metrics_service=metrics_service,
            perf_monitor=perf_monitor, engine=engine, lora_base=lora_base,
            ref_params=ref_params, resilience=resilience,
            update_guard=update_guard, health_mitigator=health_mitigator,
            round_idx=round_idx, behavior_stamp=behavior_stamp,
            planner=planner)


def _grpo_round_impl(state, model_config, mesh, make_session, tasks, *,
                     group_size, pad_id, max_len, grpo_config,
                     reward_override, max_parallel, accum_steps=1,
                     ppo_epochs=1, metrics_service=None,
                     perf_monitor=None, engine=None,
                     lora_base=None, ref_params=None, resilience=None,
                     update_guard=None, health_mitigator=None,
                     round_idx=0, behavior_stamp=None,
                     planner=None) -> RoundResult:
    import time as _time
    tracer = get_tracer()
    t0 = _time.monotonic()
    with tracer.span("collect", tasks=len(tasks), group_size=group_size):
        collected = None
        if is_lead_rank(mesh):
            collected = collect_group_trajectories(
                make_session, tasks, group_size=group_size,
                reward_override=reward_override, max_parallel=max_parallel,
                resilience=resilience, round_idx=round_idx,
                planner=planner)
        if mesh is not None:
            from ..parallel.comm import broadcast_object
            collected = broadcast_object(collected, mesh, mesh.axis_names)
    trajectories, episodes = collected.trajectories, collected.episodes
    if behavior_stamp is not None:
        # Lockstep sampling: every episode in the round was collected
        # under ONE (epoch, version) pair — the publisher never swaps
        # weights mid-round — so the caller's stamp applies uniformly.
        b_epoch, b_version = int(behavior_stamp[0]), int(behavior_stamp[1])
        for ep in episodes:
            ep.behavior_epoch = b_epoch
            ep.behavior_version = b_version
    failures = collected.failures
    dropped_groups = collected.dropped_groups
    collect_s = _time.monotonic() - t0
    if perf_monitor is not None:
        perf_monitor.record_ms("rollout_collect", collect_s * 1000.0,
                               episodes=len(episodes))
    if not trajectories:
        # Bottom rung of the degradation ladder: nothing survived
        # collection — keep the state, skip the update, leave a trail.
        if resilience is not None and (failures or dropped_groups):
            get_registry().counter(
                "senweaver_grpo_rounds_skipped_total",
                "Rounds skipped after losing every task group").inc()
        if metrics_service is not None:
            metrics_service.capture("GRPO Round Empty",
                                    {"tasks": len(tasks),
                                     "failed_episodes": len(failures),
                                     "groups_dropped": len(dropped_groups),
                                     "collect_s": round(collect_s, 3)})
        return RoundResult(state=state, metrics={}, episodes=episodes,
                           trajectories=[], failures=failures,
                           dropped_groups=dropped_groups)
    t_b = _time.monotonic()
    with tracer.span("batch_build", trajectories=len(trajectories)):
        tokens, mask, rewards, group_ids = make_batch(
            trajectories, pad_id=pad_id, max_len=max_len)
        if perf_monitor is not None:
            perf_monitor.record_ms("batch_build",
                                   (_time.monotonic() - t_b) * 1000.0,
                                   batch=len(trajectories))
        # Recorded behavior logps align on the UNPADDED batch (padding
        # appends rows/columns, leaving existing positions fixed).
        old_logp = make_batch_logps(trajectories, tokens, mask)
        branch_np = make_branch_mask(trajectories, tokens, mask)
        # Training-health diagnostics: LAUNCH the head on the params'
        # device from the HOST arrays before placement (it runs while the
        # batch is placed); the single device→host copy happens below,
        # outside the build span. Group ids are task indices and may be
        # non-contiguous after group drops — densify for segment ops.
        import numpy as _np
        from .diagnostics import (DiagnosticsConfig, dispatch_round_health,
                                  finalize_round_health)
        device = _params_device(state.params)
        diag_cfg = DiagnosticsConfig.from_grpo(
            health_mitigator.effective(grpo_config)
            if health_mitigator is not None else grpo_config)
        _uniq, _codes = _np.unique(_np.asarray(group_ids),
                                   return_inverse=True)
        health_dev = dispatch_round_health(
            rewards, _codes, mask, num_groups=max(len(_uniq), 1),
            config=diag_cfg, device=device)
        tokens, mask, rewards, group_ids, old_logp = place_batch_for_mesh(
            mesh, tokens, mask, rewards, group_ids, old_logp,
            pad_id=pad_id, accum_steps=accum_steps, device=device)
        branch_mask = None
        if branch_np is not None and mesh is not None:
            import torch as _torch
            from .data import local_block
            full_rows = (int(tokens.shape[0]) * mesh.axis_size(("dp",
                                                                "fsdp")))
            sp = mesh.axis_size("sp")
            full_cols = (int(tokens.shape[1]) - 1) * sp + 1
            branch_np = _np.pad(
                branch_np,
                ((0, full_rows - branch_np.shape[0]),
                 (0, full_cols - branch_np.shape[1])))
            branch_mask = _torch.from_numpy(local_block(
                mesh, branch_np, accum_steps)).to(tokens.device)
        elif branch_np is not None:
            # Tree-planner batches: pad the host branch mask to the
            # placed grid (appended rows/columns are outside the
            # completion mask, never read) and move it beside tokens.
            import torch as _torch
            branch_np = _np.pad(
                branch_np,
                ((0, int(tokens.shape[0]) - branch_np.shape[0]),
                 (0, int(tokens.shape[1]) - branch_np.shape[1])))
            branch_mask = _torch.from_numpy(branch_np).to(tokens.device)
    batch_build_s = _time.monotonic() - t_b
    # The round's ONE health sync, then the pre-step detector pass; a
    # persistent trigger streak may reshape this round's objective
    # (leave-one-out / token-level credit) — every transition or veto
    # becomes a round event and a labeled counter.
    from ..obs.training_health import evaluate_health, get_health_monitor
    health = finalize_round_health(health_dev)
    health["groups"] = float(len(_uniq))
    # Tree-planner lineage reaches the diagnostics surface here: the
    # planner's shape summary rides the round health dict (tree_* keys)
    # next to the advantage/credit detectors it informs.
    for k, v in collected.branch_stats.items():
        health[f"tree_{k}"] = float(v)
    monitor = get_health_monitor()
    pre_triggers = evaluate_health(health, monitor.config)
    health_events: List[str] = []
    if health_mitigator is not None:
        grpo_config, health_events = health_mitigator.apply(
            grpo_config, pre_triggers)
    # Multi-epoch (PPO-style) updates need the BEHAVIOR policy's logps
    # frozen across epochs — the clipped ratio is what bounds the drift.
    # Recorded sample-time logps are already exactly that; without them,
    # one extra forward under the pre-update params captures them
    # (timed separately so 'train_step' stays a pure update metric).
    if ppo_epochs > 1 and old_logp is None:
        from .async_loop import behavior_logp_batched
        t_b = _time.monotonic()
        with tracer.span("behavior_logp"):
            logp_params = state.params
            if lora_base is not None:
                from .lora import merge_lora
                logp_params = merge_lora(lora_base, state.params)
            old_logp = behavior_logp_batched(logp_params, model_config,
                                             tokens, accum_steps, mesh=mesh)
        if perf_monitor is not None:
            perf_monitor.record_ms("behavior_logp",
                                   (_time.monotonic() - t_b) * 1000.0)
    old = old_logp
    # Anchored training: a frozen REFERENCE policy (e.g. a rolling
    # snapshot of the serving params a few rounds back) supplies
    # ref_logp for the k3 KL term — the stabilizer against the observed
    # conditioning collapse under long unanchored runs
    # (ROUND3_NOTES.md §23). ref_params must be a FULL policy tree
    # (callers using LoRA pass the materialized/merged view).
    ref = None
    if ref_params is not None and grpo_config.kl_coef > 0.0:
        from .async_loop import behavior_logp_batched
        t_r = _time.monotonic()
        with tracer.span("ref_logp"):
            ref = behavior_logp_batched(ref_params, model_config, tokens,
                                        accum_steps, mesh=mesh)
        if perf_monitor is not None:
            perf_monitor.record_ms("ref_logp",
                                   (_time.monotonic() - t_r) * 1000.0)
    t1 = _time.monotonic()
    update_skipped: Optional[str] = None
    with tracer.span("train_step", epochs=ppo_epochs,
                     batch_tokens=int(tokens.numel())):
        for _ in range(ppo_epochs):
            # Guarded adoption: the gradients' metrics sync to host floats
            # (which also forces device completion, so the span/timer
            # close on the finished update) and the guard may veto the
            # step BEFORE the optimizer writes — a NaN gradient never
            # reaches the params or the moments, and further epochs on a
            # vetoed batch are pointless.
            state, out_metrics, update_skipped = train_step_guarded(
                state, model_config, mesh, tokens, mask, rewards,
                group_ids, guard=update_guard, old_logp=old, ref_logp=ref,
                branch_mask=branch_mask,
                grpo_config=grpo_config, accum_steps=accum_steps,
                lora_base=lora_base)
            if update_skipped is not None:
                break
    train_s = _time.monotonic() - t1
    if perf_monitor is not None:
        perf_monitor.record_ms("train_step", train_s * 1000.0,
                               epochs=ppo_epochs)
    # Fold the step's own health signals into the round's dict (finite
    # values only — a vetoed NaN step is already represented by the
    # guard veto event and the nonfinite trigger), then run the FULL
    # detector pass. Post-step-only triggers can't gate this round's
    # objective — they seed the mitigator's next-round streaks.
    import math as _math
    for src, dst in (("grad_sparsity", "grad_sparsity"),
                     ("entropy", "policy_entropy"),
                     ("kl", "kl_to_anchor")):
        v = out_metrics.get(src)
        if v is not None and _math.isfinite(v):
            health[dst] = float(v)
    health_triggers = evaluate_health(health, monitor.config)
    if health_mitigator is not None:
        health_mitigator.note_post_step(
            [t for t in health_triggers if t not in pre_triggers])
    if update_skipped is not None:
        health_events.append(f"update_skipped:{update_skipped}")
    adv_stats = {
        "zero_advantage_group_fraction":
            health.get("zero_advantage_group_fraction", 0.0),
        "advantage_std": health.get("advantage_std", 0.0),
        "groups": int(health.get("groups", 0.0)),
    }
    # Round telemetry (tokens/sec, step-time breakdown, analytic MFU):
    # always-on — a handful of registry writes per round keeps the
    # dashboard's obs tile and /metrics live without span tracing.
    from ..models.transformer import count_params
    telemetry = StepTelemetry(
        get_registry(), param_count=count_params(state.params))
    telemetry_out = telemetry.record_round(
        collect_s=collect_s, batch_build_s=batch_build_s, train_s=train_s,
        batch_tokens=int(tokens.numel()),
        completion_tokens=sum(len(t.completion_ids)
                              for t in trajectories),
        episodes=len(episodes), trajectories=len(trajectories),
        ppo_epochs=ppo_epochs, advantage_stats=adv_stats,
        health=health, health_triggers=health_triggers,
        health_events=health_events, round_index=round_idx)
    if metrics_service is not None:
        ep_rewards = [e.reward for e in episodes]
        # Engine serving counters (reuse efficiency) belong in the round
        # record when the caller shares its engine for observability.
        engine_stats = ({f"engine_{k}": v for k, v in engine.stats().items()}
                        if engine is not None and hasattr(engine, "stats")
                        else {})
        metrics_service.capture("GRPO Round Done", {
            "tasks": len(tasks), "group_size": group_size,
            **engine_stats,
            "episodes": len(episodes),
            "trajectories": len(trajectories),
            "failed_episodes": len(failures),
            "episode_retries": collected.retries,
            "groups_dropped": len(dropped_groups),
            "update_skipped": update_skipped or "",
            "batch_tokens": int(tokens.numel()),
            "reward_mean": sum(ep_rewards) / len(ep_rewards),
            "reward_min": min(ep_rewards), "reward_max": max(ep_rewards),
            "collect_s": round(collect_s, 3),
            "train_s": round(train_s, 3),
            "health_triggers": ",".join(health_triggers),
            "health_events": ",".join(health_events),
            **{k: round(float(v), 3) for k, v in telemetry_out.items()
               if isinstance(v, (int, float))},
            **{k: round(v, 6) for k, v in out_metrics.items()},
        })
    return RoundResult(
        state=state, metrics=out_metrics,
        episodes=episodes, trajectories=trajectories,
        failures=failures, dropped_groups=dropped_groups,
        update_skipped=update_skipped, health=health,
        health_triggers=health_triggers, health_events=health_events)
