"""The full online-improvement cycle: prompt search AND weight updates.

This is the reference's auto-improvement premise assembled end to end —
``apoService.ts`` ``_tryAutoAnalyze`` (:454-472) watches the trace
corpus and, when its gates open, analyzes, requests a textual gradient,
and beam-searches a better prompt; the TPU build ADDS the north-star
upgrade alongside it: every round of collected episodes also takes a
GRPO weight step and publishes the new params to the serving engine. One
loop, both optimizers:

    round N:
      1. collect a GRPO group of episodes per task, with the CURRENT
         optimized rules injected into every session's system prompt
         (segments.get_optimized_rules — the applied-prompt state the
         reference renders into its system message)
      2. judge each episode with the outcome evaluator and record the
         feedback on its trace (the corpus signal both optimizers gate
         on: user-feedback reward dim + APO analysis thresholds)
      3. GRPO update on the episodes' real sampled tokens; publish the
         new weights to the engine (next round samples the new policy)
      4. APO side: maybe_auto_analyze() (time/size gates); when the
         corpus shows a low good-rate, run the prompt beam search —
         next round's sessions inherit the winning rules

The loop owns nothing heavy: caller supplies the session factory (which
must accept ``rules=[...]``), the shared collector, the engine, and the
train state — the same contract as ``runtime/jobs.py`` factories.

PyTorch port. The trainer updates params and Adam moments IN PLACE, so
the KL anchor is a snapshot taken by copying (a clone at construction,
a ``copy_`` into the same tensors at each refresh); holding a reference,
as the JAX loop may with its immutable arrays, would make the anchor
follow every update and the k3-KL term read 0. The anchor is saved beside
the train state as ``anchor.safetensors`` (names in sorted key order,
through the port's codec).

On a mesh every rank runs the loop alike: the lead rank (the mesh's
origin) collects against its engine, every rank trains on its shards,
the params are gathered each round and the lead rank publishes them
(``grpo_round``; pass the engine on the lead rank). Each rank
checkpoints its own shards: give every rank a ``checkpoint_manager`` of
its own root.
Beyond the JAX signature, ``accum_steps`` (default 1, as the JAX loop
runs) is passed to every ``grpo_round``: at full width one card holds a
round's update only in microbatches.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence

from ..apo.eval import outcome_feedback
from ..apo.service import APOService
from ..obs import get_registry, get_tracer
from ..resilience.faults import ResilienceConfig
from ..resilience.guard import HealthMitigator, UpdateGuard
from ..traces.collector import TraceCollector
from .checkpoint import read_params_like
from .grpo import GRPOConfig
from .lora import split_lora
from .rl_loop import GroupSizeScheduler, grpo_round
from .trainer import clone_params, flatten_params

ANCHOR_FILE = "anchor.safetensors"

# Loop-id source (see OnlineImprovementLoop._loop_id): a process-unique
# tag + counter. The tag matters for WAL-persisted collectors — feedback
# keys f"{thread_id}:{message_idx}" survive restarts, and a bare counter
# restarting at 1 would overwrite a previous process's verdicts.
import uuid

_PROC_TAG = uuid.uuid4().hex[:6]
_LOOP_IDS = itertools.count(1)


class _SessionCounter:
    """Atomic, snapshotable session-id source.

    itertools.count gives the atomicity concurrent session creation
    needs but can't report its position — which checkpoint/resume does:
    a resumed loop's thread ids must keep advancing from the persisted
    cursor, not restart at 1 and collide with the killed process's WAL
    feedback keys."""

    def __init__(self, start: int = 1):
        self._lock = threading.Lock()
        self._next = int(start)                 # guarded-by: _lock

    def __next__(self) -> int:
        with self._lock:
            v = self._next
            self._next += 1
            return v

    def peek(self) -> int:
        """The id the NEXT __next__ will hand out (the resume cursor)."""
        with self._lock:
            return self._next


def _copy_into(dst, src) -> None:
    """``dst`` takes ``src``'s values, tensor by tensor, in place."""
    for (_, d), (_, s) in zip(flatten_params(dst), flatten_params(src)):
        d.copy_(s)


@dataclasses.dataclass
class OnlineRoundResult:
    round_idx: int
    reward_mean: float
    episodes: int
    rules: List[str]            # rules ACTIVE during this round
    analyzed: bool              # APO analysis ran this round
    beam_ran: bool              # prompt search ran this round
    train_metrics: Dict[str, float]
    # Resilience surface (defaults when the loop runs unguarded):
    failed_episodes: int = 0    # episodes quarantined this round
    update_skipped: Optional[str] = None  # guard veto reason, if any
    checkpointed: bool = False  # a checkpoint landed after this round
    # Training-health surface (empty for rounds with no batch):
    health: Dict[str, float] = dataclasses.field(default_factory=dict)
    health_triggers: List[str] = dataclasses.field(default_factory=list)
    health_events: List[str] = dataclasses.field(default_factory=list)
    group_size: int = 0         # group size the NEXT round will collect


class OnlineImprovementLoop:
    """Couples grpo_round with the APO auto-analysis cycle."""

    def __init__(self, state, model_config, mesh,
                 make_session: Callable[..., "RolloutSession"],
                 tasks: Sequence[str], *,
                 apo: APOService,
                 collector: TraceCollector,
                 engine=None,
                 group_size: int = 4,
                 pad_id: int = 0,
                 max_len: Optional[int] = None,
                 grpo_config: GRPOConfig = GRPOConfig(),
                 ppo_epochs: int = 1,
                 max_parallel: int = 8,
                 reward_override=None,
                 feedback_fn=outcome_feedback,
                 metrics_service=None,
                 anchor_every: int = 0,
                 analyze_every: Optional[int] = None,
                 resilience: Optional[ResilienceConfig] = None,
                 checkpoint_manager=None,
                 checkpoint_every: int = 1,
                 tenant_id: Optional[str] = None,
                 experience_sink=None,
                 accum_steps: int = 1):
        from .trainer import check_mesh
        check_mesh(mesh)
        self.state = state
        self.model_config = model_config
        self.mesh = mesh
        self.make_session = make_session
        self.tasks = list(tasks)
        self.apo = apo
        self.collector = collector
        self.engine = engine
        self.group_size = group_size
        self.pad_id = pad_id
        self.max_len = max_len
        self.grpo_config = grpo_config
        self.ppo_epochs = ppo_epochs
        self.accum_steps = accum_steps
        self.max_parallel = max_parallel
        self.reward_override = reward_override
        self.feedback_fn = feedback_fn
        self.metrics_service = metrics_service
        # Round-based analysis cadence: the reference's auto-analysis is
        # a RECURRING timer (apoService.ts:435-472, hourly); this loop
        # drives rounds, so the natural translation is "every N rounds".
        # None = every round (the service's own time/size gates still
        # apply either way — this only throttles how often they are
        # consulted).
        self.analyze_every = analyze_every
        # anchor_every > 0 (with grpo_config.kl_coef > 0): keep a
        # rolling snapshot of the policy as the k3-KL reference,
        # refreshed every anchor_every rounds — the drift stabilizer
        # proven by the contextual runs (ROUND3_NOTES.md §24). A copy:
        # the trainer writes state.params in place.
        self.anchor_every = anchor_every
        self._anchor = (clone_params(state.params)
                        if anchor_every > 0 and grpo_config.kl_coef > 0
                        else None)
        # Resilience: the fault boundary config rides into every
        # grpo_round; ONE UpdateGuard spans the loop so the loss-spike
        # baseline accumulates across rounds instead of resetting.
        self.resilience = resilience
        self._update_guard = (UpdateGuard.from_config(resilience)
                              if resilience is not None else None)
        # Training-health mitigations: ONE mitigator spans the loop
        # (streak hysteresis is cross-round state, like the guard's
        # spike baseline). Even with health_mitigations=False it runs —
        # triggers are then counted as vetoes instead of applied. The
        # group-size scheduler only engages when its sub-gate is on.
        self._health_mitigator = (HealthMitigator.from_config(resilience)
                                  if resilience is not None else None)
        self._group_scheduler = (
            GroupSizeScheduler.from_config(resilience, group_size)
            if resilience is not None and resilience.mitigate_group_size
            else None)
        # Preemption safety: with a CheckpointManager, the loop persists
        # its full resume surface (train state + round index + session
        # cursor + optimized rules + KL anchor) every
        # ``checkpoint_every`` rounds; OnlineImprovementLoop.resume()
        # restores the exact round.
        self.checkpoint_manager = checkpoint_manager
        self.checkpoint_every = checkpoint_every
        # Per-tenant mode: the round trains ADAPTER deltas only (the
        # caller sets up lora_base training so state.params is the
        # adapter tree) and each round republishes through the no-drain
        # publish_adapter path instead of the rolling base publish —
        # one tenant's training loop never pauses the others' decodes.
        self.tenant_id = tenant_id
        # Streaming async mode: when set, every round ALSO streams its
        # collected episodes — stamped with the (epoch, version) that
        # sampled them — into an experience sink (an
        # ExperienceClient.submit or ExperienceQueue.offer_many duck),
        # making this loop a collector for a streaming learner
        # (serve/learner.py StreamingLearnerService) instead of the
        # only trainer. Offers are fire-and-forget per round; the
        # sink's idempotent episode ids make resubmits safe.
        self.experience_sink = experience_sink
        self._round = 0
        # Last weight version a versioned engine (ServingFleet) acked
        # for this loop's params; persisted so resume() can republish AT
        # that version instead of letting a fresh publisher restart at 1
        # (which would make the skew gauge and the round↔version metric
        # trail lie after a restart).
        self._published_version: Optional[int] = None
        # Atomic id source: sessions are created from the collection
        # pool's worker threads (a racy += would hand two episodes the
        # same thread_id and cross-attribute their traces). The loop
        # instance id keeps thread ids unique ACROSS loops sharing one
        # collector — two successive 'online' jobs must not collide on
        # f"{thread_id}:{message_idx}" feedback keys.
        self._loop_id = next(_LOOP_IDS)
        self._session_ids = _SessionCounter(1)
        # Factories that can't take thread_id force serial collection:
        # concurrent sessions sharing the collector's default thread id
        # would read each other's traces.
        import inspect
        try:
            sig = inspect.signature(make_session)
            self._factory_takes_thread_id = (
                "thread_id" in sig.parameters
                or any(p.kind is inspect.Parameter.VAR_KEYWORD
                       for p in sig.parameters.values()))
        except (TypeError, ValueError):
            self._factory_takes_thread_id = False
        if not self._factory_takes_thread_id and max_parallel > 1:
            raise ValueError(
                "session factory does not accept thread_id=; concurrent "
                "collection (max_parallel > 1) would cross-attribute "
                "episode traces — extend the factory or pass "
                "max_parallel=1")
        # feedback_fn may take (trace) — the reference's outcome shape —
        # or (trace, session) for judges that need the episode's sampled
        # token ids (EnginePolicyClient.call_log), e.g. real-policy
        # output-style evaluators.
        self._feedback_takes_session = False
        if feedback_fn is not None:
            try:
                sig = inspect.signature(feedback_fn)
                self._feedback_takes_session = len([
                    p for p in sig.parameters.values()
                    if p.kind in (p.POSITIONAL_ONLY,
                                  p.POSITIONAL_OR_KEYWORD)]) >= 2
            except (TypeError, ValueError):
                pass

    def current_rules(self) -> List[str]:
        return self.apo.get_optimized_rules()

    def _fresh_session(self, rules: List[str]):
        """Factory call with a UNIQUE thread id — episodes share one
        collector, so per-thread trace attribution needs distinct ids.
        (Factories without thread_id support were rejected at
        construction unless collection is serial.)"""
        if not self._factory_takes_thread_id:
            return self.make_session(rules=list(rules))
        tid = (f"online-{_PROC_TAG}-{self._loop_id}-r{self._round}"
               f"-s{next(self._session_ids)}")
        return self.make_session(rules=list(rules), thread_id=tid)

    def run_round(self) -> OnlineRoundResult:
        with get_tracer().span("online.round", round=self._round):
            return self._run_round_impl()

    def _stream_episodes(self, out) -> None:
        """Async-mode side channel: offer the round's episodes to the
        experience sink, stamped with the behavior version that sampled
        them. Sink failures never fail the round — the deterministic
        episode ids make the next round's resubmit a safe dedup."""
        from .experience import trajectories_to_episodes
        episodes = trajectories_to_episodes(
            out.trajectories, epoch=0,
            version=self._published_version or 0,
            source=f"online-{_PROC_TAG}-{self._loop_id}",
            round_idx=self._round)
        sink = self.experience_sink
        try:
            submit = getattr(sink, "submit", None)
            if submit is not None:             # ExperienceClient duck
                submit(episodes)
            else:                              # ExperienceQueue duck
                sink.offer_many(
                    episodes,
                    current_version=self._published_version or 0)
        except Exception:
            get_registry().counter(
                "senweaver_online_stream_offer_failures_total",
                "Rounds whose episode stream offer failed (episodes "
                "stay local; deterministic ids make the resubmit a "
                "dedup).").inc()

    def _run_round_impl(self) -> OnlineRoundResult:
        rules = self.current_rules()

        def reward(ti, g, session):
            # Judge the episode and RECORD the verdict on its trace —
            # the feedback signal the reward head weights highest and
            # the APO gates count. The trace reward (now including the
            # feedback dim) or the caller's override scores the episode.
            trace = self.collector.get_active_trace(session.thread_id)
            if self.feedback_fn is not None and trace is not None:
                fb = (self.feedback_fn(trace, session)
                      if self._feedback_takes_session
                      else self.feedback_fn(trace))
                if fb:
                    session.record_feedback(fb)
            if self.reward_override is not None:
                return self.reward_override(ti, g, session)
            return (trace.summary.final_reward or 0.0) \
                if trace is not None else 0.0

        out = grpo_round(
            self.state, self.model_config, self.mesh,
            lambda: self._fresh_session(rules), self.tasks,
            group_size=self.group_size, pad_id=self.pad_id,
            max_len=self.max_len, grpo_config=self.grpo_config,
            ppo_epochs=self.ppo_epochs, max_parallel=self.max_parallel,
            accum_steps=self.accum_steps, reward_override=reward,
            metrics_service=self.metrics_service, engine=self.engine,
            ref_params=self._anchor, resilience=self.resilience,
            update_guard=self._update_guard,
            health_mitigator=self._health_mitigator,
            round_idx=self._round,
            behavior_stamp=(0, self._published_version or 0))
        self.state = out.state
        if self.experience_sink is not None and out.trajectories:
            self._stream_episodes(out)
        # Group-size mitigation tick: resize for the NEXT round while
        # its trigger streak is active; changes become round events.
        health_events = list(out.health_events)
        if (self._group_scheduler is not None
                and self._health_mitigator is not None):
            self.group_size, gs_events = self._group_scheduler.update(
                self._health_mitigator.group_size_active())
            health_events.extend(gs_events)
            if gs_events and self.metrics_service is not None:
                self.metrics_service.capture("Group Size Rescheduled", {
                    "round": self._round, "group_size": self.group_size,
                    "events": ",".join(gs_events),
                })
        if (self._anchor is not None and self.anchor_every > 0
                and (self._round + 1) % self.anchor_every == 0):
            _copy_into(self._anchor, self.state.params)
        if self.tenant_id is not None and self.engine is not None \
                and hasattr(self.engine, "publish_adapter"):
            # Tenant rounds publish ONLY the adapter leaves (state.params
            # is the adapter tree under lora_base training; a merged
            # tree is split the same way) at the tenant's next monotonic
            # adapter_version. In-flight requests keep their bound slot;
            # the tenant's next request uploads the new version.
            _, lora = split_lora(self.state.params)
            if not lora["layers"]:
                raise ValueError(
                    "tenant_id is set but state.params has no *_lora_* "
                    "leaves — per-tenant rounds train adapter deltas "
                    "(init_lora + lora_base training), not base weights")
            with get_tracer().span("online.publish_adapter",
                                   tenant=self.tenant_id):
                published = self.engine.publish_adapter(
                    self.tenant_id, lora)
            if isinstance(published, int):
                self._published_version = published
                if self.metrics_service is not None:
                    self.metrics_service.capture("Adapter Published", {
                        "round": self._round,
                        "tenant_id": self.tenant_id,
                        "adapter_version": published,
                    })
            if hasattr(self.engine, "record_snapshot"):
                self.engine.record_snapshot()
        elif self.mesh is not None or (
                self.engine is not None
                and hasattr(self.engine, "update_params")):
            full = _full_params(self.state.params, self.mesh)
            published = None
            if self.engine is not None and hasattr(self.engine,
                                                   "update_params"):
                with get_tracer().span("online.publish_params"):
                    published = self.engine.update_params(full)
            # A ServingFleet publish is VERSIONED (rolling drain→swap
            # across replicas via serve.WeightPublisher); a bare engine
            # returns None. Record the version + serving state so the
            # metrics trail ties each training round to the weight
            # version its next round samples from.
            if isinstance(published, int):
                self._published_version = published
                if self.metrics_service is not None:
                    self.metrics_service.capture("Weights Published", {
                        "round": self._round,
                        "weight_version": published,
                    })
            if hasattr(self.engine, "record_snapshot"):
                self.engine.record_snapshot()

        # APO side of the cycle (the reference's timer tick, driven at
        # round boundaries here): analysis when gates open; prompt beam
        # search when the corpus shows a low good-rate.
        due = (self.analyze_every is None
               or self._round % self.analyze_every == 0)
        with get_tracer().span("online.apo", due=due):
            report = self.apo.maybe_auto_analyze() if due else None
            beam_ran = False
            if report is not None and self.apo.should_auto_gradient() \
                    and self.apo.generate_fn is not None:
                self.apo.run_beam_search()
                beam_ran = True

        ep_rewards = [e.reward for e in out.episodes]
        result = OnlineRoundResult(
            round_idx=self._round,
            reward_mean=(sum(ep_rewards) / len(ep_rewards)
                         if ep_rewards else 0.0),
            episodes=len(out.episodes),
            rules=rules,
            analyzed=report is not None,
            beam_ran=beam_ran,
            train_metrics=dict(out.metrics),
            failed_episodes=len(out.failures),
            update_skipped=out.update_skipped,
            health=dict(out.health),
            health_triggers=list(out.health_triggers),
            health_events=health_events,
            group_size=self.group_size)
        self._round += 1
        if (self.checkpoint_manager is not None and self.checkpoint_every
                and self._round % self.checkpoint_every == 0):
            with get_tracer().span("online.checkpoint",
                                   round=self._round):
                self.checkpoint()
            result.checkpointed = True
        return result

    def run(self, rounds: int) -> List[OnlineRoundResult]:
        return [self.run_round() for _ in range(rounds)]

    # -- preemption-safe persistence ---------------------------------------
    def checkpoint(self) -> str:
        """Persist the loop's full resume surface and return the step dir.

        Beyond the train state, deterministic continuation needs the
        loop-level cursors: the round index (rewards/faults keyed on
        round coordinates), the session-id cursor (WAL feedback keys
        must not collide), the ACTIVE optimized rules (a resumed round
        must render the same system prompt), and the KL anchor params
        (saved as ``anchor.safetensors`` beside the state; if a preemption
        lands between meta.json and the anchor file, resume() re-anchors
        at the restored params — a refresh, not a corruption)."""
        if self.checkpoint_manager is None:
            raise ValueError("loop was built without a checkpoint_manager")
        step_dir = self.checkpoint_manager.save(self.state, extra_meta={
            "online_round": self._round,
            "online_session_cursor": self._session_ids.peek(),
            "online_rules": self.current_rules(),
            "online_anchor": self._anchor is not None,
            "online_weight_version": self._published_version,
        })
        if self._anchor is not None:
            from ..models.safetensors_io import save_file
            # written to a .tmp name, then renamed into place
            save_file(dict(flatten_params(self._anchor)),
                      os.path.join(step_dir, ANCHOR_FILE))
        return step_dir

    @classmethod
    def resume(cls, checkpoint_manager, state_template, model_config,
               mesh, make_session: Callable[..., "RolloutSession"],
               tasks: Sequence[str], *, step: Optional[int] = None,
               **kwargs: Any) -> "OnlineImprovementLoop":
        """Reconstruct a loop at the exact round a checkpoint captured.

        ``state_template`` is a TrainState with matching structure
        (shapes/dtypes/optimizer) for CheckpointManager.restore;
        ``kwargs`` are the remaining constructor arguments (apo,
        collector, engine, resilience, ...) — pass the same values the
        killed process used, with the apo service backed by the SAME
        segment-store path or any path (the persisted rule-set is
        reinstalled either way). Restores: train state, round index,
        session-id cursor, optimized rules, and the KL anchor; then
        republishes the restored params to the engine so serving
        matches training from the first resumed episode."""
        state, meta = checkpoint_manager.restore(state_template, step)
        loop = cls(state, model_config, mesh, make_session, tasks,
                   checkpoint_manager=checkpoint_manager, **kwargs)
        loop._round = int(meta.get("online_round", 0))
        loop._session_ids = _SessionCounter(
            int(meta.get("online_session_cursor", 1)))
        rules = meta.get("online_rules")
        if rules is not None:
            loop.apo.segments.install_rules(list(rules))
        if loop._anchor is not None:
            anchor_path = os.path.join(checkpoint_manager.root,
                                       f"step_{meta['step']}",
                                       ANCHOR_FILE)
            if meta.get("online_anchor") and os.path.exists(anchor_path):
                from ..models.safetensors_io import SafetensorsReader
                # into the constructor's copy, tensor by tensor: no
                # second anchor is held
                with SafetensorsReader([anchor_path]) as reader:
                    read_params_like(reader, loop._anchor, into=True)
            # else: the constructor's anchor is a copy of the restored
            # params (the re-anchor)
        full = _full_params(state.params, mesh)
        if loop.engine is not None and hasattr(loop.engine,
                                               "update_params"):
            saved_version = meta.get("online_weight_version")
            published = _republish(loop.engine, full, saved_version)
            if isinstance(published, int):
                loop._published_version = published
        return loop


def _full_params(params, mesh):
    """The full weights of this rank's shards on a mesh (every rank of it
    calls this), the params themselves without one."""
    if mesh is None:
        return params
    from ..parallel.sharding import gather_params
    return gather_params(params, mesh)


def _republish(engine, params, saved_version: Optional[int]):
    """Republish restored params, stamping the checkpointed weight
    version onto versioned engines (ServingFleet).

    Without the stamp a restarted fleet would hand out version 1 for
    weights that are really round-N's, so the version-skew gauge and the
    round↔version metric trail would lie after every resume. Only pass
    the version when it actually advances the publisher — a fleet that
    survived the trainer restart already holds >= saved_version and a
    re-stamp would (correctly) be fenced as stale. The port's engine has
    no publisher and takes the plain publish."""
    publisher = getattr(engine, "publisher", None)
    if (saved_version is not None and publisher is not None
            and int(saved_version) > publisher.version):
        return engine.update_params(params, version=int(saved_version))
    return engine.update_params(params)
