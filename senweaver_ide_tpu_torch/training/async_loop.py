"""Sampler/trainer overlap: the pipelined GRPO driver (PyTorch port).

``grpo_round`` is strictly collect → train, so the card idles through
every host-side phase of collection (tool execution, agent-loop
bookkeeping) and the host idles through the train step. This driver runs
them as a two-stage pipeline (the Podracer "Sebulba" split): a collector
thread drives rollout sessions for round N+1 while the trainer's thread
trains on round N's batch. Both launch on the card's default stream, so
the device work serializes; what the pipeline buys is the host overlap.

Staleness is bounded by the queue depth (``prefetch``): a batch is at
most ``prefetch`` updates behind the params that train on it. Two
correction modes:

- ``importance_correction=True`` (default): the behavior params that
  collected each batch are held in a BOUNDED version-keyed LRU
  (:class:`~.experience.BehaviorParamsCache`) and the batch's
  ``old_logp`` is computed under them just before the update, so the
  clipped objective's importance ratio is exact. When a batch's behavior
  version has aged out, the step degrades to the ratio-1 approximation
  under the current params, counted
  (``senweaver_grpo_behavior_ratio_one_fallbacks_total``).
- ``importance_correction=False``: ``old_logp = stop_grad(current)``
  (ratio 1), the standard 1-step-stale approximation.

Weight publication: each update stages its params for ``publish_params``
(wire it to ``RolloutEngine.update_params``), and the collector applies
the latest staged set at its next ROUND BOUNDARY, never mid-round, so the
behavior snapshot is exactly what every episode of the round sampled
under. Publications coalesce (latest wins); the final update's params are
always flushed when ``run`` returns.

**In-place updates.** The port's optimizer writes params and moments in
place, where JAX's returns new arrays, so every place the JAX driver
holds a params *reference* holds a snapshot (a copy on the params'
device) here:

- the behavior cache's entries, version 0 included: a reference would
  follow every update and the importance ratio would read 1;
- a staged publish is copied when it is STAGED, since training goes on
  after it; the engine then serves that copy and the cache holds the
  same tensors (one copy per update, bounded by the cache's capacity);
- with ``publish_params``, the first round boundary publishes the
  version-0 copy, so an engine built on the trainer's own tensors stops
  serving them before the first update runs;
- without ``publish_params``, each round's behavior is a copy taken at
  the round start under the trainer's step lock, and an engine that
  serves the trainer's own tensors is refused (it would sample a
  half-updated policy while the trainer steps).

Under LoRA ``merge_lora`` is a dict union over the frozen base, so the
adapter leaves are what gets copied.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..models.transformer import forward, vocab_parallel_logprobs
from .data import make_batch, make_batch_logps, place_batch_for_mesh
from .experience import BehaviorParamsCache, BehaviorParamsEvicted
from .grpo import GRPOConfig, token_logprobs
from .rl_loop import (EpisodeRecord, collect_group_trajectories,
                      is_lead_rank)
from .trainer import (TrainState, _host_metrics, _leaves, check_mesh,
                      clone_params, train_step)


@torch.no_grad()
def _behavior_logp(params, config, tokens: torch.Tensor,
                   mesh=None) -> torch.Tensor:
    if mesh is None:
        logits = forward(params, config, tokens[:, :-1])
        return token_logprobs(logits, tokens[:, 1:])
    logits = forward(params, config, tokens[:, :-1], mesh=mesh)
    return vocab_parallel_logprobs(logits, tokens[:, 1:], mesh)


def behavior_logp_batched(params, config, tokens,
                          accum_steps: int = 1, mesh=None) -> torch.Tensor:
    """(B, S-1) log-probs of ``tokens`` (B, S) under ``params``, in the
    trainer's target layout, one microbatch at a time: a whole-batch
    forward would hold the (B, S-1, V) logits that ``accum_steps`` was
    sized to avoid. A batch not divisible by ``accum_steps`` runs whole.
    On a ``mesh``: this rank's shards, rows and chunk
    (``data.place_batch_for_mesh``), and its block of the log-probs."""
    dev = params["embed"].device
    if not isinstance(tokens, torch.Tensor):
        tokens = torch.from_numpy(np.asarray(tokens))
    tokens = tokens.to(dev, torch.long)
    b = tokens.shape[0]
    if accum_steps <= 1 or b % accum_steps != 0:
        return _behavior_logp(params, config, tokens, mesh)
    mb = b // accum_steps
    return torch.cat([_behavior_logp(params, config,
                                     tokens[i * mb:(i + 1) * mb], mesh)
                      for i in range(accum_steps)], dim=0)


@dataclass
class AsyncRoundResult:
    state: TrainState
    metrics: Dict[str, float]
    episodes: List[EpisodeRecord]
    staleness: int            # updates between collection and training
    collect_wait_s: float     # trainer time spent waiting for a batch


@dataclass
class _Collected:
    trajectories: list
    episodes: List[EpisodeRecord]
    # Version stamp only: the params themselves live in the trainer's
    # bounded BehaviorParamsCache, not on the queue item.
    behavior_version: int
    collect_s: float = field(default=0.0)


def _engine_of(session):
    client = getattr(session, "client", None)
    return getattr(client, "engine", None)


class AsyncGRPOTrainer:
    """Two-stage pipelined GRPO: collection overlaps the train step."""

    def __init__(self, state: TrainState, model_config, mesh,
                 make_session: Callable[[], "RolloutSession"],
                 tasks: Sequence[str], *,
                 group_size: int = 4,
                 pad_id: int = 0,
                 max_len: Optional[int] = None,
                 grpo_config: GRPOConfig = GRPOConfig(),
                 reward_override=None,
                 max_parallel: int = 8,
                 accum_steps: int = 1,
                 ppo_epochs: int = 1,
                 prefetch: int = 1,
                 importance_correction: bool = True,
                 behavior_cache_size: Optional[int] = None,
                 publish_params: Optional[Callable[[object], None]] = None,
                 metrics_service=None,
                 lora_base=None,
                 ref_params=None):
        check_mesh(mesh)
        self.state = state
        self.model_config = model_config
        self.mesh = mesh
        self.make_session = make_session
        self.tasks = list(tasks)
        self.group_size = group_size
        self.pad_id = pad_id
        self.max_len = max_len
        self.grpo_config = grpo_config
        self.reward_override = reward_override
        self.max_parallel = max_parallel
        self.accum_steps = accum_steps
        if ppo_epochs < 1:
            raise ValueError(f"ppo_epochs must be >= 1, got {ppo_epochs}")
        self.ppo_epochs = ppo_epochs
        self.importance_correction = importance_correction
        self.publish_params = publish_params
        self.metrics_service = metrics_service
        # LoRA: state.params are ONLY the adapters over this frozen base
        # (training/lora.py); behavior snapshots and publishes carry the
        # MATERIALIZED policy, the train step differentiates adapters.
        self.lora_base = lora_base
        # Frozen/rolling reference for the k3-KL term: a FULL policy
        # tree; swap it with set_ref_params at round boundaries.
        self.ref_params = ref_params
        self._device = _leaves(state.params)[0].device
        # On a mesh the lead rank collects and publishes; every rank
        # trains on its shards, and a publish carries gathered weights.
        self._lead = is_lead_rank(mesh)
        self._full_base = (lora_base if mesh is None or lora_base is None
                           else self._gather(lora_base))

        self._queue: "queue.Queue[_Collected]" = queue.Queue(
            maxsize=max(1, prefetch))
        # Default capacity covers the pipeline depth plus the batch
        # currently training and one staged publish.
        self.behavior_cache = BehaviorParamsCache(
            behavior_cache_size if behavior_cache_size is not None
            else max(2, prefetch) + 2)
        v0 = self._merged_view(clone_params(state.params))
        self.behavior_cache.put(0, v0)
        # Held by the trainer while it writes state.params (the update
        # and the staging copy) and by the collector while it copies
        # them: a copy never sees half an update.
        self._step_lock = threading.Lock()
        self._publish_lock = threading.Lock()
        # Staged (version, adapter-or-params copy) awaiting publication;
        # the collector applies it at round boundaries. The version-0
        # copy is staged too: the engine must stop serving the trainer's
        # own tensors before the first in-place update.
        self._pending_publish: Optional[tuple] = (
            (0, self._gather(v0) if lora_base is None else v0)
            if publish_params is not None else None)
        # the last APPLIED pair: what the serving engine runs
        self._applied_behavior: tuple = (0, v0)
        self._version = 0
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._rounds_wanted = 0
        self._thread: Optional[threading.Thread] = None

    # -- collector side ---------------------------------------------------
    def _flush_pending_publish(self) -> None:
        """Apply the latest staged publication (if any) to the engine and
        remember it as the live behavior snapshot."""
        with self._publish_lock:
            pending = self._pending_publish
            self._pending_publish = None
        if pending is not None and self.publish_params is not None:
            pending = (pending[0], self._folded_view(pending[1]))
            self.publish_params(pending[1])
            self._applied_behavior = pending
            if pending[0] not in self.behavior_cache:
                # (version 0 is cached from construction, unfolded)
                self.behavior_cache.put(pending[0], pending[1])

    def _gather(self, params):
        """The full tensors of this rank's shards (every rank calls it);
        the params themselves without a mesh."""
        if self.mesh is None:
            return params
        from ..parallel.sharding import gather_params
        return gather_params(params, self.mesh)

    def set_ref_params(self, ref_params) -> None:
        """Swap the KL anchor (rolling-anchor pattern); takes effect on
        the next train round. Pass a FULL policy tree (materialized for
        LoRA), one the trainer does not write."""
        self.ref_params = ref_params

    def _merged_view(self, params):
        """Full-policy view (dict union over the frozen base under LoRA):
        what behavior-logp recompute consumes."""
        if self.lora_base is None:
            return params
        from .lora import merge_lora
        return merge_lora(self.lora_base, params)

    def _folded_view(self, params):
        """Materialized full weights, ONLY for publication to an engine.
        The fold runs at flush time, so latest-wins coalescing never
        burns a discarded fold."""
        if self.lora_base is None:
            return params
        from .lora import materialize_lora
        return materialize_lora(self._full_base, params, self.model_config)

    def _refuse_aliasing_engine(self, session) -> None:
        """Without a publication channel an engine serving the trainer's
        own tensors would sample a half-updated policy while the trainer
        steps in place."""
        engine = _engine_of(session)
        params = getattr(engine, "params", None)
        if self.lora_base is not None or not isinstance(params, dict):
            return
        live = {t.data_ptr() for t in _leaves(self.state.params)}
        if any(t.data_ptr() in live for t in _leaves(params)):
            raise ValueError(
                "the sessions' engine serves the trainer's own params, "
                "which the trainer updates in place; pass "
                "publish_params=engine.update_params (the engine then "
                "serves copies) or build the engine on a copy")

    def _make_checked_session(self):
        session = self.make_session()
        self._refuse_aliasing_engine(session)
        return session

    def _collect_loop(self) -> None:
        produced = 0
        try:
            while not self._stop.is_set() and produced < self._rounds_wanted:
                # Apply any params published since the last round BEFORE
                # sampling starts: every episode of a round samples under
                # exactly the (version, params) recorded here.
                self._flush_pending_publish()
                if self.publish_params is not None:
                    version = self._applied_behavior[0]
                    make_session = self.make_session
                else:
                    # no publication channel: the round's behavior is a
                    # copy of the trainer's params taken between updates
                    with self._step_lock:
                        version = self._version
                        params = self._merged_view(
                            clone_params(self.state.params))
                    self.behavior_cache.put(version, params)
                    make_session = self._make_checked_session
                t0 = time.monotonic()
                trajectories, episodes = collect_group_trajectories(
                    make_session, self.tasks,
                    group_size=self.group_size,
                    reward_override=self.reward_override,
                    max_parallel=self.max_parallel)
                for ep in episodes:
                    # (epoch, version) behavior stamp: the in-process
                    # pipeline has no lease, so epoch stays 0
                    ep.behavior_version = version
                item = _Collected(trajectories, episodes, version,
                                  collect_s=time.monotonic() - t0)
                while not self._stop.is_set():
                    try:
                        self._queue.put(item, timeout=0.2)
                        produced += 1
                        break
                    except queue.Full:
                        continue
        except BaseException as e:   # surfaced by run()
            self._error = e
            self._stop.set()

    # -- trainer side -----------------------------------------------------
    def run(self, num_rounds: int) -> List[AsyncRoundResult]:
        """Train ``num_rounds`` updates with pipelined collection. On a
        mesh only the lead rank runs the collector thread; each round's
        batch reaches the other ranks by broadcast from the training
        thread, which makes every collective of the step."""
        self._rounds_wanted = num_rounds
        if self._lead:
            self._thread = threading.Thread(target=self._collect_loop,
                                            name="grpo-collector",
                                            daemon=True)
            self._thread.start()
        results: List[AsyncRoundResult] = []
        try:
            for _ in range(num_rounds):
                t_wait = time.monotonic()
                item = self._next_item() if self._lead else None
                if self.mesh is not None:
                    from ..parallel.comm import broadcast_object
                    item = broadcast_object(item, self.mesh,
                                            self.mesh.axis_names)
                if isinstance(item, BaseException):
                    raise RuntimeError("rollout collector failed") from item
                wait_s = time.monotonic() - t_wait
                results.append(self._train_on(item, wait_s))
        finally:
            self._stop.set()
            if self._thread is not None:
                self._thread.join(timeout=30)
                # Collector is down: flush the last pending publication so
                # the engine ends on the final params. If the join timed
                # out (a wedged session), the collector still owns
                # publication.
                if not self._thread.is_alive():
                    self._flush_pending_publish()
        return results

    def _next_item(self):
        """The collector's next round, or its error (a mesh forwards the
        error to every rank before raising)."""
        while True:
            if self._error is not None:
                if self.mesh is None:
                    raise RuntimeError(
                        "rollout collector failed") from self._error
                return self._error
            try:
                return self._queue.get(timeout=0.2)
            except queue.Empty:
                continue

    def _train_on(self, item: _Collected,
                  wait_s: float) -> AsyncRoundResult:
        staleness = self._version - item.behavior_version
        if not item.trajectories:
            return AsyncRoundResult(self.state, {}, item.episodes,
                                    staleness, wait_s)
        tokens, mask, rewards, group_ids = make_batch(
            item.trajectories, pad_id=self.pad_id, max_len=self.max_len)
        recorded = (make_batch_logps(item.trajectories, tokens, mask)
                    if self.importance_correction else None)
        tokens, mask, rewards, group_ids, old_logp = place_batch_for_mesh(
            self.mesh, tokens, mask, rewards, group_ids, recorded,
            pad_id=self.pad_id, accum_steps=self.accum_steps,
            device=self._device)
        if (old_logp is None
                and (self.ppo_epochs > 1
                     or (self.importance_correction and staleness > 0))):
            # Multi-epoch updates REQUIRE frozen behavior logps (epochs
            # 2+ would otherwise recompute ratio 1 against the updated
            # params), so they are computed here regardless of the
            # importance_correction flag. Microbatched like the update.
            try:
                behavior = self.behavior_cache.get(item.behavior_version)
            except BehaviorParamsEvicted:
                # the collector outran the trainer past the cache bound:
                # ratio-1 under the CURRENT params (counted)
                self.behavior_cache.note_ratio_one_fallback()
                behavior = self._merged_view(self.state.params)
            old_logp = behavior_logp_batched(behavior, self.model_config,
                                             tokens, self.accum_steps,
                                             mesh=self.mesh)

        ref_logp = None
        ref = self.ref_params     # single read: set_ref_params may swap
        if ref is not None and self.grpo_config.kl_coef > 0.0:
            ref_logp = behavior_logp_batched(ref, self.model_config,
                                             tokens, self.accum_steps,
                                             mesh=self.mesh)
        with self._step_lock:
            for _ in range(self.ppo_epochs):
                self.state, metrics = train_step(
                    self.state, self.model_config, self.mesh, tokens, mask,
                    rewards, group_ids, old_logp=old_logp,
                    ref_logp=ref_logp, grpo_config=self.grpo_config,
                    accum_steps=self.accum_steps, lora_base=self.lora_base)
            self._version += 1
            if self.publish_params is not None:
                # Staged with a copy taken NOW (training goes on writing
                # state.params); applied at the collector's next round
                # boundary, latest wins. Adapters are staged raw; the
                # fold happens at flush.
                staged = (self._version, clone_params(self.state.params))
                if self.mesh is not None:
                    # the behavior view stays on this rank's shards; the
                    # publish carries the gathered weights
                    self.behavior_cache.put(self._version,
                                            self._merged_view(staged[1]))
                    if self.lora_base is None:
                        staged = (self._version, self._gather(staged[1]))
                with self._publish_lock:
                    self._pending_publish = staged

        out = _host_metrics(metrics)
        if self.metrics_service is not None:
            ep = [e.reward for e in item.episodes]
            self.metrics_service.capture("Async GRPO Round", {
                "episodes": len(item.episodes),
                "staleness": staleness,
                "collect_s": round(item.collect_s, 3),
                "trainer_wait_s": round(wait_s, 3),
                "reward_mean": sum(ep) / max(len(ep), 1),
                **{k: round(v, 6) for k, v in out.items()},
            })
        return AsyncRoundResult(self.state, out, item.episodes,
                                staleness, wait_s)
