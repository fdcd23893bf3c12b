"""Streaming experience pipeline: episodes flow, rounds don't.

The disaggregated learner (serve/learner.py) was strictly lockstep —
collect a full round, train, publish, repeat — so the learner idled
through every host-side collection phase and replicas idled through
every train step. This module holds the training-side half of the
continuous-flow replacement (RLAX 2512.06392 / Podracer's Sebulba
split, 2104.06272): replicas stream finished episodes as they land,
the learner aggregates PARTIAL groups and steps as soon as a
staleness-bounded batch is ready, and publishes overlap collection.

Three pieces, deliberately free of any serve/ import so the rollout
plane can depend on them without a cycle:

- :class:`StreamedEpisode` — one finished episode stamped with the
  ``(epoch, version)`` of the weights that SAMPLED it. The stamp is
  what makes asynchrony correct: the learner computes importance
  ratios against the stamped behavior version, not "whatever the
  params are now".
- :class:`ExperienceQueue` — bounded, idempotent (episode ids dedup
  across RPC replays AND learner restarts), staleness-bounded (an
  episode more than ``max_staleness`` versions behind the learner is
  dropped and counted, never trained). Group-aware: episodes bucket by
  ``group_key`` and a batch is released only when enough groups are
  COMPLETE — GRPO advantages need whole groups, not whole rounds.
- :class:`BehaviorParamsCache` — a small LRU of recently published
  param versions keyed by version. Bounds the host-memory failure
  mode where a collector outrunning the trainer pinned one full
  params pytree per in-flight batch; eviction is TYPED
  (:class:`BehaviorParamsEvicted`) so callers degrade to the ratio-1
  approximation (counted) instead of crashing or growing without
  bound.

PyTorch port: the queue and the cache are the JAX package's, line for
line. The trainer updates params IN PLACE, so what enters the behaviour
cache must be a snapshot, never the live tree: a reference would follow
every update and the importance ratio would read 1. The
:class:`StreamingTrainerAdapter` clones at every ``put``.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .data import Trajectory, make_batch, make_batch_logps

# Buckets for the staleness histogram: versions-behind at train time.
STALENESS_BUCKETS = (0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0)

# offer() outcomes — the collector's ack vocabulary. "duplicate" is a
# SUCCESS for the collector (the episode is already on the learner,
# via an RPC replay or a previous incarnation); only "full" asks it to
# back off and resubmit.
ACCEPTED = "accepted"
DUPLICATE = "duplicate"
STALE = "stale"
FULL = "full"


@dataclasses.dataclass
class StreamedEpisode:
    """One finished episode, wire-friendly (plain fields only — the rpc
    codec ships it as a tagged dict). ``group_key`` buckets alternative
    completions of the same prompt for group-relative advantages;
    ``(epoch, version)`` stamp the BEHAVIOR policy that sampled it."""

    episode_id: str
    group_key: str
    prompt_ids: List[int]
    completion_ids: List[int]
    reward: float
    epoch: int
    version: int
    # Per-completion-token behavior logps captured at SAMPLE time
    # (engine result_logps). When present on every episode in a batch,
    # old_logp is assembled exactly — token-exact importance ratios
    # with no second forward pass (training/data.py make_batch_logps).
    behavior_logp: Optional[List[float]] = None
    task_idx: int = 0

    def to_wire(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_wire(cls, d: Dict[str, Any]) -> "StreamedEpisode":
        return cls(**d)


def assemble_batch(episodes: Sequence[StreamedEpisode], *, pad_id: int,
                   max_len: Optional[int] = None
                   ) -> Tuple[List[Trajectory], np.ndarray, np.ndarray,
                              np.ndarray, np.ndarray,
                              Optional[np.ndarray]]:
    """Streamed episodes → the exact arrays ``grpo_round`` would build
    for the same episodes: group ids assigned by first appearance of
    each ``group_key`` (order-stable, so a streamed batch equals the
    lockstep reference given the same episode sequence), old_logp from
    recorded behavior logps when every episode carries them.

    Returns ``(trajectories, tokens, mask, rewards, group_ids,
    old_logp)``; ``old_logp`` is None when any episode lacks logps —
    the caller recomputes against the behavior params cache instead."""
    if not episodes:
        raise ValueError("empty episode batch")
    gid_by_key: Dict[str, int] = {}
    trajectories: List[Trajectory] = []
    for ep in episodes:
        gid = gid_by_key.setdefault(ep.group_key, len(gid_by_key))
        trajectories.append(Trajectory(
            prompt_ids=list(ep.prompt_ids),
            completion_ids=list(ep.completion_ids),
            reward=float(ep.reward), group_id=gid,
            behavior_logp=(list(ep.behavior_logp)
                           if ep.behavior_logp is not None else None)))
    tokens, mask, rewards, group_ids = make_batch(
        trajectories, pad_id=pad_id, max_len=max_len)
    old_logp = make_batch_logps(trajectories, tokens, mask)
    return trajectories, tokens, mask, rewards, group_ids, old_logp


def trajectories_to_episodes(trajectories: Sequence[Trajectory], *,
                             epoch: int, version: int, source: str,
                             round_idx: int = 0
                             ) -> List[StreamedEpisode]:
    """Lockstep-collected trajectories → streamed episodes (the online
    loop's collector-side adapter). Episode ids are deterministic in
    ``(source, round_idx, index)`` so a resubmit after a lost ack
    dedups instead of double-training; group keys preserve the
    trajectory's group id within the round."""
    return [StreamedEpisode(
        episode_id=f"{source}/r{round_idx}/i{i}",
        group_key=f"{source}/r{round_idx}/g{t.group_id}",
        prompt_ids=list(t.prompt_ids),
        completion_ids=list(t.completion_ids),
        reward=float(t.reward), epoch=int(epoch), version=int(version),
        behavior_logp=(list(t.behavior_logp)
                       if t.behavior_logp is not None else None),
        task_idx=int(t.group_id))
        for i, t in enumerate(trajectories)]


class ExperienceQueue:
    """Bounded, idempotent, staleness-bounded episode buffer.

    Episodes bucket by ``group_key``; :meth:`take_batch` releases only
    COMPLETE groups (``group_size`` episodes each), at least
    ``min_groups`` of them — partial groups wait, finished groups
    train. Staleness is enforced twice: at :meth:`offer` (don't buffer
    what's already too old) and again at :meth:`take_batch` (the
    learner may have published versions while episodes sat queued).
    Both drops land on ``senweaver_learner_stale_episodes_total``.

    Idempotency: every accepted episode id enters a bounded seen-set;
    a replayed offer (RPC retry, collector resubmit after a learner
    crash) acks ``duplicate`` without re-buffering. The seen-set is
    exportable (:meth:`seen_snapshot` / :meth:`restore_seen`) so a
    restarted learner refuses episodes its previous incarnation
    already trained — the no-double-train half of crash recovery; the
    collector's resubmit-until-acked loop is the no-loss half.
    """

    def __init__(self, *, group_size: int, capacity: int = 1024,
                 max_staleness: int = 4, min_groups: int = 1,
                 seen_capacity: int = 65536, registry=None):
        if group_size < 1:
            raise ValueError("group_size must be >= 1")
        self.group_size = int(group_size)
        self.capacity = int(capacity)
        self.max_staleness = int(max_staleness)
        self.min_groups = max(1, int(min_groups))
        self._seen_capacity = int(seen_capacity)
        # group_key -> episodes in arrival order. Dict preserves
        # insertion order, so batch assembly is deterministic.
        self._groups: Dict[str, List[StreamedEpisode]] = {}  # guarded-by: _lock
        self._depth = 0                                      # guarded-by: _lock
        # Cumulative intake accounting mirrored off the counters so
        # stats() can report fractions without reading the registry.
        self._accepted_count = 0                             # guarded-by: _lock
        self._stale_count = 0                                # guarded-by: _lock
        self._seen: "collections.OrderedDict[str, None]" = \
            collections.OrderedDict()                        # guarded-by: _lock
        self._lock = threading.Lock()
        if registry is None:
            from ..obs import get_registry
            registry = get_registry()
        self._depth_gauge = registry.gauge(
            "senweaver_learner_experience_queue_depth",
            "Episodes buffered on the streaming learner (all groups).")
        self._ready_gauge = registry.gauge(
            "senweaver_learner_experience_ready_groups",
            "Complete episode groups awaiting a train step.")
        self._stale_total = registry.counter(
            "senweaver_learner_stale_episodes_total",
            "Episodes dropped for exceeding the staleness bound "
            "(behavior version more than K published versions behind).")
        self._dup_total = registry.counter(
            "senweaver_learner_duplicate_episodes_total",
            "Episode offers deduplicated by id (RPC replays and "
            "post-crash resubmits; acked, never re-buffered).")
        self._full_total = registry.counter(
            "senweaver_learner_experience_rejected_full_total",
            "Episode offers refused because the queue was at capacity "
            "(collector backpressure; the collector resubmits).")
        self._accepted_total = registry.counter(
            "senweaver_learner_episodes_accepted_total",
            "Episodes accepted into the streaming experience queue.")
        self._staleness_hist = registry.histogram(
            "senweaver_learner_episode_staleness",
            "Versions-behind of each episode at train time.",
            buckets=STALENESS_BUCKETS)
        self._depth_gauge.set(0)
        self._ready_gauge.set(0)

    # -- intake --------------------------------------------------------------
    def offer(self, episode: StreamedEpisode, *,
              current_version: int) -> str:
        """Admit one episode; returns one of ``accepted`` /
        ``duplicate`` / ``stale`` / ``full`` (the collector's ack —
        everything except ``full`` means "stop resending this id")."""
        with self._lock:
            if episode.episode_id in self._seen:
                self._seen.move_to_end(episode.episode_id)
                self._dup_total.inc()
                return DUPLICATE
            if current_version - episode.version > self.max_staleness:
                # Stale episodes still enter the seen-set: a replayed
                # offer of a dropped episode must not flap to "full"
                # accounting, and the collector must stop resending it.
                self._note_seen(episode.episode_id)
                self._stale_total.inc()
                self._stale_count += 1
                return STALE
            if self._depth >= self.capacity:
                self._full_total.inc()
                return FULL
            self._note_seen(episode.episode_id)
            self._groups.setdefault(episode.group_key, []).append(episode)
            self._depth += 1
            self._accepted_total.inc()
            self._accepted_count += 1
            self._update_gauges()
            return ACCEPTED

    def offer_many(self, episodes: Sequence[StreamedEpisode], *,
                   current_version: int) -> Dict[str, Any]:
        """Batch offer; returns ``{"acks": {episode_id: outcome}}`` —
        the wire shape of the ``submit_episodes`` RPC."""
        return {"acks": {ep.episode_id:
                         self.offer(ep, current_version=current_version)
                         for ep in episodes}}

    def _note_seen(self, episode_id: str) -> None:
        # guarded-by: _lock
        self._seen[episode_id] = None
        while len(self._seen) > self._seen_capacity:
            self._seen.popitem(last=False)

    # -- release -------------------------------------------------------------
    def _evict_stale(self, current_version: int) -> None:
        # guarded-by: caller
        for key in list(self._groups):
            kept = [ep for ep in self._groups[key]
                    if current_version - ep.version <= self.max_staleness]
            dropped = len(self._groups[key]) - len(kept)
            if dropped:
                for _ in range(dropped):
                    self._stale_total.inc()
                self._stale_count += dropped
                self._depth -= dropped
            if kept:
                self._groups[key] = kept
            else:
                del self._groups[key]

    def ready_groups(self, *, current_version: Optional[int] = None) -> int:
        """Complete groups available right now (after staleness
        eviction when ``current_version`` is given)."""
        with self._lock:
            if current_version is not None:
                self._evict_stale(current_version)
            n = sum(len(eps) // self.group_size
                    for eps in self._groups.values())
            self._ready_gauge.set(n)
            return n

    def take_batch(self, *, current_version: int,
                   min_groups: Optional[int] = None
                   ) -> Optional[List[StreamedEpisode]]:
        """Pop a staleness-bounded batch of COMPLETE groups, or None
        when fewer than ``min_groups`` groups are ready. Each released
        group contributes exactly ``group_size`` episodes (oldest
        first); the remainder of an over-full group stays queued for
        the next step."""
        need = self.min_groups if min_groups is None else max(1,
                                                              int(min_groups))
        with self._lock:
            self._evict_stale(current_version)
            ready = [key for key, eps in self._groups.items()
                     if len(eps) >= self.group_size]
            if len(ready) < need:
                self._update_gauges()
                return None
            batch: List[StreamedEpisode] = []
            for key in ready:
                eps = self._groups[key]
                take, rest = eps[:self.group_size], eps[self.group_size:]
                if rest:
                    self._groups[key] = rest
                else:
                    del self._groups[key]
                self._depth -= len(take)
                batch.extend(take)
            for ep in batch:
                self._staleness_hist.observe(
                    float(max(0, current_version - ep.version)))
            self._update_gauges()
            return batch

    # -- introspection / durability ------------------------------------------
    @property
    def depth(self) -> int:
        with self._lock:
            return self._depth

    def _update_gauges(self) -> None:
        # guarded-by: _lock
        self._depth_gauge.set(self._depth)
        self._ready_gauge.set(sum(len(eps) // self.group_size
                                  for eps in self._groups.values()))

    def seen_snapshot(self, *, limit: int = 8192) -> List[str]:
        """Most-recent accepted episode ids (newest last) for the
        learner's durable state — a successor restores them so
        resubmitted episodes its predecessor already consumed ack
        ``duplicate`` instead of training twice."""
        with self._lock:
            ids = list(self._seen)
            return ids[-limit:]

    def restore_seen(self, ids: Sequence[str]) -> None:
        with self._lock:
            for i in ids:
                self._note_seen(str(i))

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"depth": self._depth,
                    "groups": len(self._groups),
                    "ready_groups": sum(len(e) // self.group_size
                                        for e in self._groups.values()),
                    "seen": len(self._seen),
                    "accepted": self._accepted_count,
                    "stale_dropped": self._stale_count}


class BehaviorParamsEvicted(KeyError):
    """The requested behavior version aged out of the bounded cache —
    the typed signal to degrade importance correction to the ratio-1
    approximation (counted), never to crash or to silently use wrong
    params."""


class BehaviorParamsCache:
    """Bounded LRU of ``version -> params`` pytrees.

    Replaces the unbounded per-in-flight-batch ``behavior_params``
    references the async trainer used to pin: when the collector
    outruns the trainer by more than ``capacity`` publishes, the
    oldest version is evicted (counted) and a later lookup raises
    :class:`BehaviorParamsEvicted` so the trainer falls back to
    ratio-1 old_logp under the CURRENT params (also counted) — memory
    stays O(capacity) params trees no matter how far ahead the
    collector runs."""

    def __init__(self, capacity: int = 4, *, registry=None):
        self.capacity = max(1, int(capacity))
        self._items: "collections.OrderedDict[int, Any]" = \
            collections.OrderedDict()           # guarded-by: _lock
        self._lock = threading.Lock()
        if registry is None:
            from ..obs import get_registry
            registry = get_registry()
        self._evictions_total = registry.counter(
            "senweaver_grpo_behavior_cache_evictions_total",
            "Behavior-params versions evicted from the bounded LRU "
            "(collector outran the trainer by more than the cache "
            "capacity).")
        self._fallbacks_total = registry.counter(
            "senweaver_grpo_behavior_ratio_one_fallbacks_total",
            "Train steps that degraded importance correction to the "
            "ratio-1 approximation because the behavior version was "
            "evicted.")

    def put(self, version: int, params: Any) -> None:
        with self._lock:
            self._items[int(version)] = params
            self._items.move_to_end(int(version))
            while len(self._items) > self.capacity:
                self._items.popitem(last=False)
                self._evictions_total.inc()

    def get(self, version: int) -> Any:
        with self._lock:
            try:
                params = self._items[int(version)]
            except KeyError:
                raise BehaviorParamsEvicted(
                    f"behavior params v{version} evicted "
                    f"(cache capacity {self.capacity}; resident: "
                    f"{sorted(self._items)})") from None
            self._items.move_to_end(int(version))
            return params

    def note_ratio_one_fallback(self) -> None:
        self._fallbacks_total.inc()

    def __contains__(self, version: int) -> bool:
        with self._lock:
            return int(version) in self._items

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)

    def versions(self) -> List[int]:
        with self._lock:
            return sorted(self._items)


class StreamingTrainerAdapter:
    """The trainer half of the streaming learner: streamed batch → one
    GRPO step, with the old_logp settlement the asynchrony demands.

    The streaming learner service owns leases, versions and the publish
    saga; this adapter owns the TrainState and the math. ``old_logp``
    settlement order: recorded per-token behavior logps when every
    episode carries them (token-exact, zero extra forwards — the normal
    path), else a recompute under each distinct stamped behavior version
    via the bounded :class:`BehaviorParamsCache`, degrading to ratio-1
    under the CURRENT params for evicted versions (counted, never
    crashed). Merged-LoRA behavior views are out of scope here — use
    ``AsyncGRPOTrainer`` for the in-process LoRA path.

    ``note_published(version)`` must be called at every accepted
    publish so the cache can serve later recomputes for episodes that
    version will sample. Each cached version is a COPY of the params
    (the update writes them in place); the batch moves to the params'
    device. On a mesh every rank calls :meth:`train_on_batch` with the
    same episodes and keeps its part of the batch; cached versions hold
    its shards."""

    def __init__(self, state, model_config, mesh, *,
                 grpo_config=None, optimizer=None, pad_id: int = 0,
                 max_len: Optional[int] = None, accum_steps: int = 1,
                 behavior_cache_size: int = 4, registry=None):
        from .trainer import GRPOConfig, check_mesh, clone_params
        check_mesh(mesh)
        self.state = state
        self.model_config = model_config
        self.mesh = mesh
        self.grpo_config = grpo_config or GRPOConfig()
        self.optimizer = optimizer
        self.pad_id = int(pad_id)
        self.max_len = max_len
        self.accum_steps = max(1, int(accum_steps))
        self.behavior_cache = BehaviorParamsCache(
            behavior_cache_size, registry=registry)
        # Version 0 (pre-first-publish weights) seeds the cache so the
        # earliest streamed episodes always have exact behavior params.
        self.behavior_cache.put(0, clone_params(state.params))

    @property
    def params(self):
        return self.state.params

    def note_published(self, version: int) -> None:
        """Pin a copy of the params just published as behavior version
        ``version`` (the weights replicas will sample with next)."""
        from .trainer import clone_params
        self.behavior_cache.put(int(version),
                                clone_params(self.state.params))

    def _recomputed_old_logp(self, episodes: Sequence[StreamedEpisode],
                             tokens, rows=None) -> np.ndarray:
        """Per-row behavior logps under each row's STAMPED version —
        one forward per distinct version in the batch (small: the
        staleness bound caps how many versions can coexist). On a mesh
        ``tokens`` is this rank's part and ``rows`` its rows' indices in
        the padded batch (rows past the episodes are padding)."""
        from .async_loop import behavior_logp_batched
        if rows is None:
            rows = np.arange(tokens.shape[0])
        version_of = [int(episodes[r].version) if r < len(episodes)
                      else None for r in rows]
        out = np.zeros((tokens.shape[0], tokens.shape[1] - 1),
                       dtype=np.float32)
        for version in sorted({v for v in version_of if v is not None}):
            mine = [j for j, v in enumerate(version_of) if v == version]
            try:
                params = self.behavior_cache.get(version)
            except BehaviorParamsEvicted:
                self.behavior_cache.note_ratio_one_fallback()
                params = self.state.params
            lp = behavior_logp_batched(params, self.model_config, tokens,
                                       self.accum_steps, mesh=self.mesh)
            out[mine] = lp.float().cpu().numpy()[mine]
        return out

    def train_on_batch(self, episodes: Sequence[StreamedEpisode]
                       ) -> Dict[str, float]:
        """One grpo_step over a streamed batch; returns host-float
        metrics. Mutates ``self.state``."""
        from .data import place_batch_for_mesh
        from .trainer import _host_metrics, _leaves, train_step
        _, tokens, mask, rewards, group_ids, old_logp = assemble_batch(
            episodes, pad_id=self.pad_id, max_len=self.max_len)
        if old_logp is None and self.mesh is None:
            old_logp = self._recomputed_old_logp(episodes, tokens)
        device = _leaves(self.state.params)[0].device
        tokens, mask, rewards, group_ids, old_logp = \
            place_batch_for_mesh(self.mesh, tokens, mask, rewards,
                                 group_ids, old_logp, pad_id=self.pad_id,
                                 accum_steps=self.accum_steps, device=device)
        if old_logp is None and self.mesh is not None:
            import torch

            from .data import local_rows
            rows = local_rows(self.mesh, tokens.shape[0] * self.mesh
                              .axis_size(("dp", "fsdp")), self.accum_steps)
            old_logp = torch.from_numpy(self._recomputed_old_logp(
                episodes, tokens, rows)).to(device)
        self.state, metrics = train_step(
            self.state, self.model_config, self.mesh, tokens, mask,
            rewards, group_ids, old_logp=old_logp,
            grpo_config=self.grpo_config, optimizer=self.optimizer,
            accum_steps=self.accum_steps)
        return _host_metrics(metrics)

