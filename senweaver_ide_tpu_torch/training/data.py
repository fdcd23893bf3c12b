"""Trajectories → padded GRPO training batches (numpy only).

A copy of the JAX package's ``training/data.py`` builders: a trajectory
is (prompt_ids, completion_ids, reward, group_id) plus the behaviour
log-probs the engine recorded at sample time and, for tree rollouts, its
branch points. Batches pad to a power-of-two bucket with a completion
mask so the objective scores generated tokens only. The mesh padding and
placement helpers belong to the parallel-layout slice.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class Trajectory:
    prompt_ids: List[int]
    completion_ids: List[int]
    reward: float
    group_id: int
    # behaviour log-prob per completion token, captured at sample time
    # (RolloutEngine.result_logps); make_batch_logps aligns them
    behavior_logp: Optional[List[float]] = None
    # 0-based positions within completion_ids where a rollout tree
    # branched; make_branch_mask aligns them
    branch_points: Optional[List[int]] = None


def _bucket(n: int, minimum: int = 32) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


def make_batch(trajectories: Sequence[Trajectory], *, pad_id: int,
               max_len: Optional[int] = None
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Returns (tokens (B, S) int32, completion_mask (B, S) bool, rewards
    (B,) f32, group_ids (B,) int32). S = power-of-two bucket of the
    longest trajectory (clipped to max_len; an overlong trajectory keeps
    its completion tail and drops the prompt head)."""
    if not trajectories:
        raise ValueError("empty batch")
    lens = [len(t.prompt_ids) + len(t.completion_ids) for t in trajectories]
    s = _bucket(max(lens))
    if max_len is not None:
        s = min(s, max_len)
    b = len(trajectories)
    tokens = np.full((b, s), pad_id, np.int32)
    mask = np.zeros((b, s), bool)
    rewards = np.zeros((b,), np.float32)
    group_ids = np.zeros((b,), np.int32)
    for i, t in enumerate(trajectories):
        seq = list(t.prompt_ids) + list(t.completion_ids)
        comp_start = len(t.prompt_ids)
        if len(seq) > s:
            drop = len(seq) - s
            seq = seq[drop:]
            comp_start = max(0, comp_start - drop)
        tokens[i, :len(seq)] = seq
        mask[i, comp_start:len(seq)] = True
        rewards[i] = t.reward
        group_ids[i] = t.group_id
    return tokens, mask, rewards, group_ids


def make_batch_logps(trajectories: Sequence[Trajectory],
                     tokens: np.ndarray,
                     mask: np.ndarray) -> Optional[np.ndarray]:
    """Recorded behaviour log-probs aligned with a make_batch output, as
    old_logp (B, S-1) in the trainer's target layout (position j-1
    predicts token j); None unless every trajectory carries a full list.
    Positions outside the completion mask hold 0.0."""
    if any(t.behavior_logp is None
           or len(t.behavior_logp) != len(t.completion_ids)
           for t in trajectories):
        return None
    b, s = tokens.shape
    old = np.zeros((b, s - 1), np.float32)
    for i, t in enumerate(trajectories):
        pos = np.nonzero(mask[i])[0]
        lps = np.asarray(t.behavior_logp[-len(pos):] if len(pos) else [],
                         np.float32)
        keep = pos >= 1
        old[i, pos[keep] - 1] = lps[keep]
    return old


def make_branch_mask(trajectories: Sequence[Trajectory],
                     tokens: np.ndarray,
                     mask: np.ndarray) -> Optional[np.ndarray]:
    """(B, S) f32 mask with 1.0 at the completion tokens where a
    trajectory's rollout tree branched, or None when no trajectory has
    branch points. Points cropped by an overlong row's front-drop fall
    outside the kept tail."""
    if not any(t.branch_points for t in trajectories):
        return None
    b, s = tokens.shape
    out = np.zeros((b, s), np.float32)
    for i, t in enumerate(trajectories):
        if not t.branch_points:
            continue
        pos = np.nonzero(mask[i])[0]
        n = len(pos)
        dropped = len(t.completion_ids) - n
        for p in t.branch_points:
            q = int(p) - dropped
            if 0 <= q < n:
                out[i, pos[q]] = 1.0
    return out
