"""Trajectories → padded GRPO training batches (numpy only).

A copy of the JAX package's ``training/data.py`` builders: a trajectory
is (prompt_ids, completion_ids, reward, group_id) plus the behaviour
log-probs the engine recorded at sample time and, for tree rollouts, its
branch points. Batches pad to a power-of-two bucket with a completion
mask so the objective scores generated tokens only.
:func:`place_batch_for_mesh` pads a batch for the microbatch split and
the mesh, and moves this rank's part of it to the training device.
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


def pad_batch_for_mesh(
    tokens: np.ndarray, mask: np.ndarray, rewards: np.ndarray,
    group_ids: np.ndarray, *, batch_multiple: int = 1,
    seq_multiple: int = 1, pad_id: int = 0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Pad a make_batch output so it splits evenly: batch axis to a
    multiple of ``batch_multiple``, and the TRAINING sequence length (S−1,
    after the trainer's next-token shift) to a multiple of
    ``seq_multiple``. Padded rows get an all-False mask, zero reward, and a
    fresh singleton group id each — they contribute nothing to the masked
    objective or group advantages."""
    b, s = tokens.shape
    target_s = ((s - 1 + seq_multiple - 1) // seq_multiple) * seq_multiple + 1
    if target_s > s:
        pad = target_s - s
        tokens = np.pad(tokens, ((0, 0), (0, pad)), constant_values=pad_id)
        mask = np.pad(mask, ((0, 0), (0, pad)))
    target_b = ((b + batch_multiple - 1) // batch_multiple) * batch_multiple
    if target_b > b:
        extra = target_b - b
        tokens = np.pad(tokens, ((0, extra), (0, 0)), constant_values=pad_id)
        mask = np.pad(mask, ((0, extra), (0, 0)))
        rewards = np.pad(rewards, (0, extra))
        next_gid = int(group_ids.max()) + 1 if b else 0
        group_ids = np.concatenate(
            [group_ids, np.arange(next_gid, next_gid + extra,
                                  dtype=group_ids.dtype)])
    return tokens, mask, rewards, group_ids


def local_rows(mesh, batch: int, accum_steps: int = 1) -> np.ndarray:
    """The rows of a padded ``batch`` that this rank holds, in its order:
    its share of every microbatch (over dp·fsdp)."""
    from ..parallel.mesh import DATA_AXES
    accum = max(accum_steps, 1)
    mb = batch // accum
    mbl = mb // mesh.axis_size(DATA_AXES)
    d = mesh.coord(DATA_AXES)
    return np.concatenate([np.arange(i * mb + d * mbl,
                                     i * mb + (d + 1) * mbl)
                           for i in range(accum)])


def local_block(mesh, x: np.ndarray, accum_steps: int = 1, *,
                targets: bool = False) -> np.ndarray:
    """This rank's block of a PADDED host batch array (rows first): its
    rows of every microbatch (over dp·fsdp) and, for 2-d arrays, its
    sequence chunk (over sp) — L+1 positions of a (B, S) token-layout
    array, L of a (B, S−1) target-layout one (``targets``), for L =
    (S−1)/sp. The layout :func:`place_batch_for_mesh` gives."""
    x = x[local_rows(mesh, x.shape[0], accum_steps)]
    if x.ndim < 2:
        return x
    sp = mesh.axis_size("sp")
    length = x.shape[1] // sp if targets else (x.shape[1] - 1) // sp
    c0 = mesh.coord("sp") * length
    return x[:, c0:c0 + length + (0 if targets else 1)]


def place_batch_for_mesh(mesh, tokens, mask, rewards, group_ids,
                         old_logp=None, *, pad_id: int = 0,
                         accum_steps: int = 1, device="cuda"):
    """Pad a make_batch output and move THIS RANK's part of it to
    ``device`` (the params' device): tokens and group ids as int64, the
    mask as bool, rewards and ``old_logp`` as f32. Returns ``(tokens, mask,
    rewards, group_ids, old_logp or None)`` ready for train_step.

    Without a mesh the rows pad to a multiple of ``accum_steps``. On a
    mesh the TRAINING length S−1 pads to a multiple of sp (old_logp's
    columns with it), as in JAX, and the rows to a multiple of n ·
    ``accum_steps`` for n = dp·fsdp data ranks: JAX pads to their lcm and
    lets a microbatch split unevenly, here each data rank holds an equal
    share of every microbatch (a padded row has no completion token, so
    the objective, its metrics and the gradients are the same). Data rank
    d gets rows ``[i·mb + d·mbl, i·mb + (d+1)·mbl)`` of each microbatch i
    (mb = B/accum_steps, mbl = mb/n), and sp rank c the tokens and mask of
    positions ``[c·L, (c+1)·L]`` (L = (S−1)/sp: its L inputs and the
    token after them) and old_logp's ``[c·L, (c+1)·L)``."""
    import torch

    from ..device import resolve_device

    dev = resolve_device(device)
    n_data, sp = 1, 1
    if mesh is not None:
        from ..parallel.mesh import DATA_AXES
        n_data, sp = mesh.axis_size(DATA_AXES), mesh.axis_size("sp")
    batch_multiple = n_data * max(accum_steps, 1)
    if tokens.shape[0] % batch_multiple or (tokens.shape[1] - 1) % sp:
        # the returned batch must satisfy the microbatch split's
        # divisibility check
        tokens, mask, rewards, group_ids = pad_batch_for_mesh(
            tokens, mask, rewards, group_ids,
            batch_multiple=batch_multiple, seq_multiple=sp, pad_id=pad_id)
    if old_logp is not None and old_logp.shape != (tokens.shape[0],
                                                   tokens.shape[1] - 1):
        # padded positions are outside the mask and never read
        old_logp = np.pad(old_logp,
                          ((0, tokens.shape[0] - old_logp.shape[0]),
                           (0, tokens.shape[1] - 1 - old_logp.shape[1])))
    if mesh is not None:
        tokens, mask = (local_block(mesh, a, accum_steps)
                        for a in (tokens, mask))
        rewards, group_ids = (local_block(mesh, a, accum_steps)
                              for a in (rewards, group_ids))
        if old_logp is not None:
            old_logp = local_block(mesh, old_logp, accum_steps,
                                   targets=True)

    def put(x, dtype):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev, dtype)

    return (put(tokens, torch.int64), put(mask, torch.bool),
            put(rewards, torch.float32), put(group_ids, torch.int64),
            put(old_logp, torch.float32) if old_logp is not None else None)
