"""Online DRAFT distillation from fleet speculation outcomes.

FastGRPO's failure mode (PAPERS.md): during RL the target policy keeps
moving, so a frozen speculation draft's acceptance rate (and with it
the entire speculative speedup) decays with every weight publish. The
serving engine already harvests the perfect supervision signal for
free: every verification round records the context it speculated from
and the tokens the TARGET actually chose (accepted proposals plus the
correction token that ended the round). Those pairs are exactly the
sequences the draft must imitate to raise its acceptance rate, and they
cost zero extra forward passes.

:class:`DraftDistiller` closes the loop:

    engine.drain_spec_outcomes() → ring buffer → CE steps on the draft
        → publisher.publish_draft(...)   (fleet, duck-typed)
        → engine.update_draft_params(...) (single engine)

Correctness never depends on any of this (greedy speculative decoding
is exact for an arbitrarily bad draft), so the distiller can run lazily
between serving bursts. Only the acceptance EMA (throughput) moves.

The update is shared with the offline path
(``rollout.speculative._distill_step``): one CE step over (B, S) token
batches with a train-position mask, on the trainer's Adam. Batches are
padded to a constant batch size and a power-of-two width, as the JAX
version pads them. The distiller trains its OWN copy of the draft in
place; :meth:`install` hands each engine a snapshot, so an engine keeps
the version it was given until the next install, as in JAX.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.config import ModelConfig
from ..models.transformer import Params
from ..rollout.speculative import _distill_step
from .trainer import AdamW, clone_params


class DraftDistiller:
    """Continually distill a speculation draft toward the serving target
    using the (context, target-chosen tokens) pairs the engine's fused
    verification step records.

    Not thread-safe: run it from one loop (the trainer's)."""

    def __init__(self, draft_params: Params, draft_config: ModelConfig, *,
                 learning_rate: float = 1e-3, buffer_size: int = 1024,
                 batch_size: int = 8, max_len: int = 256, pad_id: int = 0,
                 seed: int = 0, registry=None):
        self.params = clone_params(draft_params)
        self.config = draft_config
        # optax.adam(learning_rate): the trainer's Adam, unclipped
        self.optimizer = AdamW(learning_rate=learning_rate,
                               max_grad_norm=None, b2=0.999)
        self.opt_state = self.optimizer.init(self.params)
        # Ring buffer of (tokens, n_trained_tail): the final
        # ``n_trained_tail`` positions carry the CE mask — they are the
        # tokens the TARGET chose during verification; everything
        # before is conditioning context.
        self.buffer: List[Tuple[List[int], int]] = []
        self.buffer_size = int(buffer_size)
        self.batch_size = int(batch_size)
        self.max_len = int(max_len)
        self.pad_id = int(pad_id)
        self.steps = 0
        self.harvested = 0
        self.version = 0        # last version handed to publish/install
        self._rng = np.random.default_rng(seed)
        # the snapshot handed to engines: (steps it was taken at, params)
        self._snapshot: Optional[Tuple[int, Params]] = None
        if registry is None:
            from ..obs import get_registry
            registry = get_registry()
        self._steps_total = registry.counter(
            "senweaver_spec_distill_steps_total",
            "Draft distillation CE steps taken.")
        self._harvested_total = registry.counter(
            "senweaver_spec_distill_outcomes_total",
            "Verification outcomes harvested into the distill buffer.")
        self._loss_gauge = registry.gauge(
            "senweaver_spec_distill_loss",
            "Cross-entropy of the draft on target-chosen tokens "
            "(last step).")

    # -- data intake ---------------------------------------------------------
    def observe(self, context: Sequence[int],
                targets: Sequence[int]) -> None:
        """Record one verification outcome: ``targets`` are the tokens
        the target chose immediately after ``context``."""
        if not targets:
            return
        seq = (list(context) + list(targets))[-self.max_len:]
        n_out = min(len(targets), len(seq))
        self.buffer.append((seq, n_out))
        if len(self.buffer) > self.buffer_size:
            del self.buffer[:len(self.buffer) - self.buffer_size]

    def harvest(self, engine) -> int:
        """Drain one engine's buffered speculation outcomes into the
        buffer; returns how many were taken."""
        outcomes: List[Dict] = engine.drain_spec_outcomes()
        for o in outcomes:
            self.observe(o["context"], o["targets"])
        self.harvested += len(outcomes)
        if outcomes:
            self._harvested_total.inc(len(outcomes))
        return len(outcomes)

    # -- optimisation --------------------------------------------------------
    def batch(self) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """The next step's (tokens, mask) host batch, drawn uniformly from
        the buffer, or None when it is empty."""
        if not self.buffer:
            return None
        idx = self._rng.choice(len(self.buffer),
                               size=min(self.batch_size, len(self.buffer)),
                               replace=False)
        picked = [self.buffer[i] for i in idx]
        width = 16
        need = min(self.max_len, max(len(seq) for seq, _ in picked))
        while width < need:
            width *= 2
        toks = np.full((self.batch_size, width), self.pad_id, np.int64)
        mask = np.zeros((self.batch_size, width), bool)
        for i, (seq, n_out) in enumerate(picked):
            seq = seq[-width:]
            n = min(n_out, len(seq))
            toks[i, :len(seq)] = seq
            mask[i, len(seq) - n:len(seq)] = True
        return toks, mask

    def step(self) -> float:
        """One CE update over a uniform sample of the buffer. Returns
        the loss (0.0 when the buffer is empty)."""
        b = self.batch()
        if b is None:
            return 0.0
        dev = self.params["embed"].device
        self.params, self.opt_state, loss = _distill_step(
            self.params, self.opt_state, self.config, self.optimizer,
            torch.from_numpy(b[0]).to(dev), torch.from_numpy(b[1]).to(dev))
        self.steps += 1
        self._steps_total.inc()
        out = float(loss)
        self._loss_gauge.set(out)
        return out

    def run(self, steps: int) -> float:
        """``steps`` CE updates; returns the final loss."""
        loss = 0.0
        for _ in range(max(0, int(steps))):
            loss = self.step()
        return loss

    # -- publication ---------------------------------------------------------
    def snapshot(self) -> Params:
        """A copy of the current draft, taken once per step count: what
        publish and install hand out, since this distiller keeps
        updating its own params in place."""
        if self._snapshot is None or self._snapshot[0] != self.steps:
            self._snapshot = (self.steps, clone_params(self.params))
        return self._snapshot[1]

    def publish(self, publisher, *, epoch: Optional[int] = None,
                version: Optional[int] = None) -> int:
        """Republish the improved draft through a fleet publisher's
        ``publish_draft(params, epoch=, version=)``. Returns the accepted
        version."""
        self.version = publisher.publish_draft(self.snapshot(), epoch=epoch,
                                               version=version)
        return self.version

    def install(self, engine, *, version: Optional[int] = None) -> int:
        """Single-engine path: swap the draft directly via
        ``engine.update_draft_params``."""
        self.version = self.version + 1 if version is None else int(version)
        engine.update_draft_params(self.snapshot(), version=self.version)
        return self.version

    def round(self, engines: Sequence, *, steps: int = 4,
              publisher=None) -> float:
        """One full loop turn: harvest every engine, take ``steps``
        updates, then publish (fleet) or install (each engine
        directly). Returns the final loss."""
        for e in engines:
            self.harvest(e)
        loss = self.run(steps)
        if not self.buffer:
            return loss
        if publisher is not None:
            self.publish(publisher)
        else:
            v = self.version + 1
            for e in engines:
                self.install(e, version=v)
        return loss
