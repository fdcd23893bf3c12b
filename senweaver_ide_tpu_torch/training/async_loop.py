"""Behaviour log-probs under a frozen policy (PyTorch port).

Of the JAX package's ``training/async_loop.py`` this slice takes the one
function the training path needs: the reference (or behaviour) log-probs
for the KL term and importance ratios, computed with the trainer's
microbatch split. The pipelined ``AsyncGRPOTrainer`` arrives with the
rest of training.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.transformer import forward
from .grpo import token_logprobs


@torch.no_grad()
def _behavior_logp(params, config, tokens: torch.Tensor) -> torch.Tensor:
    logits = forward(params, config, tokens[:, :-1])
    return token_logprobs(logits, tokens[:, 1:])


def behavior_logp_batched(params, config, tokens,
                          accum_steps: int = 1) -> torch.Tensor:
    """(B, S-1) log-probs of ``tokens`` (B, S) under ``params``, in the
    trainer's target layout, one microbatch at a time: a whole-batch
    forward would hold the (B, S-1, V) logits that ``accum_steps`` was
    sized to avoid. A batch not divisible by ``accum_steps`` runs whole."""
    dev = params["embed"].device
    if not isinstance(tokens, torch.Tensor):
        tokens = torch.from_numpy(np.asarray(tokens))
    tokens = tokens.to(dev, torch.long)
    b = tokens.shape[0]
    if accum_steps <= 1 or b % accum_steps != 0:
        return _behavior_logp(params, config, tokens)
    mb = b // accum_steps
    return torch.cat([_behavior_logp(params, config,
                                     tokens[i * mb:(i + 1) * mb])
                      for i in range(accum_steps)], dim=0)
