"""GRPO trainer (PyTorch port): train state, the AdamW chain, one update.

``train_step`` runs the JAX ``_grpo_step`` in the same order of work:
group-relative advantages over the full batch, the next-token shift, then
per microbatch ``forward`` → ``token_logprobs`` → ``grpo_objective`` with
gradients accumulated in fp32 and weighted by the microbatch's share of
completion tokens, the gradients cast to the param dtype, their global
norm, and the optimizer update. Gradient computation
(:func:`grpo_gradients`) and the optimizer application
(:func:`apply_gradients`) are separate functions, so a guarded step
(:func:`train_step_guarded`) inspects the metrics before anything is
written: a vetoed step leaves the params and the moments untouched, the
state the JAX package's guard restores.

The optimizer is optax's ``chain(clip_by_global_norm(max_grad_norm),
adamw(schedule, b1=0.9, b2=0.95, eps=1e-8, weight_decay))`` written out
on tensors with optax's exact rules (see :class:`AdamW`), not
``torch.optim.AdamW`` + ``clip_grad_norm_``, whose clip rule and warm-up
step count differ.

Params and Adam moments are updated IN PLACE (the JAX version returns new
arrays): the returned state holds the same tensors as the input state, so
an engine serving those tensors sees the new weights at once.
``RolloutEngine.update_params`` stays the round boundary that says so.

The step runs under the span ``trainer.grpo_step`` and the runtime ledger
entry of the same name (``obs/runtime_profile.py``, ``block=False``: the
metrics stay on the device until the caller syncs them).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Iterator, List, Mapping, Optional, Tuple

import numpy as np
import torch

from ..models.config import ModelConfig
from ..models.transformer import Params, forward, init_params
from ..obs.runtime_profile import ProfiledFunction
from .grpo import (GRPOConfig, group_relative_advantages, grpo_objective,
                   token_logprobs)
from .lora import _refuse_int8, merge_lora

# the adamw constants of the JAX trainer's chain (make_optimizer)
_B1, _B2, _EPS = 0.9, 0.95, 1e-8
_METRIC_KEYS = ("pg_loss", "kl", "entropy", "ratio_mean", "clip_frac",
                "grad_sparsity")


def flatten_params(tree: Mapping, prefix: str = "") -> Iterator[
        Tuple[str, torch.Tensor]]:
    """``("layers/wq", tensor)`` pairs in sorted key order (the order of
    JAX's tree leaves): a fixed order and a name per tensor, for the
    optimizer and for files that hold a param dict."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, Mapping):
            yield from flatten_params(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


def unflatten_params(pairs) -> Dict:
    """The dict tree of ``(name, value)`` pairs named as
    :func:`flatten_params` names them."""
    out: Dict = {}
    for name, v in pairs:
        node = out
        *path, leaf = name.split("/")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = v
    return out


def _leaves(tree: Mapping) -> List[torch.Tensor]:
    return [v for _, v in flatten_params(tree)]


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares over every element, in fp32 (optax
    ``global_norm``)."""
    return torch.sqrt(sum((t.float() * t.float()).sum() for t in tensors))


@dataclasses.dataclass
class AdamWState:
    count: int          # updates applied so far (optax's Adam and
                        # schedule counts, which advance together)
    mu: Params          # first moments, in each param's dtype
    nu: Params          # second moments, in each param's dtype


@dataclasses.dataclass(frozen=True)
class AdamW:
    """optax ``chain(clip_by_global_norm, adamw(b1=0.9, b2=0.95,
    eps=1e-8))`` on torch tensors; with ``max_grad_norm=None``, ``b2=0.999``
    and no decay it is optax's plain ``adam`` (the APO proposer's).

    Per update, with g the param-dtype gradient and n its global norm:

    - clip (unless ``max_grad_norm`` is None): ``g`` if
      ``n < max_grad_norm`` else ``(g / n) * max_grad_norm`` (optax scales
      only when the norm exceeds the maximum);
    - ``mu = (1 - b1) g + b1 mu``, ``nu = (1 - b2) g**2 + b2 nu``, stored
      in the param dtype as optax stores them (``mu_dtype=None``);
    - bias corrections ``1 - b**t`` with t the incremented count;
    - ``u = mu_hat / (sqrt(nu_hat) + eps) + weight_decay * p`` (decoupled
      decay), then ``p += -lr_t * u``, where ``lr_t`` is the
      ``linear_schedule(0, lr, warmup_steps)`` value at the PRE-increment
      count: 0 at the first update when warming up.

    Arithmetic runs in fp32 (scalars as optax computes them in fp32)."""

    learning_rate: float = 1e-5
    weight_decay: float = 0.0
    max_grad_norm: Optional[float] = 1.0
    warmup_steps: int = 0
    b2: float = _B2

    def init(self, params: Params) -> AdamWState:
        zeros = lambda t: torch.zeros_like(t)       # noqa: E731
        return AdamWState(
            count=0,
            mu=unflatten_params((n, zeros(t))
                                for n, t in flatten_params(params)),
            nu=unflatten_params((n, zeros(t))
                                for n, t in flatten_params(params)))

    def step_size(self, count: int) -> float:
        """The signed step ``-lr_t`` of update number ``count`` (0-based),
        in fp32 as optax's schedule computes it."""
        lr = np.float32(self.learning_rate)
        if self.warmup_steps > 0:
            steps = np.float32(self.warmup_steps)
            c = np.float32(min(max(count, 0), self.warmup_steps))
            frac = np.float32(1.0) - c / steps
            lr = (np.float32(0.0) - lr) * frac + lr
        return float(-lr)

    @torch.no_grad()
    def update(self, grads: Params, state: AdamWState, params: Params,
               grad_norm: Optional[torch.Tensor] = None) -> AdamWState:
        """Apply one update to ``params`` and the moments IN PLACE;
        returns the state with the count advanced. ``grad_norm`` (of
        ``grads``) is computed when not given."""
        gl, pl = _leaves(grads), _leaves(params)
        ml, nl = _leaves(state.mu), _leaves(state.nu)
        clip = self.max_grad_norm is not None
        if clip:
            if grad_norm is None:
                grad_norm = global_norm(gl)
            keep = grad_norm < self.max_grad_norm
        count = state.count + 1
        b2 = self.b2
        bc1 = float(np.float32(1.0) - np.float32(_B1) ** np.float32(count))
        bc2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(count))
        step = self.step_size(state.count)
        for g, p, mu, nu in zip(gl, pl, ml, nl):
            g = g.float()
            if clip:
                g = torch.where(keep, g, (g / grad_norm) * self.max_grad_norm)
            mu.copy_(g * (1.0 - _B1) + mu.float() * _B1)
            nu.copy_((g * g) * (1.0 - b2) + nu.float() * b2)
            u = (mu.float() / bc1) / (torch.sqrt(nu.float() / bc2) + _EPS)
            if self.weight_decay:
                u = u + self.weight_decay * p.float()
            p.add_((step * u).to(p.dtype))
        return AdamWState(count=count, mu=state.mu, nu=state.nu)


@functools.lru_cache(maxsize=64)
def make_optimizer(learning_rate: float = 1e-5, *, weight_decay: float = 0.0,
                   max_grad_norm: float = 1.0,
                   warmup_steps: int = 0) -> AdamW:
    """Cached by config: equal arguments return the SAME instance."""
    return AdamW(learning_rate=learning_rate, weight_decay=weight_decay,
                 max_grad_norm=max_grad_norm, warmup_steps=warmup_steps)


_DEFAULT_OPT = make_optimizer()


@dataclasses.dataclass
class TrainState:
    params: Params
    opt_state: AdamWState
    step: int = 0
    # the optimizer whose init built opt_state; train_step keeps using it
    opt: Optional[AdamW] = None


def _refuse_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "sharded training over a mesh arrives with the parallel-layout "
            "slice of the PyTorch port; pass mesh=None")


def make_train_state(config: ModelConfig,
                     generator: Optional[torch.Generator] = None,
                     mesh=None, *, learning_rate: float = 1e-5,
                     params: Optional[Params] = None,
                     optimizer: Optional[AdamW] = None,
                     device="cuda") -> TrainState:
    """Init (from ``generator`` on ``device``) or adopt ``params``, and
    init the optimizer state beside them."""
    _refuse_mesh(mesh)
    if params is None:
        if generator is None:
            raise ValueError("pass params or a generator to init them")
        params = init_params(config, generator, device=device)
    opt = optimizer or make_optimizer(learning_rate)
    return TrainState(params=params, opt_state=opt.init(params), step=0,
                      opt=opt)


def make_lora_train_state(config: ModelConfig, base_params: Params,
                          generator: torch.Generator, mesh=None, *,
                          rank: int = 16, alpha: Optional[float] = None,
                          targets: Optional[Tuple[str, ...]] = None,
                          learning_rate: float = 1e-4,
                          optimizer: Optional[AdamW] = None) -> TrainState:
    """TrainState whose params are ONLY the LoRA adapters for
    ``base_params``; pass the frozen base to ``train_step(...,
    lora_base=base_params)``. Adapters live on the base's device."""
    from .lora import DEFAULT_TARGETS, init_lora
    _refuse_mesh(mesh)
    _refuse_int8(base_params, "LoRA training")
    wq = base_params["layers"]["wq"]
    expect = (config.num_layers, config.hidden_size, config.q_dim)
    if tuple(wq.shape) != expect:
        raise ValueError(f"base_params do not match config "
                         f"{config.name!r}: wq {tuple(wq.shape)} != "
                         f"{expect}")
    lora = init_lora(config, generator, rank=rank, alpha=alpha,
                     targets=targets or DEFAULT_TARGETS, device=wq.device)
    opt = optimizer or make_optimizer(learning_rate)
    return TrainState(params=lora, opt_state=opt.init(lora), step=0,
                      opt=opt)


def _as_tensor(x, device, dtype=None) -> Optional[torch.Tensor]:
    if x is None:
        return None
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
    return t.to(device=device, dtype=dtype)


def grpo_gradients(params: Params, config: ModelConfig,
                   tokens, completion_mask, rewards, group_ids, *,
                   old_logp=None, ref_logp=None, branch_mask=None,
                   grpo_config: GRPOConfig = GRPOConfig(),
                   num_groups: Optional[int] = None,
                   accum_steps: int = 1,
                   lora_base: Optional[Params] = None,
                   ) -> Tuple[Params, Dict[str, torch.Tensor]]:
    """The GRPO gradient of ``params`` (the adapters when ``lora_base`` is
    given) over the batch, in the param dtype, and the metrics: the
    objective's (token-share weighted over microbatches), ``loss``,
    ``grad_norm`` (of the returned gradients) and ``adv_mean``. Writes
    nothing."""
    pairs = list(flatten_params(params))
    names = [p for p, _ in pairs]
    base = [t for _, t in pairs]
    dev = base[0].device
    tokens = _as_tensor(tokens, dev, torch.long)
    completion_mask = _as_tensor(completion_mask, dev, torch.bool)
    rewards = _as_tensor(rewards, dev, torch.float32)
    group_ids = _as_tensor(group_ids, dev, torch.long)
    old_logp = _as_tensor(old_logp, dev, torch.float32)
    ref_logp = _as_tensor(ref_logp, dev, torch.float32)
    b = tokens.shape[0]
    if b % accum_steps != 0:
        raise ValueError(f"batch {b} not divisible by accum_steps "
                         f"{accum_steps}")
    n_groups = num_groups or b
    # 1. advantages over the FULL batch (group members may land in
    #    different microbatches)
    adv = group_relative_advantages(
        rewards, group_ids, n_groups,
        normalize_std=grpo_config.normalize_std,
        min_std=grpo_config.min_group_std,
        leave_one_out=grpo_config.leave_one_out)
    # 2. next-token shift
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    tgt_mask = completion_mask[:, 1:]
    branch = (None if branch_mask is None
              else _as_tensor(branch_mask, dev, torch.float32)[:, 1:])
    total_denom = torch.clamp_min(tgt_mask.sum().float(), 1.0)
    keys = _METRIC_KEYS + (("branch_token_frac",) if branch is not None
                           else ())

    # 3. per microbatch: forward, log-probs, objective, fp32 accumulation
    grads_acc = [torch.zeros(t.shape, dtype=torch.float32, device=dev)
                 for t in base]
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    loss_acc = zero
    metr_acc = {k: zero for k in keys}
    mb = b // accum_steps
    for i in range(accum_steps):
        sl = slice(i * mb, (i + 1) * mb)
        live = [t.detach().requires_grad_() for t in base]
        trainable = unflatten_params(zip(names, live))
        model_params = (trainable if lora_base is None
                        else merge_lora(lora_base, trainable))
        logits, _, _ = forward(model_params, config, inputs[sl],
                               with_aux=True)
        logp = token_logprobs(logits, targets[sl])
        olp = old_logp[sl] if old_logp is not None else logp.detach()
        loss, metrics = grpo_objective(
            logp, olp, adv[sl], tgt_mask[sl], grpo_config,
            ref_logp=ref_logp[sl] if ref_logp is not None else None,
            branch_mask=branch[sl] if branch is not None else None)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
        del logits, logp
        w = torch.clamp_min(tgt_mask[sl].sum().float(), 0.0) / total_denom
        for acc, g in zip(grads_acc, grads):
            if g is not None:
                acc.add_(g.float() * w)
        loss_acc = loss_acc + loss.detach() * w
        metr_acc = {k: metr_acc[k] + metrics[k].detach() * w for k in keys}
        del grads, loss, metrics
    # 4. gradients in the param dtype; 5. their global norm
    out = [acc.to(t.dtype) for acc, t in zip(grads_acc, base)]
    metrics = dict(metr_acc)
    metrics["loss"] = loss_acc
    metrics["grad_norm"] = global_norm(out)
    metrics["adv_mean"] = adv.mean()
    return unflatten_params(zip(names, out)), metrics


def apply_gradients(state: TrainState, grads: Params,
                    grad_norm: Optional[torch.Tensor] = None,
                    optimizer: Optional[AdamW] = None) -> TrainState:
    """6. The optimizer update, IN PLACE on ``state.params`` and its
    moments; returns the advanced state (same tensors)."""
    opt = optimizer or state.opt or _DEFAULT_OPT
    opt_state = opt.update(grads, state.opt_state, state.params, grad_norm)
    return TrainState(params=state.params, opt_state=opt_state,
                      step=state.step + 1, opt=opt)


def _has_int8(params: Params) -> bool:
    return any(t.dtype == torch.int8 for t in _leaves(params))


def _host_metrics(metrics: Mapping[str, torch.Tensor]) -> Dict[str, float]:
    """The metrics as host floats, in one device→host copy."""
    keys = list(metrics)
    vals = torch.stack([torch.as_tensor(metrics[k]).float().reshape(())
                        for k in keys]).cpu().tolist()
    return dict(zip(keys, (float(v) for v in vals)))


def _grpo_step(state: TrainState, config: ModelConfig, tokens,
               completion_mask, rewards, group_ids, *, check=None,
               optimizer: Optional[AdamW] = None, lora_base=None,
               **kwargs):
    """Gradients, then — unless ``check(host_metrics)`` returns a veto
    reason — the optimizer update. Returns ``(state, metrics, reason)``;
    on a veto ``state`` is the input state, untouched."""
    grads, metrics = grpo_gradients(
        state.params, config, tokens, completion_mask, rewards, group_ids,
        lora_base=lora_base, **kwargs)
    if check is not None:
        reason = check(_host_metrics(metrics))
        if reason is not None:
            return state, metrics, reason
    return (apply_gradients(state, grads, metrics["grad_norm"], optimizer),
            metrics, None)


# Runtime observatory wiring (obs/runtime_profile.py): the GRPO update's
# ledger. ``block=False`` keeps the launch semantics (the span comment in
# train_step): the step histogram records the host time of the step;
# device time stays with rl_loop's train_s. State and config are
# shape-stable and skipped from the signature scan.
_grpo_step = ProfiledFunction(
    _grpo_step, "trainer.grpo_step", skip_args=(0, 1),
    skip_kwargs=("lora_base", "check", "optimizer", "grpo_config"),
    block=False)


def _run_step(state: TrainState, config: ModelConfig, mesh, tokens,
              completion_mask, rewards, group_ids, *, check=None,
              lora_base=None, **kwargs):
    """train_step's refusals, then the profiled step under its span."""
    _refuse_mesh(mesh)
    if _has_int8(state.params):
        raise TypeError(
            "train_step received int8-quantized params — quantization is a "
            "SERVING transform; train on the full-precision state and "
            "publish quantized")
    if lora_base is not None:
        _refuse_int8(lora_base, "train_step")
    from ..obs import get_tracer
    with get_tracer().span("trainer.grpo_step",
                           batch=int(tokens.shape[0]),
                           accum_steps=kwargs.get("accum_steps", 1)):
        return _grpo_step(state, config, tokens, completion_mask, rewards,
                          group_ids, check=check, lora_base=lora_base,
                          **kwargs)


def train_step(state: TrainState, config: ModelConfig, mesh,
               tokens, completion_mask, rewards, group_ids, *,
               old_logp=None, ref_logp=None, branch_mask=None,
               grpo_config: GRPOConfig = GRPOConfig(),
               optimizer: Optional[AdamW] = None,
               num_groups: Optional[int] = None,
               accum_steps: int = 1,
               lora_base: Optional[Params] = None,
               ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One GRPO update. tokens (B, S) prompt+completion; completion_mask
    True on completion positions; rewards (B,); group_ids (B,) prompt
    group of each trajectory; old_logp / ref_logp (B, S-1) in the target
    layout; branch_mask (B, S). Host arrays or tensors; they move to the
    params' device. ``accum_steps > 1`` splits the batch into microbatches
    (one microbatch of activations resident at a time) with token-share
    weighted accumulation: the same update for a fraction of the memory.

    Optimizer resolution: an explicit ``optimizer`` wins, else the one
    the state was built with, else the module default. Metrics are 0-d
    tensors on the params' device (no host sync here)."""
    new_state, metrics, _ = _run_step(
        state, config, mesh, tokens, completion_mask, rewards, group_ids,
        old_logp=old_logp, ref_logp=ref_logp,
        branch_mask=branch_mask, grpo_config=grpo_config,
        optimizer=optimizer, num_groups=num_groups,
        accum_steps=accum_steps, lora_base=lora_base)
    return new_state, metrics


def train_step_guarded(state: TrainState, config: ModelConfig, mesh,
                       tokens, completion_mask, rewards, group_ids, *,
                       guard, **kwargs
                       ) -> Tuple[TrainState, Dict[str, float],
                                  Optional[str]]:
    """``train_step`` behind a resilience.UpdateGuard.

    Computes the gradients, syncs the metrics to host floats and asks
    ``guard`` whether to apply them. Returns ``(state, float_metrics,
    skip_reason)``: on a veto the optimizer never runs, so the returned
    state is the INPUT state with its params and moments untouched (what
    the JAX package's version gets by keeping the pre-step state), and
    ``skip_reason`` is the guard's verdict; otherwise ``skip_reason`` is
    None. A ``guard`` of None degrades to plain train_step with float
    metrics."""
    new_state, metrics, reason = _run_step(
        state, config, mesh, tokens, completion_mask, rewards, group_ids,
        check=guard.check if guard is not None else None, **kwargs)
    return new_state, _host_metrics(metrics), reason
