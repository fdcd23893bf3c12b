"""Pipeline parallelism (PyTorch port): GPipe and 1F1B microbatched stages
over a mesh's 'pp' axis.

The transformer blocks are cut along their stacked layer axis into K
stages (:func:`split_layers_for_stages`), each rank of the 'pp' axis keeps
its own stage (:func:`place_pipeline_params`), and activations move
stage to stage with ``comm.ring_shift``, the port's ``ppermute`` ring
(point-to-point sends; over gloo on CUDA tensors they are staged through
pinned host memory, ``comm.ROUTES["gloo/cuda/send_recv"]``). Each stage
runs the model's own layer function (``models/transformer.py::_layer``),
so on the card every layer's attention is the flash kernels' forward,
dK/dV and dQ, and on the CPU their plain versions.

- GPipe (:func:`pipeline_forward`): M microbatches drain through K
  stages in M+K−1 ticks; stage k works on microbatch t−k at tick t and
  idles (passes its input on) outside it. Differentiable: ring_shift's
  backward is the reverse shift, so the backward pass is the reverse
  pipeline. Every rank of the 'pp' group builds the same chain of shifts,
  idle ticks included, so their sends and receives pair in the forward
  and in the backward.
- 1F1B (:func:`pipeline_train_grads_1f1b`): at tick t stage k runs the
  forward of microbatch t−k and the backward of microbatch t−(2K−1)+k, in
  M+2K−1 ticks; a ``min(M, 2K)``-slot buffer keeps stage inputs and each
  backward tick recomputes its stage under autograd. Its backward is
  explicit (``torch.autograd.grad`` of the stage, or of the last stage's
  head and loss); two streams move a tick, activations forward and
  cotangents back, on every rank every tick.

The embedding, final norm and LM head are replicated and run outside the
stages, as in the JAX version; over the mesh's other axes the pipeline is
replicated too (JAX's ``shard_map`` with ``P()`` specs). Dense models
only: a routed layer's load-balance loss is not carried through the
stages.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Tuple

import torch

from .comm import all_gather, all_reduce, copy_to, reduce_from, ring_shift
from .mesh import Mesh, NamedSharding

Params = Dict[str, object]


def split_layers_for_stages(params: Params, n_stages: int) -> Params:
    """Reshape stacked layer tensors (L, ...) → (n_stages, L//n_stages,
    ...) (views). The leading stage axis is what goes over 'pp'."""
    from ..models.quantize import is_quantized
    if is_quantized(params):
        # the stages' matmuls take the weights as they are: refuse int8
        raise TypeError("pipeline stages do not support int8-quantized "
                        "params (models/quantize.py is a serving-path "
                        "transform); pass full-precision params")
    if any("_lora_" in name for name in params["layers"]):
        # adapter leaves would reshape into stages and ride along but
        # never be applied: the pipeline would serve the base policy
        raise TypeError("pipeline stages do not apply LoRA adapter "
                        "leaves; fold them first (training.lora."
                        "materialize_lora) and pass the plain params")
    L = next(iter(params["layers"].values())).shape[0]
    if L % n_stages != 0:
        raise ValueError(f"num_layers {L} not divisible by {n_stages} "
                         "pipeline stages")
    per = L // n_stages
    out = dict(params)
    out["layers"] = {n: v.reshape((n_stages, per) + tuple(v.shape[1:]))
                     for n, v in params["layers"].items()}
    return out


def _spec_tree(node, spec):
    if isinstance(node, Mapping):
        return {k: _spec_tree(v, spec) for k, v in node.items()}
    return spec


def stage_param_specs(params: Params) -> Params:
    """Specs (the port's tuples): stage-split layers on 'pp', everything
    else replicated."""
    return {k: _spec_tree(v, ("pp",) if k == "layers" else ())
            for k, v in params.items()}


def place_pipeline_params(params: Params, mesh: Mesh) -> Params:
    """This rank's part of pre-split params: its stage of every layer
    tensor, (1, L/K, ...), and copies of the replicated tensors."""
    specs = stage_param_specs(params)

    def place(node, spec):
        if isinstance(node, Mapping):
            return {k: place(v, spec[k]) for k, v in node.items()}
        return NamedSharding(mesh, spec).local(node).contiguous().clone()

    return place(params, specs)


def gather_pipeline_params(params: Params, mesh: Mesh) -> Params:
    """The inverse of :func:`place_pipeline_params`: every stage's layer
    tensors, (K, L/K, ...), on every rank of the 'pp' group."""
    out = dict(params)
    with torch.no_grad():
        out["layers"] = {n: all_gather(v, mesh, "pp", 0)
                         for n, v in params["layers"].items()}
    return out


def _stage_layers(params: Params, mesh: Mesh) -> Dict[str, torch.Tensor]:
    """This rank's stage, (L/K, ...) per tensor, from placed (1, L/K, ...)
    layer tensors."""
    out = {}
    for n, v in params["layers"].items():
        if v.shape[0] != 1:
            raise ValueError(
                f"layers/{n} holds {v.shape[0]} stages; pass this rank's "
                f"(split_layers_for_stages, then place_pipeline_params on "
                f"a mesh with pp={mesh.axis_size('pp')})")
        out[n] = v[0]
    return out


def _stage_apply(c, layers: Mapping[str, Tuple[torch.Tensor, ...]],
                 h: torch.Tensor, cos, sin, mask, remat: bool = False
                 ) -> torch.Tensor:
    """``h`` through this stage's layers (``layers``: each tensor unbound
    into its per-layer views)."""
    from torch.utils.checkpoint import checkpoint

    from ..models.transformer import _layer
    n = len(next(iter(layers.values())))
    for i in range(n):
        lp = {k: v[i] for k, v in layers.items()}
        if remat:
            h, _ = checkpoint(_layer, c, lp, h, cos, sin, mask,
                              use_reentrant=False)
        else:
            h, _ = _layer(c, lp, h, cos, sin, mask)
    return h


def _rope(c, b: int, s: int, device):
    from ..ops.rotary import rope_cos_sin
    positions = torch.arange(s, dtype=torch.int32,
                             device=device)[None, :].expand(b, s)
    return rope_cos_sin(positions, c.head_dim, c.rope_theta,
                        scaling=c.rope_scaling)


def pipeline_forward(params: Params, config, tokens: torch.Tensor, *,
                     mesh: Mesh, n_microbatches: int = 4,
                     attn_mask: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Full forward with the transformer blocks pipelined over 'pp'
    (GPipe). ``params`` are split (:func:`split_layers_for_stages`) and
    placed (:func:`place_pipeline_params`); ``tokens`` (B, S) and
    ``attn_mask`` (B, S, True on valid keys) are the whole batch on every
    rank, B divisible by ``n_microbatches``. Returns fp32 logits (B, S, V)
    on every rank of the 'pp' group.

    Under autograd every rank must differentiate the same function of the
    logits with respect to the same params (all of them): each rank's
    layer gradients are its stage's, the replicated tensors' are whole on
    every rank (the embedding lookup's part summed over 'pp')."""
    from ..models.transformer import _logits
    c = config
    K, stage = mesh.axis_size("pp"), mesh.coord("pp")
    M = n_microbatches
    b, s = tokens.shape
    if b % M != 0:
        raise ValueError(f"batch {b} not divisible by {M} microbatches")
    mb, d = b // M, c.hidden_size
    tokens = tokens.long()
    # the lookup's gradient lives on stage 0 alone: summed over pp, while
    # a tied head's use of the same table is whole on every rank
    x = copy_to(params["embed"], mesh, "pp")[tokens]
    cos, sin = _rope(c, b, s, tokens.device)
    mb_x = x.reshape(M, mb, s, d)
    mb_cos = cos.reshape((M, mb) + tuple(cos.shape[1:]))
    mb_sin = sin.reshape((M, mb) + tuple(sin.shape[1:]))
    mb_mask = (attn_mask.reshape((M, mb) + tuple(attn_mask.shape[1:]))
               if attn_mask is not None else None)
    layers = {k: torch.unbind(v)
              for k, v in _stage_layers(params, mesh).items()}
    remat = bool(c.remat) and torch.is_grad_enabled()
    first = torch.tensor(stage == 0, device=x.device)
    prev = torch.zeros((mb, s, d), dtype=x.dtype, device=x.device)
    outs = []
    for t in range(M + K - 1):
        recv = ring_shift(prev, mesh, "pp", 1)
        # stage k works on microbatch t - k: its mask and rope too
        i = t - stage
        ic = min(max(i, 0), M - 1)
        # the same graph on every rank (where, not a branch): the shifts
        # chain alike, so their backwards pair up across the ranks
        h = torch.where(first, mb_x[ic], recv)
        if 0 <= i < M:
            h = _stage_apply(c, layers, h, mb_cos[ic], mb_sin[ic],
                             None if mb_mask is None else mb_mask[ic],
                             remat)
        prev = h
        if t >= K - 1:
            outs.append(h)
    # stage K-1 produced microbatch m at tick m + K - 1: broadcast it
    last = torch.tensor(stage == K - 1, device=x.device)
    ys = torch.where(last, torch.stack(outs), torch.zeros((), dtype=x.dtype,
                                                          device=x.device))
    ys = reduce_from(ys, mesh, "pp")
    return _logits(params, c, ys.reshape(b, s, d))


def _mb_loss(logits: torch.Tensor, tgt: torch.Tensor, tmask: torch.Tensor,
             adv: torch.Tensor, denom: torch.Tensor, clip_eps: float
             ) -> torch.Tensor:
    """One microbatch's on-policy clipped term over the global token
    count (old_logp = logp.detach(): the ratio is 1)."""
    from ..training.grpo import token_logprobs
    logp = token_logprobs(logits, tgt)
    ratio = torch.exp(logp - logp.detach())
    adv = adv[:, None]
    unclipped = ratio * adv
    clipped = torch.clamp(ratio, 1.0 - clip_eps, 1.0 + clip_eps) * adv
    return -(torch.minimum(unclipped, clipped) * tmask).sum() / denom


def pipeline_train_grads_1f1b(params: Params, config, tokens: torch.Tensor,
                              completion_mask: torch.Tensor,
                              advantages: torch.Tensor, *, mesh: Mesh,
                              n_microbatches: int = 4,
                              clip_eps: float = 0.2
                              ) -> Tuple[torch.Tensor, Params]:
    """Loss and gradients with the 1F1B schedule (module docstring): the
    on-policy GRPO objective of ``pp_train_step``, each microbatch's term
    normalised by the GLOBAL completion-token count, so the sum over
    microbatches is the full-batch objective. Returns ``(loss, grads)``,
    equal on every rank of the 'pp' group: the grads in fp32, this rank's
    stage of the layers as (1, L/K, ...), the rest whole (a tied head's
    ``embed`` gets the lookup's and the head's parts)."""
    from ..models.transformer import _logits
    c = config
    K, stage = mesh.axis_size("pp"), mesh.coord("pp")
    last = K - 1
    M = n_microbatches
    b, s_full = tokens.shape
    if b % M != 0:
        raise ValueError(f"batch {b} not divisible by {M} microbatches")
    mb, d = b // M, c.hidden_size
    buf_slots = min(M, 2 * K)
    inputs, targets = tokens[:, :-1].long(), tokens[:, 1:].long()
    tgt_mask = completion_mask[:, 1:].float()
    s = s_full - 1
    denom = torch.clamp_min(tgt_mask.sum(), 1.0)          # GLOBAL
    tied = "lm_head" not in params
    head_w = params["embed"] if tied else params["lm_head"]
    norm_w = params["final_norm"]
    with torch.no_grad():
        x = params["embed"][inputs]                       # (B, S, D)
    cos, sin = _rope(c, mb, s, tokens.device)
    mb_x = x.reshape(M, mb, s, d)
    mb_tok = inputs.reshape(M, mb * s)
    mb_tgt = targets.reshape(M, mb, s)
    mb_tmask = tgt_mask.reshape(M, mb, s)
    mb_adv = advantages.reshape(M, mb).float()

    stage_lp = _stage_layers(params, mesh)
    names = sorted(stage_lp)
    live = [stage_lp[n].detach().requires_grad_() for n in names]
    layers = {n: torch.unbind(t) for n, t in zip(names, live)}
    frozen = {n: torch.unbind(stage_lp[n].detach()) for n in names}
    g_lp = [torch.zeros(t.shape, dtype=torch.float32, device=t.device)
            for t in live]
    g_embed = torch.zeros(params["embed"].shape, dtype=torch.float32,
                          device=x.device)
    g_head = torch.zeros(head_w.shape, dtype=torch.float32, device=x.device)
    g_norm = torch.zeros(norm_w.shape, dtype=torch.float32, device=x.device)
    loss_acc = torch.zeros((), dtype=torch.float32, device=x.device)
    fwd_stream = torch.zeros((mb, s, d), dtype=x.dtype, device=x.device)
    bwd_stream = torch.zeros_like(fwd_stream)
    saved: List[Optional[torch.Tensor]] = [None] * buf_slots
    for t in range(M + 2 * K - 1):
        # both streams move every tick on every rank, idle ones included
        recv_fwd = ring_shift(fwd_stream, mesh, "pp", 1)
        recv_bwd = ring_shift(bwd_stream, mesh, "pp", -1)

        # forward of microbatch t - stage (the last stage's output is
        # recomputed by its backward one tick later: not run here)
        mf = t - stage
        if 0 <= mf < M:
            h_in = mb_x[mf] if stage == 0 else recv_fwd
            saved[mf % buf_slots] = h_in
            if stage != last:
                with torch.no_grad():
                    fwd_stream = _stage_apply(c, frozen, h_in, cos, sin,
                                              None)

        # backward of microbatch t - (2K-1) + stage, recomputed
        mbk = t - (2 * K - 1) + stage
        if not 0 <= mbk < M:
            continue
        h_saved = saved[mbk % buf_slots].detach().requires_grad_()
        with torch.enable_grad():
            h_out = _stage_apply(c, layers, h_saved, cos, sin, None)
            if stage == last:
                hw = head_w.detach().requires_grad_()
                nw = norm_w.detach().requires_grad_()
                logits = _logits({"final_norm": nw,
                                  "embed" if tied else "lm_head": hw},
                                 c, h_out)
                loss_m = _mb_loss(logits, mb_tgt[mbk], mb_tmask[mbk],
                                  mb_adv[mbk], denom, clip_eps)
                got = torch.autograd.grad(loss_m, live + [h_saved, hw, nw])
                g_head += got[-2].float()
                g_norm += got[-1].float()
                loss_acc = loss_acc + loss_m.detach()
            else:
                got = torch.autograd.grad(h_out, live + [h_saved],
                                          grad_outputs=recv_bwd.to(
                                              h_out.dtype))
        for acc, g in zip(g_lp, got):
            acc += g.float()
        dh = got[len(live)]
        if stage == 0:
            # stage 0's input cotangent is the embedding rows'
            g_embed.index_add_(0, mb_tok[mbk], dh.reshape(-1, d).float())
        bwd_stream = dh.to(x.dtype)
        del got, h_out, h_saved

    # each shared tensor came from one stage: the sum is a broadcast
    shared = [g_embed, g_head, g_norm, loss_acc.reshape(1)]
    flat = all_reduce(torch.cat([g.reshape(-1) for g in shared]), mesh,
                      "pp")
    g_embed, g_head, g_norm, loss = (
        part.view_as(g) for part, g in zip(
            flat.split([g.numel() for g in shared]), shared))
    grads: Params = {"layers": {n: g[None] for n, g in zip(names, g_lp)},
                     "final_norm": g_norm}
    if tied:
        grads["embed"] = g_embed + g_head
    else:
        grads["embed"] = g_embed
        grads["lm_head"] = g_head
    return loss.reshape(()), grads


def make_pp_train_state(config, generator: Optional[torch.Generator] = None,
                        mesh: Optional[Mesh] = None, *,
                        learning_rate: float = 1e-5,
                        params: Optional[Params] = None, optimizer=None,
                        device="cuda"):
    """TrainState whose params are stage-split and this rank's stage (from
    ``generator`` on ``device``, or FULL ``params``); the Adam moments
    are shaped like them."""
    from ..models.transformer import init_params
    from ..training.trainer import TrainState, make_optimizer
    if mesh is None:
        raise ValueError("make_pp_train_state needs a mesh with a 'pp' axis")
    if params is None:
        if generator is None:
            raise ValueError("pass params or a generator to init them")
        params = init_params(config, generator, device=device)
    params = place_pipeline_params(
        split_layers_for_stages(params, mesh.axis_size("pp")), mesh)
    opt = optimizer or make_optimizer(learning_rate)
    return TrainState(params=params, opt_state=opt.init(params), step=0,
                      opt=opt)


def _pp_global_norm(grads: Params, mesh: Mesh) -> torch.Tensor:
    """The global norm of the whole gradient: the layer tensors' sums of
    squares summed over 'pp', the replicated tensors' counted once."""
    from ..training.trainer import flatten_params
    sq = [(n, (g.float() * g.float()).sum())
          for n, g in flatten_params(grads)]
    layer = [i for i, (n, _) in enumerate(sq) if n.startswith("layers/")]
    vals = [v for _, v in sq]
    if layer:
        summed = all_reduce(torch.stack([vals[i] for i in layer]), mesh,
                            "pp")
        for i, v in zip(layer, summed.unbind()):
            vals[i] = v
    return torch.sqrt(sum(vals))


def pp_gradients(params: Params, config, mesh: Mesh, tokens,
                 completion_mask, rewards, group_ids, *,
                 n_microbatches: int = 2, grpo_config=None,
                 num_groups: Optional[int] = None, schedule: str = "gpipe"
                 ) -> Tuple[Params, Dict[str, torch.Tensor]]:
    """The gradient half of :func:`pp_train_step`: ``(grads, metrics)``
    with ``loss`` and ``grad_norm`` (GPipe adds the objective's metrics),
    equal on every rank of the 'pp' group. Writes nothing."""
    from ..training.grpo import (GRPOConfig, group_relative_advantages,
                                 grpo_objective, token_logprobs)
    from ..training.trainer import (_as_tensor, flatten_params,
                                    unflatten_params)
    if schedule not in ("gpipe", "1f1b"):
        raise ValueError(f"unknown pipeline schedule {schedule!r}")
    grpo_config = grpo_config or GRPOConfig()
    dev = params["embed"].device
    tokens = _as_tensor(tokens, dev, torch.long)
    completion_mask = _as_tensor(completion_mask, dev, torch.bool)
    rewards = _as_tensor(rewards, dev, torch.float32)
    group_ids = _as_tensor(group_ids, dev, torch.long)
    n_groups = num_groups or int(tokens.shape[0])
    adv = group_relative_advantages(
        rewards, group_ids, n_groups,
        normalize_std=grpo_config.normalize_std,
        min_std=grpo_config.min_group_std,
        leave_one_out=grpo_config.leave_one_out)
    if schedule == "1f1b":
        loss, grads = pipeline_train_grads_1f1b(
            params, config, tokens, completion_mask, adv, mesh=mesh,
            n_microbatches=n_microbatches, clip_eps=grpo_config.clip_eps)
        metrics: Dict[str, torch.Tensor] = {}
    else:
        pairs = list(flatten_params(params))
        live = [t.detach().requires_grad_() for _, t in pairs]
        logits = pipeline_forward(
            unflatten_params(zip([n for n, _ in pairs], live)), config,
            tokens[:, :-1], mesh=mesh, n_microbatches=n_microbatches)
        logp = token_logprobs(logits, tokens[:, 1:])
        loss, metrics = grpo_objective(logp, logp.detach(), adv,
                                       completion_mask[:, 1:], grpo_config)
        got = torch.autograd.grad(loss, live)
        grads = unflatten_params((n, g) for (n, _), g in zip(pairs, got))
        loss = loss.detach()
        metrics = {k: v.detach() for k, v in metrics.items()}
    metrics["loss"] = loss
    metrics["grad_norm"] = _pp_global_norm(grads, mesh)
    return grads, metrics


def pp_train_step(state, config, mesh: Mesh, tokens, completion_mask,
                  rewards, group_ids, *, optimizer=None,
                  n_microbatches: int = 2, grpo_config=None,
                  num_groups: Optional[int] = None,
                  schedule: str = "gpipe"):
    """One GRPO update with the transformer blocks pipelined over 'pp':
    ``training.trainer.train_step``'s group-relative advantages and
    clipped objective (on-policy: the behaviour log-probs are the step's
    own). ``schedule`` is "gpipe" (:func:`pipeline_forward` under
    autograd; every stage holds its M microbatches' activations at the
    turn) or "1f1b" (:func:`pipeline_train_grads_1f1b`: the same loss and
    gradients, resident stage inputs bounded by the pipeline depth).

    ``state`` comes from :func:`make_pp_train_state`; params and moments
    are updated IN PLACE (the optimizer resolution of ``train_step``).
    Host arrays or tensors; every rank passes the whole batch. Dense
    models only."""
    from ..training.trainer import TrainState, make_optimizer
    grads, metrics = pp_gradients(
        state.params, config, mesh, tokens, completion_mask, rewards,
        group_ids, n_microbatches=n_microbatches, grpo_config=grpo_config,
        num_groups=num_groups, schedule=schedule)
    opt = optimizer or state.opt or make_optimizer()
    opt_state = opt.update(grads, state.opt_state, state.params,
                           metrics["grad_norm"])
    return TrainState(params=state.params, opt_state=opt_state,
                      step=state.step + 1, opt=opt), metrics
