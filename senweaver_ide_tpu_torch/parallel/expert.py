"""Top-k routed mixture-of-experts FFN (PyTorch port): on one device,
inside the model's forward on a mesh, and expert-parallel over 'ep'.

Routing: softmax router → top-k experts per token → capacity-bounded
dispatch (capacity = ceil(tokens/E · capacity_factor · top_k)); an
assignment past its expert's capacity falls through with zero
contribution, and the gates are renormalised over the selected k before
any drop. Earlier tokens of the flat batch win capacity slots, so the
output of a token depends on the batch it ran in; on a mesh that batch
is the global one, as in the JAX version, whatever the data ranks
(:func:`_route`). The aux load-balancing loss is the Switch formulation,
E · Σ_e f_e · p_e.

The JAX version builds one-hot ``(T, E, C)`` dispatch and combine
tensors and contracts them with einsums. Here the kept assignments are
gathered into an ``(E, C, D)`` buffer by index, the experts run as one
batched matmul over E, and each token sums its k gated outputs: the same
function without the one-hot tensors (1.34 GB a layer for one 2048-token
Qwen3-30B-A3B prefill). No index leaves the device, so a step does not
wait on the host.

:func:`moe_ffn_sharded` is JAX's expert-parallel path: tokens and
experts both split over 'ep', two all-to-alls of the (E, C, D) buffer
per call (``parallel/comm.py``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple, Tuple

import torch

from ..device import resolve_device
from .mesh import DATA_AXES

MoEParams = Dict[str, torch.Tensor]
# the axes whose ranks hold different tokens of the batch: rows over the
# data axes, the sequence over sp
TOKEN_AXES = DATA_AXES + ("sp",)


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    hidden_size: int
    intermediate_size: int
    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    dtype: torch.dtype = torch.float32


def init_moe_params(cfg: MoEConfig, generator: torch.Generator, *,
                    device="cuda") -> MoEParams:
    """Router (D, E) and expert banks (E, D, F) / (E, F, D): normal /
    sqrt(fan_in), drawn in fp32 from ``generator`` (which must live on
    ``device``), then cast to ``cfg.dtype``."""
    D, F, E = cfg.hidden_size, cfg.intermediate_size, cfg.num_experts
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"generator is on {generator.device}, params on "
                         f"{dev}")

    def dense(shape, fan_in):
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=dev)
        return (w / math.sqrt(fan_in)).to(cfg.dtype)

    return {
        "router": dense((D, E), D),
        "w_gate": dense((E, D, F), D),
        "w_up": dense((E, D, F), D),
        "w_down": dense((E, F, D), F),
    }


class Routing(NamedTuple):
    """One flat batch's routing decisions."""

    gates: torch.Tensor        # (T, k) fp32, renormalised over the k picks
    expert_idx: torch.Tensor   # (T, k) int64, probability order
    pos_in_expert: torch.Tensor  # (T, k) int64 slot in the expert's buffer
    keep: torch.Tensor         # (T, k) bool: pos_in_expert < capacity
    aux: torch.Tensor          # () fp32 Switch load-balance loss


def _positions(expert_idx: torch.Tensor, num_experts: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(slot of each (token, k) in its expert's buffer, assignments per
    expert) for ``expert_idx`` (T, k) in batch order: the slot is the
    count of earlier assignments to the same expert, token-major then k.
    The one-hot is scattered: F.one_hot checks its indices on the host, a
    device sync in every layer."""
    T, k = expert_idx.shape
    idx = expert_idx.reshape(T * k, 1)
    flat = torch.zeros((T * k, num_experts), dtype=torch.int32,
                       device=idx.device)
    flat.scatter_(1, idx, 1)
    before = torch.cumsum(flat, dim=0, dtype=torch.int32) - flat
    pos = before.gather(1, idx).reshape(T, k).long()
    return pos, flat.sum(0)


def _route(cfg: MoEConfig, router: torch.Tensor, x_flat: torch.Tensor,
           capacity: int, mesh=None, rows: int = 1) -> Routing:
    """x_flat (T, D) → routing. The router runs in fp32.

    With a ``mesh`` whose data axes (dp, fsdp, sp) span several ranks,
    ``x_flat`` is this rank's ``rows`` rows of its sequence chunk and the
    routing is the one-rank routing of the global batch, restricted to
    these tokens: the (T, k) expert picks are gathered over the data axes
    into the global flat (B, S) order, slots are counted over every
    token, and the aux loss is taken from the global per-expert counts
    and probability sums (the latter summed with an identity backward:
    each rank's router gradient is its own tokens' part)."""
    T, E, k = x_flat.shape[0], cfg.num_experts, cfg.top_k
    logits = x_flat.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)                   # (T, E)
    gate_vals, expert_idx = torch.topk(probs, k, dim=-1)    # (T, k)
    gate_vals = gate_vals / torch.clamp_min(
        gate_vals.sum(-1, keepdim=True), 1e-9)
    if mesh is None or mesh.axis_size(TOKEN_AXES) == 1:
        pos, counts = _positions(expert_idx, E)
        frac = counts.float() / T                           # (E,)
        aux = (frac * probs.mean(0)).sum() * E
        return Routing(gate_vals, expert_idx, pos, pos < capacity, aux)
    from .comm import gather_grid, reduce_from
    s = T // rows
    picks = gather_grid(expert_idx.view(rows, s, k), mesh, DATA_AXES,
                        ("sp",), 0, 1)                      # (B, S, k)
    n_rows, n_cols = picks.shape[:2]
    pos_all, counts = _positions(picks.reshape(n_rows * n_cols, k), E)
    dev = x_flat.device
    r0, c0 = mesh.coord(DATA_AXES) * rows, mesh.coord("sp") * s
    mine = ((r0 + torch.arange(rows, device=dev))[:, None] * n_cols
            + c0 + torch.arange(s, device=dev)[None, :]).reshape(-1)
    pos = pos_all[mine]
    n = n_rows * n_cols
    prob_sum = reduce_from(probs.sum(0), mesh, TOKEN_AXES)
    aux = ((counts.float() / n) * (prob_sum / n)).sum() * E
    return Routing(gate_vals, expert_idx, pos, pos < capacity, aux)


def _expert_ffn(w_gate, w_up, w_down, h):
    """h (..., C, D) through one expert (D, F) or a bank (E, D, F) with
    h (E, C, D): matmul broadcasts the expert axis."""
    gate = h @ w_gate
    up = h @ w_up
    act = torch.nn.functional.silu(gate.float()).to(h.dtype) * up
    return act @ w_down


def _expert_ffn_q(w_gate, g_s, w_up, u_s, w_down, d_s, h):
    """int8 bank variant (models/quantize.py): upcast at use, then the
    per-output-channel scale on the output."""
    def mm(h_, w, s_):
        out = h_ @ w.to(h_.dtype)
        return (out.float() * s_.unsqueeze(-2)).to(h_.dtype)

    gate = mm(h, w_gate, g_s)
    up = mm(h, w_up, u_s)
    act = torch.nn.functional.silu(gate.float()).to(h.dtype) * up
    return mm(act, w_down, d_s)


def _run_experts(params: MoEParams, expert_in: torch.Tensor) -> torch.Tensor:
    """(E, C, D) through every expert at once, int8-aware."""
    if params["w_gate"].dtype == torch.int8:
        return _expert_ffn_q(
            params["w_gate"], params["w_gate_scale"],
            params["w_up"], params["w_up_scale"],
            params["w_down"], params["w_down_scale"], expert_in)
    return _expert_ffn(params["w_gate"], params["w_up"], params["w_down"],
                       expert_in)


def _capacity(cfg: MoEConfig, tokens: int) -> int:
    return max(1, math.ceil(tokens / cfg.num_experts
                            * cfg.capacity_factor * cfg.top_k))


def _dispatch(x_flat: torch.Tensor, r: Routing, num_experts: int,
              capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kept assignments gathered into an ``(E, C, D)`` buffer, and
    each assignment's row in it: a dropped assignment addresses the spare
    row E·C, which no expert reads."""
    t, d = x_flat.shape
    E, C, k = num_experts, capacity, r.expert_idx.shape[1]
    slot = torch.where(r.keep, r.expert_idx * C + r.pos_in_expert,
                       E * C).reshape(t * k)
    tok = torch.arange(t, device=x_flat.device)[:, None].expand(
        t, k).reshape(-1)
    buf = x_flat.new_zeros((E * C + 1, d)).index_put((slot,), x_flat[tok])
    return buf[:E * C].view(E, C, d), slot


def _combine(out: torch.Tensor, slot: torch.Tensor, r: Routing
             ) -> torch.Tensor:
    """Each token's gated sum of its k expert outputs (``out`` (E, C, D);
    the spare row is zero) → (T, D) fp32."""
    E, C, d = out.shape
    t, k = r.gates.shape
    out = torch.cat([out.reshape(E * C, d), out.new_zeros((1, d))])
    w = (r.gates * r.keep).reshape(t * k, 1)
    return (out[slot].float() * w).view(t, k, d).sum(1)


def moe_ffn(params: MoEParams, cfg: MoEConfig, x: torch.Tensor, *,
            mesh=None, rows_split: bool = True
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) → (out (B, S, D), aux loss). The capacity counts every
    row of the flat B·S batch, padding included.

    With a ``mesh`` (the model's forward on a mesh), ``x`` is replicated
    over ``ep`` and ``tp``, the banks are this rank's local shards (E/ep
    experts, F/tp columns), and the result is this rank's block of the
    one-device result: each rank dispatches its own tokens, runs its own
    experts on the buffer (sums over tp), and the expert outputs are
    all-gathered over ep before the combine. ``rows_split`` says what
    ``x`` is over the data axes. True (the no-cache forward, the
    trainer's): this rank's rows and sequence chunk of the global batch
    over dp, fsdp and sp, routed as the GLOBAL batch: the capacity, the
    slots, the drops and the aux loss count every token of every data
    rank (:func:`_route`), and the buffer has the global capacity. False
    (the cache forward, the engine's): the whole batch, replicated over
    the data axes, which every rank routes alike."""
    from .comm import copy_to, gather_grid, reduce_from
    b, s, d = x.shape
    t, E = b * s, cfg.num_experts
    x_flat = x.reshape(t, d)
    data = mesh if rows_split else None
    n_data = 1 if data is None else data.axis_size(TOKEN_AXES)
    C = _capacity(cfg, t * n_data)
    r = _route(cfg, params["router"], x_flat, C, data, rows=b)
    n_local = params["w_gate"].shape[0]
    split = mesh is not None and n_local < E
    # the expert path's input: its gradient sums over the ranks whose
    # experts read it
    h = copy_to(copy_to(x_flat, mesh if split else None, "ep"), mesh, "tp")
    buf, slot = _dispatch(h, r, E, C)
    if split:
        e0 = mesh.coord("ep") * n_local
        out = _run_experts(params, buf[e0:e0 + n_local])
        out = gather_grid(reduce_from(out, mesh, "tp"), mesh, ("ep",))
    else:
        out = reduce_from(_run_experts(params, buf), mesh, "tp")
    y = _combine(out, slot, r)
    return y.view(b, s, d).to(x.dtype), r.aux


def moe_ffn_sharded(params: MoEParams, cfg: MoEConfig, x: torch.Tensor, *,
                    mesh) -> Tuple[torch.Tensor, torch.Tensor]:
    """The expert-parallel path: tokens AND experts split over the mesh's
    'ep' axis, two all-to-alls per call.

    ``x`` is this rank's (B/ep, S, D) rows; the router is replicated and
    the banks are this rank's E/ep experts (a full (E, ...) bank is cut to
    them here). Each rank routes its own tokens with the capacity of its
    own B/ep·S tokens, dispatches into an (E, C, D) buffer, and the first
    all-to-all sends expert block j to rank j: (E, C, D) → (E/ep, ep·C,
    D). The return trip undoes it. The aux loss is averaged over ep.
    Returns (out (B/ep, S, D), aux)."""
    from .comm import all_to_all, reduce_from
    ep = mesh.axis_size("ep")
    E = cfg.num_experts
    if E % ep != 0:
        raise ValueError(f"num_experts {E} not divisible by ep={ep}")
    el = E // ep
    banks = {}
    for n in ("w_gate", "w_up", "w_down", "w_gate_scale", "w_up_scale",
              "w_down_scale"):
        if n in params:
            w = params[n]
            if w.shape[0] == E and el != E:
                w = w[mesh.coord("ep") * el:(mesh.coord("ep") + 1) * el]
            banks[n] = w
    b, s, d = x.shape
    t = b * s
    x_flat = x.reshape(t, d)
    C = _capacity(cfg, t)
    r = _route(cfg, params["router"], x_flat, C)
    buf, slot = _dispatch(x_flat, r, E, C)
    # (E, C, D) → per-destination blocks (ep, E/ep, C, D) → received per
    # source → (E/ep, ep·C, D)
    got = all_to_all(buf.reshape(ep, el, C, d), mesh, "ep")
    got = got.permute(1, 0, 2, 3).reshape(el, ep * C, d)
    out = _run_experts(banks, got)
    out = out.reshape(el, ep, C, d).permute(1, 0, 2, 3).contiguous()
    back = all_to_all(out, mesh, "ep").reshape(E, C, d)
    y = _combine(back, slot, r)
    aux = reduce_from(r.aux, mesh, "ep") / ep
    return y.view(b, s, d).to(x.dtype), aux
