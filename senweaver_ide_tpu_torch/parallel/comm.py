"""Collectives over a mesh's axes, and the autograd pairs built on them.

JAX inserts collectives from shardings; the port calls them by name. Each
function here takes a :class:`~.mesh.Mesh` and the axes to communicate
over, and is the identity when those axes span one rank (no group).

Each (backend, device) has a fixed route per collective (:func:`_route`),
recorded in :data:`ROUTES` under ``"<backend>/<device>/<collective>"``:

- NCCL on CUDA tensors (one card per rank) and gloo on CPU tensors: every
  collective native;
- gloo on CUDA tensors, used only when the caller names it (two ranks
  sharing one card): ``all_reduce``, ``all_gather``, ``broadcast`` and
  ``all_to_all_single`` native, as measured on an H100; point-to-point
  sends (``send_recv``) staged through pinned host memory, since gloo
  accepts CUDA tensors there and then fails inside its TCP transport,
  leaving the connection broken;
- any other backend and device: refused with an error.

Reduce-scatter is NCCL's ``reduce_scatter_tensor``; over gloo it is an
all-reduce followed by this rank's slice (gloo's reduce-scatter is
deprecated under one name and absent under the other across the torch
versions the port meets).

The autograd functions are Megatron's pairs and their gather cousins:

- :func:`copy_to` — identity forward, all-reduce backward (the input of
  a column-parallel matmul, replicated over the axes);
- :func:`reduce_from` — all-reduce forward, identity backward (the
  output of a row-parallel matmul);
- :func:`gather_weight` — all-gather forward, reduce-scatter backward
  (an fsdp-sharded weight gathered for use);
- :func:`gather_grid` — all-gather forward over row and column axes,
  own-block backward (a value every rank then uses alike);
- :func:`all_to_all` and :func:`ring_shift`, each undone by its own
  inverse in the backward.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from .mesh import Mesh

ROUTES: Dict[str, str] = {}

# gloo's route for each collective on CUDA tensors
_GLOO_CUDA = {"all_reduce": "native", "all_gather": "native",
              "broadcast": "native", "all_to_all_single": "native",
              "send_recv": "host"}


def _route(name: str, group, t: torch.Tensor) -> str:
    """``"native"`` or ``"host"`` for collective ``name`` of tensor ``t``
    over ``group``, recorded in :data:`ROUTES`; raises for a backend and
    device with no route."""
    backend, dev = dist.get_backend(group), t.device.type
    if (backend, dev) in (("nccl", "cuda"), ("gloo", "cpu")):
        route = "native"
    elif (backend, dev) == ("gloo", "cuda"):
        route = _GLOO_CUDA[name]
    else:
        raise RuntimeError(f"no route for {name} of {dev} tensors over "
                           f"{backend}")
    ROUTES[f"{backend}/{dev}/{name}"] = route
    return route


def _host(t: torch.Tensor) -> torch.Tensor:
    """A pinned host copy of a card tensor."""
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)
    return h


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def all_reduce(x: torch.Tensor, mesh: Mesh, axes, op: str = "sum"
               ) -> torch.Tensor:
    """A reduced copy of ``x`` over ``axes``."""
    group = mesh.group(axes)
    if group is None:
        return x
    y = x.contiguous().clone()
    _route("all_reduce", group, y)
    dist.all_reduce(y, op=_OPS[op], group=group)
    return y


def all_gather(x: torch.Tensor, mesh: Mesh, axes,
               dim: Optional[int] = 0) -> List[torch.Tensor] | torch.Tensor:
    """Every rank's ``x`` over ``axes``, in coordinate order: concatenated
    along ``dim``, or as a list when ``dim`` is None."""
    group = mesh.group(axes)
    if group is None:
        return x if dim is not None else [x]
    src = x.contiguous()
    _route("all_gather", group, src)
    outs = [torch.empty_like(src) for _ in range(mesh.axis_size(axes))]
    dist.all_gather(outs, src, group=group)
    return outs if dim is None else torch.cat(outs, dim=dim)


def reduce_scatter(x: torch.Tensor, mesh: Mesh, axes,
                   dim: int) -> torch.Tensor:
    """The sum of ``x`` over ``axes``, split along ``dim``: this rank's
    part."""
    group = mesh.group(axes)
    if group is None:
        return x
    part = x.shape[dim] // mesh.axis_size(axes)
    if dist.get_backend(group) == "nccl":
        _route("reduce_scatter", group, x)
        src = x.movedim(dim, 0).contiguous()
        out = src.new_empty((part,) + src.shape[1:])
        dist.reduce_scatter_tensor(out, src, group=group)
        return out.movedim(0, dim).contiguous()
    total = all_reduce(x, mesh, axes)
    return total.narrow(dim, mesh.coord(axes) * part, part).contiguous()


def broadcast(x: torch.Tensor, mesh: Mesh, axes, src_coord: int = 0
              ) -> torch.Tensor:
    """The tensor of the rank at coordinate ``src_coord`` over ``axes``."""
    group = mesh.group(axes)
    if group is None:
        return x
    y = x.contiguous().clone()
    _route("broadcast", group, y)
    dist.broadcast(y, src=dist.get_global_rank(group, src_coord),
                   group=group)
    return y


def broadcast_object(obj, mesh: Mesh, axes, src_coord: int = 0):
    """A picklable object from the rank at ``src_coord`` over ``axes``."""
    group = mesh.group(axes)
    if group is None:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=dist.get_global_rank(group,
                                                             src_coord),
                               group=group)
    return box[0]


def _all_to_all_raw(x: torch.Tensor, mesh: Mesh, axes) -> torch.Tensor:
    """``x``'s dim 0 split in n equal parts, part j to rank j; the parts
    received are stacked along dim 0 in coordinate order."""
    group = mesh.group(axes)
    if group is None:
        return x
    src = x.contiguous()
    _route("all_to_all_single", group, src)
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    return out


def _shift_raw(x: torch.Tensor, mesh: Mesh, axis: str,
               step: int) -> torch.Tensor:
    """The ``x`` of the rank ``step`` places back along ``axis`` (each rank
    sends its own ``step`` places forward, a ring)."""
    group = mesh.group(axis)
    if group is None:
        return x
    n = mesh.axis_size(axis)
    me = mesh.coord(axis)
    to = dist.get_global_rank(group, (me + step) % n)
    frm = dist.get_global_rank(group, (me - step) % n)
    src = x.contiguous()
    host = _route("send_recv", group, src) == "host"
    if host:
        src = _host(src)
    out = torch.empty_like(src)
    ops = [dist.P2POp(dist.isend, src, to, group),
           dist.P2POp(dist.irecv, out, frm, group)]
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    return out.to(x.device) if host else out


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.mesh, ctx.axes), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return all_reduce(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherWeight(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return all_gather(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return (reduce_scatter(g, ctx.mesh, ctx.axes, ctx.dim), None, None,
                None)


def _grid(parts: List[torch.Tensor], n_rows: int, n_cols: int,
          row_dim: int, col_dim: int) -> torch.Tensor:
    rows = [torch.cat(parts[r * n_cols:(r + 1) * n_cols], dim=col_dim)
            for r in range(n_rows)]
    return torch.cat(rows, dim=row_dim)


class _GatherGrid(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, row_axes, col_axes, row_dim, col_dim):
        ctx.shape = x.shape
        ctx.rc = (mesh.coord(row_axes), mesh.coord(col_axes))
        ctx.dims = (row_dim, col_dim)
        n_rows, n_cols = mesh.axis_size(row_axes), mesh.axis_size(col_axes)
        if n_rows * n_cols == 1:
            return x.view_as(x)
        parts = all_gather(x, mesh, tuple(row_axes) + tuple(col_axes),
                           dim=None)
        return _grid(parts, n_rows, n_cols, row_dim, col_dim)

    @staticmethod
    def backward(ctx, g):
        (r, c), (rd, cd) = ctx.rc, ctx.dims
        g = g.narrow(rd, r * ctx.shape[rd], ctx.shape[rd])
        g = g.narrow(cd, c * ctx.shape[cd], ctx.shape[cd])
        return g, None, None, None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return _all_to_all_raw(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all_raw(g, ctx.mesh, ctx.axes), None, None


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, step):
        ctx.mesh, ctx.axis, ctx.step = mesh, axis, step
        return _shift_raw(x, mesh, axis, step)

    @staticmethod
    def backward(ctx, g):
        return _shift_raw(g, ctx.mesh, ctx.axis, -ctx.step), None, None, None


def _trivial(mesh: Optional[Mesh], axes) -> bool:
    return mesh is None or mesh.group(axes) is None


def copy_to(x: torch.Tensor, mesh: Optional[Mesh], axes) -> torch.Tensor:
    """Identity forward; the backward sums the gradient over ``axes``."""
    return x if _trivial(mesh, axes) else _CopyTo.apply(x, mesh, axes)


def reduce_from(x: torch.Tensor, mesh: Optional[Mesh], axes
                ) -> torch.Tensor:
    """Sum over ``axes`` forward; identity backward."""
    return x if _trivial(mesh, axes) else _ReduceFrom.apply(x, mesh, axes)


def gather_weight(x: torch.Tensor, mesh: Optional[Mesh], axes,
                  dim: int) -> torch.Tensor:
    """All-gather along ``dim`` forward; the backward reduce-scatters the
    gradient back to this rank's shard."""
    if _trivial(mesh, axes):
        return x
    return _GatherWeight.apply(x, mesh, axes, dim)


def gather_grid(x: torch.Tensor, mesh: Optional[Mesh], row_axes,
                col_axes=(), row_dim: int = 0, col_dim: int = 1
                ) -> torch.Tensor:
    """Every rank's block of a grid: blocks over ``row_axes`` stack along
    ``row_dim``, over ``col_axes`` along ``col_dim``. The backward keeps
    this rank's block of the gradient: every rank must go on to compute
    the same function of the whole."""
    if mesh is None:
        return x
    return _GatherGrid.apply(x, mesh, tuple(row_axes), tuple(col_axes),
                             row_dim, col_dim)


def all_to_all(x: torch.Tensor, mesh: Optional[Mesh], axes
               ) -> torch.Tensor:
    """Dim-0 all-to-all (equal parts), differentiable."""
    return x if _trivial(mesh, axes) else _AllToAll.apply(x, mesh, axes)


def ring_shift(x: torch.Tensor, mesh: Optional[Mesh], axis: str,
               step: int = 1) -> torch.Tensor:
    """The ``x`` of the rank ``step`` places back on ``axis``'s ring,
    differentiable (the backward shifts the gradient the other way)."""
    if _trivial(mesh, axis):
        return x
    if not x.requires_grad:
        return _shift_raw(x, mesh, axis, step)
    return _RingShift.apply(x, mesh, axis, step)
