"""Process-group initialization and named meshes (PyTorch port).

The JAX package calls ``jax.distributed.initialize`` once per host and
lets XLA lower collectives; the port runs one process per rank and
initializes ``torch.distributed`` from torchrun's environment
(``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``) or from an
explicit :class:`DistributedConfig`. A single process is a no-op.

The backend is explicit: NCCL for CUDA with one card per rank, gloo for
the CPU. Gloo on CUDA tensors (two ranks sharing one card) is used only
when the caller names it; there is no silent switch.

Mesh construction orders axes slowest → fastest (``AXIS_ORDER``), so the
axes whose collectives move the most bytes per step sit on neighbouring
ranks (torchrun numbers ranks node by node).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .mesh import Mesh, _all_ranks, reset_groups


@dataclasses.dataclass(frozen=True)
class DistributedConfig:
    coordinator_address: Optional[str] = None   # host:port of rank 0
    num_processes: Optional[int] = None
    process_id: Optional[int] = None
    # "nccl" | "gloo"; None: nccl for a CUDA device, gloo for the CPU
    backend: Optional[str] = None
    device: str = "cuda"


def default_backend(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize(cfg: DistributedConfig = DistributedConfig()) -> None:
    """Idempotent ``torch.distributed`` init. The explicit fields win over
    torchrun's environment; without an address or with one process it
    does nothing. With NCCL, each rank takes the card ``LOCAL_RANK``."""
    if dist.is_initialized():
        return
    addr = cfg.coordinator_address
    if addr is None and "MASTER_ADDR" in os.environ \
            and "MASTER_PORT" in os.environ:
        addr = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    nproc = cfg.num_processes if cfg.num_processes is not None else (
        int(os.environ["WORLD_SIZE"]) if "WORLD_SIZE" in os.environ
        else None)
    if addr is None or nproc in (None, 1):
        return
    rank = (cfg.process_id if cfg.process_id is not None
            else int(os.environ.get("RANK", "0")))
    backend = cfg.backend or default_backend(cfg.device)
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
    dist.init_process_group(backend, init_method=f"tcp://{addr}",
                            world_size=nproc, rank=rank)


def shutdown() -> None:
    """Destroy the process group and forget the mesh groups."""
    if dist.is_initialized():
        dist.destroy_process_group()
    reset_groups()


# Axis order: slowest (across nodes) → fastest (neighbouring ranks).
AXIS_ORDER: Tuple[str, ...] = ("dp", "fsdp", "pp", "ep", "sp", "tp")


def make_named_mesh(axis_sizes: dict, *,
                    devices: Optional[Sequence[int]] = None) -> Mesh:
    """A mesh with any subset of the canonical axes.

    ``make_named_mesh({'dp': 2, 'tp': 4})`` on 8 ranks → Mesh('dp','tp').
    The axis product must equal the rank count."""
    devices = _all_ranks(devices)
    names = [a for a in AXIS_ORDER if axis_sizes.get(a, 1) > 1]
    sizes = [axis_sizes[a] for a in names]
    if not names:                      # single-axis fallback
        names, sizes = ["dp"], [len(devices)]
    total = int(np.prod(sizes))
    if total != len(devices):
        raise ValueError(f"axis product {total} != device count "
                         f"{len(devices)} for {dict(zip(names, sizes))}")
    return Mesh(np.asarray(devices).reshape(sizes), tuple(names))
