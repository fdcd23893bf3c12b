"""Named rank meshes over ``torch.distributed`` (PyTorch port).

The JAX package builds a ``jax.sharding.Mesh`` of devices that one
controller drives; here every rank is a process of its own, and a
:class:`Mesh` is the same array of RANKS with JAX's axis names: the rank
at mesh coordinates ``c`` holds the shard that JAX's device at ``c``
holds. Ranks are laid out in JAX's device-array order (``np.reshape`` of
the rank list to the axis sizes, outermost axis first).

Canonical axes, as in the JAX package:

- ``dp``   — data parallel (batch rows; gradient all-reduce)
- ``fsdp`` — parameter/optimizer sharding, and a second data axis
- ``tp``   — tensor parallel (Megatron column/row sharding)
- ``sp``   — sequence parallel (ring attention, Ulysses all-to-all)
- ``ep``   — expert parallel (``make_named_mesh`` only)

A :class:`Mesh` creates its process groups when it is built, one per
combination of axes that the port's collectives reduce over; every rank
of the world must build the same meshes in the same order (the
``torch.distributed.new_group`` contract), members or not. A
``DeviceMesh`` would create per-axis groups too, but binds a device type
to the mesh and one card to each rank, which two ranks sharing one card
(the smoke check's layout) cannot satisfy; the axis names, the layout
and the per-axis groups here are those it would have.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch.distributed as dist

AXES = ("dp", "fsdp", "tp", "sp")
# rows of the batch shard over these; the sequence over "sp"
DATA_AXES = ("dp", "fsdp")

# process groups by their (ascending) rank tuple, shared by every mesh of
# this process so that two meshes over the same ranks reuse one group
# (process-wide, as torch.distributed's default group is)
_GROUPS: Dict[Tuple[int, ...], object] = {}


def _world() -> Tuple[int, int]:
    """(rank, world size); (0, 1) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _group_for(ranks: Tuple[int, ...]):
    """The process group over ``ranks``: None for one rank (collectives
    are then the identity) unless that rank is the whole world (a one-rank
    world's collectives still run through its backend), the world group
    when it is the world, else a group created on first request."""
    _, world = _world()
    if len(ranks) == world and ranks == tuple(range(world)) \
            and dist.is_initialized():
        return dist.group.WORLD
    if len(ranks) == 1:
        return None
    if ranks not in _GROUPS:
        _GROUPS[ranks] = dist.new_group(list(ranks))
    return _GROUPS[ranks]


def reset_groups() -> None:
    """Forget the cached groups (after the process group is destroyed)."""
    _GROUPS.clear()


class Mesh:
    """An array of ranks with named axes (the port's ``jax.sharding.Mesh``).

    ``devices`` is the int array of ranks, ``axis_names`` its axis names,
    ``shape`` the ``{name: size}`` dict. Absent axes have size 1 and
    coordinate 0. ``group(axes)`` is this rank's process group over the
    given axes (ranks that differ only there), in coordinate order."""

    def __init__(self, devices, axis_names: Sequence[str]):
        arr = np.asarray(devices, dtype=np.int64)
        names = tuple(axis_names)
        if arr.ndim != len(names):
            raise ValueError(f"{arr.ndim}-d rank array for axes {names}")
        flat = arr.reshape(-1)
        if flat.size > 1 and not (np.diff(flat) > 0).all():
            # group ranks are ordered by global rank: coordinate order
            # must agree with it for gathers to land in place
            raise ValueError(f"mesh ranks must ascend in layout order, got "
                             f"{flat.tolist()}")
        rank, world = _world()
        if flat.size > 1 and world == 1:
            raise ValueError(
                f"a mesh of {flat.size} ranks needs an initialized "
                f"torch.distributed process group "
                f"(parallel.distributed.initialize)")
        if int(flat.max()) >= world:
            raise ValueError(f"mesh ranks {flat.tolist()} exceed the world "
                             f"of {world}")
        self.devices = arr
        self.axis_names = names
        self.shape = dict(zip(names, arr.shape))
        self.size = int(flat.size)
        self.rank = rank
        self.is_member = bool((flat == rank).any())
        pos = np.argwhere(arr == rank)
        self._coords = ({n: int(c) for n, c in zip(names, pos[0])}
                        if self.is_member else {})
        self._groups: Dict[Tuple[str, ...], object] = {}
        subsets = [(a,) for a in names] + [DATA_AXES, DATA_AXES + ("sp",),
                                           names]
        for sub in subsets:
            key = self._key(sub)
            if key and key not in self._groups:
                self._groups[key] = self._make_group(key)

    def _key(self, axes) -> Tuple[str, ...]:
        """The mesh's axes among ``axes`` with size > 1, in mesh order."""
        if isinstance(axes, str):
            axes = (axes,)
        return tuple(a for a in self.axis_names
                     if a in axes and self.shape[a] > 1)

    def _make_group(self, key: Tuple[str, ...]):
        """Every rank builds every group of the partition (the new_group
        contract); returns the one holding this rank, or None."""
        idx = [self.axis_names.index(a) for a in key]
        rest = [i for i in range(len(self.axis_names)) if i not in idx]
        moved = np.transpose(self.devices, rest + idx)
        rows = moved.reshape(-1, int(np.prod([self.shape[a] for a in key])))
        mine = None
        for row in rows:
            g = _group_for(tuple(int(r) for r in row))
            if self.rank in row:
                mine = g
        return mine

    def axis_size(self, axes) -> int:
        """Product of the sizes of ``axes`` (a name or a tuple; absent
        axes count 1)."""
        return int(np.prod([self.shape[a] for a in self._key(axes)] or [1]))

    def coord(self, axes) -> int:
        """This rank's row-major coordinate over ``axes``."""
        c = 0
        for a in self._key(axes):
            c = c * self.shape[a] + self._coords[a]
        return c

    def group(self, axes):
        """This rank's group over ``axes``; None when they span one rank."""
        key = self._key(axes)
        if not key:
            return None
        if key not in self._groups:
            raise KeyError(
                f"no process group over {key}: a mesh builds groups for each "
                f"axis, {DATA_AXES}, {DATA_AXES + ('sp',)} and all axes")
        return self._groups[key]

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    dp: int = 1
    fsdp: int = 1
    tp: int = 1
    sp: int = 1

    @property
    def num_devices(self) -> int:
        return self.dp * self.fsdp * self.tp * self.sp

    def axis_sizes(self) -> Tuple[int, ...]:
        return (self.dp, self.fsdp, self.tp, self.sp)


def _all_ranks(devices: Optional[Sequence[int]]):
    if devices is not None:
        return [int(d) for d in devices]
    return list(range(_world()[1]))


def make_mesh(config: Optional[MeshConfig] = None,
              devices: Optional[Sequence[int]] = None) -> Mesh:
    """A 4-axis (dp, fsdp, tp, sp) mesh over ``devices`` (ranks; default
    the whole world), every rank on the fsdp axis when ``config`` is
    None."""
    devices = _all_ranks(devices)
    if config is None:
        config = MeshConfig(fsdp=len(devices))
    if config.num_devices != len(devices):
        raise ValueError(
            f"mesh {config} needs {config.num_devices} devices, "
            f"got {len(devices)}")
    return Mesh(np.asarray(devices).reshape(config.axis_sizes()), AXES)


def make_hybrid_mesh(config: MeshConfig, num_slices: int,
                     devices: Optional[Sequence[int]] = None) -> Mesh:
    """Multi-node mesh: dp spans nodes, the other axes stay within one.

    JAX groups devices by ``slice_index``; here a node is a block of
    ``LOCAL_WORLD_SIZE`` consecutive ranks (torchrun numbers ranks node by
    node). A ``num_slices`` that contradicts a real multi-node layout is
    refused, as JAX refuses one that stripes ICI axes across DCN; on one
    node, ``num_slices`` contiguous blocks stand in for slices. Requires
    ``config.dp % num_slices == 0``."""
    import os
    devices = _all_ranks(devices)
    if config.num_devices != len(devices):
        raise ValueError(
            f"mesh {config} needs {config.num_devices} devices, "
            f"got {len(devices)}")
    if config.dp % num_slices != 0:
        raise ValueError(
            f"dp={config.dp} must be a multiple of num_slices={num_slices} "
            f"(dp is the DCN axis)")
    local = int(os.environ.get("LOCAL_WORLD_SIZE", "0") or 0)
    if local > 0 and len(devices) > local and len(devices) % local == 0:
        real_slices = len(devices) // local
        if real_slices != num_slices:
            raise ValueError(
                f"ranks span {real_slices} nodes but num_slices={num_slices}"
                f"; set num_slices to the real node count (or restrict "
                f"devices to whole nodes)")
    per_slice = (config.dp // num_slices, config.fsdp, config.tp, config.sp)
    block = len(devices) // num_slices
    groups = [devices[i * block:(i + 1) * block] for i in range(num_slices)]
    arr = np.stack([np.asarray(g).reshape(per_slice) for g in groups])
    # (slice, dp/slice, fsdp, tp, sp) → fold slice into dp, outermost
    return Mesh(arr.reshape(config.axis_sizes()), AXES)


def single_device_mesh() -> Mesh:
    """A one-rank mesh over this rank."""
    return make_mesh(MeshConfig(), devices=[_world()[0]])


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a spec (a tuple of axis names, tuples of them, or None
    per dim): the port's ``jax.sharding.NamedSharding``."""

    mesh: Mesh
    spec: tuple

    def local(self, x):
        """This rank's block of the global array ``x`` under the spec."""
        for dim, entry in enumerate(self.spec):
            if entry is None:
                continue
            n = self.mesh.axis_size(entry)
            if n == 1:
                continue
            size = x.shape[dim]
            if size % n:
                raise ValueError(f"dim {dim} of size {size} does not split "
                                 f"over {entry} ({n})")
            part = size // n
            i = self.mesh.coord(entry)
            index = [slice(None)] * x.ndim
            index[dim] = slice(i * part, (i + 1) * part)
            x = x[tuple(index)]
        return x


def data_sharding(mesh: Mesh) -> NamedSharding:
    """Batch over (dp, fsdp), sequence over sp (restricted to the mesh's
    axes)."""
    from .sharding import restrict_spec
    return NamedSharding(mesh, restrict_spec((DATA_AXES, "sp"), mesh))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, ())

