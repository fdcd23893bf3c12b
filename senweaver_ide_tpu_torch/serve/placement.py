"""Where a serving payload's tensors live.

Two facts of PyTorch that the fleet's JAX design did not have to face:

- a tensor is mutable, and a trainer steps its params in place, so a
  weight roll that spans many pump steps must hold a copy of its own,
  not the caller's tree (:func:`on_device` with ``copy=True``);
- the wire codec (``serve/rpc.py``) decodes arrays on the host, while an
  engine computes on its own device in its own dtype, so a decoded
  payload is placed once per call before it reaches the engine.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Optional

import numpy as np
import torch


def _is_array(x: Any) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray))


def _leaf(x, device, like, copy: bool):
    if isinstance(x, np.ndarray):
        # from_numpy shares the array's memory; a read-only array (a
        # frombuffer view) is copied since torch cannot wrap it
        t = torch.from_numpy(x if x.flags.writeable else x.copy())
    else:
        t = x.detach()
    dtype = t.dtype
    if (isinstance(like, torch.Tensor) and like.is_floating_point()
            and t.is_floating_point() and tuple(like.shape) == tuple(t.shape)):
        dtype = like.dtype
    dev = t.device if device is None else torch.device(device)
    out = t.to(device=dev, dtype=dtype)
    if copy and out is t:
        out = t.clone()
    return out


def on_device(tree, device=None, *, like=None, copy: bool = False):
    """``tree`` with every array leaf (numpy or torch) as a tensor on
    ``device`` (None keeps each tensor's device; numpy leaves land on the
    host). A floating leaf whose counterpart in ``like`` (same path, same
    shape) is floating takes that counterpart's dtype; every other leaf
    keeps its own. ``copy=True`` makes every leaf a tensor of its own even
    where nothing had to move. Mappings, namedtuples, lists and tuples
    are rebuilt; other leaves (None, ints) pass through."""
    if isinstance(tree, Mapping):
        sub = like if isinstance(like, Mapping) else {}
        return {k: on_device(v, device, like=sub.get(k), copy=copy)
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(
            on_device(getattr(tree, f), device,
                      like=getattr(like, f, None), copy=copy)
            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(on_device(v, device, copy=copy) for v in tree)
    if _is_array(tree):
        return _leaf(tree, device, like, copy)
    return tree


def engine_device(engine) -> Optional[torch.device]:
    """The device an in-process engine computes on; None for a remote
    client or anything else without one."""
    dev = getattr(engine, "device", None)
    return dev if isinstance(dev, torch.device) else None
