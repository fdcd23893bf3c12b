"""Weight bridge: a parameter tree of numpy arrays → the port's params.

:func:`params_from_numpy` takes the JAX ``init_params`` tree as host
arrays (``jax.device_get``) and returns the dict of stacked tensors that
``models/transformer.py`` consumes; a LoRA adapter tree from the JAX
``init_lora`` (``{"layers": {"wq_lora_a": (L, in, r), ...}}``) converts
the same way, for ``training/lora.py``. The layout is unchanged: projection
weights stay ``(in, out)`` and layer tensors keep their leading L axis,
so no transpose happens and ``x @ W`` computes what the JAX einsums do.
Loading HF safetensors checkpoints comes with a later slice.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from ..device import resolve_device
from .transformer import Params

# numpy extension dtypes (ml_dtypes) torch.from_numpy cannot take:
# reinterpret their bits as a same-width integer array, then view back.
_BIT_VIEWS = {
    "bfloat16": (np.uint16, torch.bfloat16),
    "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
}


def _to_tensor(a, device, dtype) -> torch.Tensor:
    # a private, writable, contiguous copy: the source may be a read-only
    # view of another framework's buffer
    a = np.array(a, order="C", copy=True)
    view = _BIT_VIEWS.get(a.dtype.name)
    if view is not None:
        t = torch.from_numpy(a.view(view[0])).view(view[1])
    else:
        t = torch.from_numpy(a)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_numpy(tree: Mapping, *, device="cuda",
                      dtype: Optional[torch.dtype] = None) -> Params:
    """Convert a nested mapping of numpy arrays to torch tensors on
    ``device``. ``dtype`` casts every floating tensor (None keeps each
    array's own dtype)."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, Mapping):
            return {k: conv(v) for k, v in node.items()}
        return _to_tensor(node, dev, dtype)

    return conv(tree)
