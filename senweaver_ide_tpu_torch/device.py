"""Device selection for the port's entry points.

Entry points (``init_params``, ``params_from_numpy``, ``RolloutEngine``,
``init_paged_pool``, ``init_kv_cache``) run on the CUDA card unless the caller asks for the
CPU by name. There is no silent "CUDA if present, else CPU": a serving
process that lost its card must fail, not crawl on host cores.
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises when it names CUDA and
    this process has no usable card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; "
            f"pass device='cpu' to run the plain PyTorch path on the host")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}; expected "
                         f"'cuda' or 'cpu'")
    return dev
