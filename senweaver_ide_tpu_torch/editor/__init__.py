"""Editor-AI layer (PyTorch port).

Of the JAX package's ``editor/`` this slice takes ``fast_apply``, the
SEARCH/REPLACE apply that rollout sessions' edit tool runs. FIM
autocomplete, diff zones and edit prediction come with the host-plane
slice.
"""

from .fast_apply import (MAX_APPLY_RETRIES, ApplyResult,
                         apply_described_edit, instantly_apply_blocks)

__all__ = [
    "MAX_APPLY_RETRIES", "ApplyResult", "apply_described_edit",
    "instantly_apply_blocks",
]
