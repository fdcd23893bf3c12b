"""Editor-AI layer (PyTorch port).

Of the JAX package's ``editor/`` the port takes ``fast_apply``, the
SEARCH/REPLACE apply that rollout sessions' edit tool runs, and
``autocomplete``, FIM prompt building and completion postprocessing over
the model capabilities table. Diff zones and edit prediction come with
the host-plane slice.
"""

from .autocomplete import (AutocompleteService, FimPrompt, build_fim_prompt,
                           postprocess_completion, should_complete)
from .fast_apply import (MAX_APPLY_RETRIES, ApplyResult,
                         apply_described_edit, instantly_apply_blocks)

__all__ = [
    "AutocompleteService", "FimPrompt", "build_fim_prompt",
    "postprocess_completion", "should_complete",
    "MAX_APPLY_RETRIES", "ApplyResult", "apply_described_edit",
    "instantly_apply_blocks",
]
