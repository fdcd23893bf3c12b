"""Context engineering (PyTorch port).

Of the JAX package's ``context/`` this slice takes ``token_config``, the
output-reserve and tool-result caps the tool service and the agent loop
apply. Budgeting, compression, compaction and rate limiting come with the
host-plane slice.
"""

from .token_config import (DIRECTORY_OPTIMIZATION, MAX_CHILDREN_URIS_PAGE,
                           MAX_FILE_CHARS_PAGE, OPTIMIZATION_TARGETS,
                           OUTPUT_RESERVE_RATIO, TOOL_RESULT_OPTIMIZATION,
                           cap_text)

__all__ = [
    "DIRECTORY_OPTIMIZATION", "MAX_CHILDREN_URIS_PAGE",
    "MAX_FILE_CHARS_PAGE", "OPTIMIZATION_TARGETS", "OUTPUT_RESERVE_RATIO",
    "TOOL_RESULT_OPTIMIZATION", "cap_text",
]
