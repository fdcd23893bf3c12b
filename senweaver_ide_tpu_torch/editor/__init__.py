"""Editor-AI layer: fast-apply, FIM autocomplete, edit prediction.

TPU-build analogues of the reference's L7 editor features (SURVEY.md
§2.5): editCodeService.ts (SEARCH/REPLACE fast apply + retry),
autocompleteService.ts (FIM + postprocessing), editPredictionService.ts
(multi-location edit prediction). In this framework they serve the
rollout sandbox (edit_agent tool, agent self-edits) rather than a GUI.
"""

from .autocomplete import (AutocompleteService, FimPrompt, build_fim_prompt,
                           postprocess_completion, should_complete)
from .diff_zones import ComputedDiff, Diff, DiffZone, DiffZoneService, \
    find_diffs
from .edit_prediction import (EditPrediction, changed_symbols,
                              predict_edit_locations, suggest_contents)
from .fast_apply import (MAX_APPLY_RETRIES, ApplyResult,
                         apply_described_edit, instantly_apply_blocks)

__all__ = [
    "ComputedDiff", "Diff", "DiffZone", "DiffZoneService", "find_diffs",
    "AutocompleteService", "FimPrompt", "build_fim_prompt",
    "postprocess_completion", "should_complete", "EditPrediction",
    "changed_symbols", "predict_edit_locations", "suggest_contents",
    "MAX_APPLY_RETRIES", "ApplyResult", "apply_described_edit",
    "instantly_apply_blocks",
]
