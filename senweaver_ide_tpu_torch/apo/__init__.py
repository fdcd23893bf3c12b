from .types import (APOConfig, BeamState, CATEGORIES, DIM_CATEGORY_MAP,
                    EffectivenessReport, IssuePattern, ModeStats, PromptSegment,
                    PromptVersion, RolloutMessage, RolloutResult, Suggestion,
                    TextualGradient, new_suggestion)
from .patterns import analyze_patterns, reward_dimension_patterns
from .report import build_report, generate_local_suggestions, reward_by_dimension
from .rollouts import trace_to_rollout, traces_to_rollouts
from .gradient import (build_apply_edit_prompt, build_textual_gradient_prompt,
                       format_rollout, parse_rules)
from .segments import SegmentStore
from .beam import beam_search, corpus_score_fn, propose_candidates
from .service import (APOService, APO_RULES_MAX_CHARS,
                      format_apo_rules_section, install_apo_channel)
from .synthetic import (generate_good_traces, generate_pattern_traces,
                        make_six_pattern_corpus)
from .local import (corpus_score_from_collector, make_local_apo,
                    policy_generate_fn)
from .eval import (GOOD_RULESET, RuleSensitivePolicy, SIX_PATTERN_TASKS,
                   evaluate_rules, make_rollout_score_fn, run_uplift_eval)
