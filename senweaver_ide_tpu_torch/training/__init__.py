from .async_loop import behavior_logp_batched
from .data import (Trajectory, make_batch, make_batch_logps,
                   make_branch_mask, pad_batch_for_mesh,
                   place_batch_for_mesh)
from .diagnostics import (DiagnosticsConfig, advantage_stats,
                          dispatch_round_health, finalize_round_health)
from .grpo import (GRPOConfig, branch_credit_weights,
                   group_relative_advantages, grpo_objective,
                   token_credit_weights, token_logprobs)
from .lora import (DEFAULT_TARGETS, export_peft_adapter, init_lora,
                   load_peft_adapter, lora_param_count, materialize_lora,
                   merge_lora, split_lora)
from .rl_loop import (CollectResult, EpisodeRecord, EpisodeTimeout,
                      GroupSizeScheduler, RoundResult,
                      collect_group_trajectories, collect_tree_trajectories,
                      grpo_round)
from .trainer import (AdamW, AdamWState, TrainState, apply_gradients,
                      grpo_gradients, make_lora_train_state,
                      make_optimizer, make_train_state, train_step,
                      train_step_guarded)
from .checkpoint import CheckpointManager
from .online import OnlineImprovementLoop, OnlineRoundResult
