from .async_loop import behavior_logp_batched
from .data import (Trajectory, make_batch, make_batch_logps,
                   make_branch_mask)
from .grpo import (GRPOConfig, branch_credit_weights,
                   group_relative_advantages, grpo_objective,
                   token_credit_weights, token_logprobs)
from .lora import (DEFAULT_TARGETS, init_lora, lora_param_count,
                   materialize_lora, merge_lora, split_lora)
from .trainer import (AdamW, AdamWState, TrainState, apply_gradients,
                      grpo_gradients, make_lora_train_state,
                      make_optimizer, make_train_state, train_step)
