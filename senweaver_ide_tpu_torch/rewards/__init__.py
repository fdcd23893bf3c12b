from .head import (DIM_NAMES, N_DIMS, WEIGHTS, RewardOutput, reward_head,
                   reward_head_batch, score_trace, score_traces)
