"""Context engineering: budgeting, compression, compaction, rate limiting.

The TPU-build analogue of the reference's client-side long-context stack
(`common/smartContextManager.ts`, `common/messageCompressor.ts`,
`common/tokenOptimizationConfig.ts`, `common/tokenUsageTracker.ts`,
`common/tpmRateLimiter.ts`, `common/cacheService.ts`,
`common/performanceMonitor.ts`). Rollouts keep these exact semantics so
trace token statistics (reward dims 7-8) match the reference; real
long-context *compute* lives in ops/flash_attention.py and
parallel/ring_attention.py.
"""

from .cache import CacheStats, LRUTTLCache
from .compressor import (compress_assistant_message,
                         compress_history_to_summary, compress_message,
                         compress_tool_result)
from .estimator import TokenEstimator, estimate_tokens, looks_like_code
from .manager import (CompactionState, EnhancedContextManager,
                      SmartContextManager)
from .manager_types import (OVERFLOW_THRESHOLD,
                            PRIORITY, PRUNE, ContextBuildResult, ContextPart,
                            MessageInput, PruneResult, TokenUsageInfo,
                            model_context_limit)
from .rate_limiter import (DEFAULT_TPM_CONFIGS, TPMRateLimiter,
                           tpm_rate_limiter)
from .token_config import (DIRECTORY_OPTIMIZATION, MAX_CHILDREN_URIS_PAGE,
                           MAX_FILE_CHARS_PAGE, OPTIMIZATION_TARGETS,
                           OUTPUT_RESERVE_RATIO, TOOL_RESULT_OPTIMIZATION,
                           cap_text)
from .tracker import (DEFAULT_THRESHOLDS, PerfEvent, PerformanceMonitor,
                      TokenUsageRecord, TokenUsageTracker, UsageStats)

__all__ = [
    "CacheStats", "LRUTTLCache", "compress_assistant_message",
    "compress_history_to_summary", "compress_message",
    "compress_tool_result", "TokenEstimator", "estimate_tokens",
    "looks_like_code", "CompactionState", "EnhancedContextManager",
    "SmartContextManager", "OVERFLOW_THRESHOLD",
    "PRIORITY", "PRUNE", "ContextBuildResult", "ContextPart",
    "MessageInput", "PruneResult", "TokenUsageInfo", "model_context_limit",
    "DEFAULT_TPM_CONFIGS", "TPMRateLimiter", "tpm_rate_limiter",
    "DIRECTORY_OPTIMIZATION", "MAX_CHILDREN_URIS_PAGE",
    "MAX_FILE_CHARS_PAGE", "OPTIMIZATION_TARGETS", "OUTPUT_RESERVE_RATIO",
    "TOOL_RESULT_OPTIMIZATION", "cap_text", "DEFAULT_THRESHOLDS",
    "PerfEvent", "PerformanceMonitor", "TokenUsageRecord",
    "TokenUsageTracker", "UsageStats",
]
