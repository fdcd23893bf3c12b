from .engine import EngineConfig, PrefixImportError, QueueFull, RolloutEngine
from .paged_kv import (KV_DTYPES, BlockAllocator, BlockPayload,
                       BlocksExhausted, PagedKVPool, init_paged_pool,
                       resolve_kv_dtypes)
from .policy_client import EnginePolicyClient
from .sampler import (SampleParams, decode_step, generate, generate_scan,
                      prefill, prefill_chunked)
from .session import RolloutSession, TurnResult
