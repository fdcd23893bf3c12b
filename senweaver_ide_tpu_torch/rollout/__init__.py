from .engine import EngineConfig, QueueFull, RolloutEngine
from .paged_kv import (KV_DTYPES, BlockAllocator, BlocksExhausted,
                       PagedKVPool, init_paged_pool, resolve_kv_dtypes)
from .sampler import (SampleParams, decode_step, generate, generate_scan,
                      prefill, prefill_chunked)
