from .adapter_pool import (AdapterBinding, AdapterPool, AdapterPoolConfig,
                           AdapterPoolFull, StaleAdapterVersion)
from .engine import EngineConfig, PrefixImportError, QueueFull, RolloutEngine
from .group_tree import BranchPolicy, GroupRollout, Leaf
from .paged_kv import (KV_DTYPES, BlockAllocator, BlockPayload,
                       BlocksExhausted, PagedKVPool, PagedSeqKV,
                       init_paged_pool, resolve_kv_dtypes)
from .policy_client import EnginePolicyClient
from .sampler import (SampleParams, decode_step, generate, generate_scan,
                      prefill, prefill_chunked)
from .session import RolloutSession, TurnResult
from .spec_controller import FixedDepth, SpecController, SpecControllerConfig
from .speculative import OnlineDraftLearner, SpeculativeDecoder
