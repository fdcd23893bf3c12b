from .config import (ModelConfig, PRESETS, RopeScaling, get_config,
                     qwen2_5_coder_0_5b, qwen2_5_coder_1_5b, qwen2_5_coder_7b,
                     deepseek_coder_1_3b, deepseek_coder_6_7b, llama_3_1_8b,
                     llama_3_2_1b, mistral_7b, small_test, tiny_test)
from .transformer import (KVCache, Params, count_params, forward,
                          forward_paged, init_kv_cache, init_params,
                          ring_capacity)
from .load import (available_hf_keys, export_hf_params, load_hf_params,
                   params_from_numpy)
from .tokenizer import ByteTokenizer, HFTokenizer, load_tokenizer
