from .config import (ModelConfig, PRESETS, RopeScaling, get_config,
                     qwen2_5_coder_0_5b, qwen2_5_coder_1_5b, qwen2_5_coder_7b,
                     deepseek_coder_1_3b, deepseek_coder_6_7b, llama_3_1_8b,
                     llama_3_2_1b, mistral_7b, small_test, tiny_test)
from .transformer import (KVCache, Params, count_params, forward,
                          forward_paged, init_kv_cache, init_params,
                          ring_capacity)
from .load import (available_hf_keys, export_hf_params, load_hf_params,
                   params_from_numpy)
from .quantize import is_quantized, quantize_weights_int8, quantized_bytes
from .tokenizer import ByteTokenizer, HFTokenizer, load_tokenizer
from .capabilities import (ModelCapabilities, get_model_capabilities,
                           get_reserved_output_token_space)
