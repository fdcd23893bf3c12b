from .attention import attention, causal_mask
from .norms import rms_norm
from .paged_attention import paged_flash_decode, paged_flash_decode_plain
from .rotary import apply_rope, rope_cos_sin, rope_frequencies
from .sampling import apply_temperature, apply_top_k, apply_top_p, sample_token
