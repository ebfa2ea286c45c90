"""`flash_attn.flash_attn_interface`, the import path most integrations
use, over the port's three entry points."""

from flash_attn_v100_tpu_torch.ops.flash_attention import flash_attn_func
from flash_attn_v100_tpu_torch.ops.kvcache import flash_attn_with_kvcache
from flash_attn_v100_tpu_torch.ops.varlen import flash_attn_varlen_func

flash_attn_gpu = flash_attn_func
flash_attn_varlen_gpu = flash_attn_varlen_func
flash_attn_with_kvcache_gpu = flash_attn_with_kvcache

__all__ = [
    "flash_attn_func", "flash_attn_gpu",
    "flash_attn_varlen_func", "flash_attn_varlen_gpu",
    "flash_attn_with_kvcache", "flash_attn_with_kvcache_gpu",
]
