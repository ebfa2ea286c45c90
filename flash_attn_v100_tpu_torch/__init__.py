"""flash_attn_v100_tpu_torch — the PyTorch/CUDA port of flash_attn_v100_tpu
for NVIDIA Hopper (H100, sm_90a).

The JAX package `flash_attn_v100_tpu` is the reference; this package grows
beside it slice by slice.  It holds the paged serving engine: the KV-cache
attention API with its two hand-written CUDA kernels (split-KV decode and
paged varlen prefill), the Llama-family model's serving path, and the
continuous-batching runtime.  Entry points run on the GPU unless the caller
passes device="cpu", where every kernel is replaced by its plain PyTorch
version.
"""

from flash_attn_v100_tpu_torch.models.transformer import (
    ModelConfig, params_from_jax)
from flash_attn_v100_tpu_torch.ops.kvcache import flash_attn_with_kvcache
from flash_attn_v100_tpu_torch.runtime.engine import ServingEngine

__all__ = ["flash_attn_with_kvcache", "ServingEngine", "ModelConfig",
           "params_from_jax"]
