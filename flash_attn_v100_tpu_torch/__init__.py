"""flash_attn_v100_tpu_torch — the PyTorch/CUDA port of flash_attn_v100_tpu
for NVIDIA Hopper (H100, sm_90a).

The JAX package `flash_attn_v100_tpu` is the reference; this package grows
beside it slice by slice.  It holds
  * training: `flash_attn_func` (dense attention, differentiable) on three
    hand-written CUDA kernels (K1 forward, K2 dQ, K3 dK/dV) and the
    Llama-family model's `forward`, `loss_fn`, `sgd_train_step` and
    `make_train_step`;
  * packed sequences: `flash_attn_varlen_func` (differentiable; K5
    forward, K6 dQ, K7 dK/dV, and K8 for paged K/V) and the pad/unpad
    helpers of `ops/padding.py`;
  * the paged serving engine: the KV-cache attention API with its
    hand-written CUDA kernels (split-KV decode K4 and paged varlen prefill
    K8, and their int8/fp8/int4 variants K4q and K8q over quantized pools),
    the model's serving path, and the continuous-batching runtime;
  * the KV-cache formats: `quantize_kv` / `dequantize_kv` and the cache
    constructors of `cache/`;
  * integrations: HF Llama / Mistral / Qwen2 checkpoint import
    (`convert_hf_model`) and LoRA fine-tuning (`LoraConfig`,
    `integrations/lora.py`), and the measuring tools of `utils/`
    (benchmarking, profiling, debugging, the dist-info masquerade).
Entry points run on the GPU unless the caller passes device="cpu" (or CPU
tensors), where every kernel is replaced by its plain PyTorch version.
"""

__version__ = "2.8.3"  # the JAX package's flash_attn version masquerade

from flash_attn_v100_tpu_torch.cache import (
    ContiguousCache, PagedCache, init_contiguous, init_paged, kvcache_kwargs)
from flash_attn_v100_tpu_torch.integrations.huggingface import (
    convert_hf_model)
from flash_attn_v100_tpu_torch.integrations.lora import LoraConfig
from flash_attn_v100_tpu_torch.models.transformer import (
    ModelConfig, params_from_jax)
from flash_attn_v100_tpu_torch.ops.flash_attention import flash_attn_func
from flash_attn_v100_tpu_torch.ops.kvcache import flash_attn_with_kvcache
from flash_attn_v100_tpu_torch.ops.quant import dequantize_kv, quantize_kv
from flash_attn_v100_tpu_torch.ops.varlen import flash_attn_varlen_func
from flash_attn_v100_tpu_torch.runtime.engine import ServingEngine

# the names the JAX package also exports
flash_attn_gpu = flash_attn_func
flash_attn_varlen_gpu = flash_attn_varlen_func
flash_attn_with_kvcache_gpu = flash_attn_with_kvcache

__all__ = ["flash_attn_func", "flash_attn_varlen_func",
           "flash_attn_with_kvcache", "flash_attn_gpu",
           "flash_attn_varlen_gpu", "flash_attn_with_kvcache_gpu",
           "ServingEngine", "ModelConfig", "params_from_jax", "quantize_kv",
           "dequantize_kv", "ContiguousCache", "PagedCache",
           "init_contiguous", "init_paged", "kvcache_kwargs",
           "convert_hf_model", "LoraConfig"]
