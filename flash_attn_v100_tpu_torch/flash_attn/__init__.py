"""The canonical `flash_attn` surface of the port: the counterpart of the
repository's root `flash_attn/` package, which names the JAX package.

Drop-in callers (HF transformers' `is_flash_attn_2_available` probes,
`import flash_attn`) reach the port once
`flash_attn_v100_tpu_torch.utils.distinfo.install_canonical_name()` has
registered this package under the name `flash_attn`; imported as
`flash_attn_v100_tpu_torch.flash_attn` it needs no registration.  The
version masquerades as the flash-attn release whose API surface matches.
"""

from flash_attn_v100_tpu_torch import __version__  # noqa: F401  (2.8.3)
from flash_attn_v100_tpu_torch.ops.flash_attention import flash_attn_func
from flash_attn_v100_tpu_torch.ops.kvcache import flash_attn_with_kvcache
from flash_attn_v100_tpu_torch.ops.varlen import flash_attn_varlen_func

# GPU-suffix aliases kept for drop-in parity
flash_attn_gpu = flash_attn_func
flash_attn_varlen_gpu = flash_attn_varlen_func
flash_attn_with_kvcache_gpu = flash_attn_with_kvcache

__all__ = [
    "flash_attn_func", "flash_attn_gpu",
    "flash_attn_varlen_func", "flash_attn_varlen_gpu",
    "flash_attn_with_kvcache", "flash_attn_with_kvcache_gpu",
]
