"""Serving runtime: native paged allocator + continuous-batching scheduler
(csrc/fa_runtime.cpp via ctypes, pure-Python fallback) and the paged decode
engine."""

from flash_attn_v100_tpu_torch.runtime.allocator import PagedAllocator
from flash_attn_v100_tpu_torch.runtime.scheduler import Scheduler
from flash_attn_v100_tpu_torch.runtime.engine import (ServingEngine,
                                                     paged_forward)

__all__ = ["PagedAllocator", "Scheduler", "ServingEngine", "paged_forward"]
