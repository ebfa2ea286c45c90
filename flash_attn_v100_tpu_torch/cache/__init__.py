"""KV-cache constructors in the head-major layouts the kernels read without
a copy: contiguous (B, Hk, N, D) and paged (Hk, num_pages, page_size, D).

Payloads are 16/32-bit, or quantized (ops/quant.py) with per-(token, head)
fp32 scales filled with ones: int8 and fp8 (torch.float8_e4m3fn) keep the
payload shape; "int4" packs two tokens per int8 byte, so its payload has
half the token rows at the full head_dim while its scales stay per token.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from flash_attn_v100_tpu_torch.config import (
    DeviceLike, as_torch_dtype, resolve_device)
from flash_attn_v100_tpu_torch.ops.quant import FP8, is_int4

_FLOAT_DTYPES = (torch.bfloat16, torch.float16, torch.float32)


@dataclasses.dataclass
class ContiguousCache:
    """Per-layer (B, Hk, N, D) caches in HND layout."""
    k: torch.Tensor
    v: torch.Tensor
    k_scales: Optional[torch.Tensor] = None   # (B, Hk, N, 1) fp32 if quantized
    v_scales: Optional[torch.Tensor] = None

    @property
    def quantized(self) -> bool:
        return self.k_scales is not None


@dataclasses.dataclass
class PagedCache:
    """(Hk, num_pages, page_size, D) page pool + external block tables."""
    k: torch.Tensor
    v: torch.Tensor
    page_size: int
    k_scales: Optional[torch.Tensor] = None   # (Hk, P, ps, 1) fp32 if quantized
    v_scales: Optional[torch.Tensor] = None

    @property
    def num_pages(self) -> int:
        return self.k.shape[1]

    @property
    def quantized(self) -> bool:
        return self.k_scales is not None


def _payload(dtype) -> Tuple[int, torch.dtype, bool]:
    """(token-dim divisor, payload dtype, scales?) for a cache dtype."""
    if is_int4(dtype):
        return 2, torch.int8, True
    dt = as_torch_dtype(dtype)
    if dt in (torch.int8, FP8):
        return 1, dt, True
    if dt not in _FLOAT_DTYPES:
        raise TypeError(f"KV cache dtype {dtype!r}: 16/32-bit, int8, "
                        "float8_e4m3fn or 'int4' payloads are supported")
    return 1, dt, False


def _alloc(shape, scale_shape, dtype, device):
    div, dt, quant = _payload(dtype)
    if shape[2] % div:
        raise ValueError(f"int4 caches pack two tokens per byte: the token "
                         f"dimension ({shape[2]}) must be even")
    dev = resolve_device(device)
    shape = shape[:2] + (shape[2] // div,) + shape[3:]
    k, v = (torch.zeros(shape, dtype=dt, device=dev) for _ in range(2))
    if not quant:
        return k, v, None, None
    ks, vs = (torch.ones(scale_shape, dtype=torch.float32, device=dev)
              for _ in range(2))
    return k, v, ks, vs


def init_contiguous(batch: int, max_len: int, n_kv_heads: int, head_dim: int,
                    dtype=torch.bfloat16,
                    device: DeviceLike = None) -> ContiguousCache:
    k, v, ks, vs = _alloc((batch, n_kv_heads, max_len, head_dim),
                          (batch, n_kv_heads, max_len, 1), dtype, device)
    return ContiguousCache(k=k, v=v, k_scales=ks, v_scales=vs)


def init_paged(num_pages: int, page_size: int, n_kv_heads: int, head_dim: int,
               dtype=torch.bfloat16,
               device: DeviceLike = None) -> PagedCache:
    k, v, ks, vs = _alloc((n_kv_heads, num_pages, page_size, head_dim),
                          (n_kv_heads, num_pages, page_size, 1), dtype,
                          device)
    return PagedCache(k=k, v=v, page_size=page_size, k_scales=ks, v_scales=vs)


def kvcache_kwargs(cache) -> dict:
    """kwargs for flash_attn_with_kvcache from a cache object."""
    kw = dict(kv_cache_layout="HND")
    if cache.quantized:
        kw.update(k_scales=cache.k_scales, v_scales=cache.v_scales)
    return kw


__all__ = ["ContiguousCache", "PagedCache", "init_contiguous", "init_paged",
           "kvcache_kwargs"]
