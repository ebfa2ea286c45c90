"""KV-cache constructors in the head-major layouts the kernels read without
a copy: contiguous (B, Hk, N, D) and paged (Hk, num_pages, page_size, D).

16/32-bit payloads only; the quantized pools (int8, fp8, int4) come with
port slice 4.
"""

from __future__ import annotations

import dataclasses

import torch

from flash_attn_v100_tpu_torch.config import (
    DeviceLike, as_torch_dtype, resolve_device)

_PAYLOAD_DTYPES = (torch.bfloat16, torch.float16, torch.float32)


@dataclasses.dataclass
class ContiguousCache:
    """Per-layer (B, Hk, N, D) caches in HND layout."""
    k: torch.Tensor
    v: torch.Tensor


@dataclasses.dataclass
class PagedCache:
    """(Hk, num_pages, page_size, D) page pool + external block tables."""
    k: torch.Tensor
    v: torch.Tensor
    page_size: int

    @property
    def num_pages(self) -> int:
        return self.k.shape[1]


def _payload(dtype) -> torch.dtype:
    dt = as_torch_dtype(dtype)
    if dt not in _PAYLOAD_DTYPES:
        raise NotImplementedError(
            f"KV cache dtype {dtype!r}: quantized pools (int8/fp8/int4) come "
            "with port slice 4; 16/32-bit payloads are supported")
    return dt


def init_contiguous(batch: int, max_len: int, n_kv_heads: int, head_dim: int,
                    dtype=torch.bfloat16,
                    device: DeviceLike = None) -> ContiguousCache:
    shape = (batch, n_kv_heads, max_len, head_dim)
    dt, dev = _payload(dtype), resolve_device(device)
    return ContiguousCache(k=torch.zeros(shape, dtype=dt, device=dev),
                           v=torch.zeros(shape, dtype=dt, device=dev))


def init_paged(num_pages: int, page_size: int, n_kv_heads: int, head_dim: int,
               dtype=torch.bfloat16,
               device: DeviceLike = None) -> PagedCache:
    shape = (n_kv_heads, num_pages, page_size, head_dim)
    dt, dev = _payload(dtype), resolve_device(device)
    return PagedCache(k=torch.zeros(shape, dtype=dt, device=dev),
                      v=torch.zeros(shape, dtype=dt, device=dev),
                      page_size=page_size)


__all__ = ["ContiguousCache", "PagedCache", "init_contiguous", "init_paged"]
