"""Paged KV-cache allocator: host-side page bookkeeping for the paged
`block_table` machinery of flash_attn_with_kvcache.

The page ids handed out here index rows of the device page pool
(the `(1, Hk, P, page_size, D)` view of ops/cuda/decode.py); the per-sequence
page lists become the rows of `block_table`.  C++-backed (csrc/fa_runtime.cpp)
with a pure-Python mirror for toolchain-free environments; both sides share
semantics and are cross-tested in tests/test_torch_engine.py.

The reference reserves this design space but never implements it: paged KV is
validated per-call (`block_table`, kernel/fused_mha_forward_kvcache.cu:479-501)
and allocation is left to the caller.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List

from flash_attn_v100_tpu_torch.runtime import native


class PagedAllocator:
    """Fixed pool of `num_pages` KV pages of `page_size` tokens each.
    (The JAX package's seq-mesh page sharding comes with port slice 5.)"""

    def __init__(self, num_pages: int, page_size: int, use_native: bool = True):
        if num_pages <= 0 or page_size <= 0:
            raise ValueError("num_pages and page_size must be positive")
        self.num_pages = num_pages
        self.page_size = page_size
        self._lib = native.load() if use_native else None
        if self._lib is not None:
            self._h = self._lib.fa_alloc_create(num_pages, page_size)
        else:
            # popped from the end: pages are handed out in ascending order
            self._free: List[int] = list(range(num_pages - 1, -1, -1))
            self._seq: Dict[int, List[int]] = {}

    @property
    def is_native(self) -> bool:
        return self._lib is not None

    def num_free(self) -> int:
        if self._lib is not None:
            return self._lib.fa_alloc_num_free(self._h)
        return len(self._free)

    def can_extend(self, seq_id: int, n: int) -> bool:
        """Can n more pages be handed to seq_id?"""
        if n <= 0:
            return True
        if self._lib is not None:
            return bool(self._lib.fa_alloc_can_extend(self._h, seq_id, n))
        return len(self._free) >= n

    def extend(self, seq_id: int, n: int) -> List[int]:
        """Append n pages to seq_id's list (all-or-nothing).  Returns the new
        page ids; [] if the pool can't cover the request."""
        if n <= 0:
            return []
        if self._lib is not None:
            out = (ctypes.c_int32 * n)()
            got = self._lib.fa_alloc_extend(self._h, seq_id, n, out)
            return list(out[:n]) if got else []
        if not self.can_extend(seq_id, n):
            return []
        pages = [self._free.pop() for _ in range(n)]
        self._seq.setdefault(seq_id, []).extend(pages)
        return pages

    def pages_of(self, seq_id: int) -> List[int]:
        if self._lib is not None:
            n = self._lib.fa_alloc_pages_of(self._h, seq_id, None, 0)
            if n == 0:
                return []
            out = (ctypes.c_int32 * n)()
            self._lib.fa_alloc_pages_of(self._h, seq_id, out, n)
            return list(out)
        return list(self._seq.get(seq_id, []))

    def release(self, seq_id: int) -> None:
        if self._lib is not None:
            self._lib.fa_alloc_release(self._h, seq_id)
            return
        self._free.extend(self._seq.pop(seq_id, []))

    def __del__(self):
        lib = getattr(self, "_lib", None)
        if lib is not None and getattr(self, "_h", None):
            lib.fa_alloc_destroy(self._h)
            self._h = None
