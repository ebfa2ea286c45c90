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

    With `num_shards > 1` (the engine's seq-sharded mode) the pool is
    sharded: block-table slot columns are split contiguously over the seq
    mesh axis, `slots_per_shard` columns each, and the page backing slot j
    comes from the pool shard of the rank owning that column, shard
    min(j // slots_per_shard, num_shards - 1).  Page ids are shard-local
    and `num_pages` counts per shard, so the KV capacity grows with the
    seq axis at the same memory a rank."""

    def __init__(self, num_pages: int, page_size: int, use_native: bool = True,
                 num_shards: int = 1, slots_per_shard: int = 2**31 - 1):
        if num_pages <= 0 or page_size <= 0:
            raise ValueError("num_pages and page_size must be positive")
        if num_shards <= 0 or slots_per_shard <= 0:
            raise ValueError("num_shards and slots_per_shard must be positive")
        self.num_pages = num_pages
        self.page_size = page_size
        self.num_shards = num_shards
        self.slots_per_shard = slots_per_shard
        self._lib = native.load() if use_native else None
        if self._lib is not None:
            self._h = self._lib.fa_alloc_create_sharded(
                num_pages, page_size, num_shards, slots_per_shard)
        else:
            # one free list a shard, popped from the end: pages are handed
            # out in ascending order
            self._free: List[List[int]] = [
                list(range(num_pages - 1, -1, -1)) for _ in range(num_shards)]
            self._seq: Dict[int, List[int]] = {}

    @property
    def is_native(self) -> bool:
        return self._lib is not None

    def num_free(self) -> int:
        if self._lib is not None:
            return self._lib.fa_alloc_num_free(self._h)
        return sum(len(f) for f in self._free)

    def _shard_of(self, slot: int) -> int:
        return min(slot // self.slots_per_shard, self.num_shards - 1)

    def can_extend(self, seq_id: int, n: int) -> bool:
        """Can slots [held, held + n) of seq_id all be covered by the
        shards that own them?"""
        if n <= 0:
            return True
        if self._lib is not None:
            return bool(self._lib.fa_alloc_can_extend(self._h, seq_id, n))
        base = len(self._seq.get(seq_id, ()))
        need: Dict[int, int] = {}
        for slot in range(base, base + n):
            s = self._shard_of(slot)
            need[s] = need.get(s, 0) + 1
        return all(len(self._free[s]) >= k for s, k in need.items())

    def extend(self, seq_id: int, n: int) -> List[int]:
        """Append n pages to seq_id's list (all-or-nothing).  Returns the new
        (shard-local) page ids; [] if the pool can't cover the request."""
        if n <= 0:
            return []
        if self._lib is not None:
            out = (ctypes.c_int32 * n)()
            got = self._lib.fa_alloc_extend(self._h, seq_id, n, out)
            return list(out[:n]) if got else []
        if not self.can_extend(seq_id, n):
            return []
        held = self._seq.setdefault(seq_id, [])
        pages = []
        for _ in range(n):
            pages.append(self._free[self._shard_of(len(held))].pop())
            held.append(pages[-1])
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
        for slot, p in enumerate(self._seq.pop(seq_id, [])):
            self._free[self._shard_of(slot)].append(p)

    def __del__(self):
        lib = getattr(self, "_lib", None)
        if lib is not None and getattr(self, "_h", None):
            lib.fa_alloc_destroy(self._h)
            self._h = None
