"""Continuous-batching scheduler for paged decode.

Policy (implemented natively in csrc/fa_runtime.cpp, mirrored here in Python):

  * FIFO admission: waiting requests join the running batch in arrival order
    while batch slots remain AND the allocator can cover ceil((prompt+1)/ps)
    pages.  Head-of-line blocking is intentional — no starvation.
  * Per-step reservation: every running sequence is guaranteed capacity for
    one more token before the step's batch is emitted.
  * LIFO preemption: under page pressure the youngest running request loses
    its pages (its KV is recomputed by a later prefill) and returns to the
    FRONT of the waiting queue.

This subsystem is new relative to the reference (which is a single-call
library; its `block_table`/`num_splits` machinery is the hook this sits on:
kernel/fused_mha_forward_kvcache.cu:462,479-501).
"""

from __future__ import annotations

import ctypes
import dataclasses
from collections import deque
from typing import Dict, List, Tuple

from flash_attn_v100_tpu_torch.runtime import native


@dataclasses.dataclass
class _Req:
    id: int
    prompt_len: int
    max_new_tokens: int
    generated: int = 0
    needs_prefill: bool = True

    @property
    def cur_len(self) -> int:
        return self.prompt_len + self.generated


class Scheduler:
    """See module docstring.  `step()` returns [(seq_id, needs_prefill)]."""

    def __init__(self, max_batch: int, num_pages: int, page_size: int,
                 use_native: bool = True, num_shards: int = 1,
                 slots_per_shard: int = 2**31 - 1):
        """`num_shards` / `slots_per_shard`: the seq-sharded page pool of
        allocator.PagedAllocator; `num_pages` then counts per shard."""
        if max_batch <= 0:
            raise ValueError("max_batch must be positive")
        self.max_batch = max_batch
        self.page_size = page_size
        self.num_pages = num_pages
        self._lib = native.load() if use_native else None
        if self._lib is not None:
            self._h = self._lib.fa_sched_create_sharded(
                max_batch, num_pages, page_size, num_shards, slots_per_shard)
        else:
            from flash_attn_v100_tpu_torch.runtime.allocator import PagedAllocator
            self._alloc = PagedAllocator(num_pages, page_size, use_native=False,
                                         num_shards=num_shards,
                                         slots_per_shard=slots_per_shard)
            self._waiting: deque = deque()
            self._running: List[int] = []
            self._reqs: Dict[int, _Req] = {}
            self._preempts = 0

    @property
    def is_native(self) -> bool:
        return self._lib is not None

    # ---- API ----

    def add(self, seq_id: int, prompt_len: int, max_new_tokens: int) -> bool:
        if self._lib is not None:
            return bool(self._lib.fa_sched_add(self._h, seq_id, prompt_len,
                                               max_new_tokens))
        if seq_id in self._reqs or prompt_len <= 0 or max_new_tokens <= 0:
            return False
        self._reqs[seq_id] = _Req(seq_id, prompt_len, max_new_tokens)
        self._waiting.append(seq_id)
        return True

    def step(self) -> List[Tuple[int, bool]]:
        if self._lib is not None:
            cap = self.max_batch
            ids = (ctypes.c_int64 * cap)()
            pf = (ctypes.c_int8 * cap)()
            n = self._lib.fa_sched_step(self._h, ids, pf, cap)
            assert n >= 0, "scheduler batch exceeded cap"
            return [(ids[i], bool(pf[i])) for i in range(n)]
        return self._py_step()

    def advance(self, seq_id: int) -> bool:
        """Record one generated token.  True => request just hit its token
        budget (caller finishes it)."""
        if self._lib is not None:
            r = self._lib.fa_sched_advance(self._h, seq_id)
            if r < 0:
                raise KeyError(seq_id)
            return bool(r)
        r = self._reqs[seq_id]
        r.needs_prefill = False
        r.generated += 1
        return r.generated >= r.max_new_tokens

    def finish(self, seq_id: int) -> None:
        if self._lib is not None:
            self._lib.fa_sched_finish(self._h, seq_id)
            return
        self._alloc.release(seq_id)
        if seq_id in self._running:
            self._running.remove(seq_id)
        self._reqs.pop(seq_id, None)

    def pages_of(self, seq_id: int) -> List[int]:
        if self._lib is not None:
            n = self._lib.fa_sched_pages_of(self._h, seq_id, None, 0)
            if n == 0:
                return []
            out = (ctypes.c_int32 * n)()
            self._lib.fa_sched_pages_of(self._h, seq_id, out, n)
            return list(out)
        return self._alloc.pages_of(seq_id)

    def stats(self) -> Dict[str, int]:
        if self._lib is not None:
            return dict(
                free_pages=self._lib.fa_sched_num_free_pages(self._h),
                waiting=self._lib.fa_sched_num_waiting(self._h),
                running=self._lib.fa_sched_num_running(self._h),
                preemptions=self._lib.fa_sched_num_preemptions(self._h),
            )
        return dict(free_pages=self._alloc.num_free(),
                    waiting=len(self._waiting), running=len(self._running),
                    preemptions=self._preempts)

    # ---- pure-Python mirror of Scheduler::step ----

    def _pages_for(self, length: int) -> int:
        return -(-length // self.page_size)

    def _preempt_youngest(self) -> None:
        sid = self._running.pop()
        r = self._reqs[sid]
        self._alloc.release(sid)
        # generated kept: already emitted; re-prefill covers prompt+generated
        r.needs_prefill = True
        self._waiting.appendleft(sid)
        self._preempts += 1

    def _py_step(self) -> List[Tuple[int, bool]]:
        i = 0
        while i < len(self._running):
            r = self._reqs[self._running[i]]
            held = len(self._alloc.pages_of(r.id))
            need = self._pages_for(r.cur_len + 1) - held
            while need > 0 and not self._alloc.can_extend(r.id, need) and \
                    len(self._running) > i + 1:
                self._preempt_youngest()
            if need > 0 and not self._alloc.extend(r.id, need):
                self._alloc.release(r.id)
                r.needs_prefill = True
                self._waiting.appendleft(r.id)
                del self._running[i]
                self._preempts += 1
                continue
            i += 1
        while self._waiting and len(self._running) < self.max_batch:
            sid = self._waiting[0]
            r = self._reqs[sid]
            need = self._pages_for(r.cur_len + 1)
            if not self._alloc.can_extend(sid, need):
                break
            self._alloc.extend(sid, need)
            self._waiting.popleft()
            r.needs_prefill = True
            self._running.append(sid)
        return [(sid, self._reqs[sid].needs_prefill) for sid in self._running]

    def __del__(self):
        lib = getattr(self, "_lib", None)
        if lib is not None and getattr(self, "_h", None):
            lib.fa_sched_destroy(self._h)
            self._h = None
