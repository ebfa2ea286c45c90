"""The port's seq-sharded page allocator and scheduler (`num_shards`,
`slots_per_shard`; shard-local ids, slot j owned by shard
min(j // slots_per_shard, num_shards - 1)) against the JAX package's, on
the cases of its tests/test_runtime.py: every decision bit-equal, the
port's Python mirror and its native core alike."""

import numpy as np
import pytest
import torch

from flash_attn_v100_tpu.runtime.allocator import PagedAllocator as JaxAllocator
from flash_attn_v100_tpu.runtime.scheduler import Scheduler as JaxScheduler
from flash_attn_v100_tpu_torch.runtime import native
from flash_attn_v100_tpu_torch.runtime.allocator import PagedAllocator
from flash_attn_v100_tpu_torch.runtime.scheduler import Scheduler

torch.set_num_threads(1)

BACKENDS = [False, True]


@pytest.fixture(autouse=True)
def _native_built():
    assert native.available(), "the native runtime must build here"


@pytest.mark.parametrize("use_native", BACKENDS)
def test_allocator_sharded_slot_mapping(use_native):
    a = PagedAllocator(3, 16, use_native=use_native, num_shards=2,
                       slots_per_shard=2)
    ref = JaxAllocator(3, 16, use_native=False, num_shards=2,
                       slots_per_shard=2)
    assert a.is_native == use_native
    assert a.num_free() == ref.num_free() == 6
    p = a.extend(1, 3)            # slots 0, 1 from shard 0, slot 2 shard 1
    assert p == ref.extend(1, 3) and len(p) == 3
    assert all(0 <= x < 3 for x in p)        # ids are shard-local
    for n in (2, 1):              # shard 0 has 1 page left
        assert a.can_extend(2, n) == ref.can_extend(2, n)
    assert not a.can_extend(2, 2) and a.extend(2, 2) == [] == ref.extend(2, 2)
    a.release(1)
    ref.release(1)
    assert a.num_free() == ref.num_free() == 6
    assert a.can_extend(2, 2)


@pytest.mark.parametrize("use_native", BACKENDS)
def test_allocator_sharded_random_ops_match_jax(use_native):
    a = PagedAllocator(5, 8, use_native=use_native, num_shards=3,
                       slots_per_shard=2)
    ref = JaxAllocator(5, 8, use_native=False, num_shards=3,
                       slots_per_shard=2)
    rng = np.random.default_rng(5)
    for _ in range(120):
        sid = int(rng.integers(0, 6))
        # slots stay below num_shards * slots_per_shard, as the engine's
        # do: past it the native core counts the last shard's demand
        # short (the reference's csrc/fa_runtime.cpp can_extend)
        n = int(rng.integers(0, 7 - len(ref.pages_of(sid))))
        if rng.random() < 0.3:
            a.release(sid)
            ref.release(sid)
        else:
            assert a.can_extend(sid, n) == ref.can_extend(sid, n)
            assert a.extend(sid, n) == ref.extend(sid, n)
        assert a.pages_of(sid) == ref.pages_of(sid)
        assert a.num_free() == ref.num_free()


@pytest.mark.parametrize("use_native", BACKENDS)
def test_scheduler_sharded_capacity_scales(use_native):
    """One 8-page sequence fits in 2 shards of 4 pages; the unsharded
    4-page pool never admits it."""
    s0 = Scheduler(max_batch=1, num_pages=4, page_size=4,
                   use_native=use_native)
    assert s0.add(7, prompt_len=29, max_new_tokens=2)
    assert s0.step() == []
    s = Scheduler(max_batch=1, num_pages=4, page_size=4,
                  use_native=use_native, num_shards=2, slots_per_shard=4)
    ref = JaxScheduler(max_batch=1, num_pages=4, page_size=4,
                       use_native=False, num_shards=2, slots_per_shard=4)
    assert s.add(7, prompt_len=29, max_new_tokens=2)
    ref.add(7, prompt_len=29, max_new_tokens=2)
    assert s.step() == ref.step() == [(7, True)]
    assert s.pages_of(7) == ref.pages_of(7) and len(s.pages_of(7)) == 8
    assert s.stats() == ref.stats() and s.stats()["free_pages"] == 0
    assert s.advance(7) == ref.advance(7)
    assert s.advance(7) and ref.advance(7)            # budget hit
    s.finish(7)
    assert s.stats()["free_pages"] == 8


@pytest.mark.parametrize("use_native", BACKENDS)
def test_scheduler_sharded_random_schedule_matches_jax(use_native):
    """The JAX package's randomized sharded schedule: batches, pages,
    finishes and stats bit-equal to its scheduler's."""
    rng = np.random.default_rng(1)
    mk = lambda cls, **kw: cls(max_batch=4, num_pages=6, page_size=4,
                               num_shards=4, slots_per_shard=2, **kw)
    s, ref = mk(Scheduler, use_native=use_native), mk(JaxScheduler,
                                                       use_native=False)
    nid = 0
    for it in range(80):
        if rng.random() < 0.4 and nid < 24:
            pl, mn = int(rng.integers(1, 24)), int(rng.integers(1, 8))
            assert s.add(nid, pl, mn) == ref.add(nid, pl, mn)
            nid += 1
        bs, br = s.step(), ref.step()
        assert bs == br, f"iter {it}: {bs} != {br}"
        for sid, _ in bs:
            assert s.pages_of(sid) == ref.pages_of(sid)
            fs, fr = s.advance(sid), ref.advance(sid)
            assert fs == fr
            if fs:
                s.finish(sid)
                ref.finish(sid)
        assert s.stats() == ref.stats(), f"iter {it}"


def test_sharded_arguments_checked():
    for kw in (dict(num_shards=0), dict(slots_per_shard=0)):
        with pytest.raises(ValueError):
            PagedAllocator(4, 8, use_native=False, **kw)
