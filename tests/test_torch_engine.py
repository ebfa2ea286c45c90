"""Port serving path against the JAX package: params_from_jax + paged_forward
logits (fp32, 1e-4), allocator / scheduler decisions (exact), and greedy
ServingEngine tokens (exact) on the tiny fp32 config."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_v100_tpu.runtime import engine as jengine
from flash_attn_v100_tpu.runtime import native as jnative
from flash_attn_v100_tpu.runtime.allocator import PagedAllocator as JaxAllocator
from flash_attn_v100_tpu.runtime.scheduler import Scheduler as JaxScheduler
from flash_attn_v100_tpu_torch import ServingEngine as TorchEngine
from flash_attn_v100_tpu_torch import config as tconfig
from flash_attn_v100_tpu_torch.models import transformer as tmodel
from flash_attn_v100_tpu_torch.runtime import engine as tengine
from flash_attn_v100_tpu_torch.runtime import native as tnative
from flash_attn_v100_tpu_torch.runtime.allocator import PagedAllocator
from flash_attn_v100_tpu_torch.runtime.scheduler import Scheduler

import torch_engine_scenarios as sc

torch.set_num_threads(1)

LOGITS_ATOL = 1e-4


def test_paged_forward_logits_match_jax():
    """One prefill and one decode step through the layer-folded pools."""
    (jcfg, jparams), (tcfg, tparams) = sc.make_models()
    L, Hk, D, ps, npg = jcfg.n_layers, jcfg.n_kv_heads, jcfg.head_dim, 8, 6
    shape = (Hk, (npg + 1) * L, ps, D)
    rng = np.random.default_rng(0)
    tbl = np.asarray([[1, 2, 3, 0, 0, 0, 0, 0], [4, 5, 0, 0, 0, 0, 0, 0]],
                     np.int32)
    steps = [(rng.integers(0, 64, (2, 8)), np.asarray([0, 0], np.int32)),
             (rng.integers(0, 64, (2, 1)), np.asarray([8, 5], np.int32))]
    jk, jv = jnp.zeros(shape), jnp.zeros(shape)
    tk, tv = torch.zeros(shape), torch.zeros(shape)
    jfwd = jax.jit(jengine.paged_forward, static_argnames=("cfg",))
    for toks, cs in steps:
        jl, jk, jv = jfwd(
            jparams, jk, jv, jnp.asarray(toks, jnp.int32), jnp.asarray(cs),
            jnp.asarray(tbl), cfg=jcfg)
        tl, tk2, tv2 = tengine.paged_forward(
            tparams, tk, tv, torch.from_numpy(toks), torch.from_numpy(cs),
            torch.from_numpy(tbl), tcfg)
        assert tk2 is tk and tv2 is tv
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=LOGITS_ATOL)
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0,
                                   atol=1e-5)
        # last_idx computes the same rows
        T = toks.shape[1]
        tk_c, tv_c = tk.clone(), tv.clone()
        last = torch.full((2,), T - 1)
        tl_last = tengine.paged_forward(
            tparams, tk_c, tv_c, torch.from_numpy(toks), torch.from_numpy(cs),
            torch.from_numpy(tbl), tcfg, last_idx=last)[0]
        np.testing.assert_allclose(tl_last[:, 0].numpy(),
                                   np.asarray(jl)[:, -1], rtol=0,
                                   atol=LOGITS_ATOL)


def test_params_from_jax_names_and_lm_head():
    (jcfg, jparams), _ = sc.make_models(qkv_bias=True)
    tree = jax.device_get(jparams)
    tree = dict(tree, lm_head=np.ones((jcfg.dim, jcfg.vocab_size), np.float32))
    p = tmodel.params_from_jax(tree, device="cpu", dtype=torch.bfloat16)
    assert set(p) == {"embed", "layers", "ln_f", "lm_head"}
    assert set(p["layers"][0]) == set(tree["layers"][0])
    assert {"bq", "bk", "bv"} <= set(p["layers"][0])
    assert p["lm_head"].dtype == torch.bfloat16
    assert p["embed"].shape == tuple(tree["embed"].shape)


def test_rmsnorm_casts_before_scale():
    x = torch.tensor([[1.0, 2.0, 3.0, 4.0]], dtype=torch.bfloat16)
    scale = torch.full((4,), 1.5, dtype=torch.bfloat16)
    x32 = x.float()
    expect = (x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + 1e-5)
              ).to(torch.bfloat16) * scale
    assert torch.equal(tmodel.rmsnorm(x, scale), expect)


def test_native_library_builds():
    assert tnative.available(), "native runtime failed to build/load"
    assert str(tnative._BUILD).endswith("flash_attn_v100_tpu_torch/build")


@pytest.mark.parametrize("use_native", [False, True])
def test_scheduler_matches_jax(use_native):
    """A randomized schedule through the port's scheduler (native C++ and
    Python mirror) and the JAX package's: identical batches, pages, stats."""
    if not jnative.available():
        pytest.skip("JAX package's native runtime unavailable")
    rng = np.random.default_rng(0)
    ours = Scheduler(max_batch=4, num_pages=16, page_size=4,
                     use_native=use_native)
    assert ours.is_native == use_native
    ref = JaxScheduler(max_batch=4, num_pages=16, page_size=4,
                       use_native=True)
    nid = 0
    for it in range(60):
        if rng.random() < 0.4 and nid < 20:
            pl, mn = int(rng.integers(1, 12)), int(rng.integers(1, 6))
            assert ours.add(nid, pl, mn) == ref.add(nid, pl, mn)
            nid += 1
        bo, br = ours.step(), ref.step()
        assert bo == br, f"iter {it}: {bo} != {br}"
        for sid, _ in bo:
            assert ours.pages_of(sid) == ref.pages_of(sid)
            fo, fr = ours.advance(sid), ref.advance(sid)
            assert fo == fr
            if fo:
                ours.finish(sid)
                ref.finish(sid)
        assert ours.stats() == ref.stats(), f"iter {it}"


@pytest.mark.parametrize("use_native", [False, True])
def test_allocator_basics(use_native):
    a = PagedAllocator(8, 16, use_native=use_native)
    assert a.is_native == use_native
    p1 = a.extend(1, 3)
    p2 = a.extend(2, 5)
    assert len(p1) == 3 and len(p2) == 5 and a.num_free() == 0
    assert not set(p1) & set(p2)
    assert a.extend(3, 1) == []
    a.release(1)
    assert a.num_free() == 3 and a.pages_of(1) == []
    assert a.pages_of(2) == p2
    # a random run in lockstep with the JAX package's allocator: the same
    # page ids, refusals and free counts
    ours = PagedAllocator(12, 16, use_native=use_native)
    ref = JaxAllocator(12, 16, use_native=False)
    rng = np.random.default_rng(1)
    for _ in range(80):
        sid, n = int(rng.integers(0, 5)), int(rng.integers(0, 4))
        if rng.random() < 0.3:
            ours.release(sid)
            ref.release(sid)
        else:
            assert ours.can_extend(sid, n) == ref.can_extend(sid, n)
            assert ours.extend(sid, n) == ref.extend(sid, n)
        assert ours.pages_of(sid) == ref.pages_of(sid)
        assert ours.num_free() == ref.num_free()


def test_engine_greedy_matches_jax():
    """3 prompts x 6 tokens, page_size 8: identical greedy tokens, TTFTs
    stamped."""
    j, t = sc.both(sc.three_prompts, jax_kw=dict(decode_fuse=1),
                   torch_kw=dict(decode_fuse=1), max_batch=4, num_pages=32,
                   page_size=8)
    assert (sc.assert_same(j, t) == 6).all()


def test_engine_rejects_later_slices_and_missing_gpu():
    _, (tcfg, tparams) = sc.make_models()
    with pytest.raises((TypeError, ValueError)):     # not a parallel Mesh
        TorchEngine(tparams, tcfg, page_size=8, device="cpu", mesh=object())
    # quantized pools (slice 4) are built: int4 packs two tokens a byte
    for kv_dtype, rows in ((torch.int8, 8), ("float8_e4m3fn", 8),
                           ("int4", 4)):
        eng = TorchEngine(tparams, tcfg, page_size=8, num_pages=4,
                          device="cpu", kv_dtype=kv_dtype)
        assert eng.quantized and eng.k_pool.shape[2] == rows
        assert eng.k_scales.shape == eng.k_pool.shape[:2] + (8, 1)
    for kv_dtype in (torch.bfloat16, torch.float8_e5m2):
        with pytest.raises(TypeError):       # 16/32-bit pools: model dtype
            TorchEngine(tparams, tcfg, page_size=8, device="cpu",
                        kv_dtype=kv_dtype)
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError):
        tconfig.resolve_device(None)          # the default is the GPU
    with pytest.raises(RuntimeError):
        TorchEngine(tparams, tcfg, page_size=8)
    with pytest.raises(RuntimeError):
        tmodel.init_params(tcfg)


def test_engine_sampling_and_streaming():
    """Per-request top-k/top-p sampling stays in the vocabulary and is
    reproducible from rng_seed; on_token streams exactly the result."""
    _, (tcfg, tparams) = sc.make_models()
    streamed = {}

    def script(eng):
        sp = tengine.SamplingParams(temperature=0.8, top_k=5, top_p=0.9)
        return {"s": eng.submit([3, 1, 4], max_new_tokens=7, sampling=sp,
                                on_token=lambda r, toks: streamed.setdefault(
                                    r, []).extend(toks)),
                "g": eng.submit([2, 7], max_new_tokens=5)}
    a = sc.run(TorchEngine, tparams, tcfg, script, max_batch=2, num_pages=16,
               page_size=8, rng_seed=5)
    assert streamed[0] == a[0]["s"]
    b = sc.run(TorchEngine, tparams, tcfg, script, max_batch=2, num_pages=16,
               page_size=8, rng_seed=5)
    assert a[0] == b[0]
    assert all(0 <= x < tcfg.vocab_size for x in a[0]["s"])
    assert len(a[0]["s"]) == 7 and len(a[0]["g"]) == 5
