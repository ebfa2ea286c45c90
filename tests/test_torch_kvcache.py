"""Port flash_attn_with_kvcache against the JAX package's, fp32, on both
kernel routes (K4 decode, K8 paged prefill), paged and contiguous caches,
NHD and HND layouts, append and rotary.  Outputs within 1e-5; appended
payloads bit-equal without rotary, within 1e-6 with it (XLA may fuse the
fp32 rotation differently)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from flash_attn_v100_tpu import flash_attn_with_kvcache as jax_kvcache
from flash_attn_v100_tpu_torch import flash_attn_with_kvcache as torch_kvcache
from flash_attn_v100_tpu_torch.ops import kvcache as tkv
from flash_attn_v100_tpu_torch.ops.cuda import varlen as tvl
from flash_attn_v100_tpu_torch.ops.reference import mha_reference_kvcache

torch.set_num_threads(1)

ATOL = 1e-5

# name: (paged, layout, T_new, append, rotary, extra kwargs)
CASES = {
    "contig_nhd_decode_append_rotary": (False, "NHD", 1, True, "half", {}),
    "contig_hnd_append_leftpad_window": (
        False, "HND", 3, True, None,
        dict(cache_leftpad=np.asarray([4, 0, 9], np.int32),
             window_size=(10, -1))),
    "contig_nhd_batch_idx_softcap_alibi": (
        False, "NHD", 2, True, "interleaved",
        dict(cache_batch_idx=np.asarray([2, 0, 1], np.int32), softcap=8.0,
             alibi=True)),
    "paged_nhd_append_rotary_interleaved": (True, "NHD", 2, True,
                                            "interleaved", {}),
    "paged_hnd_no_append_lse_splits": (True, "HND", 1, False, None,
                                       dict(num_splits=3)),
    "paged_hnd_varlen_route_append_rotary": (True, "HND", 256, True, "half",
                                             {}),
}


def _case_inputs(paged, layout, T, append, rotary, extra):
    rng = np.random.default_rng(21)
    Hq, Hk, D = 8, 2, 32
    varlen = T * (Hq // Hk) >= 1024
    B, ps = (2, 128) if varlen else (3, 16)
    mk = lambda *s: rng.standard_normal(s).astype(np.float32)
    kw = dict(causal=True)
    if paged:
        P, mp = 10, 4 if varlen else 8
        shape = (P, ps, Hk, D) if layout == "NHD" else (Hk, P, ps, D)
        tbl = np.stack([rng.permutation(np.arange(1, P))[:mp]
                        for _ in range(B)]).astype(np.int32)
        kw["block_table"] = tbl
        cap = mp * ps
    else:
        N = 64
        shape = (B, N, Hk, D) if layout == "NHD" else (B, Hk, N, D)
        cap = N - 12
    kc, vc = mk(*shape), mk(*shape)
    cs = rng.integers(5, cap - T, size=B).astype(np.int32)
    q = mk(B, T, Hq, D)
    new = (mk(B, T, Hk, D), mk(B, T, Hk, D)) if append else (None, None)
    if rotary:
        ang = rng.uniform(0, 2 * np.pi, (cap + T, D // 2))
        kw.update(rotary_cos=np.cos(ang).astype(np.float32),
                  rotary_sin=np.sin(ang).astype(np.float32),
                  rotary_interleaved=rotary == "interleaved")
    extra = dict(extra)
    if extra.pop("alibi", False):
        kw["alibi_slopes"] = rng.uniform(0.01, 0.2, (B, Hq)).astype(np.float32)
    kw.update(extra)
    return q, kc, vc, new, cs, kw


@pytest.mark.parametrize("name", list(CASES))
def test_kvcache_matches_jax(name):
    paged, layout, T, append, rotary, extra = CASES[name]
    q, kc, vc, (kn, vn), cs, kw = _case_inputs(paged, layout, T, append,
                                               rotary, extra)
    common = dict(kv_cache_layout=layout, return_softmax_lse=True)
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    tkw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    jres = jax_kvcache(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                       k=None if kn is None else jnp.asarray(kn),
                       v=None if vn is None else jnp.asarray(vn),
                       cache_seqlens=jnp.asarray(cs), **common, **jkw)
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    tres = torch_kvcache(torch.from_numpy(q), tk, tv,
                         k=None if kn is None else torch.from_numpy(kn),
                         v=None if vn is None else torch.from_numpy(vn),
                         cache_seqlens=torch.from_numpy(cs), **common, **tkw)
    assert len(tres) == len(jres)
    np.testing.assert_allclose(tres[0].numpy(), np.asarray(jres[0]), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(tres[1].numpy(), np.asarray(jres[1]), rtol=0,
                               atol=ATOL)
    if append:
        (k2, v2), (jk2, jv2) = tres[2], jres[2]
        assert k2 is tk and v2 is tv, "the append must be in place"
        if rotary:
            np.testing.assert_allclose(k2.numpy(), np.asarray(jk2), rtol=0,
                                       atol=1e-6)
        else:
            assert np.array_equal(k2.numpy(), np.asarray(jk2))
        assert np.array_equal(v2.numpy(), np.asarray(jv2))


def test_kvcache_route_selection(monkeypatch):
    """group * T_new >= VARLEN_PREFILL_MIN_ROWS with page_size % 128 routes
    to K8, everything else to K4; the threshold is read at call time."""
    assert tkv.VARLEN_PREFILL_MIN_ROWS == 1024
    assert tkv.uses_varlen_route(True, 8, 128, 128)
    assert not tkv.uses_varlen_route(True, 8, 127, 128)
    assert not tkv.uses_varlen_route(True, 8, 128, 64)
    assert not tkv.uses_varlen_route(False, 8, 512, 128)
    hits = []
    orig = tvl.flash_attn_varlen_fwd_paged_ref
    monkeypatch.setattr(tvl, "flash_attn_varlen_fwd_paged_ref",
                        lambda *a, **k: hits.append(1) or orig(*a, **k))
    monkeypatch.setattr(tkv, "VARLEN_PREFILL_MIN_ROWS", 8)
    q, kc, vc, (kn, vn), cs, kw = _case_inputs(True, "HND", 4, True, None, {})
    kw["block_table"] = torch.from_numpy(kw["block_table"])
    torch_kvcache(torch.from_numpy(q), torch.zeros(2, 10, 128, 32),
                  torch.zeros(2, 10, 128, 32), k=torch.from_numpy(kn),
                  v=torch.from_numpy(vn), cache_seqlens=torch.from_numpy(cs),
                  kv_cache_layout="HND", **kw)
    assert hits, "group * T_new >= threshold must take the K8 route"


def test_kvcache_matches_port_oracle_fp16():
    """fp16 through the plain kernels vs the port's own fp32 oracle
    (mha_reference_kvcache), gated like the JAX tests."""
    from flash_attn_v100_tpu_torch.utils.testing import assert_fwd_close
    rng = np.random.default_rng(4)
    B, T, Hq, Hk, D, N = 2, 2, 4, 2, 32, 48
    mk = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)
                                     ).to(torch.float16)
    q, kc, vc = mk(B, T, Hq, D), mk(B, N, Hk, D), mk(B, N, Hk, D)
    kn, vn = mk(B, T, Hk, D), mk(B, T, Hk, D)
    cs = torch.tensor([10, 30], dtype=torch.int32)
    ref32, kref, _ = mha_reference_kvcache(q, kc, vc, kn, vn,
                                           cache_seqlens=cs, causal=True)
    refnat = mha_reference_kvcache(q, kc, vc, kn, vn, cache_seqlens=cs,
                                   causal=True, upcast=False)[0]
    out, (k2, _) = torch_kvcache(q, kc.clone(), vc.clone(), k=kn, v=vn,
                                 cache_seqlens=cs, causal=True)
    assert_fwd_close(out, ref32, refnat)
    assert torch.equal(k2, kref)


def test_kvcache_rejections():
    q = torch.zeros(1, 1, 2, 32)
    pool = torch.zeros(4, 8, 2, 32)
    bt = torch.zeros(1, 2, dtype=torch.int32)
    with pytest.raises(ValueError):
        torch_kvcache(q, pool, pool, block_table=bt,
                      cache_batch_idx=torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError):
        torch_kvcache(q, pool, pool, block_table=bt,
                      cache_leftpad=torch.zeros(1, dtype=torch.int32))
    # as the JAX package's test_quant_errors: scales on a float cache, and
    # k_scales without v_scales
    scales = torch.ones(4, 8, 2, 1)
    with pytest.raises(ValueError):
        torch_kvcache(q, pool, pool, block_table=bt, k_scales=scales,
                      v_scales=scales)
    pool8 = torch.zeros(4, 8, 2, 32, dtype=torch.int8)
    with pytest.raises(ValueError):
        torch_kvcache(q, pool8, pool8, block_table=bt, k_scales=scales)
    # a pool of another dtype than q is refused, not read through a copy
    pool16 = pool.to(torch.bfloat16)
    with pytest.raises(TypeError):
        torch_kvcache(q, pool16, pool16, block_table=bt)


@pytest.mark.parametrize("kind", ["paged", "contiguous"])
def test_cache_constructors_match_jax(kind):
    """init_paged / init_contiguous build the JAX package's HND caches (same
    shapes, zeros, payload dtype); one append + attention through each
    package's cache then agrees; the quantized caches match JAX's shapes
    and scales; the default device is the GPU."""
    from flash_attn_v100_tpu import cache as jcache
    from flash_attn_v100_tpu_torch import cache as tcache
    rng = np.random.default_rng(8)
    B, T, Hq, Hk, D, ps, P = 2, 3, 4, 2, 32, 16, 6
    if kind == "paged":
        jc = jcache.init_paged(P, ps, Hk, D, dtype=jnp.float32)
        tc = tcache.init_paged(P, ps, Hk, D, dtype=torch.float32, device="cpu")
        assert tc.page_size == ps and tc.num_pages == P
        tbl = np.asarray([[1, 2, 3], [4, 5, 0]], np.int32)
        extra = dict(block_table=tbl)
    else:
        jc = jcache.init_contiguous(B, 48, Hk, D, dtype=jnp.float32)
        tc = tcache.init_contiguous(B, 48, Hk, D, dtype=torch.float32,
                                    device="cpu")
        extra = {}
    assert tuple(tc.k.shape) == tuple(jc.k.shape)
    assert tc.k.dtype == torch.float32 and not tc.k.any() and not tc.v.any()
    q, kn, vn = (rng.standard_normal(s).astype(np.float32)
                 for s in ((B, T, Hq, D), (B, T, Hk, D), (B, T, Hk, D)))
    cs = np.asarray([5, 9], np.int32)
    jout = jax_kvcache(jnp.asarray(q), jc.k, jc.v, k=jnp.asarray(kn),
                       v=jnp.asarray(vn), cache_seqlens=jnp.asarray(cs),
                       causal=True, kv_cache_layout="HND",
                       **{k: jnp.asarray(v) for k, v in extra.items()})
    tout = torch_kvcache(torch.from_numpy(q), tc.k, tc.v,
                         k=torch.from_numpy(kn), v=torch.from_numpy(vn),
                         cache_seqlens=torch.from_numpy(cs), causal=True,
                         kv_cache_layout="HND",
                         **{k: torch.from_numpy(v) for k, v in extra.items()})
    np.testing.assert_allclose(tout[0].numpy(), np.asarray(jout[0]), rtol=0,
                               atol=ATOL)
    assert np.array_equal(tc.k.numpy(), np.asarray(jout[1][0]))
    assert not tc.quantized and tcache.kvcache_kwargs(tc) == dict(
        kv_cache_layout="HND")
    # quantized caches: the JAX package's payload shapes and dtypes, scales
    # of ones (int4: half the token rows, scales per token)
    for tdt, jdt in ((torch.int8, jnp.int8),
                     (torch.float8_e4m3fn, jnp.float8_e4m3fn),
                     ("int4", "int4")):
        if kind == "paged":
            jq = jcache.init_paged(P, ps, Hk, D, dtype=jdt)
            tq = tcache.init_paged(P, ps, Hk, D, dtype=tdt, device="cpu")
        else:
            jq = jcache.init_contiguous(B, 48, Hk, D, dtype=jdt)
            tq = tcache.init_contiguous(B, 48, Hk, D, dtype=tdt, device="cpu")
        assert tq.quantized and jq.quantized
        assert tuple(tq.k.shape) == tuple(jq.k.shape)
        assert str(tq.k.dtype).split(".")[-1] == str(jq.k.dtype)
        assert np.array_equal(tq.k_scales.numpy(), np.asarray(jq.k_scales))
        assert set(tcache.kvcache_kwargs(tq)) == {
            "kv_cache_layout", "k_scales", "v_scales"}
    with pytest.raises(TypeError):
        tcache.init_paged(P, ps, Hk, D, dtype=torch.int16, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tcache.init_contiguous(B, 48, Hk, D)
