"""Port K8q's plain version (ops/cuda/varlen.py::flash_attn_varlen_fwd_paged_ref
with scales) against the JAX package's flash_attn_varlen_fwd_paged with
k_scales / v_scales at kv_unroll=1 (Pallas interpret mode, P grouped per
page, p_tile=None here), fp32 q, the same int8 / fp8 / int4 pools; and the
port's two flash_attn_with_kvcache routes (K8q and K4q) on one quantized
prefill, as tests/test_quant.py holds the JAX package's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_v100_tpu.ops import quant as jq
from flash_attn_v100_tpu.ops.pallas import masks as jmasks
from flash_attn_v100_tpu.ops.pallas.varlen import (
    flash_attn_varlen_fwd_paged as jax_paged)
from flash_attn_v100_tpu_torch import flash_attn_with_kvcache
from flash_attn_v100_tpu_torch.ops import kvcache as tkv
from flash_attn_v100_tpu_torch.ops import masks as tmasks
from flash_attn_v100_tpu_torch.ops import quant as tq
from flash_attn_v100_tpu_torch.ops.cuda import varlen as tvl
from flash_attn_v100_tpu_torch.ops.reference import mha_reference_kvcache

torch.set_num_threads(1)

KINDS = {"int8": (torch.int8, jnp.int8),
         "fp8": (torch.float8_e4m3fn, jnp.float8_e4m3fn),
         "int4": ("int4", "int4")}
# Against JAX: the integer products are exact on both sides, so O and LSE
# agree to fp32 rounding (1e-5) except where a rounding of P flips: JAX's
# softmax runs in base 2 through XLA's exp2, the port's through torch.exp2,
# and the two differ by an ulp on most inputs.  One flipped int8 step of P
# moves an output by at most max(v_scale) / l, about 0.02 / l, which the
# short causal rows here (l of a few) take to a few 1e-3 (fp8: a bf16 step
# of P, 2^-8 of p v / l), so at most 0.2% of the outputs may leave 1e-5,
# none by more than FLIP_ATOL; the LSE takes P unrounded: within 1e-5.
ATOL = 1e-5
FLIP_ATOL = {"int8": 5e-3, "int4": 5e-3, "fp8": 1e-3}
FLIP_SHARE = 2e-3


def _pools(rng, kind, Hk, P, ps, D):
    (kq, ks), (vq, vs) = (
        jq.quantize_kv(jnp.asarray(rng.standard_normal((Hk, P, ps, D)),
                                   jnp.float32), KINDS[kind][1])
        for _ in range(2))
    return (kq, vq, ks, vs), [tq.payload_from_numpy(np.asarray(a))
                              for a in (kq, vq, ks, vs)]


def _compare(kind, ot, lt, oj, lj):
    d = np.abs(ot.numpy() - np.asarray(oj))
    assert (d > ATOL).mean() <= FLIP_SHARE, (d > ATOL).mean()
    assert d.max() <= FLIP_ATOL[kind], d.max()
    lj = np.asarray(lj)
    assert np.array_equal(np.isneginf(lt.numpy()), np.isneginf(lj))
    fin = np.isfinite(lj)
    np.testing.assert_allclose(lt.numpy()[fin], lj[fin], rtol=0, atol=ATOL)


@pytest.mark.parametrize("kind", list(KINDS))
def test_varlen_paged_quant_plain_matches_jax(kind):
    """2 sequences of 256 new tokens over cache prefixes 150 and 37, the
    shape of tests/test_quant.py's routed prefill."""
    rng = np.random.default_rng(31)
    B, T, Hq, Hk, D, ps, P = 2, 256, 8, 2, 64, 128, 12
    q = rng.standard_normal((B * T, Hq, D)).astype(np.float32)
    jpools, tpools = _pools(rng, kind, Hk, P, ps, D)
    table = np.asarray([[7, 2, 11, 0], [5, 9, 1, 8]], np.int32)
    seqlens = np.asarray([150, 37], np.int32) + T
    cu = np.arange(B + 1, dtype=np.int32) * T
    args = (T, 4 * ps, D ** -0.5)
    mask = dict(causal=True, window_right=0)
    oj, lj = jax_paged(jnp.asarray(q), jpools[0], jpools[1],
                       jnp.asarray(table), jnp.asarray(cu),
                       jnp.asarray(seqlens), *args,
                       jmasks.MaskParams(**mask), k_scales=jpools[2],
                       v_scales=jpools[3], interpret=True, kv_unroll=1)
    ot, lt = tvl.flash_attn_varlen_fwd_paged_ref(
        torch.from_numpy(q), tpools[0], tpools[1], torch.from_numpy(table),
        torch.from_numpy(cu), torch.from_numpy(seqlens), *args,
        tmasks.MaskParams(**mask), k_scales=tpools[2], v_scales=tpools[3],
        p_tile=None)
    assert ot.shape == (B * T, Hq, D) and lt.shape == (Hq, B * T)
    _compare(kind, ot, lt, oj, lj)


def test_varlen_paged_quant_plain_matches_jax_features():
    """Ragged q lengths, window + ALiBi, seqused_k / leftpad_k with an
    empty sequence (O = 0, LSE = -inf), int8; and softcap (the natural-exp
    domain) on int4."""
    rng = np.random.default_rng(37)
    Hq, Hk, D, ps, P = 4, 2, 32, 128, 9
    qlens = [70, 130, 33]
    B = len(qlens)
    cu = np.concatenate([[0], np.cumsum(qlens)]).astype(np.int32)
    q = rng.standard_normal((int(cu[-1]), Hq, D)).astype(np.float32)
    table = np.asarray([[3, 1, 7], [2, 8, 4], [6, 5, 0]], np.int32)
    seqlens = np.asarray([200, 300, 90], np.int32)
    slopes = rng.uniform(0.01, 0.3, (B, Hq)).astype(np.float32)
    cases = (
        ("int8", dict(causal=True, window_left=50, window_right=0,
                      has_alibi=True),
         dict(alibi_slopes=slopes, seqused_k=np.asarray([150, 0, 90],
                                                        np.int32),
              leftpad_k=np.asarray([10, 0, 4], np.int32))),
        ("int4", dict(causal=True, window_right=0, softcap=10.0), {}))
    for kind, mask, extra in cases:
        jpools, tpools = _pools(rng, kind, Hk, P, ps, D)
        args = (max(qlens), 3 * ps, D ** -0.5)
        oj, lj = jax_paged(
            jnp.asarray(q), jpools[0], jpools[1], jnp.asarray(table),
            jnp.asarray(cu), jnp.asarray(seqlens), *args,
            jmasks.MaskParams(**mask), k_scales=jpools[2],
            v_scales=jpools[3], interpret=True, kv_unroll=1,
            **{k: jnp.asarray(v) for k, v in extra.items()})
        ot, lt = tvl.flash_attn_varlen_fwd_paged_ref(
            torch.from_numpy(q), tpools[0], tpools[1],
            torch.from_numpy(table), torch.from_numpy(cu),
            torch.from_numpy(seqlens), *args, tmasks.MaskParams(**mask),
            k_scales=tpools[2], v_scales=tpools[3], p_tile=None,
            **{k: torch.from_numpy(v) for k, v in extra.items()})
        _compare(kind, ot, lt, oj, lj)
        if "seqused_k" in extra:
            rows = slice(cu[1], cu[2])
            assert not ot[rows].any() and torch.isneginf(lt[:, rows]).all()


@pytest.mark.parametrize("kind", list(KINDS))
def test_kvcache_quant_routes_agree(kind, monkeypatch):
    """A routed quantized prefill (group * T >= VARLEN_PREFILL_MIN_ROWS,
    page 128) through K8q's plain version, and the same call pinned to the
    decode route (K4q's): both quantize q and P to int8 (fp8: P to bf16) at
    their own grouping, so they agree to quantization noise, the JAX
    package's gates 0.04 (int8, fp8) and 0.12 (int4); and each meets the
    oracle gate (0.1; int4 0.3) against fp32 attention on the dequantized
    updated pages."""
    rng = np.random.default_rng(41)
    B, T, Hq, Hk, D, ps, P = 2, 256, 8, 2, 64, 128, 12
    int4 = kind == "int4"
    mk = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32))
    q = mk(B, T, Hq, D)
    (kq, ks), (vq, vs) = (tq.quantize_kv(mk(P, ps, Hk, D), KINDS[kind][0],
                                         token_axis=1) for _ in range(2))
    kn, vn = mk(B, T, Hk, D), mk(B, T, Hk, D)
    table = torch.tensor([[7, 2, 11, 0], [5, 9, 1, 8]], dtype=torch.int32)
    cs = torch.tensor([150, 37], dtype=torch.int32)
    assert tkv.uses_varlen_route(True, Hq // Hk, T, ps)

    def run():
        caches = [x.clone() for x in (kq, vq, ks, vs)]
        out = flash_attn_with_kvcache(
            q, caches[0], caches[1], k=kn, v=vn, cache_seqlens=cs,
            block_table=table, causal=True, k_scales=caches[2],
            v_scales=caches[3])
        return out

    out, (k2, v2, ks2, vs2) = run()
    monkeypatch.setattr(tkv, "VARLEN_PREFILL_MIN_ROWS", 1 << 30)
    out_dec, _ = run()
    err_paths = float((out - out_dec).abs().max())
    assert err_paths <= (0.12 if int4 else 0.04), err_paths
    kd = tq.dequantize_kv(k2, ks2, torch.float32, int4=int4, token_axis=1)
    vd = tq.dequantize_kv(v2, vs2, torch.float32, int4=int4, token_axis=1)
    kmat = kd[table.long()].reshape(B, 4 * ps, Hk, D)
    vmat = vd[table.long()].reshape(B, 4 * ps, Hk, D)
    ref = mha_reference_kvcache(q, kmat, vmat, cache_seqlens=cs + T,
                                causal=True)[0]
    for o in (out, out_dec):
        err = float((o - ref).abs().max())
        assert err <= (0.3 if int4 else 0.1), err
