"""Port K8 (plain path of ops/cuda/varlen.py) against the JAX package's
flash_attn_varlen_fwd_paged (Pallas interpret mode), fp32, same numpy
inputs.  Tolerance 1e-5 (fp32 op outputs)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from flash_attn_v100_tpu.ops.pallas import masks as jmasks
from flash_attn_v100_tpu.ops.pallas.varlen import (
    flash_attn_varlen_fwd_paged as jax_paged)
from flash_attn_v100_tpu_torch.ops import masks as tmasks
from flash_attn_v100_tpu_torch.ops.cuda import decode as tdec
from flash_attn_v100_tpu_torch.ops.cuda import varlen as tvl

torch.set_num_threads(1)

ATOL = 1e-5


def _compare(out_t, lse_t, out_j, lse_j):
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=0,
                               atol=ATOL)
    lj = np.asarray(lse_j)
    assert np.array_equal(np.isneginf(lse_t.numpy()), np.isneginf(lj))
    fin = np.isfinite(lj)
    np.testing.assert_allclose(lse_t.numpy()[fin], lj[fin], rtol=0, atol=ATOL)


def test_varlen_paged_plain_matches_jax_kvcache_shape():
    """The shape of tests/test_kvcache.py::test_paged_prefill_routes_varlen_
    kernel: 2 sequences of 256 new tokens over cache prefixes 150 and 37."""
    rng = np.random.default_rng(5)
    B, T, Hq, Hk, D, ps, P = 2, 256, 8, 2, 64, 128, 12
    q = rng.standard_normal((B * T, Hq, D)).astype(np.float32)
    kp = rng.standard_normal((Hk, P, ps, D)).astype(np.float32)
    vp = rng.standard_normal((Hk, P, ps, D)).astype(np.float32)
    table = np.asarray([[7, 2, 11, 0], [5, 9, 1, 8]], np.int32)
    seqlens = np.asarray([150, 37], np.int32) + T
    cu = np.arange(B + 1, dtype=np.int32) * T
    args = (T, 4 * ps, D ** -0.5)
    oj, lj = jax_paged(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                       jnp.asarray(table), jnp.asarray(cu),
                       jnp.asarray(seqlens), *args,
                       jmasks.MaskParams(causal=True, window_right=0),
                       interpret=True)
    ot, lt = tvl.flash_attn_varlen_fwd_paged(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(table), torch.from_numpy(cu),
        torch.from_numpy(seqlens), *args,
        tmasks.MaskParams(causal=True, window_right=0))
    assert ot.shape == (B * T, Hq, D) and lt.shape == (Hq, B * T)
    _compare(ot, lt, oj, lj)


@pytest.mark.parametrize("feature", ["window_softcap_alibi", "seqused_leftpad"])
def test_varlen_paged_plain_matches_jax_features(feature):
    """Ragged q lengths, window/softcap/ALiBi, seqused_k/leftpad_k (with an
    empty sequence: O = 0, LSE = -inf)."""
    rng = np.random.default_rng(9)
    Hq, Hk, D, ps, P = 4, 2, 32, 128, 9
    qlens = [70, 130, 33]
    B = len(qlens)
    cu = np.concatenate([[0], np.cumsum(qlens)]).astype(np.int32)
    q = rng.standard_normal((int(cu[-1]), Hq, D)).astype(np.float32)
    kp = rng.standard_normal((Hk, P, ps, D)).astype(np.float32)
    vp = rng.standard_normal((Hk, P, ps, D)).astype(np.float32)
    table = np.asarray([[3, 1, 7], [2, 8, 4], [6, 5, 0]], np.int32)
    seqlens = np.asarray([200, 300, 90], np.int32)
    kw_j, kw_t = {}, {}
    if feature == "window_softcap_alibi":
        mp = dict(causal=True, window_left=50, window_right=0, softcap=10.0,
                  has_alibi=True)
        slopes = rng.uniform(0.01, 0.3, (B, Hq)).astype(np.float32)
        kw_j["alibi_slopes"] = jnp.asarray(slopes)
        kw_t["alibi_slopes"] = torch.from_numpy(slopes)
    else:
        mp = dict(causal=True, window_right=0)
        used = np.asarray([150, 0, 90], np.int32)
        lp = np.asarray([10, 0, 4], np.int32)
        kw_j.update(seqused_k=jnp.asarray(used), leftpad_k=jnp.asarray(lp))
        kw_t.update(seqused_k=torch.from_numpy(used),
                    leftpad_k=torch.from_numpy(lp))
    args = (max(qlens), 3 * ps, D ** -0.5)
    oj, lj = jax_paged(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                       jnp.asarray(table), jnp.asarray(cu),
                       jnp.asarray(seqlens), *args, jmasks.MaskParams(**mp),
                       interpret=True, **kw_j)
    ot, lt = tvl.flash_attn_varlen_fwd_paged(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(table), torch.from_numpy(cu),
        torch.from_numpy(seqlens), *args, tmasks.MaskParams(**mp), **kw_t)
    _compare(ot, lt, oj, lj)
    if feature == "seqused_leftpad":
        rows = slice(cu[1], cu[2])
        assert not ot[rows].any() and torch.isneginf(lt[:, rows]).all()


def test_varlen_paged_plain_matches_decode_plain():
    """The two plain kernels compute one function: a causal prefill of T
    tokens over a paged cache gives the same O and LSE through K8's packed
    rows and K4's folded rows."""
    rng = np.random.default_rng(13)
    B, T, Hq, Hk, D, ps, P = 2, 24, 4, 2, 32, 128, 5
    group = Hq // Hk
    q = torch.from_numpy(rng.standard_normal((B, T, Hq, D)).astype(np.float32))
    kp = torch.from_numpy(rng.standard_normal((Hk, P, ps, D)).astype(np.float32))
    vp = torch.from_numpy(rng.standard_normal((Hk, P, ps, D)).astype(np.float32))
    table = torch.tensor([[3, 1], [2, 4]], dtype=torch.int32)
    lens = torch.tensor([40, 150], dtype=torch.int32)       # incl. new tokens
    params = tmasks.MaskParams(causal=True, window_right=0)
    o8, l8 = tvl.flash_attn_varlen_fwd_paged(
        q.reshape(B * T, Hq, D), kp, vp, table,
        torch.arange(B + 1, dtype=torch.int32) * T, lens, T, 2 * ps, 0.17,
        params)
    q_rows = q.transpose(1, 2).reshape(B, Hk, group * T, D)
    o4, l4 = tdec.merge_partials(*tdec.paged_decode_attention(
        q_rows, kp[None], vp[None], table, lens, torch.zeros(B, dtype=torch.int32),
        qpos_vec=lens - T, softmax_scale=0.17, params=params, t_new=T,
        group=group, num_splits=2))
    o4 = o4.reshape(B, Hk, group, T, D).permute(0, 3, 1, 2, 4).reshape(
        B * T, Hq, D)
    l4 = l4[..., 0].reshape(B, Hq, T).permute(1, 0, 2).reshape(Hq, B * T)
    torch.testing.assert_close(o8, o4, rtol=0, atol=ATOL)
    torch.testing.assert_close(l8, l4, rtol=0, atol=ATOL)
