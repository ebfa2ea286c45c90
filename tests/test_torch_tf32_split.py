"""The 3 x TF32 split products of the fp32 kernels (K1's body: K1, K5, K8;
K2's: K2, K6; K3's: K3, K7), modelled on the CPU by
flash_attn_v100_tpu_torch/ops/cuda/tf32.py, against the JAX package's fp32
flash_attn_func (Pallas interpret mode) and its jax.grad.  Packed
documents: tests/test_torch_tf32_split_varlen.py.

Gate (utils/testing.py, the fp32 reading of the reference's model): the
model's error against the fp64 oracle (the port's plain twins on fp64
copies) <= 2 x the JAX fp32 output's error + 1e-5 (out, LSE), 3 x + 1e-4
(dq, dk, dv).  One TF32 product instead of the split must miss it: the
gate tells the two apart."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_v100_tpu import flash_attn_func as jax_attn
from flash_attn_v100_tpu_torch.ops import flash_attention as fa_mod
from flash_attn_v100_tpu_torch.ops import masks as masklib
from flash_attn_v100_tpu_torch.ops.cuda import build
from flash_attn_v100_tpu_torch.ops.cuda import bwd as dbwd
from flash_attn_v100_tpu_torch.ops.cuda import fwd as dfwd
from flash_attn_v100_tpu_torch.ops.cuda import tf32
from flash_attn_v100_tpu_torch.utils.testing import (
    BWD_ATOL, BWD_MULT, FWD_ATOL, FWD_MULT, assert_bwd_close,
    assert_fwd_close, max_abs_err)

torch.set_num_threads(1)


def test_split_tf32_is_exact():
    """hi keeps 10 mantissa bits (the low 13 bits zero) and hi + lo gives x
    to 2**-22 of |x|, over 30 binades of both signs."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(20000) * 2.0 ** rng.integers(-15, 15, 20000)
         ).astype(np.float32)
    xt = torch.from_numpy(x)
    hi, lo = tf32.split_tf32(xt)
    assert int((hi.view(torch.int32) & 0x1FFF).abs().max()) == 0
    assert int((lo.view(torch.int32) & 0x1FFF).abs().max()) == 0
    rel = ((hi.double() + lo.double() - xt.double()).abs()
           / xt.double().abs()).max()
    assert float(rel) <= 2.0 ** -22
    # hi is the nearest TF32 value: |x - hi| <= half its unit
    assert float(((xt.double() - hi.double()).abs()
                  / xt.double().abs()).max()) <= 2.0 ** -11


def test_round_tf32_ties_away_from_zero():
    """cvt.rna: a value halfway between two TF32 values rounds to the one of
    larger magnitude; inf and NaN pass."""
    one = np.float32(1.0)
    half_ulp = np.float32(2.0 ** -11)   # TF32's unit at 1 is 2**-10
    x = torch.tensor([one + half_ulp, -(one + half_ulp),
                      one + np.float32(2.0 ** -12), float("inf"),
                      float("nan")], dtype=torch.float32)
    r = tf32.round_tf32(x)
    assert r[0] == 1.0 + 2.0 ** -10 and r[1] == -(1.0 + 2.0 ** -10)
    assert r[2] == 1.0 and torch.isinf(r[3]) and torch.isnan(r[4])


def test_matmul_3xtf32_against_fp64():
    """A 64 x 256 x 64 product: the split's error is within a few times
    fp32's own, one TF32 product's about 2**10 times larger."""
    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.standard_normal((64, 256)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((256, 64)).astype(np.float32))
    ref = a.double() @ b.double()
    e32 = max_abs_err(a @ b, ref)
    e3 = max_abs_err(tf32.matmul_3xtf32(a, b), ref)
    e1 = max_abs_err(tf32.einsum_tf32("ik,kj->ij", a, b), ref)
    assert e3 <= 4 * e32, (e3, e32)
    assert e1 >= 100 * e32, (e1, e32)


def test_parse_sass_counts_named_opcodes():
    """`ops` adds a count of the lines holding all of a key's strings, so a
    TF32 HMMA and an FFMA are told apart from the other HMMAs."""
    sass = """\
                Function : _Z3fooPf
        /*0100*/                   HMMA.1684.F32.TF32 R4, R8, R12, R4 ;
        /*0110*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
        /*0120*/                   FFMA R5, R6, R7, R5 ;
"""
    got = build.parse_sass(sass, {}, {"tf32": ("HMMA.", ".TF32"),
                                      "ffma": ("FFMA",)})
    assert got == {"_Z3fooPf": dict(hgmma=0, hmma=2, mufu_ex2=0, tf32=1,
                                    ffma=1)}


# name: (B, Hq, Hk, M, N, D, mask kwargs, alibi, dropout_p); the last is
# the sweep's largest head dim over a 1024-key sum
CASES = {
    "causal_gqa": (2, 4, 2, 96, 96, 64, dict(causal=True), False, 0.0),
    "window_softcap_alibi": (1, 2, 2, 70, 90, 32,
                             dict(window_size=(24, 8), softcap=20.0), True,
                             0.0),
    "causal_d128_group2": (1, 2, 1, 80, 80, 128, dict(causal=True), False,
                           0.0),
    "d256_long": (1, 1, 1, 128, 1024, 256, {}, False, 0.0),
}


def _case(B, Hq, Hk, M, N, D, mask, alibi, p):
    rng = np.random.default_rng(23)
    q = rng.standard_normal((B, M, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, N, Hk, D)).astype(np.float32)
    v = rng.standard_normal((B, N, Hk, D)).astype(np.float32)
    do = rng.standard_normal((B, M, Hq, D)).astype(np.float32)
    slopes = (np.asarray([0.5 ** (i + 1) for i in range(Hq)], np.float32)
              if alibi else None)
    return q, k, v, do, slopes


def _jax(q, k, v, do, slopes, mask, p):
    kw = dict(mask)
    if slopes is not None:
        kw["alibi_slopes"] = jnp.asarray(slopes)
    if p:
        kw.update(dropout_p=p, dropout_seed=7)
    qj, kj, vj = (jnp.asarray(x) for x in (q, k, v))
    out, lse, _ = jax_attn(qj, kj, vj, return_attn_probs=True, **kw)
    grads = jax.grad(lambda *a: (jax_attn(*a, **kw) * do).sum(),
                     argnums=(0, 1, 2))(qj, kj, vj)
    return [torch.from_numpy(np.array(x)) for x in (out, lse, *grads)]


def _port(q, k, v, do, slopes, mask, p, einsum, dtype):
    """The plain twins of K1 and K2 / K3 with every product through
    `einsum`: (out, lse, dq, dk, dv)."""
    wl, wr = mask.get("window_size", (-1, -1))
    params = masklib.MaskParams(causal=mask.get("causal", False),
                                window_left=wl, window_right=wr,
                                softcap=mask.get("softcap", 0.0),
                                has_alibi=slopes is not None)
    qt, kt, vt, dot = (torch.from_numpy(x).to(dtype) for x in (q, k, v, do))
    st = None if slopes is None else torch.from_numpy(slopes)
    scale = q.shape[-1] ** -0.5
    kw = dict(alibi_slopes=st, dropout_p=p,
              dropout_seed=fa_mod.normalize_seed(p, 7), upcast=False)
    out, lse = dfwd.flash_attn_dense_fwd_ref(qt, kt, vt, scale, params,
                                             einsum=einsum, **kw)
    grads = dbwd.flash_attn_dense_bwd_ref(qt, kt, vt, out, dot, lse, scale,
                                          params, einsum=einsum, **kw)
    return [out, lse, *grads]


@pytest.mark.parametrize("name", list(CASES))
def test_3xtf32_model_holds_the_fp32_gates(name):
    """The split model's out, LSE, dq, dk and dv within the gates against
    the fp64 oracle, the JAX package's fp32 outputs the same-dtype
    reference; one TF32 product misses the forward gate on every case."""
    B, Hq, Hk, M, N, D, mask, alibi, p = CASES[name]
    q, k, v, do, slopes = _case(*CASES[name])
    ref = _jax(q, k, v, do, slopes, mask, p)
    oracle = _port(q, k, v, do, slopes, mask, p, torch.einsum, torch.float64)
    split = _port(q, k, v, do, slopes, mask, p, tf32.einsum_3xtf32,
                  torch.float32)
    one = _port(q, k, v, do, slopes, mask, p, tf32.einsum_tf32,
                torch.float32)
    ratios = {}
    for what, got, o, r, o1 in zip(("out", "lse", "dq", "dk", "dv"), split,
                                   oracle, ref, one):
        fin = torch.isfinite(o)
        assert torch.equal(fin, torch.isfinite(got)), what
        got, o, r, o1 = (x[fin].double() for x in (got, o, r, o1))
        fwd = what in ("out", "lse")
        check = assert_fwd_close if fwd else assert_bwd_close
        check(got, o, r, name=f"{name} {what}")
        mult, atol = (FWD_MULT, FWD_ATOL) if fwd else (BWD_MULT, BWD_ATOL)
        gate = mult * max_abs_err(r, o) + atol
        ratios[what] = (max_abs_err(got, o) / gate, max_abs_err(o1, o) / gate)
    print(name, {w: f"split {a:.3f}, one tf32 {b:.2f} of the gate"
                 for w, (a, b) in ratios.items()})
    assert ratios["out"][1] > 1.0, ratios
