"""The fp32 kernels' 3 x TF32 split products on packed documents (K5's
body and K6 / K7's), modelled on the CPU by flash_attn_v100_tpu_torch/ops/
cuda/tf32.py against the JAX package's fp32 flash_attn_varlen_func (Pallas
interpret mode, as its own tests run it).

Gate (utils/testing.py, the fp32 reading of the reference's model): the
model's error against the fp64 oracle (the port's plain twins on fp64
copies) <= 2 x the JAX fp32 output's error + 1e-5 (out, LSE), 3 x + 1e-4
(dq, dk, dv).  One TF32 product instead of the split must miss it.  The
dense cases are tests/test_torch_tf32_split.py, dQ's truncating
accumulation tests/test_torch_tf32_accumulate.py."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from flash_attn_v100_tpu import flash_attn_varlen_func as jax_varlen
from flash_attn_v100_tpu_torch.ops import masks as masklib
from flash_attn_v100_tpu_torch.ops.cuda import tf32
from flash_attn_v100_tpu_torch.ops.cuda import varlen as vl
from flash_attn_v100_tpu_torch.utils.testing import (
    BWD_ATOL, BWD_MULT, FWD_ATOL, FWD_MULT, assert_bwd_close,
    assert_fwd_close, max_abs_err)

torch.set_num_threads(1)

# packed documents: ragged lengths (one of a single token), GQA 4/2,
# causal, D 64 as the training shape's
LENS = [37, 200, 1, 90]
Hq, Hk, D = 4, 2, 64


def _packed():
    rng = np.random.default_rng(31)
    T = sum(LENS)
    q = rng.standard_normal((T, Hq, D)).astype(np.float32)
    k = rng.standard_normal((T, Hk, D)).astype(np.float32)
    v = rng.standard_normal((T, Hk, D)).astype(np.float32)
    do = rng.standard_normal((T, Hq, D)).astype(np.float32)
    cu = np.concatenate([[0], np.cumsum(LENS)]).astype(np.int32)
    return q, k, v, do, cu


def _jax_varlen(q, k, v, do, cu):
    args = (jnp.asarray(cu), jnp.asarray(cu), max(LENS), max(LENS))

    def f(q_, k_, v_):
        return tuple(jax_varlen(q_, k_, v_, *args, causal=True,
                                return_attn_probs=True)[:2])

    (out, lse), vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    grads = vjp((jnp.asarray(do), jnp.zeros_like(lse)))
    return [torch.from_numpy(np.array(x)) for x in (out, lse, *grads)]


def _port_varlen(q, k, v, do, cu, einsum, dtype):
    """The plain twins of K5 and K6 / K7 with every product through
    `einsum`: (out, lse, dq, dk, dv)."""
    qt, kt, vt, dot = (torch.from_numpy(x).to(dtype) for x in (q, k, v, do))
    cut = torch.from_numpy(cu)
    mx, scale = max(LENS), D ** -0.5
    params = masklib.MaskParams(causal=True)
    out, lse = vl.flash_attn_varlen_fwd_ref(qt, kt, vt, cut, cut, mx, mx,
                                            scale, params, upcast=False,
                                            einsum=einsum)
    grads = vl.flash_attn_varlen_bwd_ref(qt, kt, vt, out, dot, lse, cut, cut,
                                         mx, mx, scale, params, upcast=False,
                                         einsum=einsum)
    return [out, lse, *grads]


def test_3xtf32_model_holds_the_fp32_gates_on_packed_documents():
    """K5 / K6 / K7's split model on packed documents: out, LSE, dq, dk and
    dv within the gates against the fp64 oracle, the JAX package's fp32
    flash_attn_varlen_func (and its vjp) the same-dtype reference; one TF32
    product misses the forward gate."""
    q, k, v, do, cu = _packed()
    ref = _jax_varlen(q, k, v, do, cu)
    oracle = _port_varlen(q, k, v, do, cu, torch.einsum, torch.float64)
    split = _port_varlen(q, k, v, do, cu, tf32.einsum_3xtf32, torch.float32)
    one = _port_varlen(q, k, v, do, cu, tf32.einsum_tf32, torch.float32)
    ratios = {}
    for what, got, o, r, o1 in zip(("out", "lse", "dq", "dk", "dv"), split,
                                   oracle, ref, one):
        fin = torch.isfinite(o)
        assert torch.equal(fin, torch.isfinite(got)), what
        got, o, r, o1 = (x[fin].double() for x in (got, o, r, o1))
        fwd = what in ("out", "lse")
        check = assert_fwd_close if fwd else assert_bwd_close
        check(got, o, r, name=f"packed {what}")
        mult, atol = (FWD_MULT, FWD_ATOL) if fwd else (BWD_MULT, BWD_ATOL)
        gate = mult * max_abs_err(r, o) + atol
        ratios[what] = (max_abs_err(got, o) / gate, max_abs_err(o1, o) / gate)
    print("packed", {w: f"split {a:.3f}, one tf32 {b:.2f} of the gate"
                     for w, (a, b) in ratios.items()})
    assert ratios["out"][1] > 1.0, ratios
