"""K2's dQ accumulation on the tensor cores, modelled on the CPU by
flash_attn_v100_tpu_torch/ops/cuda/tf32.py: the tensor cores add each
product into fp32 by truncation, so dQ takes two key k-steps at a time into
a zeroed fragment and adds it in fp32 (csrc/f32_tiles.cuh `flush`).  The
model of that order, over the training shape's key count, against the fp64
oracle and the JAX package's fp32 dq (Pallas interpret mode) under the
gradient gate (utils/testing.py: 3 x the JAX output's error + 1e-4)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from flash_attn_v100_tpu import flash_attn_func as jax_attn
from flash_attn_v100_tpu_torch.ops import masks as masklib
from flash_attn_v100_tpu_torch.ops.cuda import bwd as dbwd
from flash_attn_v100_tpu_torch.ops.cuda import fwd as dfwd
from flash_attn_v100_tpu_torch.ops.cuda import tf32
from flash_attn_v100_tpu_torch.utils.testing import (
    BWD_ATOL, BWD_MULT, assert_bwd_close, max_abs_err)

torch.set_num_threads(1)

D = 64

# dQ over the training shape's keys (B 4 x 2048, 32/4 x 64, causal): the
# last 64 q rows of one head, which see 1985-2048 keys each
N_KEYS, M_ROWS = 2048, 64


def test_dq_flushed_truncating_chain_holds_the_gradient_gate():
    """K2's dQ += dS K as the tensor cores accumulate it (tf32.
    matmul_3xtf32_chain: truncating additions, two key k-steps into a
    zeroed fragment, then an fp32 add) in the split model of the dense
    backward, within the gradient gate against the fp64 oracle and the JAX
    package's fp32 dq; the same products in one truncating chain (no
    flush) printed beside it, and further off."""
    rng = np.random.default_rng(37)
    q = rng.standard_normal((1, M_ROWS, 1, D)).astype(np.float32)
    k = rng.standard_normal((1, N_KEYS, 1, D)).astype(np.float32)
    v = rng.standard_normal((1, N_KEYS, 1, D)).astype(np.float32)
    do = rng.standard_normal((1, M_ROWS, 1, D)).astype(np.float32)
    qj, kj, vj = (jnp.asarray(x) for x in (q, k, v))
    dq_jax = torch.from_numpy(np.array(jax.grad(
        lambda q_: (jax_attn(q_, kj, vj, causal=True) * do).sum())(qj)))
    params, scale = masklib.MaskParams(causal=True), D ** -0.5

    def port_dq(einsum, dtype):
        qt, kt, vt, dot = (torch.from_numpy(x).to(dtype)
                           for x in (q, k, v, do))
        out, lse = dfwd.flash_attn_dense_fwd_ref(qt, kt, vt, scale, params,
                                                 upcast=False, einsum=einsum)
        return dbwd.flash_attn_dense_bwd_ref(qt, kt, vt, out, dot, lse,
                                             scale, params, upcast=False,
                                             einsum=einsum)[0]

    def kernel_einsum(flush):
        """the split model, dQ's product through the truncating chain"""
        def einsum(eq, a, b):
            if eq == "hmn,hnd->hmd":
                return tf32.matmul_3xtf32_chain(a, b, flush=flush)
            return tf32.einsum_3xtf32(eq, a, b)
        return einsum

    oracle = port_dq(torch.einsum, torch.float64)
    flushed = port_dq(kernel_einsum(2), torch.float32)
    chain = port_dq(kernel_einsum(None), torch.float32)
    assert_bwd_close(flushed, oracle, dq_jax, name="dq, flushed chain")
    gate = BWD_MULT * max_abs_err(dq_jax, oracle) + BWD_ATOL
    e_flush, e_chain = (max_abs_err(x, oracle) for x in (flushed, chain))
    print(f"dq over {N_KEYS} keys: flushed {e_flush:.3e} "
          f"({e_flush / gate:.4f} of the gate), one chain {e_chain:.3e} "
          f"({e_chain / gate:.4f}); the JAX fp32 dq "
          f"{max_abs_err(dq_jax, oracle):.3e}")
    assert e_flush < e_chain, (e_flush, e_chain)
