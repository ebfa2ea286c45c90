"""The port's dense forward/backward entry points (ops/cuda/fwd.py and
ops/cuda/bwd.py, plain versions on the CPU) against the JAX package's
flash_attn_dense_fwd / flash_attn_dense_bwd called directly with the
ring-attention extras (`offset`, `pos_base`, `num_heads_total`) and an lse
cotangent `dlse`, fp32 (out and LSE 1e-5, gradients 1e-4, LSE -inf rows
exact); a bf16 flash_attn_func held to the relative gates of
utils/testing.py against the port's fp32 mha_reference; and the API's
edge cases."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dense_cases as dc
from flash_attn_v100_tpu import flash_attn_func as jax_attn
from flash_attn_v100_tpu.ops.pallas import masks as jmasks
from flash_attn_v100_tpu.ops.pallas.bwd import flash_attn_dense_bwd as jbwd
from flash_attn_v100_tpu.ops.pallas.fwd import flash_attn_dense_fwd as jfwd
from flash_attn_v100_tpu_torch.ops import masks as tmasks
from flash_attn_v100_tpu_torch.ops.cuda.bwd import flash_attn_dense_bwd
from flash_attn_v100_tpu_torch.ops.cuda.fwd import flash_attn_dense_fwd
from flash_attn_v100_tpu_torch.ops.flash_attention import flash_attn_func
from flash_attn_v100_tpu_torch.ops.reference import mha_reference
from flash_attn_v100_tpu_torch.utils.testing import (
    assert_bwd_close, assert_fwd_close)

torch.set_num_threads(1)

# name: (mask kwargs, offset, dropout_p, pos_base, num_heads_total)
RING_CASES = {
    "offset_pos_base_dropout": (dict(causal=True), 40, 0.2, (64, 192, 1, 2),
                                8),
    "negative_offset_window": (dict(causal=True, window_left=16), -64, 0.0,
                               None, None),
}


@pytest.mark.parametrize("name", list(RING_CASES))
def test_dense_fwd_bwd_extras_match_jax(name):
    mkw, offset, p, pos_base, nh = RING_CASES[name]
    B, Hq, Hk, M, N, D = 2, 4, 2, 128, 128, 32
    q, k, v, do, _ = dc.make_inputs(B, Hq, Hk, M, N, D, {}, seed=23)
    dlse = np.random.default_rng(5).standard_normal((B, Hq, M)).astype(
        np.float32)
    seed = np.asarray([0x1234, 0x80000001], np.uint32)
    scale = D ** -0.5
    extras = dict(dropout_p=p, offset=offset, pos_base=pos_base,
                  num_heads_total=nh)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    out_j, lse_j = jfwd(jq, jk, jv, scale, jmasks.MaskParams(**mkw),
                        dropout_seed=jnp.asarray(seed), interpret=True,
                        **extras)
    grads_j = jbwd(jq, jk, jv, out_j, jnp.asarray(do), lse_j, scale,
                   jmasks.MaskParams(**mkw), dropout_seed=jnp.asarray(seed),
                   interpret=True, dlse=jnp.asarray(dlse), **extras)

    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    params = tmasks.MaskParams(**mkw)
    tseed = torch.from_numpy(seed.astype(np.int64))
    out_t, lse_t = flash_attn_dense_fwd(tq, tk, tv, scale, params,
                                        dropout_seed=tseed, **extras)
    dc.close(out_t, out_j, dc.OUT_ATOL, "out")
    dc.close_lse(lse_t, lse_j)
    grads_t = flash_attn_dense_bwd(tq, tk, tv, out_t, torch.from_numpy(do),
                                   lse_t, scale, params, dropout_seed=tseed,
                                   dlse=torch.from_numpy(dlse), **extras)
    for g_t, g_j, what in zip(grads_t, grads_j, ("dq", "dk", "dv")):
        dc.close(g_t, g_j, dc.GRAD_ATOL, what)
    if offset < 0:
        assert torch.isneginf(lse_t[:, :, :-offset]).all()


def test_bf16_within_relative_gates():
    """bf16 inputs: out and every gradient within the relative gates
    (2x / 3x the bf16 reference's error against the fp32 reference)."""
    q, k, v, do, _ = dc.make_inputs(1, 4, 2, 128, 128, 64, {}, seed=31)
    q, k, v, do = (torch.from_numpy(x).to(torch.bfloat16) for x in
                   (q, k, v, do))

    def run(fn, **kw):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fn(*leaves, causal=True, **kw)
        (out.float() * do.float()).sum().backward()
        return out.detach(), [t.grad for t in leaves]

    out, grads = run(flash_attn_func)
    out32, g32 = run(mha_reference, upcast=True)
    outnat, gnat = run(mha_reference, upcast=False)
    assert out.dtype == torch.bfloat16
    assert_fwd_close(out, out32, outnat, name="bf16 out")
    for g, gr32, grn, what in zip(grads, g32, gnat, ("dq", "dk", "dv")):
        assert g.dtype == torch.bfloat16
        assert_bwd_close(g, gr32, grn, name=f"bf16 {what}")


def test_single_row_drops_causal():
    """M == 1: bottom-right causal is a no-op, as in JAX."""
    q, k, v, _, _ = dc.make_inputs(1, 2, 2, 1, 40, 32, {}, seed=3)
    out_t = flash_attn_func(*(torch.from_numpy(x) for x in (q, k, v)),
                            causal=True)
    out_j = jax_attn(*(jnp.asarray(x) for x in (q, k, v)), causal=True)
    dc.close(out_t, out_j, dc.OUT_ATOL, "out")


def test_rejects_softcap_with_dropout_and_seeds_from_generator():
    q, k, v, _, _ = dc.make_inputs(1, 2, 2, 16, 16, 32, {}, seed=4)
    q, k, v = (torch.from_numpy(x) for x in (q, k, v))
    with pytest.raises(ValueError):
        flash_attn_func(q, k, v, dropout_p=0.1, softcap=5.0)
    outs = [flash_attn_func(q, k, v, dropout_p=0.3,
                            generator=torch.Generator().manual_seed(9))
            for _ in range(2)]
    assert torch.equal(outs[0], outs[1])
    other = flash_attn_func(q, k, v, dropout_p=0.3,
                            generator=torch.Generator().manual_seed(10))
    assert not torch.equal(outs[0], other)
