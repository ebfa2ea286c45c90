"""K4 over fp32 pools (the decode body's fp32 instantiation, csrc/
decode_f32.cu) runs S = Q K^T and O += P V as 3 x TF32 split products on
the tensor cores, O taking each key group's P V from a zeroed fragment
(the tensor cores add into fp32 by truncation; csrc/f32_tiles.cuh `flush`):
16-key groups, two k-steps, at D 32 / 64, 8-key groups at D 128 / 256.
Its model on the CPU (flash_attn_v100_tpu_torch/ops/cuda/tf32.py through
the plain twin's `einsum=` hook: S and P V as split products, P V as the
truncating chain of one warp's key stream, flushed as the kernel flushes)
against the JAX package's fp32 paged_decode_attention + merge_partials
(Pallas interpret mode) and the fp64 oracle (the plain twin on fp64
copies), under the forward gate (utils/testing.py: 2 x the JAX output's
error + 1e-5), at two shapes: a few rows at the engine decode step's
widths, and one split of 2048 keys, the length of a warp's key stream at
the 32k decode.  One TF32 product instead of the split misses the gate;
the same products in one unflushed truncating chain are printed beside
the flushed model (`-s`)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_v100_tpu.ops.pallas import decode as jdec
from flash_attn_v100_tpu.ops.pallas import masks as jmasks
from flash_attn_v100_tpu_torch.ops import masks as tmasks
from flash_attn_v100_tpu_torch.ops.cuda import decode as tdec
from flash_attn_v100_tpu_torch.ops.cuda import tf32
from flash_attn_v100_tpu_torch.utils.testing import (
    FWD_ATOL, FWD_MULT, assert_fwd_close, max_abs_err)

torch.set_num_threads(1)

PV = "bhrsn,bhsnd->bhsrd"   # the plain twin's P V

# name: (lengths, kv heads, group, head dim, page size, table slots,
#        splits, the kernel's k-steps a flush at that head dim)
SHAPES = {
    # the engine's decode step (32/4 x 64, page 128, lengths 600-2000),
    # two batch rows of two kv heads
    "engine_step": ([700, 1900], 2, 8, 64, 128, 16, 8, 2),
    # a warp's key stream at the 32k decode (32/8 x 128, page 512): 2048
    # keys in one split
    "stream_2048": ([2048], 1, 4, 128, 512, 4, 1, 1),
}


def kernel_einsum(flush):
    """The kernel's products: S and P V as 3 x TF32 split products, P V
    accumulated as tf32.matmul_3xtf32_chain (k-steps of 8 keys added by
    truncation, `flush` k-steps into a zeroed fragment; None: one chain)."""
    def einsum(eq, a, b):
        if eq == PV:
            return tf32.matmul_3xtf32_chain(a.transpose(2, 3), b,
                                            flush=flush)
        return tf32.einsum_3xtf32(eq, a, b)
    return einsum


def _case(name):
    lens, Hk, group, D, ps, mp, splits, flush = SHAPES[name]
    rng = np.random.default_rng(25)
    B = len(lens)
    P = B * mp + 1
    q = rng.standard_normal((B, Hk, 8, D)).astype(np.float32)
    q[:, :, group:] = 0.0
    k = rng.standard_normal((1, Hk, P, ps, D)).astype(np.float32)
    v = rng.standard_normal((1, Hk, P, ps, D)).astype(np.float32)
    tbl = rng.permutation(np.arange(1, P)).reshape(B, mp).astype(np.int32)
    lens = np.asarray(lens, np.int32)
    return dict(q=q, k=k, v=v, tbl=tbl, lens=lens, lp=np.zeros(B, np.int32),
                qpos=lens - 1, group=group, splits=splits,
                scale=D ** -0.5, flush=flush)


def _jax(x):
    o, lse = jdec.merge_partials(*jdec.paged_decode_attention(
        *(jnp.asarray(x[n]) for n in ("q", "k", "v", "tbl", "lens", "lp")),
        qpos_vec=jnp.asarray(x["qpos"]), softmax_scale=x["scale"],
        params=jmasks.MaskParams(window_right=0), t_new=1, group=x["group"],
        num_splits=x["splits"], interpret=True))
    return (torch.from_numpy(np.array(o)), torch.from_numpy(np.array(lse)))


def _port(x, dtype, einsum=torch.einsum):
    args = [torch.from_numpy(x[n]) for n in ("q", "k", "v", "tbl", "lens",
                                             "lp")]
    args[:3] = [a.to(dtype) for a in args[:3]]
    return tdec.merge_partials(*tdec.paged_decode_attention_ref(
        *args, qpos_vec=torch.from_numpy(x["qpos"]),
        softmax_scale=x["scale"], params=tmasks.MaskParams(window_right=0),
        t_new=1, group=x["group"], num_splits=x["splits"], upcast=False,
        einsum=einsum))


@pytest.mark.parametrize("name", list(SHAPES))
def test_fp32_decode_split_model_holds_the_forward_gate(name):
    """The flushed 3 x TF32 model of K4 fp32 holds out and LSE within the
    forward gate against the fp64 oracle and the JAX package's fp32 decode;
    one TF32 product misses it."""
    x = _case(name)
    n = x["group"]          # real q rows; the rest is padding
    o_jax, lse_jax = (t[:, :, :n] for t in _jax(x))
    o64, lse64 = (t[:, :, :n] for t in _port(x, torch.float64))
    o_fl, lse_fl = (t[:, :, :n] for t in _port(
        x, torch.float32, kernel_einsum(x["flush"])))
    o_ch = _port(x, torch.float32, kernel_einsum(None))[0][:, :, :n]
    o_one = _port(x, torch.float32, tf32.einsum_tf32)[0][:, :, :n]
    assert_fwd_close(o_fl, o64, o_jax, name=f"{name} out, flushed split")
    assert_fwd_close(lse_fl, lse64, lse_jax,
                     name=f"{name} lse, flushed split")
    gate = FWD_MULT * max_abs_err(o_jax, o64) + FWD_ATOL
    e_fl, e_ch, e_one = (max_abs_err(o, o64) for o in (o_fl, o_ch, o_one))
    print(f"{name}: out err flushed {e_fl:.3e} ({e_fl / gate:.4f} of the "
          f"gate), one chain {e_ch:.3e} ({e_ch / gate:.4f}), one TF32 "
          f"product {e_one:.3e} ({e_one / gate:.2f}); the JAX fp32 out "
          f"{max_abs_err(o_jax, o64):.3e}")
    assert e_one > gate, (e_one, gate)
