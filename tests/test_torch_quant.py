"""Port ops/quant.py against the JAX package's: payload bytes and scales
bit-equal on the same fp32 and bf16 inputs (int8, fp8 e4m3 and int4 on
both token axes), the int4 nibble helpers, dequantization, and every e4m3
byte's value."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_v100_tpu.ops import quant as jq
from flash_attn_v100_tpu.ops.pallas.decode import _fp8_bitcast_dequant
from flash_attn_v100_tpu_torch.ops import quant as tq

torch.set_num_threads(1)

DTYPES = {"int8": (torch.int8, jnp.int8),
          "fp8": (torch.float8_e4m3fn, jnp.float8_e4m3fn),
          "int4": ("int4", "int4")}


def _bytes(a) -> np.ndarray:
    """A JAX array's or a torch tensor's payload as raw bytes."""
    if isinstance(a, torch.Tensor):
        return tq.payload_bytes(a).numpy()
    a = np.asarray(a)
    return a.view(np.uint8) if a.dtype.name == "float8_e4m3fn" else a


def _inputs(seed, shape=(3, 2, 16, 64)):
    rng = np.random.default_rng(seed)
    # per-row magnitudes over six decades, a zero row and a constant row
    x = rng.standard_normal(shape) * 10.0 ** rng.uniform(-3, 3, shape[:-1]
                                                         + (1,))
    x[0, 0, 0] = 0.0
    x[0, 0, 1] = 2.5
    return x.astype(np.float32)


@pytest.mark.parametrize("in_dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("token_axis", [-2, 1])
@pytest.mark.parametrize("kind", list(DTYPES))
def test_quantize_kv_bit_equal_to_jax(kind, token_axis, in_dtype):
    tdt, jdt = DTYPES[kind]
    x = _inputs(0)
    tx = torch.from_numpy(x)
    jx = jnp.asarray(x)
    if in_dtype == "bf16":
        tx, jx = tx.to(torch.bfloat16), jx.astype(jnp.bfloat16)
    tp, ts = tq.quantize_kv(tx, tdt, token_axis=token_axis)
    jp, js = jq.quantize_kv(jx, jdt, token_axis=token_axis)
    assert tuple(tp.shape) == jp.shape and tuple(ts.shape) == js.shape
    assert np.array_equal(_bytes(tp), _bytes(jp))
    assert np.array_equal(ts.numpy(), np.asarray(js))
    # and back, from JAX's payload carried over as bytes
    back = tq.dequantize_kv(tq.payload_from_numpy(np.asarray(jp)), ts,
                            torch.float32, int4=kind == "int4",
                            token_axis=token_axis)
    want = jq.dequantize_kv(jp, js, jnp.float32, int4=kind == "int4",
                            token_axis=token_axis)
    assert np.array_equal(back.numpy(), np.asarray(want))


def test_int4_helpers_bit_equal_to_jax():
    rng = np.random.default_rng(1)
    vals = rng.integers(-8, 8, (4, 6, 8)).astype(np.int8)
    packed = tq.pack_int4(torch.from_numpy(vals[:, ::2]),
                          torch.from_numpy(vals[:, 1::2]))
    jpacked = jq.pack_int4(jnp.asarray(vals[:, ::2]), jnp.asarray(vals[:, 1::2]))
    assert np.array_equal(packed.numpy(), np.asarray(jpacked))
    for t, j in zip(tq.unpack_int4(packed), jq.unpack_int4(jpacked)):
        assert np.array_equal(t.numpy(), np.asarray(j))
    for axis in (1, -2):
        tp = tq.pack_int4_tokens(torch.from_numpy(vals), axis=axis)
        jp = jq.pack_int4_tokens(jnp.asarray(vals), axis=axis)
        assert np.array_equal(tp.numpy(), np.asarray(jp))
        assert np.array_equal(tq.unpack_int4_tokens(tp, axis=axis).numpy(),
                              vals)
    x = _inputs(2)
    tv, ts = tq.quantize_int4_values(torch.from_numpy(x))
    jv, js = jq.quantize_int4_values(jnp.asarray(x))
    assert np.array_equal(tv.numpy(), np.asarray(jv))
    assert np.array_equal(ts.numpy(), np.asarray(js))
    with pytest.raises(ValueError):
        tq.pack_int4_tokens(torch.zeros(3, 4, dtype=torch.int8), axis=0)


def test_every_e4m3_byte():
    """All 256 e4m3 bytes: the port converts exactly (as ml_dtypes does);
    the TPU kernel's bit-placement dequant agrees on every normal and zero
    byte and flushes the subnormals (|x| < 2^-6) to zero, a difference below
    2^-6 x scale per element."""
    allbytes = np.arange(256, dtype=np.uint8)
    ours = tq.payload_from_numpy(allbytes.view(jnp.float8_e4m3fn)).to(
        torch.float32).numpy()
    exact = allbytes.view(jnp.float8_e4m3fn).astype(np.float32)
    assert np.array_equal(np.isnan(ours), np.isnan(exact))
    fin = np.isfinite(exact)
    assert np.array_equal(ours[fin], exact[fin])
    tpu = np.asarray(_fp8_bitcast_dequant(jax.lax.bitcast_convert_type(
        jnp.asarray(allbytes), jnp.float8_e4m3fn)).astype(jnp.float32))
    normal = fin & ((np.abs(exact) >= 2.0 ** -6) | (exact == 0))
    assert np.array_equal(ours[normal], tpu[normal])
    sub = fin & ~normal
    assert sub.sum() == 14 and (tpu[sub] == 0).all()
    assert np.abs(ours[sub]).max() < 2.0 ** -6


def test_payload_bytes_and_scatter():
    """fp8 payloads scatter through a uint8 view of their own storage."""
    pool = torch.zeros(2, 4, 8, dtype=torch.float8_e4m3fn)
    vals = torch.tensor([[1.5, -2.0] * 4], dtype=torch.float32)
    tq.scatter_payload_(pool, (1, 2), vals[0])
    assert tq.payload_bytes(pool).data_ptr() == pool.data_ptr()
    assert torch.equal(pool[1, 2].to(torch.float32), vals[0])
    assert not pool[0].to(torch.float32).any()
    assert tq.quant_kind("int4") == "int4" and tq.is_int4("int4")
    with pytest.raises(ValueError):
        tq.quant_kind(torch.float16)
