"""KV-cache quantization: INT8, FP8 (e4m3) and packed INT4 payloads with one
fp32 scale per (token, kv head) over head_dim.

The port's own copy of flash_attn_v100_tpu/ops/quant.py: the same payload
bytes and scales, bit for bit, on the same fp32 or bf16 inputs.

  * int8: scale = max(amax / 127, 1e-8), payload round(x / scale) clipped
    to [-127, 127] (round half to even, as jnp.round).
  * fp8 (torch.float8_e4m3fn): scale = max(amax / 448, 1e-8), payload
    x / scale converted to e4m3 (round to nearest even).
  * int4 (dtype "int4"): scale = max(amax / 7, 1e-8), values
    round(x / scale) clipped to [-8, 7], packed two TOKENS per int8 byte
    along the token axis: byte (t, d) holds token 2t's dim d in its low
    nibble, biased by +8, and token 2t + 1's dim d in its high nibble, in
    two's complement.  The pool keeps the full head_dim and half the token
    rows; the scales stay one per token.

The kernels (csrc/decode_quant.cu, csrc/varlen_paged_quant.cu) dequantize
inside their tiles and never materialize a dequantized cache;
`dequantize_kv` is for tests and oracles.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

INT8_MAX = 127.0
INT4_MAX = 7.0
FP8_E4M3_MAX = 448.0
SCALE_FLOOR = 1e-8

FP8 = torch.float8_e4m3fn


def is_int4(dtype) -> bool:
    return isinstance(dtype, str) and dtype == "int4"


def quant_kind(dtype) -> str:
    """"int8", "fp8" or "int4" for a quantized payload dtype."""
    if is_int4(dtype):
        return "int4"
    if dtype == torch.int8:
        return "int8"
    if dtype == FP8:
        return "fp8"
    raise ValueError(f"unsupported quantized dtype {dtype}")


def _qmax(dtype) -> float:
    return {"int8": INT8_MAX, "fp8": FP8_E4M3_MAX,
            "int4": INT4_MAX}[quant_kind(dtype)]


def ieee_div(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c, correctly rounded on every device: CUDA torch divides by a
    Python scalar as a multiplication by its reciprocal, an ulp off at
    times, which would move a quantized byte."""
    return x / torch.full_like(x, c)


def _scale(x32: torch.Tensor, qmax: float) -> torch.Tensor:
    amax = x32.abs().amax(dim=-1, keepdim=True)
    return torch.clamp_min(ieee_div(amax, qmax), SCALE_FLOOR)


def pack_int4(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Pack two integer tensors of 4-bit values (-8..7) into int8 bytes: the
    low nibble holds lo + 8, the high nibble hi in two's complement."""
    lo = (lo.to(torch.int32) + 8) & 0xF
    hi = hi.to(torch.int32) & 0xF
    return (lo | (hi << 4)).to(torch.int8)


def unpack_int4(packed: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse of pack_int4: (lo, hi) int8 tensors with the bias removed."""
    p = packed.to(torch.int32)
    lo = ((p & 0xF) - 8).to(torch.int8)
    hi = ((p << 24) >> 28).to(torch.int8)
    return lo, hi


def quantize_int4_values(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(token, head) int4 quantization without packing: x (..., D) ->
    (values (..., D) int8 in [-8, 7], scales (..., 1) fp32).  The cache
    append merges these into the packed bytes itself."""
    x32 = x.to(torch.float32)
    scale = _scale(x32, INT4_MAX)
    q4 = torch.clamp(torch.round(x32 / scale), -8, INT4_MAX)
    return q4.to(torch.int8), scale


def pack_int4_tokens(q4: torch.Tensor, axis: int = -2) -> torch.Tensor:
    """Pack int4 values pairwise along a token axis: (..., N, ..., D) ->
    (..., N/2, ..., D) bytes, token 2t low, token 2t + 1 high."""
    axis = axis % q4.dim()
    if q4.shape[axis] % 2:
        raise ValueError("int4 token packing needs an even token count")
    even = [slice(None)] * q4.dim()
    odd = list(even)
    even[axis], odd[axis] = slice(0, None, 2), slice(1, None, 2)
    return pack_int4(q4[tuple(even)], q4[tuple(odd)])


def unpack_int4_tokens(packed: torch.Tensor, axis: int = -2) -> torch.Tensor:
    """Inverse of pack_int4_tokens: (..., N/2, ..., D) bytes ->
    (..., N, ..., D) int8 values in token order."""
    axis = axis % packed.dim()
    lo, hi = unpack_int4(packed)
    st = torch.stack([lo, hi], dim=axis + 1)          # (..., N/2, 2, ..., D)
    shape = (packed.shape[:axis] + (2 * packed.shape[axis],)
             + packed.shape[axis + 1:])
    return st.reshape(shape)


def quantize_kv(x: torch.Tensor, dtype=torch.int8,
                token_axis: int = -2) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize over the last (head_dim) axis: x (..., D) -> (payload,
    scales (..., 1) fp32).  The payload keeps x's shape in `dtype` for int8
    and fp8; dtype="int4" packs token pairs along `token_axis` (even-sized)
    into int8 bytes, halving that axis.  `token_axis` is -2 for head-major
    (HND) caches and 1 for token-major (NHD) ones."""
    if is_int4(dtype):
        q4, scale = quantize_int4_values(x)
        return pack_int4_tokens(q4, axis=token_axis), scale
    x32 = x.to(torch.float32)
    scale = _scale(x32, _qmax(dtype))
    y = x32 / scale
    if dtype == torch.int8:
        q = torch.clamp(torch.round(y), -INT8_MAX, INT8_MAX).to(torch.int8)
    else:
        q = y.to(dtype)
    return q, scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype=torch.bfloat16, int4: bool = False,
                  token_axis: int = -2) -> torch.Tensor:
    """Inverse of quantize_kv (tests and oracles)."""
    if int4:
        q = unpack_int4_tokens(q, axis=token_axis)
    return (q.to(torch.float32) * scale.to(torch.float32)).to(dtype)


def payload_from_numpy(a: np.ndarray) -> torch.Tensor:
    """A numpy payload (int8, int4-packed int8, or an ml_dtypes
    float8_e4m3fn array as numpy gives a JAX fp8 array) as a torch tensor
    with the same bytes; fp8 goes through a uint8 view."""
    a = np.array(a)                     # a writable copy
    if a.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(a.view(np.uint8)).view(FP8)
    return torch.from_numpy(a)


def payload_bytes(t: torch.Tensor) -> torch.Tensor:
    """The payload's storage as a same-shaped uint8 view (fp8 pools are
    scattered and copied through it: not every torch build indexes fp8)."""
    return t.view(torch.uint8) if t.dtype == FP8 else t


def scatter_payload_(pool: torch.Tensor, index, values: torch.Tensor) -> None:
    """pool[index] = values, in place, for any payload dtype."""
    payload_bytes(pool)[index] = payload_bytes(values.to(pool.dtype))
