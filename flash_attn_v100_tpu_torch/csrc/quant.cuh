// Quantized KV payloads on the device: the byte-level helpers the quantized
// kernels (decode_quant.cu, varlen_paged_quant.cu) share.  The layouts are
// those of flash_attn_v100_tpu_torch/ops/quant.py:
//   int8  one signed byte per element, scale = amax / 127 per (token, head);
//   fp8   one e4m3 byte per element, scale = amax / 448;
//   int4  two tokens per byte along the token axis: byte (t, d) holds token
//         2t's dim d in its low nibble, biased by +8, and token 2t + 1's in
//         its high nibble, in two's complement.
// The kernels unpack int4 to int8 in token order (the TPU kernel's nibble
// ANDs and [evens | odds] column order are Mosaic workarounds) and convert
// e4m3 exactly (no subnormal flush).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <stdint.h>

namespace fa {

// payload kinds, as the wrappers pass them
constexpr int kInt8 = 0;
constexpr int kFp8 = 1;
constexpr int kInt4 = 2;

// e4m3 byte -> float, exact (every e4m3 value, subnormals included, is an
// fp16 value)
__device__ __forceinline__ float e4m3_to_float(uint8_t x) {
  return __half2float(__half(__nv_cvt_fp8_to_halfraw(
      static_cast<__nv_fp8_storage_t>(x), __NV_E4M3)));
}

// An fp32 q over an fp8 pool (the TPU kernel's S is the fp32 q . k): x as
// three bf16 values whose sum is x exactly (hi the nearest bf16, mid and lo
// the nearest to what is left; each remainder is exact in fp32 and the
// last has at most 8 significant bits).  Every e4m3 value is a bf16 value,
// so three bf16 products of the parts with converted K, accumulated in
// fp32, give the fp32 dot product's terms exactly.
__device__ __forceinline__ void split_bf16x3(float x, __nv_bfloat16& hi,
                                             __nv_bfloat16& mid,
                                             __nv_bfloat16& lo) {
  hi = __float2bfloat16_rn(x);
  const float r = x - __bfloat162float(hi);
  mid = __float2bfloat16_rn(r);
  lo = __float2bfloat16_rn(r - __bfloat162float(mid));
}

// Q's column for head-dim index d where S = Q K^T runs on m16n8k16 against
// e4m3 K bytes loaded by 16-bit ldmatrix: within each 16, dim 4 t + i sits
// where an A fragment expects k 2 t + i (i < 2) or 2 t + 8 + i - 2, the
// dims an e4m3 K register holds
__device__ __forceinline__ int fp8_q_col(int d) {
  const int x = d % 16, t = x / 4, i = x % 4;
  return d - x + (i < 2 ? 2 * t + i : 2 * t + 6 + i);
}

// four int4-packed bytes -> the four even tokens' int8 values (low nibbles,
// bias removed) and the four odd tokens' (high nibbles, sign-extended),
// each packed four to a word in byte order
// (per-byte SIMD: a low nibble v is v - 8, a high nibble h is (h ^ 8) - 8)
__device__ __forceinline__ void unpack_int4x4(uint32_t w, uint32_t& lo,
                                              uint32_t& hi) {
  lo = __vsub4(w & 0x0F0F0F0Fu, 0x08080808u);
  hi = __vsub4(((w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
}

// sixteen int4-packed bytes -> sixteen int8 values of the even token and
// sixteen of the odd token
__device__ __forceinline__ void unpack_int4x16(const uint4& raw, uint4& even,
                                               uint4& odd) {
  unpack_int4x4(raw.x, even.x, odd.x);
  unpack_int4x4(raw.y, even.y, odd.y);
  unpack_int4x4(raw.z, even.z, odd.z);
  unpack_int4x4(raw.w, even.w, odd.w);
}

// P's int8 quantization of one row over a group of keys, as the TPU kernels
// round it: scale = amax / 127 (1 where the group is all zero), value
// rint(p / scale), half to even
__device__ __forceinline__ float p_scale_of(float amax) {
  return amax == 0.0f ? 1.0f : amax / 127.0f;
}

}  // namespace fa
