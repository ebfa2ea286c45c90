// Shared score pipeline for the attention kernels of this package, on the
// device: scale -> ALiBi -> softcap, then the causal/window position mask,
// masked entries filled with NEG_INF.  The plain PyTorch twin is
// flash_attn_v100_tpu_torch/ops/masks.py; both follow
// flash_attn_v100_tpu/ops/pallas/masks.py.
//
//   causal  masks  rel >  row               (rel = col - offset)
//   window  masks  rel <  row - window_left   (window_left  >= 0)
//                  rel >  row + window_right  (window_right >= 0)
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>

namespace fa {

constexpr float kNegInf = -1e30f;
constexpr float kExpClamp = -80.0f;

struct MaskParams {
  int causal;        // bottom-right causal
  int window_left;   // -1: unbounded
  int window_right;  // -1: unbounded
  float softcap;     // 0: off
  int has_alibi;

  // causal is window_right 0 for range trimming
  __host__ __device__ int effective_window_right() const {
    return causal ? 0 : window_right;
  }
};

// s = raw q.k; row/rel are positions in one frame (rel = col - offset)
__device__ __forceinline__ float score_bias(float s, int row, int rel,
                                            float scale, float slope,
                                            const MaskParams& p) {
  s *= scale;
  if (p.has_alibi) s -= slope * fabsf(static_cast<float>(row - rel));
  if (p.softcap > 0.0f) s = p.softcap * tanhf(s * (1.0f / p.softcap));
  return s;
}

__device__ __forceinline__ bool position_valid(int row, int rel,
                                               const MaskParams& p) {
  bool ok = true;
  if (p.causal) ok = ok && rel <= row;
  if (p.window_left >= 0) ok = ok && rel >= row - p.window_left;
  if (p.window_right >= 0) ok = ok && rel <= row + p.window_right;
  return ok;
}

__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_float(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_float<__half>(float x) {
  return __float2half(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

}  // namespace fa
