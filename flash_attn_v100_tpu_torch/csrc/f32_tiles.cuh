// Tile machinery of the fp32 attention bodies (csrc/fwd_f32.cu: K1, K5, K8;
// csrc/bwd_f32.cu: K2/K3, K6/K7; csrc/decode_f32.cu: K4): every product in
// fp32 FFMA on the CUDA cores, operands from shared memory.
//
// Why FFMA and not the tensor cores: the reference's fp32 gates (forward
// 2 x the fp32 oracle's error + 1e-5, gradients 3 x + 1e-4) are close to
// absolute, and one TF32 product (10-bit mantissa) misses them by about
// 100x, worse where a large score's error is amplified by exp.  3 x TF32
// split products run at a third of the TF32 rate, with each operand split
// in registers and mma.sync's fragment layouts rebuilt for 32-bit types.
// FFMA is exact fp32 arithmetic, so a kernel's error is the oracle's own
// at any scale, and its ceiling is the card's 66.9 TFLOP/s of fp32 FMA.
//
// The thread layout (128 threads, 4 warps): thread t is (ty, tx) =
// (t / 8, t % 8).  In a product C = A B^T over the head dim (S = Q K^T,
// dP = dO V^T, and in K3 S^T = K Q^T, dP^T = V dO^T) it holds C's rows
// ty + 16 i and columns tx + 8 j; in a product C += P B over keys (O += P V,
// dQ += dS K, dV += P_drop^T dO, dK += dS^T Q) it holds rows ty + 16 i and
// the float4 columns 4 (tx + 8 u).  So a row's 8 threads are the 8 lanes
// of one lane-octet (row max / sum: three shuffles), and the accumulator
// rows of both products are the same rows.
//
// Shared-memory tiles: a D-wide tile has rows of D + 4 floats and a key-wide
// tile (P, dS) rows of BK + 8: a 16-byte read of the 8 lanes of an octet
// then touches 8 distinct bank groups (B^T reads: 8 rows 4 floats apart in
// bank space; P V reads: 8 consecutive chunks of one row) and the A rows of
// a warp's 4 octets broadcast, so the loads have no bank conflicts.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace fa {
namespace f32 {

using fa::sm90::cp_async16;
using fa::sm90::cp_async4;
using fa::sm90::cp_async_commit;
using fa::sm90::cp_async_wait;

constexpr int kThreads = 128;

// ROWS rows of D floats into a tile of row stride D + 4, 16 bytes a copy:
// row r from src(r), or zero where src(r) is null (`any` is then the
// copy's unread source address)
template <int D, int ROWS, class F>
__device__ __forceinline__ void load_rows(float* dst, const float* any,
                                          F src) {
  constexpr int C = D / 4;
  for (int idx = threadIdx.x; idx < ROWS * C; idx += kThreads) {
    const int r = idx / C, c = idx % C;
    const float* s = src(r);
    cp_async16(dst + r * (D + 4) + 4 * c, s ? s + 4 * c : any, s != nullptr);
  }
}

// acc[i][j] = sum_d A[ty + 16 i][d] B[tx + 8 j][d]; A and B D-wide tiles
template <int D, int RT, int CT>
__device__ __forceinline__ void abt(float (&acc)[RT][CT], const float* a,
                                    const float* b, int ty, int tx) {
  constexpr int LD = D + 4;
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < CT; ++j) acc[i][j] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 av[RT], bv[CT];
#pragma unroll
    for (int i = 0; i < RT; ++i)
      av[i] = *reinterpret_cast<const float4*>(a + (ty + 16 * i) * LD + d);
#pragma unroll
    for (int j = 0; j < CT; ++j)
      bv[j] = *reinterpret_cast<const float4*>(b + (tx + 8 * j) * LD + d);
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < CT; ++j) {
        float s = acc[i][j];
        s = fmaf(av[i].x, bv[j].x, s);
        s = fmaf(av[i].y, bv[j].y, s);
        s = fmaf(av[i].z, bv[j].z, s);
        s = fmaf(av[i].w, bv[j].w, s);
        acc[i][j] = s;
      }
  }
}

// acc[i][u] += sum_k P[ty + 16 i][k] B[k][4 (tx + 8 u) ..]; P a K-wide tile
// of row stride PLD, B a D-wide tile of K rows
template <int D, int RT, int K, int PLD>
__device__ __forceinline__ void ab(float4 (&acc)[RT][D / 32], const float* p,
                                   const float* b, int ty, int tx) {
  constexpr int LD = D + 4;
#pragma unroll 2
  for (int k = 0; k < K; k += 4) {
    float4 pv[RT];
#pragma unroll
    for (int i = 0; i < RT; ++i)
      pv[i] = *reinterpret_cast<const float4*>(p + (ty + 16 * i) * PLD + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int u = 0; u < D / 32; ++u) {
        const float4 bv = *reinterpret_cast<const float4*>(
            b + (k + kk) * LD + 4 * (tx + 8 * u));
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          const float w = kk == 0   ? pv[i].x
                          : kk == 1 ? pv[i].y
                          : kk == 2 ? pv[i].z
                                    : pv[i].w;
          acc[i][u].x = fmaf(w, bv.x, acc[i][u].x);
          acc[i][u].y = fmaf(w, bv.y, acc[i][u].y);
          acc[i][u].z = fmaf(w, bv.z, acc[i][u].z);
          acc[i][u].w = fmaf(w, bv.w, acc[i][u].w);
        }
      }
    }
  }
}

template <int RT, int DC>
__device__ __forceinline__ void zero(float4 (&acc)[RT][DC]) {
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int u = 0; u < DC; ++u) acc[i][u] = make_float4(0.f, 0.f, 0.f, 0.f);
}

__device__ __forceinline__ float4 scale4(float4 x, float s) {
  return make_float4(x.x * s, x.y * s, x.z * s, x.w * s);
}

// over the 8 lanes of this thread's octet (one row's threads)
__device__ __forceinline__ float octet_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
}

__device__ __forceinline__ float octet_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x + __shfl_xor_sync(0xffffffffu, x, 4);
}

// a kernel's dynamic shared memory limit, raised on its first launch
template <class Fn>
cudaError_t allow_smem(Fn fn, size_t bytes, size_t* configured) {
  if (bytes <= *configured) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e == cudaSuccess) *configured = bytes;
  return e;
}

}  // namespace f32
}  // namespace fa
