// Tile machinery of the fp32 attention bodies (csrc/fwd_f32.cu: K1, K5, K8;
// csrc/bwd_f32.cu: K2/K3, K6/K7; the decode body csrc/decode_body.cuh for
// fp32 pools: K4): every fp32 product as 3 x TF32 split products on the
// tensor cores (wgmma m64nNk8 .tf32, s_wgmma / pv_wgmma below, in K1's
// body at D 32-128 and K2's at D 32 / 64; mma.sync m16n8k8 .tf32 at the
// others, in K3's and in K4's).
//
// 3 x TF32: x = hi + lo with hi = tf32(x) (cvt.rna: 10 mantissa bits, round
// to nearest) and lo = x - hi, exact in fp32 and passed as it is (whatever
// the tensor core does with its low 13 bits moves x by at most 2^-21 of
// it), and A B = A_lo B_hi + A_hi B_lo + A_hi B_hi, the two small terms
// first into the fp32 accumulator; A_lo B_lo (2^-22 of the product) is
// dropped.  Each term is one TF32 product, so a split product costs three
// at the TF32 rate: a ceiling of 494.7 / 3 = 164.9 TFLOP/s on the H100 SXM
// against FFMA's 66.9.  One TF32 product alone misses the reference's fp32
// gates (forward 2 x the fp32 oracle's error + 1e-5, gradients 3 x + 1e-4)
// by 10-140x on the forward (ops/cuda/tf32.py models both on the CPU;
// tests/test_torch_tf32_split.py holds the model to the JAX package's
// fp32 outputs); the split products hold them on the card within half a
// gate (PERF.md section 6).
//
// The mma.sync fragments (PTX ISA, "Matrix fragments for mma.m16n8k8" with
// .tf32), g = lane / 4, c = lane % 4:
//   A 16x8, 4 regs: a0 (row g, k c), a1 (row g+8, k c), a2 (row g, k c+4),
//                   a3 (row g+8, k c+4)
//   B 8x8,  2 regs: b0 (k c, col g), b1 (k c+4, col g)
//   C 16x8, 4 fp32: c0, c1 (row g, cols 2c, 2c+1), c2, c3 (row g+8)
// A product whose k is the keys (O += P V, dQ += dS K) or the q rows (in K3
// dV += P_drop^T dO, dK += dS^T Q) takes its A from the registers of the
// previous product's C:
// k-step j's logical k = c is key 2c of n-block j and k = c + 4 key 2c + 1
// (the order of the terms of a sum does not matter to the product), so
// A = {C0, C2, C1, C3} and B reads rows 2c and 2c + 1 of the tile
// (frag_b_mn).  Tiles are row-major with a row stride of D + 4 floats:
// both the row-g, column-c reads of frag_a / frag_b_k and the row-2c,
// column-g reads of frag_b_mn then touch 32 distinct banks.
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
using fa::sm90::WgmmaTf32;

constexpr int kThreads = 128;

// ROWS rows of D floats into a tile of row stride D + 4, 16 bytes a copy
// by NT threads: row r from src(r), or zero where src(r) is null (`any` is
// then the copy's unread source address)
template <int D, int ROWS, int NT = kThreads, class F>
__device__ __forceinline__ void load_rows(float* dst, const float* any,
                                          F src) {
  constexpr int C = D / 4;
  for (int idx = threadIdx.x; idx < ROWS * C; idx += NT) {
    const int r = idx / C, c = idx % C;
    const float* s = src(r);
    cp_async16(dst + r * (D + 4) + 4 * c, s ? s + 4 * c : any, s != nullptr);
  }
}

// ------------------------------------------------------------- 3 x TF32

// x = hi + lo: hi = x rounded to TF32, lo = x - hi (exact)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// A or B fragment registers of 3 x TF32: the hi and lo words of each
template <int N>
struct Frag {
  uint32_t hi[N], lo[N];
  __device__ __forceinline__ void set(int i, float x) {
    split(x, hi[i], lo[i]);
  }
};
using FragA = Frag<4>;
using FragB = Frag<2>;

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += A B as A_lo B_hi + A_hi B_lo + A_hi B_hi, in that order
__device__ __forceinline__ void mma3(float (&c)[4], const FragA& a,
                                     const FragB& b) {
  mma_tf32(c, a.lo, b.hi);
  mma_tf32(c, a.hi, b.lo);
  mma_tf32(c, a.hi, b.hi);
}

// The tensor cores add each product into the accumulator with truncation
// (round toward zero), not fp32's round to nearest, so one long chain of
// products into one accumulator drifts towards zero by about one unit in
// the last place a product.  An accumulator that lives across tiles (O,
// dQ, dK, dV) takes kG k-steps at a time into a zeroed fragment, added to it
// with an FADD (flush).
constexpr int kG = 2;

__device__ __forceinline__ void flush(float (&acc)[4], const float (&t)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += t[e];
}

// A of k-step k0 (8 columns) from rows r0 .. r0 + 15 of a tile of row
// stride LD
template <int LD>
__device__ __forceinline__ void frag_a(FragA& f, const float* t, int r0,
                                       int k0, int lane) {
  const float* p = t + (r0 + lane / 4) * LD + k0 + lane % 4;
  f.set(0, p[0]);
  f.set(1, p[8 * LD]);
  f.set(2, p[4]);
  f.set(3, p[8 * LD + 4]);
}

// B of k-step k0 for C = A T^T: T's rows n0 .. n0 + 7 are B's columns
template <int LD>
__device__ __forceinline__ void frag_b_k(FragB& f, const float* t, int n0,
                                         int k0, int lane) {
  const float* p = t + (n0 + lane / 4) * LD + k0 + lane % 4;
  f.set(0, p[0]);
  f.set(1, p[4]);
}

// B of k-step k0 for C += A T with A from a C fragment ({C0, C2, C1, C3}):
// T's rows k0 + 2c and k0 + 2c + 1, column n0 + g
template <int LD>
__device__ __forceinline__ void frag_b_mn(FragB& f, const float* t, int k0,
                                          int n0, int lane) {
  const float* p = t + (k0 + 2 * (lane % 4)) * LD + n0 + lane / 4;
  f.set(0, p[0]);
  f.set(1, p[LD]);
}

// the A fragment of the keys k-step whose scores are C fragment c
__device__ __forceinline__ void frag_a_c(FragA& f, const float (&c)[4]) {
  f.set(0, c[0]);
  f.set(1, c[2]);
  f.set(2, c[1]);
  f.set(3, c[3]);
}

// keep the compiler from reading wgmma's accumulators before its wait
template <int NB>
__device__ __forceinline__ void settle(float (&acc)[NB][4]) {
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) fa::sm90::fence_operand(acc[j][e]);
}

// ----------------------------------------------- 3 x TF32 on wgmma

// a K-major 128-byte-swizzled tile's descriptor at k8 step kk (R rows)
template <int R>
__device__ __forceinline__ uint64_t tf32_desc(uint32_t tile, int kk) {
  return fa::sm90::sw128_desc(tile + (kk / 4) * R * 128 + (kk % 4) * 32, 0,
                              1024);
}

// S = Q K^T on wgmma, 3 x TF32 (also dP = dO V^T): Q's A fragments (this
// warp's 16 rows of q_s, split in registers) KC k-steps a batch in two
// register sets, K hi / lo from split K-major tiles (BK rows of D); S's C
// fragments in sc on return
template <int D, int BK, int LD>
__device__ __forceinline__ void s_wgmma(float (&sc)[BK / 8][4],
                                        const float* q_s, int r0,
                                        uint32_t kh, uint32_t kl, int lane) {
  constexpr int KS = D / 8, KC = KS < 2 ? KS : 2;
  FragA qa[2][KC];
#pragma unroll
  for (int c = 0; c < KS / KC; ++c) {
#pragma unroll
    for (int i = 0; i < KC; ++i)
      frag_a<LD>(qa[c & 1][i], q_s, r0, 8 * (c * KC + i), lane);
    fa::sm90::wgmma_fence();
#pragma unroll
    for (int i = 0; i < KC; ++i) {
      const int kk = c * KC + i;
      WgmmaTf32<BK>::rs(&sc[0][0], qa[c & 1][i].lo, tf32_desc<BK>(kh, kk),
                        kk > 0);
      WgmmaTf32<BK>::rs(&sc[0][0], qa[c & 1][i].hi, tf32_desc<BK>(kl, kk),
                        1);
      WgmmaTf32<BK>::rs(&sc[0][0], qa[c & 1][i].hi, tf32_desc<BK>(kh, kk),
                        1);
    }
    fa::sm90::wgmma_commit();
    fa::sm90::wgmma_wait<1>();   // the batch before: its register set free
  }
  fa::sm90::wgmma_wait<0>();
  settle(sc);
}

// ot = P V on wgmma, 3 x TF32 (also dS K), into a zeroed accumulator: P's
// A fragments from sc (frag_a_c), V^T hi / lo from split K-major tiles (D
// rows of BK keys, each 8 keys ordered as frag_a_c reads them)
template <int D, int BK>
__device__ __forceinline__ void pv_wgmma(float (&ot)[D / 8][4],
                                         const float (&sc)[BK / 8][4],
                                         uint32_t vh, uint32_t vl) {
  FragA pa[BK / 8];
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) frag_a_c(pa[j], sc[j]);
  fa::sm90::wgmma_fence();
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    WgmmaTf32<D>::rs(&ot[0][0], pa[j].lo, tf32_desc<D>(vh, j), j > 0);
    WgmmaTf32<D>::rs(&ot[0][0], pa[j].hi, tf32_desc<D>(vl, j), 1);
    WgmmaTf32<D>::rs(&ot[0][0], pa[j].hi, tf32_desc<D>(vh, j), 1);
  }
  fa::sm90::wgmma_commit();
  fa::sm90::wgmma_wait<0>();
  settle(ot);
}

// over the 4 lanes of this thread's quad (one C row's threads)
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
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
