// Tile machinery shared by the forward (csrc/fwd.cu) and backward
// (csrc/bwd.cu) attention kernels: the live-key interval of a q row, the
// two product paths (mma.sync, wgmma) and the dynamic shared memory's
// 1024-byte alignment.
//
// The products of a block run on one of two paths with the same per-thread
// accumulator layout (a warp's 16 rows in mma C fragments):
//   abt: acc = A B^T, A the block's rows of tile a (R_A rows x D), B the N
//        rows of tile b (N x D): S = Q K^T, S^T = K Q^T and the dP's;
//   ab:  acc += A B, A this warp's rows in registers (k = the K rows of
//        tile b), B the columns [n0, n0 + N) of tile b (K x D): O += P V,
//        dQ = dS K, dV = P_drop^T dO, dK = dS^T Q.
// SyncPath: mma.sync, each warp its own 16 rows (a_row), operands through
// ldmatrix from rows padded by 16 bytes.  WgPath: wgmma, four warps one
// warpgroup over all 64 rows of A, B read by the tensor cores from
// 128-byte-swizzled tiles (a 64-column sub-tile is one 128-byte swizzle
// atom a row, so D 256 has four; at D 32 a row is one 64-byte atom, so the
// tiles are 64-byte swizzled); a batch of products starts
// with begin() and its results are readable after commit_wait() (or
// commit() and wait<N>(), which leaves the N latest batches in flight) and
// settle().
#pragma once

#include <type_traits>

#include "mma_sm90.cuh"

namespace fa {
namespace attn {

using namespace fa::sm90;

// live keys of q row qp: [key_lo, key_hi]
struct Live {
  int N, offs, wl, wr;
  __device__ int key_lo(int qp) const {
    return wl >= 0 ? max(qp + offs - wl, 0) : 0;
  }
  __device__ int key_hi(int qp) const {
    return wr >= 0 ? min(N - 1, qp + offs + wr) : N - 1;
  }
  __device__ bool valid(int qp, int kp) const {
    return kp >= key_lo(qp) && kp <= key_hi(qp);
  }
  // every key of [kp0, kp0 + nk) is live for every q row of [qp0, qp0 + nq)
  __device__ bool full(int qp0, int nq, int kp0, int nk) const {
    return key_lo(qp0 + nq - 1) <= kp0 && key_hi(qp0) >= kp0 + nk - 1;
  }
};

template <typename T, int D>
struct SyncPath {
  static constexpr int LD = D + 8;
  template <int R>
  static constexpr size_t tile_bytes() {
    return static_cast<size_t>(R) * LD * sizeof(T);
  }
  template <int R>
  __device__ static int chunk(int r, int c8) {
    return (r * LD + c8 * 8) * static_cast<int>(sizeof(T));
  }
  __device__ static void copies_landed() {}
  __device__ static void begin() {}
  __device__ static void commit() {}
  template <int N>
  __device__ static void wait() {}
  __device__ static void commit_wait() {}
  template <int NB>
  __device__ static void settle(float (&)[NB][4]) {}

  template <int RA, int N>
  __device__ static void abt(float (&acc)[N / 8][4], const unsigned char* a,
                             int a_row, const unsigned char* b, int lane) {
    const T* as = reinterpret_cast<const T*>(a) + a_row * LD;
    const T* bs = reinterpret_cast<const T*>(b);
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t af[4];
      load_a<LD>(af, as + kk * 16, lane);
#pragma unroll
      for (int nb = 0; nb < N / 16; ++nb) {
        uint32_t bf[4];
        load_b_nk<LD>(bf, bs + nb * 16 * LD + kk * 16, lane);
        mma16816<T>(acc[2 * nb], af, bf[0], bf[1]);
        mma16816<T>(acc[2 * nb + 1], af, bf[2], bf[3]);
      }
    }
  }

  template <int K, int N>
  __device__ static void ab(float (&acc)[N / 8][4],
                            const uint32_t (&af)[K / 16][4],
                            const unsigned char* b, int n0, int lane) {
    const T* bs = reinterpret_cast<const T*>(b) + n0;
#pragma unroll
    for (int kk = 0; kk < K / 16; ++kk)
#pragma unroll
      for (int nb = 0; nb < N / 16; ++nb) {
        uint32_t bf[4];
        load_b_kn<LD>(bf, bs + kk * 16 * LD + nb * 16, lane);
        mma16816<T>(acc[2 * nb], af[kk], bf[0], bf[1]);
        mma16816<T>(acc[2 * nb + 1], af[kk], bf[2], bf[3]);
      }
  }
};

template <typename T, int D>
struct WgPath {
  // D 32: 64-byte rows, each one 64-byte swizzle atom
  static constexpr bool kSw64 = D == 32;
  template <int R>
  static constexpr size_t tile_bytes() {
    return static_cast<size_t>(R) * D * sizeof(T);
  }
  template <int R>
  __device__ static int chunk(int r, int c8) {
    if constexpr (kSw64)
      return sw64_chunk(r, c8);
    else
      return sw128_chunk<R>(r, c8);
  }
  // this thread's cp.async writes, landed, made visible to wgmma
  __device__ static void copies_landed() { fence_proxy_async(); }
  __device__ static void begin() { wgmma_fence(); }
  __device__ static void commit() { wgmma_commit(); }
  // until at most N committed batches of this warpgroup are in flight
  template <int N>
  __device__ static void wait() { wgmma_wait<N>(); }
  __device__ static void commit_wait() {
    wgmma_commit();
    wgmma_wait<0>();
  }
  template <int NB>
  __device__ static void settle(float (&acc)[NB][4]) {
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) fence_operand(acc[j][e]);
  }

  template <int RA, int N>
  __device__ static void abt(float (&acc)[N / 8][4], const unsigned char* a,
                             int, const unsigned char* b, int) {
    static_assert(RA == 64, "one warpgroup: 64 rows of A");
    const uint32_t sa = smem_u32(a), sb = smem_u32(b);
    if constexpr (kSw64) {
      // both k16 steps inside the row's one atom, 32 bytes apart
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        Wgmma<N, T>::ss(&acc[0][0], sw64_desc(sa + kk * 32, 0, 512),
                        sw64_desc(sb + kk * 32, 0, 512), kk > 0);
    } else {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        Wgmma<N, T>::ss(&acc[0][0],
                        sw128_desc(sa + (kk / 4) * RA * 128 + (kk % 4) * 32,
                                   0, 1024),
                        sw128_desc(sb + (kk / 4) * N * 128 + (kk % 4) * 32,
                                   0, 1024),
                        kk > 0);
    }
  }

  template <int K, int N>
  __device__ static void ab(float (&acc)[N / 8][4],
                            const uint32_t (&af)[K / 16][4],
                            const unsigned char* b, int, int) {
    static_assert(N == D, "one warpgroup: all D columns");
    const uint32_t sb = smem_u32(b);
#pragma unroll
    for (int kk = 0; kk < K / 16; ++kk) {
      if constexpr (kSw64)
        Wgmma<N, T>::rs(&acc[0][0], af[kk],
                        sw64_desc(sb + kk * 16 * 64, K * 64, 512), 1);
      else
        Wgmma<N, T>::rs(&acc[0][0], af[kk],
                        sw128_desc(sb + kk * 16 * 128, K * 128, 1024), 1);
    }
  }
};

// The path of the forward (csrc/fwd_body.cuh) and of K2 and K3 at D <= 128
// (csrc/bwd.cu): wgmma at every head dim.  (K2 and K3 at D 256 are kernels
// of their own on WgPath; SyncPath serves the decode body,
// csrc/decode_body.cuh.)
template <typename T, int D>
using PathOf = WgPath<T, D>;

constexpr size_t align1k(size_t x) { return (x + 1023) / 1024 * 1024; }

// the dynamic shared memory from its first 1024-byte boundary (swizzled
// tiles need it; every layout reserves the slack)
__device__ __forceinline__ unsigned char* smem_base(unsigned char* smem) {
  return smem + ((1024u - (smem_u32(smem) & 1023u)) & 1023u);
}

}  // namespace attn
}  // namespace fa
