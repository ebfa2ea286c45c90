// P4: does the card take packed int4 operands in its tensor cores, and is
// that faster than unpacking them to int8?  Replaces the TPU probe
// benchmarks/prof_int4_native.py::kernel :20, an int4 x int4 and an
// int8 x int4 dot_general to int32.  Its plain twin, the operand format and
// the wrappers: flash_attn_v100_tpu_torch/ops/cuda/probe_int4.py.
//
// The function: C (M, N) int32 = A (M, K) . B (N, K)^T, exact.  B holds
// int4 values as two's-complement nibbles packed along K, the lower k in
// the low nibble (N, K / 2) bytes; A is packed the same way (kind 0) or
// one int8 a value (kind 1).  Two kernels on one GEMM body:
//   kind 0  int4 x int4 on mma.sync m16n8k64 .s4.s4 (32 packed bytes of k a
//           fragment: the byte layout of the int8 m16n8k32 fragments);
//   kind 1  int8 x int4: each K chunk of B is unpacked to int8 in shared
//           memory (sign-extended nibbles, back in k order by a byte
//           permute) and multiplied on mma.sync m16n8k32 .s8.s8
//           (csrc/mma_sm90.cuh::mma16832_s8), as the quantized decode and
//           prefill kernels treat int4 pools.
// Body: a 128 x 128 output tile a block, 8 warps of 64 x 32, 64 bytes of A
// a row a K chunk through a three-stage cp.async ring, operands through
// ldmatrix from rows padded to 80 bytes (no bank conflicts).  M, N and K
// are multiples of 128.
//
// What bounds it: operations at 4096^3 (the card lists 1979 TOP/s int8 and
// no int4 rate); bytes at the probe's own 128 x 128 x 256 shape, where a
// launch's fixed cost dominates.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

using namespace fa::sm90;

constexpr int kBM = 128, kBN = 128;
constexpr int kChunk = 64;      // bytes of an A row a K chunk
constexpr int kLd = 80;         // padded row stride of a tile, bytes
constexpr int kStages = 3;
constexpr int kThreads = 256;
constexpr int kTile = kBM * kLd;   // bytes of a padded 128-row tile

// c += a b, 16x8x64, int4 inputs (eight a register), int32 accumulate
__device__ __forceinline__ void mma16864_s4(int (&c)[4],
                                            const uint32_t (&a)[4],
                                            uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k64.row.col.s32.s4.s4.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// eight packed nibbles (k 0..7, low nibble first) -> eight int8 in k order
__device__ __forceinline__ void unpack8(uint32_t w, uint32_t& k0_3,
                                        uint32_t& k4_7) {
  const uint32_t ev = __vsub4((w & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
  const uint32_t od =
      __vsub4(((w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
  k0_3 = __byte_perm(ev, od, 0x5140);
  k4_7 = __byte_perm(ev, od, 0x7362);
}

template <int KIND>
struct Smem {
  // A stages, B stages (kind 0 padded; kind 1 packed 32-byte rows), then
  // kind 1's unpacked B tile
  static constexpr int b_off = kStages * kTile;
  static constexpr int b_stage = KIND == 0 ? kTile : kBN * kChunk / 2;
  static constexpr int b8_off = b_off + kStages * b_stage;
  static constexpr int bytes = b8_off + (KIND == 0 ? 0 : kTile);
};

template <int KIND>
__global__ void __launch_bounds__(kThreads)
    int4_mma_kernel(const uint8_t* a, const uint8_t* b, int* c, int M, int N,
                    int K) {
  using S = Smem<KIND>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / 4, wn = warp % 4;   // 64 rows x 32 columns a warp
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int lda = KIND == 0 ? K / 2 : K;    // bytes a row
  const int ldb = K / 2;
  constexpr int kBChunk = KIND == 0 ? kChunk : kChunk / 2;
  const int n_chunks = lda / kChunk;

  auto load_chunk = [&](int ch, int st) {
    unsigned char* as = smem + st * kTile;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + i * kThreads, r = idx / 4, c16 = idx % 4;
      cp_async16(as + r * kLd + c16 * 16,
                 a + static_cast<long long>(m0 + r) * lda + ch * kChunk +
                     c16 * 16,
                 true);
    }
    unsigned char* bs = smem + S::b_off + st * S::b_stage;
    if constexpr (KIND == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int idx = tid + i * kThreads, r = idx / 4, c16 = idx % 4;
        cp_async16(bs + r * kLd + c16 * 16,
                   b + static_cast<long long>(n0 + r) * ldb + ch * kBChunk +
                       c16 * 16,
                   true);
      }
    } else {
      const int r = tid / 2, c16 = tid % 2;
      cp_async16(bs + r * kBChunk + c16 * 16,
                 b + static_cast<long long>(n0 + r) * ldb + ch * kBChunk +
                     c16 * 16,
                 true);
    }
  };

  int acc[4][4][4] = {};
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_chunks) load_chunk(s, s);
    cp_async_commit();
  }
  for (int ch = 0; ch < n_chunks; ++ch) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // chunk ch landed; chunk ch - 1 read by all
    if (ch + kStages - 1 < n_chunks)
      load_chunk(ch + kStages - 1, (ch + kStages - 1) % kStages);
    cp_async_commit();
    const int st = ch % kStages;
    const unsigned char* as = smem + st * kTile;
    const unsigned char* bs = smem + S::b_off + st * S::b_stage;
    if constexpr (KIND == 1) {
      // this thread's 16 packed bytes (row tid / 2, k 32 (tid % 2) ..) ->
      // 32 int8 in the unpacked tile
      const int r = tid / 2, half = tid % 2;
      const uint4 w =
          *reinterpret_cast<const uint4*>(bs + r * kBChunk + half * 16);
      uint4 lo, hi;
      unpack8(w.x, lo.x, lo.y);
      unpack8(w.y, lo.z, lo.w);
      unpack8(w.z, hi.x, hi.y);
      unpack8(w.w, hi.z, hi.w);
      unsigned char* b8 = smem + S::b8_off + r * kLd + half * 32;
      *reinterpret_cast<uint4*>(b8) = lo;
      *reinterpret_cast<uint4*>(b8 + 16) = hi;
      __syncthreads();
      bs = smem + S::b8_off;
    }
    // two 32-byte k steps: int4 k 64 each (kind 0), int8 k 32 (kind 1)
#pragma unroll
    for (int ks = 0; ks < kChunk / 32; ++ks) {
      uint32_t af[4][4], bf[2][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        load_a<kLd / 2>(af[mi],
                        reinterpret_cast<const uint16_t*>(
                            as + (wm * 64 + mi * 16) * kLd + ks * 32),
                        lane);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj)
        load_b_nk<kLd / 2>(bf[nj],
                           reinterpret_cast<const uint16_t*>(
                               bs + (wn * 32 + nj * 16) * kLd + ks * 32),
                           lane);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int nb = 0; nb < 4; ++nb) {
          const uint32_t b0 = bf[nb / 2][(nb % 2) * 2];
          const uint32_t b1 = bf[nb / 2][(nb % 2) * 2 + 1];
          if constexpr (KIND == 0)
            mma16864_s4(acc[mi][nb], af[mi], b0, b1);
          else
            mma16832_s8(acc[mi][nb], af[mi], b0, b1);
        }
    }
  }
  cp_async_wait<0>();

  // C fragments: c[0], c[1] row g, columns 2t, 2t + 1; c[2], c[3] row g + 8
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int nb = 0; nb < 4; ++nb) {
      const long long row = m0 + wm * 64 + mi * 16 + g;
      const int col = n0 + wn * 32 + nb * 8 + 2 * t;
      *reinterpret_cast<int2*>(c + row * N + col) =
          make_int2(acc[mi][nb][0], acc[mi][nb][1]);
      *reinterpret_cast<int2*>(c + (row + 8) * N + col) =
          make_int2(acc[mi][nb][2], acc[mi][nb][3]);
    }
}

template <int KIND>
cudaError_t launch(const uint8_t* a, const uint8_t* b, int* c, int M, int N,
                   int K, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        int4_mma_kernel<KIND>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Smem<KIND>::bytes);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  int4_mma_kernel<KIND><<<dim3(N / kBN, M / kBM), kThreads, Smem<KIND>::bytes,
                          stream>>>(a, b, c, M, N, K);
  return cudaGetLastError();
}

}  // namespace

// C (M, N) int32 = A . B^T: kind 0 A packed int4 (M, K / 2), kind 1 A int8
// (M, K); B packed int4 (N, K / 2).  M, N, K multiples of 128.  Returns a
// cudaError_t.
extern "C" int fa_int4_mma_launch(int kind, const void* a, const void* b,
                                  int* c, int M, int N, int K,
                                  void* stream) {
  if (M % kBM || N % kBN || K % 128 || M <= 0 || N <= 0 || K <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* pa = static_cast<const uint8_t*>(a);
  const auto* pb = static_cast<const uint8_t*>(b);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind == 0) return static_cast<int>(launch<0>(pa, pb, c, M, N, K, st));
  if (kind == 1) return static_cast<int>(launch<1>(pa, pb, c, M, N, K, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
