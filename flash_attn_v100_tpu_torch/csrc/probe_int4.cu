// P4: does the card take packed int4 operands in its tensor cores, and is
// that faster than unpacking them to int8?  Replaces the TPU probe
// benchmarks/prof_int4_native.py::kernel :20, an int4 x int4 and an
// int8 x int4 dot_general to int32.  Its plain twin, the operand format and
// the wrappers: flash_attn_v100_tpu_torch/ops/cuda/probe_int4.py.
//
// The function: C (M, N) int32 = A (M, K) . B (N, K)^T, exact.  B holds
// int4 values as two's-complement nibbles packed along K, the lower k in
// the low nibble (N, K / 2) bytes; A is packed the same way (kind 0) or
// one int8 a value (kind 1).  M and N are multiples of 8, K of 32 (a packed
// row of K / 2 bytes is a whole number of the 16 bytes TMA steps by).
//
// What bounds it: operations at 4096^3 (1979 TOP/s int8; the card lists no
// int4 rate, and its tensor cores take no s4 operand on the path that
// reaches that rate: mma.sync m16n8k64 .s4 compiles for sm_90a but the
// SASS holds no s4 IMMA, 40 TOP/s), bytes at the probe's own 128 x 256 x
// 128 shape, where a launch's fixed cost dominates.
//
// What the design does about it: both kinds multiply int8 on wgmma
// m64n256k32 .s8.s8 (the only instruction at the int8 rate; the widest
// tile, so the fewest shared-memory bytes a product), the int4 operands
// unpacked to int8 in shared memory on the way:
//   * Work.  A persistent grid, one block an SM, walks the 128 x 256 output
//     tiles (n fastest).  A block is three warpgroups: a producer and two
//     consumers, consumer w owning rows [64 w, 64 w + 64) of the tile and
//     all 256 columns (one m64n256 accumulator, 128 int32 registers a
//     thread; setmaxnreg gives the consumers 232 registers and the
//     producer 40).
//   * Loads.  One producer thread brings each K chunk of 128 values (A's
//     rows of the tile, packed (kind 0, 64 bytes a row) or int8 (kind 1,
//     128 bytes, 128-byte-swizzled: wgmma reads it in place), and B's 256
//     packed rows) into a ring of 3 (kind 0) or 4 (kind 1) stages by TMA
//     (cp.async.bulk.tensor, maps encoded per call on the host), each
//     stage with a full and an empty mbarrier (csrc/tma_pipe.cuh).  Edges
//     of M, N and K load as zeros (the maps' bounds); the epilogue stores
//     only rows < M and columns < N.
//   * Unpacking.  Consumer w unpacks B's rows [128 w, 128 w + 128) of the
//     stage (and, kind 0, its own 64 rows of A) into wgmma's K-major
//     128-byte-swizzled layout, straight from registers (sign-extended
//     nibbles, back in k order by a byte permute), fences them to the
//     async proxy, and the two consumers meet on a named barrier: each
//     multiplies the whole unpacked B.  Three unpacked buffers rotate, so
//     the barrier of chunk c - 1 also certifies that both consumers'
//     products of chunk c - 3 (the last readers of chunk c's buffer) are
//     done, and chunk c's unpack runs while chunk c - 1's products are on
//     the tensor cores.  No block-wide barrier sits in the loop.
//   * Release.  Kind 0 frees a stage once it is unpacked (both operands
//     are copied out); kind 1 once the products that read its A finished
//     (wgmma.wait_group 1, a chunk later).
#include <cuda_runtime.h>
#include <stdint.h>

#include "attn_tiles.cuh"
#include "tma_pipe.cuh"

namespace {

using namespace fa::sm90;
using namespace fa::tma;

constexpr int kBM = 128, kBN = 256;   // output tile
constexpr int kBK = 128;              // k values a chunk
constexpr int kConsumers = 2;         // warpgroups, kBM / 2 rows each
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kUnpacked = 3;          // unpacked buffers in rotation
constexpr int kBothConsumers = 1;     // named barrier of the consumers

template <int KIND>
struct Cfg {
  static constexpr int kStages = KIND == 0 ? 3 : 4;
  // a stage: A (kind 0 packed rows of 64 bytes; kind 1 int8 rows of 128,
  // swizzled), then B's packed rows
  static constexpr int a_bytes = KIND == 0 ? kBM * kBK / 2 : kBM * kBK;
  static constexpr int b_bytes = kBN * kBK / 2;
  static constexpr int stage_bytes = a_bytes + b_bytes;
  // an unpacked buffer: B (256 rows), then kind 0's A (each consumer's 64
  // rows), 128 int8 a row, swizzled
  static constexpr int u_a = kBN * kBK;
  static constexpr int u_bytes = u_a + (KIND == 0 ? kBM * kBK : 0);
  static constexpr int u_off = kStages * stage_bytes;
  static constexpr int bar_off = u_off + kUnpacked * u_bytes;
  static constexpr int bytes = bar_off + 2 * kStages * 8 + 1024;
};

// four nibbles in the low halves of the bytes of t -> four int8
__device__ __forceinline__ uint32_t sext4(uint32_t t) {
  // a set bit 3 becomes 0xF0 in its own byte (8 * 0x1E; no carry out)
  return t | ((t & 0x08080808u) * 0x1Eu);
}

// eight packed nibbles (k 0..7, low nibble first) -> eight int8 in k order
__device__ __forceinline__ void unpack8(uint32_t w, uint32_t& k0_3,
                                        uint32_t& k4_7) {
  const uint32_t ev = sext4(w & 0x0F0F0F0Fu);          // k 0, 2, 4, 6
  const uint32_t od = sext4((w >> 4) & 0x0F0F0F0Fu);   // k 1, 3, 5, 7
  k0_3 = __byte_perm(ev, od, 0x5140);
  k4_7 = __byte_perm(ev, od, 0x7362);
}

// ROWS packed rows of 64 bytes at src (k 0..127 of each) -> int8 rows of
// 128 bytes at dst, 128-byte-swizzled; the 128 threads of a warpgroup,
// thread t taking 16-byte chunk t % 4 of rows t / 4 + 32 i (a warp's loads
// read 128 contiguous bytes a phase and its stores hit distinct banks)
template <int ROWS>
__device__ __forceinline__ void unpack_rows(unsigned char* dst,
                                            const unsigned char* src,
                                            int tid) {
  const int c = tid % 4;
#pragma unroll
  for (int i = 0; i < ROWS / 32; ++i) {
    const int r = tid / 4 + 32 * i;
    const uint4 w = *reinterpret_cast<const uint4*>(src + r * 64 + c * 16);
    uint4 lo, hi;   // k 32c .. 32c + 15, 32c + 16 .. 32c + 31
    unpack8(w.x, lo.x, lo.y);
    unpack8(w.y, lo.z, lo.w);
    unpack8(w.z, hi.x, hi.y);
    unpack8(w.w, hi.z, hi.w);
    unsigned char* row = dst + r * 128;
    *reinterpret_cast<uint4*>(row + ((2 * c) ^ (r % 8)) * 16) = lo;
    *reinterpret_cast<uint4*>(row + ((2 * c + 1) ^ (r % 8)) * 16) = hi;
  }
}

template <int KIND>
__global__ void __launch_bounds__(kThreads, 1)
    int4_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                     const __grid_constant__ CUtensorMap map_b, int* c, int M,
                     int N, int K) {
  using C = Cfg<KIND>;
  constexpr int S = C::kStages;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = fa::attn::smem_base(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::bar_off);
  uint64_t* empty = full + S;
  const int tiles_n = (N + kBN - 1) / kBN;
  const int n_tiles = (M + kBM - 1) / kBM * tiles_n;
  const int n_chunks = (K + kBK - 1) / kBK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * 4);   // each consumer warp's
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ------------------------------------------------------- producer
    regs_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      Ring<S> r;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int m0 = tile / tiles_n * kBM, n0 = tile % tiles_n * kBN;
        for (int ch = 0; ch < n_chunks; ++ch) {
          mbar_wait(&empty[r.stage], r.phase ^ 1u);
          unsigned char* st = smem + r.stage * C::stage_bytes;
          mbar_expect_tx(&full[r.stage], C::stage_bytes);
          load_2d(st, &map_a, &full[r.stage],
                  KIND == 0 ? ch * kBK / 2 : ch * kBK, m0);
          load_2d(st + C::a_bytes, &map_b, &full[r.stage], ch * kBK / 2, n0);
          r.next();
        }
      }
    }
  } else {
    // ------------------------------------------------------ consumers
    regs_inc<kConsumerRegs>();
    const int w = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    Ring<S> r;
    int ub = 0;   // the unpacked buffer of this chunk
    int acc[128];
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int m0 = tile / tiles_n * kBM, n0 = tile % tiles_n * kBN;
      int prev = 0;   // the stage of the previous chunk
      for (int ch = 0; ch < n_chunks; ++ch) {
        mbar_wait(&full[r.stage], r.phase);
        const unsigned char* st = smem + r.stage * C::stage_bytes;
        unsigned char* u = smem + C::u_off + ub * C::u_bytes;
        unpack_rows<kBN / 2>(u + w * (kBN / 2) * 128,
                             st + C::a_bytes + w * (kBN / 2) * 64, tid);
        if constexpr (KIND == 0)
          unpack_rows<kBM / 2>(u + C::u_a + w * 64 * 128, st + w * 64 * 64,
                               tid);
        fence_proxy_async();
        // both consumers' halves of B written (and their products of chunk
        // ch - 2, which read the buffer chunk ch + 1 writes, done)
        bar_sync(kBothConsumers, 256);
        if constexpr (KIND == 0) mbar_arrive(&empty[r.stage], lane == 0);
        const uint32_t sa = smem_addr(KIND == 0 ? u + C::u_a : st) +
                            w * 64 * 128;
        const uint32_t sb = smem_addr(u);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 32; ++kk)
          WgmmaS8<256>::ss(acc, sw128_desc(sa + kk * 32, 0, 1024),
                           sw128_desc(sb + kk * 32, 0, 1024),
                           ch > 0 || kk > 0);
        wgmma_commit();
        wgmma_wait<1>();   // chunk ch - 1's products are done
        if constexpr (KIND == 1)
          mbar_arrive(&empty[prev], lane == 0 && ch > 0);
        prev = r.stage;
        r.next();
        ub = ub + 1 == kUnpacked ? 0 : ub + 1;
      }
      wgmma_wait<0>();
      if constexpr (KIND == 1) mbar_arrive(&empty[prev], lane == 0);
#pragma unroll
      for (int i = 0; i < 128; ++i)
        asm volatile("" : "+r"(acc[i]) :: "memory");

      // acc[4j + e]: row 64 w + 16 warp + g (+ 8 for e >= 2), column 8 j +
      // 2 t (+ 1 for odd e)
      const int g = lane / 4, t = lane % 4;
#pragma unroll
      for (int j = 0; j < 32; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = m0 + w * 64 + warp * 16 + g + 8 * h;
          const int col = n0 + j * 8 + 2 * t;
          if (row < M && col < N)
            *reinterpret_cast<int2*>(c + static_cast<long long>(row) * N +
                                     col) =
                make_int2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        }
    }
  }
}

template <int KIND>
cudaError_t launch(const void* a, const void* b, int* c, int M, int N, int K,
                   cudaStream_t stream) {
  using C = Cfg<KIND>;
  // A: (M, K / 2) packed bytes, or (M, K) int8 128-byte-swizzled; B: (N,
  // K / 2) packed bytes
  const uint64_t a_row = KIND == 0 ? K / 2 : K, b_row = K / 2;
  const uint64_t a_dims[2] = {a_row, static_cast<uint64_t>(M)};
  const uint64_t b_dims[2] = {b_row, static_cast<uint64_t>(N)};
  const uint64_t a_str[1] = {a_row}, b_str[1] = {b_row};
  const uint32_t a_box[2] = {KIND == 0 ? kBK / 2 : kBK, kBM};
  const uint32_t b_box[2] = {kBK / 2, kBN};
  CUtensorMap ma, mb;
  cudaError_t e = encode_map<2>(
      &ma, CU_TENSOR_MAP_DATA_TYPE_UINT8, a, a_dims, a_str, a_box,
      KIND == 0 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B);
  if (e != cudaSuccess) return e;
  e = encode_map<2>(&mb, CU_TENSOR_MAP_DATA_TYPE_UINT8, b, b_dims, b_str,
                    b_box, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (e != cudaSuccess) return e;
  static bool configured = false;
  if (!configured) {
    e = cudaFuncSetAttribute(int4_gemm_kernel<KIND>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::bytes);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const int tiles = (M + kBM - 1) / kBM * ((N + kBN - 1) / kBN);
  int4_gemm_kernel<KIND><<<tiles < sms ? tiles : sms, kThreads, C::bytes,
                           stream>>>(ma, mb, c, M, N, K);
  return cudaGetLastError();
}

}  // namespace

// C (M, N) int32 = A . B^T: kind 0 A packed int4 (M, K / 2), kind 1 A int8
// (M, K); B packed int4 (N, K / 2).  M, N multiples of 8, K of 32, a and b
// 16-byte aligned (TMA's), c 8-byte aligned.  Returns a cudaError_t
// (cudaErrorInvalidValue for a shape or pointer it does not take, or a
// tensor map cuTensorMapEncodeTiled refuses).
extern "C" int fa_int4_mma_launch(int kind, const void* a, const void* b,
                                  int* c, int M, int N, int K,
                                  void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || M % 8 || N % 8 || K % 32 ||
      reinterpret_cast<uintptr_t>(a) % 16 ||
      reinterpret_cast<uintptr_t>(b) % 16 ||
      reinterpret_cast<uintptr_t>(c) % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind == 0) return static_cast<int>(launch<0>(a, b, c, M, N, K, st));
  if (kind == 1) return static_cast<int>(launch<1>(a, b, c, M, N, K, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
