// The pieces of a warp-specialised TMA pipeline on Hopper (sm_90a), shared
// by the int4 GEMM probe (csrc/probe_int4.cu) and the flash-step probes
// (csrc/probes.cu):
//   * mbarriers in shared memory: init, arrive (plain, predicated, with an
//     expected transaction count) and a parity wait whose polling loop
//     lives inside the asm, as CUTLASS's does, so that the compiler sees
//     no branch while a wgmma is in flight;
//   * TMA tile loads (cp.async.bulk.tensor, 2-D and 4-D) and plain bulk
//     copies (cp.async.bulk) that complete on an mbarrier's transaction
//     count;
//   * setmaxnreg, by which a producer warpgroup hands its registers to the
//     consumer warpgroups, and named barriers (bar.sync / bar.arrive) for
//     a subset of the block's warps;
//   * a Ring: the stage and phase of a ring of S stages as a producer or a
//     consumer walks it, each stage with a "full" barrier (the producer's
//     loads landed) and an "empty" one (every consumer is done with it);
//   * on the host, cuTensorMapEncodeTiled reached through
//     cudaGetDriverEntryPoint, so that a library built with nvcc alone
//     (no -lcuda) and loaded through ctypes can encode tensor maps.  The
//     maps travel to a kernel as __grid_constant__ const CUtensorMap
//     parameters.
//
// Phases: a barrier starts in phase 0 and flips each time its count of
// arrivals (and bytes) completes.  wait(parity) returns once the phase of
// that parity has completed; a consumer waits its full barriers with the
// ring's phase, a producer its empty ones with the phase flipped, which
// passes at once on the first lap (the stages start empty).
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fa {
namespace tma {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// --------------------------------------------------------------- mbarrier

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

// the barriers' initialisation made visible before any thread uses them
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also adds `bytes` to the transactions the phase waits
// for (the producer's, before it issues the loads)
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// one arrival when `pred` (a predicated instruction, no branch)
__device__ __forceinline__ void mbar_arrive(uint64_t* bar, bool pred = true) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n"
      :: "r"(smem_addr(bar)), "r"(static_cast<int>(pred)) : "memory");
}

// until the phase of parity `parity` has completed (the label is local to
// the asm's { } block, so every inlined copy has its own)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n"
      :: "r"(smem_addr(bar)), "r"(parity) : "memory");
}

// ------------------------------------------------------------ bulk copies

// a box of a 2-D tensor map at element coordinates (c0 innermost, c1) into
// shared memory, completing on `bar`
__device__ __forceinline__ void load_2d(void* dst, const CUtensorMap* map,
                                        uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// the same for a 4-D tensor map (c0 innermost)
__device__ __forceinline__ void load_4d(void* dst, const CUtensorMap* map,
                                        uint64_t* bar, int c0, int c1, int c2,
                                        int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global to
// shared memory, completing on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// ------------------------------------------- registers and named barriers

template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}

template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}

// named barrier `id` (1-15; 0 is __syncthreads'), `n` threads in all
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

// ------------------------------------------------------------------ Ring

// a walk over a ring of S stages: stage index and the phase of this lap
template <int S>
struct Ring {
  int stage = 0;
  uint32_t phase = 0;
  __device__ void next() {
    const bool wrap = ++stage == S;
    stage = wrap ? 0 : stage;
    phase ^= static_cast<uint32_t>(wrap);
  }
};

// ------------------------------------------------------------ host side

using EncodeTiledFn = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, or nullptr
inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiledFn>(nullptr);
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// A tiled map of a RANK-D tensor at `base`: dims[0] innermost (contiguous),
// strides[i] the byte stride of dimension i + 1, box the tile a load
// brings; out-of-bounds elements of a box load as zero.  Returns a
// cudaError_t: cudaErrorInvalidValue when libcuda has no encoder or
// refuses the layout (base or a stride not 16-byte aligned, a box too big).
template <int RANK>
inline cudaError_t encode_map(CUtensorMap* map, CUtensorMapDataType type,
                              const void* base, const uint64_t (&dims)[RANK],
                              const uint64_t (&strides)[RANK - 1],
                              const uint32_t (&box)[RANK],
                              CUtensorMapSwizzle swizzle) {
  const EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return cudaErrorInvalidValue;
  cuuint64_t d[RANK], s[RANK > 1 ? RANK - 1 : 1];
  cuuint32_t b[RANK], e[RANK];
  for (int i = 0; i < RANK; ++i) {
    d[i] = dims[i];
    b[i] = box[i];
    e[i] = 1;
    if (i + 1 < RANK) s[i] = strides[i];
  }
  const CUresult r = fn(map, type, RANK, const_cast<void*>(base), d, s, b, e,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace tma
}  // namespace fa
