// Tensor-core and asynchronous-copy helpers for the attention kernels of
// this package (sm_90a): warp-level mma.sync m16n8k16 and ldmatrix,
// warpgroup-level wgmma m64nNk16 (N 16 to 256), both with 16-bit inputs
// and fp32 accumulators, warp-level mma.sync m16n8k32 and warpgroup-level
// wgmma m64n256k32 with int8 inputs and int32 accumulators, and cp.async
// with zero fill.
//
// Fragment layouts of m16n8k16 (PTX ISA, "Matrix fragments for
// mma.m16n8k16"), with g = lane / 4 and t = lane % 4; each 32-bit register
// holds two 16-bit values, the lower column in the low half:
//   A 16x16, 4 regs: a[0] (row g, cols 2t, 2t+1), a[1] (row g+8, 2t..),
//                    a[2] (row g, 2t+8..), a[3] (row g+8, 2t+8..)
//   B 16x8,  2 regs: b[0] (k 2t, 2t+1; col g), b[1] (k 2t+8, 2t+9; col g)
//   C 16x8,  4 fp32: c[0], c[1] (row g, cols 2t, 2t+1), c[2], c[3] (row g+8)
// So the C fragments of n-blocks 2i and 2i+1, packed to 16 bits
// (pack_a), are the A fragment of k-step i: a product's result feeds the
// next product from registers.
//
// Shared-memory tiles for ldmatrix are row-major with a row stride of LD
// 16-bit values; LD = D + 8 (16 bytes of padding) puts the 8 rows an
// ldmatrix phase reads in 8 distinct 16-byte bank groups, so the loads have
// no bank conflicts.
//
// wgmma: the four warps of a warpgroup compute a 64-row tile together, warp
// w holding rows 16w..16w+15 of the accumulator in the layout of C above
// (d[4j + e] is C fragment e of n-block j) and, for A from registers, the
// same rows in the layout of A above.  B, and A when it is read from shared
// memory, are tiles in the 128-byte-swizzle layout: 64-column sub-tiles of
// R rows x 128 bytes, 1024-byte aligned, the 16-byte chunk c of row r
// stored at chunk c ^ (r % 8) (sw128_chunk); a 32-column tile is one
// 64-byte swizzle atom a row (sw64_chunk, sw64_desc: 8-row groups of 512
// bytes, the same steps at half the row).  A K-major operand ([n][k]
// rows, e.g. K for S = Q K^T) advances its descriptor 32 bytes a k-step
// inside a sub-tile; an MN-major one ([k][n] rows, e.g. K for dQ = dS K,
// read with the transpose bit) advances 16 rows (2048 bytes) a k-step and
// steps across 64-column sub-tiles by the descriptor's leading offset.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace fa {
namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------- cp.async

// 16 bytes global -> shared; zero-filled when !pred (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(pred ? 16 : 0));
}

// 4 bytes global -> shared; zero-filled when !pred
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(pred ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// ------------------------------------------------------------- ldmatrix

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// A fragment of the 16x16 block at s (row-major, stride LD)
template <int LD, typename T>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const T* s,
                                       int lane) {
  ldsm_x4(a, s + (lane % 16) * LD + (lane / 16) * 8);
}

// B fragments of two n-blocks (16 n x 16 k) from [n][k] storage at s:
// b[0], b[1] for n 0-7 and b[2], b[3] for n 8-15
template <int LD, typename T>
__device__ __forceinline__ void load_b_nk(uint32_t (&b)[4], const T* s,
                                          int lane) {
  ldsm_x4(b, s + ((lane % 8) + (lane / 16) * 8) * LD + ((lane / 8) % 2) * 8);
}

// the same from [k][n] storage at s (ldmatrix transposes)
template <int LD, typename T>
__device__ __forceinline__ void load_b_kn(uint32_t (&b)[4], const T* s,
                                          int lane) {
  ldsm_x4_t(b, s + ((lane % 8) + ((lane / 8) % 2) * 8) * LD + (lane / 16) * 8);
}

// ----------------------------------------------------------------- mma

// c += a b, 16x8x16, fp32 accumulate
template <typename T>
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1);

template <>
__device__ __forceinline__ void mma16816<__nv_bfloat16>(
    float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <>
__device__ __forceinline__ void mma16816<__half>(
    float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b, 16x8x32, int8 inputs, int32 accumulate.  The fragments are
// m16n8k16's with each 32-bit register holding four 8-bit values (PTX ISA,
// "Matrix fragments for mma.m16n8k32"): a[0] (row g, k 4t..4t+3), a[1]
// (row g+8), a[2] (row g, k 4t+16..), a[3] (row g+8, k 4t+16..); b[0] (k
// 4t..4t+3, col g), b[1] (k 4t+16.., col g); c as m16n8k16's.  So the
// 16-bit ldmatrix loads give them from byte rows: load_a's addresses for A
// (16 rows x 32 bytes) and load_b_nk's for B stored [n][k].
__device__ __forceinline__ void mma16832_s8(int (&c)[4],
                                            const uint32_t (&a)[4],
                                            uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ------------------------------------------------------------- packing

// two floats rounded to nearest into one register, lo in the low half
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);

template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the A fragment of k-step i from the C fragments of n-blocks 2i, 2i+1
template <typename T>
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack2<T>(c0[0], c0[1]);
  a[1] = pack2<T>(c0[2], c0[3]);
  a[2] = pack2<T>(c1[0], c1[1]);
  a[3] = pack2<T>(c1[2], c1[3]);
}

// ---------------------------------------------------------------- wgmma

// byte offset of 16-byte chunk c8 (8 16-bit columns) of row r in an R-row
// tile in the 128-byte-swizzle layout
template <int R>
__device__ __forceinline__ int sw128_chunk(int r, int c8) {
  return (c8 / 8) * R * 128 + r * 128 + ((c8 % 8) ^ (r % 8)) * 16;
}

// byte offset of 16-byte chunk c8 (0-3) of row r in a tile of 64-byte rows
// (32 16-bit columns: one 64-byte swizzle atom a row) in the 64-byte-swizzle
// layout: chunk c8 stored at chunk c8 ^ ((r / 2) % 4), address bits 4-5
// XOR bits 7-8, a pattern that repeats every 8 rows (512 bytes)
__device__ __forceinline__ int sw64_chunk(int r, int c8) {
  return r * 64 + ((c8 ^ ((r >> 1) & 3)) * 16);
}

// shared-memory matrix descriptor, 64-byte swizzle (layout type 2): the
// fields of sw128_desc (an 8-row group is 512 bytes)
__device__ __forceinline__ uint64_t sw64_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(2) << 62;
}

// shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// byte offset (MN-major: between 64-column sub-tiles), stride byte offset
// (between 8-row groups)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(1) << 62;
}

// order earlier register writes before the next wgmma of this warpgroup
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// shared-memory writes of this thread (st.shared, cp.async) made visible
// to the async proxy that wgmma reads through
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// keep the compiler from moving reads of x above a wgmma wait
__device__ __forceinline__ void fence_operand(float& x) {
  asm volatile("" : "+f"(x) :: "memory");
}

// d (+)= A B over one k16 step, m64nNk16, fp32 accumulators d[N / 2]
// (acc 0: overwrite).  ss: A and B from shared memory, both K-major; ss_t:
// A from shared memory, K-major, B MN-major (transposed); rs: A from
// registers, B from shared memory, MN-major (transposed).
template <int N, typename T>
struct Wgmma;

// The accumulators as asm operands %0..%(N/2 - 1) (FA_WG_R<n>) and their
// "+f" bindings from d[i] on (FA_WG_D<n>(i)), for n = N / 2 accumulators a
// thread.
#define FA_WG_R8 "%0, %1, %2, %3, %4, %5, %6, %7"
#define FA_WG_R16                                                           \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
#define FA_WG_R32                                                           \
  FA_WG_R16 ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, " \
            "%28, %29, %30, %31"
#define FA_WG_R64                                                           \
  FA_WG_R32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
            "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "  \
            "%56, %57, %58, %59, %60, %61, %62, %63"
#define FA_WG_R128                                                          \
  FA_WG_R64 ", %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, "     \
            "%75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, "  \
            "%87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, "  \
            "%99, %100, %101, %102, %103, %104, %105, %106, %107, %108, "   \
            "%109, %110, %111, %112, %113, %114, %115, %116, %117, %118, "  \
            "%119, %120, %121, %122, %123, %124, %125, %126, %127"
#define FA_WG_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define FA_WG_D8(i) FA_WG_D4(i), FA_WG_D4(i + 4)
#define FA_WG_D16(i) \
  FA_WG_D4(i), FA_WG_D4(i + 4), FA_WG_D4(i + 8), FA_WG_D4(i + 12)
#define FA_WG_D32(i) FA_WG_D16(i), FA_WG_D16(i + 16)
#define FA_WG_D64(i) FA_WG_D32(i), FA_WG_D32(i + 32)
#define FA_WG_D128(i) FA_WG_D64(i), FA_WG_D64(i + 64)

// Wgmma<N, T> for PTX type TY ("bf16", "f16"); REGS and OUTS are the
// FA_WG_R<n> and FA_WG_D<n> of N, O0..O5 the numbers of the six asm
// operands that follow the accumulators (N / 2 .. N / 2 + 5).
#define FA_WG_SPEC(N, T, TY, REGS, OUTS, O0, O1, O2, O3, O4, O5)             \
  template <>                                                                \
  struct Wgmma<N, T> {                                                       \
    __device__ static void ss(float* d, uint64_t a, uint64_t b, int acc) {   \
      asm volatile(                                                          \
          "{\n.reg .pred p;\nsetp.ne.b32 p, %" O2 ", 0;\n"                   \
          "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "." TY "\n"   \
          "{" REGS "}, %" O0 ", %" O1 ", p, 1, 1, 0, 0;\n}\n"                \
          : OUTS(0)                                                          \
          : "l"(a), "l"(b), "r"(acc));                                       \
    }                                                                        \
    __device__ static void ss_t(float* d, uint64_t a, uint64_t b, int acc) { \
      asm volatile(                                                          \
          "{\n.reg .pred p;\nsetp.ne.b32 p, %" O2 ", 0;\n"                   \
          "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "." TY "\n"   \
          "{" REGS "}, %" O0 ", %" O1 ", p, 1, 1, 0, 1;\n}\n"                \
          : OUTS(0)                                                          \
          : "l"(a), "l"(b), "r"(acc));                                       \
    }                                                                        \
    __device__ static void rs(float* d, const uint32_t (&a)[4], uint64_t b,  \
                              int acc) {                                     \
      asm volatile(                                                          \
          "{\n.reg .pred p;\nsetp.ne.b32 p, %" O5 ", 0;\n"                   \
          "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "." TY "\n"   \
          "{" REGS "}, {%" O0 ", %" O1 ", %" O2 ", %" O3 "}, %" O4           \
          ", p, 1, 1, 1;\n}\n"                                               \
          : OUTS(0)                                                          \
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));   \
    }                                                                        \
  };

#define FA_WG_N(N, REGS, OUTS, O0, O1, O2, O3, O4, O5)                     \
  FA_WG_SPEC(N, __nv_bfloat16, "bf16", REGS, OUTS, O0, O1, O2, O3, O4, O5) \
  FA_WG_SPEC(N, __half, "f16", REGS, OUTS, O0, O1, O2, O3, O4, O5)

FA_WG_N(16, FA_WG_R8, FA_WG_D8, "8", "9", "10", "11", "12", "13")
FA_WG_N(32, FA_WG_R16, FA_WG_D16, "16", "17", "18", "19", "20", "21")
FA_WG_N(64, FA_WG_R32, FA_WG_D32, "32", "33", "34", "35", "36", "37")
FA_WG_N(128, FA_WG_R64, FA_WG_D64, "64", "65", "66", "67", "68", "69")
FA_WG_N(256, FA_WG_R128, FA_WG_D128, "128", "129", "130", "131", "132",
        "133")

// d (+)= A B over one k8 step of TF32, m64nNk8, fp32 accumulators d[N / 2]
// (acc 0: overwrite); rs: A from registers (a warp's 16 rows in the
// m16n8k8 .tf32 A layout: a0 (row g, k c), a1 (g + 8, c), a2 (g, c + 4),
// a3 (g + 8, c + 4)), B from shared memory, K-major (32-bit types take no
// transpose): a 128-byte-swizzled tile of 32 fp32 k values a row, a k8
// step 32 bytes into the row, as a bf16 k16 step.
template <int N>
struct WgmmaTf32;

#define FA_WGT_SPEC(N, REGS, OUTS, O0, O1, O2, O3, O4, O5)                  \
  template <>                                                              \
  struct WgmmaTf32<N> {                                                    \
    __device__ static void rs(float* d, const uint32_t (&a)[4], uint64_t b, \
                              int acc) {                                   \
      asm volatile(                                                        \
          "{\n.reg .pred p;\nsetp.ne.b32 p, %" O5 ", 0;\n"                 \
          "wgmma.mma_async.sync.aligned.m64n" #N "k8.f32.tf32.tf32\n"      \
          "{" REGS "}, {%" O0 ", %" O1 ", %" O2 ", %" O3 "}, %" O4         \
          ", p, 1, 1;\n}\n"                                                \
          : OUTS(0)                                                        \
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc)); \
    }                                                                      \
  };

FA_WGT_SPEC(32, FA_WG_R16, FA_WG_D16, "16", "17", "18", "19", "20", "21")
FA_WGT_SPEC(64, FA_WG_R32, FA_WG_D32, "32", "33", "34", "35", "36", "37")
FA_WGT_SPEC(128, FA_WG_R64, FA_WG_D64, "64", "65", "66", "67", "68", "69")
#undef FA_WGT_SPEC

// d (+)= A B over one k32 step of 8-bit integers, m64nNk32, int32
// accumulators d[N / 2] in the fp32 accumulators' layout (acc 0:
// overwrite).  A and B both from shared memory and K-major, the only
// layout integer wgmma reads: 128-byte-swizzled tiles of 128 int8 k values
// a row, a k32 step 32 bytes into the row (sw128_desc(addr + 32 kk, 0,
// 1024)), as a bf16 k16 step.
template <int N>
struct WgmmaS8;

#define FA_WGI_D4(i) "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3])
#define FA_WGI_D16(i) \
  FA_WGI_D4(i), FA_WGI_D4(i + 4), FA_WGI_D4(i + 8), FA_WGI_D4(i + 12)
#define FA_WGI_D32(i) FA_WGI_D16(i), FA_WGI_D16(i + 16)
#define FA_WGI_D64(i) FA_WGI_D32(i), FA_WGI_D32(i + 32)
#define FA_WGI_D128(i) FA_WGI_D64(i), FA_WGI_D64(i + 64)
#define FA_WGI_SPEC(N, REGS, OUTS, O0, O1, O2)                             \
  template <>                                                              \
  struct WgmmaS8<N> {                                                      \
    __device__ static void ss(int* d, uint64_t a, uint64_t b, int acc) {   \
      asm volatile(                                                        \
          "{\n.reg .pred p;\nsetp.ne.b32 p, %" O2 ", 0;\n"                 \
          "wgmma.mma_async.sync.aligned.m64n" #N "k32.s32.s8.s8\n"         \
          "{" REGS "}, %" O0 ", %" O1 ", p;\n}\n"                          \
          : OUTS(0)                                                        \
          : "l"(a), "l"(b), "r"(acc));                                     \
    }                                                                      \
  };

FA_WGI_SPEC(256, FA_WG_R128, FA_WGI_D128, "128", "129", "130")

#undef FA_WGI_SPEC
#undef FA_WG_R128
#undef FA_WGI_D128
#undef FA_WGI_D64
#undef FA_WGI_D32
#undef FA_WGI_D16
#undef FA_WGI_D4
#undef FA_WG_N
#undef FA_WG_SPEC
#undef FA_WG_D128
#undef FA_WG_D64
#undef FA_WG_D32
#undef FA_WG_D16
#undef FA_WG_D4
#undef FA_WG_R64
#undef FA_WG_R32
#undef FA_WG_R16

}  // namespace sm90
}  // namespace fa
