// The split-KV paged decode body for Hopper (sm_90a), instantiated for
// 16-bit pools (K4, csrc/decode.cu), fp32 pools (K4 fp32,
// csrc/decode_f32.cu) and int8, fp8 (e4m3) and int4 pools (K4q,
// csrc/decode_quant.cu).  The contracts are stated in those files; this
// one holds the schedule they share.
//
// What bounds it on this card: bytes.  Decode reads every live K and V byte
// once and does 4 * Rq operations per K/V element pair, far below the ~295
// flop/byte ridge, so the floor is the K/V bytes over 3.35 TB/s; at the
// engine's few-MB steps, launch latency and filling 132 SMs matter as much.
//
// What the design does about it:
//   * Work.  One block of 4 warps per (split, q-row tile, kv head, batch
//     row); the wrapper picks the split count that fills one wave of two
//     blocks an SM.  At Rq <= 16 (every decode step) the tile is the 16
//     rows of an m16 operand (rows past Rq are padding, free where bytes
//     bound) and the 4 warps split the keys: warp w takes the key groups g
//     of the split with g % 4 == w, counted from the split's first cache
//     row, and keeps its own (m, l, O); the warps combine them in shared
//     memory at the end, in warp order.  At Rq > 16 (short-prompt
//     prefills) the tile is 64 rows, each warp 16 of them over every
//     group.  Either way a K/V byte is read once per 64 q rows at most.  A
//     group is 32 keys for payload bytes (P's int8 group), a quarter of a
//     stage, at least 16, for 16-bit pools, and 16 keys for fp32 pools at
//     D 32 / 64, 8 at D 128 / 256.  (16-bit pools at D 256 keep 16-key
//     groups, two warps of four a 32-key stage: the ring bounds that shape.
//     With its products taken out (kAblCopies) it took 94% of the kernel's
//     time at Gemma-2B's 8k step, and 8-key groups, every warp every stage,
//     timed no faster.)
//   * Copies.  The block reads its split's page ids into shared memory
//     once, beside Q.  K/V (and for K4q the keys' scales) stream through a
//     cp.async ring in their storage type (bf16/fp16, or bytes), stage
//     s + NS - 1 copied while stage s is computed: 3 stages of 128 keys at
//     D 32/64, of 64 at D 128 (16-bit) and of 32 at D 256; for fp32 pools
//     3 of half as many keys (64 at D 32 / 64, 32 at 128, 16 at 256: the
//     same bytes); 2 of 128 for payload bytes at D 128, whose 128-byte
//     rows are swizzled (chunk c of row r at c ^ (r % 8)) instead of
//     padded.  Where the page size is a multiple of a stage a stage lies
//     in one page, and a thread's addresses are one base plus constant
//     steps.  Rows outside the live range are zero-filled.
//   * Products.  S = Q K^T and O += P V on mma.sync, S, P and O in
//     registers: m16n8k16 for 16-bit pools and fp8 (e4m3 converted exactly
//     in registers, K to q's type and V to bf16, by exponent arithmetic
//     rather than conversion instructions), m16n8k32 on int8 for int8 and
//     int4 (int32 products, bit-equal to dp4a sums).  P feeds P V from the
//     accumulator layout as the A operand.  An 8-bit B operand must be
//     K-major and ldmatrix cannot transpose bytes, so V's fragments come
//     from ldmatrix.trans on byte pairs and a byte permute (v_frags): each
//     register holds one dim and the keys 2 t, 2 t + 1, 2 t + 8, 2 t + 9,
//     S's accumulator layout, at the cost of O's columns in a permuted
//     order that the epilogue undoes.  For fp8, Q's columns are permuted
//     within each 16 so that the e4m3 K bytes from ldmatrix convert
//     straight into B fragments.  int4 K is unpacked into a warp tile.
//   * fp32 pools (K4 fp32).  S and O += P V are 3 x TF32 split products on
//     mma.sync m16n8k8 .tf32 (csrc/f32_tiles.cuh: x = hi + lo, A B =
//     A_lo B_hi + A_hi B_lo + A_hi B_hi), K and V split as their fragments
//     are read from rows of D + 4 floats (no bank conflicts), P's A
//     fragments split from S's accumulators.  Q is split once into
//     registers at D 32 / 64; at D 128 / 256 its fragments are read from
//     an fp32 Q tile each group (registers: O takes D / 2 a thread).  S
//     runs as two chains of products (even and odd k-steps).  The tensor
//     cores add into fp32 by truncation, so each group's P V (one or two
//     k-steps) goes into a zeroed fragment that O takes with an FADD
//     (f32_tiles.cuh `flush`), as the other fp32 bodies do.  No run showed
//     that this body needs it: a CPU model of one unflushed chain over 2048
//     keys stays inside the forward gate, and no card run tested the body
//     without it.  Shared memory a block: about 55 / 104 /
//     110 KB at D 32 / 64 / 128 (two blocks an SM; a 64-row block at D 128
//     holds a 34 KB Q tile besides, one block), 116 KB at D 256 (16 rows;
//     166 KB at 64): one block an SM at D 256.
//   * Softmax.  Online, on the fragments, in base 2 (ex2.approx, scale *
//     log2(e) folded into the FFMA; natural-domain score_bias then log2(e)
//     where ALiBi or softcap is on), updated per group; a group every row
//     sees whole takes a path with no per-key test, and O's rescale is
//     skipped where no row's max moved.  For K4q, P's amax and rint(p /
//     p_scale) run on the fragments of one group, with one exact-division
//     branch per eight values (the reciprocal fast path of
//     csrc/varlen_paged_quant.cu).  For fp32 pools, in the natural base
//     with expf, as the fp32 bodies (csrc/fwd_f32.cu) compute it.
//   * fp32 q over quantized pools (K4q).  int8 / int4 quantize the fp32
//     rows as they do 16-bit ones.  For fp8 the TPU kernel's S is the fp32
//     q . k, which one bf16 (or TF32) rounding of q misses: q is split
//     into three bf16 tiles whose sum is q exactly (fa::split_bf16x3) and
//     S is three m16n8k16 products against the same converted K
//     fragments, fp32 accumulation (three times the S work, which is a
//     small share of a bytes-bound step); P V is the 16-bit path's.  O
//     comes out in fp32.
//   * The merge.  Given merged outputs, a block writes its normalized
//     partial, fences, and bumps its (b, kv head, row tile)'s arrival
//     counter; the last of the S blocks to arrive merges their partials in
//     split order (deterministic whatever the arrival order), all its
//     threads over (row, 4 columns), writes O in q's type and the LSE, and
//     resets the counter to zero.  One launch, no combine kernel; with one
//     split the block writes the merged output directly.  At D 256 with
//     kBulkMergeSplits (32) splits or more (Gemma-2B's step at 8k has 33)
//     the merge, the launch's tail after the last split lands, reads its
//     partials together instead (`merge_bulk`): every split's LSE into
//     shared memory at once, a thread a row takes the weights from there,
//     the partials come by bulk copies (TMA) a chunk of splits at a time
//     on one mbarrier, and each thread sums its (row, 4 columns) from
//     shared memory in split order: the same additions in the same order,
//     so the same bits.  Its fixed costs (proxy fences, the mbarrier, four
//     block barriers) made it slower at D 128 over 33 splits and with few
//     splits (the engine step's 8, Gemma-7B's 2), which keep the loop.
//   * Ablations (ABL; the shipped kernels take 0).  The sweep libraries
//     (FA_SWEEP, ops/cuda/build.py VARIANTS) instantiate, for timing only:
//     int4 K4q at bf16 q, D 128 with parts of the nibble chain taken out
//     (csrc/decode_quant.cu, benchmarks/prof_int4_ablate); K4 at bf16, D
//     256, 16 rows with no products at all, the ring's own ceiling
//     (csrc/decode.cu, `chip_smoke.py --decode-times`' `copies` rows).
#pragma once

#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "attn_tiles.cuh"
#include "f32_tiles.cuh"
#include "masks.cuh"
#include "quant.cuh"
#include "tma_pipe.cuh"

namespace fa {
namespace dec {

using namespace fa::attn;

constexpr int kK16 = 3;        // 16-bit pools; fa::kInt8 / kFp8 / kInt4
constexpr int kK32 = 4;        // fp32 pools (and q)
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kGroup = 32;     // keys a warp step: P's int8 group
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// the int4 ablations (wrong numbers, timing only): what of the nibble chain
// a variant keeps
constexpr int kAblFullQk = 1;  // the production S; P V over one nibble
                               // half of V, duplicated into both halves
constexpr int kAblQkOne = 2;   // S of one K half (16 of the 32 keys'
                               // products), duplicated; P V as kAblFullQk
constexpr int kAblNoAnd = 3;   // the packed bytes read as int8 K and V with
                               // no unpacking; S and P V halved as kAblQkOne
// K4's ablation (16-bit pools): the ring alone, its copies, waits and
// barriers with no products or softmax (O 0, LSE -inf): the copies' own
// ceiling
constexpr int kAblCopies = 4;

struct DecodeArgs {
  const void* q;          // (B, Hk, Rq, D) contiguous, bf16 or fp16 (K4q:
                          // or fp32)
  const unsigned char* k; // pool view base; strides below in bytes
  const unsigned char* v;
  const float* ks;        // K4q: scale pool views, float strides below
  const float* vs;
  const int* table;       // (B, max_pages)
  const int* lens;        // (B,) live tokens after leftpad
  const int* leftpad;     // (B,) or nullptr
  const int* qpos;        // (B,) position of the first new token
  const float* slopes;    // (B, Hk, Rq) or nullptr
  float* o_part;          // (B, Hk, S, Rq, D)
  float* lse_part;        // (B, Hk, S, Rq)
  void* o;                // merged (B, Hk, Rq, D) in q's type, or nullptr
  float* lse;             // merged (B, Hk, Rq)
  int* counters;          // (B * Hk * row tiles) arrival counters, zero
                          // between calls
  long long s_c1, s_h, s_c2, s_tok;
  long long sc_c1, sc_h, sc_c2, sc_tok;
  int c2;
  int B, Hk, Rq, S, max_pages, page_size, pages_per_split, t_new, group;
  float scale;
  fa::MaskParams mp;
};

constexpr size_t align16(size_t x) { return (x + 15) / 16 * 16; }

// shared memory: the Q tile, the stages, int4's unpacked K (a tile a
// warp), the split's page ids; at Rq <= 16 the warps' (O, m, l) over the
// stages at the end, and the merge's row weights
template <typename T, int D, int KIND, int ROWS>
struct Smem {
  static constexpr bool kWide = KIND == kK32;   // fp32 pools
  static constexpr bool kByte = KIND != kK16 && !kWide;
  static constexpr bool kInt = KIND == fa::kInt8 || KIND == fa::kInt4;
  static constexpr bool kF32 = std::is_same<T, float>::value;
  // bf16 Q tiles: one, or fp32 q's three parts over an fp8 pool
  static constexpr int QP = KIND == fa::kFp8 && kF32 ? 3 : 1;
  // fp32 pools: Q's split fragments in registers (D 32 / 64), else an fp32
  // Q tile
  static constexpr bool kQReg = kWide && D <= 64;
  // keys a stage and stages: 3 stages of 128 keys at D 32 / 64 and of 64
  // at D 128 for 16-bit pools (two blocks an SM, about 128 KB in flight),
  // 2 of 128 for payload bytes at D 128 (every warp a group of each
  // stage), 3 of 32 at D 256; fp32 pools 3 of 64 at D 32 / 64, 32 at 128
  // and 16 at 256.  (Five 32-key stages at D 256, one block an SM with
  // 132 KB in flight, were slower than two blocks of three: the first four
  // stages took longer to issue than two blocks' first two.)
  static constexpr int BK = kWide ? (D <= 64 ? 64 : (D == 128 ? 32 : 16))
                            : D <= 64 || (kByte && D == 128) ? 128
                            : (D == 128 ? 64 : 32);
  static constexpr int NS = kByte && D == 128 ? 2 : 3;
  // keys a warp step: P's int8 group (32) for payload bytes; a quarter of
  // a stage, at least 16, for 16- and 32-bit pools, but 8 for fp32 pools at
  // D 128 / 256 (every warp a group of a 32-key stage at 128; with 16, two
  // warps of four worked a stage, slower at the 32k decode)
  static constexpr int G = kByte                ? kGroup
                           : kWide && D >= 128 ? 8
                                               : (BK / 4 > 16 ? BK / 4 : 16);
  static constexpr int NG = BK / G;
  static constexpr int QLD =   // bytes a row
      kInt ? D + 16 : (kWide ? (D + 4) * 4 : (D + 8) * 2);
  static constexpr size_t q_bytes =
      kQReg ? 0
            : static_cast<size_t>(QP) * ROWS * QLD + (kInt ? 4 * ROWS : 0);
  // payload rows of 128 bytes (D 128) are 128-byte swizzled (16-byte chunk
  // c of row r at c ^ (r % 8): ldmatrix without bank conflicts or
  // padding), others padded by 16 bytes
  static constexpr bool kSwz = kByte && D == 128;
  static constexpr int KLD = kByte   ? (kSwz ? D : D + 16)
                             : kWide ? (D + 4) * 4
                                     : (D + 8) * 2;
  static constexpr int K8LD = D + 16;   // int4's unpacked K rows
  static constexpr int PR = KIND == fa::kInt4 ? BK / 2 : BK;  // payload rows
  static constexpr size_t v_off = static_cast<size_t>(PR) * KLD;
  static constexpr size_t sc_off = 2 * v_off;
  static constexpr size_t stage_bytes = sc_off + (kByte ? 8 * BK : 0);
  static constexpr size_t stage_off = align16(q_bytes);
  static constexpr size_t k8_bytes =
      KIND == fa::kInt4 ? static_cast<size_t>(kGroup) * K8LD : 0;
  static constexpr size_t k8_off = stage_off + NS * stage_bytes;
  static constexpr size_t tbl_off = k8_off + kWarps * k8_bytes;
  static constexpr int OLD = D + 4;                         // floats a row
  static constexpr size_t comb_bytes =
      ROWS == 16 ? sizeof(float) * kWarps * 16 * (OLD + 2) : 0;
  static constexpr size_t bytes(size_t tbl) {
    return tbl_off + tbl > stage_off + comb_bytes ? tbl_off + tbl
                                                  : stage_off + comb_bytes;
  }
  // floats the merge may use from stage_off on (the page ids are spent)
  static constexpr int kMergeFloats =
      static_cast<int>((bytes(0) - stage_off) / 4);
};

// an e4m3 byte as an fp32 value, exactly: its magnitude bits placed at
// fp32's low exponent and high mantissa bits give 2^(e - 127) (1 + m / 8)
// (a denormal m 2^-129 where e = 0), which 2^120 scales to the e4m3 value
// 2^(e - 7) (1 + m / 8) (m 2^-9); no conversion instruction (those run at
// a quarter of the FMA rate; one to fp16 and integer arithmetic on to
// bf16 was slower).  0x7F (e4m3's NaN) reads as 480: quantized pools hold
// none.
__device__ __forceinline__ float e4m3_f32(uint32_t b) {
  return __uint_as_float(((b & 0x7Fu) << 20) | ((b & 0x80u) << 24)) *
         0x1p120f;
}

// two e4m3 values (low byte first) -> two TT values, exactly (every e4m3
// value is a bf16 and an fp16 value), lo in the low half; bf16 is the
// high half of the exact fp32 value (3 mantissa bits)
template <typename TT>
__device__ __forceinline__ uint32_t e4m3x2_to(uint32_t two) {
  if constexpr (std::is_same<TT, __half>::value) {
    const __half2_raw hr = __nv_cvt_fp8x2_to_halfraw2(
        static_cast<__nv_fp8x2_storage_t>(two & 0xFFFFu), __NV_E4M3);
    return static_cast<uint32_t>(hr.x) | static_cast<uint32_t>(hr.y) << 16;
  } else {
    return __byte_perm(__float_as_uint(e4m3_f32(two)),
                       __float_as_uint(e4m3_f32(two >> 8)), 0x7632);
  }
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// the softmax's exponential: of a base-2 exponent (ex2), or for fp32
// pools (NAT) of a natural one (expf, the fp32 bodies')
template <bool NAT>
__device__ __forceinline__ float exp_of(float x) {
  return NAT ? expf(x) : ex2(x);
}

// int <-> float on the full-rate pipes: kMagic + x holds the integer x in
// its low mantissa bits for |x| < 2^22 (an S of at most 256 * 127 * 128, a
// P V sum of at most 32 * 127 * 128)
constexpr float kMagic = 12582912.0f;   // 1.5 * 2^23
constexpr int kMagicBits = 0x4B400000;

__device__ __forceinline__ float i2f(int x) {
  return __int_as_float(x + kMagicBits) - kMagic;
}

// P's int8 value of p >= 0 under scale ps: rint of the IEEE quotient p /
// ps, half to even, kept as kMagic + q (q in the low byte).  r = p * inv
// (inv = 1 / ps rounded) lies within 1.9e-5 of the quotient (two roundings
// below 128), so kMagic + r rounds to the quotient's q wherever r lies
// farther than kTie from a half-integer; `near` says where it does not,
// and the caller divides there.
constexpr float kTie = 0.5f - 3.0517578125e-05f;   // 0.5 - 2^-15

__device__ __forceinline__ uint32_t p8_fast(float p, float inv, bool& near) {
  const float r = p * inv;
  const float t = r + kMagic;
  near |= fabsf(r - (t - kMagic)) >= kTie;
  return __float_as_uint(t);
}

// the low bytes of four words, the first in the low byte
__device__ __forceinline__ uint32_t pack_s8(uint32_t a, uint32_t b,
                                            uint32_t c, uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
}

// 16-byte chunk c of row r in a payload tile, swizzled or not
template <bool SWZ>
__device__ __forceinline__ int chunk(int r, int c) {
  return SWZ ? c ^ (r % 8) : c;
}

// a B operand's lane address in an [n][k] byte tile of row stride ld, for
// the 32 bytes from chunk 2 kk
template <bool SWZ>
__device__ __forceinline__ const unsigned char* b_addr(const unsigned char* t,
                                                       int ld, int lane,
                                                       int kk) {
  const int r = (lane % 8) + (lane / 16) * 8;
  return t + r * ld + chunk<SWZ>(r, 2 * kk + (lane / 8) % 2) * 16;
}

// 8-bit V for P V without a transposed copy.  ldmatrix.trans on the
// [key][dim] byte tile read as 16-bit pairs hands a thread, from an 8-row
// matrix, rows 2 t and 2 t + 1 at dim pair g: bytes (key a: dims 2 g,
// 2 g + 1; key b: the same).  Two such registers, byte-permuted, give dim
// 2 g (even, E) and dim 2 g + 1 (odd, O) with the keys 2 t, 2 t + 1,
// 2 t + 8, 2 t + 9 of a 16: the B fragment of P's A layout (S's
// accumulator layout, keys permuted as in csrc/varlen_paged_quant.cu).  O
// then holds its dims in n-block pairs: n-block 2 c (E) columns are dims
// 16 c + 2 n, n-block 2 c + 1 (O) dims 16 c + 2 n + 1.
//   int8 / fp8: matrix m = keys 8 m .. 8 m + 7 of the group, chunk c.
//   int4: packed rows; lane i of matrix m reads packed row i / 2 +
//     4 (i % 2) + 8 (m % 2) of chunk c + m / 2, so a thread's rows are
//     packed rows t and t + 4 (keys 2 t, 2 t + 1 and 2 t + 8, 2 t + 9
//     after the nibbles split).
// Fills bE[k], bO[k] (k: keys 16 k .. 16 k + 15 of the group).
template <int KIND, int KLD, bool SWZ>
__device__ __forceinline__ void v_frags(const unsigned char* vg, int c,
                                        int lane, uint32_t (&bE)[2][2],
                                        uint32_t (&bO)[2][2]) {
  uint32_t r[4];
  if constexpr (KIND == fa::kInt4) {
    const int i = lane % 8, m = lane / 8;
    const int row = i / 2 + 4 * (i % 2) + 8 * (m % 2);
    ldsm_x4_t(r, vg + row * KLD + chunk<SWZ>(row, 2 * c + m / 2) * 16);
    // r[0], r[1]: chunk 2 c (keys 0-15, 16-31); r[2], r[3]: chunk 2 c + 1
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        uint32_t lo, hi;
        fa::unpack_int4x4(r[2 * h + k], lo, hi);
        bE[k][h] = __byte_perm(lo, hi, 0x6240);
        bO[k][h] = __byte_perm(lo, hi, 0x7351);
      }
  } else {
    ldsm_x4_t(r, vg + lane * KLD + chunk<SWZ>(lane, c) * 16);
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      bE[k][0] = __byte_perm(r[2 * k], r[2 * k + 1], 0x6420);
      bO[k][0] = __byte_perm(r[2 * k], r[2 * k + 1], 0x7531);
    }
  }
}

// The split merge of the last block of (b, kv head, row tile) to arrive,
// at D 256 with at least kBulkMergeSplits splits (the decode body's header,
// "The merge"): its partials come into shared memory by bulk copies (TMA)
// and every sum keeps its split order, so the bits are those of the
// kernel's own merge.
constexpr int kBulkMergeSplits = 32;

template <typename L, typename T, int D, int ROWS>
__device__ __forceinline__ void merge_bulk(const DecodeArgs& a,
                                           unsigned char* smem,
                                           long long bh, int row0) {
  __shared__ uint64_t merge_bar;   // the bulk copies' barrier
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // the partials, written by the generic proxy of other blocks, read below
  // by the async proxy (bulk copies)
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
  const long long base_row = bh * a.S * a.Rq;
  const int nr = min(ROWS, a.Rq - row0);
  // (a volatile load: __ldcg's asm declares no memory access, so the
  // compiler may hoist it out of the branch that guards it, and a loop
  // that takes its weights from shared memory then waits on L2 each step)
  auto lse_of = [&](int s, int r) {
    float x;
    asm volatile("ld.global.cg.f32 %0, [%1];\n"
                 : "=f"(x)
                 : "l"(a.lse_part + base_row +
                       static_cast<long long>(s) * a.Rq + r));
    return x;
  };
  // shared memory from the stages on: each row's (max LSE, weight sum),
  // the weights w[s][i] of the first SC splits in at most half of it (the
  // rest are recomputed, to the same bits, where they are used), then the
  // partials' chunks
  float* mw = reinterpret_cast<float*>(smem + L::stage_off);
  float* wt = mw + 2 * ROWS;
  const int SC = min(a.S, (L::kMergeFloats / 2 - 2 * ROWS) / nr);
  // every LSE of the first SC splits, all threads' loads in flight together
#pragma unroll 4
  for (int idx = tid; idx < SC * nr; idx += kThreads)
    wt[idx] = lse_of(idx / nr, row0 + idx % nr);
  __syncthreads();
  // a thread a row: the max over the splits, then the weights
  // exp(lse - max), 0 in a row with no live key, and their sum in split
  // order (shared memory reads, so the row's chain is short)
  for (int i = tid; i < nr; i += kThreads) {
    float mx = -INFINITY;
    for (int s = 0; s < SC; ++s) mx = fmaxf(mx, wt[s * nr + i]);
    for (int s = SC; s < a.S; ++s) mx = fmaxf(mx, lse_of(s, row0 + i));
    float sw = 0.0f;
    if (mx != -INFINITY) {
      for (int s = 0; s < SC; ++s) {
        const float w = expf(wt[s * nr + i] - mx);
        wt[s * nr + i] = w;
        sw += w;
      }
      for (int s = SC; s < a.S; ++s) sw += expf(lse_of(s, row0 + i) - mx);
    } else {
      for (int s = 0; s < SC; ++s) wt[s * nr + i] = 0.0f;
    }
    mw[2 * i] = mx;
    mw[2 * i + 1] = sw;
  }
  __syncthreads();
  // every (row, 4 columns): the partials summed in split order.  A pass
  // takes rows [i_lo, i_hi), at most kIt (row, 4 columns) a thread; their
  // partials are copied into shared memory a chunk of splits at a time,
  // one bulk copy (TMA) a split (its rows are contiguous), all in flight
  // together on one mbarrier, then summed from there split by split (a
  // block's own 16-byte cp.async copies moved half the bytes a second).
  constexpr int kIt = 4;
  float* part = wt + (SC * nr + 3) / 4 * 4;   // 16-byte aligned
  const int cap = L::kMergeFloats - static_cast<int>(part - mw);
  if (tid == 0) {
    tma::mbar_init(&merge_bar, 1);
    tma::mbar_init_fence();
  }
  __syncthreads();
  uint32_t parity = 0;
  // splits [c0, c0 + nc) of rows [i_lo, i_lo + span_f / D) into `part`:
  // warp 0 arms the barrier and issues a copy a split, every thread
  // waits for the bytes (the shared memory they overwrite was last used
  // by this block's generic loads and stores, ordered by the barrier
  // before this call and the proxy fence)
  auto copy_chunk = [&](int c0, int nc, int i_lo, int span_f) {
    if (warp == 0) {
      if (lane == 0) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        tma::mbar_expect_tx(&merge_bar, nc * span_f * 4);
      }
      __syncwarp();
      for (int sl = lane; sl < nc; sl += 32)
        tma::bulk_copy(part + sl * span_f,
                       a.o_part + (base_row +
                                   static_cast<long long>(c0 + sl) * a.Rq +
                                   row0 + i_lo) * D,
                       span_f * 4, &merge_bar);
    }
    tma::mbar_wait(&merge_bar, parity);
    parity ^= 1;
  };
  const int rows_pass = min(kIt * kThreads * 4 / D, cap / D);
  for (int i_lo = 0; i_lo < nr; i_lo += rows_pass) {
    const int i_hi = min(nr, i_lo + rows_pass);
    const int span_f = (i_hi - i_lo) * D;   // floats a split
    const int sch = cap / span_f;           // splits a chunk
    const int g0 = i_lo * (D / 4), g1 = i_hi * (D / 4);
    float4 acc[kIt];
#pragma unroll
    for (int k = 0; k < kIt; ++k) acc[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int c0 = 0; c0 < a.S; c0 += sch) {
      const int nc = min(sch, a.S - c0);
      copy_chunk(c0, nc, i_lo, span_f);
      // the thread's items side by side, split by split (an item past the
      // pass's end repeats its last, unwritten); an empty row weighs 0
      const float* pv[kIt];
      int ik[kIt];
      float mxk[kIt];
#pragma unroll
      for (int k = 0; k < kIt; ++k) {
        const int idx = min(g0 + k * kThreads + tid, g1 - 1);
        ik[k] = idx / (D / 4);
        mxk[k] = mw[2 * ik[k]];
        pv[k] = part + (ik[k] - i_lo) * D + 4 * (idx % (D / 4));
      }
      // (splits past SC, beyond the weights' room, recompute theirs)
      const int n_fast = max(0, min(nc, SC - c0));
#pragma unroll 4
      for (int sl = 0; sl < n_fast; ++sl) {
        const float* ws = wt + (c0 + sl) * nr;
        float w[kIt];
        float4 v4[kIt];
#pragma unroll
        for (int k = 0; k < kIt; ++k) {
          w[k] = ws[ik[k]];
          v4[k] = *reinterpret_cast<const float4*>(pv[k] + sl * span_f);
        }
#pragma unroll
        for (int k = 0; k < kIt; ++k) {
          acc[k].x += w[k] * v4[k].x;
          acc[k].y += w[k] * v4[k].y;
          acc[k].z += w[k] * v4[k].z;
          acc[k].w += w[k] * v4[k].w;
        }
      }
      for (int sl = n_fast; sl < nc; ++sl) {
        const int s = c0 + sl;
        float w[kIt];
        float4 v4[kIt];
#pragma unroll
        for (int k = 0; k < kIt; ++k) {
          w[k] = mxk[k] == -INFINITY
                     ? 0.0f
                     : expf(lse_of(s, row0 + ik[k]) - mxk[k]);
          v4[k] = *reinterpret_cast<const float4*>(pv[k] + sl * span_f);
        }
#pragma unroll
        for (int k = 0; k < kIt; ++k) {
          acc[k].x += w[k] * v4[k].x;
          acc[k].y += w[k] * v4[k].y;
          acc[k].z += w[k] * v4[k].z;
          acc[k].w += w[k] * v4[k].w;
        }
      }
      __syncthreads();   // the chunk read before the next overwrites it
    }
#pragma unroll
    for (int k = 0; k < kIt; ++k) {
      const int idx = g0 + k * kThreads + tid;
      if (idx >= g1) break;
      const int i = idx / (D / 4), d = 4 * (idx % (D / 4)), r = row0 + i;
      const float mx = mw[2 * i], sw = mw[2 * i + 1];
      float4 o4 = acc[k];
      if (mx != -INFINITY) {
        const float inv = 1.0f / sw;
        o4 = make_float4(o4.x * inv, o4.y * inv, o4.z * inv, o4.w * inv);
      }
      if constexpr (L::kF32)
        *reinterpret_cast<float4*>(static_cast<float*>(a.o) +
                                   (bh * a.Rq + r) * D + d) = o4;
      else
        *reinterpret_cast<uint2*>(static_cast<T*>(a.o) +
                                  (bh * a.Rq + r) * D + d) =
            make_uint2(pack2<T>(o4.x, o4.y), pack2<T>(o4.z, o4.w));
      if (d == 0) a.lse[bh * a.Rq + r] = mx == -INFINITY ? -INFINITY
                                                         : mx + logf(sw);
    }
  }
}

// (a two-block minimum steers ptxas off a 128-register allocation that
// spilled the fp8 variants at D 128; it caps nothing below 255)
template <typename T, int D, int KIND, int ROWS, int ABL = 0>
__global__ void __launch_bounds__(kThreads, 2)
    decode_kernel(const DecodeArgs a) {
  static_assert(ABL == 0 || (ABL == kAblCopies ? KIND == kK16
                                                : KIND == fa::kInt4),
                "the ablations: int4's, and K4's");
  using L = Smem<T, D, KIND, ROWS>;
  constexpr int BK = L::BK, NG = L::NG, KLD = L::KLD, G = L::G;
  constexpr bool SWZ = L::kSwz;
  constexpr int NJ = G / 8;    // S's n-blocks a warp step
  constexpr bool kByte = L::kByte, kInt = L::kInt, kWide = L::kWide;
  constexpr bool kKeySplit = ROWS == 16;
  constexpr int LDE = D + 8;   // 16-bit Q tile: elements a row
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last_block;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n_rt = kKeySplit ? 1 : (a.Rq + ROWS - 1) / ROWS;
  const int split = blockIdx.x / n_rt;
  const int row0 = (blockIdx.x % n_rt) * ROWS;
  const int h = blockIdx.y, b = blockIdx.z;
  const long long bh = static_cast<long long>(b) * a.Hk + h;
  const int lp = a.leftpad ? a.leftpad[b] : 0;
  const int cs = a.lens[b];
  const int qbase = a.qpos ? a.qpos[b] : cs - a.t_new;
  const int n_rows = a.group * a.t_new;
  const int ps = a.page_size;

  // this split's cache rows [j_lo, j_hi), trimmed to the live, window and
  // causal extent; stages from the split's first row in steps of BK
  const int span = a.pages_per_split * ps;
  const int split0 = split * span;
  int j_lo = max(split0, lp);
  int j_hi = min(min(split0 + span, a.max_pages * ps), lp + cs);
  if (a.mp.window_left >= 0) j_lo = max(j_lo, lp + qbase - a.mp.window_left);
  const int wr = a.mp.effective_window_right();
  if (wr >= 0) j_hi = min(j_hi, lp + qbase + (a.t_new - 1) + wr + 1);
  const int j_first = j_lo < j_hi ? split0 + (j_lo - split0) / BK * BK : 0;
  const int n_st = j_lo < j_hi ? (j_hi - j_first + BK - 1) / BK : 0;

  // the split's page ids, once (all of its slots: their loads need not
  // wait for the lengths), beside Q below; the barrier after Q
  int* tbl_s = reinterpret_cast<int*>(smem + L::tbl_off);
  const int slot_lo = split * a.pages_per_split;
  {
    const int n_slots = min(a.pages_per_split, a.max_pages - slot_lo);
    const int* trow = a.table + static_cast<long long>(b) * a.max_pages +
                      slot_lo;
    for (int i = tid; i < n_slots; i += kThreads) tbl_s[i] = trow[i];
  }

  // stage t: payload rows by cp.async (tokens per row TPR), then the keys'
  // k and v scales (K4q)
  constexpr int TPR = KIND == fa::kInt4 ? 2 : 1;
  constexpr int CH =   // 16-byte chunks a row
      (kByte ? D : (kWide ? 4 : 2) * D) / 16;
  constexpr int STEP = kThreads / CH;
  static_assert(kThreads % CH == 0 && L::PR % STEP == 0 &&
                    (!L::kSwz || STEP % 8 == 0), "copy split");
  const int r_t = tid / CH, c_t = tid % CH;
  const unsigned char* kbase = a.k + h * a.s_h;
  const unsigned char* vbase = a.v + h * a.s_h;
  const bool one_page = ps % BK == 0;
  auto stage = [&](int t) {
    return smem + L::stage_off + (t % L::NS) * L::stage_bytes;
  };
  // a page's offsets into the payload and scale pools
  auto pay_off = [&](int page) {
    return static_cast<long long>(page / a.c2) * a.s_c1 +
           static_cast<long long>(page % a.c2) * a.s_c2;
  };
  auto sc_off = [&](int page) {
    return h * a.sc_h + static_cast<long long>(page / a.c2) * a.sc_c1 +
           static_cast<long long>(page % a.c2) * a.sc_c2;
  };
  auto issue = [&](int t) {
    const int j0 = j_first + t * BK;
    // (rows r_t + i STEP share r_t % 8: STEP is a multiple of 8 where
    // rows are swizzled)
    unsigned char* dk = stage(t) + r_t * KLD + chunk<SWZ>(r_t, c_t) * 16;
    float* dsc = reinterpret_cast<float*>(stage(t) + L::sc_off);
    if (one_page) {
      // the stage lies in one page: one base, constant steps
      const int slot = j0 / ps, page = tbl_s[slot - slot_lo];
      const int off = j0 - slot * ps;
      const long long o =
          pay_off(page) +
          static_cast<long long>(off / TPR + r_t) * a.s_tok + c_t * 16;
      const long long step = STEP * a.s_tok;
#pragma unroll
      for (int i = 0; i < L::PR / STEP; ++i) {
        const int jr = j0 + (r_t + i * STEP) * TPR;
        const bool in = jr + TPR > j_lo && jr < j_hi;
        cp_async16(dk + i * STEP * KLD, in ? kbase + o + i * step : kbase, in);
        cp_async16(dk + L::v_off + i * STEP * KLD,
                   in ? vbase + o + i * step : vbase, in);
      }
      if constexpr (kByte) {
        const long long so = sc_off(page) + static_cast<long long>(off) *
                                                a.sc_tok;
        for (int idx = tid; idx < 2 * BK; idx += kThreads) {
          const int c = idx % BK;
          const bool in = j0 + c >= j_lo && j0 + c < j_hi;
          cp_async4(dsc + idx,
                    in ? (idx < BK ? a.ks : a.vs) + so + c * a.sc_tok : a.ks,
                    in);
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < L::PR / STEP; ++i) {
        const int jr = j0 + (r_t + i * STEP) * TPR;
        const bool in = jr + TPR > j_lo && jr < j_hi;
        const int slot = jr / ps, page = in ? tbl_s[slot - slot_lo] : 0;
        const long long o =
            in ? pay_off(page) +
                     static_cast<long long>((jr - slot * ps) / TPR) *
                         a.s_tok + c_t * 16
               : 0;
        cp_async16(dk + i * STEP * KLD, kbase + o, in);
        cp_async16(dk + L::v_off + i * STEP * KLD, vbase + o, in);
      }
      if constexpr (kByte) {
        for (int idx = tid; idx < 2 * BK; idx += kThreads) {
          const int j = j0 + idx % BK;
          const bool in = j >= j_lo && j < j_hi;
          const float* src = a.ks;
          if (in) {
            const int slot = j / ps, page = tbl_s[slot - slot_lo];
            src = (idx < BK ? a.ks : a.vs) + sc_off(page) +
                  static_cast<long long>(j - slot * ps) * a.sc_tok;
          }
          cp_async4(dsc + idx, src, in);
        }
      }
    }
  };

  // Q: 16-bit rows by cp.async (K4), permuted columns (fp8), or int8 rows
  // quantized per row with scale amax / 127 (IEEE division) and rint (int8,
  // int4); rows past Rq are zero
  const long long q_row0 = bh * a.Rq + row0;
  if constexpr (KIND == kK16) {
    const unsigned char* qg = static_cast<const unsigned char*>(a.q);
    for (int idx = tid; idx < ROWS * (D / 8); idx += kThreads) {
      const int r = idx / (D / 8), c = idx % (D / 8);
      const bool in = row0 + r < a.Rq;
      cp_async16(smem + r * L::QLD + c * 16,
                 in ? qg + ((q_row0 + r) * D + c * 8) * 2 : qg, in);
    }
  } else if constexpr (kWide) {
    // fp32 rows by cp.async where Q's fragments are read from a tile
    if constexpr (!L::kQReg) {
      const unsigned char* qg = static_cast<const unsigned char*>(a.q);
      for (int idx = tid; idx < ROWS * (D / 4); idx += kThreads) {
        const int r = idx / (D / 4), c = idx % (D / 4);
        const bool in = row0 + r < a.Rq;
        cp_async16(smem + r * L::QLD + c * 16,
                   in ? qg + ((q_row0 + r) * D + c * 4) * 4 : qg, in);
      }
    }
  } else if constexpr (KIND == fa::kFp8 && L::kF32) {
    // fp32 q: its three bf16 parts, tile p at p * ROWS rows
    const float* qg = static_cast<const float*>(a.q);
    __nv_bfloat16* qt = reinterpret_cast<__nv_bfloat16*>(smem);
    for (int idx = tid; idx < ROWS * D; idx += kThreads) {
      const int r = idx / D, d = idx % D;
      const float x = row0 + r < a.Rq ? qg[(q_row0 + r) * D + d] : 0.0f;
      __nv_bfloat16* t = qt + r * LDE + fa::fp8_q_col(d);
      fa::split_bf16x3(x, t[0], t[ROWS * LDE], t[2 * ROWS * LDE]);
    }
  } else if constexpr (KIND == fa::kFp8) {
    const T* qg = static_cast<const T*>(a.q);
    T* qt = reinterpret_cast<T*>(smem);
    for (int idx = tid; idx < ROWS * D; idx += kThreads) {
      const int r = idx / D, d = idx % D;
      qt[r * LDE + fa::fp8_q_col(d)] = row0 + r < a.Rq
                                           ? qg[(q_row0 + r) * D + d]
                                           : fa::from_float<T>(0.0f);
    }
  } else {
    const T* qg = static_cast<const T*>(a.q);
    int8_t* q8 = reinterpret_cast<int8_t*>(smem);
    float* qs_s = reinterpret_cast<float*>(smem + ROWS * L::QLD);
    for (int r = warp; r < ROWS; r += kWarps) {
      float x[D / 32];
      float amax = 0.0f;
#pragma unroll
      for (int c = 0; c < D / 32; ++c) {
        x[c] = row0 + r < a.Rq
                   ? fa::to_float(qg[(q_row0 + r) * D + lane + 32 * c])
                   : 0.0f;
        amax = fmaxf(amax, fabsf(x[c]));
      }
      const float qsc = fa::p_scale_of(fa::warp_max(amax));
#pragma unroll
      for (int c = 0; c < D / 32; ++c)
        q8[r * L::QLD + lane + 32 * c] = static_cast<int8_t>(rintf(x[c] / qsc));
      if (lane == 0) qs_s[r] = qsc;
    }
  }
  __syncthreads();   // the page ids stored
#pragma unroll
  for (int t = 0; t < L::NS - 1; ++t) {
    if (t < n_st) issue(t);
    cp_async_commit();
  }

  // this thread's two rows (g, g + 8 of the warp's 16)
  const int wrow = kKeySplit ? 0 : 16 * warp;
  int qp[2];
  bool rok[2];
  float slope[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + wrow + lane / 4 + 8 * i;
    qp[i] = qbase + (a.t_new > 1 ? r % a.t_new : 0);
    rok[i] = r < n_rows;
    slope[i] = a.slopes && r < a.Rq ? a.slopes[bh * a.Rq + r] : 0.0f;
  }
  const bool extra = a.mp.has_alibi || a.mp.softcap > 0.0f;
  // fp32 pools keep the natural base: "log2" units are natural ones there
  const float to_log2 = extra ? 1.0f : a.scale * (kWide ? 1.0f : kLog2e);
  constexpr float to_nat = kWide ? 1.0f : kLn2;
  // a key group whose every key every row sees (only the rows past
  // group * t_new masked): the live range holds it and no causal or
  // window edge cuts it, for q positions qbase .. qbase + t_new - 1
  auto whole = [&](int jg) {
    const int lo = jg - lp, hi = jg + G - 1 - lp;
    return jg >= j_lo && jg + G <= j_hi && (!a.mp.causal || hi <= qbase) &&
           (a.mp.window_right < 0 || hi <= qbase + a.mp.window_right) &&
           (a.mp.window_left < 0 ||
            lo >= qbase + a.t_new - 1 - a.mp.window_left);
  };

  float o[D / 8][4];
#pragma unroll
  for (int nb = 0; nb < D / 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nb][e] = 0.0f;
  // fp32 pools at D 32 / 64: Q's A fragments of every k-step, split once
  // (rows past Rq zero)
  constexpr int LDF = D + 4;   // fp32 tiles: floats a row
  f32::FragA qf[L::kQReg ? D / 8 : 1];
  if constexpr (L::kQReg) {
    const float* qg = static_cast<const float*>(a.q);
    auto at = [&](int r, int c) {
      return row0 + r < a.Rq ? qg[(q_row0 + r) * D + c] : 0.0f;
    };
    const int r = wrow + lane / 4;
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      const int c = 8 * kk + lane % 4;
      qf[kk].set(0, at(r, c));
      qf[kk].set(1, at(r + 8, c));
      qf[kk].set(2, at(r, c + 4));
      qf[kk].set(3, at(r + 8, c + 4));
    }
  }
  float m[2] = {-INFINITY, -INFINITY};   // running row max (base 2;
                                         // natural for fp32 pools)
  float l[2] = {0.0f, 0.0f};             // this lane's part of the row sum
  unsigned char* k8 = smem + L::k8_off + warp * L::k8_bytes;

  // one warp step: this warp's 16 rows against the G keys from cache row
  // jg, group q of stage st
  auto group_step = [&](const unsigned char* st, int q, int jg) {
    const unsigned char* kg = st + q * (G / TPR) * KLD;
    const unsigned char* vg = kg + L::v_off;
    if constexpr (KIND == fa::kInt4 && ABL != kAblNoAnd) {
      // K unpacked into this warp's tile, keys in order (kAblQkOne: the
      // first 16 keys only)
      __syncwarp();
      for (int u = lane; u < (ABL == kAblQkOne ? 8 : 16) * (D / 16);
           u += 32) {
        const int row = u / (D / 16), c = u % (D / 16);
        uint4 ev, od;
        fa::unpack_int4x16(
            *reinterpret_cast<const uint4*>(kg + row * KLD +
                                            chunk<SWZ>(row, c) * 16),
            ev, od);
        *reinterpret_cast<uint4*>(k8 + 2 * row * L::K8LD + c * 16) = ev;
        *reinterpret_cast<uint4*>(k8 + (2 * row + 1) * L::K8LD + c * 16) = od;
      }
      __syncwarp();
    }
    const float* ks_s =
        reinterpret_cast<const float*>(st + L::sc_off) + q * G;
    const float* vs_s = ks_s + BK;

    // S = Q K^T: 16 rows x G keys, in fragments
    float sc[NJ][4];
    if constexpr (KIND == kK16) {
      SyncPath<T, D>::template abt<16, G>(sc, smem, wrow, kg, lane);
    } else if constexpr (kWide) {
      // 3 x TF32: Q's fragments from registers or the Q tile, K's split as
      // they are read; even and odd k-steps into two accumulators (two
      // dependent chains of 3 D / 16 products, not one of 3 D / 8: 6% off
      // the 32k decode), added at the end
      float s2[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = s2[j][e] = 0.0f;
      const float* kf = reinterpret_cast<const float*>(kg);
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        f32::FragA qa;
        if constexpr (L::kQReg)
          qa = qf[kk];
        else
          f32::frag_a<LDF>(qa, reinterpret_cast<const float*>(smem), wrow,
                           8 * kk, lane);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          f32::FragB kb;
          f32::frag_b_k<LDF>(kb, kf, 8 * j, 8 * kk, lane);
          f32::mma3(kk % 2 ? s2[j] : sc[j], qa, kb);
        }
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] += s2[j][e];
    } else if constexpr (KIND == fa::kFp8 && L::kF32) {
      // fp32 q: the three bf16 parts against the same K fragments, the
      // smallest part first
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = 0.0f;
      using B16 = __nv_bfloat16;
      const B16* qs = reinterpret_cast<const B16*>(smem) + wrow * LDE;
#pragma unroll
      for (int kk = 0; kk < D / 32; ++kk) {
#pragma unroll
        for (int nb = 0; nb < 2; ++nb) {
          uint32_t bf[4], b[4][2];
          ldsm_x4(bf, b_addr<SWZ>(kg + nb * 16 * KLD, KLD, lane, kk));
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            b[i][0] = e4m3x2_to<B16>(bf[i]);
            b[i][1] = e4m3x2_to<B16>(bf[i] >> 16);
          }
#pragma unroll
          for (int p = L::QP - 1; p >= 0; --p) {
            uint32_t af0[4], af1[4];
            load_a<LDE>(af0, qs + p * ROWS * LDE + kk * 32, lane);
            load_a<LDE>(af1, qs + p * ROWS * LDE + kk * 32 + 16, lane);
            mma16816<B16>(sc[2 * nb], af0, b[0][0], b[0][1]);
            mma16816<B16>(sc[2 * nb + 1], af0, b[2][0], b[2][1]);
            mma16816<B16>(sc[2 * nb], af1, b[1][0], b[1][1]);
            mma16816<B16>(sc[2 * nb + 1], af1, b[3][0], b[3][1]);
          }
        }
      }
    } else if constexpr (KIND == fa::kFp8) {
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = 0.0f;
      const T* qs = reinterpret_cast<const T*>(smem) + wrow * LDE;
#pragma unroll
      for (int kk = 0; kk < D / 32; ++kk) {
        uint32_t af0[4], af1[4];
        load_a<LDE>(af0, qs + kk * 32, lane);
        load_a<LDE>(af1, qs + kk * 32 + 16, lane);
#pragma unroll
        for (int nb = 0; nb < 2; ++nb) {
          uint32_t bf[4];
          ldsm_x4(bf, b_addr<SWZ>(kg + nb * 16 * KLD, KLD, lane, kk));
          mma16816<T>(sc[2 * nb], af0, e4m3x2_to<T>(bf[0]),
                      e4m3x2_to<T>(bf[0] >> 16));
          mma16816<T>(sc[2 * nb + 1], af0, e4m3x2_to<T>(bf[2]),
                      e4m3x2_to<T>(bf[2] >> 16));
          mma16816<T>(sc[2 * nb], af1, e4m3x2_to<T>(bf[1]),
                      e4m3x2_to<T>(bf[1] >> 16));
          mma16816<T>(sc[2 * nb + 1], af1, e4m3x2_to<T>(bf[3]),
                      e4m3x2_to<T>(bf[3] >> 16));
        }
      }
    } else {
      int si[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) si[j][e] = 0;
      // int4's K from this warp's unpacked tile (padded), else the stage
      // (kAblNoAnd: int4's packed stage rows)
      constexpr bool kUnpacked = KIND == fa::kInt4 && ABL != kAblNoAnd;
      constexpr bool KSWZ = SWZ && !kUnpacked;
      constexpr int KTLD = kUnpacked ? L::K8LD : KLD;
      // the ablations but kAblFullQk take one 16-key product, duplicated
      constexpr int NBS = ABL == kAblQkOne || ABL == kAblNoAnd ? 1 : 2;
      const unsigned char* kt = kUnpacked ? k8 : kg;
      const unsigned char* qa =
          smem + (wrow + lane % 16) * L::QLD + (lane / 16) * 16;
#pragma unroll
      for (int kk = 0; kk < D / 32; ++kk) {
        uint32_t af[4];
        ldsm_x4(af, qa + kk * 32);
#pragma unroll
        for (int nb = 0; nb < NBS; ++nb) {
          uint32_t bf[4];
          ldsm_x4(bf, b_addr<KSWZ>(kt + nb * 16 * KTLD, KTLD, lane, kk));
          mma16832_s8(si[2 * nb], af, bf[0], bf[1]);
          mma16832_s8(si[2 * nb + 1], af, bf[2], bf[3]);
        }
      }
      if constexpr (NBS == 1) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          si[2][e] = si[0][e];
          si[3][e] = si[1][e];
        }
      }
      const float* qs_s = reinterpret_cast<const float*>(smem + ROWS * L::QLD);
      const float qsc[2] = {qs_s[wrow + lane / 4], qs_s[wrow + lane / 4 + 8]};
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = i2f(si[j][e]) * qsc[e / 2];
    }

    // scores in log2 units (times the key's k scale for K4q), masked, and
    // the online softmax's running max: without bias on a whole group only
    // the padding rows are masked, with no per-key test
    float mx[2] = {-INFINITY, -INFINITY};
    auto scores = [&](auto plain) {
      constexpr bool PLAIN = decltype(plain)::value;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        float2 kq = make_float2(1.0f, 1.0f);
        if constexpr (kByte)
          kq = *reinterpret_cast<const float2*>(ks_s + 8 * j +
                                                2 * (lane % 4));
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e / 2;
          float x = sc[j][e];
          if constexpr (kByte) x *= e & 1 ? kq.y : kq.x;
          if constexpr (PLAIN) {
            x = rok[i] ? x : -INFINITY;
          } else {
            const int key = jg + 8 * j + 2 * (lane % 4) + (e & 1);
            const int jl = key - lp;
            if (extra)
              x = fa::score_bias(x, qp[i], jl, a.scale, slope[i], a.mp) *
                  (kWide ? 1.0f : kLog2e);
            const bool ok = rok[i] && key >= j_lo && key < j_hi &&
                            fa::position_valid(qp[i], jl, a.mp);
            x = ok ? x : -INFINITY;
          }
          sc[j][e] = x;
          mx[i] = fmaxf(mx[i], x);
        }
      }
    };
    if (!extra && whole(jg))
      scores(std::true_type{});
    else
      scores(std::false_type{});
    float alpha[2], base[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float r = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      r = fmaxf(r, __shfl_xor_sync(0xffffffffu, r, 2));
      const float m_next = fmaxf(m[i], r * to_log2);
      base[i] = m_next == -INFINITY ? 0.0f : m_next;
      alpha[i] = exp_of<kWide>(m[i] - base[i]);
      m[i] = m_next;
    }
    float ls[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      float2 vq = make_float2(1.0f, 1.0f);
      if constexpr (kByte)
        vq = *reinterpret_cast<const float2*>(vs_s + 8 * j + 2 * (lane % 4));
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p =
            kWide ? expf(sc[j][e] * to_log2 - base[e / 2])
                  : ex2(fmaf(sc[j][e], to_log2, -base[e / 2]));
        ls[e / 2] += p;
        // P times the key's v scale (K4q): V's dequantization
        sc[j][e] = kByte ? p * (e & 1 ? vq.y : vq.x) : p;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + ls[i];
    // O's rescale, skipped where no row's max moved (alpha exactly 1)
    if (__any_sync(0xffffffffu, alpha[0] != 1.0f || alpha[1] != 1.0f)) {
#pragma unroll
      for (int nb = 0; nb < D / 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[nb][e] *= alpha[e / 2];
    }

    if constexpr (kWide) {
      // O += P V, 3 x TF32: P's A fragments split from S's accumulators,
      // V's split as they are read; the group's one or two k-steps into a
      // zeroed fragment that O takes in fp32 (the tensor cores' sums
      // truncate)
      static_assert(NJ <= f32::kG, "one flush a group");
      f32::FragA pa[NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j) f32::frag_a_c(pa[j], sc[j]);
      const float* vf = reinterpret_cast<const float*>(vg);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        float t[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          f32::FragB vb;
          f32::frag_b_mn<LDF>(vb, vf, 8 * j, 8 * n, lane);
          f32::mma3(t, pa[j], vb);
        }
        f32::flush(o[n], t);
      }
    } else if constexpr (!kInt) {
      // O += P V, P rounded to the product's 16-bit type (fp8: P times
      // the v scale, to bf16)
      using TP = typename std::conditional<KIND == fa::kFp8, __nv_bfloat16,
                                           T>::type;
      uint32_t pa[G / 16][4];
#pragma unroll
      for (int kk = 0; kk < G / 16; ++kk)
        pack_a<TP>(pa[kk], sc[2 * kk], sc[2 * kk + 1]);
      if constexpr (KIND == kK16) {
        SyncPath<T, D>::template ab<G, D>(o, pa, vg, 0, lane);
      } else {
#pragma unroll
        for (int c = 0; c < D / 16; ++c) {
          uint32_t bE[2][2], bO[2][2];
          v_frags<KIND, KLD, SWZ>(vg, c, lane, bE, bO);
#pragma unroll
          for (int kk = 0; kk < 2; ++kk) {
            mma16816<TP>(o[2 * c], pa[kk], e4m3x2_to<TP>(bE[kk][0]),
                         e4m3x2_to<TP>(bE[kk][0] >> 16));
            mma16816<TP>(o[2 * c + 1], pa[kk], e4m3x2_to<TP>(bO[kk][0]),
                         e4m3x2_to<TP>(bO[kk][0] >> 16));
          }
        }
      }
    } else {
      // P quantized per row over the group into P8's A fragment; O +=
      // p_scale (P8 V8), the int32 sums from kMagic's bits (i2f without
      // the add)
      float am[2] = {0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) am[e / 2] = fmaxf(am[e / 2], sc[j][e]);
      float pscale[2], pinv[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float r = fmaxf(am[i], __shfl_xor_sync(0xffffffffu, am[i], 1));
        r = fmaxf(r, __shfl_xor_sync(0xffffffffu, r, 2));
        pscale[i] = fa::p_scale_of(r);
        pinv[i] = 1.0f / pscale[i];
      }
      uint32_t pa[4];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int j = 2 * hh;
        uint32_t t[2][4];
        bool near = false;
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int u = 0; u < 4; ++u)
            t[i][u] = p8_fast(sc[j + u / 2][2 * i + u % 2], pinv[i], near);
        if (__builtin_expect(near, 0)) {
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int u = 0; u < 4; ++u)
              t[i][u] = __float_as_uint(sc[j + u / 2][2 * i + u % 2] /
                                            pscale[i] + kMagic);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
          pa[2 * hh + i] = pack_s8(t[i][0], t[i][1], t[i][2], t[i][3]);
      }
      // int4's fragments come two dim chunks a load
      constexpr int CW = KIND == fa::kInt4 ? 2 : 1;
#pragma unroll
      for (int c = 0; c < D / 16; c += CW) {
        uint32_t bE[2][2], bO[2][2];
        if constexpr (ABL == 0) {
          v_frags<KIND, KLD, SWZ>(vg, c / CW, lane, bE, bO);
        } else {
          // the ablations: v_frags' ldmatrix, then the low nibbles
          // (kAblNoAnd: the bytes) as the even dims' fragments, no unpack
          const int li = lane % 8, lm = lane / 8;
          const int vr = li / 2 + 4 * (li % 2) + 8 * (lm % 2);
          uint32_t raw[4];
          ldsm_x4_t(raw, vg + vr * KLD +
                             chunk<SWZ>(vr, 2 * (c / CW) + lm / 2) * 16);
#pragma unroll
          for (int hv = 0; hv < 2; ++hv)
#pragma unroll
            for (int kv = 0; kv < 2; ++kv)
              bE[kv][hv] = ABL == kAblNoAnd ? raw[2 * hv + kv]
                                            : raw[2 * hv + kv] & 0x0F0F0F0Fu;
        }
#pragma unroll
        for (int w = 0; w < CW; ++w) {
          int accE[4] = {kMagicBits, kMagicBits, kMagicBits, kMagicBits};
          int accO[4] = {kMagicBits, kMagicBits, kMagicBits, kMagicBits};
          mma16832_s8(accE, pa, bE[0][w], bE[1][w]);
          if constexpr (ABL == 0) {
            mma16832_s8(accO, pa, bO[0][w], bO[1][w]);
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e) accO[e] = accE[e];
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float& oe = o[2 * (c + w)][e];
            float& oo = o[2 * (c + w) + 1][e];
            oe = fmaf(__int_as_float(accE[e]) - kMagic, pscale[e / 2], oe);
            oo = fmaf(__int_as_float(accO[e]) - kMagic, pscale[e / 2], oo);
          }
        }
      }
    }
  };

  // the ring: stage s + NS - 1 copied while stage s is computed
#pragma unroll 1
  for (int s = 0; s < n_st; ++s) {
    cp_async_wait<L::NS - 2>();
    __syncthreads();   // stage s landed for all; stage s - 1's buffer free
    if (s + L::NS - 1 < n_st) issue(s + L::NS - 1);
    cp_async_commit();
    const unsigned char* st = stage(s);
    const int j0 = j_first + s * BK;
#pragma unroll 1
    for (int q = 0; q < NG; ++q) {
      const int jg = j0 + q * G;
      if (kKeySplit && ((jg - split0) / G) % kWarps != warp) continue;
      if (jg >= j_hi || jg + G <= j_lo) continue;
      if constexpr (ABL != kAblCopies) group_step(st, q, jg);
    }
  }
  cp_async_wait<0>();

  // a thread's O columns: 16-bit pools, n-block nb's 2 t, 2 t + 1; K4q,
  // dims 16 c + 4 t .. + 3 from the n-block pair (2 c, 2 c + 1)
  // (v_frags); `emit(c, d0, x0, x1, d1, y0, y1)` takes row i's two column
  // pairs of chunk c
  auto columns = [&](int i, auto emit) {
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      const float* e0 = o[2 * c];
      const float* e1 = o[2 * c + 1];
      if constexpr (kByte)
        emit(16 * c + 4 * (lane % 4), e0[2 * i], e1[2 * i],
             16 * c + 4 * (lane % 4) + 2, e0[2 * i + 1], e1[2 * i + 1]);
      else
        emit(16 * c + 2 * (lane % 4), e0[2 * i], e0[2 * i + 1],
             16 * c + 8 + 2 * (lane % 4), e1[2 * i], e1[2 * i + 1]);
    }
  };

  // the rows' sums over the quad; outputs: merged (one split) or partials
  const bool direct = a.o != nullptr && a.S == 1;
  auto put = [&](int r, int d, float x0, float x1) {
    if (direct) {
      if constexpr (L::kF32)
        *reinterpret_cast<float2*>(static_cast<float*>(a.o) +
                                   (bh * a.Rq + r) * D + d) =
            make_float2(x0, x1);
      else
        *reinterpret_cast<uint32_t*>(static_cast<T*>(a.o) +
                                     (bh * a.Rq + r) * D + d) =
            pack2<T>(x0, x1);
    } else {
      *reinterpret_cast<float2*>(
          a.o_part + ((bh * a.S + split) * a.Rq + r) * D + d) =
          make_float2(x0, x1);
    }
  };
  auto put_lse = [&](int r, float x) {
    if (direct)
      a.lse[bh * a.Rq + r] = x;
    else
      a.lse_part[(bh * a.S + split) * a.Rq + r] = x;
  };
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  if constexpr (kKeySplit) {
    // the warps' (m, l, O) combined in shared memory, in warp order
    constexpr int OLD = L::OLD;
    float* co = reinterpret_cast<float*>(smem + L::stage_off);
    float* cm = co + kWarps * 16 * OLD;
    float* cl = cm + kWarps * 16;
    __syncthreads();   // every warp is done with the stages
    if (lane % 4 == 0)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        cm[warp * 16 + lane / 4 + 8 * i] = m[i];
        cl[warp * 16 + lane / 4 + 8 * i] = l[i];
      }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = lane / 4 + 8 * i;
      float mm = cm[row];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) mm = fmaxf(mm, cm[w * 16 + row]);
      const float f = mm == -INFINITY ? 0.0f : exp_of<kWide>(m[i] - mm);
      float* dst = co + (warp * 16 + row) * OLD;
      columns(i, [&](int d0, float x0, float x1, int d1, float y0, float y1) {
        *reinterpret_cast<float2*>(dst + d0) = make_float2(x0 * f, x1 * f);
        *reinterpret_cast<float2*>(dst + d1) = make_float2(y0 * f, y1 * f);
      });
    }
    __syncthreads();
    for (int idx = tid; idx < 16 * (D / 2); idx += kThreads) {
      const int row = idx / (D / 2), d = 2 * (idx % (D / 2));
      const int r = row0 + row;
      if (r >= a.Rq) continue;
      float mm = cm[row];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) mm = fmaxf(mm, cm[w * 16 + row]);
      float ll = 0.0f, x0 = 0.0f, x1 = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        ll += mm == -INFINITY ? 0.0f
                              : cl[w * 16 + row] *
                                    exp_of<kWide>(cm[w * 16 + row] - mm);
        const float2 v2 =
            *reinterpret_cast<const float2*>(co + (w * 16 + row) * OLD + d);
        x0 += v2.x;
        x1 += v2.y;
      }
      const float inv = ll == 0.0f ? 0.0f : 1.0f / ll;
      put(r, d, x0 * inv, x1 * inv);
      if (d == 0) put_lse(r, ll == 0.0f ? -INFINITY : mm * to_nat + logf(ll));
    }
  } else {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = row0 + wrow + lane / 4 + 8 * i;
      if (r >= a.Rq) continue;
      const float inv = l[i] == 0.0f ? 0.0f : 1.0f / l[i];
      columns(i, [&](int d0, float x0, float x1, int d1, float y0, float y1) {
        put(r, d0, x0 * inv, x1 * inv);
        put(r, d1, y0 * inv, y1 * inv);
      });
      if (lane % 4 == 0)
        put_lse(r, l[i] == 0.0f ? -INFINITY : m[i] * to_nat + logf(l[i]));
    }
  }
  if (a.o == nullptr || direct) return;

  // the split merge: the last of the S blocks of (b, kv head, row tile) to
  // arrive combines their partials in split order, writes O and the LSE,
  // and resets the counter
  int* counter = a.counters + bh * n_rt + blockIdx.x % n_rt;
  __threadfence();
  __syncthreads();
  if (tid == 0) last_block = atomicAdd(counter, 1) == a.S - 1;
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  if constexpr (D == 256) {
    if (a.S >= kBulkMergeSplits) {
      merge_bulk<L, T, D, ROWS>(a, smem, bh, row0);
      if (tid == 0) *counter = 0;
      return;
    }
  }
  const long long base_row = bh * a.S * a.Rq;
  const int nr = min(ROWS, a.Rq - row0);
  auto lse_of = [&](int s, int r) {
    return __ldcg(a.lse_part + base_row + static_cast<long long>(s) * a.Rq +
                  r);
  };
  // each row's max LSE and weight sum, then every (row, 4 columns) apart
  float* mw = reinterpret_cast<float*>(smem + L::stage_off);
  for (int i = tid; i < nr; i += kThreads) {
    float mx = -INFINITY, sw = 0.0f;
    for (int s = 0; s < a.S; ++s) mx = fmaxf(mx, lse_of(s, row0 + i));
    if (mx != -INFINITY)
      for (int s = 0; s < a.S; ++s) sw += expf(lse_of(s, row0 + i) - mx);
    mw[2 * i] = mx;
    mw[2 * i + 1] = sw;
  }
  __syncthreads();
  for (int idx = tid; idx < nr * (D / 4); idx += kThreads) {
    const int i = idx / (D / 4), d = 4 * (idx % (D / 4)), r = row0 + i;
    const float mx = mw[2 * i], sw = mw[2 * i + 1];
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (mx != -INFINITY) {
      for (int s = 0; s < a.S; ++s) {
        const float w = expf(lse_of(s, r) - mx);
        const float4 v4 = __ldcg(reinterpret_cast<const float4*>(
            a.o_part + (base_row + static_cast<long long>(s) * a.Rq + r) * D +
            d));
        acc.x += w * v4.x;
        acc.y += w * v4.y;
        acc.z += w * v4.z;
        acc.w += w * v4.w;
      }
      const float inv = 1.0f / sw;
      acc = make_float4(acc.x * inv, acc.y * inv, acc.z * inv, acc.w * inv);
    }
    if constexpr (L::kF32)
      *reinterpret_cast<float4*>(static_cast<float*>(a.o) +
                                 (bh * a.Rq + r) * D + d) = acc;
    else
      *reinterpret_cast<uint2*>(static_cast<T*>(a.o) + (bh * a.Rq + r) * D +
                                d) =
          make_uint2(pack2<T>(acc.x, acc.y), pack2<T>(acc.z, acc.w));
    if (d == 0) a.lse[bh * a.Rq + r] = mx == -INFINITY ? -INFINITY
                                                       : mx + logf(sw);
  }
  if (tid == 0) *counter = 0;
}

// the variant of (T, D, KIND, ROWS, ABL): its entry and shared memory
// (without the table's bytes), its limit raised on first use to `smem`
template <typename T, int D, int KIND, int ROWS, int ABL = 0>
cudaError_t variant(const void** fn, size_t* smem, size_t tbl) {
  using L = Smem<T, D, KIND, ROWS>;
  *fn = reinterpret_cast<const void*>(decode_kernel<T, D, KIND, ROWS, ABL>);
  *smem = L::bytes(tbl);
  static size_t configured = 0;
  if (*smem > configured) {
    cudaError_t e = cudaFuncSetAttribute(
        decode_kernel<T, D, KIND, ROWS, ABL>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(*smem));
    if (e != cudaSuccess) return e;
    configured = *smem;
  }
  return cudaSuccess;
}

template <typename T, int KIND>
cudaError_t find(int D, int rows, const void** fn, size_t* smem, size_t tbl) {
  const bool a16 = rows <= 16;
  switch (D) {
    case 32: return a16 ? variant<T, 32, KIND, 16>(fn, smem, tbl)
                        : variant<T, 32, KIND, 64>(fn, smem, tbl);
    case 64: return a16 ? variant<T, 64, KIND, 16>(fn, smem, tbl)
                        : variant<T, 64, KIND, 64>(fn, smem, tbl);
    case 128: return a16 ? variant<T, 128, KIND, 16>(fn, smem, tbl)
                         : variant<T, 128, KIND, 64>(fn, smem, tbl);
    case 256: return a16 ? variant<T, 256, KIND, 16>(fn, smem, tbl)
                         : variant<T, 256, KIND, 64>(fn, smem, tbl);
    default: return cudaErrorInvalidValue;
  }
}

// q rows a block: 16 (the warps split the keys) up to Rq 16, else 64
inline int rows_of(int Rq) { return Rq <= 16 ? 16 : 64; }

// a kernel of the body on the grid of a's splits and row tiles
inline cudaError_t launch_fn(const void* fn, size_t smem, int rows,
                             const DecodeArgs& a, cudaStream_t stream) {
  if (smem > 232448) return cudaErrorInvalidValue;
  dim3 grid(a.S * ((a.Rq + rows - 1) / rows), a.Hk, a.B);
  void* args[] = {const_cast<DecodeArgs*>(&a)};
  cudaError_t e = cudaLaunchKernel(fn, grid, dim3(kThreads), args, smem,
                                   stream);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <typename T, int KIND>
cudaError_t launch(const DecodeArgs& a, int D, cudaStream_t stream) {
  const int rows = rows_of(a.Rq);
  const void* fn;
  size_t smem;
  cudaError_t e =
      find<T, KIND>(D, rows, &fn, &smem, align16(4 * a.pages_per_split));
  if (e != cudaSuccess) return e;
  return launch_fn(fn, smem, rows, a, stream);
}

// out[0] resident blocks a multiprocessor, out[1] dynamic shared memory a
// block (bytes, without the table), out[2] threads a block, out[3]
// registers a thread, out[4] local memory a thread (bytes)
template <typename T, int KIND>
cudaError_t occupancy(int D, int rows, int* out) {
  const void* fn;
  size_t smem;
  cudaFuncAttributes attr;
  cudaError_t e = find<T, KIND>(D, rows, &fn, &smem, 0);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, fn);
  if (e != cudaSuccess) return e;
  out[1] = static_cast<int>(smem);
  out[2] = kThreads;
  out[3] = attr.numRegs;
  out[4] = static_cast<int>(attr.localSizeBytes);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, fn, kThreads,
                                                       smem);
}

// the arguments every entry shares
inline void set_common(DecodeArgs& a, const void* q, const void* k,
                       const void* v, const int* table, const int* lens,
                       const int* leftpad, const int* qpos,
                       const float* slopes, float* o_part, float* lse_part,
                       void* o, float* lse, int* counters, int c2, int B,
                       int Hk, int Rq, int S, int max_pages, int page_size,
                       int pages_per_split, int t_new, int group, float scale,
                       int causal, int window_left, int window_right,
                       float softcap, int has_alibi) {
  a.q = q;
  a.k = static_cast<const unsigned char*>(k);
  a.v = static_cast<const unsigned char*>(v);
  a.table = table; a.lens = lens; a.leftpad = leftpad; a.qpos = qpos;
  a.slopes = has_alibi ? slopes : nullptr;
  a.o_part = o_part; a.lse_part = lse_part;
  a.o = o; a.lse = lse; a.counters = counters;
  a.c2 = c2; a.B = B; a.Hk = Hk; a.Rq = Rq; a.S = S;
  a.max_pages = max_pages; a.page_size = page_size;
  a.pages_per_split = pages_per_split; a.t_new = t_new; a.group = group;
  a.scale = scale;
  a.mp.causal = causal; a.mp.window_left = window_left;
  a.mp.window_right = window_right; a.mp.softcap = softcap;
  a.mp.has_alibi = has_alibi;
}

// K4q (csrc/decode_quant.cu) for q of type T, each payload kind.  Each q
// type is instantiated in a translation unit of its own
// (decode_quant.cu bf16, decode_quant_f16.cu, decode_quant_f32.cu), so
// the library's kernels compile in parallel.
template <typename T>
cudaError_t launch_quant(int kind, const DecodeArgs& a, int D,
                         cudaStream_t st) {
  switch (kind) {
    case fa::kInt8: return launch<T, fa::kInt8>(a, D, st);
    case fa::kFp8: return launch<T, fa::kFp8>(a, D, st);
    case fa::kInt4: return launch<T, fa::kInt4>(a, D, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t occupancy_quant(int kind, int D, int rows, int* out) {
  switch (kind) {
    case fa::kInt8: return occupancy<T, fa::kInt8>(D, rows, out);
    case fa::kFp8: return occupancy<T, fa::kFp8>(D, rows, out);
    case fa::kInt4: return occupancy<T, fa::kInt4>(D, rows, out);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace dec
}  // namespace fa
