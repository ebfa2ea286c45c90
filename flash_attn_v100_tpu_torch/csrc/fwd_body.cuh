// The attention forward body for Hopper (sm_90a), instantiated three times:
// K1 dense and K5 packed varlen (csrc/fwd.cu), K8 paged over 16-bit pools
// (csrc/varlen_paged.cu), and once more for K8q over an fp8 pool
// (csrc/varlen_paged_quant.cu).  The kernels' contracts are stated in those
// files; this one holds what they share.
//
// What bounds it on this card: operations.  A causal 2048-token sequence
// does 4 * D flops per live (q row, key) pair against each K/V byte read
// once per q tile, far above the ~295 flop/byte ridge, so the floor is the
// flops over the 989 TFLOP/s of the bf16 tensor cores.  Beside the products
// each pair costs an exp2 and a few fp32 operations, which at D 64 take
// about as long as its 256 tensor-core flops; at D 32 the pair's one exp2
// (16 a clock an SM on the MUFU) takes about twice its 128 flops, so the
// exponentials bound it.
//
// What the design does about it (K2's shape in csrc/bwd.cu; products and
// live-key intervals in csrc/attn_tiles.cuh):
//   * Work.  One block per (q tile, q head, batch row or sequence), each
//     64 q rows of the tile owned by one warpgroup of 4 warps (16 rows a
//     warp); two warpgroups share each K/V tile (128 q rows).
//     A varlen or paged block reads its sequence's bounds from device
//     memory (csrc/seq.cuh) and leaves at once if its tile lies past the
//     sequence; the key loop covers only the tiles its rows'
//     causal/window intervals touch (the reference CUDA BlockInfo trim).
//     Both warpgroups run every tile of the block (one that none of a
//     warpgroup's rows sees gives P = 0), so no product sits in a branch:
//     ptxas serializes every wgmma of a kernel that leaves one in flight
//     across a branch.
//   * Products.  S = Q K^T is a wgmma from 128-byte-swizzled Q and K
//     tiles, both K-major (four swizzle atoms a row at D 256; at D 32 a
//     row is one 64-byte atom, two k16 steps 32 bytes apart), and O += P V
//     a wgmma with P from registers and V read MN-major through the
//     transpose bit (one m64n256k16 a k-step at D 256, m64n32k16 at 32).
//   * D 256.  O alone is 128 fp32 registers a thread; with S and P of a
//     64-key step the 16-bit kernels stay under 255 registers with no
//     local memory.  fp8 (K8q) holds its next K and V tiles in registers
//     through the softmax, so it steps 32 keys.  Q (two 32 KB tiles) and
//     two stages of K + V fill ~195 KB: one block an SM.
//   * Registers.  S stays in the accumulator fragments and O in registers
//     for the block's whole life.  The online softmax runs on the
//     fragments in base 2 (scale * log2(e) folded into the exponent's
//     multiply-add): a row's max takes the two shuffles within the quad of
//     lanes that holds it, its sum is kept per lane and reduced once at the
//     end, O is rescaled in place, and P, rounded to the input type, is the
//     A operand of P V (the accumulator layout is the A layout): nothing
//     goes back to shared memory.
//   * In flight.  Step s issues S(s) and then P(s - 1) V(s - 1), and runs
//     the softmax of S(s) while the second product is on the tensor cores.
//     K, V and the dropout column words stream through a two-stage cp.async
//     ring, K(s + 1) and V(s) copied during step s; one block barrier a
//     step.  Q is loaded once; the epilogue writes O * (1 / l) into Q's
//     tile and stores it as 16-byte rows.
//   * Masks.  Only tiles that straddle a row's causal/window edge or the
//     ragged end of M or N run the per-element mask test.  ALiBi, softcap
//     and dropout are compiled only into the kernel variant for the calls
//     that use them.
//   * Order.  The linear block index maps to q tiles from the last, the
//     heaviest under causal masking; the map is a permutation, so every
//     tile runs once under any mask.
//   * Pages (K8, K8q fp8).  Key tiles start at multiples of BK in the
//     sequence's cache rows, not at leftpad-relative ones, so that a tile
//     never straddles a page (the wrappers take page sizes that are
//     multiples of 128); a tile's first leftpad-relative key is then
//     tile * BK - leftpad, and keys before the leftpad read as masked and
//     load as zero.  The block reads the page numbers its key range
//     touches into shared memory once, so no block-table load stands
//     before a tile's copy; a tile's rows are one base pointer plus
//     constant steps of the pool's row stride.
//   * fp8 (K8q).  K and V are e4m3 bytes with an fp32 scale a token: a
//     tile goes through registers (loaded during one step, converted
//     exactly to 16 bits and stored at the end of it) in place of a bare
//     cp.async, K into q's type and V into bf16, and the tile's k and v
//     scales ride with K in the stage.  S is multiplied by its key's
//     k-scale, and P by its key's v-scale before it is rounded to bf16 for
//     P V (after the row sum has taken it).
//   * Tiles (shared memory a block, 16-bit inputs, with 1 KB of alignment
//     slack; paged blocks add 4 bytes a page of the table):
//         D     q rows x keys a step
//         32    128 x 64  wgmma    (27 KB; 64-byte swizzle)
//         64    128 x 64  wgmma    (51 KB)
//         128   128 x 64  wgmma    (99 KB)
//         256   128 x 64  wgmma    (195 KB; fp8 128 x 32, 131 KB)
//   * Variants (FwdTune; the shipped kernels take its defaults).  The
//     sweep library (FA_SWEEP in csrc/fwd.cu and csrc/varlen_paged.cu,
//     ops/cuda/build.py VARIANTS) instantiates others at bf16, D 128 for
//     the tile and unroll sweeps (benchmarks/prof_*): other tiles, U
//     sub-tiles of keys a step under one online softmax, every tile
//     unmasked (wrong numbers, timing only) and the FA3 ping-pong of the
//     two warpgroups.
#pragma once

#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "attn_tiles.cuh"
#include "masks.cuh"
#include "philox.cuh"
#include "seq.cuh"

namespace {

using namespace fa::attn;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// where the body's K and V come from
constexpr int kDense = 0;    // K1: (B, N, Hk, D)
constexpr int kVarlen = 1;   // K5: packed (Tk, Hk, D)
constexpr int kPaged = 2;    // K8, K8q: pools (Hk, P, ps, D) through a table
// what K and V hold
constexpr int kKv16 = 0;     // q's 16-bit type
constexpr int kKvFp8 = 1;    // e4m3 bytes, an fp32 scale a token

// 2^x, flushing results below 2^-126 to zero (one MUFU operation)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// the pages of a paged call (K8, K8q): pools and scale pools (Hk, P, ps, .)
// with element (payload) and float (scale) strides, the block table (B,
// table_stride), mp pages a sequence at most
struct PagedArgs {
  const int* table;
  const int* seqlens_k;   // (B,)
  const float* ks;        // K8q: (Hk, P, ps, 1)
  const float* vs;
  long long s_h, s_p, s_tok;
  long long sc_h, sc_p, sc_tok;
  int table_stride, page_size, mp;
};

struct FwdArgs {
  const void* q;          // dense (B, M, Hq, D); varlen, paged (Tq, Hq, D)
  const void* k;          // dense (B, N, Hk, D); varlen (Tk, Hk, D); paged
  const void* v;          //   pool (Hk, P, ps, D)
  const float* slopes;    // (B, Hq) or nullptr
  void* out;              // q's shape
  float* lse;             // dense (B, Hq, M); varlen, paged (Hq, Tq)
  fa::SeqArgs seq;
  int B, Hq, Hk, group;
  float scale;
  fa::MaskParams mp_;
  fa::DropoutParams dp;
  PagedArgs pg;
  int d_in;               // K1, K5 at D 32: the rows' columns in memory (8,
                          //   16, 24 or 32)
};

// The tile and schedule of a forward kernel; 0 is the body's own choice
// for D.  The shipped kernels take the defaults.
//   KT    keys a sub-tile, the N of one S product (64; 32 for fp8 at D
//         256)
//   U     sub-tiles a step: U S products of KT keys, one online softmax
//         over the U * KT keys, U P V products
//   G     warpgroups a block, 64 q rows each (2)
//   FAST  every tile takes the unmasked pass: wrong numbers wherever a
//         tile straddles a mask edge (timing only)
//   PP    ping-pong: the two warpgroups take turns to issue their products
//         through two named barriers, so one's softmax runs while the
//         other's products are on the tensor cores (FA3)
template <int KT = 0, int U = 1, int G = 0, bool FAST = false,
          bool PP = false>
struct FwdTune {
  static constexpr int kKT = KT, kU = U, kG = G;
  static constexpr bool kFast = FAST, kPingPong = PP;
};

template <typename T, int D, int KV = kKv16, class TN = FwdTune<>>
struct FwdSmem {
  using P = PathOf<T, D>;
  static constexpr int kGroups = TN::kG ? TN::kG : 2;       // warpgroups
  static constexpr int kThreads = 128 * kGroups;
  static constexpr int BQ = 64 * kGroups;                  // q rows a block
  static constexpr int KT =
      TN::kKT ? TN::kKT : (D == 256 && KV == kKvFp8 ? 32 : 64);
  static constexpr int U = TN::kU;                         // sub-tiles a step
  static constexpr int BK = U * KT;                        // keys a step
  // a warpgroup's 64-row Q tile (then its O stage)
  static constexpr size_t q_tile = P::template tile_bytes<64>();
  static constexpr size_t stage_off = align1k(kGroups * q_tile);
  // a stage: the K and V tiles (U sub-tiles of KT rows each), then the
  // dropout column words (K1, K5) or the tile's k and v scales (fp8)
  static constexpr size_t k_off = 0;
  static constexpr size_t kt_bytes = P::template tile_bytes<KT>();
  static constexpr size_t v_off = U * kt_bytes;
  static constexpr size_t cw_off = 2 * v_off;
  static constexpr size_t stage_bytes =
      align1k(cw_off + sizeof(uint32_t) * BK * (KV == kKvFp8 ? 2 : 1));
  // paged: the block's page numbers, after the stages
  static constexpr size_t tbl_off = stage_off + 2 * stage_bytes;
  static constexpr size_t bytes = stage_off + 2 * stage_bytes + 1024;
};

// ROWS rows of D elements from g (the tile's row 0), `stride` elements
// apart, into a tile in P's layout, NT threads, 16 bytes a copy; tile rows
// outside [lo, hi] are zero, and (NARROW) so are the chunks from `chunks`
// on.  Thread t copies the chunks (r_t + kRowStep i, c8_t), so its
// addresses are one base plus constant steps.
template <typename T, int D, int ROWS, int NT, class P, bool NARROW = false>
__device__ __forceinline__ void load_strided_async(unsigned char* dst,
                                                   const T* g,
                                                   long long stride,
                                                   int lo, int hi,
                                                   int chunks = D / 8) {
  constexpr int kChunks = D / 8, kRowStep = NT / kChunks;
  static_assert(NT % kChunks == 0 && ROWS % kRowStep == 0, "copy split");
  // a swizzled tile's chunk offset is linear in the row over whole 8-row
  // groups (a padded one's over any rows)
  static_assert(kRowStep % 8 == 0 || !std::is_same<P, WgPath<T, D>>::value,
                "row step");
  const int r_t = threadIdx.x / kChunks;
  const int c8_t = threadIdx.x % kChunks;
  const bool col_in = !NARROW || c8_t < chunks;
  const long long step = kRowStep * stride;
  const T* gt = g + r_t * stride + c8_t * 8;
  unsigned char* d = dst + P::template chunk<ROWS>(r_t, c8_t);
#pragma unroll
  for (int i = 0; i < ROWS / kRowStep; ++i) {
    const int r = r_t + i * kRowStep;
    const bool in = col_in && r >= lo && r <= hi;
    cp_async16(d + P::template chunk<ROWS>(i * kRowStep, 0),
               in ? gt + i * step : g, in);
  }
}

// the same for ROWS rows of a (rows, H, DR) tensor from row row0, head h:
// DR = D, or (NARROW) fewer columns, the tile's others zero
template <typename T, int D, int ROWS, int NT, class P, bool NARROW = false>
__device__ __forceinline__ void load_rows_async(unsigned char* dst,
                                                const void* src,
                                                long long row0, int H, int h,
                                                int lo, int hi, int DR = D) {
  load_strided_async<T, D, ROWS, NT, P, NARROW>(
      dst, static_cast<const T*>(src) + (row0 * H + h) * DR,
      static_cast<long long>(H) * DR, lo, hi, DR / 8);
}

// two e4m3 values (low byte first) -> two TT values, exactly (every e4m3
// value is a bf16 and an fp16 value), lo in the low half
template <typename TT>
__device__ __forceinline__ uint32_t e4m3x2_to(uint32_t two) {
  const __half2_raw hr = __nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(two & 0xFFFFu), __NV_E4M3);
  if constexpr (std::is_same<TT, __half>::value) {
    return static_cast<uint32_t>(hr.x) | static_cast<uint32_t>(hr.y) << 16;
  } else {
    const float2 f = __half22float2(__half2(hr));
    return pack2<TT>(f.x, f.y);
  }
}

// fp8 (K8q): a tile of ROWS e4m3 rows of D bytes through registers, 16
// bytes a load: load() during one step, store() converted into a 16-bit
// tile in P's layout at the end of it.  Rows outside [lo, hi] are zero.
// The first kUsed threads copy (at D 32 a tile has fewer 16-byte chunks
// than the block has threads).
template <int D, int ROWS, int NT>
struct Fp8Rows {
  static constexpr int kChunks = D / 16;
  static constexpr int kUsed = ROWS * kChunks < NT ? ROWS * kChunks : NT;
  static constexpr int kRowStep = kUsed / kChunks;
  static constexpr int kN = ROWS / kRowStep;
  static_assert(kUsed % kChunks == 0 && ROWS % kRowStep == 0, "copy split");
  uint4 r[kN];

  __device__ void load(const uint8_t* g, long long stride, int lo, int hi) {
    if constexpr (kUsed < NT) {
      if (threadIdx.x >= kUsed) return;
    }
    const int r_t = threadIdx.x / kChunks;
    const uint8_t* gt = g + r_t * stride + (threadIdx.x % kChunks) * 16;
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      const int row = r_t + i * kRowStep;
      r[i] = make_uint4(0u, 0u, 0u, 0u);
      if (row >= lo && row <= hi)
        r[i] = __ldg(reinterpret_cast<const uint4*>(gt + i * kRowStep *
                                                    stride));
    }
  }

  template <typename TT, class P>
  __device__ void store(unsigned char* dst) const {
    if constexpr (kUsed < NT) {
      if (threadIdx.x >= kUsed) return;
    }
    const int r_t = threadIdx.x / kChunks;
    const int c8 = 2 * (threadIdx.x % kChunks);
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      const int row = r_t + i * kRowStep;
      const uint32_t w[4] = {r[i].x, r[i].y, r[i].z, r[i].w};
      uint32_t o[8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        o[2 * j] = e4m3x2_to<TT>(w[j]);
        o[2 * j + 1] = e4m3x2_to<TT>(w[j] >> 16);
      }
      *reinterpret_cast<uint4*>(dst + P::template chunk<ROWS>(row, c8)) =
          make_uint4(o[0], o[1], o[2], o[3]);
      *reinterpret_cast<uint4*>(dst + P::template chunk<ROWS>(row, c8 + 1)) =
          make_uint4(o[4], o[5], o[6], o[7]);
    }
  }
};

// named barrier `id` (1-15; 0 is __syncthreads'), `n` threads in all (the
// ping-pong's turns, as csrc/tma_pipe.cuh's)
__device__ __forceinline__ void named_bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void named_bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

// sub-tile u of a step's fragments (KT keys: N n-blocks of S, or N
// k-steps of P)
template <int N, int M, typename E>
__device__ __forceinline__ E (&part(E (&a)[M][4], int u))[N][4] {
  return *reinterpret_cast<E(*)[N][4]>(&a[u * N][0]);
}

template <typename T, int D, int MODE, bool EXTRA, int KV = kKv16,
          class TN = FwdTune<>>
__global__ void __launch_bounds__(FwdSmem<T, D, KV, TN>::kThreads)
    fwd_kernel(FwdArgs a) {
  using L = FwdSmem<T, D, KV, TN>;
  using P = typename L::P;
  constexpr bool kFp8 = KV == kKvFp8;
  static_assert(!kFp8 || MODE == kPaged, "fp8 pools are paged");
  constexpr int KT = L::KT, U = L::U;
  static_assert(U == 1 || !kFp8, "fp8 tiles are one sub-tile a step");
  static_assert(!TN::kPingPong || L::kGroups == 2,
                "the ping-pong takes two warpgroups");
  // K1 and K5 at D 32 read and write rows of a.d_in columns (D 16 without
  // the wrapper's pad copies): the tiles' other columns are zero
  constexpr bool kNarrow = D == 32 && MODE != kPaged;
  const int DR = kNarrow ? a.d_in : D;
  // P V's type: q's, or bf16 for fp8 (its P is rounded to bf16)
  using TV = typename std::conditional<kFp8, __nv_bfloat16, T>::type;
  using PV = PathOf<TV, D>;
  constexpr int BQ = L::BQ, BK = L::BK, NT = L::kThreads;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = smem_base(smem_raw);

  // heaviest first: q tiles from the last (under causal masking a later q
  // tile sees more keys), each over all heads and batch rows / sequences
  const int n_tiles = (a.seq.M + BQ - 1) / BQ;
  const int hb = blockIdx.x % (a.Hq * a.B);
  const int h = hb % a.Hq;
  const int b = hb / a.Hq;
  const int qp0 =
      (n_tiles - 1 - static_cast<int>(blockIdx.x) / (a.Hq * a.B)) * BQ;
  fa::Seq sq;
  if constexpr (MODE == kPaged)
    sq = fa::paged_seq_info(a.seq, a.pg.seqlens_k,
                            a.pg.mp * a.pg.page_size, b);
  else
    sq = fa::seq_info<MODE == kVarlen>(a.seq, b, a.Hq);
  if (qp0 >= sq.slq) return;  // uniform over the block
  const int nq = min(BQ, sq.slq - qp0);
  const int kvh = h / a.group;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wg = warp / 4;                 // this thread's warpgroup
  const int g0 = qp0 + 64 * wg;            // its first q row
  const int nq_g = min(64, sq.slq - g0);   // its rows in the sequence
  const int wrow = (warp % 4) * 16;        // this warp's rows in the tile
  const Live lv = {sq.slk, sq.offs, a.mp_.window_left,
                   a.mp_.effective_window_right()};
  const bool drop = EXTRA && MODE != kPaged && a.dp.enabled;
  const float slope = EXTRA && a.slopes ? a.slopes[b * a.Hq + h] : 0.0f;
  const uint32_t bh = fa::dropout_bh(b, h, a.dp);
  // exponents in base 2: the plain variant keeps raw q.k in S and folds
  // scale * log2(e) into the exponent's multiply-add (a scale > 0; the
  // launch sends any other to the EXTRA variant), which keeps the biased
  // score (scale, ALiBi, softcap) times log2(e) in S
  const float to_log2 = EXTRA ? 1.0f : a.scale * kLog2e;
  unsigned char* q_s = smem + wg * L::q_tile;

  // this thread's rows r0 + 8 i of the warpgroup's tile
  const int r0 = wrow + lane / 4;
  int qp[2];
  uint32_t rw[2] = {0u, 0u};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    qp[i] = g0 + r0 + 8 * i;
    if (drop) rw[i] = fa::dropout_row_word(qp[i] + a.dp.q0, bh, a.dp);
  }
  // live keys of the block's rows
  const int blk_lo = lv.key_lo(qp0);
  const int blk_hi = lv.key_hi(qp0 + nq - 1);
  // key tiles from key position 0, or paged from cache row 0 (the leftpad
  // lp before key position 0): tile t's first key is (kt0 + t) * BK - lp
  const int lp = MODE == kPaged ? static_cast<int>(sq.k_base) : 0;
  const int kt0 = (blk_lo + lp) / BK;
  const int n_steps = blk_hi >= blk_lo ? (blk_hi + lp) / BK - kt0 + 1 : 0;
  auto key0 = [&](int t) { return (kt0 + t) * BK - lp; };

  float o[D / 8][4] = {};
  float m[2] = {-INFINITY, -INFINITY};   // running row max (base 2)
  float l[2] = {0.0f, 0.0f};             // this lane's part of the row sum

  // paged: the pages of cache rows [kt0 * BK, (kt0 + n_steps) * BK), from
  // the table slot slot0 on
  const int* tbl_s = reinterpret_cast<const int*>(smem + L::tbl_off);
  const int ps = a.pg.page_size;
  const int slot0 = MODE == kPaged ? kt0 * BK / ps : 0;
  // fp8: the K and V tiles in flight through registers
  Fp8Rows<D, BK, NT> k8r, v8r;

  // stage t & 1 holds K(t) and the dropout column words (fp8: the k and v
  // scales) of tile t, copied at step t - 1, and V(t), copied at step t:
  // at step s the products are S(s) = Q K(s)^T and O += P(s - 1) V(s - 1)
  auto stage = [&](int t) {
    return smem + L::stage_off + (t & 1) * L::stage_bytes;
  };
  // paged: offset of tile t's first row in a pool with strides (s_p, s_h,
  // s_tok), its page read from the block's table
  auto page_row = [&](int t, long long s_p, long long s_h, long long s_tok) {
    const int raw = (kt0 + t) * BK;
    return tbl_s[raw / ps - slot0] * s_p + kvh * s_h +
           static_cast<long long>(raw % ps) * s_tok;
  };
  // tile t of K or V into its stage, sub-tile by sub-tile; keys outside
  // [blk_lo, blk_hi] are zero
  auto copy_kv = [&](int t, const void* src, size_t off, auto& regs) {
    const int k0 = key0(t);
    if constexpr (kFp8) {
      regs.load(static_cast<const uint8_t*>(src) +
                    page_row(t, a.pg.s_p, a.pg.s_h, a.pg.s_tok),
                a.pg.s_tok, blk_lo - k0, blk_hi - k0);
    } else {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int k0u = k0 + u * KT;
        unsigned char* dst = stage(t) + off + u * L::kt_bytes;
        if constexpr (MODE == kPaged)
          load_strided_async<T, D, KT, NT, P>(
              dst,
              static_cast<const T*>(src) +
                  page_row(t, a.pg.s_p, a.pg.s_h, a.pg.s_tok) +
                  u * KT * a.pg.s_tok,
              a.pg.s_tok, blk_lo - k0u, blk_hi - k0u);
        else
          load_rows_async<T, D, KT, NT, P, kNarrow>(
              dst, src, sq.k_base + k0u, a.Hk, kvh, blk_lo - k0u,
              blk_hi - k0u, DR);
      }
    }
  };
  auto copy_k = [&](int t) {
    copy_kv(t, a.k, L::k_off, k8r);
    if constexpr (kFp8) {
      // the tile's k scales, then its v scales
      if (threadIdx.x < 2 * BK) {
        const int c = threadIdx.x % BK;
        const int k0 = key0(t);
        const bool in = c >= blk_lo - k0 && c <= blk_hi - k0;
        const float* sc = (threadIdx.x < BK ? a.pg.ks : a.pg.vs) +
                          page_row(t, a.pg.sc_p, a.pg.sc_h, a.pg.sc_tok) +
                          c * a.pg.sc_tok;
        cp_async4(stage(t) + L::cw_off + threadIdx.x * 4,
                  in ? sc : a.pg.ks, in);
      }
    }
    if (drop) {
      const int k0 = key0(t);
      uint32_t* cw = reinterpret_cast<uint32_t*>(stage(t) + L::cw_off);
      for (int c = threadIdx.x; c < BK; c += NT)
        cw[c] = fa::dropout_col_word(k0 + c + a.dp.k0, bh, a.dp);
    }
  };
  auto copy_v = [&](int t) { copy_kv(t, a.v, L::v_off, v8r); };
  // the online softmax of tile t on the fragments: P_drop(t) in fp32 in
  // place of S(t) (fp8: times the v scales), alpha the rescale of O from
  // the last tile's base to this one's
  float alpha[2];
  auto softmax = [&](int t, float (&sc)[BK / 8][4]) {
    const int k0 = key0(t);
    const uint32_t* cw_s =
        reinterpret_cast<const uint32_t*>(stage(t) + L::cw_off);
    const float* ks_s = reinterpret_cast<const float*>(cw_s);
    const float* vs_s = ks_s + BK;
    auto pass = [&](auto masked) {
      constexpr bool MASK = decltype(masked)::value;
      // row i's max over its two columns of each n-block, then over both
      float mx[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e / 2;
          const int kp = k0 + j * 8 + (lane % 4) * 2 + e % 2;
          float s = sc[j][e];
          if constexpr (kFp8) {
            const float2 kq = *reinterpret_cast<const float2*>(
                ks_s + j * 8 + (lane % 4) * 2);
            s *= e % 2 ? kq.y : kq.x;
          }
          float x = EXTRA ? fa::score_bias(s, qp[i] + sq.offs, kp, a.scale,
                                           slope, a.mp_) *
                                kLog2e
                          : s;
          if (MASK && !lv.valid(qp[i], kp)) x = -INFINITY;
          sc[j][e] = x;
          mx[e] = fmaxf(mx[e], x);
        }
      float base[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float r = fmaxf(mx[2 * i], mx[2 * i + 1]);
        r = fmaxf(r, __shfl_xor_sync(0xffffffffu, r, 1));
        r = fmaxf(r, __shfl_xor_sync(0xffffffffu, r, 2));
        const float m_next = fmaxf(m[i], r * to_log2);
        // a row with no live key so far keeps P = 0 (exp2(-inf - 0))
        base[i] = MASK && m_next == -INFINITY ? 0.0f : m_next;
        alpha[i] = ex2(m[i] - base[i]);
        m[i] = m_next;
      }
      float ls[4] = {0.0f, 0.0f, 0.0f, 0.0f};   // as mx
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e / 2;
          float p = ex2(fmaf(sc[j][e], to_log2, -base[i]));
          ls[e] += p;
          if (drop)
            p = fa::dropout_keep(rw[i], cw_s[j * 8 + (lane % 4) * 2 + e % 2],
                                 a.dp)
                    ? p * a.dp.scale
                    : 0.0f;
          if constexpr (kFp8) {
            const float2 vq = *reinterpret_cast<const float2*>(
                vs_s + j * 8 + (lane % 4) * 2);
            p *= e % 2 ? vq.y : vq.x;
          }
          sc[j][e] = p;
        }
#pragma unroll
      for (int i = 0; i < 2; ++i)
        l[i] = l[i] * alpha[i] + (ls[2 * i] + ls[2 * i + 1]);
    };
    if constexpr (TN::kFast)
      pass(std::false_type{});
    else if (nq_g == 64 && lv.full(g0, 64, k0, BK))
      pass(std::false_type{});
    else
      pass(std::true_type{});
  };
  // step t's copies, after the barrier that frees their stages (fp8 first
  // stores K(t) and V(t - 1), loaded during step t - 1)
  auto copies = [&](int t) {
    if constexpr (kFp8) {
      if (t > 0) {
        if (t < n_steps) k8r.template store<T, P>(stage(t) + L::k_off);
        v8r.template store<TV, PV>(stage(t - 1) + L::v_off);
      }
    }
    cp_async_wait<0>();
    P::copies_landed();
    __syncthreads();   // K(t), V(t - 1) landed for all; the tiles their
                       // stages held before have been read
    if (t + 1 < n_steps) copy_k(t + 1);
    if (t < n_steps) copy_v(t);
    cp_async_commit();
  };

  // S(t) = Q K(t)^T, U products of KT keys; P(t) V(t), U products of
  // depth KT
  auto s_products = [&](float (&sc)[BK / 8][4], int t) {
    if constexpr (U == 1) {
      P::template abt<64, KT>(sc, q_s, wrow, stage(t) + L::k_off, lane);
    } else {
#pragma unroll
      for (int u = 0; u < U; ++u)
        P::template abt<64, KT>(part<KT / 8>(sc, u), q_s, wrow,
                                stage(t) + L::k_off + u * L::kt_bytes, lane);
    }
  };
  auto pv_products = [&](const uint32_t (&pa)[BK / 16][4], int t) {
    if constexpr (U == 1) {
      PV::template ab<BK, D>(o, pa, stage(t) + L::v_off, 0, lane);
    } else {
#pragma unroll
      for (int u = 0; u < U; ++u)
        PV::template ab<KT, D>(o, part<KT / 16>(pa, u),
                               stage(t) + L::v_off + u * L::kt_bytes, 0,
                               lane);
    }
  };
  // the ping-pong (PP): wait for this warpgroup's turn to issue, then hand
  // the turn to the other (named barriers 1 + w: warpgroup w's turn)
  auto turn_wait = [&]() {
    if constexpr (TN::kPingPong) named_bar_sync(1 + wg, 256);
  };
  auto turn_pass = [&]() {
    if constexpr (TN::kPingPong) named_bar_arrive(2 - wg, 256);
  };

  // Every warpgroup runs every tile of the block (a tile none of its rows
  // sees gives P = 0), so no product sits in a branch.  At step s >= 1 it
  // issues S(s) and then P(s - 1) V(s - 1), and runs the softmax of S(s)
  // while the second product is in flight.
  if (n_steps > 0) {
    // the first warpgroup holds the first turn
    if (TN::kPingPong && wg == 0) named_bar_arrive(1, 256);
    if constexpr (MODE == kPaged) {
      const int n_slots = ((kt0 + n_steps) * BK - 1) / ps - slot0 + 1;
      int* tbl = reinterpret_cast<int*>(smem + L::tbl_off);
      const int* row = a.pg.table + static_cast<long long>(b) *
                                        a.pg.table_stride + slot0;
      for (int i = threadIdx.x; i < n_slots; i += NT) tbl[i] = row[i];
      __syncthreads();
    }
    // Q rows past the sequence are zero
    load_rows_async<T, D, 64, NT, P, kNarrow>(smem, a.q, sq.q_base + qp0,
                                              a.Hq, h, 0, nq - 1, DR);
    if (L::kGroups == 2)
      load_rows_async<T, D, 64, NT, P, kNarrow>(
          smem + L::q_tile, a.q, sq.q_base + qp0 + 64, a.Hq, h, 0, nq - 65,
          DR);
    copy_k(0);
    if constexpr (kFp8) k8r.template store<T, P>(stage(0) + L::k_off);
    cp_async_commit();   // one group: Q and K(0)
    float sc[BK / 8][4];        // S(s), then P(s) in fp32
    uint32_t pa[BK / 16][4];    // P(s - 1) in P V's type
    auto rescale_pack = [&]() {
#pragma unroll
      for (int nb = 0; nb < D / 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[nb][e] *= alpha[e / 2];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        pack_a<TV>(pa[kk], sc[2 * kk], sc[2 * kk + 1]);
    };

    copies(0);
    turn_wait();
    P::begin();
    s_products(sc, 0);
    P::commit();
    turn_pass();
    P::template wait<0>();
    P::settle(sc);
    softmax(0, sc);
    rescale_pack();
    for (int s = 1; s < n_steps; ++s) {
      copies(s);
      turn_wait();
      P::begin();
      s_products(sc, s);
      P::commit();
      pv_products(pa, s - 1);
      P::commit();
      turn_pass();
      P::template wait<1>();
      P::settle(sc);
      softmax(s, sc);
      P::template wait<0>();
      P::settle(o);
      // P(s - 1) was an operand of the product just waited for
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          asm volatile("" : "+r"(pa[kk][e]) :: "memory");
      rescale_pack();
    }
    copies(n_steps);
    turn_wait();
    P::begin();
    pv_products(pa, n_steps - 1);
    P::commit();
    turn_pass();
    P::template wait<0>();
    P::settle(o);
    // the second warpgroup's last turn, taken: the turn barriers end even
    if (TN::kPingPong && wg == 0) turn_wait();
  }

  // epilogue: the row sums, O * (1 / l) through the warpgroup's Q tile as
  // 16-byte rows, LSE = m + log(l) (natural log), -inf where l = 0
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    inv[i] = l[i] == 0.0f ? 0.0f : 1.0f / l[i];
  }
  __syncthreads();   // every product has read Q
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
#pragma unroll
    for (int nb = 0; nb < D / 8; ++nb)
      *reinterpret_cast<uint32_t*>(q_s + P::template chunk<64>(r, nb) +
                                   (lane % 4) * 4) =
          pack2<T>(o[nb][2 * i] * inv[i], o[nb][2 * i + 1] * inv[i]);
    if (lane % 4 == 0 && r < nq_g)
      a.lse[sq.lse_index(h, qp[i])] =
          l[i] == 0.0f ? -INFINITY : m[i] * kLn2 + logf(l[i]);
  }
  __syncthreads();
  T* og = static_cast<T*>(a.out);
  constexpr int kChunks = D / 8;
  for (int idx = threadIdx.x % 128; idx < 64 * kChunks; idx += 128) {
    const int r = idx / kChunks;
    const int c8 = idx % kChunks;
    if (r < nq_g && (!kNarrow || c8 < DR / 8))
      *reinterpret_cast<uint4*>(og + ((sq.q_base + g0 + r) * a.Hq + h) * DR +
                                c8 * 8) =
          *reinterpret_cast<const uint4*>(q_s + P::template chunk<64>(r, c8));
  }
}

// ---------------------------------------------------------------- launch

// one kernel variant: its entry, dynamic shared memory, threads and q rows
// a block
struct Kernel {
  void (*fn)(FwdArgs);
  int smem;
  int threads;
  int rows;
};

// the variant, its shared-memory limit raised on first use (paged: to the
// largest block table it has been launched with, `extra` bytes)
template <typename T, int D, int MODE, bool EXTRA, int KV = kKv16,
          class TN = FwdTune<>>
cudaError_t variant(Kernel* k, int extra = 0) {
  using L = FwdSmem<T, D, KV, TN>;
  k->fn = fwd_kernel<T, D, MODE, EXTRA, KV, TN>;
  k->smem = static_cast<int>(L::bytes);
  k->threads = L::kThreads;
  k->rows = L::BQ;
  static int configured = 0;
  if (k->smem + extra > configured) {
    cudaError_t e = cudaFuncSetAttribute(
        k->fn, cudaFuncAttributeMaxDynamicSharedMemorySize, k->smem + extra);
    if (e != cudaSuccess) return e;
    configured = k->smem + extra;
  }
  return cudaSuccess;
}

template <typename T, int MODE, int KV = kKv16>
cudaError_t find_d(int D, bool extra, Kernel* k, int smem_extra = 0) {
  switch (D) {
    case 32: return extra ? variant<T, 32, MODE, true, KV>(k, smem_extra)
                          : variant<T, 32, MODE, false, KV>(k, smem_extra);
    case 64: return extra ? variant<T, 64, MODE, true, KV>(k, smem_extra)
                          : variant<T, 64, MODE, false, KV>(k, smem_extra);
    case 128: return extra ? variant<T, 128, MODE, true, KV>(k, smem_extra)
                           : variant<T, 128, MODE, false, KV>(k, smem_extra);
    case 256: return extra ? variant<T, 256, MODE, true, KV>(k, smem_extra)
                           : variant<T, 256, MODE, false, KV>(k, smem_extra);
    default: return cudaErrorInvalidValue;
  }
}

// the variant for the call's bias and dropout (a scale <= 0 too)
bool needs_extra(const FwdArgs& a) {
  return a.mp_.has_alibi || a.mp_.softcap > 0.0f || a.dp.enabled ||
         !(a.scale > 0.0f);
}

// one block per (q tile, q head, sequence); blocks past their sequence
// leave at once
cudaError_t launch_kernel(const Kernel& kn, const FwdArgs& a, int smem_extra,
                          cudaStream_t stream) {
  const int tiles = (a.seq.M + kn.rows - 1) / kn.rows;
  kn.fn<<<tiles * a.Hq * a.B, kn.threads, kn.smem + smem_extra, stream>>>(a);
  return cudaGetLastError();
}

// paged: the block table's bytes in shared memory (mp slots, 16-byte
// multiple)
int table_bytes(int mp) { return (mp * 4 + 15) / 16 * 16; }

}  // namespace
