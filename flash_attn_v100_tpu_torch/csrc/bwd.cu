// K2 (dQ) and K3 (dK, dV), dense, and K6 (dQ) and K7 (dK, dV), packed
// varlen: attention backward for Hopper (sm_90a), one body of each kernel
// instantiated for both (csrc/seq.cuh), as csrc/fwd.cu does for K1 and K5.
//
// K2 and K3 replace flash_attn_v100_tpu/ops/pallas/bwd.py::_dq_kernel and
// ::_dkv_kernel, the two TPU kernels behind flash_attn_dense_bwd and the
// backward of flash_attn_func: q/dout (B, M, Hq, D), k/v (B, N, Hk, D)
// contiguous, GQA kv_head = h / group, the forward's masks, bias and
// dropout keying (csrc/fwd.cu); lse and delta (B, Hq, M).
//
// K6 and K7 replace flash_attn_v100_tpu/ops/pallas/varlen.py::
// _varlen_dq_kernel and ::_varlen_dkv_kernel, the TPU kernels behind
// flash_attn_varlen_bwd and the backward of flash_attn_varlen_func: q/dout
// (Tq, Hq, D) packed by cu_q, k/v (Tk, Hk, D) by cu_k, optional seqused_k /
// leftpad_k; the masks aligned per sequence and dropout keyed as K5 keys
// it; lse and delta (Hq, Tq).  Rows and keys no block covers (past cu_q[B]
// / cu_k[B], before leftpad_k, past seqused_k) are left to the caller,
// which zeroes them.  On equal lengths K6/K7 give K2/K3's bits.
//
// All four: lse clamped to >= NEG_INF and delta = rowsum(O * dO) - dlse,
// both fp32 and computed by the caller.  Per score:
//     P      = exp(min(S - lse, 0)) where the position is valid, else 0
//     P_drop = keep ? P / (1 - p) : 0
//     dS     = (P_drop * dO.V^T - P * delta) * scale  [* (1 - (S/cap)^2)]
// dQ = dS K (dS rounded to the input type), dK = dS^T Q, dV = P_drop^T dO
// (P_drop rounded to the input type), all accumulated in fp32.
//
// What bounds them on this card: operations.  dQ does 6 * D flops per live
// (q row, key) pair (S, dO V^T, dS K) and dK/dV 8 * D (S^T, V dO^T,
// P^T dO, dS^T Q), against Q/K/V/dO bytes read once per tile: far above
// the ~295 flop/byte ridge.
//
// What the design does about it (the FlashAttention-2 shape with Hopper's
// warpgroup products; helpers in csrc/mma_sm90.cuh, products and live-key
// intervals in csrc/attn_tiles.cuh):
//   * Work.  K2 is q-centric: one block of 4 warps per (64-row q tile, q
//     head, batch row or sequence), each warp owning 16 q rows, looping
//     over the key tiles its rows' intervals touch (at D 256 a block of
//     two warpgroups over 128 q rows: dq_split_kernel below).  K3 is
//     key-centric: one block of 4 warps per (key tile, kv head, batch row
//     or sequence), each warp owning 16 key rows, looping over the `group`
//     q heads of its kv head and, for each, over the live q tiles (at D
//     256 a block of two warpgroups: dkv_split_kernel below).  A varlen
//     block reads its sequence's bounds from device memory and leaves at
//     once, before any copy or product, if its tile lies past the sequence
//     (the grid covers max_seqlen).
//   * Products.  At D 64, 128 and 256 every product is a wgmma over a
//     warpgroup's 64 rows: S = Q K^T and dP = dO V^T (K3: S^T = K Q^T,
//     dP^T = V dO^T) with both operands read from shared memory, K-major;
//     dQ += dS K (K3 at D <= 128: dV += P_drop^T dO, dK += dS^T Q) with A
//     from registers and B read MN-major through the transpose bit (K3 at
//     D 256 reads A from an exchange tile).  At D 32 every product is a
//     wgmma too, on 64-byte-swizzled tiles (a row is one atom): S and dP
//     m64n64k16, two k-steps 32 bytes apart; dQ m64n32k16 with dS from
//     registers.
//   * Registers.  The accumulators (dQ in K2; dK and dV in K3) live in
//     registers for the block's whole life and go to device memory once.
//     S and dP of the current tile stay in the accumulator fragments; the
//     score pass (mask, bias, exp, dropout, dS) runs on them, taking each
//     element's (row, col) from the fragment layout, and P_drop and dS,
//     rounded to the input type, are the A operands of the next products:
//     the accumulator layout is the A layout, so nothing goes back to shared
//     memory.
//   * Shared memory.  The block's fixed operands (Q and dO in K2; K and V
//     in K3) and a two-stage cp.async ring of the streamed ones (K, V and
//     the dropout column words in K2; Q, dO, lse, delta and the dropout row
//     words in K3).  Tiles are 128-byte swizzled for wgmma (64-byte at D
//     32), so the tensor cores read them without bank conflicts.
//   * In flight.  While a stage is computed on, the next tile's copies run;
//     one block barrier a tile.
//   * Masks.  Only tiles that straddle a row's causal/window edge or the
//     ragged end of M or N (each sequence's, in varlen) run the
//     per-element mask test.  ALiBi, softcap and dropout are compiled only
//     into the kernel variant for the calls that use them.
//   * Order.  The linear block index maps to the tile heaviest first under
//     causal masking (K3's low key tiles, K2's high q tiles); the map is a
//     permutation, so every tile is visited once under any mask.
//   * Tiles (shared memory a block, 16-bit inputs, with 1 KB of alignment
//     slack):
//         D     K2: q rows x keys a step    K3: keys x q rows a step
//         32    64 x 64  wgmma    (27 KB)   64 x 64  wgmma    (27 KB)
//         64    64 x 64  wgmma    (51 KB)   64 x 64  wgmma    (51 KB)
//         128   64 x 32  wgmma    (67 KB)   64 x 32  wgmma    (67 KB)
//         256  128 x 32  wgmma    (195 KB)  64 x 64  wgmma    (211 KB)
//   * Nothing is summed across blocks: every output element belongs to one
//     block, which adds its terms in a fixed order, so two calls are
//     bitwise equal.
//   * Variants (BwdTune; the shipped kernels take its defaults).  The
//     sweep library (FA_SWEEP, ops/cuda/build.py VARIANTS) instantiates
//     others at bf16, D 128 for the backward tile sweeps
//     (benchmarks/prof_bwd*, prof_dkv_wide): K2 at 64 keys a step, K3 at
//     64 q rows a step, K3 at 128 keys a block (two warpgroups).
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "attn_tiles.cuh"
#include "masks.cuh"
#include "philox.cuh"
#include "seq.cuh"

// FA_SWEEP 1 builds the sweep library (ops/cuda/build.py VARIANTS) in
// place of the shipped one: only the tile variants of find_variant below.
#ifndef FA_SWEEP
#define FA_SWEEP 0
#endif

namespace {

using namespace fa::attn;

constexpr int kThreads = 128;   // 4 warps: dq_kernel, dkv_kernel (one
                                // warpgroup)
constexpr float kLog2e = 1.4426950408889634f;

struct BwdArgs {
  const void* q;          // dense (B, M, Hq, D); varlen (Tq, Hq, D)
  const void* k;          // dense (B, N, Hk, D); varlen (Tk, Hk, D)
  const void* v;
  const void* dout;       // q's shape
  const float* lse;       // dense (B, Hq, M); varlen (Hq, Tq); >= NEG_INF
  const float* delta;     // lse's shape
  const float* slopes;    // (B, Hq) or nullptr
  void* dq;               // q's shape
  void* dk;               // k's shape
  void* dv;
  fa::SeqArgs seq;
  int B, Hq, Hk, group;
  float scale;
  fa::MaskParams mp_;
  fa::DropoutParams dp;
};

// The tiles of a backward kernel; 0 is the body's own choice for D.  The
// shipped kernels take the defaults.
//   DQBK   K2: keys a step
//   DKVBQ  K3: q rows a step
//   KG     K3: warpgroups a block, each over 64 keys of its own (the wgmma
//          path, D 32 / 64 / 128)
// (K2 and K3 at D 256 take none: dq_split_kernel and dkv_split_kernel
// have one tile each.)
template <int DQBK = 0, int DKVBQ = 0, int KG = 1>
struct BwdTune {
  static constexpr int kDqBK = DQBK, kDkvBQ = DKVBQ, kKeyGroups = KG;
};

template <int D, class TN = BwdTune<>>
struct Tiles {
  static constexpr int kDqBQ = 64;                    // K2: q rows a block
                                                      // (D 256: DqSplitSmem)
  static constexpr int kDqBK =                        // K2: keys a step
      TN::kDqBK ? TN::kDqBK : (D <= 64 ? 64 : 32);
  static constexpr int kKeyWarps = 4;                 // K3: 16-key slabs
  static constexpr int kKeyGroups = TN::kKeyGroups;   // K3: warpgroups
  static constexpr int kDkvBK = 16 * kKeyWarps * kKeyGroups;  // K3: keys
  static constexpr int kDkvBQ =                       // K3: q rows a step
      TN::kDkvBQ ? TN::kDkvBQ : (D <= 64 ? 64 : 32);
  static constexpr int kDkvThreads = kThreads * kKeyGroups;
  static_assert(kKeyGroups == 1 || (kKeyWarps == 4 && D <= 128),
                "K3's warpgroups take the wgmma path");
};

__device__ __forceinline__ Live make_live(const BwdArgs& a,
                                          const fa::Seq& sq) {
  Live lv;
  lv.N = sq.slk;
  lv.offs = sq.offs;
  lv.wl = a.mp_.window_left;
  lv.wr = a.mp_.effective_window_right();
  return lv;
}

// The block's sequence, seq_info's r.  A dense block's bounds are
// arithmetic on the kernel's arguments, which the compiler re-derives where
// it needs them.  A varlen block's come from device memory: the block puts
// them in shared memory, s, and reads them there where it needs them,
// rather than holding them in registers across its loop (held, they made
// K3's bias/dropout variant spill at D 64).
template <bool kVarlen>
__device__ __forceinline__ const fa::Seq& block_seq(const fa::Seq& r,
                                                    fa::Seq& s) {
  if constexpr (!kVarlen) {
    return r;
  } else {
    if (threadIdx.x == 0) s = r;
    __syncthreads();
    return s;
  }
}

// One score of a fragment: s holds S on entry and P_drop on return, dp
// holds dO.V^T on entry and dS on return; M is the sequence's q rows.
template <bool MASK, bool EXTRA>
__device__ __forceinline__ void grad_score(float& s, float& dp, int qp, int kp,
                                           float lse, float delta,
                                           uint32_t rw, uint32_t cw,
                                           float slope, const Live& lv, int M,
                                           const BwdArgs& a) {
  const float sb =
      EXTRA ? fa::score_bias(s, qp + lv.offs, kp, a.scale, slope, a.mp_)
            : s * a.scale;
  float p = exp2f(fminf(sb - lse, 0.0f) * kLog2e);
  if (MASK && !(qp < M && lv.valid(qp, kp))) p = 0.0f;
  float pd = p;
  if (EXTRA && a.dp.enabled)
    pd = fa::dropout_keep(rw, cw, a.dp) ? p * a.dp.scale : 0.0f;
  float ds = (pd * dp - p * delta) * a.scale;
  if (EXTRA && a.mp_.softcap > 0.0f) {
    const float sn = sb * (1.0f / a.mp_.softcap);
    ds *= 1.0f - sn * sn;
  }
  s = pd;
  dp = ds;
}

// ROWS rows of a (rows, H, D) tensor from packed row row0, head h, into a
// tile in P's layout, 16 bytes a copy by NT threads; tile rows at or past n
// are zero
template <typename T, int D, int ROWS, class P, int NT = kThreads>
__device__ __forceinline__ void load_tile_async(unsigned char* dst,
                                                const void* src,
                                                long long row0, int n, int H,
                                                int h) {
  constexpr int kChunks = D / 8;
  constexpr int kTotal = ROWS * kChunks;
  const T* g = static_cast<const T*>(src);
#pragma unroll
  for (int i = 0; i < (kTotal + NT - 1) / NT; ++i) {
    const int idx = i * NT + threadIdx.x;
    if (kTotal % NT == 0 || idx < kTotal) {
      const int r = idx / kChunks;
      const int c8 = idx % kChunks;
      const bool in = r < n;
      const T* p = in ? g + ((row0 + r) * H + h) * D + c8 * 8 : g;
      cp_async16(dst + P::template chunk<ROWS>(r, c8), p, in);
    }
  }
}

// ------------------------------------------------------------------ K2: dQ

template <typename T, int D, class TN = BwdTune<>>
struct DqSmem {
  using P = PathOf<T, D>;
  static constexpr int BQ = Tiles<D, TN>::kDqBQ, BK = Tiles<D, TN>::kDqBK;
  static constexpr size_t q_off = 0;
  static constexpr size_t do_off = P::template tile_bytes<BQ>();
  static constexpr size_t stage_off = align1k(2 * do_off);
  // a stage: the K and V tiles and the dropout column words
  static constexpr size_t k_off = 0;
  static constexpr size_t v_off = P::template tile_bytes<BK>();
  static constexpr size_t cw_off = 2 * v_off;
  static constexpr size_t stage_bytes = align1k(cw_off + sizeof(uint32_t) * BK);
  static constexpr size_t bytes = stage_off + 2 * stage_bytes + 1024;
};

template <typename T, int D, bool kVarlen, bool EXTRA, class TN = BwdTune<>>
__global__ void __launch_bounds__(kThreads) dq_kernel(BwdArgs a) {
  static_assert(D <= 128, "K2 at D 256 is dq_split_kernel");
  using L = DqSmem<T, D, TN>;
  using P = typename L::P;
  constexpr int BQ = L::BQ, BK = L::BK;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = smem_base(smem_raw);
  unsigned char* q_s = smem + L::q_off;
  unsigned char* do_s = smem + L::do_off;

  // heaviest first: q tiles from the last (under causal masking a later q
  // tile sees more keys), each over all heads and batch rows / sequences
  const int n_tiles = (a.seq.M + BQ - 1) / BQ;
  const int hb = blockIdx.x % (a.Hq * a.B);
  const int h = hb % a.Hq;
  const int b = hb / a.Hq;
  const int qp0 =
      (n_tiles - 1 - static_cast<int>(blockIdx.x) / (a.Hq * a.B)) * BQ;
  const fa::Seq seq_r = fa::seq_info<kVarlen>(a.seq, b, a.Hq);
  if (kVarlen && qp0 >= seq_r.slq) return;  // uniform over the block
  __shared__ fa::Seq seq_s;
  const fa::Seq& sq = block_seq<kVarlen>(seq_r, seq_s);
  const int nq = min(BQ, sq.slq - qp0);
  const int kvh = h / a.group;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp * 16 + lane / 4;   // this thread's rows: r0, r0 + 8
  const Live lv = make_live(a, sq);
  const bool drop = EXTRA && a.dp.enabled;
  const float slope = EXTRA && a.slopes ? a.slopes[b * a.Hq + h] : 0.0f;
  const uint32_t bh = fa::dropout_bh(b, h, a.dp);
  int qp[2];
  float lse[2], delta[2];
  uint32_t rw[2] = {0u, 0u};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    qp[i] = qp0 + r;
    const long long row = sq.lse_index(h, qp[i]);
    lse[i] = r < nq ? a.lse[row] : 0.0f;
    delta[i] = r < nq ? a.delta[row] : 0.0f;
    if (drop) rw[i] = fa::dropout_row_word(qp[i] + a.dp.q0, bh, a.dp);
  }
  const int blk_lo = lv.key_lo(qp0);
  const int blk_hi = lv.key_hi(qp0 + nq - 1);
  const int kt0 = blk_lo / BK;
  const int n_steps = blk_hi >= blk_lo ? blk_hi / BK - kt0 + 1 : 0;

  float dq[D / 8][4] = {};

  auto prefetch = [&](int s) {
    unsigned char* st = smem + L::stage_off + (s & 1) * L::stage_bytes;
    const int k0 = (kt0 + s) * BK;
    load_tile_async<T, D, BK, P>(st + L::k_off, a.k, sq.k_base + k0,
                                 sq.slk - k0, a.Hk, kvh);
    load_tile_async<T, D, BK, P>(st + L::v_off, a.v, sq.k_base + k0,
                                 sq.slk - k0, a.Hk, kvh);
    cp_async_commit();
    if (drop) {
      uint32_t* cw = reinterpret_cast<uint32_t*>(st + L::cw_off);
      for (int c = threadIdx.x; c < BK; c += kThreads)
        cw[c] = fa::dropout_col_word(k0 + c + a.dp.k0, bh, a.dp);
    }
  };

  if (n_steps > 0) {
    load_tile_async<T, D, BQ, P>(q_s, a.q, sq.q_base + qp0, nq, a.Hq, h);
    load_tile_async<T, D, BQ, P>(do_s, a.dout, sq.q_base + qp0, nq, a.Hq, h);
    prefetch(0);   // one group: Q, dO and the first K/V stage
    for (int s = 0; s < n_steps; ++s) {
      cp_async_wait<0>();
      P::copies_landed();
      __syncthreads();   // stage s landed for all; stage s + 1 is free
      if (s + 1 < n_steps) prefetch(s + 1);
      const unsigned char* st = smem + L::stage_off + (s & 1) * L::stage_bytes;
      const unsigned char* k_s = st + L::k_off;
      const uint32_t* cw_s = reinterpret_cast<const uint32_t*>(st + L::cw_off);
      const int k0 = (kt0 + s) * BK;

      // S = Q K^T and dP = dO V^T
      float sc[BK / 8][4], dp[BK / 8][4];
      P::begin();
      P::template abt<BQ, BK>(sc, q_s, warp * 16, k_s, lane);
      P::template abt<BQ, BK>(dp, do_s, warp * 16, st + L::v_off, lane);
      P::commit_wait();
      P::settle(sc);
      P::settle(dp);

      // dS in place of dP, from the fragments' (row, col); the live-key
      // bounds made again each step, so that a varlen block reads them from
      // shared memory rather than holding them in registers
      const Live lv_s = make_live(a, sq);
      auto scores = [&](auto masked) {
        constexpr bool MASK = decltype(masked)::value;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e / 2;
            const int c = j * 8 + (lane % 4) * 2 + e % 2;
            grad_score<MASK, EXTRA>(sc[j][e], dp[j][e], qp[i], k0 + c, lse[i],
                                    delta[i], rw[i], drop ? cw_s[c] : 0u,
                                    slope, lv_s, sq.slq, a);
          }
      };
      if (nq == BQ && lv_s.full(qp0, BQ, k0, BK))
        scores(std::false_type{});
      else
        scores(std::true_type{});

      // dQ += dS K
      uint32_t da[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        pack_a<T>(da[kk], dp[2 * kk], dp[2 * kk + 1]);
      P::begin();
      P::template ab<BK, D>(dq, da, k_s, 0, lane);
      P::commit_wait();
    }
    P::settle(dq);
  }

  T* dqg = static_cast<T*>(a.dq);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (r0 + 8 * i >= nq) continue;
    const long long row = (sq.q_base + qp[i]) * a.Hq + h;
#pragma unroll
    for (int nb = 0; nb < D / 8; ++nb)
      *reinterpret_cast<uint32_t*>(dqg + row * D + nb * 8 + (lane % 4) * 2) =
          pack2<T>(dq[nb][2 * i], dq[nb][2 * i + 1]);
  }
}

// ------------------------------------------------------ K2 at D 256: dQ
//
// At D 256 K2 is a block of two warpgroups over 128 q rows of one (q head,
// batch row or sequence), K1's D 256 layout applied to dQ: warpgroup w
// owns rows [64 w, 64 w + 64) and all 256 dQ columns, 128 fp32 registers a
// thread for the block's life, stored once.  It loops over the live keys
// 32 a step, heaviest first, as dq_kernel does; each step each warpgroup
// runs
//   * S = Q K^T and dP = dO V^T, wgmma m64n32k16 with its Q / dO tile and
//     the shared K / V tile read K-major from 128-byte-swizzled tiles,
//     issued back to back and waited for once;
//   * the score pass (grad_score) on the fragments;
//   * dQ += dS K, one wgmma m64n256k16 a k-step with dS from registers and
//     K read MN-major through the transpose bit.
// Nothing goes through shared memory between the products, and each K / V
// stage serves 128 q rows.  Shared memory: Q and dO (128 KB) and two
// stages of K, V and the dropout column words (66 KB): 195 KB, one block
// of 8 warps an SM.  Both warpgroups run every step of the block (one that
// none of a warpgroup's rows sees gives dS = 0), so no product sits in a
// branch.  The epilogue rounds dQ into the warpgroup's Q tile and stores
// 16-byte rows.

template <typename T>
struct DqSplitSmem {
  static constexpr int D = 256;
  static constexpr int BQ = 128;             // q rows a block
  static constexpr int BK = 32;              // keys a step
  static constexpr int kThreads = 256;       // two warpgroups
  using P = WgPath<T, D>;
  // warpgroup w's 64-row Q tile at q_off + w * q_tile, its dO tile at
  // do_off + w * q_tile
  static constexpr size_t q_tile = P::template tile_bytes<64>();
  static constexpr size_t q_off = 0;
  static constexpr size_t do_off = 2 * q_tile;
  static constexpr size_t stage_off = align1k(4 * q_tile);
  // a stage: the K and V tiles and the dropout column words
  static constexpr size_t k_off = 0;
  static constexpr size_t v_off = P::template tile_bytes<BK>();
  static constexpr size_t cw_off = 2 * v_off;
  static constexpr size_t stage_bytes = align1k(cw_off + sizeof(uint32_t) * BK);
  static constexpr size_t bytes = stage_off + 2 * stage_bytes + 1024;
};

template <typename T, int D, bool kVarlen, bool EXTRA>
__global__ void __launch_bounds__(DqSplitSmem<T>::kThreads)
    dq_split_kernel(BwdArgs a) {
  static_assert(D == 256, "K2's split layout is D 256's");
  using L = DqSplitSmem<T>;
  using P = typename L::P;
  constexpr int BQ = L::BQ, BK = L::BK, NT = L::kThreads;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = smem_base(smem_raw);

  // heaviest first, as dq_kernel
  const int n_tiles = (a.seq.M + BQ - 1) / BQ;
  const int hb = blockIdx.x % (a.Hq * a.B);
  const int h = hb % a.Hq;
  const int b = hb / a.Hq;
  const int qp0 =
      (n_tiles - 1 - static_cast<int>(blockIdx.x) / (a.Hq * a.B)) * BQ;
  const fa::Seq seq_r = fa::seq_info<kVarlen>(a.seq, b, a.Hq);
  if (kVarlen && qp0 >= seq_r.slq) return;  // uniform over the block
  __shared__ fa::Seq seq_s;
  const fa::Seq& sq = block_seq<kVarlen>(seq_r, seq_s);
  const int nq = min(BQ, sq.slq - qp0);
  const int kvh = h / a.group;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wg = warp / 4;                 // this thread's warpgroup
  const int g0 = qp0 + 64 * wg;            // its first q row
  const int nq_g = min(64, sq.slq - g0);   // its rows in the sequence
  const int r0 = (warp % 4) * 16 + lane / 4;   // this thread's rows there:
                                               // r0, r0 + 8
  unsigned char* q_s = smem + L::q_off + wg * L::q_tile;
  unsigned char* do_s = smem + L::do_off + wg * L::q_tile;
  const Live lv = make_live(a, sq);
  const bool drop = EXTRA && a.dp.enabled;
  const float slope = EXTRA && a.slopes ? a.slopes[b * a.Hq + h] : 0.0f;
  const uint32_t bh = fa::dropout_bh(b, h, a.dp);
  int qp[2];
  float lse[2], delta[2];
  uint32_t rw[2] = {0u, 0u};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    qp[i] = g0 + r;
    const long long row = sq.lse_index(h, qp[i]);
    lse[i] = r < nq_g ? a.lse[row] : 0.0f;
    delta[i] = r < nq_g ? a.delta[row] : 0.0f;
    if (drop) rw[i] = fa::dropout_row_word(qp[i] + a.dp.q0, bh, a.dp);
  }
  const int blk_lo = lv.key_lo(qp0);
  const int blk_hi = lv.key_hi(qp0 + nq - 1);
  const int kt0 = blk_lo / BK;
  const int n_steps = blk_hi >= blk_lo ? blk_hi / BK - kt0 + 1 : 0;

  float dq[D / 8][4] = {};

  auto prefetch = [&](int s) {
    unsigned char* st = smem + L::stage_off + (s & 1) * L::stage_bytes;
    const int k0 = (kt0 + s) * BK;
    load_tile_async<T, D, BK, P, NT>(st + L::k_off, a.k, sq.k_base + k0,
                                     sq.slk - k0, a.Hk, kvh);
    load_tile_async<T, D, BK, P, NT>(st + L::v_off, a.v, sq.k_base + k0,
                                     sq.slk - k0, a.Hk, kvh);
    cp_async_commit();
    if (drop) {
      uint32_t* cw = reinterpret_cast<uint32_t*>(st + L::cw_off);
      for (int c = threadIdx.x; c < BK; c += NT)
        cw[c] = fa::dropout_col_word(k0 + c + a.dp.k0, bh, a.dp);
    }
  };

  if (n_steps > 0) {
    // both warpgroups' Q and dO tiles; rows past the sequence are zero
#pragma unroll
    for (int w = 0; w < 2; ++w) {
      const long long row0 = sq.q_base + qp0 + 64 * w;
      load_tile_async<T, D, 64, P, NT>(smem + L::q_off + w * L::q_tile, a.q,
                                       row0, nq - 64 * w, a.Hq, h);
      load_tile_async<T, D, 64, P, NT>(smem + L::do_off + w * L::q_tile,
                                       a.dout, row0, nq - 64 * w, a.Hq, h);
    }
    prefetch(0);   // one group: Q, dO and the first K/V stage
    for (int s = 0; s < n_steps; ++s) {
      cp_async_wait<0>();
      P::copies_landed();
      __syncthreads();   // stage s landed for all; stage s + 1 is free
      if (s + 1 < n_steps) prefetch(s + 1);
      const unsigned char* st = smem + L::stage_off + (s & 1) * L::stage_bytes;
      const unsigned char* k_s = st + L::k_off;
      const uint32_t* cw_s = reinterpret_cast<const uint32_t*>(st + L::cw_off);
      const int k0 = (kt0 + s) * BK;

      // S = Q K^T and dP = dO V^T on this warpgroup's 64 rows
      float sc[BK / 8][4], dp[BK / 8][4];
      P::begin();
      P::template abt<64, BK>(sc, q_s, 0, k_s, 0);
      P::template abt<64, BK>(dp, do_s, 0, st + L::v_off, 0);
      P::commit_wait();
      P::settle(sc);
      P::settle(dp);

      // dS in place of dP (lv_s as in dq_kernel)
      const Live lv_s = make_live(a, sq);
      auto scores = [&](auto masked) {
        constexpr bool MASK = decltype(masked)::value;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e / 2;
            const int c = j * 8 + (lane % 4) * 2 + e % 2;
            grad_score<MASK, EXTRA>(sc[j][e], dp[j][e], qp[i], k0 + c, lse[i],
                                    delta[i], rw[i], drop ? cw_s[c] : 0u,
                                    slope, lv_s, sq.slq, a);
          }
      };
      if (nq_g == 64 && lv_s.full(g0, 64, k0, BK))
        scores(std::false_type{});
      else
        scores(std::true_type{});

      // dQ += dS K
      uint32_t da[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        pack_a<T>(da[kk], dp[2 * kk], dp[2 * kk + 1]);
      P::begin();
      P::template ab<BK, D>(dq, da, k_s, 0, 0);
      P::commit_wait();
    }
    P::settle(dq);
  }

  // epilogue: dQ rounded to T through this warpgroup's Q tile, then stored
  // as 16-byte rows
  __syncthreads();   // every product has read Q
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
#pragma unroll
    for (int nb = 0; nb < D / 8; ++nb)
      *reinterpret_cast<uint32_t*>(q_s + P::template chunk<64>(r, nb) +
                                   (lane % 4) * 4) =
          pack2<T>(dq[nb][2 * i], dq[nb][2 * i + 1]);
  }
  __syncthreads();
  T* dqg = static_cast<T*>(a.dq);
  constexpr int kChunks = D / 8;
  for (int idx = threadIdx.x % 128; idx < 64 * kChunks; idx += 128) {
    const int r = idx / kChunks;
    const int c8 = idx % kChunks;
    if (r < nq_g)
      *reinterpret_cast<uint4*>(dqg + ((sq.q_base + g0 + r) * a.Hq + h) * D +
                                c8 * 8) =
          *reinterpret_cast<const uint4*>(q_s + P::template chunk<64>(r, c8));
  }
}

// ------------------------------------------------------------ K3: dK, dV

template <typename T, int D, class TN = BwdTune<>>
struct DkvSmem {
  using P = PathOf<T, D>;
  static constexpr int BK = Tiles<D, TN>::kDkvBK, BQ = Tiles<D, TN>::kDkvBQ;
  // the K and V tiles: one of BK rows, or (two warpgroups) one of 64 rows
  // each, so that each warpgroup's rows are a tile of their own
  static constexpr size_t gk_bytes =
      P::template tile_bytes<BK / Tiles<D, TN>::kKeyGroups>();
  static constexpr size_t k_off = 0;
  static constexpr size_t v_off = P::template tile_bytes<BK>();
  static constexpr size_t stage_off = align1k(2 * v_off);
  // a stage: the Q and dO tiles, lse, delta and the dropout row words
  static constexpr size_t q_off = 0;
  static constexpr size_t do_off = P::template tile_bytes<BQ>();
  static constexpr size_t lse_off = 2 * do_off;
  static constexpr size_t delta_off = lse_off + sizeof(float) * BQ;
  static constexpr size_t rw_off = delta_off + sizeof(float) * BQ;
  static constexpr size_t stage_bytes = align1k(rw_off + sizeof(uint32_t) * BQ);
  static constexpr size_t bytes = stage_off + 2 * stage_bytes + 1024;
};

template <typename T, int D, bool kVarlen, bool EXTRA, class TN = BwdTune<>>
__global__ void __launch_bounds__(Tiles<D, TN>::kDkvThreads)
    dkv_kernel(BwdArgs a) {
  using L = DkvSmem<T, D, TN>;
  using P = typename L::P;
  constexpr int BK = L::BK, BQ = L::BQ;
  constexpr int kKeyWarps = Tiles<D, TN>::kKeyWarps;
  constexpr int KG = Tiles<D, TN>::kKeyGroups;
  constexpr int NT = Tiles<D, TN>::kDkvThreads;
  constexpr int GK = BK / KG;                 // keys a warpgroup
  constexpr int DW = D;                       // dK/dV columns a warp holds
  static_assert(D <= 128, "K3 at D 256 is dkv_split_kernel");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = smem_base(smem_raw);
  unsigned char* k_s = smem + L::k_off;
  unsigned char* v_s = smem + L::v_off;

  // heaviest first: key tiles from the first (under causal masking an
  // earlier key tile is seen by more q rows), each over all kv heads and
  // batch rows / sequences
  const int hb = blockIdx.x % (a.Hk * a.B);
  const int kvh = hb % a.Hk;
  const int b = hb / a.Hk;
  const int k0 = static_cast<int>(blockIdx.x) / (a.Hk * a.B) * BK;
  const fa::Seq seq_r = fa::seq_info<kVarlen>(a.seq, b, a.Hq);
  if (kVarlen && k0 >= seq_r.slk) return;  // uniform over the block
  __shared__ fa::Seq seq_s;
  const fa::Seq& sq = block_seq<kVarlen>(seq_r, seq_s);
  const int nk = min(BK, sq.slk - k0);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wg = KG == 1 ? 0 : warp / 4;     // this warp's key warpgroup
  const int kr0 = (warp % kKeyWarps) * 16;   // its 16 key rows there
  const int d0 = ((KG == 1 ? warp : warp % 4) / kKeyWarps) * DW;  // and its
                                                    // dK/dV columns
  const int kp = k0 + wg * GK + kr0 + lane / 4;  // this thread's keys: kp,
                                                 // kp + 8
  const Live lv = make_live(a, sq);
  const bool drop = EXTRA && a.dp.enabled;
  // q rows that see any key of this tile: [q_lo, q_hi]
  const int k_last = k0 + nk - 1;
  const int q_lo = lv.wr >= 0 ? max(0, k0 - lv.offs - lv.wr) : 0;
  const int q_hi = lv.wl >= 0 ? min(sq.slq - 1, k_last - lv.offs + lv.wl)
                              : sq.slq - 1;
  const int qt0 = q_lo / BQ;
  const int n_qt = q_hi >= q_lo ? q_hi / BQ - qt0 + 1 : 0;
  const int n_steps = a.group * n_qt;   // (q head, q tile), head-major

  float dk[DW / 8][4] = {}, dv[DW / 8][4] = {};

  auto prefetch = [&](int s) {
    unsigned char* st = smem + L::stage_off + (s & 1) * L::stage_bytes;
    const int h = kvh * a.group + s / n_qt;
    const int t0 = (qt0 + s % n_qt) * BQ;
    load_tile_async<T, D, BQ, P, NT>(st + L::q_off, a.q, sq.q_base + t0,
                                     sq.slq - t0, a.Hq, h);
    load_tile_async<T, D, BQ, P, NT>(st + L::do_off, a.dout, sq.q_base + t0,
                                     sq.slq - t0, a.Hq, h);
    const long long base = sq.lse_index(h, t0);
    float* lse = reinterpret_cast<float*>(st + L::lse_off);
    float* delta = reinterpret_cast<float*>(st + L::delta_off);
    for (int c = threadIdx.x; c < BQ; c += NT) {
      const bool in = t0 + c < sq.slq;
      cp_async4(lse + c, in ? a.lse + base + c : a.lse, in);
      cp_async4(delta + c, in ? a.delta + base + c : a.delta, in);
    }
    cp_async_commit();
    if (drop) {
      uint32_t* rw = reinterpret_cast<uint32_t*>(st + L::rw_off);
      const uint32_t bh = fa::dropout_bh(b, h, a.dp);
      for (int c = threadIdx.x; c < BQ; c += NT)
        rw[c] = fa::dropout_row_word(t0 + c + a.dp.q0, bh, a.dp);
    }
  };

  if (n_steps > 0) {
#pragma unroll
    for (int g = 0; g < KG; ++g) {
      const size_t off = g * L::gk_bytes;
      load_tile_async<T, D, GK, P, NT>(k_s + off, a.k, sq.k_base + k0 + g * GK,
                                       nk - g * GK, a.Hk, kvh);
      load_tile_async<T, D, GK, P, NT>(v_s + off, a.v, sq.k_base + k0 + g * GK,
                                       nk - g * GK, a.Hk, kvh);
    }
    prefetch(0);   // one group: K, V and the first Q/dO stage
    int cur_h = -1;
    float slope = 0.0f;
    uint32_t cw[2] = {0u, 0u};
    for (int s = 0; s < n_steps; ++s) {
      cp_async_wait<0>();
      P::copies_landed();
      __syncthreads();   // stage s landed for all; stage s + 1 is free
      if (s + 1 < n_steps) prefetch(s + 1);
      const int h = kvh * a.group + s / n_qt;
      const int t0 = (qt0 + s % n_qt) * BQ;
      if (EXTRA && h != cur_h) {
        cur_h = h;
        slope = a.slopes ? a.slopes[b * a.Hq + h] : 0.0f;
        if (drop) {
          const uint32_t bh = fa::dropout_bh(b, h, a.dp);
          cw[0] = fa::dropout_col_word(kp + a.dp.k0, bh, a.dp);
          cw[1] = fa::dropout_col_word(kp + 8 + a.dp.k0, bh, a.dp);
        }
      }
      const unsigned char* st = smem + L::stage_off + (s & 1) * L::stage_bytes;
      const unsigned char* q_s = st + L::q_off;
      const unsigned char* do_s = st + L::do_off;
      const float* lse_s = reinterpret_cast<const float*>(st + L::lse_off);
      const float* delta_s = reinterpret_cast<const float*>(st + L::delta_off);
      const uint32_t* rw_s = reinterpret_cast<const uint32_t*>(st + L::rw_off);

      // S^T = K Q^T and dP^T = V dO^T
      float sc[BQ / 8][4], dp[BQ / 8][4];
      P::begin();
      const size_t g_off = wg * L::gk_bytes;
      P::template abt<GK, BQ>(sc, k_s + g_off, kr0, q_s, lane);
      P::template abt<GK, BQ>(dp, v_s + g_off, kr0, do_s, lane);
      P::commit_wait();
      P::settle(sc);
      P::settle(dp);

      // P_drop^T in place of S^T and dS^T in place of dP^T (lv_s as in K2)
      const Live lv_s = make_live(a, sq);
      auto scores = [&](auto masked) {
        constexpr bool MASK = decltype(masked)::value;
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e / 2;
            const int c = j * 8 + (lane % 4) * 2 + e % 2;
            grad_score<MASK, EXTRA>(sc[j][e], dp[j][e], t0 + c, kp + 8 * i,
                                    lse_s[c], delta_s[c],
                                    drop ? rw_s[c] : 0u, cw[i], slope, lv_s,
                                    sq.slq, a);
          }
      };
      if (t0 + BQ <= sq.slq && nk == BK && lv_s.full(t0, BQ, k0, BK))
        scores(std::false_type{});
      else
        scores(std::true_type{});

      // dV += P_drop^T dO and dK += dS^T Q on this warp's columns
      uint32_t pa[BQ / 16][4], da[BQ / 16][4];
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        pack_a<T>(pa[kk], sc[2 * kk], sc[2 * kk + 1]);
        pack_a<T>(da[kk], dp[2 * kk], dp[2 * kk + 1]);
      }
      P::begin();
      P::template ab<BQ, DW>(dv, pa, do_s, d0, lane);
      P::template ab<BQ, DW>(dk, da, q_s, d0, lane);
      P::commit_wait();
    }
    P::settle(dk);
    P::settle(dv);
  }

  T* dkg = static_cast<T*>(a.dk);
  T* dvg = static_cast<T*>(a.dv);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (kp + 8 * i - k0 >= nk) continue;
    const long long row =
        ((sq.k_base + kp + 8 * i) * a.Hk + kvh) * D + d0 + (lane % 4) * 2;
#pragma unroll
    for (int nb = 0; nb < DW / 8; ++nb) {
      *reinterpret_cast<uint32_t*>(dkg + row + nb * 8) =
          pack2<T>(dk[nb][2 * i], dk[nb][2 * i + 1]);
      *reinterpret_cast<uint32_t*>(dvg + row + nb * 8) =
          pack2<T>(dv[nb][2 * i], dv[nb][2 * i + 1]);
    }
  }
}

// ------------------------------------------------ K3 at D 256: dK, dV
//
// At D 256 K3 is a block of two warpgroups over 64 keys of one kv head,
// looping as dkv_kernel does over the `group` q heads and their live q
// tiles, 64 q rows a step (FA3's head-dim-256 backward layout, without its
// dQ atomics: K2 stays a kernel of its own and nothing is summed across
// blocks).  Each product runs once:
//   * S^T = K Q^T and dP^T = V dO^T are wgmmas split between the two
//     warpgroups by q columns, 64 keys x 32 q rows each, with K / V and
//     Q / dO read K-major from 128-byte-swizzled tiles.
//   * The score pass (mask, bias, exp from LSE, dropout, dS with delta)
//     runs on the fragments, and P_drop^T and dS^T, rounded to the input
//     type, go to two 64 x 64 swizzled tiles: one block barrier, and each
//     warpgroup reads all 64 q columns of both.
//   * dV[:, half] += P_drop^T dO[:, half] and dK[:, half] += dS^T Q[:, half]
//     are wgmmas with A from those tiles (K-major) and B read MN-major
//     through the transpose bit; warpgroup w holds D columns [128 w, 128 w
//     + 128) of dK and dV, 128 fp32 registers a thread for the block's
//     life, stored once.
// So a live (q row, key) pair costs 8 * D flops.  Shared memory: K and V
// (64 KB), the two exchange tiles (16 KB) and two stages of Q, dO (64 KB)
// with lse, delta and the dropout row words: 211 KB, one block an SM.

template <typename T>
struct DkvSplitSmem {
  static constexpr int D = 256;
  static constexpr int BK = 64;              // keys a block
  static constexpr int BQ = 64;              // q rows a step
  static constexpr int kThreads = 256;       // two warpgroups
  using P = WgPath<T, D>;
  static constexpr size_t k_off = 0;
  static constexpr size_t v_off = P::template tile_bytes<BK>();
  // P_drop^T and dS^T: BK rows (keys) of BQ values (q), one swizzle atom
  static constexpr size_t xt_bytes = static_cast<size_t>(BK) * BQ * sizeof(T);
  static constexpr size_t pt_off = 2 * v_off;
  static constexpr size_t ds_off = pt_off + xt_bytes;
  static constexpr size_t stage_off = align1k(ds_off + xt_bytes);
  // a stage: the Q and dO tiles, lse, delta and the dropout row words
  static constexpr size_t q_off = 0;
  static constexpr size_t do_off = P::template tile_bytes<BQ>();
  static constexpr size_t lse_off = 2 * do_off;
  static constexpr size_t delta_off = lse_off + sizeof(float) * BQ;
  static constexpr size_t rw_off = delta_off + sizeof(float) * BQ;
  static constexpr size_t stage_bytes = align1k(rw_off + sizeof(uint32_t) * BQ);
  static constexpr size_t bytes = stage_off + 2 * stage_bytes + 1024;
  static_assert(BQ * sizeof(T) == 128, "an exchange row is one swizzle atom");
};

template <typename T, int D, bool kVarlen, bool EXTRA>
__global__ void __launch_bounds__(DkvSplitSmem<T>::kThreads)
    dkv_split_kernel(BwdArgs a) {
  static_assert(D == 256, "K3's split layout is D 256's");
  using L = DkvSplitSmem<T>;
  using P = typename L::P;
  constexpr int BK = L::BK, BQ = L::BQ, NT = L::kThreads;
  constexpr int HQ = BQ / 2;   // q columns of a step a warpgroup computes
  constexpr int HD = D / 2;    // dK / dV columns a warpgroup holds
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = smem_base(smem_raw);
  unsigned char* k_s = smem + L::k_off;
  unsigned char* v_s = smem + L::v_off;
  unsigned char* pt_s = smem + L::pt_off;
  unsigned char* ds_s = smem + L::ds_off;

  // heaviest first, as dkv_kernel
  const int hb = blockIdx.x % (a.Hk * a.B);
  const int kvh = hb % a.Hk;
  const int b = hb / a.Hk;
  const int k0 = static_cast<int>(blockIdx.x) / (a.Hk * a.B) * BK;
  const fa::Seq seq_r = fa::seq_info<kVarlen>(a.seq, b, a.Hq);
  if (kVarlen && k0 >= seq_r.slk) return;  // uniform over the block
  __shared__ fa::Seq seq_s;
  const fa::Seq& sq = block_seq<kVarlen>(seq_r, seq_s);
  const int nk = min(BK, sq.slk - k0);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wg = warp / 4;
  const int kr0 = (warp % 4) * 16;       // this warp's 16 keys
  const int kp = k0 + kr0 + lane / 4;    // this thread's keys: kp, kp + 8
  const int c0 = wg * HQ;                // its warpgroup's q columns
  const int d0 = wg * HD;                // and dK / dV columns
  const Live lv = make_live(a, sq);
  const bool drop = EXTRA && a.dp.enabled;
  // q rows that see any key of this tile: [q_lo, q_hi]
  const int k_last = k0 + nk - 1;
  const int q_lo = lv.wr >= 0 ? max(0, k0 - lv.offs - lv.wr) : 0;
  const int q_hi = lv.wl >= 0 ? min(sq.slq - 1, k_last - lv.offs + lv.wl)
                              : sq.slq - 1;
  const int qt0 = q_lo / BQ;
  const int n_qt = q_hi >= q_lo ? q_hi / BQ - qt0 + 1 : 0;
  const int n_steps = a.group * n_qt;   // (q head, q tile), head-major

  float dk[HD / 8][4] = {}, dv[HD / 8][4] = {};

  auto prefetch = [&](int s) {
    unsigned char* st = smem + L::stage_off + (s & 1) * L::stage_bytes;
    const int h = kvh * a.group + s / n_qt;
    const int t0 = (qt0 + s % n_qt) * BQ;
    load_tile_async<T, D, BQ, P, NT>(st + L::q_off, a.q, sq.q_base + t0,
                                     sq.slq - t0, a.Hq, h);
    load_tile_async<T, D, BQ, P, NT>(st + L::do_off, a.dout, sq.q_base + t0,
                                     sq.slq - t0, a.Hq, h);
    const long long base = sq.lse_index(h, t0);
    float* lse = reinterpret_cast<float*>(st + L::lse_off);
    float* delta = reinterpret_cast<float*>(st + L::delta_off);
    for (int c = threadIdx.x; c < BQ; c += NT) {
      const bool in = t0 + c < sq.slq;
      cp_async4(lse + c, in ? a.lse + base + c : a.lse, in);
      cp_async4(delta + c, in ? a.delta + base + c : a.delta, in);
    }
    cp_async_commit();
    if (drop) {
      uint32_t* rw = reinterpret_cast<uint32_t*>(st + L::rw_off);
      const uint32_t bh = fa::dropout_bh(b, h, a.dp);
      for (int c = threadIdx.x; c < BQ; c += NT)
        rw[c] = fa::dropout_row_word(t0 + c + a.dp.q0, bh, a.dp);
    }
  };

  if (n_steps > 0) {
    load_tile_async<T, D, BK, P, NT>(k_s, a.k, sq.k_base + k0, nk, a.Hk,
                                     kvh);
    load_tile_async<T, D, BK, P, NT>(v_s, a.v, sq.k_base + k0, nk, a.Hk,
                                     kvh);
    prefetch(0);   // one group: K, V and the first Q/dO stage
    const uint32_t sk = smem_u32(k_s), sv = smem_u32(v_s);
    const uint32_t spt = smem_u32(pt_s), sds = smem_u32(ds_s);
    int cur_h = -1;
    float slope = 0.0f;
    uint32_t cw[2] = {0u, 0u};
    for (int s = 0; s < n_steps; ++s) {
      cp_async_wait<0>();
      fence_proxy_async();
      __syncthreads();   // stage s landed for all; stage s + 1 and the
                         // exchange tiles are free
      if (s + 1 < n_steps) prefetch(s + 1);
      const int h = kvh * a.group + s / n_qt;
      const int t0 = (qt0 + s % n_qt) * BQ;
      if (EXTRA && h != cur_h) {
        cur_h = h;
        slope = a.slopes ? a.slopes[b * a.Hq + h] : 0.0f;
        if (drop) {
          const uint32_t bh = fa::dropout_bh(b, h, a.dp);
          cw[0] = fa::dropout_col_word(kp + a.dp.k0, bh, a.dp);
          cw[1] = fa::dropout_col_word(kp + 8 + a.dp.k0, bh, a.dp);
        }
      }
      const unsigned char* st = smem + L::stage_off + (s & 1) * L::stage_bytes;
      const uint32_t sq_s = smem_u32(st + L::q_off);
      const uint32_t sdo_s = smem_u32(st + L::do_off);
      const float* lse_s = reinterpret_cast<const float*>(st + L::lse_off);
      const float* delta_s = reinterpret_cast<const float*>(st + L::delta_off);
      const uint32_t* rw_s = reinterpret_cast<const uint32_t*>(st + L::rw_off);

      // S^T = K Q^T and dP^T = V dO^T on this warpgroup's q columns: the
      // B tiles' rows [c0, c0 + HQ), each 64-column sub-tile BQ rows long
      float sc[HQ / 8][4], dp[HQ / 8][4];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t ao = (kk / 4) * BK * 128 + (kk % 4) * 32;
        const uint32_t bo = (kk / 4) * BQ * 128 + c0 * 128 + (kk % 4) * 32;
        Wgmma<HQ, T>::ss(&sc[0][0], sw128_desc(sk + ao, 0, 1024),
                         sw128_desc(sq_s + bo, 0, 1024), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t ao = (kk / 4) * BK * 128 + (kk % 4) * 32;
        const uint32_t bo = (kk / 4) * BQ * 128 + c0 * 128 + (kk % 4) * 32;
        Wgmma<HQ, T>::ss(&dp[0][0], sw128_desc(sv + ao, 0, 1024),
                         sw128_desc(sdo_s + bo, 0, 1024), kk > 0);
      }
      P::commit_wait();
      P::settle(sc);
      P::settle(dp);

      // P_drop^T in place of S^T and dS^T in place of dP^T (lv_s as in K2)
      const Live lv_s = make_live(a, sq);
      auto scores = [&](auto masked) {
        constexpr bool MASK = decltype(masked)::value;
#pragma unroll
        for (int j = 0; j < HQ / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e / 2;
            const int c = c0 + j * 8 + (lane % 4) * 2 + e % 2;
            grad_score<MASK, EXTRA>(sc[j][e], dp[j][e], t0 + c, kp + 8 * i,
                                    lse_s[c], delta_s[c],
                                    drop ? rw_s[c] : 0u, cw[i], slope, lv_s,
                                    sq.slq, a);
          }
      };
      if (t0 + BQ <= sq.slq && nk == BK && lv_s.full(t0, BQ, k0, BK))
        scores(std::false_type{});
      else
        scores(std::true_type{});

      // this warpgroup's columns of P_drop^T and dS^T, rounded to T, into
      // the exchange tiles (rows: keys)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = kr0 + lane / 4 + 8 * i;
#pragma unroll
        for (int j = 0; j < HQ / 8; ++j) {
          const int off = sw128_chunk<BK>(r, c0 / 8 + j) + (lane % 4) * 4;
          *reinterpret_cast<uint32_t*>(pt_s + off) =
              pack2<T>(sc[j][2 * i], sc[j][2 * i + 1]);
          *reinterpret_cast<uint32_t*>(ds_s + off) =
              pack2<T>(dp[j][2 * i], dp[j][2 * i + 1]);
        }
      }
      fence_proxy_async();
      __syncthreads();   // both warpgroups' columns written

      // dV += P_drop^T dO and dK += dS^T Q on this warpgroup's D columns
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        Wgmma<HD, T>::ss_t(&dv[0][0], sw128_desc(spt + kk * 32, 0, 1024),
                           sw128_desc(sdo_s + (d0 / 64) * BQ * 128 +
                                          kk * 16 * 128,
                                      BQ * 128, 1024),
                           1);
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        Wgmma<HD, T>::ss_t(&dk[0][0], sw128_desc(sds + kk * 32, 0, 1024),
                           sw128_desc(sq_s + (d0 / 64) * BQ * 128 +
                                          kk * 16 * 128,
                                      BQ * 128, 1024),
                           1);
      P::commit_wait();
    }
    P::settle(dk);
    P::settle(dv);
  }

  T* dkg = static_cast<T*>(a.dk);
  T* dvg = static_cast<T*>(a.dv);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (kp + 8 * i - k0 >= nk) continue;
    const long long row =
        ((sq.k_base + kp + 8 * i) * a.Hk + kvh) * D + d0 + (lane % 4) * 2;
#pragma unroll
    for (int nb = 0; nb < HD / 8; ++nb) {
      *reinterpret_cast<uint32_t*>(dkg + row + nb * 8) =
          pack2<T>(dk[nb][2 * i], dk[nb][2 * i + 1]);
      *reinterpret_cast<uint32_t*>(dvg + row + nb * 8) =
          pack2<T>(dv[nb][2 * i], dv[nb][2 * i + 1]);
    }
  }
}

// ---------------------------------------------------------------- launch

// one kernel variant: its entry, dynamic shared memory a block, rows a
// block (key rows in K3, q rows in K2) and threads a block
struct Kernel {
  void (*fn)(BwdArgs);
  int smem;
  int rows;
  int threads;
};

// the variant, its shared-memory limit set on first use
template <bool DKV, bool kVarlen, typename T, int D, bool EXTRA,
          class TN = BwdTune<>>
cudaError_t variant(Kernel* k) {
  if constexpr (DKV && D == 256) {
    k->fn = dkv_split_kernel<T, D, kVarlen, EXTRA>;
    k->smem = static_cast<int>(DkvSplitSmem<T>::bytes);
    k->rows = DkvSplitSmem<T>::BK;
    k->threads = DkvSplitSmem<T>::kThreads;
  } else if constexpr (DKV) {
    k->fn = dkv_kernel<T, D, kVarlen, EXTRA, TN>;
    k->smem = static_cast<int>(DkvSmem<T, D, TN>::bytes);
    k->rows = DkvSmem<T, D, TN>::BK;
    k->threads = Tiles<D, TN>::kDkvThreads;
  } else if constexpr (D == 256) {
    k->fn = dq_split_kernel<T, D, kVarlen, EXTRA>;
    k->smem = static_cast<int>(DqSplitSmem<T>::bytes);
    k->rows = DqSplitSmem<T>::BQ;
    k->threads = DqSplitSmem<T>::kThreads;
  } else {
    k->fn = dq_kernel<T, D, kVarlen, EXTRA, TN>;
    k->smem = static_cast<int>(DqSmem<T, D, TN>::bytes);
    k->rows = DqSmem<T, D, TN>::BQ;
    k->threads = kThreads;
  }
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        k->fn, cudaFuncAttributeMaxDynamicSharedMemorySize, k->smem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  return cudaSuccess;
}

#if !FA_SWEEP
template <bool kVarlen, typename T, int D>
cudaError_t variant_d(bool dkv, bool extra, Kernel* k) {
  if (dkv)
    return extra ? variant<true, kVarlen, T, D, true>(k)
                 : variant<true, kVarlen, T, D, false>(k);
  return extra ? variant<false, kVarlen, T, D, true>(k)
               : variant<false, kVarlen, T, D, false>(k);
}

template <bool kVarlen, typename T>
cudaError_t find_t(bool dkv, bool extra, int D, Kernel* k) {
  switch (D) {
    case 32: return variant_d<kVarlen, T, 32>(dkv, extra, k);
    case 64: return variant_d<kVarlen, T, 64>(dkv, extra, k);
    case 128: return variant_d<kVarlen, T, 128>(dkv, extra, k);
    case 256: return variant_d<kVarlen, T, 256>(dkv, extra, k);
    default: return cudaErrorInvalidValue;
  }
}

// dtype 0 = bf16, 1 = fp16
cudaError_t find_variant(bool dkv, bool varlen, int dtype, bool extra, int D,
                         Kernel* k) {
  if (varlen)
    return dtype == 0 ? find_t<true, __nv_bfloat16>(dkv, extra, D, k)
                      : find_t<true, __half>(dkv, extra, D, k);
  return dtype == 0 ? find_t<false, __nv_bfloat16>(dkv, extra, D, k)
                    : find_t<false, __half>(dkv, extra, D, k);
}
#else
// The sweep's variants of K2 and K3, by id (flash_attn_v100_tpu_torch/
// benchmarks/variants.py's DQ and DKV): dense, bf16, D 128, without bias
// or dropout only.
//   K2 1 bk64     64 keys a step (the shipped 32)
//   K3 1 bq64     64 q rows a step (the shipped 32)
//   K3 2 keys128  128 keys a block, a warpgroup of 4 warps on each 64 (the
//                 shipped 64 keys, one warpgroup)
cudaError_t find_variant(bool dkv, bool varlen, int dtype, bool extra, int D,
                         Kernel* k, int id) {
  using B = __nv_bfloat16;
  if (varlen || dtype != 0 || extra || D != 128)
    return cudaErrorInvalidValue;
  if (!dkv)
    return id == 1 ? variant<false, false, B, 128, false, BwdTune<64>>(k)
                   : cudaErrorInvalidValue;
  switch (id) {
    case 1: return variant<true, false, B, 128, false, BwdTune<0, 64>>(k);
    case 2: return variant<true, false, B, 128, false, BwdTune<0, 0, 2>>(k);
    default: return cudaErrorInvalidValue;
  }
}
#endif

// varlen: a.seq.M / a.seq.N are max_seqlen_q / max_seqlen_k; blocks past
// their sequence leave at once
int launch_kernel(const Kernel& kn, bool dkv, const BwdArgs& a,
                  void* stream) {
  const int tiles = ((dkv ? a.seq.N : a.seq.M) + kn.rows - 1) / kn.rows;
  kn.fn<<<tiles * (dkv ? a.Hk : a.Hq) * a.B, kn.threads, kn.smem,
          static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int launch(bool dkv, bool varlen, int dtype, int D, const BwdArgs& a,
           void* stream, int id = 0) {
  Kernel kn;
  const bool extra = a.mp_.has_alibi || a.mp_.softcap > 0.0f || a.dp.enabled;
#if FA_SWEEP
  cudaError_t e = find_variant(dkv, varlen, dtype, extra, D, &kn, id);
#else
  (void)id;
  cudaError_t e = find_variant(dkv, varlen, dtype, extra, D, &kn);
#endif
  if (e != cudaSuccess) return static_cast<int>(e);
  return launch_kernel(kn, dkv, a, stream);
}

void set_common(BwdArgs* a, const void* q, const void* k, const void* v,
                const void* dout, const float* lse, const float* delta,
                const float* slopes, void* dq, void* dk, void* dv, int B,
                int Hq, int Hk, float scale, int causal, int window_left,
                int window_right, float softcap, int has_alibi, int dropout,
                unsigned int seed_lo, unsigned int seed_hi,
                unsigned int threshold, float drop_scale) {
  a->q = q; a->k = k; a->v = v; a->dout = dout; a->lse = lse;
  a->delta = delta; a->slopes = has_alibi ? slopes : nullptr;
  a->dq = dq; a->dk = dk; a->dv = dv;
  a->B = B; a->Hq = Hq; a->Hk = Hk; a->group = Hq / Hk; a->scale = scale;
  a->mp_.causal = causal; a->mp_.window_left = window_left;
  a->mp_.window_right = window_right; a->mp_.softcap = softcap;
  a->mp_.has_alibi = has_alibi;
  a->dp.enabled = dropout; a->dp.seed_lo = seed_lo; a->dp.seed_hi = seed_hi;
  a->dp.threshold = threshold; a->dp.scale = drop_scale;
}

int dense_launch(bool dkv, int dtype, const void* q, const void* k,
                 const void* v, const void* dout, const float* lse,
                 const float* delta, const float* slopes, void* dq, void* dk,
                 void* dv, int B, int M, int N, int Hq, int Hk, int D,
                 int offset, float scale, int causal, int window_left,
                 int window_right, float softcap, int has_alibi, int dropout,
                 unsigned int seed_lo, unsigned int seed_hi,
                 unsigned int threshold, float drop_scale, int q0, int k0,
                 int b0, int h0, int num_heads, void* stream, int id = 0) {
  if (Hk <= 0 || Hq % Hk != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || Hq == 0 || (dkv ? N : M) == 0) return 0;
  BwdArgs a = {};
  set_common(&a, q, k, v, dout, lse, delta, slopes, dq, dk, dv, B, Hq, Hk,
             scale, causal, window_left, window_right, softcap, has_alibi,
             dropout, seed_lo, seed_hi, threshold, drop_scale);
  a.seq.M = M; a.seq.N = N; a.seq.offset = offset;
  a.dp.q0 = q0; a.dp.k0 = k0; a.dp.b0 = b0; a.dp.h0 = h0;
  a.dp.num_heads = num_heads;
  return launch(dkv, false, dtype, D, a, stream, id);
}

#if !FA_SWEEP
int varlen_launch(bool dkv, int dtype, const void* q, const void* k,
                  const void* v, const void* dout, const float* lse,
                  const float* delta, const float* slopes, void* dq,
                  void* dk, void* dv, const int* cu_q, const int* cu_k,
                  const int* seqused_k, const int* leftpad_k, int B, int Tq,
                  int max_seqlen_q, int max_seqlen_k, int Hq, int Hk, int D,
                  float scale, int causal, int window_left, int window_right,
                  float softcap, int has_alibi, int dropout,
                  unsigned int seed_lo, unsigned int seed_hi,
                  unsigned int threshold, float drop_scale, void* stream) {
  if (Hk <= 0 || Hq % Hk != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || Hq == 0 || (dkv ? max_seqlen_k : max_seqlen_q) <= 0)
    return 0;
  BwdArgs a = {};
  set_common(&a, q, k, v, dout, lse, delta, slopes, dq, dk, dv, B, Hq, Hk,
             scale, causal, window_left, window_right, softcap, has_alibi,
             dropout, seed_lo, seed_hi, threshold, drop_scale);
  a.seq.M = max_seqlen_q; a.seq.N = max_seqlen_k; a.seq.Tq = Tq;
  a.seq.cu_q = cu_q; a.seq.cu_k = cu_k; a.seq.seqused_k = seqused_k;
  a.seq.leftpad_k = leftpad_k;
  // dropout keyed as K5 keys it: (within-sequence q position,
  // leftpad-relative key position, bh = b * Hq + h)
  a.dp.num_heads = Hq;
  return launch(dkv, true, dtype, D, a, stream);
}

#endif

// out[0] resident blocks a multiprocessor, out[1] dynamic shared memory a
// block (bytes), out[2] threads a block, out[3] registers a thread, out[4]
// local memory a thread (bytes: spills and stack)
int occupancy(const Kernel& kn, int* out) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, kn.fn);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[1] = kn.smem;
  out[2] = kn.threads;
  out[3] = attr.numRegs;
  out[4] = static_cast<int>(attr.localSizeBytes);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, kn.fn, kn.threads, kn.smem));
}

#if !FA_SWEEP
int occupancy(bool dkv, bool varlen, int dtype, int D, int extra, int* out) {
  Kernel kn;
  cudaError_t e = find_variant(dkv, varlen, dtype, extra != 0, D, &kn);
  return e != cudaSuccess ? static_cast<int>(e) : occupancy(kn, out);
}
#endif

}  // namespace

#define FA_BWD_PARAMS                                                        \
  int dtype, const void *q, const void *k, const void *v, const void *dout,  \
      const float *lse, const float *delta, const float *slopes, void *dq,   \
      void *dk, void *dv, int B, int M, int N, int Hq, int Hk, int D,         \
      int offset, float scale, int causal, int window_left, int window_right, \
      float softcap, int has_alibi, int dropout, unsigned int seed_lo,        \
      unsigned int seed_hi, unsigned int threshold, float drop_scale, int q0, \
      int k0, int b0, int h0, int num_heads, void *stream
#define FA_BWD_ARGS                                                          \
  dtype, q, k, v, dout, lse, delta, slopes, dq, dk, dv, B, M, N, Hq, Hk, D,  \
      offset, scale, causal, window_left, window_right, softcap, has_alibi,  \
      dropout, seed_lo, seed_hi, threshold, drop_scale, q0, k0, b0, h0,      \
      num_heads, stream
#define FA_VARLEN_BWD_PARAMS                                                 \
  int dtype, const void *q, const void *k, const void *v, const void *dout,  \
      const float *lse, const float *delta, const float *slopes, void *dq,   \
      void *dk, void *dv, const int *cu_q, const int *cu_k,                   \
      const int *seqused_k, const int *leftpad_k, int B, int Tq,             \
      int max_seqlen_q, int max_seqlen_k, int Hq, int Hk, int D, float scale, \
      int causal, int window_left, int window_right, float softcap,          \
      int has_alibi, int dropout, unsigned int seed_lo, unsigned int seed_hi, \
      unsigned int threshold, float drop_scale, void *stream
#define FA_VARLEN_BWD_ARGS                                                   \
  dtype, q, k, v, dout, lse, delta, slopes, dq, dk, dv, cu_q, cu_k,          \
      seqused_k, leftpad_k, B, Tq, max_seqlen_q, max_seqlen_k, Hq, Hk, D,    \
      scale, causal, window_left, window_right, softcap, has_alibi, dropout, \
      seed_lo, seed_hi, threshold, drop_scale, stream

#if !FA_SWEEP
// dtype: 0 = bf16, 1 = fp16.  Each returns cudaGetLastError() of its launch.
// K2 writes dq (dk, dv unused); K3 writes dk and dv (dq unused).
extern "C" int fa_dq_launch(FA_BWD_PARAMS) {
  return dense_launch(false, FA_BWD_ARGS);
}
extern "C" int fa_dkv_launch(FA_BWD_PARAMS) {
  return dense_launch(true, FA_BWD_ARGS);
}

// K6 writes dq (dk, dv unused); K7 writes dk and dv (dq unused).  cu_q and
// cu_k are (B + 1,), seqused_k / leftpad_k (B,) or null; the grids cover
// max_seqlen_q rows (K6) or max_seqlen_k keys (K7) of each sequence.
extern "C" int fa_varlen_dq_launch(FA_VARLEN_BWD_PARAMS) {
  return varlen_launch(false, FA_VARLEN_BWD_ARGS);
}
extern "C" int fa_varlen_dkv_launch(FA_VARLEN_BWD_PARAMS) {
  return varlen_launch(true, FA_VARLEN_BWD_ARGS);
}

// The occupancy of K2 (dkv 0) or K3 (dkv 1) for (dtype, D), in the variant
// without bias and dropout (extra 0) or with (extra 1): out[0] resident
// blocks a multiprocessor, out[1] dynamic shared memory a block (bytes),
// out[2] threads a block, out[3] registers a thread, out[4] local memory a
// thread (bytes: spills and stack).  Returns a cudaError_t.
extern "C" int fa_bwd_occupancy(int dkv, int dtype, int D, int extra,
                                int* out) {
  return occupancy(dkv != 0, false, dtype, D, extra, out);
}

// The same for K6 (dkv 0) or K7 (dkv 1), the varlen instantiation.
extern "C" int fa_varlen_bwd_occupancy(int dkv, int dtype, int D, int extra,
                                       int* out) {
  return occupancy(dkv != 0, true, dtype, D, extra, out);
}
#else
// The sweep library's entries: the shipped entries' arguments after the
// variant's id (find_variant above), and a variant's occupancy.
extern "C" int fa_dq_sweep_launch(int id, FA_BWD_PARAMS) {
  return dense_launch(false, FA_BWD_ARGS, id);
}
extern "C" int fa_dkv_sweep_launch(int id, FA_BWD_PARAMS) {
  return dense_launch(true, FA_BWD_ARGS, id);
}
extern "C" int fa_bwd_sweep_occupancy(int dkv, int id, int* out) {
  Kernel kn;
  cudaError_t e = find_variant(dkv != 0, false, 0, false, 128, &kn, id);
  return e != cudaSuccess ? static_cast<int>(e) : occupancy(kn, out);
}
#endif
