// K2 (dQ) and K3 (dK, dV), dense, and K6 / K7, packed varlen, over fp32
// inputs: the attention backward for Hopper (sm_90a), one fp32 body of each
// kernel instantiated for both kinds of sequence (csrc/seq.cuh), as
// csrc/bwd.cu is for 16-bit inputs.
//
// Replaces, for fp32 inputs, flash_attn_v100_tpu/ops/pallas/bwd.py::
// _dq_kernel (K2) and ::_dkv_kernel (K3), and flash_attn_v100_tpu/ops/
// pallas/varlen.py::_varlen_dq_kernel (K6) and ::_varlen_dkv_kernel (K7).
// The contracts are csrc/bwd.cu's: the same arguments; lse clamped to
// >= NEG_INF and delta = rowsum(O * dO) - dlse from the caller; per score
//     P      = exp(min(S - lse, 0)) where the position is valid, else 0
//     P_drop = keep ? P / (1 - p) : 0
//     dS     = (P_drop * dO.V^T - P * delta) * scale  [* (1 - (S/cap)^2)]
// dQ = dS K, dK = dS^T Q (summed over the group of q heads of a kv head),
// dV = P_drop^T dO, all in fp32.  Rows and keys no block covers are left to
// the caller.
//
// What bounds them on this card: operations.  dQ does 6 * D flops per live
// (q row, key) pair and dK / dV 8 * D, against operand bytes read once per
// tile.  All four run their products as 3 x TF32 split products on the
// tensor cores (csrc/f32_tiles.cuh: a ceiling of 164.9 TFLOP/s against
// FFMA's 66.9): TF32 wgmma in K2 / K6 at D 32 / 64, TF32 mma.sync m16n8k8
// elsewhere, every operand split into TF32 hi / lo parts (wgmma's shared
// tiles once a block, register fragments as they are read).
//
// What the design does about it (the FlashAttention-2 split):
//   * K2 is q-centric: one block per (q tile, q head, sequence) holding Q
//     and dO, dQ in registers, over the key tiles its rows' intervals
//     touch.  At D 32 / 64 two warpgroups over 128 q rows, 64 keys a step:
//     each landed K / V tile is split once into swizzled K-major hi / lo
//     tiles (K, V and K^T) that S = Q K^T, dP = dO V^T and dQ += dS K read
//     on wgmma, Q, dO and dS split in registers (dq_wg).  At D 128 / 256 8
//     warps of 16 q rows (at 256 two a 16-row group with half of dQ's
//     columns each), 16 keys a step, mma.sync with K and V as B fragments
//     read from rows of D + 4 floats (dq_sync).  Either way dS stays in
//     registers as the A operand of dQ += dS K, and dQ takes a step's
//     products (two key k-steps on mma.sync) into a zeroed accumulator
//     added in fp32.
//   * K3 is key-centric: one block per (key tile, kv head, sequence)
//     holding K and V, W warps of 16 keys each (4 warps, 64 keys at D 32 /
//     64; 8 warps, 128 keys at D 128; at D 256 8 warps, two a 16-key group
//     with half of dK / dV's columns each, 64 keys), dK and dV in
//     registers, over the group's q heads and, for each, the q tiles (64
//     rows at D 32, 32 at 64, 16 at 128 / 256) whose intervals reach its
//     keys.  S^T = K Q^T and dP^T = V dO^T take K and V as A and Q, dO as
//     B; P_drop^T and dS^T stay in registers as the A operands of dV +=
//     P_drop^T dO and dK += dS^T Q, whose B fragments are read from the
//     row-major Q and dO tiles.  dK and dV take two q-row steps at a time
//     into zeroed fragments added in fp32.
//   * The tensor cores' accumulation truncates: an accumulator that lives
//     across steps (dQ, dK, dV) takes its products in short chains
//     (f32_tiles.cuh flush), in one fixed order.
//   * The streamed operands (K2: K, V and the dropout column words; K3: Q,
//     dO, lse, delta and both dropout words of the step's head) run
//     through cp.async (a two-stage ring; K2 at D 32 / 64 one raw stage,
//     free once split), the next tile copied while this one is computed.
//   * Nothing is summed across blocks: each output element belongs to one
//     block (one warp), which adds its terms in a fixed order, so two
//     calls are bitwise equal, and K6 / K7, the varlen instantiations,
//     give each sequence K2's / K3's bits on it alone.  Shared memory of a
//     block (K2 at D 32 / 64: the split tiles, Q, dO, the raw stage; at
//     128 / 256: Q, dO, two stages of K, V; K3: K, V, two stages of Q, dO):
//         D     K2       K3
//         32    104 KB   57 KB
//         64    200 KB   71 KB
//         128   169 KB   170 KB
//         256   200 KB   201 KB
#include <math.h>

#include <type_traits>

#include "attn_tiles.cuh"
#include "f32_tiles.cuh"
#include "masks.cuh"
#include "philox.cuh"
#include "seq.cuh"

namespace {

using fa::attn::Live;
using namespace fa::f32;

constexpr int kF32 = 2;   // the wrappers' dtype code of fp32

struct Args {
  const float* q;         // dense (B, M, Hq, D); varlen (Tq, Hq, D)
  const float* k;         // dense (B, N, Hk, D); varlen (Tk, Hk, D)
  const float* v;
  const float* dout;      // q's shape
  const float* lse;       // dense (B, Hq, M); varlen (Hq, Tq); >= NEG_INF
  const float* delta;     // lse's shape
  const float* slopes;    // (B, Hq) or nullptr
  float* dq;              // q's shape
  float* dk;              // k's shape
  float* dv;
  fa::SeqArgs seq;
  int B, Hq, Hk, group;
  float scale;
  fa::MaskParams mp;
  fa::DropoutParams dp;
};

// One score: s holds S (raw q.k) on entry and P_drop on return, dp holds
// dO.V^T on entry and dS on return; `live` says whether the position is
// valid
__device__ __forceinline__ void grad_score(float& s, float& dp, int qp,
                                           int kp, bool live, float lse,
                                           float delta, uint32_t rw,
                                           uint32_t cw, float slope, int offs,
                                           const Args& a) {
  const float sb = fa::score_bias(s, qp + offs, kp, a.scale, slope, a.mp);
  const float p = live ? expf(fminf(sb - lse, 0.0f)) : 0.0f;
  float pd = p;
  if (a.dp.enabled) pd = fa::dropout_keep(rw, cw, a.dp) ? p * a.dp.scale : 0.0f;
  float ds = (pd * dp - p * delta) * a.scale;
  if (a.mp.softcap > 0.0f) {
    const float sn = sb * (1.0f / a.mp.softcap);
    ds *= 1.0f - sn * sn;
  }
  s = pd;
  dp = ds;
}

// a compiler barrier: the fragments of dK / dV's next column block are
// read after this one's products, so ptxas does not hoist the reads of
// every block ahead (which took K3 past 255 registers into local memory)
__device__ __forceinline__ void pin() { asm volatile("" ::: "memory"); }

__device__ __forceinline__ Live make_live(const Args& a, const fa::Seq& sq) {
  return Live{sq.slk, sq.offs, a.mp.window_left,
              a.mp.effective_window_right()};
}

// row r of a (rows, H, D) tensor at packed row row0 + r, head h, or null
// at r >= n
__device__ __forceinline__ const float* packed_row(const float* base,
                                                   long long row0, int r,
                                                   int n, int H, int h,
                                                   int D) {
  return r < n ? base + ((row0 + r) * H + h) * static_cast<long long>(D)
               : nullptr;
}

// ------------------------------------------------------------------ K2 / K6

// K2 / K6 on warpgroup products, D 32 / 64: two warpgroups over 128 q rows,
// 64 keys a step landing in one raw stage while the step before is
// computed.  Each landed tile is split once per block (split_kvk) into
// 128-byte-swizzled K-major TF32 hi / lo tiles: K and V as they are (the B
// of S = Q K^T and dP = dO V^T) and K transposed, its keys ordered as dS's
// A fragment reads them (the B of dQ += dS K; TF32 wgmma reads no
// MN-major operand).  S and dP are three wgmma m64n64k8 .tf32 a k-step,
// Q's and dO's A fragments split in registers as they are read; dQ three
// m64nDk8 a key k-step with dS's A fragments made from dP's accumulators,
// into a zeroed accumulator added to dQ in fp32.  Shared memory a block
// (the six split tiles, Q, dO, the raw stage, the dropout words): D 32
// 104 KB, 64 200 KB.
template <int D>
struct DqWgCfg {
  static constexpr int BQ = 128;
  static constexpr int BK = 64;
  static constexpr int NT = 256;
  static constexpr int LD = D + 4;
  static constexpr int kTile = BK * D * 4;   // bytes of one split tile
  static constexpr int q_off = 6 * kTile;
  static constexpr int do_off = q_off + BQ * LD * 4;
  static constexpr int kv_off = do_off + BQ * LD * 4;
  static constexpr int cw_off = kv_off + 2 * BK * LD * 4;
  static constexpr size_t bytes = cw_off + 2 * BK * 4 + 1024;
};

// The raw K / V tile (BK rows of D floats, row stride LD) split for wgmma:
// K's and V's row r into the K-major hi / lo tiles 0-3 (BK rows of D), and
// K's row r into column pos(r) of the K-major K^T hi / lo tiles 4-5 (D rows
// of BK keys), pos ordering each 8 keys 0, 2, 4, 6, 1, 3, 5, 7: dS's A
// fragment, made from dP's C fragment (frag_a_c), reads key 2c as its k =
// c and key 2c + 1 as k = c + 4.
template <int D, int BK, int LD, int NT>
__device__ __forceinline__ void split_kvk(unsigned char* t, const float* kr,
                                          const float* vr) {
  constexpr int C = D / 4, kTile = BK * D * 4;
  for (int idx = threadIdx.x; idx < 2 * BK * C; idx += NT) {
    const int m = idx / (BK * C);   // 0: K, 1: V
    const int r = idx / C % BK, u = idx % C;   // a warp along a row
    const float4 x =
        *reinterpret_cast<const float4*>((m ? vr : kr) + r * LD + 4 * u);
    uint32_t h[4], l[4];
    split(x.x, h[0], l[0]);
    split(x.y, h[1], l[1]);
    split(x.z, h[2], l[2]);
    split(x.w, h[3], l[3]);
    const int off = fa::sm90::sw128_chunk<BK>(r, u);
    *reinterpret_cast<uint4*>(t + 2 * m * kTile + off) =
        make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(t + (2 * m + 1) * kTile + off) =
        make_uint4(l[0], l[1], l[2], l[3]);
  }
  for (int idx = threadIdx.x; idx < BK * C; idx += NT) {
    const int r = idx % BK, u = idx / BK;   // a warp along K's keys
    const float4 x = *reinterpret_cast<const float4*>(kr + r * LD + 4 * u);
    const int pos = (r & ~7) | ((r & 1) << 2) | ((r & 7) >> 1);
    const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      uint32_t h, l;
      split(xs[e], h, l);
      const int off =
          fa::sm90::sw128_chunk<D>(4 * u + e, pos / 4) + (pos % 4) * 4;
      *reinterpret_cast<uint32_t*>(t + 4 * kTile + off) = h;
      *reinterpret_cast<uint32_t*>(t + 5 * kTile + off) = l;
    }
  }
}

template <int D, bool VARLEN>
__device__ __forceinline__ void dq_wg(const Args& a) {
  using C = DqWgCfg<D>;
  constexpr int BQ = C::BQ, BK = C::BK, NT = C::NT, LD = C::LD;
  constexpr int NB = BK / 8, DB = D / 8;   // n-blocks of S, of dQ
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = fa::attn::smem_base(smem_raw);
  float* q_s = reinterpret_cast<float*>(base + C::q_off);
  float* do_s = reinterpret_cast<float*>(base + C::do_off);
  float* k_raw = reinterpret_cast<float*>(base + C::kv_off);
  float* v_raw = k_raw + BK * LD;
  uint32_t* cw_s = reinterpret_cast<uint32_t*>(base + C::cw_off);
  const uint32_t split_s = fa::sm90::smem_u32(base);   // wgmma's tiles

  // heaviest first: q tiles from the last
  const int n_tiles = (a.seq.M + BQ - 1) / BQ;
  const int hb = blockIdx.x % (a.Hq * a.B);
  const int h = hb % a.Hq;
  const int b = hb / a.Hq;
  const int qp0 =
      (n_tiles - 1 - static_cast<int>(blockIdx.x) / (a.Hq * a.B)) * BQ;
  const fa::Seq sq = fa::seq_info<VARLEN>(a.seq, b, a.Hq);
  if (qp0 >= sq.slq) return;   // uniform over the block
  const int nq = min(BQ, sq.slq - qp0);
  const int kvh = h / a.group;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int r0 = 16 * warp;   // the warp's rows in the tile
  const Live lv = make_live(a, sq);
  const float slope = a.slopes ? a.slopes[b * a.Hq + h] : 0.0f;
  const uint32_t bh = fa::dropout_bh(b, h, a.dp);
  int qp[2];
  float lse[2], delta[2];
  uint32_t rw[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    qp[i] = qp0 + r0 + lane / 4 + 8 * i;
    const bool in = qp[i] < sq.slq;
    lse[i] = in ? a.lse[sq.lse_index(h, qp[i])] : 0.0f;
    delta[i] = in ? a.delta[sq.lse_index(h, qp[i])] : 0.0f;
    rw[i] = a.dp.enabled ? fa::dropout_row_word(qp[i] + a.dp.q0, bh, a.dp)
                         : 0u;
  }
  const int blk_lo = lv.key_lo(qp0);
  const int blk_hi = lv.key_hi(qp0 + nq - 1);
  const int n_steps = blk_hi >= blk_lo ? (blk_hi - blk_lo) / BK + 1 : 0;

  // tile t's K and V into the raw stage, its dropout words into stage t & 1
  auto copy_kv = [&](int t) {
    const int k0 = blk_lo + t * BK;
    const int n = min(BK, blk_hi - k0 + 1);
    load_rows<D, BK, NT>(k_raw, a.k, [&](int r) {
      return packed_row(a.k, sq.k_base + k0, r, n, a.Hk, kvh, D);
    });
    load_rows<D, BK, NT>(v_raw, a.v, [&](int r) {
      return packed_row(a.v, sq.k_base + k0, r, n, a.Hk, kvh, D);
    });
    if (a.dp.enabled)
      for (int c = threadIdx.x; c < BK; c += NT)
        cw_s[(t & 1) * BK + c] =
            fa::dropout_col_word(k0 + c + a.dp.k0, bh, a.dp);
  };

  // dQ: the warp's rows g, g + 8 x columns 8 n + 2c, + 1
  float dq[DB][4];
#pragma unroll
  for (int n = 0; n < DB; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.0f;
  if (n_steps > 0) {
    load_rows<D, BQ, NT>(q_s, a.q, [&](int r) {
      return packed_row(a.q, sq.q_base + qp0, r, nq, a.Hq, h, D);
    });
    load_rows<D, BQ, NT>(do_s, a.dout, [&](int r) {
      return packed_row(a.dout, sq.q_base + qp0, r, nq, a.Hq, h, D);
    });
    copy_kv(0);
    cp_async_commit();
    for (int s = 0; s < n_steps; ++s) {
      cp_async_wait<0>();
      // tile s landed; the split tiles of tile s - 1 are free (each
      // warpgroup past its waits)
      __syncthreads();
      split_kvk<D, BK, LD, NT>(base, k_raw, v_raw);
      fa::sm90::fence_proxy_async();   // visible to wgmma
      __syncthreads();   // split; the raw stage is free
      if (s + 1 < n_steps) copy_kv(s + 1);
      cp_async_commit();
      const uint32_t* cw = cw_s + (s & 1) * BK;
      const int k0 = blk_lo + s * BK;
      // S = Q K^T and dP = dO V^T, 3 x TF32
      float sc[NB][4], dp[NB][4];
      s_wgmma<D, BK, LD>(sc, q_s, r0, split_s, split_s + C::kTile, lane);
      s_wgmma<D, BK, LD>(dp, do_s, r0, split_s + 2 * C::kTile,
                         split_s + 3 * C::kTile, lane);
      // P_drop into sc, dS into dp
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < NB; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kl = 8 * j + 2 * (lane % 4) + e, kp = k0 + kl;
            grad_score(sc[j][2 * i + e], dp[j][2 * i + e], qp[i], kp,
                       qp[i] < sq.slq && lv.valid(qp[i], kp), lse[i],
                       delta[i], rw[i], cw[kl], slope, sq.offs, a);
          }
      // dQ += dS K: the step's products into a zeroed accumulator, then
      // added in fp32
      float dt[DB][4];
      pv_wgmma<D, BK>(dt, dp, split_s + 4 * C::kTile,
                      split_s + 5 * C::kTile);
#pragma unroll
      for (int n = 0; n < DB; ++n) flush(dq[n], dt[n]);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (qp[i] >= sq.slq) continue;
    const long long row = ((sq.q_base + qp[i]) * a.Hq + h) *
                          static_cast<long long>(D) + 2 * (lane % 4);
#pragma unroll
    for (int n = 0; n < DB; ++n)
      *reinterpret_cast<float2*>(a.dq + row + 8 * n) =
          make_float2(dq[n][2 * i], dq[n][2 * i + 1]);
  }
}

// K2 / K6 on warp products, D 128 / 256: 8 warps, each 16 q rows and DW
// columns of their dQ (at D 256 two warps share 16 rows, one half of the
// columns each), 16 keys a step through a two-stage ring; mma.sync
// m16n8k8 .tf32, every operand split in registers as its fragment is read
// (rows of D + 4 floats: no bank conflicts), dS from the registers of dP,
// dQ taking two key k-steps at a time from a zeroed fragment.  (32 keys a
// step at D 128 took ptxas past 255 registers into local memory; the
// warpgroup body above, with one warpgroup at D 128, was 20% slower.)
// Shared memory a block (Q, dO, two stages of K, V): D 128 169 KB, 256
// 200 KB.
template <int D>
struct DqSyncCfg {
  static constexpr int W = 8;
  static constexpr int DW = D <= 128 ? D : 128;
  static constexpr int BQ = 16 * W / (D / DW);   // q rows a block
  static constexpr int BK = 16;                   // keys a step
  static constexpr int NT = 32 * W;
  static constexpr int LD = D + 4;
  // floats: Q, dO, two stages of (K, V), two stages of column words
  static constexpr int do_off = BQ * LD;
  static constexpr int kv_off = 2 * BQ * LD;
  static constexpr int cw_off = kv_off + 4 * BK * LD;
  static constexpr size_t bytes = (cw_off + 2 * BK) * sizeof(float);
};

template <int D, bool VARLEN>
__device__ __forceinline__ void dq_sync(const Args& a) {
  using C = DqSyncCfg<D>;
  constexpr int BQ = C::BQ, BK = C::BK, NT = C::NT, LD = C::LD, DW = C::DW;
  constexpr int NB = BK / 8, DB = DW / 8;   // n-blocks of S, of dQ
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;
  float* do_s = smem + C::do_off;
  uint32_t* cw_s = reinterpret_cast<uint32_t*>(smem + C::cw_off);
  auto k_s = [&](int t) { return smem + C::kv_off + (t & 1) * 2 * BK * LD; };
  auto v_s = [&](int t) { return k_s(t) + BK * LD; };

  // heaviest first: q tiles from the last
  const int n_tiles = (a.seq.M + BQ - 1) / BQ;
  const int hb = blockIdx.x % (a.Hq * a.B);
  const int h = hb % a.Hq;
  const int b = hb / a.Hq;
  const int qp0 =
      (n_tiles - 1 - static_cast<int>(blockIdx.x) / (a.Hq * a.B)) * BQ;
  const fa::Seq sq = fa::seq_info<VARLEN>(a.seq, b, a.Hq);
  if (qp0 >= sq.slq) return;
  const int nq = min(BQ, sq.slq - qp0);
  const int kvh = h / a.group;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int r0 = 16 * (warp / (D / DW));   // the warp's rows in the tile
  const int c0 = DW * (warp % (D / DW));   // and its dQ columns
  const Live lv = make_live(a, sq);
  const float slope = a.slopes ? a.slopes[b * a.Hq + h] : 0.0f;
  const uint32_t bh = fa::dropout_bh(b, h, a.dp);
  // this thread's rows: qp0 + r0 + lane / 4 + 8 i
  int qp[2];
  float lse[2], delta[2];
  uint32_t rw[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    qp[i] = qp0 + r0 + lane / 4 + 8 * i;
    const bool in = qp[i] < sq.slq;
    lse[i] = in ? a.lse[sq.lse_index(h, qp[i])] : 0.0f;
    delta[i] = in ? a.delta[sq.lse_index(h, qp[i])] : 0.0f;
    rw[i] = a.dp.enabled ? fa::dropout_row_word(qp[i] + a.dp.q0, bh, a.dp)
                         : 0u;
  }
  const int blk_lo = lv.key_lo(qp0);
  const int blk_hi = lv.key_hi(qp0 + nq - 1);
  const int n_steps = blk_hi >= blk_lo ? (blk_hi - blk_lo) / BK + 1 : 0;

  auto copy_kv = [&](int t) {
    const int k0 = blk_lo + t * BK;
    const int n = min(BK, blk_hi - k0 + 1);
    load_rows<D, BK, NT>(k_s(t), a.k, [&](int r) {
      return packed_row(a.k, sq.k_base + k0, r, n, a.Hk, kvh, D);
    });
    load_rows<D, BK, NT>(v_s(t), a.v, [&](int r) {
      return packed_row(a.v, sq.k_base + k0, r, n, a.Hk, kvh, D);
    });
    if (a.dp.enabled)
      for (int c = threadIdx.x; c < BK; c += NT)
        cw_s[(t & 1) * BK + c] =
            fa::dropout_col_word(k0 + c + a.dp.k0, bh, a.dp);
  };

  // dQ: the warp's rows g, g + 8 x columns c0 + 8 n + 2c, + 1
  float dq[DB][4];
#pragma unroll
  for (int n = 0; n < DB; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.0f;
  if (n_steps > 0) {
    load_rows<D, BQ, NT>(q_s, a.q, [&](int r) {
      return packed_row(a.q, sq.q_base + qp0, r, nq, a.Hq, h, D);
    });
    load_rows<D, BQ, NT>(do_s, a.dout, [&](int r) {
      return packed_row(a.dout, sq.q_base + qp0, r, nq, a.Hq, h, D);
    });
    copy_kv(0);
    cp_async_commit();
    for (int s = 0; s < n_steps; ++s) {
      cp_async_wait<0>();
      __syncthreads();   // tile s landed; tile s - 1's stage is free
      if (s + 1 < n_steps) copy_kv(s + 1);
      cp_async_commit();
      const float* kt = k_s(s);
      const float* vt = v_s(s);
      const uint32_t* cw = cw_s + (s & 1) * BK;
      const int k0 = blk_lo + s * BK;
      // S = Q K^T and dP = dO V^T (q rows x keys), 3 x TF32
      float sc[NB][4], dp[NB][4];
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.0f;
#pragma unroll 1
      for (int kk = 0; kk < D; kk += 8) {
        FragA fq, fd;
        frag_a<LD>(fq, q_s, r0, kk, lane);
        frag_a<LD>(fd, do_s, r0, kk, lane);
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          FragB fk, fv;
          frag_b_k<LD>(fk, kt, 8 * j, kk, lane);
          frag_b_k<LD>(fv, vt, 8 * j, kk, lane);
          mma3(sc[j], fq, fk);
          mma3(dp[j], fd, fv);
        }
      }
      // P_drop into sc, dS into dp
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < NB; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kl = 8 * j + 2 * (lane % 4) + e, kp = k0 + kl;
            grad_score(sc[j][2 * i + e], dp[j][2 * i + e], qp[i], kp,
                       qp[i] < sq.slq && lv.valid(qp[i], kp), lse[i],
                       delta[i], rw[i], cw[kl], slope, sq.offs, a);
          }
      // dQ += dS K: A from the registers of dS, kG key k-steps into zeroed
      // fragments, then added in fp32
#pragma unroll
      for (int j = 0; j < NB; j += kG) {
        FragA fs[kG];
#pragma unroll
        for (int g = 0; g < kG; ++g) frag_a_c(fs[g], dp[j + g]);
#pragma unroll
        for (int n = 0; n < DB; ++n) {
          float t[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
          for (int g = 0; g < kG; ++g) {
            FragB fk;
            frag_b_mn<LD>(fk, kt, 8 * (j + g), c0 + 8 * n, lane);
            mma3(t, fs[g], fk);
          }
          flush(dq[n], t);
          pin();
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (qp[i] >= sq.slq) continue;
    const long long row = ((sq.q_base + qp[i]) * a.Hq + h) *
                          static_cast<long long>(D) + c0 + 2 * (lane % 4);
#pragma unroll
    for (int n = 0; n < DB; ++n)
      *reinterpret_cast<float2*>(a.dq + row + 8 * n) =
          make_float2(dq[n][2 * i], dq[n][2 * i + 1]);
  }
}

// the body by head dim: warpgroup products at D 32 / 64, warp products at
// 128 / 256 (one kernel name, so the SASS tables find K2 at every D)
template <int D>
using DqCfg = typename std::conditional<D <= 64, DqWgCfg<D>,
                                        DqSyncCfg<D>>::type;

template <int D, bool VARLEN>
__global__ void __launch_bounds__(DqCfg<D>::NT, 1)
    dq_f32_kernel(const Args a) {
  if constexpr (D <= 64)
    dq_wg<D, VARLEN>(a);
  else
    dq_sync<D, VARLEN>(a);
}

// ------------------------------------------------------------------ K3 / K7

template <int D>
struct DkvCfg {
  // warps a block; each owns 16 keys and DW columns of their dK / dV (at
  // D 256 two warps share 16 keys, one half of the columns each)
  static constexpr int W = D == 128 || D == 256 ? 8 : 4;
  static constexpr int DW = D <= 128 ? D : 128;
  static constexpr int BK = 16 * W / (D / DW);    // keys a block
  static constexpr int BQ = D == 32 ? 64 : (D == 64 ? 32 : 16);  // q rows
  static constexpr int NT = 32 * W;
  static constexpr int LD = D + 4;
  // a stage (floats): Q, dO, then lse, delta and the row words of its BQ
  // rows, the column words of the block's BK keys for its head
  static constexpr int st_do = BQ * LD;
  static constexpr int st_lse = 2 * BQ * LD;
  static constexpr int st_delta = st_lse + BQ;
  static constexpr int st_rw = st_delta + BQ;
  static constexpr int st_cw = st_rw + BQ;
  static constexpr int stage = (st_cw + BK + 3) / 4 * 4;
  // floats: K, V, two stages
  static constexpr int v_off = BK * LD;
  static constexpr int st_off = 2 * BK * LD;
  static constexpr size_t bytes = (st_off + 2 * stage) * sizeof(float);
};

template <int D, bool VARLEN>
__global__ void __launch_bounds__(DkvCfg<D>::NT, 1)
    dkv_f32_kernel(const Args a) {
  using C = DkvCfg<D>;
  constexpr int BK = C::BK, BQ = C::BQ, NT = C::NT, LD = C::LD, DW = C::DW;
  constexpr int NB = BQ / 8, DB = DW / 8;   // n-blocks of S^T, of dK / dV
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;
  float* v_s = smem + C::v_off;
  auto st = [&](int t) { return smem + C::st_off + (t & 1) * C::stage; };

  // heaviest first under causal masking: key tiles from the first
  const int hb = blockIdx.x % (a.Hk * a.B);
  const int kvh = hb % a.Hk;
  const int b = hb / a.Hk;
  const int kp0 = static_cast<int>(blockIdx.x) / (a.Hk * a.B) * BK;
  const fa::Seq sq = fa::seq_info<VARLEN>(a.seq, b, a.Hq);
  if (kp0 >= sq.slk) return;
  const int nk = min(BK, sq.slk - kp0);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int r0 = 16 * (warp / (D / DW));   // the warp's keys in the tile
  const int c0 = DW * (warp % (D / DW));   // and its dK / dV columns
  const Live lv = make_live(a, sq);
  // the q rows whose intervals reach keys [kp0, kp0 + nk)
  const int q_lo = lv.wr >= 0 ? max(0, kp0 - sq.offs - lv.wr) : 0;
  const int q_hi = lv.wl >= 0 ? min(sq.slq - 1, kp0 + nk - 1 - sq.offs + lv.wl)
                              : sq.slq - 1;
  const int n_qt = q_hi >= q_lo ? (q_hi - q_lo) / BQ + 1 : 0;
  const int n_steps = a.group * n_qt;   // (q head, q tile), head-major

  auto head_of = [&](int t) { return kvh * a.group + t / n_qt; };
  auto q0_of = [&](int t) { return q_lo + (t % n_qt) * BQ; };
  auto copy_q = [&](int t) {
    const int h = head_of(t), q0 = q0_of(t);
    const int n = min(BQ, q_hi - q0 + 1);
    float* s = st(t);
    load_rows<D, BQ, NT>(s, a.q, [&](int r) {
      return packed_row(a.q, sq.q_base + q0, r, n, a.Hq, h, D);
    });
    load_rows<D, BQ, NT>(s + C::st_do, a.dout, [&](int r) {
      return packed_row(a.dout, sq.q_base + q0, r, n, a.Hq, h, D);
    });
    const uint32_t bh = fa::dropout_bh(b, h, a.dp);
    uint32_t* rw = reinterpret_cast<uint32_t*>(s + C::st_rw);
    uint32_t* cw = reinterpret_cast<uint32_t*>(s + C::st_cw);
    for (int r = threadIdx.x; r < BQ; r += NT) {
      const bool in = r < n;
      cp_async4(s + C::st_lse + r,
                in ? a.lse + sq.lse_index(h, q0 + r) : a.lse, in);
      cp_async4(s + C::st_delta + r,
                in ? a.delta + sq.lse_index(h, q0 + r) : a.delta, in);
      if (a.dp.enabled) rw[r] = fa::dropout_row_word(q0 + r + a.dp.q0, bh, a.dp);
    }
    if (a.dp.enabled)
      for (int c = threadIdx.x; c < BK; c += NT)
        cw[c] = fa::dropout_col_word(kp0 + c + a.dp.k0, bh, a.dp);
  };

  // dK, dV: the warp's key rows g, g + 8 x columns c0 + 8 n + 2c, + 1
  float dk[DB][4], dv[DB][4];
#pragma unroll
  for (int n = 0; n < DB; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.0f;
  if (n_steps > 0) {
    load_rows<D, BK, NT>(k_s, a.k, [&](int r) {
      return packed_row(a.k, sq.k_base + kp0, r, nk, a.Hk, kvh, D);
    });
    load_rows<D, BK, NT>(v_s, a.v, [&](int r) {
      return packed_row(a.v, sq.k_base + kp0, r, nk, a.Hk, kvh, D);
    });
    copy_q(0);
    cp_async_commit();
    for (int s = 0; s < n_steps; ++s) {
      cp_async_wait<0>();
      __syncthreads();   // stage s landed; stage s - 1 is free
      if (s + 1 < n_steps) copy_q(s + 1);
      cp_async_commit();
      const int h = head_of(s), q0 = q0_of(s);
      const float* sg = st(s);
      const float slope = a.slopes ? a.slopes[b * a.Hq + h] : 0.0f;
      const uint32_t* rw = reinterpret_cast<const uint32_t*>(sg + C::st_rw);
      const uint32_t* cw = reinterpret_cast<const uint32_t*>(sg + C::st_cw);
      // S^T = K Q^T and dP^T = V dO^T (keys x q rows), 3 x TF32
      float sc[NB][4], dp[NB][4];
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.0f;
#pragma unroll 1
      for (int kk = 0; kk < D; kk += 8) {
        FragA fk, fv;
        frag_a<LD>(fk, k_s, r0, kk, lane);
        frag_a<LD>(fv, v_s, r0, kk, lane);
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          FragB fq, fd;
          frag_b_k<LD>(fq, sg, 8 * j, kk, lane);
          frag_b_k<LD>(fd, sg + C::st_do, 8 * j, kk, lane);
          mma3(sc[j], fk, fq);
          mma3(dp[j], fv, fd);
        }
      }
      // P_drop^T into sc, dS^T into dp
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int kl = r0 + lane / 4 + 8 * i;
        const int kp = kp0 + kl;
#pragma unroll
        for (int j = 0; j < NB; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int ql = 8 * j + 2 * (lane % 4) + e, qp = q0 + ql;
            grad_score(sc[j][2 * i + e], dp[j][2 * i + e], qp, kp,
                       kp < sq.slk && qp <= q_hi && lv.valid(qp, kp),
                       sg[C::st_lse + ql], sg[C::st_delta + ql], rw[ql],
                       cw[kl], slope, sq.offs, a);
          }
      }
      // dV += P_drop^T dO, dK += dS^T Q: A from the registers of S^T and
      // dP^T, kG q-row steps into zeroed fragments, then added in fp32
#pragma unroll
      for (int j = 0; j < NB; j += kG) {
        FragA fp[kG], fs[kG];
#pragma unroll
        for (int g = 0; g < kG; ++g) {
          frag_a_c(fp[g], sc[j + g]);
          frag_a_c(fs[g], dp[j + g]);
        }
#pragma unroll
        for (int n = 0; n < DB; ++n) {
          float tv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          float tk[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
          for (int g = 0; g < kG; ++g) {
            FragB fd, fq;
            frag_b_mn<LD>(fd, sg + C::st_do, 8 * (j + g), c0 + 8 * n, lane);
            frag_b_mn<LD>(fq, sg, 8 * (j + g), c0 + 8 * n, lane);
            mma3(tv, fp[g], fd);
            mma3(tk, fs[g], fq);
          }
          flush(dv[n], tv);
          flush(dk[n], tk);
          pin();
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kp = kp0 + r0 + lane / 4 + 8 * i;
    if (kp >= sq.slk) continue;
    const long long row = ((sq.k_base + kp) * a.Hk + kvh) *
                          static_cast<long long>(D) + c0 + 2 * (lane % 4);
#pragma unroll
    for (int n = 0; n < DB; ++n) {
      *reinterpret_cast<float2*>(a.dk + row + 8 * n) =
          make_float2(dk[n][2 * i], dk[n][2 * i + 1]);
      *reinterpret_cast<float2*>(a.dv + row + 8 * n) =
          make_float2(dv[n][2 * i], dv[n][2 * i + 1]);
    }
  }
}

// ------------------------------------------------------------------ launch

template <int D, bool VARLEN>
cudaError_t launch_d(bool dkv, const Args& a, cudaStream_t stream) {
  static size_t conf_dq = 0, conf_dkv = 0;
  if (dkv) {
    using C = DkvCfg<D>;
    cudaError_t e = allow_smem(dkv_f32_kernel<D, VARLEN>, C::bytes, &conf_dkv);
    if (e != cudaSuccess) return e;
    const int tiles = (a.seq.N + C::BK - 1) / C::BK;
    dkv_f32_kernel<D, VARLEN>
        <<<tiles * a.Hk * a.B, C::NT, C::bytes, stream>>>(a);
  } else {
    using C = DqCfg<D>;
    cudaError_t e = allow_smem(dq_f32_kernel<D, VARLEN>, C::bytes, &conf_dq);
    if (e != cudaSuccess) return e;
    const int tiles = (a.seq.M + C::BQ - 1) / C::BQ;
    dq_f32_kernel<D, VARLEN>
        <<<tiles * a.Hq * a.B, C::NT, C::bytes, stream>>>(a);
  }
  return cudaGetLastError();
}

template <bool VARLEN>
int launch(bool dkv, int D, const Args& a, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return static_cast<int>(launch_d<32, VARLEN>(dkv, a, st));
    case 64: return static_cast<int>(launch_d<64, VARLEN>(dkv, a, st));
    case 128: return static_cast<int>(launch_d<128, VARLEN>(dkv, a, st));
    case 256: return static_cast<int>(launch_d<256, VARLEN>(dkv, a, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

void set_common(Args* a, const void* q, const void* k, const void* v,
                const void* dout, const float* lse, const float* delta,
                const float* slopes, void* dq, void* dk, void* dv, int B,
                int Hq, int Hk, float scale, int causal, int window_left,
                int window_right, float softcap, int has_alibi, int dropout,
                unsigned int seed_lo, unsigned int seed_hi,
                unsigned int threshold, float drop_scale) {
  a->q = static_cast<const float*>(q); a->k = static_cast<const float*>(k);
  a->v = static_cast<const float*>(v);
  a->dout = static_cast<const float*>(dout); a->lse = lse;
  a->delta = delta; a->slopes = has_alibi ? slopes : nullptr;
  a->dq = static_cast<float*>(dq); a->dk = static_cast<float*>(dk);
  a->dv = static_cast<float*>(dv);
  a->B = B; a->Hq = Hq; a->Hk = Hk; a->group = Hq / Hk; a->scale = scale;
  a->mp.causal = causal; a->mp.window_left = window_left;
  a->mp.window_right = window_right; a->mp.softcap = softcap;
  a->mp.has_alibi = has_alibi;
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
                 int b0, int h0, int num_heads, void* stream) {
  if (dtype != kF32 || Hk <= 0 || Hq % Hk != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || Hq == 0 || (dkv ? N : M) == 0) return 0;
  Args a = {};
  set_common(&a, q, k, v, dout, lse, delta, slopes, dq, dk, dv, B, Hq, Hk,
             scale, causal, window_left, window_right, softcap, has_alibi,
             dropout, seed_lo, seed_hi, threshold, drop_scale);
  a.seq.M = M; a.seq.N = N; a.seq.offset = offset;
  a.dp.q0 = q0; a.dp.k0 = k0; a.dp.b0 = b0; a.dp.h0 = h0;
  a.dp.num_heads = num_heads;
  return launch<false>(dkv, D, a, stream);
}

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
  if (dtype != kF32 || Hk <= 0 || Hq % Hk != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || Hq == 0 || (dkv ? max_seqlen_k : max_seqlen_q) <= 0)
    return 0;
  Args a = {};
  set_common(&a, q, k, v, dout, lse, delta, slopes, dq, dk, dv, B, Hq, Hk,
             scale, causal, window_left, window_right, softcap, has_alibi,
             dropout, seed_lo, seed_hi, threshold, drop_scale);
  a.seq.M = max_seqlen_q; a.seq.N = max_seqlen_k; a.seq.Tq = Tq;
  a.seq.cu_q = cu_q; a.seq.cu_k = cu_k; a.seq.seqused_k = seqused_k;
  a.seq.leftpad_k = leftpad_k;
  // dropout keyed as K5 keys it: (within-sequence q position,
  // leftpad-relative key position, bh = b * Hq + h)
  a.dp.num_heads = Hq;
  return launch<true>(dkv, D, a, stream);
}

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

// The arguments of csrc/bwd.cu's entries; dtype must be 2 (fp32).  Each
// returns cudaGetLastError() of its launch.  K2 writes dq (dk, dv unused);
// K3 writes dk and dv (dq unused).
extern "C" int fa_dq_f32_launch(FA_BWD_PARAMS) {
  return dense_launch(false, FA_BWD_ARGS);
}
extern "C" int fa_dkv_f32_launch(FA_BWD_PARAMS) {
  return dense_launch(true, FA_BWD_ARGS);
}

// K6 writes dq (dk, dv unused); K7 writes dk and dv (dq unused).
extern "C" int fa_varlen_dq_f32_launch(FA_VARLEN_BWD_PARAMS) {
  return varlen_launch(false, FA_VARLEN_BWD_ARGS);
}
extern "C" int fa_varlen_dkv_f32_launch(FA_VARLEN_BWD_PARAMS) {
  return varlen_launch(true, FA_VARLEN_BWD_ARGS);
}
