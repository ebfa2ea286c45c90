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
// tile.  K3 / K7 run their four products as 3 x TF32 split products on the
// tensor cores (csrc/f32_tiles.cuh: a ceiling of 164.9 TFLOP/s); K2 / K6
// keep fp32 FFMA on the CUDA cores (66.9 TFLOP/s).
//
// What the design does about it (the FlashAttention-2 split):
//   * K2 is q-centric: one block of 128 threads per (q tile, q head,
//     sequence) holding Q and dO (64 rows at D 32 / 64, 32 at D 128 / 256),
//     dQ in registers, over the key tiles (32 keys, 16 at D 256) its rows'
//     intervals touch; S and dP in registers, dS once through shared
//     memory to dQ's product (FFMA register tiles: abt / ab).
//   * K3 is key-centric: one block per (key tile, kv head, sequence)
//     holding K and V, W warps of 16 keys each (4 warps, 64 keys at D 32 /
//     64; 8 warps, 128 keys at D 128; at D 256 8 warps, two a 16-key group
//     with half of dK / dV's columns each, 64 keys), dK and dV in
//     registers, over the group's q heads and, for each, the q tiles (64
//     rows at D 32, 32 at 64, 16 at 128 / 256) whose intervals reach its
//     keys.  S^T = K Q^T and dP^T = V dO^T are mma.sync m16n8k8 .tf32 with
//     K and V as A and Q, dO as B (rows of D + 4 floats); P_drop^T and dS^T
//     stay in registers as the A operands of dV += P_drop^T dO and dK +=
//     dS^T Q, whose B fragments are read from the row-major Q and dO
//     tiles; every operand is split into TF32 hi / lo parts as it is read.
//     dK and dV take two q-row steps at a time into zeroed fragments added
//     in fp32 (the tensor cores' accumulation truncates).
//   * The streamed operands (K2: K, V and the dropout column words; K3: Q,
//     dO, lse, delta and both dropout words of the step's head) run
//     through a two-stage cp.async ring, the next tile copied while this
//     one is computed.
//   * Nothing is summed across blocks: each output element belongs to one
//     block (one warp), which adds its terms in a fixed order, so two
//     calls are bitwise equal, and K7, the varlen instantiation of K3's
//     body, gives each sequence K3's bits on it alone.  Shared memory of a
//     K3 block (K, V, two stages): D 32 57 KB, 64 71 KB, 128 170 KB, 256
//     201 KB.
#include <math.h>

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

template <int D>
struct DqCfg {
  static constexpr int BQ = D <= 64 ? 64 : 32;    // q rows a block
  static constexpr int BK = D <= 128 ? 32 : 16;   // keys a step
  static constexpr int RT = BQ / 16, CT = BK / 8;
  static constexpr int LD = D + 4, PLD = BK + 8;
  // floats: Q, dO, two stages of (K, V), dS, two stages of column words
  static constexpr int do_off = BQ * LD;
  static constexpr int kv_off = 2 * BQ * LD;
  static constexpr int ds_off = kv_off + 4 * BK * LD;
  static constexpr int cw_off = ds_off + BQ * PLD;
  static constexpr size_t bytes = (cw_off + 2 * BK) * sizeof(float);
};

template <int D, bool VARLEN>
__global__ void __launch_bounds__(kThreads) dq_f32_kernel(const Args a) {
  using C = DqCfg<D>;
  constexpr int BQ = C::BQ, BK = C::BK, RT = C::RT, CT = C::CT;
  constexpr int LD = C::LD, PLD = C::PLD, DC = D / 32;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;
  float* do_s = smem + C::do_off;
  float* ds_s = smem + C::ds_off;
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
  const int ty = threadIdx.x / 8, tx = threadIdx.x % 8;
  const Live lv = make_live(a, sq);
  const float slope = a.slopes ? a.slopes[b * a.Hq + h] : 0.0f;
  const uint32_t bh = fa::dropout_bh(b, h, a.dp);
  int qp[RT];
  float lse[RT], delta[RT];
  uint32_t rw[RT];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    qp[i] = qp0 + ty + 16 * i;
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
    load_rows<D, BK>(k_s(t), a.k, [&](int r) {
      return packed_row(a.k, sq.k_base + k0, r, n, a.Hk, kvh, D);
    });
    load_rows<D, BK>(v_s(t), a.v, [&](int r) {
      return packed_row(a.v, sq.k_base + k0, r, n, a.Hk, kvh, D);
    });
    if (a.dp.enabled)
      for (int c = threadIdx.x; c < BK; c += kThreads)
        cw_s[(t & 1) * BK + c] =
            fa::dropout_col_word(k0 + c + a.dp.k0, bh, a.dp);
  };

  float4 dq[RT][DC];
  zero(dq);
  if (n_steps > 0) {
    load_rows<D, BQ>(q_s, a.q, [&](int r) {
      return packed_row(a.q, sq.q_base + qp0, r, nq, a.Hq, h, D);
    });
    load_rows<D, BQ>(do_s, a.dout, [&](int r) {
      return packed_row(a.dout, sq.q_base + qp0, r, nq, a.Hq, h, D);
    });
    copy_kv(0);
    cp_async_commit();
    for (int s = 0; s < n_steps; ++s) {
      cp_async_wait<0>();
      __syncthreads();   // tile s landed; tile s - 1's stage and dS free
      if (s + 1 < n_steps) copy_kv(s + 1);
      cp_async_commit();
      float sc[RT][CT], dp[RT][CT];
      abt<D, RT, CT>(sc, q_s, k_s(s), ty, tx);
      abt<D, RT, CT>(dp, do_s, v_s(s), ty, tx);
      const int k0 = blk_lo + s * BK;
      const uint32_t* cw = cw_s + (s & 1) * BK;
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < CT; ++j) {
          const int kp = k0 + tx + 8 * j;
          grad_score(sc[i][j], dp[i][j], qp[i], kp,
                     qp[i] < sq.slq && lv.valid(qp[i], kp), lse[i], delta[i],
                     rw[i], cw[tx + 8 * j], slope, sq.offs, a);
          ds_s[(ty + 16 * i) * PLD + tx + 8 * j] = dp[i][j];
        }
      __syncthreads();   // dS stored
      ab<D, RT, BK, PLD>(dq, ds_s, k_s(s), ty, tx);
    }
  }
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    if (qp[i] >= sq.slq) continue;
    float* g = a.dq + ((sq.q_base + qp[i]) * a.Hq + h) *
                          static_cast<long long>(D);
#pragma unroll
    for (int u = 0; u < DC; ++u)
      *reinterpret_cast<float4*>(g + 4 * (tx + 8 * u)) = dq[i][u];
  }
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
        <<<tiles * a.Hq * a.B, kThreads, C::bytes, stream>>>(a);
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
