// K8q (csrc/varlen_paged_quant.cu, whose note states the contract and the
// design): its kernels and its entry points' body for one q type, which
// each translation unit of the library instantiates for its own q types
// (varlen_paged_quant.cu bf16, varlen_paged_quant_f16.cu fp16,
// varlen_paged_quant_f32.cu fp32) so that nvcc compiles them in parallel.
#pragma once

#include <stdint.h>

#include "fwd_body.cuh"
#include "quant.cuh"

// the entry point's parameters after its dtype, and their names
#define FA_K8Q_PARAMS                                                         \
  int kind, const void* q, const void* k, const void* v, const float* ks,     \
  const float* vs, const int* table, int table_stride, const int* cu_q,       \
  const int* seqlens_k, const int* seqused_k, const int* leftpad_k,           \
  const float* slopes, void* out, float* lse, long long s_h, long long s_p,   \
  long long s_tok, long long sc_h, long long sc_p, long long sc_tok, int B,   \
  int Tq, int Hq, int Hk, int D, int page_size, int mp, int max_seqlen_q,     \
  float scale, float slope_mult, int exp2_domain, int causal,                 \
  int window_left, int window_right, float softcap, int has_alibi,            \
  void* stream
#define FA_K8Q_ARGS                                                           \
  kind, q, k, v, ks, vs, table, table_stride, cu_q, seqlens_k, seqused_k,     \
  leftpad_k, slopes, out, lse, s_h, s_p, s_tok, sc_h, sc_p, sc_tok, B, Tq,    \
  Hq, Hk, D, page_size, mp, max_seqlen_q, scale, slope_mult, exp2_domain,     \
  causal, window_left, window_right, softcap, has_alibi, stream

namespace {

// ----------------------------------------------------------- int8 / int4

// shared memory of the int kernel: Q8 and the q scales, then two stages of
// K8 [key][dim], V8^T [dim][key] and the tile's k and v scales, then the
// block table.  Rows padded by 16 bytes: the 8 rows an ldmatrix phase
// reads fall in 8 distinct 16-byte bank groups.
template <int D, int KIND>
struct IntSmem {
  static constexpr int kWarps = 4;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int BQ = 16 * kWarps;   // q rows a block
  static constexpr int BK = 64;            // keys a step: P's int8 group
  static constexpr int QLD = D + 16;       // bytes a Q8 / K8 row
  static constexpr int VLD = BK + 16;      // bytes a V8^T row
  // fp8 (fp32 q): three bf16 Q tiles of QLE elements a row instead of Q8
  static constexpr int QLE = D + 8;
  static constexpr size_t qs_off =
      KIND == fa::kFp8 ? static_cast<size_t>(3) * BQ * QLE * 2
                       : static_cast<size_t>(BQ) * QLD;
  static constexpr size_t stage_off = qs_off + 4 * BQ;
  static constexpr size_t k_off = 0;
  static constexpr size_t v_off = static_cast<size_t>(BK) * QLD;
  static constexpr size_t sc_off = v_off + static_cast<size_t>(D) * VLD;
  static constexpr size_t stage_bytes = sc_off + 8 * BK;
  static constexpr size_t tbl_off = stage_off + 2 * stage_bytes;
  static constexpr size_t bytes = tbl_off;   // + the table at launch
};

struct IntArgs {
  FwdArgs f;          // f.scale: the score scale of the softmax domain
  float slope_mult;   // log2(e) in the base-2 domain, else 1
  int exp2_domain;
};

// Conversions between int32 and fp32 run at a quarter of the FMA rate on
// this card; these run on the full-rate pipes instead.  kMagic = 1.5 *
// 2^23: a float in [2^23, 2^24) has unit spacing, so kMagic + x holds the
// integer x in its low mantissa bits for |x| < 2^22 (S is at most
// 256 * 127 * 128 < 2^22 in magnitude, a P V sum 64 * 127 * 128).
constexpr float kMagic = 12582912.0f;
constexpr int kMagicBits = 0x4B400000;

// x exactly as a float, |x| < 2^22
__device__ __forceinline__ float i2f(int x) {
  return __int_as_float(x + kMagicBits) - kMagic;
}

// P's int8 value of p >= 0 under scale ps is q = rint of the IEEE quotient
// p / ps, half to even, kept as kMagic + q (q in the low byte).  r = p *
// inv (inv = 1 / ps rounded) lies within 1.9e-5 of that quotient (two
// roundings below 128), and kMagic + r rounds r half to even, so that is
// the quotient's q wherever r lies farther than kTie from a half-integer;
// p8_fast says where it does not, and the caller divides there.
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

__device__ __forceinline__ uint32_t ldg32(const uint8_t* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

// V's tile through registers: units of (4 keys, 4 dims), the keys
// 16 h + 2 q + {0, 1, 8, 9} of a 32-key half kk, which land transposed in
// columns 32 kk + 16 h + 4 q + {0..3} of rows 4 d4 + {0..3}.  Neighbouring
// threads take neighbouring key groups kg = 8 kk + 4 h + q: a store then
// writes word kg of its row, so a warp's 4-byte stores (two rows 4 apart,
// 80 words) meet 32 distinct banks.
template <int D, int NT, int KIND>
struct VtRegs {
  static constexpr int kUnits = 16 * (D / 4);
  static constexpr int kN = (kUnits + NT - 1) / NT;
  static constexpr int kWords = KIND == fa::kInt4 ? 2 : 4;
  uint32_t w[kN][kWords];

  __device__ static void unit(int u, int& d4, int& key, int& col) {
    d4 = u / 16;
    const int kg = u % 16;
    const int kk = kg / 8, h = (kg % 8) / 4, q = kg % 4;
    key = 32 * kk + 16 * h + 2 * q;
    col = 32 * kk + 16 * h + 4 * q;
  }

  // g: the tile's row 0 (int4: its byte row 0), stride bytes a row
  __device__ void load(const uint8_t* g, long long stride) {
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      const int u = threadIdx.x + i * NT;
      if (kN * NT > kUnits && u >= kUnits) break;
      int d4, key, col;
      unit(u, d4, key, col);
      const uint8_t* p = g + d4 * 4;
      if constexpr (KIND == fa::kInt4) {
        w[i][0] = ldg32(p + (key / 2) * stride);
        w[i][1] = ldg32(p + (key / 2 + 4) * stride);
      } else {
        w[i][0] = ldg32(p + key * stride);
        w[i][1] = ldg32(p + (key + 1) * stride);
        w[i][2] = ldg32(p + (key + 8) * stride);
        w[i][3] = ldg32(p + (key + 9) * stride);
      }
    }
  }

  template <int VLD>
  __device__ void store(unsigned char* vt) const {
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      const int u = threadIdx.x + i * NT;
      if (kN * NT > kUnits && u >= kUnits) break;
      int d4, key, col;
      unit(u, d4, key, col);
      uint32_t w0, w1, w2, w3;   // keys key, key + 1, key + 8, key + 9
      if constexpr (KIND == fa::kInt4) {
        fa::unpack_int4x4(w[i][0], w0, w1);
        fa::unpack_int4x4(w[i][1], w2, w3);
      } else {
        w0 = w[i][0]; w1 = w[i][1]; w2 = w[i][2]; w3 = w[i][3];
      }
      const uint32_t t0 = __byte_perm(w0, w1, 0x5140);
      const uint32_t t1 = __byte_perm(w2, w3, 0x5140);
      const uint32_t t2 = __byte_perm(w0, w1, 0x7362);
      const uint32_t t3 = __byte_perm(w2, w3, 0x7362);
      unsigned char* d = vt + (4 * d4) * VLD + col;
      *reinterpret_cast<uint32_t*>(d) = __byte_perm(t0, t1, 0x5410);
      *reinterpret_cast<uint32_t*>(d + VLD) = __byte_perm(t0, t1, 0x7632);
      *reinterpret_cast<uint32_t*>(d + 2 * VLD) = __byte_perm(t2, t3, 0x5410);
      *reinterpret_cast<uint32_t*>(d + 3 * VLD) = __byte_perm(t2, t3, 0x7632);
    }
  }
};

// int4 K's tile through registers: 16 packed bytes (two tokens' 16 dims)
// a unit, unpacked into rows 2 br and 2 br + 1
template <int D, int NT>
struct K4Regs {
  static constexpr int kUnits = 32 * (D / 16);
  static constexpr int kN = (kUnits + NT - 1) / NT;
  uint4 w[kN];

  __device__ void load(const uint8_t* g, long long stride) {
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      const int u = threadIdx.x + i * NT;
      if (kN * NT > kUnits && u >= kUnits) break;
      w[i] = __ldg(reinterpret_cast<const uint4*>(
          g + (u / (D / 16)) * stride + (u % (D / 16)) * 16));
    }
  }

  template <int QLD>
  __device__ void store(unsigned char* kt) const {
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      const int u = threadIdx.x + i * NT;
      if (kN * NT > kUnits && u >= kUnits) break;
      uint4 ev, od;
      fa::unpack_int4x16(w[i], ev, od);
      unsigned char* d = kt + 2 * (u / (D / 16)) * QLD + (u % (D / 16)) * 16;
      *reinterpret_cast<uint4*>(d) = ev;
      *reinterpret_cast<uint4*>(d + QLD) = od;
    }
  }
};

// KIND fa::kFp8 only for an fp32 q (T float): see the file's note
template <typename T, int D, int KIND, bool EXTRA>
__global__ void __launch_bounds__(IntSmem<D, KIND>::kThreads)
    int_kernel(IntArgs ia) {
  using L = IntSmem<D, KIND>;
  using B16 = __nv_bfloat16;
  constexpr int BQ = L::BQ, BK = L::BK, NT = L::kThreads;
  constexpr int QLD = L::QLD, VLD = L::VLD, QLE = L::QLE;
  constexpr bool kF8 = KIND == fa::kFp8;
  static_assert(!kF8 || std::is_same<T, float>::value, "fp8: fp32 q only");
  // Q8's A fragments held in registers
  constexpr bool kQRegs = D <= 128 && !kF8;
  constexpr int NC = D < 64 ? D : 64;  // O's columns a P V accumulator
  const FwdArgs& a = ia.f;
  extern __shared__ __align__(16) unsigned char smem[];

  // heaviest first, as K8
  const int n_tiles = (a.seq.M + BQ - 1) / BQ;
  const int hb = blockIdx.x % (a.Hq * a.B);
  const int h = hb % a.Hq;
  const int b = hb / a.Hq;
  const int qp0 =
      (n_tiles - 1 - static_cast<int>(blockIdx.x) / (a.Hq * a.B)) * BQ;
  const fa::Seq sq = fa::paged_seq_info(a.seq, a.pg.seqlens_k,
                                        a.pg.mp * a.pg.page_size, b);
  if (qp0 >= sq.slq) return;  // uniform over the block
  const int nq = min(BQ, sq.slq - qp0);
  const int kvh = h / a.group;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int w0 = qp0 + 16 * warp;          // this warp's first q row
  const int nq_w = min(16, sq.slq - w0);   // its rows in the sequence
  const Live lv = {sq.slk, sq.offs, a.mp_.window_left,
                   a.mp_.effective_window_right()};
  const float slope =
      EXTRA && a.slopes ? a.slopes[b * a.Hq + h] * ia.slope_mult : 0.0f;
  // the plain variant (base-2 domain, no bias) folds the score scale into
  // the exponent's multiply-add; the EXTRA one keeps the biased score in
  // log2 units in S
  const float to_log2 = EXTRA ? 1.0f : a.scale;
  const float to_base2 = ia.exp2_domain ? 1.0f : kLog2e;
  int qp[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) qp[i] = w0 + lane / 4 + 8 * i;

  // live keys of the block's rows; key tiles from cache row 0 (tile t's
  // first leftpad-relative key is (kt0 + t) * BK - lp)
  const int lp = static_cast<int>(sq.k_base);
  const int blk_lo = lv.key_lo(qp0);
  const int blk_hi = lv.key_hi(qp0 + nq - 1);
  const int kt0 = (blk_lo + lp) / BK;
  const int n_steps = blk_hi >= blk_lo ? (blk_hi + lp) / BK - kt0 + 1 : 0;
  auto key0 = [&](int t) { return (kt0 + t) * BK - lp; };
  const int ps = a.pg.page_size;
  const int slot0 = kt0 * BK / ps;
  const int* tbl_s = reinterpret_cast<const int*>(smem + L::tbl_off);
  auto stage = [&](int t) {
    return smem + L::stage_off + (t & 1) * L::stage_bytes;
  };
  // tile t's page and first row in it
  auto page_of = [&](int t) { return tbl_s[(kt0 + t) * BK / ps - slot0]; };
  auto row_of = [&](int t) { return (kt0 + t) * BK % ps; };

  float o[D / 8][4] = {};
  float m[2] = {-INFINITY, -INFINITY};   // running row max (base 2)
  float l[2] = {0.0f, 0.0f};             // this lane's part of the row sum

  VtRegs<D, NT, KIND> vr;
  K4Regs<D, NT> kr;
  // tile t's copies: K8 by cp.async (int8) or into registers (int4), V
  // into registers, the k and v scales by cp.async (zero outside the live
  // keys: a scale row past the written tokens may hold anything; payload
  // bytes there only meet P = 0 or a masked score)
  auto issue = [&](int t) {
    const long long pg_b = page_of(t) * a.pg.s_p + kvh * a.pg.s_h;
    const int row = row_of(t);
    const long long pay_row = (KIND == fa::kInt4 ? row / 2 : row) * a.pg.s_tok;
    const uint8_t* kg = static_cast<const uint8_t*>(a.k) + pg_b + pay_row;
    const uint8_t* vg = static_cast<const uint8_t*>(a.v) + pg_b + pay_row;
    if constexpr (KIND == fa::kInt4) {
      kr.load(kg, a.pg.s_tok);
    } else {
      unsigned char* kt = stage(t) + L::k_off;
      for (int idx = threadIdx.x; idx < BK * (D / 16); idx += NT) {
        const int r = idx / (D / 16), c = idx % (D / 16);
        cp_async16(kt + r * QLD + c * 16, kg + r * a.pg.s_tok + c * 16, true);
      }
    }
    vr.load(vg, a.pg.s_tok);
    if (threadIdx.x < 2 * BK) {
      const int c = threadIdx.x % BK;
      const int k0 = key0(t);
      const bool in = c >= blk_lo - k0 && c <= blk_hi - k0;
      const float* sc = (threadIdx.x < BK ? a.pg.ks : a.pg.vs) +
                        page_of(t) * a.pg.sc_p + kvh * a.pg.sc_h +
                        static_cast<long long>(row + c) * a.pg.sc_tok;
      cp_async4(stage(t) + L::sc_off + threadIdx.x * 4, in ? sc : a.pg.ks,
                in);
    }
  };
  // the register part of tile t's copies into its stage
  auto land = [&](int t) {
    if constexpr (KIND == fa::kInt4)
      kr.template store<QLD>(stage(t) + L::k_off);
    vr.template store<VLD>(stage(t) + L::v_off);
  };

  if (n_steps > 0) {
    {
      const int n_slots = ((kt0 + n_steps) * BK - 1) / ps - slot0 + 1;
      int* tbl = reinterpret_cast<int*>(smem + L::tbl_off);
      const int* trow = a.pg.table + static_cast<long long>(b) *
                                         a.pg.table_stride + slot0;
      for (int i = threadIdx.x; i < n_slots; i += NT) tbl[i] = trow[i];
      __syncthreads();
    }
    issue(0);
    cp_async_commit();

    // Q: this warp's 16 rows quantized to int8 per row, scale amax / 127
    // (IEEE division), rint half to even; rows past the sequence are zero
    // with scale 1
    int8_t* q8 = reinterpret_cast<int8_t*>(smem);
    float* qs_s = reinterpret_cast<float*>(smem + L::qs_off);
    if constexpr (kF8) {
      // fp32 q: its three bf16 parts, columns permuted, tile p at p * BQ
      // rows; rows past the sequence are zero
      B16* qt = reinterpret_cast<B16*>(smem);
      const float* qg = static_cast<const float*>(a.q);
      for (int idx = threadIdx.x; idx < BQ * D; idx += NT) {
        const int r = idx / D, d = idx % D;
        const float x =
            r < nq ? qg[((sq.q_base + qp0 + r) * a.Hq + h) * D + d] : 0.0f;
        B16* t = qt + r * QLE + fa::fp8_q_col(d);
        fa::split_bf16x3(x, t[0], t[BQ * QLE], t[2 * BQ * QLE]);
      }
    } else {
      constexpr int QV = D / 32;   // a lane's elements of a row
      const T* qg = static_cast<const T*>(a.q);
#pragma unroll 1
      for (int i = 0; i < 16; ++i) {
        const int r = 16 * warp + i;
        float x[QV];
        float amax = 0.0f;
        const T* src = qg + ((sq.q_base + qp0 + r) * a.Hq + h) * D + lane * QV;
#pragma unroll
        for (int c = 0; c < QV; ++c) {
          x[c] = r < nq ? fa::to_float(src[c]) : 0.0f;
          amax = fmaxf(amax, fabsf(x[c]));
        }
        const float qsc = fa::p_scale_of(fa::warp_max(amax));
#pragma unroll
        for (int c = 0; c < QV; ++c)
          q8[r * QLD + lane * QV + c] = static_cast<int8_t>(rintf(x[c] / qsc));
        if (lane == 0) qs_s[r] = qsc;
      }
    }
    land(0);
    if constexpr (kF8)
      __syncthreads();   // the Q tiles are written across warps
    else
      __syncwarp();
    float qsc[2] = {1.0f, 1.0f};
    if constexpr (!kF8) {
#pragma unroll
      for (int i = 0; i < 2; ++i) qsc[i] = qs_s[16 * warp + lane / 4 + 8 * i];
    }
    const unsigned char* qa_s =
        smem + (16 * warp + lane % 16) * QLD + (lane / 16) * 16;
    uint32_t qa[kQRegs ? D / 32 : 1][4];
    if constexpr (kQRegs) {
#pragma unroll
      for (int kk = 0; kk < D / 32; ++kk) ldsm_x4(qa[kk], qa_s + kk * 32);
    }
    // a B operand's lane address in a [n][k] byte tile, row stride LD
    auto b_addr = [&](const unsigned char* t, int ld) {
      return t + ((lane % 8) + (lane / 16) * 8) * ld + ((lane / 8) % 2) * 16;
    };

    // Stage t & 1 holds tile t, copied during step t - 1: its cp.async
    // parts issued after that step's barrier, its register parts stored at
    // that step's end.
#pragma unroll 1
    for (int s = 0; s < n_steps; ++s) {
      cp_async_wait<0>();
      __syncthreads();   // tile s landed for all; stage (s + 1) & 1 free
      if (s + 1 < n_steps) issue(s + 1);
      cp_async_commit();
      const unsigned char* st = stage(s);

      // S = Q8 K8^T, this warp's 16 rows x 64 keys (fp8: fp32 S over the
      // three Q parts)
      int si[BK / 8][4] = {};
      float sf[BK / 8][4] = {};
      const unsigned char* kb = b_addr(st + L::k_off, QLD);
      if constexpr (kF8) {
        const B16* qs =
            reinterpret_cast<const B16*>(smem) + (16 * warp) * QLE;
#pragma unroll
        for (int kk = 0; kk < D / 32; ++kk)
#pragma unroll
          for (int nb = 0; nb < BK / 16; ++nb) {
            uint32_t bf[4], bb[4][2];
            ldsm_x4(bf, kb + nb * 16 * QLD + kk * 32);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              bb[i][0] = e4m3x2_to<B16>(bf[i]);
              bb[i][1] = e4m3x2_to<B16>(bf[i] >> 16);
            }
#pragma unroll
            for (int p = 2; p >= 0; --p) {
              uint32_t af0[4], af1[4];
              load_a<QLE>(af0, qs + p * BQ * QLE + kk * 32, lane);
              load_a<QLE>(af1, qs + p * BQ * QLE + kk * 32 + 16, lane);
              mma16816<B16>(sf[2 * nb], af0, bb[0][0], bb[0][1]);
              mma16816<B16>(sf[2 * nb + 1], af0, bb[2][0], bb[2][1]);
              mma16816<B16>(sf[2 * nb], af1, bb[1][0], bb[1][1]);
              mma16816<B16>(sf[2 * nb + 1], af1, bb[3][0], bb[3][1]);
            }
          }
      }
#pragma unroll
      for (int kk = 0; kk < (kF8 ? 0 : D / 32); ++kk) {
        uint32_t af[4];
        if constexpr (kQRegs) {
#pragma unroll
          for (int e = 0; e < 4; ++e) af[e] = qa[kk][e];
        } else {
          ldsm_x4(af, qa_s + kk * 32);
        }
#pragma unroll
        for (int nb = 0; nb < BK / 16; ++nb) {
          uint32_t bf[4];
          ldsm_x4(bf, kb + nb * 16 * QLD + kk * 32);
          mma16832_s8(si[2 * nb], af, bf[0], bf[1]);
          mma16832_s8(si[2 * nb + 1], af, bf[2], bf[3]);
        }
      }

      // the online softmax on the fragments, then P times the v scales
      // quantized per row over the tile into P8's A fragments
      const int k0 = key0(s);
      const float* ks_s = reinterpret_cast<const float*>(st + L::sc_off);
      const float* vs_s = ks_s + BK;
      float alpha[2], pscale[2], pinv[2];
      uint32_t pa[2][4];
      uint32_t pa16[kF8 ? BK / 16 : 1][4];
      auto pass = [&](auto masked) {
        constexpr bool MASK = decltype(masked)::value;
        float x[BK / 8][4];
        float mx[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e / 2;
            const int kp = k0 + j * 8 + (lane % 4) * 2 + e % 2;
            const float2 kq =
                *reinterpret_cast<const float2*>(ks_s + j * 8 + (lane % 4) * 2);
            float v = (kF8 ? sf[j][e] : i2f(si[j][e]) * qsc[i]) *
                      (e % 2 ? kq.y : kq.x);
            if (EXTRA)
              v = fa::score_bias(v, qp[i] + sq.offs, kp, a.scale, slope,
                                 a.mp_) *
                  to_base2;
            if (MASK && !lv.valid(qp[i], kp)) v = -INFINITY;
            x[j][e] = v;
            mx[e] = fmaxf(mx[e], v);
          }
        float base[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float r = fmaxf(mx[2 * i], mx[2 * i + 1]);
          r = fmaxf(r, __shfl_xor_sync(0xffffffffu, r, 1));
          r = fmaxf(r, __shfl_xor_sync(0xffffffffu, r, 2));
          const float m_next = fmaxf(m[i], r * to_log2);
          base[i] = MASK && m_next == -INFINITY ? 0.0f : m_next;
          alpha[i] = ex2(m[i] - base[i]);
          m[i] = m_next;
        }
        float ls[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        float am[2] = {0.0f, 0.0f};
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e / 2;
            const float p = ex2(fmaf(x[j][e], to_log2, -base[i]));
            const float2 vq =
                *reinterpret_cast<const float2*>(vs_s + j * 8 + (lane % 4) * 2);
            ls[e] += p;
            x[j][e] = p * (e % 2 ? vq.y : vq.x);
            am[i] = fmaxf(am[i], x[j][e]);
          }
        if constexpr (kF8) {
          // fp8: P times the v scales, rounded to bf16 into 16-bit A
          // fragments
#pragma unroll
          for (int i = 0; i < 2; ++i)
            l[i] = l[i] * alpha[i] + (ls[2 * i] + ls[2 * i + 1]);
#pragma unroll
          for (int j = 0; j < BK / 16; ++j)
            pack_a<B16>(pa16[j], x[2 * j], x[2 * j + 1]);
          return;
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          l[i] = l[i] * alpha[i] + (ls[2 * i] + ls[2 * i + 1]);
          float r = fmaxf(am[i], __shfl_xor_sync(0xffffffffu, am[i], 1));
          r = fmaxf(r, __shfl_xor_sync(0xffffffffu, r, 2));
          pscale[i] = fa::p_scale_of(r);
          pinv[i] = 1.0f / pscale[i];
        }
        // P8's A fragments, eight values (two registers) at a time: the
        // fast quotients, and the IEEE division where one lies near a tie
        // (about once in 10^4 values), one branch for the eight
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int j = 4 * kk + 2 * hh;
            uint32_t t[2][4];
            bool near = false;
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
              for (int u = 0; u < 4; ++u)
                t[i][u] = p8_fast(x[j + u / 2][2 * i + u % 2], pinv[i], near);
            if (__builtin_expect(near, 0)) {
#pragma unroll
              for (int i = 0; i < 2; ++i)
#pragma unroll
                for (int u = 0; u < 4; ++u)
                  t[i][u] = __float_as_uint(
                      x[j + u / 2][2 * i + u % 2] / pscale[i] + kMagic);
            }
#pragma unroll
            for (int i = 0; i < 2; ++i)
              pa[kk][2 * hh + i] = pack_s8(t[i][0], t[i][1], t[i][2], t[i][3]);
          }
      };
      if (nq_w == 16 && lv.full(w0, 16, k0, BK))
        pass(std::false_type{});
      else
        pass(std::true_type{});

      // O = alpha O + p_scale (P8 V8), NC columns at a time (fp8: O =
      // alpha O + P V on m16n8k16; a word of V's tile holds the keys 2 t,
      // 2 t + 1, 2 t + 8, 2 t + 9 of a 16, a B fragment's two registers)
      const unsigned char* vb = b_addr(st + L::v_off, VLD);
      if constexpr (kF8) {
#pragma unroll
        for (int nb = 0; nb < D / 8; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[nb][e] *= alpha[e / 2];
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)
#pragma unroll
          for (int nb = 0; nb < D / 16; ++nb) {
            uint32_t bf[4];
            ldsm_x4(bf, vb + nb * 16 * VLD + kk * 32);
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              mma16816<B16>(o[2 * nb], pa16[2 * kk + hh],
                            e4m3x2_to<B16>(bf[hh]),
                            e4m3x2_to<B16>(bf[hh] >> 16));
              mma16816<B16>(o[2 * nb + 1], pa16[2 * kk + hh],
                            e4m3x2_to<B16>(bf[2 + hh]),
                            e4m3x2_to<B16>(bf[2 + hh] >> 16));
            }
          }
      }
#pragma unroll
      for (int c = 0; c < (kF8 ? 0 : D / NC); ++c) {
        int acc[NC / 8][4] = {};
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)
#pragma unroll
          for (int nb = 0; nb < NC / 16; ++nb) {
            uint32_t bf[4];
            ldsm_x4(bf, vb + (c * NC + nb * 16) * VLD + kk * 32);
            mma16832_s8(acc[2 * nb], pa[kk], bf[0], bf[1]);
            mma16832_s8(acc[2 * nb + 1], pa[kk], bf[2], bf[3]);
          }
#pragma unroll
        for (int nb = 0; nb < NC / 8; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float& oe = o[c * (NC / 8) + nb][e];
            oe = fmaf(i2f(acc[nb][e]), pscale[e / 2], oe * alpha[e / 2]);
          }
      }
      if (s + 1 < n_steps) land(s + 1);
    }
  }

  // epilogue: the row sums, O * (1 / l) from the fragments, LSE = m + log(l)
  // (natural log), -inf where l = 0
  T* og = static_cast<T*>(a.out);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const float inv = l[i] == 0.0f ? 0.0f : 1.0f / l[i];
    if (qp[i] >= sq.slq) continue;
    T* row = og + ((sq.q_base + qp[i]) * a.Hq + h) * D + (lane % 4) * 2;
#pragma unroll
    for (int nb = 0; nb < D / 8; ++nb) {
      if constexpr (std::is_same<T, float>::value)
        *reinterpret_cast<float2*>(row + nb * 8) =
            make_float2(o[nb][2 * i] * inv, o[nb][2 * i + 1] * inv);
      else
        *reinterpret_cast<uint32_t*>(row + nb * 8) =
            pack2<T>(o[nb][2 * i] * inv, o[nb][2 * i + 1] * inv);
    }
    if (lane % 4 == 0)
      a.lse[sq.lse_index(h, qp[i])] =
          l[i] == 0.0f ? -INFINITY : m[i] * kLn2 + logf(l[i]);
  }
}

// the int kernel's variant, its shared-memory limit raised on first use
// (to the largest block table it has been launched with, `extra` bytes)
template <typename T, int D, int KIND, bool EXTRA>
cudaError_t int_variant(void (**fn)(IntArgs), Kernel* k, int extra) {
  using L = IntSmem<D, KIND>;
  *fn = int_kernel<T, D, KIND, EXTRA>;
  k->fn = nullptr;
  k->smem = static_cast<int>(L::bytes);
  k->threads = L::kThreads;
  k->rows = L::BQ;
  static int configured = 0;
  if (k->smem + extra > configured) {
    cudaError_t e = cudaFuncSetAttribute(
        *fn, cudaFuncAttributeMaxDynamicSharedMemorySize, k->smem + extra);
    if (e != cudaSuccess) return e;
    configured = k->smem + extra;
  }
  return cudaSuccess;
}

template <typename T, int KIND>
cudaError_t int_find_d(int D, bool extra, void (**fn)(IntArgs), Kernel* k,
                       int smem_extra) {
  switch (D) {
    case 32: return extra ? int_variant<T, 32, KIND, true>(fn, k, smem_extra)
                          : int_variant<T, 32, KIND, false>(fn, k, smem_extra);
    case 64: return extra ? int_variant<T, 64, KIND, true>(fn, k, smem_extra)
                          : int_variant<T, 64, KIND, false>(fn, k, smem_extra);
    case 128:
      return extra ? int_variant<T, 128, KIND, true>(fn, k, smem_extra)
                   : int_variant<T, 128, KIND, false>(fn, k, smem_extra);
    case 256:
      return extra ? int_variant<T, 256, KIND, true>(fn, k, smem_extra)
                   : int_variant<T, 256, KIND, false>(fn, k, smem_extra);
    default: return cudaErrorInvalidValue;
  }
}

// the variant of (kind, q's type T, D, extra): the int kernel's entry in
// *ifn (int8, int4, and fp8 over an fp32 q) or the fp8 body's in k->fn
template <typename T>
cudaError_t find_kind(int kind, int D, bool extra, void (**ifn)(IntArgs),
                      Kernel* k, int smem_extra) {
  switch (kind) {
    case fa::kFp8:
      if constexpr (std::is_same<T, float>::value) {
        return int_find_d<T, fa::kFp8>(D, extra, ifn, k, smem_extra);
      } else {
        *ifn = nullptr;
        return find_d<T, kPaged, kKvFp8>(D, extra, k, smem_extra);
      }
    case fa::kInt8:
      return int_find_d<T, fa::kInt8>(D, extra, ifn, k, smem_extra);
    case fa::kInt4:
      return int_find_d<T, fa::kInt4>(D, extra, ifn, k, smem_extra);
    default: return cudaErrorInvalidValue;
  }
}

// fa_varlen_paged_quant_launch's body for q of type T
template <typename T>
int launch_quant(FA_K8Q_PARAMS) {
  if (page_size <= 0 || page_size % 64 != 0 || Hk <= 0 || Hq % Hk != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || max_seqlen_q <= 0 || Hq == 0) return 0;
  FwdArgs a = {};
  a.q = q; a.k = k; a.v = v; a.slopes = has_alibi ? slopes : nullptr;
  a.out = out; a.lse = lse;
  a.seq.M = max_seqlen_q; a.seq.Tq = Tq; a.seq.cu_q = cu_q;
  a.seq.seqused_k = seqused_k; a.seq.leftpad_k = leftpad_k;
  a.B = B; a.Hq = Hq; a.Hk = Hk; a.group = Hq / Hk; a.scale = scale;
  a.mp_.causal = causal; a.mp_.window_left = window_left;
  a.mp_.window_right = window_right; a.mp_.softcap = softcap;
  a.mp_.has_alibi = has_alibi;
  a.pg.table = table; a.pg.table_stride = table_stride;
  a.pg.seqlens_k = seqlens_k; a.pg.ks = ks; a.pg.vs = vs;
  a.pg.page_size = page_size; a.pg.mp = mp;
  a.pg.s_h = s_h; a.pg.s_p = s_p; a.pg.s_tok = s_tok;
  a.pg.sc_h = sc_h; a.pg.sc_p = sc_p; a.pg.sc_tok = sc_tok;
  const bool extra = needs_extra(a);
  const int tb = table_bytes(mp);
  void (*ifn)(IntArgs) = nullptr;
  Kernel kn;
  cudaError_t e = find_kind<T>(kind, D, extra, &ifn, &kn, tb);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ifn == nullptr)   // fp8: the body takes softmax_scale in any domain
    return static_cast<int>(launch_kernel(kn, a, tb, st));
  IntArgs ia;
  ia.f = a;
  ia.f.scale = exp2_domain ? scale * kLog2e : scale;
  ia.slope_mult = slope_mult;
  ia.exp2_domain = exp2_domain;
  const int tiles = (max_seqlen_q + kn.rows - 1) / kn.rows;
  ifn<<<tiles * Hq * B, kn.threads, kn.smem + tb, st>>>(ia);
  return static_cast<int>(cudaGetLastError());
}

// fa_varlen_paged_quant_occupancy's body for q of type T
template <typename T>
int occupancy_quant(int kind, int D, int extra, int* out) {
  void (*ifn)(IntArgs) = nullptr;
  Kernel kn;
  cudaFuncAttributes attr;
  cudaError_t e = find_kind<T>(kind, D, extra != 0, &ifn, &kn, 0);
  const void* fn = ifn ? reinterpret_cast<const void*>(ifn)
                       : reinterpret_cast<const void*>(kn.fn);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, fn);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[1] = kn.smem;
  out[2] = kn.threads;
  out[3] = attr.numRegs;
  out[4] = static_cast<int>(attr.localSizeBytes);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, fn, kn.threads, kn.smem));
}

}  // namespace

// the fp16 and fp32 q types' bodies, each in a translation unit of its own
namespace fa {
namespace k8q {
int launch_f16(FA_K8Q_PARAMS);
int launch_f32(FA_K8Q_PARAMS);
int occupancy_f16(int kind, int D, int extra, int* out);
int occupancy_f32(int kind, int D, int extra, int* out);
}  // namespace k8q
}  // namespace fa
