// K8q: packed-varlen attention forward with K/V read through a block table
// from an int8, fp8 (e4m3) or int4 HND page pool with per-(token, head)
// fp32 scales, for Hopper (sm_90a).
//
// Replaces the kv_quant branches of
// flash_attn_v100_tpu/ops/pallas/varlen.py::_varlen_fwd_kernel, entered
// through _varlen_fwd_kernel_paged (wrapper flash_attn_varlen_fwd_paged with
// k_scales / v_scales), the engine's large-prefill route over a quantized
// pool.  The contract is K8's (varlen_paged.cu): q (Tq, Hq, D) packed by
// cu_seqlens_q, pools (Hk, P, rows, D) with rows = page_size (int8, e4m3)
// or page_size / 2 (int4, two tokens a byte), scales (Hk, P, page_size, 1);
// out (Tq, Hq, D) in q's dtype and LSE (Hq, Tq) fp32.  The arithmetic is
// the TPU kernel's, in its base-2 softmax domain (natural where softcap is
// on):
//   int8 and int4: the q tile is quantized per row to int8 (amax / 127);
//     S = Q8 K8^T in int32, then float(S) * q_scale * k_scale, times
//     softmax_scale * log2(e); P is multiplied by V's per-token scales and
//     quantized per row over the key tile (amax / 127); P8 V8 in int32,
//     added as float(int) * p_scale after the rescale.
//   fp8: K is converted exactly to q's type and V to bf16; S = Q K^T in
//     fp32, times k_scale; P times V's scales is rounded to bf16 for P V.
// P's grouping: the TPU kernel takes P's int8 scale over its kv step (one
// page at kv_unroll 1); this kernel over each 64-key tile of the
// sequence's cache rows (rows [64 t, 64 t + 64)).  The plain twin
// (ops/cuda/varlen.py::flash_attn_varlen_fwd_paged_ref, p_tile=64) groups
// the same way.  Both paths compute the softmax in base 2 (a score of the
// natural domain is turned into log2 units before its exponential) and
// give the LSE in the natural log.
//
// What bounds it on this card: operations.  A 512-token prefill does
// 4 * D operations per (q row, key) pair against K/V bytes read once per q
// tile: the floor is the operations over 1,979 TOPS of the int8 tensor
// cores (int8, int4) or 989 TFLOP/s of bf16 (fp8, whose products stay
// 16-bit).
//
// What the design does about it:
//   * fp8 is K8's schedule: the paged instantiation of the forward body
//     (csrc/fwd_body.cuh) with e4m3 K/V tiles converted in registers, the
//     tile's scales in its stage, wgmma at D 64/128 and mma.sync at 32/256.
//   * int8 and int4 run a kernel of their own on the int8 tensor cores
//     (mma.sync m16n8k32, int32 accumulators), with S, P and O in
//     registers.  A block is 4 warps of 16 q rows (64 rows; two or three
//     blocks an SM, whose barriers do not hold each other) sharing each
//     64-key tile of a two-stage ring, tile s + 1 copied during step s
//     (running P(s - 1) V(s - 1) during the softmax of S(s), as the body
//     does, took 204 registers at D 64 against 167 and lost more to the
//     third block an SM than the overlap won).  The key step stays 64
//     cache-row-aligned keys at every head dim: it is P's int8 group.  Q is
//     quantized once per block into shared memory, its A fragments read
//     from there once (D <= 128) or at every step (D 256).  K8 is stored [key][dim] (K-major, B of Q K^T) by
//     cp.async (int8) or by a register pass that unpacks int4.  An 8-bit
//     B operand must be K-major, and neither ldmatrix's nor wgmma's
//     transpose takes 8-bit types, so V goes through registers into a
//     transposed tile, [dim][key], 4 x 4 bytes at a time.  Its keys are
//     permuted within each 32 so that the accumulator layout of S, in
//     which a thread holds keys 8 j + 2 (lane % 4) + {0, 1}, is the A
//     layout of P V, which wants keys 4 (lane % 4) + {0..3} and + 16:
//     P8's A fragment for keys [32 kk, 32 kk + 32) packs n-blocks 4 kk,
//     4 kk + 1 (then 4 kk + 2, 4 kk + 3) of the thread's S fragments, and
//     column 16 h + 4 q + 2 a + b of V's tile holds key 16 h + 2 q + 8 a + b
//     (FA3's trick for fp8).  On the fragments: float(S) * q_scale *
//     k_scale and the bias, the row max over the quad, P times the v
//     scale, the row amax over the quad for P's scale, rint(p / p_scale)
//     into int8 A fragments; P8 V8 accumulates in int32 64 columns at a
//     time and is added to O as float(int) * p_scale after the rescale.
//     The conversions between int32 and fp32 (S, P, the P V sums) are
//     exact float additions of 1.5 * 2^23 rather than conversion
//     instructions, which run at a quarter of the FMA rate.
//     Masks on edge tiles only, heaviest q tiles first, the block's pages
//     read into shared memory once, as K8.
#include <stdint.h>

#include "fwd_body.cuh"
#include "quant.cuh"

namespace {

// ----------------------------------------------------------- int8 / int4

// shared memory of the int kernel: Q8 and the q scales, then two stages of
// K8 [key][dim], V8^T [dim][key] and the tile's k and v scales, then the
// block table.  Rows padded by 16 bytes: the 8 rows an ldmatrix phase
// reads fall in 8 distinct 16-byte bank groups.
template <int D>
struct IntSmem {
  static constexpr int kWarps = 4;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int BQ = 16 * kWarps;   // q rows a block
  static constexpr int BK = 64;            // keys a step: P's int8 group
  static constexpr int QLD = D + 16;       // bytes a Q8 / K8 row
  static constexpr int VLD = BK + 16;      // bytes a V8^T row
  static constexpr size_t qs_off = static_cast<size_t>(BQ) * QLD;
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

template <typename T, int D, int KIND, bool EXTRA>
__global__ void __launch_bounds__(IntSmem<D>::kThreads)
    int_kernel(IntArgs ia) {
  using L = IntSmem<D>;
  constexpr int BQ = L::BQ, BK = L::BK, NT = L::kThreads;
  constexpr int QLD = L::QLD, VLD = L::VLD;
  constexpr bool kQRegs = D <= 128;   // Q8's A fragments held in registers
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
    {
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
    __syncwarp();
    float qsc[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) qsc[i] = qs_s[16 * warp + lane / 4 + 8 * i];
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

      // S = Q8 K8^T, this warp's 16 rows x 64 keys
      int si[BK / 8][4] = {};
      const unsigned char* kb = b_addr(st + L::k_off, QLD);
#pragma unroll
      for (int kk = 0; kk < D / 32; ++kk) {
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
            float v = i2f(si[j][e]) * qsc[i] * (e % 2 ? kq.y : kq.x);
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

      // O = alpha O + p_scale (P8 V8), NC columns at a time
      const unsigned char* vb = b_addr(st + L::v_off, VLD);
#pragma unroll
      for (int c = 0; c < D / NC; ++c) {
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
    for (int nb = 0; nb < D / 8; ++nb)
      *reinterpret_cast<uint32_t*>(row + nb * 8) =
          pack2<T>(o[nb][2 * i] * inv, o[nb][2 * i + 1] * inv);
    if (lane % 4 == 0)
      a.lse[sq.lse_index(h, qp[i])] =
          l[i] == 0.0f ? -INFINITY : m[i] * kLn2 + logf(l[i]);
  }
}

// the int kernel's variant, its shared-memory limit raised on first use
// (to the largest block table it has been launched with, `extra` bytes)
template <typename T, int D, int KIND, bool EXTRA>
cudaError_t int_variant(void (**fn)(IntArgs), Kernel* k, int extra) {
  using L = IntSmem<D>;
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

// the variant of (kind, dtype, D, extra): the int kernel's entry in *ifn
// (int8, int4) or the fp8 body's in k->fn
cudaError_t find_variant(int kind, int dtype, int D, bool extra,
                         void (**ifn)(IntArgs), Kernel* k, int smem_extra) {
  const bool bf = dtype == 0;
  switch (kind) {
    case fa::kFp8:
      *ifn = nullptr;
      return bf ? find_d<__nv_bfloat16, kPaged, kKvFp8>(D, extra, k,
                                                        smem_extra)
                : find_d<__half, kPaged, kKvFp8>(D, extra, k, smem_extra);
    case fa::kInt8:
      return bf ? int_find_d<__nv_bfloat16, fa::kInt8>(D, extra, ifn, k,
                                                       smem_extra)
                : int_find_d<__half, fa::kInt8>(D, extra, ifn, k, smem_extra);
    case fa::kInt4:
      return bf ? int_find_d<__nv_bfloat16, fa::kInt4>(D, extra, ifn, k,
                                                       smem_extra)
                : int_find_d<__half, fa::kInt4>(D, extra, ifn, k, smem_extra);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// kind: 0 = int8, 1 = fp8 (e4m3), 2 = int4; dtype (of q): 0 = bf16,
// 1 = fp16.  scale is softmax_scale; slope_mult and exp2_domain give the
// TPU kernel's softmax domain (base 2 unless softcap is on: ALiBi slopes
// times slope_mult, log2(e) there).  Payload strides in bytes, scale
// strides in floats.  Returns cudaGetLastError() of the launch.
extern "C" int fa_varlen_paged_quant_launch(
    int kind, int dtype, const void* q, const void* k, const void* v,
    const float* ks, const float* vs, const int* table, int table_stride,
    const int* cu_q, const int* seqlens_k, const int* seqused_k,
    const int* leftpad_k, const float* slopes, void* out, float* lse,
    long long s_h, long long s_p, long long s_tok, long long sc_h,
    long long sc_p, long long sc_tok, int B, int Tq, int Hq, int Hk, int D,
    int page_size, int mp, int max_seqlen_q, float scale, float slope_mult,
    int exp2_domain, int causal, int window_left, int window_right,
    float softcap, int has_alibi, void* stream) {
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
  cudaError_t e = find_variant(kind, dtype, D, extra, &ifn, &kn, tb);
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

// The occupancy of K8q for (kind, dtype, D), in the variant without bias
// (extra 0) or with (extra 1), without the block table's bytes: out[0]
// resident blocks a multiprocessor, out[1] dynamic shared memory a block
// (bytes), out[2] threads a block, out[3] registers a thread, out[4] local
// memory a thread (bytes: spills and stack).  Returns a cudaError_t.
extern "C" int fa_varlen_paged_quant_occupancy(int kind, int dtype, int D,
                                               int extra, int* out) {
  void (*ifn)(IntArgs) = nullptr;
  Kernel kn;
  cudaFuncAttributes attr;
  cudaError_t e = find_variant(kind, dtype, D, extra != 0, &ifn, &kn, 0);
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
