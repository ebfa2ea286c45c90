// P1-P3: the flash-step cost probes for Hopper (sm_90a), one templated kernel
// family whose features are template parameters (the bits of F), so each
// variant is its own instantiation with no runtime branch in the timed loop.
//
// Replaces the TPU probes of the repository's benchmark folder:
//   P1 benchmarks/prof_softmax_cost.py::kernel :25 (stages toggled) and
//      ::kernel2 :118 (a wider key step);
//   P2 benchmarks/prof_fwd_gap.py::make_minimal.kernel :52,
//      make_lse.kernel :91, make_prefetch.kernel :147, make_4d.kernel :200;
//   P3 benchmarks/prof_small_streams.py::make.kernel :53,
//      make_dynamic_grid.kernel :129, make_branches.kernel :171.
// Their plain twin, the function each variant computes and the variants'
// flags: flash_attn_v100_tpu_torch/ops/cuda/probes.py.
//
// The function (bf16, D 128): q (BH, M, D) (the 4-D variant (B, Hq, M, D)
// under strides) against k/v (BHk, N, D), q head h reading kv head
// h / (BH / BHk).  Per q row: m = -1e30, l = 0, acc = 0; for each key tile
// of BK keys, s = fp32(q . k) * scale (+ the side streams' int32 words
// summed and multiplied by 0.0), then the stages the variant names:
//   max      m' = max(m, rowmax s), alpha = exp2(m - m'), m = m'
//            (without it m stays -1e30 and alpha = 1);
//   exp      p = exp2(s - m) (without it p = s);
//   bf16exp  p = bf16(exp2(bf16(s - m)));
//   sum      l = alpha l + rowsum p;
//   pv       acc = alpha acc + bf16(p) V;
// and the output is acc in bf16 (unnormalised), or with the LSE epilogue
// acc * where(l == 0, 0, 1/l) and LSE = where(l == 0, -inf,
// m * 0.6931 + ln l) fp32 (B, Hq, M).  Without max, exp gives
// exp2(s + 1e30) = inf and the output is NaN: the twin holds the same
// non-finite pattern.  A value no output reads (S in the qk-only variant,
// l without the LSE epilogue) is folded into the output times 0.0f, which
// nvcc does not fold away without fast-math, so its work stays in the
// binary (chip_smoke.py counts each instantiation's HGMMA and MUFU.EX2
// instructions in the SASS).
//
// Shape: K1's at D 128 (csrc/fwd_body.cuh): a block of two warpgroups owns
// 128 q rows, each warp 16; S = Q K^T a wgmma from 128-byte-swizzled Q and
// K tiles, O += P V a wgmma with P from registers; K, V (and the k-side
// words) stream through a two-stage cp.async ring, K(s + 1) and V(s) copied
// during step s; step s issues S(s) and P(s - 1) V(s - 1) and runs the
// softmax of S(s) while the second product is on the tensor cores.  So a
// stage's cost here speaks of K1's step.  Simplified against K1: no masks
// (M a multiple of 128, N of BK), one dtype.  The features:
//   kWide     BK = 128 keys a step (P1's kernel2: twice the keys a step,
//             one online update over them) instead of K1's 64;
//   kLse      the LSE epilogue (P2 +lse);
//   kPairs    the key tile of each step and the end of the block's run read
//             from a (4, T) int32 table (qi, ki, first, last) in device
//             memory, a block's run starting at entry q tile x tiles a row
//             (P2's pair grid);
//   kStrided  (B, Hq, M, D) operands under runtime strides and a
//             (q tile, head, batch) grid (P2's 4-D layout);
//   streams   0-3 q-side (M,) and 0-3 k-side (N,) int32 vectors: q-side
//             words read once a block, k-side words copied with each K tile
//             into the stage (P3);
//   kDynamic  the key-tile count read by every block from device memory, as
//             csrc/seq.cuh reads sequence bounds; otherwise a kernel
//             argument (the constant bank, as K1's dense blocks get theirs);
//   kBranches a q (M,) and a k (N,) int32 segment vector: the block reduces
//             its q words once and each tile's k words every step (min and
//             max over warp shuffles) and takes one of three paths that run
//             the same softmax (only the first is taken when the segments
//             are uniform); a tile with no overlap gives P = 0, alpha = 1,
//             as the TPU kernel's skipped step (P3's branches).  No product
//             sits in a branch (csrc/fwd_body.cuh).
//
// What bounds it: operations, 2 or 4 * D flops a (q row, key) pair over the
// 989 TFLOP/s of the bf16 tensor cores, as K1.
#include <climits>

#include "fwd_body.cuh"

namespace {

using T = __nv_bfloat16;
constexpr int kD = 128;
using Path = WgPath<T, kD>;
constexpr int kThreads = 256;
constexpr int kBQ = 128;

// feature bits of a variant (ops/cuda/probes.py::Probe.flags)
constexpr int kMax = 1 << 0;
constexpr int kExp = 1 << 1;
constexpr int kBf16Exp = 1 << 2;
constexpr int kSum = 1 << 3;
constexpr int kPv = 1 << 4;
constexpr int kLse = 1 << 5;
constexpr int kPairs = 1 << 6;
constexpr int kStrided = 1 << 7;
constexpr int kQsideShift = 8;    // 2 bits: q-side streams
constexpr int kKsideShift = 10;   // 2 bits: k-side streams
constexpr int kDynamic = 1 << 12;
constexpr int kBranches = 1 << 13;
constexpr int kWide = 1 << 14;

struct ProbeArgs {
  const T* q;
  const T* k;
  const T* v;
  T* out;
  float* lse;
  // strided: (batch, head, row) strides in elements of q, k, v, out; the
  // LSE's (batch, head)
  long long qs[3], ks[3], vs[3], os[3], ls[2];
  int B, Hq, Hk, M, N;
  int n_steps;          // key tiles (a pair table's tiles a row)
  const int* trip;      // dynamic: the key-tile count
  const int* pairs;     // (4, n_pairs): qi, ki, first, last
  int n_pairs;
  const int* qside[3];  // (M,) each
  const int* kside[3];  // (N,) each
  const int* qseg;      // branches: (M,), (N,)
  const int* kseg;
  float scale;
};

template <int F>
struct Layout {
  static constexpr int BK = (F & kWide) ? 128 : 64;
  static constexpr int NQS = (F >> kQsideShift) & 3;
  static constexpr int NKS = (F >> kKsideShift) & 3;
  // int32 words a key in the stage: the k-side streams, then the segment
  static constexpr int KW = NKS + ((F & kBranches) ? 1 : 0);
  static constexpr size_t q_tile = Path::template tile_bytes<64>();
  static constexpr size_t stage_off = align1k(2 * q_tile);
  static constexpr size_t k_off = 0;
  static constexpr size_t v_off = Path::template tile_bytes<BK>();
  static constexpr size_t w_off = 2 * v_off;
  static constexpr size_t stage_bytes = align1k(w_off + 4 * BK * KW);
  static constexpr size_t bytes = stage_off + 2 * stage_bytes + 1024;
};

// lo = the warp's min of lo, hi its max of hi
__device__ __forceinline__ void warp_minmax(int& lo, int& hi) {
#pragma unroll
  for (int o = 16; o > 0; o /= 2) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
}

template <int F>
__global__ void __launch_bounds__(kThreads) probe_kernel(ProbeArgs a) {
  using L = Layout<F>;
  constexpr int BK = L::BK, NQS = L::NQS, NKS = L::NKS, D = kD;
  constexpr bool MAX = F & kMax, EXP = F & kExp, BEXP = F & kBf16Exp;
  constexpr bool SUM = F & kSum, PV = F & kPv, LSE = F & kLse;
  constexpr bool PAIRS = F & kPairs, STRIDED = F & kStrided;
  constexpr bool DYN = F & kDynamic, BR = F & kBranches;
  constexpr bool READS_S = MAX || EXP || BEXP || SUM || PV;
  static_assert(!LSE || (MAX && SUM), "the LSE epilogue reads m and l");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = smem_base(smem_raw);

  int b = 0, h, qt;
  if constexpr (STRIDED) {
    qt = blockIdx.x;
    h = blockIdx.y;
    b = blockIdx.z;
  } else {
    h = blockIdx.x % a.Hq;
    qt = blockIdx.x / a.Hq;
  }
  // a pair table's run for this block starts at q tile x tiles a row; its
  // q tile is the table's
  const int t0 = PAIRS ? qt * a.n_steps : 0;
  if constexpr (PAIRS) qt = a.pairs[t0];
  const int kvh = h / (a.Hq / a.Hk);
  const long long q_rs = STRIDED ? a.qs[2] : D;
  const long long k_rs = STRIDED ? a.ks[2] : D;
  const long long v_rs = STRIDED ? a.vs[2] : D;
  const long long o_rs = STRIDED ? a.os[2] : D;
  const T* qg = a.q + (STRIDED ? b * a.qs[0] + h * a.qs[1]
                               : static_cast<long long>(h) * a.M * D) +
                qt * kBQ * q_rs;
  const T* kg = a.k + (STRIDED ? b * a.ks[0] + kvh * a.ks[1]
                               : static_cast<long long>(kvh) * a.N * D);
  const T* vg = a.v + (STRIDED ? b * a.vs[0] + kvh * a.vs[1]
                               : static_cast<long long>(kvh) * a.N * D);
  T* og = a.out + (STRIDED ? b * a.os[0] + h * a.os[1]
                           : static_cast<long long>(h) * a.M * D) +
          qt * kBQ * o_rs;
  int n_steps = a.n_steps;
  if constexpr (DYN) n_steps = *a.trip;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wg = warp / 4;
  const int wrow = (warp % 4) * 16;
  const int r0 = wrow + lane / 4;   // this thread's rows r0, r0 + 8 of its
                                    // warpgroup's 64
  unsigned char* q_s = smem + wg * L::q_tile;

  // the q-side words of this thread's rows, summed in stream order
  float qsum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = qt * kBQ + 64 * wg + r0 + 8 * i;
#pragma unroll
    for (int u = 0; u < NQS; ++u)
      qsum[i] += static_cast<float>(a.qside[u][row]);
  }
  // branches: the block's q segment words, reduced once
  int qmin = 0, qmax = 0;
  if constexpr (BR) {
    qmin = INT_MAX;
    qmax = INT_MIN;
#pragma unroll
    for (int r = lane; r < kBQ; r += 32) {
      const int w = a.qseg[qt * kBQ + r];
      qmin = min(qmin, w);
      qmax = max(qmax, w);
    }
    warp_minmax(qmin, qmax);
  }

  auto stage = [&](int t) {
    return smem + L::stage_off + (t & 1) * L::stage_bytes;
  };
  // key tile of step t: the table's, or t
  auto tile_of = [&](int t) {
    if constexpr (PAIRS) return a.pairs[a.n_pairs + t0 + t];
    return t;
  };
  auto copy_k = [&](int t) {
    const int kt = tile_of(t);
    load_strided_async<T, D, BK, kThreads, Path>(
        stage(t) + L::k_off, kg + kt * BK * k_rs, k_rs, 0, BK - 1);
    if constexpr (L::KW > 0) {
      // the tile's k-side words, then its segment words, 16 bytes a copy
      constexpr int kChunks = BK / 4;
      if (threadIdx.x < kChunks * L::KW) {
        const int u = threadIdx.x / kChunks, c = threadIdx.x % kChunks;
        const int* src = a.kseg;   // u == NKS
#pragma unroll
        for (int x = 0; x < NKS; ++x)
          if (u == x) src = a.kside[x];
        cp_async16(stage(t) + L::w_off + (u * BK + 4 * c) * 4,
                   src + kt * BK + 4 * c, true);
      }
    }
  };
  auto copy_v = [&](int t) {
    load_strided_async<T, D, BK, kThreads, Path>(
        stage(t) + L::v_off, vg + tile_of(t) * BK * v_rs, v_rs, 0, BK - 1);
  };
  // step t's copies, after the barrier that frees their stages
  auto copies = [&](int t, bool next_k, bool this_v) {
    cp_async_wait<0>();
    Path::copies_landed();
    __syncthreads();
    if (next_k) copy_k(t + 1);
    if (this_v) copy_v(t);
    cp_async_commit();
  };

  float o[D / 8][4] = {};
  float m[2] = {-1e30f, -1e30f};
  float l[2] = {0.0f, 0.0f};   // this lane's part of the row sum
  float alpha[2] = {1.0f, 1.0f};
  float dead = 0.0f;           // qk only: S, folded into O times 0

  // one path of the softmax of tile t on the fragments: p in place of s
  auto softmax = [&](int t, float (&sc)[BK / 8][4]) {
    const int* w = reinterpret_cast<const int*>(stage(t) + L::w_off);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[j][e] * a.scale;
        if constexpr (NQS + NKS > 0) {
          const int c = j * 8 + (lane % 4) * 2 + e % 2;
          float ex = qsum[e / 2];
#pragma unroll
          for (int u = 0; u < NKS; ++u)
            ex += static_cast<float>(w[u * BK + c]);
          x += ex * 0.0f;
        }
        if constexpr (!READS_S) dead += x;
        sc[j][e] = x;
      }
    if constexpr (MAX) {
      float mx[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e] = fmaxf(mx[e], sc[j][e]);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float r = fmaxf(mx[2 * i], mx[2 * i + 1]);
        r = fmaxf(r, __shfl_xor_sync(0xffffffffu, r, 1));
        r = fmaxf(r, __shfl_xor_sync(0xffffffffu, r, 2));
        const float m_next = fmaxf(m[i], r);
        alpha[i] = ex2(m[i] - m_next);
        m[i] = m_next;
      }
    }
    float ls[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float p0 = sc[j][2 * i], p1 = sc[j][2 * i + 1];
        if constexpr (BEXP) {
          // exp2 of the bf16-rounded argument, the result rounded to bf16
          // (ex2.approx.ftz.bf16x2 compiled to the same two MUFU.EX2 a
          // pair and rounded otherwise than to nearest)
          const uint32_t x = pack2<T>(p0 - m[i], p1 - m[i]);
          const uint32_t y = pack2<T>(ex2(__uint_as_float(x << 16)),
                                      ex2(__uint_as_float(x & 0xFFFF0000u)));
          p0 = __uint_as_float(y << 16);
          p1 = __uint_as_float(y & 0xFFFF0000u);
        } else if constexpr (EXP) {
          p0 = ex2(p0 - m[i]);
          p1 = ex2(p1 - m[i]);
        }
        if constexpr (SUM) {
          ls[2 * i] += p0;
          ls[2 * i + 1] += p1;
        }
        sc[j][2 * i] = p0;
        sc[j][2 * i + 1] = p1;
      }
    if constexpr (SUM) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
        l[i] = l[i] * alpha[i] + (ls[2 * i] + ls[2 * i + 1]);
    }
  };
  // the softmax of tile t as the variant takes it: branches reduce the
  // tile's k segment words and take one of three paths, or none (P = 0)
  auto step_softmax = [&](int t, float (&sc)[BK / 8][4]) {
    if constexpr (BR) {
      const int* ws =
          reinterpret_cast<const int*>(stage(t) + L::w_off) + NKS * BK;
      int kmin = INT_MAX, kmax = INT_MIN;
#pragma unroll
      for (int c = lane; c < BK; c += 32) {
        kmin = min(kmin, ws[c]);
        kmax = max(kmax, ws[c]);
      }
      warp_minmax(kmin, kmax);
      const bool run = kmin <= qmax && qmin <= kmax;
      const bool uniform = qmin == qmax && kmin == kmax;
      if (run && uniform) {
        softmax(t, sc);
      } else if (run && qmin == kmin) {
        softmax(t, sc);
      } else if (run) {
        softmax(t, sc);
      } else {
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[j][e] = 0.0f;
        alpha[0] = alpha[1] = 1.0f;
      }
    } else {
      softmax(t, sc);
    }
  };

  float sc[BK / 8][4];        // S(s), then P(s) in fp32
  uint32_t pa[BK / 16][4];    // P(s - 1) in bf16
  auto rescale_pack = [&]() {
    if constexpr (MAX || BR) {
#pragma unroll
      for (int nb = 0; nb < D / 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[nb][e] *= alpha[e / 2];
    }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      pack_a<T>(pa[kk], sc[2 * kk], sc[2 * kk + 1]);
  };
  // tile s + 1 exists (a pair table: tile s was not its run's last)
  auto more_after = [&](int s) {
    if constexpr (PAIRS) return a.pairs[3 * a.n_pairs + t0 + s] == 0;
    return s + 1 < n_steps;
  };

  load_strided_async<T, D, 64, kThreads, Path>(smem, qg, q_rs, 0, 63);
  load_strided_async<T, D, 64, kThreads, Path>(smem + L::q_tile,
                                               qg + 64 * q_rs, q_rs, 0, 63);
  copy_k(0);
  cp_async_commit();   // one group: Q and K(0)
  bool more = more_after(0);
  copies(0, more, true);
  Path::begin();
  Path::template abt<64, BK>(sc, q_s, wrow, stage(0) + L::k_off, lane);
  Path::commit_wait();
  Path::settle(sc);
  step_softmax(0, sc);
  if constexpr (PV) rescale_pack();
  int s = 1;
  for (; more; ++s) {
    more = more_after(s);
    copies(s, more, true);
    Path::begin();
    Path::template abt<64, BK>(sc, q_s, wrow, stage(s) + L::k_off, lane);
    Path::commit();
    if constexpr (PV) {
      Path::template ab<BK, D>(o, pa, stage(s - 1) + L::v_off, 0, lane);
      Path::commit();
      Path::template wait<1>();
    } else {
      Path::template wait<0>();
    }
    Path::settle(sc);
    step_softmax(s, sc);
    if constexpr (PV) {
      Path::template wait<0>();
      Path::settle(o);
      // P(s - 1) was an operand of the product just waited for
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          asm volatile("" : "+r"(pa[kk][e]) :: "memory");
      rescale_pack();
    }
  }
  copies(s, false, false);
  if constexpr (PV) {
    Path::begin();
    Path::template ab<BK, D>(o, pa, stage(s - 1) + L::v_off, 0, lane);
    Path::commit_wait();
    Path::settle(o);
  }

  // epilogue: O (LSE: times 1 / l) through the warpgroup's Q tile as
  // 16-byte rows; values no output reads enter O times 0
  float inv[2] = {1.0f, 1.0f};
  if constexpr (LSE) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      inv[i] = l[i] == 0.0f ? 0.0f : 1.0f / l[i];
    }
  } else if constexpr (SUM) {
    o[0][0] += l[0] * 0.0f;
    o[0][2] += l[1] * 0.0f;
  }
  if constexpr (!READS_S) o[0][0] += dead * 0.0f;
  __syncthreads();   // every product has read Q
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
#pragma unroll
    for (int nb = 0; nb < D / 8; ++nb) {
      const float x0 = LSE ? o[nb][2 * i] * inv[i] : o[nb][2 * i];
      const float x1 = LSE ? o[nb][2 * i + 1] * inv[i] : o[nb][2 * i + 1];
      *reinterpret_cast<uint32_t*>(q_s + Path::template chunk<64>(r, nb) +
                                   (lane % 4) * 4) = pack2<T>(x0, x1);
    }
    if constexpr (LSE) {
      if (lane % 4 == 0) {
        const long long row = qt * kBQ + 64 * wg + r;
        float* lg = a.lse + (STRIDED ? b * a.ls[0] + h * a.ls[1]
                                     : static_cast<long long>(h) * a.M);
        lg[row] = l[i] == 0.0f ? -INFINITY : m[i] * 0.6931f + logf(l[i]);
      }
    }
  }
  __syncthreads();
  constexpr int kChunks = D / 8;
  for (int idx = threadIdx.x % 128; idx < 64 * kChunks; idx += 128) {
    const int r = idx / kChunks, c8 = idx % kChunks;
    *reinterpret_cast<uint4*>(og + (64 * wg + r) * o_rs + c8 * 8) =
        *reinterpret_cast<const uint4*>(q_s + Path::template chunk<64>(r, c8));
  }
}

template <int F>
cudaError_t launch_variant(const ProbeArgs& a, cudaStream_t stream) {
  using L = Layout<F>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        probe_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(L::bytes));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const int tiles = a.M / kBQ;
  const dim3 grid = (F & kStrided) ? dim3(tiles, a.Hq, a.B)
                                   : dim3(tiles * a.Hq, 1, 1);
  probe_kernel<F><<<grid, kThreads, L::bytes, stream>>>(a);
  return cudaGetLastError();
}

// every instantiated variant (ops/cuda/probes.py: P1_VARIANTS,
// P2_VARIANTS, P3_VARIANTS): the F of each
#define FA_PROBE_VARIANTS(X)                                     \
  X(0)       /* P1 qk only */                                    \
  X(16)      /* P1 qk+pv */                                      \
  X(17)      /* P1 qk+max+pv */                                  \
  X(18)      /* P1 qk+exp+pv */                                  \
  X(19)      /* P1 qk+max+exp+pv */                              \
  X(27)      /* P1 full; P2 minimal; P3 no side streams */       \
  X(29)      /* P1 bf16 exp */                                   \
  X(16411)   /* P1 the wide step */                              \
  X(59)      /* P2 +lse */                                       \
  X(123)     /* P2 +prefetch pairs */                            \
  X(187)     /* P2 4d layout */                                  \
  X(2075)    /* P3 2 k-side */                                   \
  X(795)     /* P3 3 q-side */                                   \
  X(2843)    /* P3 3 q-side + 2 k-side */                        \
  X(4123)    /* P3 dynamic trip count */                         \
  X(8219)    /* P3 seg-reduce + 3 branches */

}  // namespace

// One probe launch: flags F of the variant, q/k/v/out/lse, strides (q, k,
// v, out: batch, head, row; lse: batch, head), B, Hq, Hk, M, N, the key
// tiles (a table's tiles a row), the trip-count word, the pair table and
// its length, three q-side and three k-side stream pointers, the two
// segment vectors, the scale and the stream.  Returns a cudaError_t
// (cudaErrorInvalidValue for flags no instantiation has).
extern "C" int fa_probe_launch(
    int flags, const void* q, const void* k, const void* v, void* out,
    float* lse, const long long* strides, int B, int Hq, int Hk, int M,
    int N, int n_steps, const int* trip, const int* pairs, int n_pairs,
    const int* qside0, const int* qside1, const int* qside2,
    const int* kside0, const int* kside1, const int* kside2,
    const int* qseg, const int* kseg, float scale, void* stream) {
  ProbeArgs a = {};
  a.q = static_cast<const T*>(q);
  a.k = static_cast<const T*>(k);
  a.v = static_cast<const T*>(v);
  a.out = static_cast<T*>(out);
  a.lse = lse;
  for (int i = 0; i < 3; ++i) {
    a.qs[i] = strides[i];
    a.ks[i] = strides[3 + i];
    a.vs[i] = strides[6 + i];
    a.os[i] = strides[9 + i];
  }
  a.ls[0] = strides[12];
  a.ls[1] = strides[13];
  a.B = B; a.Hq = Hq; a.Hk = Hk; a.M = M; a.N = N;
  a.n_steps = n_steps; a.trip = trip; a.pairs = pairs; a.n_pairs = n_pairs;
  a.qside[0] = qside0; a.qside[1] = qside1; a.qside[2] = qside2;
  a.kside[0] = kside0; a.kside[1] = kside1; a.kside[2] = kside2;
  a.qseg = qseg; a.kseg = kseg;
  a.scale = scale;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (flags) {
#define FA_PROBE_CASE(F) \
  case F: return static_cast<int>(launch_variant<F>(a, st));
    FA_PROBE_VARIANTS(FA_PROBE_CASE)
#undef FA_PROBE_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// registers, local memory and dynamic shared memory of variant `flags`:
// out[0] registers a thread, out[1] local bytes a thread, out[2] shared
// bytes a block, out[3] resident blocks a multiprocessor
extern "C" int fa_probe_occupancy(int flags, int* out) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaErrorInvalidValue;
  switch (flags) {
#define FA_PROBE_CASE(F)                                              \
  case F:                                                             \
    e = cudaFuncGetAttributes(&attr, probe_kernel<F>);                \
    out[2] = static_cast<int>(Layout<F>::bytes);                      \
    if (e == cudaSuccess)                                             \
      e = cudaFuncSetAttribute(                                       \
          probe_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize, \
          out[2]);                                                    \
    if (e == cudaSuccess)                                             \
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(              \
          &out[3], probe_kernel<F>, kThreads, out[2]);                \
    break;
    FA_PROBE_VARIANTS(FA_PROBE_CASE)
#undef FA_PROBE_CASE
    default: break;
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  return 0;
}
