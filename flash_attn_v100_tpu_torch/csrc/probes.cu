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
// Shape: K1's tile at D 128 (csrc/fwd_body.cuh): 128 q rows a block, 16 a
// warp, S = Q K^T a wgmma from 128-byte-swizzled Q and K tiles, O += P V a
// wgmma with P from registers; step s issues S(s), rescales O by the last
// step's alpha while S runs, issues P(s - 1) V(s - 1) and runs the softmax
// of S(s) while the second product is on the tensor cores (so only packing
// P(s) to bf16, into the registers P V reads, waits for P V).  Simplified
// against K1: no masks (M a multiple of 128, N of BK), one dtype.  The
// schedule around it is FA3's (its warp-specialised forward), not K1's:
//   * Roles.  Three warpgroups: a producer and two consumers of 64 q rows
//     each; setmaxnreg leaves the producer 24 registers and gives each
//     consumer thread 240.  One producer thread loads Q once and every
//     step's K and V tiles by TMA (cp.async.bulk.tensor over 4-D maps of
//     (D, rows, heads, batch): the strided variant's runtime strides are
//     the map's), and each stage's k-side and segment words by
//     cp.async.bulk on K's barrier; it reads the pair table and the device
//     trip count itself.
//   * Ring.  K and V each have a full and an empty mbarrier a stage
//     (csrc/tma_pipe.cuh) in a ring of 3 stages (2 for the 128-key step): a
//     consumer waits for the bytes of the tile it needs, and each of its
//     warps releases a K stage once S and the softmax have read it, a V
//     stage once P V has.  No block-wide barrier runs after the set-up.  A
//     variant without P V loads no V (the TPU probe's BlockSpec streams it
//     unread: L2 traffic that would hide what S costs).
//   * Ping-pong.  The two consumers take turns to issue their products
//     through two named barriers, so one warpgroup's softmax runs while the
//     other's products are on the tensor cores, on top of each warpgroup's
//     own S(s) / P(s - 1) V(s - 1) overlap.
// The products and the online update run in K1's order, so each variant's
// output is what K1's schedule (a two-stage cp.async ring refilled by the
// consumers themselves, a block-wide barrier a step) gives, and what a
// stage costs here is what it costs under FA3's schedule.  The features:
//   kWide     BK = 128 keys a step (P1's kernel2: twice the keys a step,
//             one online update over them) instead of K1's 64;
//   kLse      the LSE epilogue (P2 +lse);
//   kPairs    the key tile of each step and the end of the block's run read
//             from a (4, T) int32 table (qi, ki, first, last) in device
//             memory, a block's run starting at entry q tile x tiles a row
//             (P2's pair grid): the producer reads the tiles, the
//             consumers only the "last" words that end their loop;
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
#include "tma_pipe.cuh"

namespace {

using namespace fa::tma;
using T = __nv_bfloat16;
constexpr int kD = 128;
using Path = WgPath<T, kD>;
constexpr int kConsumers = 2;                   // warpgroups of 64 q rows
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kBQ = 64 * kConsumers;
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
// named barriers: kTurnBar + w, consumer w's turn to issue its products;
// kOwnBar + w, consumer w's 128 threads
constexpr int kTurnBar = 1, kOwnBar = 3;

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
  T* out;
  float* lse;
  // strided: out's (batch, head, row) strides in elements, the LSE's
  // (batch, head)
  long long os[3], ls[2];
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
  static constexpr int S = BK == 64 ? 3 : 2;   // ring stages
  static constexpr int NQS = (F >> kQsideShift) & 3;
  static constexpr int NKS = (F >> kKsideShift) & 3;
  // int32 words a key in the stage: the k-side streams, then the segment
  static constexpr int KW = NKS + ((F & kBranches) ? 1 : 0);
  static constexpr size_t q_tile = Path::template tile_bytes<64>();
  static constexpr size_t stage_off = align1k(kConsumers * q_tile);
  static constexpr size_t k_off = 0;
  static constexpr size_t v_off = Path::template tile_bytes<BK>();
  static constexpr size_t w_off = 2 * v_off;
  static constexpr size_t stage_bytes = align1k(w_off + 4 * BK * KW);
  // K's transactions a stage: the tile and its words
  static constexpr uint32_t k_tx = static_cast<uint32_t>(v_off + 4 * BK * KW);
  // full_q, then full_k, full_v, empty_k, empty_v [S] each
  static constexpr size_t bar_off = stage_off + S * stage_bytes;
  static constexpr size_t bytes = bar_off + 8 * (1 + 4 * S) + 1024;
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
__global__ void __launch_bounds__(kThreads, 1)
    probe_kernel(const __grid_constant__ CUtensorMap map_q,
                 const __grid_constant__ CUtensorMap map_k,
                 const __grid_constant__ CUtensorMap map_v,
                 const ProbeArgs a) {
  using L = Layout<F>;
  constexpr int BK = L::BK, S = L::S, NQS = L::NQS, NKS = L::NKS, D = kD;
  constexpr bool MAX = F & kMax, EXP = F & kExp, BEXP = F & kBf16Exp;
  constexpr bool SUM = F & kSum, PV = F & kPv, LSE = F & kLse;
  constexpr bool PAIRS = F & kPairs, STRIDED = F & kStrided;
  constexpr bool DYN = F & kDynamic, BR = F & kBranches;
  constexpr bool READS_S = MAX || EXP || BEXP || SUM || PV;
  static_assert(!LSE || (MAX && SUM), "the LSE epilogue reads m and l");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = smem_base(smem_raw);
  uint64_t* full_q = reinterpret_cast<uint64_t*>(smem + L::bar_off);
  uint64_t* full_k = full_q + 1;
  uint64_t* full_v = full_k + S;
  uint64_t* empty_k = full_v + S;
  uint64_t* empty_v = empty_k + S;
  auto stage = [&](int st) {
    return smem + L::stage_off + st * L::stage_bytes;
  };

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

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int i = 0; i < S; ++i) {
      mbar_init(&full_k[i], 1);
      mbar_init(&full_v[i], 1);
      mbar_init(&empty_k[i], 4 * kConsumers);   // each consumer warp's
      mbar_init(&empty_v[i], 4 * kConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ----------------------------------------------------------- producer
    regs_dec<kProducerRegs>();
    if (threadIdx.x != 0) return;
    const int kvh = h / (a.Hq / a.Hk);
    // Q: each consumer's 64 rows as two 64-column boxes
    mbar_expect_tx(full_q, static_cast<uint32_t>(kConsumers * L::q_tile));
#pragma unroll
    for (int w = 0; w < kConsumers; ++w)
#pragma unroll
      for (int c = 0; c < 2; ++c)
        load_4d(smem + w * L::q_tile + c * 64 * 128, &map_q, full_q, 64 * c,
                qt * kBQ + 64 * w, h, b);
    const int n_steps = DYN ? *a.trip : a.n_steps;
    Ring<S> r;
    for (int t = 0; PAIRS || t < n_steps; ++t) {
      const int kt = PAIRS ? a.pairs[a.n_pairs + t0 + t] : t;
      unsigned char* st = stage(r.stage);
      mbar_wait(&empty_k[r.stage], r.phase ^ 1u);
      mbar_expect_tx(&full_k[r.stage], L::k_tx);
      load_4d(st + L::k_off, &map_k, &full_k[r.stage], 0, kt * BK, kvh, b);
      load_4d(st + L::k_off + BK * 128, &map_k, &full_k[r.stage], 64,
              kt * BK, kvh, b);
      // the tile's k-side words, then its segment words
#pragma unroll
      for (int u = 0; u < L::KW; ++u)
        bulk_copy(st + L::w_off + u * BK * 4,
                  (u < NKS ? a.kside[u < 3 ? u : 0] : a.kseg) + kt * BK,
                  4 * BK, &full_k[r.stage]);
      if constexpr (PV) {
        mbar_wait(&empty_v[r.stage], r.phase ^ 1u);
        mbar_expect_tx(&full_v[r.stage], static_cast<uint32_t>(L::v_off));
        load_4d(st + L::v_off, &map_v, &full_v[r.stage], 0, kt * BK, kvh, b);
        load_4d(st + L::v_off + BK * 128, &map_v, &full_v[r.stage], 64,
                kt * BK, kvh, b);
      }
      r.next();
      if (PAIRS && a.pairs[3 * a.n_pairs + t0 + t]) break;
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  regs_inc<kConsumerRegs>();
  const int wg = threadIdx.x / 128 - 1;
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int wrow = warp * 16;
  const int r0 = wrow + lane / 4;   // this thread's rows r0, r0 + 8 of its
                                    // warpgroup's 64
  unsigned char* q_s = smem + wg * L::q_tile;
  const long long o_rs = STRIDED ? a.os[2] : D;
  T* og = a.out + (STRIDED ? b * a.os[0] + h * a.os[1]
                           : static_cast<long long>(h) * a.M * D) +
          (qt * kBQ + 64 * wg) * o_rs;
  int n_steps = a.n_steps;
  if constexpr (DYN) n_steps = *a.trip;

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

  float o[D / 8][4] = {};
  float m[2] = {-1e30f, -1e30f};
  float l[2] = {0.0f, 0.0f};   // this lane's part of the row sum
  float alpha[2] = {1.0f, 1.0f};
  float dead = 0.0f;           // qk only: S, folded into O times 0

  // one path of the softmax of a tile (its words at w) on the fragments:
  // p in place of s
  auto softmax = [&](const int* w, float (&sc)[BK / 8][4]) {
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
  // the softmax of a tile as the variant takes it: branches reduce the
  // tile's k segment words and take one of three paths, or none (P = 0)
  auto step_softmax = [&](const int* w, float (&sc)[BK / 8][4]) {
    if constexpr (BR) {
      const int* ws = w + NKS * BK;
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
        softmax(w, sc);
      } else if (run && qmin == kmin) {
        softmax(w, sc);
      } else if (run) {
        softmax(w, sc);
      } else {
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[j][e] = 0.0f;
        alpha[0] = alpha[1] = 1.0f;
      }
    } else {
      softmax(w, sc);
    }
  };

  float sc[BK / 8][4];        // S(s), then P(s) in fp32
  uint32_t pa[BK / 16][4];    // P(s - 1) in bf16
  // O by the last softmax's alpha, just before P V adds to it
  auto rescale = [&]() {
    if constexpr (MAX || BR) {
#pragma unroll
      for (int nb = 0; nb < D / 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[nb][e] *= alpha[e / 2];
    }
  };
  auto pack = [&]() {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      pack_a<T>(pa[kk], sc[2 * kk], sc[2 * kk + 1]);
  };
  // tile s + 1 exists (a pair table: tile s was not its run's last)
  auto more_after = [&](int s) {
    if constexpr (PAIRS) return a.pairs[3 * a.n_pairs + t0 + s] == 0;
    return s + 1 < n_steps;
  };
  auto words = [&](int st) {
    return reinterpret_cast<const int*>(stage(st) + L::w_off);
  };
  // a warp is done with a stage: its lane 0 arrives for it
  auto release = [&](uint64_t* bar) {
    __syncwarp();
    mbar_arrive(bar, lane == 0);
  };
  // the ping-pong: wait for this warpgroup's turn to issue, then hand the
  // turn to the other; the first consumer holds the first turn
  auto turn_wait = [&]() { bar_sync(kTurnBar + wg, 256); };
  auto turn_pass = [&]() { bar_arrive(kTurnBar + (wg ^ 1), 256); };
  if (wg == 0) bar_arrive(kTurnBar, 256);

  Ring<S> rk;   // K's stage of step s
  Ring<S> rv;   // V's stage of step s - 1
  mbar_wait(full_q, 0);
  mbar_wait(&full_k[rk.stage], rk.phase);
  turn_wait();
  Path::begin();
  Path::template abt<64, BK>(sc, q_s, wrow, stage(rk.stage) + L::k_off,
                             lane);
  Path::commit();
  turn_pass();
  Path::template wait<0>();
  Path::settle(sc);
  step_softmax(words(rk.stage), sc);
  release(&empty_k[rk.stage]);
  rk.next();
  if constexpr (PV) pack();
  bool more = more_after(0);
  for (int s = 1; more; ++s) {
    more = more_after(s);
    mbar_wait(&full_k[rk.stage], rk.phase);
    turn_wait();
    Path::begin();
    Path::template abt<64, BK>(sc, q_s, wrow, stage(rk.stage) + L::k_off,
                               lane);
    Path::commit();
    if constexpr (PV) {
      // O (P V through s - 2, done) by alpha(s - 1) while S(s) runs
      rescale();
      Path::begin();
      mbar_wait(&full_v[rv.stage], rv.phase);
      Path::template ab<BK, D>(o, pa, stage(rv.stage) + L::v_off, 0, lane);
      Path::commit();
      turn_pass();
      Path::template wait<1>();
    } else {
      turn_pass();
      Path::template wait<0>();
    }
    Path::settle(sc);
    step_softmax(words(rk.stage), sc);
    release(&empty_k[rk.stage]);
    rk.next();
    if constexpr (PV) {
      Path::template wait<0>();
      Path::settle(o);
      // P(s - 1) was an operand of the product just waited for
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          asm volatile("" : "+r"(pa[kk][e]) :: "memory");
      pack();
      release(&empty_v[rv.stage]);
      rv.next();
    }
  }
  if constexpr (PV) {
    mbar_wait(&full_v[rv.stage], rv.phase);
    turn_wait();
    rescale();
    Path::begin();
    Path::template ab<BK, D>(o, pa, stage(rv.stage) + L::v_off, 0, lane);
    Path::commit();
    turn_pass();
    Path::template wait<0>();
    Path::settle(o);
  }
  // the other consumer's last turn, taken: the turn barriers end even
  if (wg == 0) turn_wait();

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
  bar_sync(kOwnBar + wg, 128);   // every product of this warpgroup read Q
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
  bar_sync(kOwnBar + wg, 128);
  constexpr int kChunks = D / 8;
  for (int idx = threadIdx.x % 128; idx < 64 * kChunks; idx += 128) {
    const int r = idx / kChunks, c8 = idx % kChunks;
    *reinterpret_cast<uint4*>(og + r * o_rs + c8 * 8) =
        *reinterpret_cast<const uint4*>(q_s + Path::template chunk<64>(r, c8));
  }
}

// a (D, rows, heads, batch) map of bf16 rows under element strides s
// (batch, head, row), boxes of 64 columns x box_rows
cudaError_t encode_rows(CUtensorMap* map, const void* base, int rows,
                        int heads, int batch, const long long* s,
                        int box_rows) {
  const uint64_t dims[4] = {static_cast<uint64_t>(kD),
                            static_cast<uint64_t>(rows),
                            static_cast<uint64_t>(heads),
                            static_cast<uint64_t>(batch)};
  const uint64_t strides[3] = {2ull * s[2], 2ull * s[1], 2ull * s[0]};
  const uint32_t box[4] = {64u, static_cast<uint32_t>(box_rows), 1u, 1u};
  return encode_map<4>(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, dims,
                       strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int F>
cudaError_t launch_variant(const void* q, const void* k, const void* v,
                           const long long* qs, const long long* ks,
                           const long long* vs, const ProbeArgs& a,
                           cudaStream_t stream) {
  using L = Layout<F>;
  CUtensorMap mq, mk, mv;
  cudaError_t e = encode_rows(&mq, q, a.M, a.Hq, a.B, qs, 64);
  if (e == cudaSuccess) e = encode_rows(&mk, k, a.N, a.Hk, a.B, ks, L::BK);
  if (e == cudaSuccess) e = encode_rows(&mv, v, a.N, a.Hk, a.B, vs, L::BK);
  if (e != cudaSuccess) return e;
  static bool configured = false;
  if (!configured) {
    e = cudaFuncSetAttribute(probe_kernel<F>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(L::bytes));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const int tiles = a.M / kBQ;
  const dim3 grid = (F & kStrided) ? dim3(tiles, a.Hq, a.B)
                                   : dim3(tiles * a.Hq, 1, 1);
  probe_kernel<F><<<grid, kThreads, L::bytes, stream>>>(mq, mk, mv, a);
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
// v, out: batch, head, row; lse: batch, head; all 0 for the 3-D variants,
// whose (BH, rows, D) tensors are contiguous), B, Hq, Hk, M, N, the key
// tiles (a table's tiles a row), the trip-count word, the pair table and
// its length, three q-side and three k-side stream pointers, the two
// segment vectors, the scale and the stream.  q, k, v and the k-side and
// k segment streams start 16-byte aligned, their row strides too (TMA's).
// Returns a cudaError_t (cudaErrorInvalidValue for flags no instantiation
// has, or a tensor map cuTensorMapEncodeTiled refuses).
extern "C" int fa_probe_launch(
    int flags, const void* q, const void* k, const void* v, void* out,
    float* lse, const long long* strides, int B, int Hq, int Hk, int M,
    int N, int n_steps, const int* trip, const int* pairs, int n_pairs,
    const int* qside0, const int* qside1, const int* qside2,
    const int* kside0, const int* kside1, const int* kside2,
    const int* qseg, const int* kseg, float scale, void* stream) {
  ProbeArgs a = {};
  a.out = static_cast<T*>(out);
  a.lse = lse;
  long long qs[3], ks[3], vs[3];
  const bool strided = flags & kStrided;
  for (int i = 0; i < 3; ++i) {
    qs[i] = strides[i];
    ks[i] = strides[3 + i];
    vs[i] = strides[6 + i];
    a.os[i] = strides[9 + i];
  }
  a.ls[0] = strides[12];
  a.ls[1] = strides[13];
  if (!strided) {   // (BH, rows, D) contiguous, one batch
    const long long q_h = static_cast<long long>(M) * kD;
    const long long k_h = static_cast<long long>(N) * kD;
    qs[0] = Hq * q_h; qs[1] = q_h; qs[2] = kD;
    ks[0] = vs[0] = Hk * k_h; ks[1] = vs[1] = k_h; ks[2] = vs[2] = kD;
  }
  a.B = B; a.Hq = Hq; a.Hk = Hk; a.M = M; a.N = N;
  a.n_steps = n_steps; a.trip = trip; a.pairs = pairs; a.n_pairs = n_pairs;
  a.qside[0] = qside0; a.qside[1] = qside1; a.qside[2] = qside2;
  a.kside[0] = kside0; a.kside[1] = kside1; a.kside[2] = kside2;
  a.qseg = qseg; a.kseg = kseg;
  a.scale = scale;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (flags) {
#define FA_PROBE_CASE(F)                                                \
  case F:                                                               \
    return static_cast<int>(launch_variant<F>(q, k, v, qs, ks, vs, a, st));
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
