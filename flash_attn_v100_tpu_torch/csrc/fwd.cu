// K1 (dense) and K5 (packed varlen): attention forward for Hopper
// (sm_90a), one kernel body instantiated for both (csrc/seq.cuh).
//
// K1 replaces flash_attn_v100_tpu/ops/pallas/fwd.py::_fwd_kernel, the TPU
// kernel behind flash_attn_dense_fwd and the forward of flash_attn_func:
// q (B, M, Hq, D), k/v (B, N, Hk, D) contiguous, GQA kv_head = h / group;
// causal/window masks aligned by `offset` (default N - M, ring attention
// passes its own); dropout keyed on absolute (row + q0, col + k0) and
// bh = (b + b0) * num_heads + (h + h0).  Out (B, M, Hq, D), LSE (B, Hq, M).
//
// K5 replaces flash_attn_v100_tpu/ops/pallas/varlen.py::_varlen_fwd_kernel,
// the TPU kernel behind flash_attn_varlen_fwd and the forward of
// flash_attn_varlen_func: q (Tq, Hq, D) packed by cu_seqlens_q, k/v
// (Tk, Hk, D) by cu_seqlens_k, optional seqused_k / leftpad_k; the masks
// aligned per sequence (offs = slk - slq); dropout keyed on within-sequence
// q position, leftpad-relative key position and bh = b * Hq + h.  Out
// (Tq, Hq, D), LSE (Hq, Tq); rows no block covers (past cu_q[B]) are left to
// the caller, which fills them with O = 0 and LSE = -inf.
//
// Both: scale -> ALiBi -> softcap; Philox dropout on the unnormalized P
// after l has summed the pre-dropout P; out in q's dtype, LSE fp32; a row
// with no live key gives O = 0 and LSE = -inf.
//
// What bounds it on this card: operations.  A causal 2048-token sequence
// does 4 * D flops per live (q row, key) pair against each K/V byte read
// once per q tile, far above the ~295 flop/byte ridge, so the floor is the
// flops over the 989 TFLOP/s of the bf16 tensor cores.  Beside the products
// each pair costs an exp2 and a few fp32 operations, which at D 64 take
// about as long as its 256 tensor-core flops.
//
// What the design does about it (K2's shape in csrc/bwd.cu; products and
// live-key intervals in csrc/attn_tiles.cuh):
//   * Work.  One block per (q tile, q head, batch row or sequence), each
//     64 q rows of the tile owned by one warpgroup of 4 warps (16 rows a
//     warp); at D 64/128 two warpgroups share each K/V tile (128 q rows).
//     A varlen block reads its sequence's bounds from device memory and
//     leaves at once if its tile lies past the sequence; the key loop
//     covers only the tiles its rows' causal/window intervals touch (the
//     reference CUDA BlockInfo trim).  Both warpgroups run every tile of
//     the block (one that none of a warpgroup's rows sees gives P = 0), so
//     no product sits in a branch: ptxas serializes every wgmma of a
//     kernel that leaves one in flight across a branch.
//   * Products.  At D 64 and 128 S = Q K^T is a wgmma from 128-byte-
//     swizzled Q and K tiles, both K-major, and O += P V a wgmma with P
//     from registers and V read MN-major through the transpose bit.  At D
//     32 and 256 each warp runs mma.sync m16n8k16 on its own rows, operands
//     through ldmatrix.
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
//   * Tiles (shared memory a block, 16-bit inputs, with 1 KB of alignment
//     slack):
//         D     q rows x keys a step
//         32     64 x 64  mma.sync (28 KB)
//         64    128 x 64  wgmma    (51 KB)
//         128   128 x 64  wgmma    (99 KB)
//         256    64 x 32  mma.sync (103 KB)
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

// 2^x, flushing results below 2^-126 to zero (one MUFU operation)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

struct FwdArgs {
  const void* q;          // dense (B, M, Hq, D); varlen (Tq, Hq, D)
  const void* k;          // dense (B, N, Hk, D); varlen (Tk, Hk, D)
  const void* v;
  const float* slopes;    // (B, Hq) or nullptr
  void* out;              // q's shape
  float* lse;             // dense (B, Hq, M); varlen (Hq, Tq)
  fa::SeqArgs seq;
  int B, Hq, Hk, group;
  float scale;
  fa::MaskParams mp_;
  fa::DropoutParams dp;
};

template <typename T, int D>
struct FwdSmem {
  using P = PathOf<T, D>;
  static constexpr int kGroups = D == 64 || D == 128 ? 2 : 1;  // warpgroups
  static constexpr int kThreads = 128 * kGroups;
  static constexpr int BQ = 64 * kGroups;                  // q rows a block
  static constexpr int BK = D <= 128 ? 64 : 32;            // keys a step
  // a warpgroup's 64-row Q tile (then its O stage)
  static constexpr size_t q_tile = P::template tile_bytes<64>();
  static constexpr size_t stage_off = align1k(kGroups * q_tile);
  // a stage: the K and V tiles and the dropout column words
  static constexpr size_t k_off = 0;
  static constexpr size_t v_off = P::template tile_bytes<BK>();
  static constexpr size_t cw_off = 2 * v_off;
  static constexpr size_t stage_bytes = align1k(cw_off + sizeof(uint32_t) * BK);
  static constexpr size_t bytes = stage_off + 2 * stage_bytes + 1024;
};

// ROWS rows of a (rows, H, D) tensor from row row0, head h, into a tile in
// P's layout, NT threads, 16 bytes a copy; tile rows outside [lo, hi] are
// zero.  Thread t copies the chunks (r_t + kRowStep i, c8_t), so its
// addresses are one base plus constant steps.
template <typename T, int D, int ROWS, int NT, class P>
__device__ __forceinline__ void load_rows_async(unsigned char* dst,
                                                const void* src,
                                                long long row0, int H, int h,
                                                int lo, int hi) {
  constexpr int kChunks = D / 8, kRowStep = NT / kChunks;
  static_assert(NT % kChunks == 0 && ROWS % kRowStep == 0, "copy split");
  // a swizzled tile's chunk offset is linear in the row over whole 8-row
  // groups (a padded one's over any rows)
  static_assert(kRowStep % 8 == 0 || !std::is_same<P, WgPath<T, D>>::value,
                "row step");
  const int r_t = threadIdx.x / kChunks;
  const int c8_t = threadIdx.x % kChunks;
  const long long step = static_cast<long long>(kRowStep) * H * D;
  const T* g = static_cast<const T*>(src) + ((row0 + r_t) * H + h) * D +
               c8_t * 8;
  unsigned char* d = dst + P::template chunk<ROWS>(r_t, c8_t);
#pragma unroll
  for (int i = 0; i < ROWS / kRowStep; ++i) {
    const int r = r_t + i * kRowStep;
    const bool in = r >= lo && r <= hi;
    cp_async16(d + P::template chunk<ROWS>(i * kRowStep, 0),
               in ? g + i * step : src, in);
  }
}

template <typename T, int D, bool kVarlen, bool EXTRA>
__global__ void __launch_bounds__(FwdSmem<T, D>::kThreads)
    fwd_kernel(FwdArgs a) {
  using L = FwdSmem<T, D>;
  using P = typename L::P;
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
  const fa::Seq sq = fa::seq_info<kVarlen>(a.seq, b, a.Hq);
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
  const bool drop = EXTRA && a.dp.enabled;
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
  const int kt0 = blk_lo / BK;
  const int n_steps = blk_hi >= blk_lo ? blk_hi / BK - kt0 + 1 : 0;

  float o[D / 8][4] = {};
  float m[2] = {-INFINITY, -INFINITY};   // running row max (base 2)
  float l[2] = {0.0f, 0.0f};             // this lane's part of the row sum

  // stage t & 1 holds K(t) and the dropout column words of tile t, copied
  // at step t - 1, and V(t), copied at step t: at step s the products are
  // S(s) = Q K(s)^T and O += P(s - 1) V(s - 1)
  auto stage = [&](int t) {
    return smem + L::stage_off + (t & 1) * L::stage_bytes;
  };
  // tile t of K or V into its stage; keys outside [blk_lo, blk_hi] are zero
  auto copy_kv = [&](int t, const void* src, size_t off) {
    const int k0 = (kt0 + t) * BK;
    load_rows_async<T, D, BK, NT, P>(stage(t) + off, src, sq.k_base + k0,
                                     a.Hk, kvh, blk_lo - k0, blk_hi - k0);
  };
  auto copy_k = [&](int t) {
    copy_kv(t, a.k, L::k_off);
    if (drop) {
      const int k0 = (kt0 + t) * BK;
      uint32_t* cw = reinterpret_cast<uint32_t*>(stage(t) + L::cw_off);
      for (int c = threadIdx.x; c < BK; c += NT)
        cw[c] = fa::dropout_col_word(k0 + c + a.dp.k0, bh, a.dp);
    }
  };
  auto copy_v = [&](int t) { copy_kv(t, a.v, L::v_off); };
  // the online softmax of tile t on the fragments: P_drop(t) in fp32 in
  // place of S(t), alpha the rescale of O from the last tile's base to
  // this one's
  float alpha[2];
  auto softmax = [&](int t, float (&sc)[BK / 8][4]) {
    const int k0 = (kt0 + t) * BK;
    const uint32_t* cw_s =
        reinterpret_cast<const uint32_t*>(stage(t) + L::cw_off);
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
          float x = EXTRA ? fa::score_bias(sc[j][e], qp[i] + sq.offs, kp,
                                           a.scale, slope, a.mp_) *
                                kLog2e
                          : sc[j][e];
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
          sc[j][e] = p;
        }
#pragma unroll
      for (int i = 0; i < 2; ++i)
        l[i] = l[i] * alpha[i] + (ls[2 * i] + ls[2 * i + 1]);
    };
    if (nq_g == 64 && lv.full(g0, 64, k0, BK))
      pass(std::false_type{});
    else
      pass(std::true_type{});
  };
  // step t's copies, after the barrier that frees their stages
  auto copies = [&](int t) {
    cp_async_wait<0>();
    P::copies_landed();
    __syncthreads();   // K(t), V(t - 1) landed for all; the tiles their
                       // stages held before have been read
    if (t + 1 < n_steps) copy_k(t + 1);
    if (t < n_steps) copy_v(t);
    cp_async_commit();
  };

  // Every warpgroup runs every tile of the block (a tile none of its rows
  // sees gives P = 0), so no product sits in a branch.  At step s >= 1 it
  // issues S(s) and then P(s - 1) V(s - 1), and runs the softmax of S(s)
  // while the second product is in flight.
  if (n_steps > 0) {
    // Q rows past the sequence are zero
    load_rows_async<T, D, 64, NT, P>(smem, a.q, sq.q_base + qp0, a.Hq, h, 0,
                                     nq - 1);
    if (L::kGroups == 2)
      load_rows_async<T, D, 64, NT, P>(smem + L::q_tile, a.q,
                                       sq.q_base + qp0 + 64, a.Hq, h, 0,
                                       nq - 65);
    copy_k(0);
    cp_async_commit();   // one group: Q and K(0)
    float sc[BK / 8][4];        // S(s), then P(s) in fp32
    uint32_t pa[BK / 16][4];    // P(s - 1) in the input type
    auto rescale_pack = [&]() {
#pragma unroll
      for (int nb = 0; nb < D / 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[nb][e] *= alpha[e / 2];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        pack_a<T>(pa[kk], sc[2 * kk], sc[2 * kk + 1]);
    };

    copies(0);
    P::begin();
    P::template abt<64, BK>(sc, q_s, wrow, stage(0) + L::k_off, lane);
    P::commit_wait();
    P::settle(sc);
    softmax(0, sc);
    rescale_pack();
    for (int s = 1; s < n_steps; ++s) {
      copies(s);
      P::begin();
      P::template abt<64, BK>(sc, q_s, wrow, stage(s) + L::k_off, lane);
      P::commit();
      P::template ab<BK, D>(o, pa, stage(s - 1) + L::v_off, 0, lane);
      P::commit();
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
    P::begin();
    P::template ab<BK, D>(o, pa, stage(n_steps - 1) + L::v_off, 0, lane);
    P::commit_wait();
    P::settle(o);
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
    if (r < nq_g)
      *reinterpret_cast<uint4*>(og + ((sq.q_base + g0 + r) * a.Hq + h) * D +
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

// the variant, its shared-memory limit set on first use
template <typename T, int D, bool kVarlen, bool EXTRA>
cudaError_t variant(Kernel* k) {
  using L = FwdSmem<T, D>;
  k->fn = fwd_kernel<T, D, kVarlen, EXTRA>;
  k->smem = static_cast<int>(L::bytes);
  k->threads = L::kThreads;
  k->rows = L::BQ;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        k->fn, cudaFuncAttributeMaxDynamicSharedMemorySize, k->smem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  return cudaSuccess;
}

template <typename T, bool kVarlen>
cudaError_t find_d(int D, bool extra, Kernel* k) {
  switch (D) {
    case 32: return extra ? variant<T, 32, kVarlen, true>(k)
                          : variant<T, 32, kVarlen, false>(k);
    case 64: return extra ? variant<T, 64, kVarlen, true>(k)
                          : variant<T, 64, kVarlen, false>(k);
    case 128: return extra ? variant<T, 128, kVarlen, true>(k)
                           : variant<T, 128, kVarlen, false>(k);
    case 256: return extra ? variant<T, 256, kVarlen, true>(k)
                           : variant<T, 256, kVarlen, false>(k);
    default: return cudaErrorInvalidValue;
  }
}

// dtype 0 = bf16, 1 = fp16
cudaError_t find_variant(bool varlen, int dtype, int D, bool extra,
                         Kernel* k) {
  if (varlen)
    return dtype == 0 ? find_d<__nv_bfloat16, true>(D, extra, k)
                      : find_d<__half, true>(D, extra, k);
  return dtype == 0 ? find_d<__nv_bfloat16, false>(D, extra, k)
                    : find_d<__half, false>(D, extra, k);
}

// varlen: a.seq.M is max_seqlen_q; blocks past their sequence leave at once
cudaError_t launch(bool varlen, int dtype, int D, const FwdArgs& a,
                   cudaStream_t stream) {
  const bool extra = a.mp_.has_alibi || a.mp_.softcap > 0.0f ||
                     a.dp.enabled || !(a.scale > 0.0f);
  Kernel kn;
  cudaError_t e = find_variant(varlen, dtype, D, extra, &kn);
  if (e != cudaSuccess) return e;
  const int tiles = (a.seq.M + kn.rows - 1) / kn.rows;
  kn.fn<<<tiles * a.Hq * a.B, kn.threads, kn.smem, stream>>>(a);
  return cudaGetLastError();
}

void set_mask_dropout(FwdArgs* a, int causal, int window_left,
                      int window_right, float softcap, int has_alibi,
                      int dropout, unsigned int seed_lo, unsigned int seed_hi,
                      unsigned int threshold, float drop_scale, int q0,
                      int k0, int b0, int h0, int num_heads) {
  a->mp_.causal = causal; a->mp_.window_left = window_left;
  a->mp_.window_right = window_right; a->mp_.softcap = softcap;
  a->mp_.has_alibi = has_alibi;
  a->dp.enabled = dropout; a->dp.seed_lo = seed_lo; a->dp.seed_hi = seed_hi;
  a->dp.threshold = threshold; a->dp.scale = drop_scale;
  a->dp.q0 = q0; a->dp.k0 = k0; a->dp.b0 = b0; a->dp.h0 = h0;
  a->dp.num_heads = num_heads;
}

}  // namespace

#define FA_MASK_DROPOUT_PARAMS                                              \
  int causal, int window_left, int window_right, float softcap,             \
      int has_alibi, int dropout, unsigned int seed_lo, unsigned int seed_hi, \
      unsigned int threshold, float drop_scale, int q0, int k0, int b0,     \
      int h0, int num_heads
#define FA_MASK_DROPOUT_ARGS                                                \
  causal, window_left, window_right, softcap, has_alibi, dropout, seed_lo,  \
      seed_hi, threshold, drop_scale, q0, k0, b0, h0, num_heads

// dtype: 0 = bf16, 1 = fp16.  Each returns cudaGetLastError() of its launch.
// K1: dense (B, M, Hq, D) q against (B, N, Hk, D) k/v.
extern "C" int fa_fwd_launch(
    int dtype, const void* q, const void* k, const void* v,
    const float* slopes, void* out, float* lse, int B, int M, int N, int Hq,
    int Hk, int D, int offset, float scale, FA_MASK_DROPOUT_PARAMS,
    void* stream) {
  if (Hk <= 0 || Hq % Hk != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || M == 0 || Hq == 0) return 0;
  FwdArgs a = {};
  a.q = q; a.k = k; a.v = v; a.slopes = has_alibi ? slopes : nullptr;
  a.out = out; a.lse = lse;
  a.seq.M = M; a.seq.N = N; a.seq.offset = offset;
  a.B = B; a.Hq = Hq; a.Hk = Hk; a.group = Hq / Hk; a.scale = scale;
  set_mask_dropout(&a, FA_MASK_DROPOUT_ARGS);
  return static_cast<int>(
      launch(false, dtype, D, a, static_cast<cudaStream_t>(stream)));
}

// K5: packed (Tq, Hq, D) q split by cu_q (B + 1,) against packed (Tk, Hk, D)
// k/v split by cu_k; seqused_k / leftpad_k (B,) may be null.  The grid
// covers max_seqlen_q rows of each sequence.
extern "C" int fa_varlen_fwd_launch(
    int dtype, const void* q, const void* k, const void* v, const int* cu_q,
    const int* cu_k, const int* seqused_k, const int* leftpad_k,
    const float* slopes, void* out, float* lse, int B, int Tq,
    int max_seqlen_q, int Hq, int Hk, int D, float scale,
    FA_MASK_DROPOUT_PARAMS, void* stream) {
  if (Hk <= 0 || Hq % Hk != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || max_seqlen_q <= 0 || Hq == 0) return 0;
  FwdArgs a = {};
  a.q = q; a.k = k; a.v = v; a.slopes = has_alibi ? slopes : nullptr;
  a.out = out; a.lse = lse;
  a.seq.M = max_seqlen_q; a.seq.Tq = Tq; a.seq.cu_q = cu_q;
  a.seq.cu_k = cu_k; a.seq.seqused_k = seqused_k;
  a.seq.leftpad_k = leftpad_k;
  a.B = B; a.Hq = Hq; a.Hk = Hk; a.group = Hq / Hk; a.scale = scale;
  set_mask_dropout(&a, FA_MASK_DROPOUT_ARGS);
  return static_cast<int>(
      launch(true, dtype, D, a, static_cast<cudaStream_t>(stream)));
}

// The occupancy of K1 for (dtype, D), in the variant without bias and
// dropout (extra 0) or with (extra 1): out[0] resident blocks a
// multiprocessor, out[1] dynamic shared memory a block (bytes), out[2]
// threads a block, out[3] registers a thread, out[4] local memory a thread
// (bytes: spills and stack).  Returns a cudaError_t.
extern "C" int fa_fwd_occupancy(int dtype, int D, int extra, int* out) {
  Kernel kn;
  cudaFuncAttributes attr;
  cudaError_t e = find_variant(false, dtype, D, extra != 0, &kn);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, kn.fn);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[1] = kn.smem;
  out[2] = kn.threads;
  out[3] = attr.numRegs;
  out[4] = static_cast<int>(attr.localSizeBytes);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, kn.fn, kn.threads, kn.smem));
}
