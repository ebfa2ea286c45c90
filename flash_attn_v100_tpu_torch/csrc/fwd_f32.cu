// K1 (dense), K5 (packed varlen) and K8 (paged) over fp32 inputs: the
// attention forward for Hopper (sm_90a), one fp32 body instantiated for the
// three kinds of sequence of csrc/seq.cuh, as csrc/fwd_body.cuh is for 16-bit
// inputs.
//
// Replaces, for fp32 q/k/v (the JAX package sends fp32 through its Pallas
// kernels: flash_attn_v100_tpu/config.py::kernel_dtype converts fp16 only):
//   K1 flash_attn_v100_tpu/ops/pallas/fwd.py::_fwd_kernel,
//   K5 flash_attn_v100_tpu/ops/pallas/varlen.py::_varlen_fwd_kernel,
//   K8 flash_attn_v100_tpu/ops/pallas/varlen.py::_varlen_fwd_kernel_paged.
// The contracts are those of csrc/fwd.cu (K1, K5) and csrc/varlen_paged.cu
// (K8): the same arguments, masks (bottom-right causal, window), scale ->
// ALiBi -> softcap, Philox dropout on the unnormalized P after l has summed
// the pre-dropout P (K1, K5), O in fp32, LSE fp32; a row with no live key
// gives O = 0 and LSE = -inf; rows no block covers are left to the caller.
//
// What bounds it on this card: operations.  A causal 2048-token sequence
// does 4 * D flops per live (q row, key) pair against each K/V byte read
// once per q tile.  On FFMA (csrc/f32_tiles.cuh says why) the ceiling is
// 66.9 TFLOP/s, an eighth of the dense TF32 rate the bound is stated at.
//
// What the design does about it: one block of 128 threads per (q tile,
// q head, sequence), the q tile (64 rows, 32 at D 256) loaded once; K and V
// tiles of 32 keys (16 at D 256) stream through a two-stage cp.async ring,
// tile t + 1 copied while tile t is computed; each thread holds 4 rows x 4
// keys of S (register tiling: 8 float4 loads a 64 FMAs) and 4 rows x D / 8
// columns of O; P goes once through shared memory between the two
// products; the key loop covers only the tiles the block's causal / window
// intervals touch, and blocks run heaviest q tile first.  Shared memory a
// block: D 32 38 KB, 64 63 KB, 128 112 KB, 256 103 KB.
#include <math.h>

#include "attn_tiles.cuh"
#include "f32_tiles.cuh"
#include "masks.cuh"
#include "philox.cuh"
#include "seq.cuh"

namespace {

using fa::attn::Live;
using namespace fa::f32;

constexpr int kDense = 0;    // K1: (B, N, Hk, D)
constexpr int kVarlen = 1;   // K5: packed (Tk, Hk, D)
constexpr int kPaged = 2;    // K8: pools (Hk, P, ps, D) through a table
constexpr int kF32 = 2;      // the wrappers' dtype code of fp32

struct Args {
  const float* q;         // dense (B, M, Hq, D); varlen, paged (Tq, Hq, D)
  const float* k;         // dense (B, N, Hk, D); varlen (Tk, Hk, D); paged
  const float* v;         //   pool (Hk, P, ps, D), strides below
  const float* slopes;    // (B, Hq) or nullptr
  float* out;             // q's shape
  float* lse;             // dense (B, Hq, M); varlen, paged (Hq, Tq)
  fa::SeqArgs seq;
  int B, Hq, Hk, group;
  float scale;
  fa::MaskParams mp;
  fa::DropoutParams dp;
  // paged (K8)
  const int* table;       // (B, table_stride)
  const int* seqlens_k;   // (B,)
  long long s_h, s_p, s_tok;
  int table_stride, page_size, max_pages;
};

template <int D>
struct Cfg {
  static constexpr int BQ = D <= 128 ? 64 : 32;   // q rows a block
  static constexpr int BK = D <= 128 ? 32 : 16;   // keys a step
  static constexpr int RT = BQ / 16, CT = BK / 8;
  static constexpr int LD = D + 4, PLD = BK + 8;
  // offsets in floats: Q, two stages of (K, V), P, two stages of the
  // dropout column words
  static constexpr int kv_off = BQ * LD;
  static constexpr int p_off = kv_off + 4 * BK * LD;
  static constexpr int cw_off = p_off + BQ * PLD;
  static constexpr size_t bytes = (cw_off + 2 * BK) * sizeof(float);
};

template <int D, int MODE>
__global__ void __launch_bounds__(kThreads) fwd_f32_kernel(const Args a) {
  using C = Cfg<D>;
  constexpr int BQ = C::BQ, BK = C::BK, RT = C::RT, CT = C::CT;
  constexpr int LD = C::LD, PLD = C::PLD, DC = D / 32;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;
  float* p_s = smem + C::p_off;
  uint32_t* cw_s = reinterpret_cast<uint32_t*>(smem + C::cw_off);
  auto k_s = [&](int t) { return smem + C::kv_off + (t & 1) * 2 * BK * LD; };
  auto v_s = [&](int t) { return k_s(t) + BK * LD; };

  // heaviest first: q tiles from the last, each over all heads and
  // sequences
  const int n_tiles = (a.seq.M + BQ - 1) / BQ;
  const int hb = blockIdx.x % (a.Hq * a.B);
  const int h = hb % a.Hq;
  const int b = hb / a.Hq;
  const int qp0 =
      (n_tiles - 1 - static_cast<int>(blockIdx.x) / (a.Hq * a.B)) * BQ;
  fa::Seq sq;
  if constexpr (MODE == kPaged)
    sq = fa::paged_seq_info(a.seq, a.seqlens_k, a.max_pages * a.page_size,
                            b);
  else
    sq = fa::seq_info<MODE == kVarlen>(a.seq, b, a.Hq);
  if (qp0 >= sq.slq) return;   // uniform over the block
  const int nq = min(BQ, sq.slq - qp0);
  const int kvh = h / a.group;
  const int ty = threadIdx.x / 8, tx = threadIdx.x % 8;
  const Live lv = {sq.slk, sq.offs, a.mp.window_left,
                   a.mp.effective_window_right()};
  const bool drop = MODE != kPaged && a.dp.enabled;
  const float slope = a.slopes ? a.slopes[b * a.Hq + h] : 0.0f;
  const uint32_t bh = fa::dropout_bh(b, h, a.dp);
  int qp[RT];
  uint32_t rw[RT];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    qp[i] = qp0 + ty + 16 * i;
    rw[i] = drop ? fa::dropout_row_word(qp[i] + a.dp.q0, bh, a.dp) : 0u;
  }
  // live keys of the block's rows, in tiles from the first
  const int blk_lo = lv.key_lo(qp0);
  const int blk_hi = lv.key_hi(qp0 + nq - 1);
  const int n_steps = blk_hi >= blk_lo ? (blk_hi - blk_lo) / BK + 1 : 0;

  // key position kp's row of K or V, null outside [blk_lo, blk_hi]
  auto key_row = [&](const float* base, int kp) -> const float* {
    if (kp < blk_lo || kp > blk_hi) return nullptr;
    if constexpr (MODE == kPaged) {
      const int cr = static_cast<int>(sq.k_base) + kp;   // cache row
      const int page = a.table[static_cast<long long>(b) * a.table_stride +
                               cr / a.page_size];
      return base + page * a.s_p + kvh * a.s_h +
             static_cast<long long>(cr % a.page_size) * a.s_tok;
    } else {
      return base + ((sq.k_base + kp) * a.Hk + kvh) * static_cast<long long>(D);
    }
  };
  // tile t's K, V and dropout column words into stage t & 1
  auto copy_kv = [&](int t) {
    const int k0 = blk_lo + t * BK;
    load_rows<D, BK>(k_s(t), a.k,
                     [&](int r) { return key_row(a.k, k0 + r); });
    load_rows<D, BK>(v_s(t), a.v,
                     [&](int r) { return key_row(a.v, k0 + r); });
    if (drop)
      for (int c = threadIdx.x; c < BK; c += kThreads)
        cw_s[(t & 1) * BK + c] =
            fa::dropout_col_word(k0 + c + a.dp.k0, bh, a.dp);
  };

  float4 o[RT][DC];
  zero(o);
  float m[RT], l[RT];   // running row max; this thread's part of the sum
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
  }
  if (n_steps > 0) {
    // Q rows past the sequence are zero
    load_rows<D, BQ>(q_s, a.q, [&](int r) -> const float* {
      return r < nq ? a.q + ((sq.q_base + qp0 + r) * a.Hq + h) *
                                static_cast<long long>(D)
                    : nullptr;
    });
    copy_kv(0);
    cp_async_commit();
    for (int s = 0; s < n_steps; ++s) {
      cp_async_wait<0>();
      __syncthreads();   // tile s landed; tile s - 1's stage and P are free
      if (s + 1 < n_steps) copy_kv(s + 1);
      cp_async_commit();
      float sc[RT][CT];
      abt<D, RT, CT>(sc, q_s, k_s(s), ty, tx);
      const int k0 = blk_lo + s * BK;
      const uint32_t* cw = cw_s + (s & 1) * BK;
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < CT; ++j) {
          const int kp = k0 + tx + 8 * j;
          float x = fa::score_bias(sc[i][j], qp[i] + sq.offs, kp, a.scale,
                                   slope, a.mp);
          if (!(qp[i] < sq.slq && lv.valid(qp[i], kp))) x = -INFINITY;
          sc[i][j] = x;
          mx = fmaxf(mx, x);
        }
        const float m_next = fmaxf(m[i], octet_max(mx));
        // a row with no live key so far keeps P = 0 (exp(-inf - 0))
        const float base = m_next == -INFINITY ? 0.0f : m_next;
        const float alpha = expf(m[i] - base);
        m[i] = m_next;
        float ls = 0.0f;
#pragma unroll
        for (int j = 0; j < CT; ++j) {
          float p = expf(sc[i][j] - base);
          ls += p;
          if (drop)
            p = fa::dropout_keep(rw[i], cw[tx + 8 * j], a.dp) ? p * a.dp.scale
                                                              : 0.0f;
          p_s[(ty + 16 * i) * PLD + tx + 8 * j] = p;
        }
        l[i] = l[i] * alpha + ls;
#pragma unroll
        for (int u = 0; u < DC; ++u) o[i][u] = scale4(o[i][u], alpha);
      }
      __syncthreads();   // P stored
      ab<D, RT, BK, PLD>(o, p_s, v_s(s), ty, tx);
    }
  }

  // epilogue: O * (1 / l), LSE = m + log(l), -inf where l = 0
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const float ll = octet_sum(l[i]);
    if (qp[i] >= sq.slq) continue;
    const float inv = ll == 0.0f ? 0.0f : 1.0f / ll;
    float* og = a.out + ((sq.q_base + qp[i]) * a.Hq + h) *
                            static_cast<long long>(D);
#pragma unroll
    for (int u = 0; u < DC; ++u)
      *reinterpret_cast<float4*>(og + 4 * (tx + 8 * u)) = scale4(o[i][u], inv);
    if (tx == 0)
      a.lse[sq.lse_index(h, qp[i])] =
          ll == 0.0f ? -INFINITY : m[i] + logf(ll);
  }
}

template <int D, int MODE>
cudaError_t launch_d(const Args& a, cudaStream_t stream) {
  using C = Cfg<D>;
  static size_t configured = 0;
  cudaError_t e = allow_smem(fwd_f32_kernel<D, MODE>, C::bytes, &configured);
  if (e != cudaSuccess) return e;
  const int tiles = (a.seq.M + C::BQ - 1) / C::BQ;
  fwd_f32_kernel<D, MODE><<<tiles * a.Hq * a.B, kThreads, C::bytes, stream>>>(
      a);
  return cudaGetLastError();
}

template <int MODE>
int launch(const Args& a, int D, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return static_cast<int>(launch_d<32, MODE>(a, st));
    case 64: return static_cast<int>(launch_d<64, MODE>(a, st));
    case 128: return static_cast<int>(launch_d<128, MODE>(a, st));
    case 256: return static_cast<int>(launch_d<256, MODE>(a, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

void set_mask(Args* a, int causal, int window_left, int window_right,
              float softcap, int has_alibi, const float* slopes) {
  a->mp.causal = causal; a->mp.window_left = window_left;
  a->mp.window_right = window_right; a->mp.softcap = softcap;
  a->mp.has_alibi = has_alibi;
  a->slopes = has_alibi ? slopes : nullptr;
}

void set_dropout(Args* a, int dropout, unsigned int seed_lo,
                 unsigned int seed_hi, unsigned int threshold,
                 float drop_scale, int q0, int k0, int b0, int h0,
                 int num_heads) {
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

// The arguments of fa_fwd_launch / fa_varlen_fwd_launch (csrc/fwd.cu) and
// fa_varlen_paged_launch (csrc/varlen_paged.cu); dtype must be 2 (fp32),
// and D_in must be D (fp32 rows are padded by the wrapper).
// Each returns cudaGetLastError() of its launch.
// K1: dense (B, M, Hq, D) q against (B, N, Hk, D) k/v.
extern "C" int fa_fwd_f32_launch(
    int dtype, const void* q, const void* k, const void* v,
    const float* slopes, void* out, float* lse, int B, int M, int N, int Hq,
    int Hk, int D, int D_in, int offset, float scale, FA_MASK_DROPOUT_PARAMS,
    void* stream) {
  if (dtype != kF32 || Hk <= 0 || Hq % Hk != 0 || D_in != D)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || M == 0 || Hq == 0) return 0;
  Args a = {};
  a.q = static_cast<const float*>(q); a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.out = static_cast<float*>(out); a.lse = lse;
  a.seq.M = M; a.seq.N = N; a.seq.offset = offset;
  a.B = B; a.Hq = Hq; a.Hk = Hk; a.group = Hq / Hk; a.scale = scale;
  set_mask(&a, causal, window_left, window_right, softcap, has_alibi, slopes);
  set_dropout(&a, dropout, seed_lo, seed_hi, threshold, drop_scale, q0, k0,
              b0, h0, num_heads);
  return launch<kDense>(a, D, stream);
}

// K5: packed (Tq, Hq, D) q split by cu_q (B + 1,) against packed (Tk, Hk, D)
// k/v split by cu_k; seqused_k / leftpad_k (B,) may be null.  The grid
// covers max_seqlen_q rows of each sequence.
extern "C" int fa_varlen_fwd_f32_launch(
    int dtype, const void* q, const void* k, const void* v, const int* cu_q,
    const int* cu_k, const int* seqused_k, const int* leftpad_k,
    const float* slopes, void* out, float* lse, int B, int Tq,
    int max_seqlen_q, int Hq, int Hk, int D, int D_in, float scale,
    FA_MASK_DROPOUT_PARAMS, void* stream) {
  if (dtype != kF32 || Hk <= 0 || Hq % Hk != 0 || D_in != D)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || max_seqlen_q <= 0 || Hq == 0) return 0;
  Args a = {};
  a.q = static_cast<const float*>(q); a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.out = static_cast<float*>(out); a.lse = lse;
  a.seq.M = max_seqlen_q; a.seq.Tq = Tq; a.seq.cu_q = cu_q;
  a.seq.cu_k = cu_k; a.seq.seqused_k = seqused_k;
  a.seq.leftpad_k = leftpad_k;
  a.B = B; a.Hq = Hq; a.Hk = Hk; a.group = Hq / Hk; a.scale = scale;
  set_mask(&a, causal, window_left, window_right, softcap, has_alibi, slopes);
  set_dropout(&a, dropout, seed_lo, seed_hi, threshold, drop_scale, q0, k0,
              b0, h0, num_heads);
  return launch<kVarlen>(a, D, stream);
}

// K8: packed q against pools (Hk, P, ps, D) through the block table; pool
// strides in elements; no dropout.
extern "C" int fa_varlen_paged_f32_launch(
    int dtype, const void* q, const void* k, const void* v, const int* table,
    int table_stride, const int* cu_q, const int* seqlens_k,
    const int* seqused_k, const int* leftpad_k, const float* slopes, void* out,
    float* lse, long long s_h, long long s_p, long long s_tok, int B, int Tq,
    int Hq, int Hk, int D, int page_size, int mp, int max_seqlen_q,
    float scale, int causal, int window_left, int window_right, float softcap,
    int has_alibi, void* stream) {
  if (dtype != kF32 || page_size <= 0 || Hk <= 0 || Hq % Hk != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || max_seqlen_q <= 0 || Hq == 0) return 0;
  Args a = {};
  a.q = static_cast<const float*>(q); a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.out = static_cast<float*>(out); a.lse = lse;
  a.seq.M = max_seqlen_q; a.seq.Tq = Tq; a.seq.cu_q = cu_q;
  a.seq.seqused_k = seqused_k; a.seq.leftpad_k = leftpad_k;
  a.B = B; a.Hq = Hq; a.Hk = Hk; a.group = Hq / Hk; a.scale = scale;
  set_mask(&a, causal, window_left, window_right, softcap, has_alibi, slopes);
  a.table = table; a.table_stride = table_stride; a.seqlens_k = seqlens_k;
  a.page_size = page_size; a.max_pages = mp;
  a.s_h = s_h; a.s_p = s_p; a.s_tok = s_tok;
  return launch<kPaged>(a, D, stream);
}
