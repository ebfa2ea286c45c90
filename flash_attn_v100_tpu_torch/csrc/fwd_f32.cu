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
// once per q tile.  The products run as 3 x TF32 split products on the
// tensor cores (csrc/f32_tiles.cuh), so the ceiling is a third of the
// 494.7 TFLOP/s dense TF32 rate the bound is stated at, 164.9 TFLOP/s
// (66.9 for fp32 FFMA on the CUDA cores).
//
// What the design does about it: one block per (q tile, q head,
// sequence), the q tile loaded once; K and V tiles stream through
// cp.async; the key loop covers only the tiles the block's causal / window
// intervals touch, and blocks run heaviest q tile first.  The online
// softmax (row max and sum over a quad's 4 lanes), masks, ALiBi, softcap
// and Philox dropout run in fp32 on S's accumulator fragments
// (softmax_tile), and P never goes through shared memory.
//   * D 32-128, warpgroup products: two warpgroups over 128 q rows, 64-key
//     tiles (32 at D 128) landing in one raw stage while the tile before
//     is computed.  Each landed tile is split once per block (split_kv)
//     into 128-byte-swizzled K-major TF32 hi / lo tiles: K as it is, V
//     transposed, its keys ordered as P's A fragment reads them.  S = Q K^T
//     is three wgmma m64nBKk8 .tf32 a k-step, Q's A fragments split in
//     registers as they are read from the q tile (two k-steps a batch, two
//     register sets); P V is three m64nDk8 a key step with P's A
//     fragments made from S's accumulators, into a zeroed accumulator that
//     O takes as O alpha + P V in fp32 (the tensor cores' accumulation
//     truncates: csrc/f32_tiles.cuh).  Shared memory a block (the split
//     tiles, Q, the raw stage, the dropout words): D 32 71 KB, 64 137 KB,
//     128 168 KB.
//   * D 256, warp products: 4 warps over 64 q rows, 16-key tiles through a
//     two-stage ring, mma.sync m16n8k8 .tf32, every operand split in
//     registers as its fragment is read (rows of D + 4 floats: no bank
//     conflicts), O taking two key steps at a time from a zeroed fragment
//     (a wgmma accumulator of P V beside O would need 256 registers a
//     thread).  Shared memory a block: 133 KB.
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

// One key tile's online softmax on S's C fragments (n-block j, element e:
// row g + 8 (e / 2), key k0 + 8 j + 2c + e % 2): scale -> ALiBi -> softcap,
// the live-key mask [k_lo, k_hi] of each row, the running max m and this
// thread's part of the row sum l, P = exp(S - m) in place (dropped after
// l has summed it) and each row's rescale of O, alpha.
template <int NB>
__device__ __forceinline__ void softmax_tile(
    float (&sc)[NB][4], float (&alpha)[2], float (&m)[2], float (&l)[2],
    int k0, const uint32_t* cw, const int (&qp)[2], const int (&k_lo)[2],
    const int (&k_hi)[2], const uint32_t (&rw)[2], bool drop, float slope,
    int offs, const Args& a, int lane) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kp = k0 + 8 * j + 2 * (lane % 4) + e;
        float x = fa::score_bias(sc[j][2 * i + e], qp[i] + offs, kp, a.scale,
                                 slope, a.mp);
        if (kp < k_lo[i] || kp > k_hi[i]) x = -INFINITY;
        sc[j][2 * i + e] = x;
        mx = fmaxf(mx, x);
      }
    const float m_next = fmaxf(m[i], quad_max(mx));
    // a row with no live key so far keeps P = 0 (exp(-inf - 0))
    const float base = m_next == -INFINITY ? 0.0f : m_next;
    alpha[i] = expf(m[i] - base);
    m[i] = m_next;
    float ls = 0.0f;
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float p = expf(sc[j][2 * i + e] - base);
        ls += p;
        if (drop)
          p = fa::dropout_keep(rw[i], cw[8 * j + 2 * (lane % 4) + e], a.dp)
                  ? p * a.dp.scale
                  : 0.0f;
        sc[j][2 * i + e] = p;
      }
    l[i] = l[i] * alpha[i] + ls;
  }
}

template <int D>
struct Cfg {
  // warpgroup products (wgmma) at D <= 128, two warpgroups over 128 q rows;
  // mma.sync at D 256, 4 warps over 64 rows
  static constexpr bool kWg = D <= 128;
  static constexpr int W = kWg ? 8 : 4;   // warps, each 16 q rows
  static constexpr int BQ = 16 * W;
  static constexpr int BK = D <= 64 ? 64 : (D == 128 ? 32 : 16);  // keys
  static constexpr int NT = 32 * W;
  static constexpr int LD = D + 4;
  static constexpr int kStages = kWg ? 1 : 2;   // raw K / V stages
  // bytes from the (1024-aligned) base: on wgmma the split tiles K hi, K
  // lo, V^T hi, V^T lo (128-byte-swizzled, kTile bytes each), then Q, the
  // raw K / V stages, two stages of the dropout column words
  static constexpr int kTile = kWg ? BK * D * 4 : 0;
  static constexpr int q_off = 4 * kTile;
  static constexpr int kv_off = q_off + BQ * LD * 4;
  static constexpr int cw_off = kv_off + kStages * 2 * BK * LD * 4;
  static constexpr size_t bytes = cw_off + 2 * BK * 4 + (kWg ? 1024 : 0);
};

// The raw K / V tile (BK rows of D floats, row stride LD) split for wgmma:
// K's row r into the K-major K hi / lo tiles (BK rows of D), V's row r into
// column pos(r) of the K-major V^T hi / lo tiles (D rows of BK keys), pos
// ordering each 8 keys 0, 2, 4, 6, 1, 3, 5, 7: P's A fragment, made from
// S's C fragment (frag_a_c), reads key 2c as its k = c and key 2c + 1 as
// k = c + 4.
template <int D, int BK, int LD, int NT>
__device__ __forceinline__ void split_kv(unsigned char* t, const float* kr,
                                         const float* vr) {
  constexpr int C = D / 4, kTile = BK * D * 4;
  for (int idx = threadIdx.x; idx < BK * C; idx += NT) {
    const int r = idx / C, u = idx % C;   // a warp along a row of K
    const float4 x = *reinterpret_cast<const float4*>(kr + r * LD + 4 * u);
    uint32_t h[4], l[4];
    split(x.x, h[0], l[0]);
    split(x.y, h[1], l[1]);
    split(x.z, h[2], l[2]);
    split(x.w, h[3], l[3]);
    const int off = fa::sm90::sw128_chunk<BK>(r, u);
    *reinterpret_cast<uint4*>(t + off) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(t + kTile + off) =
        make_uint4(l[0], l[1], l[2], l[3]);
  }
  for (int idx = threadIdx.x; idx < BK * C; idx += NT) {
    const int r = idx % BK, u = idx / BK;   // a warp along V's keys
    const float4 x = *reinterpret_cast<const float4*>(vr + r * LD + 4 * u);
    const int pos = (r & ~7) | ((r & 1) << 2) | ((r & 7) >> 1);
    const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      uint32_t h, l;
      split(xs[e], h, l);
      const int off =
          fa::sm90::sw128_chunk<D>(4 * u + e, pos / 4) + (pos % 4) * 4;
      *reinterpret_cast<uint32_t*>(t + 2 * kTile + off) = h;
      *reinterpret_cast<uint32_t*>(t + 3 * kTile + off) = l;
    }
  }
}

template <int D, int MODE>
__global__ void __launch_bounds__(Cfg<D>::NT, 1)
    fwd_f32_kernel(const Args a) {
  using C = Cfg<D>;
  constexpr int BQ = C::BQ, BK = C::BK, NT = C::NT, LD = C::LD;
  constexpr int NB = BK / 8, DB = D / 8;   // n-blocks of S and of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base =
      C::kWg ? fa::attn::smem_base(smem_raw) : smem_raw;
  float* q_s = reinterpret_cast<float*>(base + C::q_off);
  uint32_t* cw_s = reinterpret_cast<uint32_t*>(base + C::cw_off);
  auto k_s = [&](int t) {
    return reinterpret_cast<float*>(base + C::kv_off) +
           (C::kStages == 2 ? (t & 1) : 0) * 2 * BK * LD;
  };
  auto v_s = [&](int t) { return k_s(t) + BK * LD; };
  const uint32_t split_s = fa::sm90::smem_u32(base);   // wgmma's tiles

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
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int r0 = 16 * warp;            // the warp's rows in the tile
  const Live lv = {sq.slk, sq.offs, a.mp.window_left,
                   a.mp.effective_window_right()};
  const bool drop = MODE != kPaged && a.dp.enabled;
  const float slope = a.slopes ? a.slopes[b * a.Hq + h] : 0.0f;
  const uint32_t bh = fa::dropout_bh(b, h, a.dp);
  // this thread's two C rows, g and g + 8 of the warp's 16, and their
  // live keys [k_lo, k_hi] (none past the sequence)
  int qp[2], k_lo[2], k_hi[2];
  uint32_t rw[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    qp[i] = qp0 + r0 + lane / 4 + 8 * i;
    k_lo[i] = lv.key_lo(qp[i]);
    k_hi[i] = qp[i] < sq.slq ? lv.key_hi(qp[i]) : -1;
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
    load_rows<D, BK, NT>(k_s(t), a.k,
                         [&](int r) { return key_row(a.k, k0 + r); });
    load_rows<D, BK, NT>(v_s(t), a.v,
                         [&](int r) { return key_row(a.v, k0 + r); });
    if (drop)
      for (int c = threadIdx.x; c < BK; c += NT)
        cw_s[(t & 1) * BK + c] =
            fa::dropout_col_word(k0 + c + a.dp.k0, bh, a.dp);
  };

  float o[DB][4];   // O's rows g, g + 8 x columns 8 n + 2c, + 1
#pragma unroll
  for (int n = 0; n < DB; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.0f;
  float m[2], l[2];   // running row max; this thread's part of the sum
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
  }
  if (n_steps > 0) {
    // Q rows past the sequence are zero
    load_rows<D, BQ, NT>(q_s, a.q, [&](int r) -> const float* {
      return r < nq ? a.q + ((sq.q_base + qp0 + r) * a.Hq + h) *
                                static_cast<long long>(D)
                    : nullptr;
    });
    copy_kv(0);
    cp_async_commit();
    for (int s = 0; s < n_steps; ++s) {
      cp_async_wait<0>();
      // tile s landed; tile s - 1's stage (mma.sync) or split tiles
      // (wgmma, each warpgroup past its waits) are free
      __syncthreads();
      if constexpr (C::kWg) {
        split_kv<D, BK, LD, NT>(base, k_s(s), v_s(s));
        fa::sm90::fence_proxy_async();   // visible to wgmma
        __syncthreads();   // split; the raw stage is free
      }
      if (s + 1 < n_steps) copy_kv(s + 1);
      cp_async_commit();
      // S = Q K^T, 3 x TF32
      float sc[NB][4];
      if constexpr (C::kWg) {
        s_wgmma<D, BK, LD>(sc, q_s, r0, split_s, split_s + C::kTile, lane);
      } else {
#pragma unroll
        for (int j = 0; j < NB; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[j][e] = 0.0f;
        const float* ks = k_s(s);
#pragma unroll 2
        for (int kk = 0; kk < D; kk += 8) {
          FragA fa_;
          frag_a<LD>(fa_, q_s, r0, kk, lane);
#pragma unroll
          for (int j = 0; j < NB; ++j) {
            FragB fb;
            frag_b_k<LD>(fb, ks, 8 * j, kk, lane);
            mma3(sc[j], fa_, fb);
          }
        }
      }
      float alpha[2];
      softmax_tile<NB>(sc, alpha, m, l, blk_lo + s * BK, cw_s + (s & 1) * BK,
                       qp, k_lo, k_hi, rw, drop, slope, sq.offs, a, lane);
      if constexpr (C::kWg) {
        // O = O alpha + P V, the product into a zeroed accumulator
        float ot[DB][4];
        pv_wgmma<D, BK>(ot, sc, split_s + 2 * C::kTile,
                        split_s + 3 * C::kTile);
#pragma unroll
        for (int n = 0; n < DB; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            o[n][e] = fmaf(o[n][e], alpha[e / 2], ot[n][e]);
      } else {
#pragma unroll
        for (int n = 0; n < DB; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[n][e] *= alpha[e / 2];
        // O += P V, 3 x TF32: P from the registers of S, kG key steps
        // into a zeroed fragment, then added to O in fp32 (flush)
        const float* vs = v_s(s);
#pragma unroll
        for (int j = 0; j < NB; j += kG) {
          FragA fp[kG];
#pragma unroll
          for (int g = 0; g < kG; ++g) frag_a_c(fp[g], sc[j + g]);
#pragma unroll
          for (int n = 0; n < DB; ++n) {
            float t[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
            for (int g = 0; g < kG; ++g) {
              FragB fb;
              frag_b_mn<LD>(fb, vs, 8 * (j + g), 8 * n, lane);
              mma3(t, fp[g], fb);
            }
            flush(o[n], t);
          }
        }
      }
    }
  }

  // epilogue: O * (1 / l), LSE = m + log(l), -inf where l = 0
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float ll = quad_sum(l[i]);
    if (qp[i] >= sq.slq) continue;
    const float inv = ll == 0.0f ? 0.0f : 1.0f / ll;
    float* og = a.out + ((sq.q_base + qp[i]) * a.Hq + h) *
                            static_cast<long long>(D);
#pragma unroll
    for (int n = 0; n < DB; ++n)
      *reinterpret_cast<float2*>(og + 8 * n + 2 * (lane % 4)) =
          make_float2(o[n][2 * i] * inv, o[n][2 * i + 1] * inv);
    if (lane % 4 == 0)
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
  fwd_f32_kernel<D, MODE><<<tiles * a.Hq * a.B, C::NT, C::bytes, stream>>>(
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
