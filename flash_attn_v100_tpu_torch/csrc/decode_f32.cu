// K4 over fp32 q and fp32 page pools: split-KV paged decode attention over
// GQA-folded q rows for Hopper (sm_90a), with the split merge in the same
// launch, as csrc/decode.cu is for 16-bit pools.
//
// Replaces, for fp32 inputs, flash_attn_v100_tpu/ops/pallas/decode.py::
// _decode_kernel (with _decode_page_update and _decode_tile_update), the TPU
// kernel behind paged_decode_attention.  The contract is csrc/decode.cu's:
// q rows (B, Hk, Rq, D) with row r = g * t_new + t, a page pool view (C1,
// Hk, C2, ps, D) through a block table, live cache rows [leftpad, leftpad +
// lens), q position qpos + r % t_new; one normalized partial O and one LSE
// per split, or, given merged outputs, the split merge inside the launch:
// O (B, Hk, Rq, D) fp32 and LSE (B, Hk, Rq).  A row with no live key gives
// O = 0, LSE = -inf; an empty split weighs 0 in the merge.
//
// What bounds it on this card: bytes.  Decode reads every live K and V byte
// once and does 4 * Rq operations per K/V element pair; fp32 pools hold
// twice the bytes of 16-bit ones.
//
// What the design does about it: one block of 128 threads per (split, q-row
// tile, kv head, batch row), the split count the wrapper's (one wave of two
// blocks an SM); the tile is 16 q rows up to Rq 16 (every decode step) and
// 64 above, so a K/V byte is read once per 64 q rows at most; K and V tiles
// of 32 cache rows (16 at D 256) stream through a two-stage cp.async ring,
// each row's address from the block table; S, the online softmax and
// O += P V as csrc/fwd_f32.cu computes them (FFMA, csrc/f32_tiles.cuh);
// the merge as csrc/decode_body.cuh does it: each block writes its
// normalized partial and bumps its (b, kv head, row tile)'s arrival
// counter, and the last of the S blocks merges the partials in split
// order, writes O and the LSE, and resets the counter.
#include <math.h>

#include "f32_tiles.cuh"
#include "masks.cuh"

namespace {

using namespace fa::f32;

constexpr int kF32 = 2;   // the wrappers' dtype code of fp32

struct Args {
  const float* q;         // (B, Hk, Rq, D) contiguous
  const float* k;         // pool view base; element strides below
  const float* v;
  const int* table;       // (B, max_pages)
  const int* lens;        // (B,) live tokens after leftpad
  const int* leftpad;     // (B,) or nullptr
  const int* qpos;        // (B,) position of the first new token, or null
  const float* slopes;    // (B, Hk, Rq) or nullptr
  float* o_part;          // (B, Hk, S, Rq, D)
  float* lse_part;        // (B, Hk, S, Rq)
  float* o;               // merged (B, Hk, Rq, D), or nullptr
  float* lse;             // merged (B, Hk, Rq)
  int* counters;          // (B * Hk * row tiles), zero between calls
  long long s_c1, s_h, s_c2, s_tok;
  int c2;
  int B, Hk, Rq, S, max_pages, page_size, pages_per_split, t_new, group;
  float scale;
  fa::MaskParams mp;
};

template <int D, int ROWS>
struct Cfg {
  static constexpr int BK = D <= 128 ? 32 : 16;   // cache rows a step
  static constexpr int RT = ROWS / 16, CT = BK / 8;
  static constexpr int LD = D + 4, PLD = BK + 8;
  // floats: Q, two stages of (K, V), P
  static constexpr int kv_off = ROWS * LD;
  static constexpr int p_off = kv_off + 4 * BK * LD;
  static constexpr size_t bytes = (p_off + ROWS * PLD) * sizeof(float);
};

template <int D, int ROWS>
__global__ void __launch_bounds__(kThreads) decode_f32_kernel(const Args a) {
  using C = Cfg<D, ROWS>;
  constexpr int BK = C::BK, RT = C::RT, CT = C::CT;
  constexpr int LD = C::LD, PLD = C::PLD, DC = D / 32;
  extern __shared__ __align__(16) float smem[];
  __shared__ int last_block;
  float* q_s = smem;
  float* p_s = smem + C::p_off;
  auto k_s = [&](int t) { return smem + C::kv_off + (t & 1) * 2 * BK * LD; };
  auto v_s = [&](int t) { return k_s(t) + BK * LD; };

  const int tid = threadIdx.x;
  const int ty = tid / 8, tx = tid % 8;
  const int n_rt = (a.Rq + ROWS - 1) / ROWS;
  const int split = blockIdx.x / n_rt;
  const int row0 = (blockIdx.x % n_rt) * ROWS;
  const int h = blockIdx.y, b = blockIdx.z;
  const long long bh = static_cast<long long>(b) * a.Hk + h;
  const int lp = a.leftpad ? a.leftpad[b] : 0;
  const int cs = a.lens[b];
  const int qbase = a.qpos ? a.qpos[b] : cs - a.t_new;
  const int n_rows = a.group * a.t_new;
  const int ps = a.page_size;

  // this split's cache rows [j_lo, j_hi), trimmed to the live, window and
  // causal extent, in steps of BK from j_lo
  const int span = a.pages_per_split * ps;
  const int split0 = split * span;
  int j_lo = max(split0, lp);
  int j_hi = min(min(split0 + span, a.max_pages * ps), lp + cs);
  if (a.mp.window_left >= 0) j_lo = max(j_lo, lp + qbase - a.mp.window_left);
  const int wr = a.mp.effective_window_right();
  if (wr >= 0) j_hi = min(j_hi, lp + qbase + (a.t_new - 1) + wr + 1);
  const int n_st = j_lo < j_hi ? (j_hi - j_lo + BK - 1) / BK : 0;

  // cache row j's row of K or V, null outside [j_lo, j_hi)
  auto cache_row = [&](const float* base, int j) -> const float* {
    if (j >= j_hi) return nullptr;
    const int page = a.table[static_cast<long long>(b) * a.max_pages + j / ps];
    return base + (page / a.c2) * a.s_c1 + h * a.s_h +
           (page % a.c2) * a.s_c2 + static_cast<long long>(j % ps) * a.s_tok;
  };
  auto copy_kv = [&](int t) {
    const int j0 = j_lo + t * BK;
    load_rows<D, BK>(k_s(t), a.k,
                     [&](int r) { return cache_row(a.k, j0 + r); });
    load_rows<D, BK>(v_s(t), a.v,
                     [&](int r) { return cache_row(a.v, j0 + r); });
  };

  int qp[RT];
  bool rok[RT];
  float slope[RT];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int r = row0 + ty + 16 * i;
    qp[i] = qbase + (a.t_new > 1 ? r % a.t_new : 0);
    rok[i] = r < n_rows;
    slope[i] = a.slopes && r < a.Rq ? a.slopes[bh * a.Rq + r] : 0.0f;
  }

  float4 o[RT][DC];
  zero(o);
  float m[RT], l[RT];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
  }
  if (n_st > 0) {
    // q rows past Rq are zero
    load_rows<D, ROWS>(q_s, a.q, [&](int r) -> const float* {
      return row0 + r < a.Rq ? a.q + (bh * a.Rq + row0 + r) * D : nullptr;
    });
    copy_kv(0);
    cp_async_commit();
    for (int s = 0; s < n_st; ++s) {
      cp_async_wait<0>();
      __syncthreads();   // tile s landed; tile s - 1's stage and P are free
      if (s + 1 < n_st) copy_kv(s + 1);
      cp_async_commit();
      float sc[RT][CT];
      abt<D, RT, CT>(sc, q_s, k_s(s), ty, tx);
      const int j0 = j_lo + s * BK;
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        float mx = -INFINITY;
#pragma unroll
        for (int c = 0; c < CT; ++c) {
          const int j = j0 + tx + 8 * c, jl = j - lp;
          float x = fa::score_bias(sc[i][c], qp[i], jl, a.scale, slope[i],
                                   a.mp);
          if (!(rok[i] && j < j_hi && fa::position_valid(qp[i], jl, a.mp)))
            x = -INFINITY;
          sc[i][c] = x;
          mx = fmaxf(mx, x);
        }
        const float m_next = fmaxf(m[i], octet_max(mx));
        const float base = m_next == -INFINITY ? 0.0f : m_next;
        const float alpha = expf(m[i] - base);
        m[i] = m_next;
        float ls = 0.0f;
#pragma unroll
        for (int c = 0; c < CT; ++c) {
          const float p = expf(sc[i][c] - base);
          ls += p;
          p_s[(ty + 16 * i) * PLD + tx + 8 * c] = p;
        }
        l[i] = l[i] * alpha + ls;
#pragma unroll
        for (int u = 0; u < DC; ++u) o[i][u] = scale4(o[i][u], alpha);
      }
      __syncthreads();   // P stored
      ab<D, RT, BK, PLD>(o, p_s, v_s(s), ty, tx);
    }
  }

  // outputs: merged (one split) or this split's partial
  const bool direct = a.o != nullptr && a.S == 1;
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const float ll = octet_sum(l[i]);
    const int r = row0 + ty + 16 * i;
    if (r >= a.Rq) continue;
    const float inv = ll == 0.0f ? 0.0f : 1.0f / ll;
    const float x = ll == 0.0f ? -INFINITY : m[i] + logf(ll);
    const long long row = direct ? bh * a.Rq + r
                                 : (bh * a.S + split) * a.Rq + r;
    float* og = (direct ? a.o : a.o_part) + row * D;
#pragma unroll
    for (int u = 0; u < DC; ++u)
      *reinterpret_cast<float4*>(og + 4 * (tx + 8 * u)) = scale4(o[i][u], inv);
    if (tx == 0) (direct ? a.lse : a.lse_part)[row] = x;
  }
  if (a.o == nullptr || direct) return;

  // the split merge: the last of the S blocks of (b, kv head, row tile) to
  // arrive combines their partials in split order, writes O and the LSE,
  // and resets the counter
  int* counter = a.counters + bh * n_rt + blockIdx.x % n_rt;
  __threadfence();
  __syncthreads();
  if (tid == 0) last_block = atomicAdd(counter, 1) == a.S - 1;
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  const long long base_row = bh * a.S * a.Rq;
  const int nr = min(ROWS, a.Rq - row0);
  auto lse_of = [&](int s, int r) {
    return __ldcg(a.lse_part + base_row + static_cast<long long>(s) * a.Rq +
                  r);
  };
  // each row's max LSE and weight sum, then every (row, 4 columns) apart
  float* mw = q_s;
  for (int i = tid; i < nr; i += kThreads) {
    float mx = -INFINITY, sw = 0.0f;
    for (int s = 0; s < a.S; ++s) mx = fmaxf(mx, lse_of(s, row0 + i));
    if (mx != -INFINITY)
      for (int s = 0; s < a.S; ++s) sw += expf(lse_of(s, row0 + i) - mx);
    mw[2 * i] = mx;
    mw[2 * i + 1] = sw;
  }
  __syncthreads();
  for (int idx = tid; idx < nr * (D / 4); idx += kThreads) {
    const int i = idx / (D / 4), d = 4 * (idx % (D / 4)), r = row0 + i;
    const float mx = mw[2 * i], sw = mw[2 * i + 1];
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (mx != -INFINITY) {
      for (int s = 0; s < a.S; ++s) {
        const float w = expf(lse_of(s, r) - mx);
        const float4 v4 = __ldcg(reinterpret_cast<const float4*>(
            a.o_part + (base_row + static_cast<long long>(s) * a.Rq + r) * D +
            d));
        acc.x += w * v4.x;
        acc.y += w * v4.y;
        acc.z += w * v4.z;
        acc.w += w * v4.w;
      }
      acc = scale4(acc, 1.0f / sw);
    }
    *reinterpret_cast<float4*>(a.o + (bh * a.Rq + r) * D + d) = acc;
    if (d == 0) a.lse[bh * a.Rq + r] = mx == -INFINITY ? -INFINITY
                                                       : mx + logf(sw);
  }
  if (tid == 0) *counter = 0;
}

template <int D, int ROWS>
cudaError_t launch_d(const Args& a, cudaStream_t stream) {
  using C = Cfg<D, ROWS>;
  static size_t configured = 0;
  cudaError_t e =
      allow_smem(decode_f32_kernel<D, ROWS>, C::bytes, &configured);
  if (e != cudaSuccess) return e;
  dim3 grid(a.S * ((a.Rq + ROWS - 1) / ROWS), a.Hk, a.B);
  decode_f32_kernel<D, ROWS><<<grid, kThreads, C::bytes, stream>>>(a);
  return cudaGetLastError();
}

// q rows a block: 16 up to Rq 16, else 64 (ops/cuda/decode.py::block_rows)
template <int D>
cudaError_t launch_rows(const Args& a, cudaStream_t stream) {
  return a.Rq <= 16 ? launch_d<D, 16>(a, stream) : launch_d<D, 64>(a, stream);
}

}  // namespace

// The arguments of fa_decode_launch (csrc/decode.cu); dtype must be 2
// (fp32); pool strides in elements; o / lse / counters null for partials
// only.  Returns cudaGetLastError() of the launch.
extern "C" int fa_decode_f32_launch(
    int dtype, const void* q, const void* k, const void* v, const int* table,
    const int* lens, const int* leftpad, const int* qpos, const float* slopes,
    float* o_part, float* lse_part, void* o, float* lse, int* counters,
    long long s_c1, long long s_h, long long s_c2, long long s_tok, int c2,
    int B, int Hk, int Rq, int D, int S, int max_pages, int page_size,
    int pages_per_split, int t_new, int group, float scale, int causal,
    int window_left, int window_right, float softcap, int has_alibi,
    void* stream) {
  if (dtype != kF32 || Rq % 8 != 0 || (o != nullptr && counters == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || Hk == 0 || Rq == 0) return 0;
  Args a = {};
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.table = table; a.lens = lens; a.leftpad = leftpad; a.qpos = qpos;
  a.slopes = has_alibi ? slopes : nullptr;
  a.o_part = o_part; a.lse_part = lse_part;
  a.o = static_cast<float*>(o); a.lse = lse; a.counters = counters;
  a.s_c1 = s_c1; a.s_h = s_h; a.s_c2 = s_c2; a.s_tok = s_tok;
  a.c2 = c2; a.B = B; a.Hk = Hk; a.Rq = Rq; a.S = S;
  a.max_pages = max_pages; a.page_size = page_size;
  a.pages_per_split = pages_per_split; a.t_new = t_new; a.group = group;
  a.scale = scale;
  a.mp.causal = causal; a.mp.window_left = window_left;
  a.mp.window_right = window_right; a.mp.softcap = softcap;
  a.mp.has_alibi = has_alibi;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (D) {
    case 32: e = launch_rows<32>(a, st); break;
    case 64: e = launch_rows<64>(a, st); break;
    case 128: e = launch_rows<128>(a, st); break;
    case 256: e = launch_rows<256>(a, st); break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
