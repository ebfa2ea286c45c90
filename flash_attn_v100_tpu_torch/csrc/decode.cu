// K4: split-KV paged decode attention over GQA-folded q rows, for Hopper
// (sm_90a).
//
// Replaces flash_attn_v100_tpu/ops/pallas/decode.py::_decode_kernel (with
// _decode_page_update and _decode_tile_update), the TPU kernel behind
// paged_decode_attention.  Same contract: q rows (B, Hk, Rq, D) with row
// r = g * t_new + t, a page pool view (C1, Hk, C2, ps, D) addressed through a
// block table, live cache rows [leftpad, leftpad + lens), q position
// qpos + r % t_new; one normalized partial O and one LSE per split, merged
// outside (merge_partials).  A row with no live key gives O = 0, LSE = -inf.
//
// What bounds it on this card: bytes.  Decode reads every live K and V byte
// once and does 4 * Rq flops per K/V element pair: at Rq = 8 that is far
// below the ~295 flop/byte at which an H100 turns compute-bound, so the
// floor is the K/V bytes over 3.35 TB/s.  At the engine's decode shapes the
// whole K/V of a step is a few MB, so launch latency and filling the 132 SMs
// matter as much as streaming.
//
// What the design does about it: one block per (batch row, kv head, split,
// 8-row q tile) so that B * Hk * S blocks fill the SMs even at small batch
// (the wrapper picks S); each block resolves its own page ids from the
// block table (the TPU kernel's scalar-prefetch index maps), streams its
// key range in 32-key chunks with 16-byte loads (the next chunk's loads in
// flight during the current chunk's arithmetic) through shared memory, and
// trims the range to the live, causal and window extent before the loop.
// Scores, softmax state and the accumulator stay fp32: each warp owns two q
// rows, a lane owns one key of the chunk for the scores and D/32 output
// columns for the accumulator, so the online softmax reduces with warp
// shuffles and never leaves registers.  Plain FMA arithmetic, no tensor
// cores: at Rq = 8 the arithmetic is not the limit.
#include <cuda_runtime.h>
#include <math.h>

#include "masks.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 2;
constexpr int kRowTile = kWarps * kRowsPerWarp;  // q rows per block
constexpr int kKeyTile = 32;                     // keys per chunk: one a lane

struct DecodeArgs {
  const void* q;         // (B, Hk, Rq, D) contiguous
  const void* k;         // pool view base, strides below (elements)
  const void* v;
  const int* table;      // (B, max_pages)
  const int* lens;       // (B,) live tokens after leftpad
  const int* leftpad;    // (B,) or nullptr
  const int* qpos;       // (B,) position of the first new token
  const float* slopes;   // (B, Hk, Rq) or nullptr
  float* o_part;         // (B, Hk, S, Rq, D)
  float* lse_part;       // (B, Hk, S, Rq)
  long long s_c1, s_h, s_c2, s_tok;
  int c2;
  int B, Hk, Rq, S, max_pages, page_size, pages_per_split, t_new, group;
  float scale;
  fa::MaskParams mp;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) decode_kernel(DecodeArgs a) {
  constexpr int DP = D + 1;   // padded smem row: conflict-free key-per-lane reads
  constexpr int NC = D / 32;  // accumulator columns per lane
  extern __shared__ float smem[];
  float* q_s = smem;                   // [kRowTile][D]
  float* k_s = q_s + kRowTile * D;     // [kKeyTile][DP]
  float* v_s = k_s + kKeyTile * DP;    // [kKeyTile][DP]

  const int n_rt = a.Rq / kRowTile;
  const int split = blockIdx.x / n_rt;
  const int row0 = (blockIdx.x % n_rt) * kRowTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  const T* qb = static_cast<const T*>(a.q) +
                ((static_cast<long long>(b) * a.Hk + h) * a.Rq + row0) * D;
  for (int i = threadIdx.x; i < kRowTile * D; i += kThreads)
    q_s[i] = fa::to_float(qb[i]);

  const int lp = a.leftpad ? a.leftpad[b] : 0;
  const int cs = a.lens[b];
  const int qbase = a.qpos[b];
  const int n_rows = a.group * a.t_new;

  int qp[kRowsPerWarp];
  bool row_ok[kRowsPerWarp];
  float slope[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = row0 + warp * kRowsPerWarp + i;
    qp[i] = qbase + (a.t_new > 1 ? r % a.t_new : 0);
    row_ok[i] = r < n_rows;
    slope[i] = a.slopes
                   ? a.slopes[(static_cast<long long>(b) * a.Hk + h) * a.Rq + r]
                   : 0.0f;
  }

  // this split's cache rows, trimmed to the live / window / causal extent
  const long long span = static_cast<long long>(a.pages_per_split) * a.page_size;
  const long long cap = static_cast<long long>(a.max_pages) * a.page_size;
  long long j_lo = split * span;
  long long j_hi = j_lo + span < cap ? j_lo + span : cap;
  if (j_lo < lp) j_lo = lp;
  if (j_hi > static_cast<long long>(lp) + cs) j_hi = static_cast<long long>(lp) + cs;
  if (a.mp.window_left >= 0) {
    const long long w = static_cast<long long>(lp) + qbase - a.mp.window_left;
    if (j_lo < w) j_lo = w;
  }
  const int wr = a.mp.effective_window_right();
  if (wr >= 0) {
    const long long w = static_cast<long long>(lp) + qbase + (a.t_new - 1) + wr + 1;
    if (j_hi > w) j_hi = w;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][NC];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m[i] = fa::kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.0f;
  }

  const T* kbase = static_cast<const T*>(a.k) + h * a.s_h;
  const T* vbase = static_cast<const T*>(a.v) + h * a.s_h;
  const int* tbl = a.table + static_cast<long long>(b) * a.max_pages;

  // 16-byte K (and V) loads per thread per chunk; the next chunk's loads
  // are issued before the current chunk's arithmetic and land in registers
  constexpr int NL = kKeyTile * (D / 8) / kThreads;
  uint4 kraw[NL], vraw[NL];
  auto fetch = [&](long long j0) {
#pragma unroll
    for (int u = 0; u < NL; ++u) {
      const int idx = threadIdx.x + u * kThreads;
      const int kk = idx / (D / 8);
      const int d8 = (idx % (D / 8)) * 8;
      const long long j = j0 + kk;
      kraw[u] = vraw[u] = make_uint4(0, 0, 0, 0);
      if (j < j_hi) {
        const int slot = static_cast<int>(j / a.page_size);
        const int off = static_cast<int>(j - static_cast<long long>(slot) * a.page_size);
        const int page = tbl[slot];
        const long long o = static_cast<long long>(page / a.c2) * a.s_c1 +
                            static_cast<long long>(page % a.c2) * a.s_c2 +
                            static_cast<long long>(off) * a.s_tok + d8;
        kraw[u] = *reinterpret_cast<const uint4*>(kbase + o);
        vraw[u] = *reinterpret_cast<const uint4*>(vbase + o);
      }
    }
  };
  if (j_lo < j_hi) fetch(j_lo);

  for (long long j0 = j_lo; j0 < j_hi; j0 += kKeyTile) {
    __syncthreads();  // previous chunk fully consumed (and q_s stored)
#pragma unroll
    for (int u = 0; u < NL; ++u) {
      const int idx = threadIdx.x + u * kThreads;
      const int kk = idx / (D / 8);
      const int d8 = (idx % (D / 8)) * 8;
      const T* ke = reinterpret_cast<const T*>(&kraw[u]);
      const T* ve = reinterpret_cast<const T*>(&vraw[u]);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        k_s[kk * DP + d8 + e] = fa::to_float(ke[e]);
        v_s[kk * DP + d8 + e] = fa::to_float(ve[e]);
      }
    }
    __syncthreads();
    if (j0 + kKeyTile < j_hi) fetch(j0 + kKeyTile);

    const long long j = j0 + lane;
    const int jl = static_cast<int>(j - lp);  // position in the live frame
    const bool key_ok = j < j_hi && jl >= 0 && jl < cs;
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const float* qr = q_s + (warp * kRowsPerWarp + i) * D;
      const float* kr = k_s + lane * DP;
      float s = 0.0f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr[d], s);
      s = fa::score_bias(s, qp[i], jl, a.scale, slope[i], a.mp);
      const bool valid = key_ok && row_ok[i] && fa::position_valid(qp[i], jl, a.mp);
      s = valid ? s : fa::kNegInf;

      const float m_next = fmaxf(m[i], fa::warp_max(s));
      const float alpha = expf(m[i] - m_next);
      const float p = valid ? expf(fmaxf(s - m_next, fa::kExpClamp)) : 0.0f;
      l[i] = alpha * l[i] + fa::warp_sum(p);
      m[i] = m_next;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
      for (int jj = 0; jj < kKeyTile; ++jj) {
        const float pj = __shfl_sync(0xffffffffu, p, jj);
        const float* vr = v_s + jj * DP + lane;
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(pj, vr[32 * c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = row0 + warp * kRowsPerWarp + i;
    const long long row =
        ((static_cast<long long>(b) * a.Hk + h) * a.S + split) * a.Rq + r;
    const float inv = l[i] == 0.0f ? 0.0f : 1.0f / l[i];
    float* o = a.o_part + row * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) o[lane + 32 * c] = acc[i][c] * inv;
    if (lane == 0) a.lse_part[row] = l[i] == 0.0f ? -INFINITY : m[i] + logf(l[i]);
  }
}

template <typename T, int D>
cudaError_t launch(const DecodeArgs& a, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (kRowTile * D + 2 * kKeyTile * (D + 1));
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        decode_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  dim3 grid(a.S * (a.Rq / kRowTile), a.Hk, a.B);
  decode_kernel<T, D><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const DecodeArgs& a, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(a, stream);
    case 64: return launch<T, 64>(a, stream);
    case 128: return launch<T, 128>(a, stream);
    case 256: return launch<T, 256>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = bf16, 1 = fp16.  Returns cudaGetLastError() of the launch.
extern "C" int fa_decode_launch(
    int dtype, const void* q, const void* k, const void* v, const int* table,
    const int* lens, const int* leftpad, const int* qpos, const float* slopes,
    float* o_part, float* lse_part, long long s_c1, long long s_h,
    long long s_c2, long long s_tok, int c2, int B, int Hk, int Rq, int D,
    int S, int max_pages, int page_size, int pages_per_split, int t_new,
    int group, float scale, int causal, int window_left, int window_right,
    float softcap, int has_alibi, void* stream) {
  if (Rq % kRowTile != 0) return static_cast<int>(cudaErrorInvalidValue);
  DecodeArgs a;
  a.q = q; a.k = k; a.v = v; a.table = table; a.lens = lens;
  a.leftpad = leftpad; a.qpos = qpos; a.slopes = has_alibi ? slopes : nullptr;
  a.o_part = o_part; a.lse_part = lse_part;
  a.s_c1 = s_c1; a.s_h = s_h; a.s_c2 = s_c2; a.s_tok = s_tok; a.c2 = c2;
  a.B = B; a.Hk = Hk; a.Rq = Rq; a.S = S; a.max_pages = max_pages;
  a.page_size = page_size; a.pages_per_split = pages_per_split;
  a.t_new = t_new; a.group = group; a.scale = scale;
  a.mp.causal = causal; a.mp.window_left = window_left;
  a.mp.window_right = window_right; a.mp.softcap = softcap;
  a.mp.has_alibi = has_alibi;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = dtype == 0 ? dispatch_d<__nv_bfloat16>(D, a, s)
                             : dispatch_d<__half>(D, a, s);
  return static_cast<int>(e);
}
