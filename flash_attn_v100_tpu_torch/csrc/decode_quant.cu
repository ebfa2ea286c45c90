// K4q: split-KV paged decode attention over int8, fp8 (e4m3) or int4 page
// pools with per-(token, head) fp32 scales, for Hopper (sm_90a).
//
// Replaces the quantized branches of
// flash_attn_v100_tpu/ops/pallas/decode.py::_decode_kernel (with
// _decode_page_update and _decode_tile_update), the TPU kernel behind
// paged_decode_attention(k_scales=, v_scales=, int4=).  The contract is
// K4's (decode.cu): q rows (B, Hk, Rq, D), a page pool view
// (C1, Hk, C2, rows, D) through a block table, one normalized partial O and
// one LSE per split.  The payload is int8, e4m3, or int4 packed two tokens
// a byte (rows = page_size / 2); the scales are (C1, Hk, C2, page_size, 1).
// The arithmetic is the TPU kernel's:
//   int8 and int4: each q row is quantized to int8 (scale amax / 127,
//     rint(q / scale)); the score is the int32 dot q8 . k8, then
//     float(dot) * q_scale * k_scale * softmax_scale -> ALiBi -> softcap;
//     P is multiplied by V's per-token scales and quantized to int8 per row
//     over a group of keys (scale amax / 127); P8 . V8 runs in int32 and is
//     added as float(int) * p_scale to the fp32 accumulator after the
//     online-softmax rescale.
//   fp8: K and V are converted exactly to float; the score is the fp32 dot,
//     times k_scale, then the pipeline; P times V's scales is rounded to
//     bf16 before the P V product.
// P's grouping: the TPU kernel takes P's int8 scale per page; this kernel
// takes it per (q row, chunk of kKeyTile = 32 consecutive cache rows,
// counted from its split's first row).  The plain twin
// (ops/cuda/decode.py::paged_decode_attention_ref, p_tile=32) groups the
// same way.
//
// What bounds it on this card: bytes.  Decode reads every live payload byte
// and scale once: 2 * (D + 4) bytes per token and kv head for int8/fp8,
// 2 * (D / 2 + 4) for int4, against 2 * 2 * D for the 16-bit K4, at a few
// operations per byte.  At the engine's decode shapes the K/V of a step is
// a few MB, so launch latency and filling the SMs matter as much.
//
// What the design does about it: K4's layout: one block per (batch row, kv
// head, split, 8-row q tile), page ids resolved from the block table, the
// range trimmed to the live / causal / window extent before the loop,
// 32-key chunks streamed with 16-byte loads (16 int8/e4m3 values or 32
// int4 values a load), the next chunk's loads in flight during the current
// chunk's arithmetic.  int8/int4: the q rows are quantized once in the
// prologue, int4 is unpacked to int8 in token order into shared memory,
// each lane scores one key with __dp4a over D/4 words and owns D/32 output
// columns for the int32 P V sums; the softmax state never leaves registers.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "masks.cuh"
#include "quant.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 2;
constexpr int kRowTile = kWarps * kRowsPerWarp;  // q rows per block
constexpr int kKeyTile = 32;                     // keys per chunk: one a lane

struct DecodeQuantArgs {
  const void* q;          // (B, Hk, Rq, D) contiguous, bf16 or fp16
  const uint8_t* k;       // payload pool view base, byte strides below
  const uint8_t* v;
  const float* ks;        // scale pool views, float strides below
  const float* vs;
  const int* table;       // (B, max_pages)
  const int* lens;        // (B,) live tokens after leftpad
  const int* leftpad;     // (B,) or nullptr
  const int* qpos;        // (B,) position of the first new token
  const float* slopes;    // (B, Hk, Rq) or nullptr
  float* o_part;          // (B, Hk, S, Rq, D)
  float* lse_part;        // (B, Hk, S, Rq)
  long long s_c1, s_h, s_c2, s_tok;      // payload strides (bytes)
  long long sc_c1, sc_h, sc_c2, sc_tok;  // scale strides (floats)
  int c2;
  int B, Hk, Rq, S, max_pages, page_size, pages_per_split, t_new, group;
  float scale;
  fa::MaskParams mp;
};

template <int D, int KIND>
struct DecodeSmem {
  static constexpr bool kInt = KIND != fa::kFp8;
  static constexpr int DP8 = D + 4;  // int8 row stride: odd word stride
  static constexpr int DPF = D + 1;  // float row stride: key-per-lane reads
  static constexpr size_t bytes =
      kInt ? static_cast<size_t>(kRowTile + kKeyTile) * DP8 + kKeyTile * D
           : sizeof(float) * (kRowTile * D + 2 * kKeyTile * DPF);
};

template <typename T, int D, int KIND>
__global__ void __launch_bounds__(kThreads)
    decode_quant_kernel(DecodeQuantArgs a) {
  using L = DecodeSmem<D, KIND>;
  constexpr bool kInt = L::kInt;
  constexpr int DP8 = L::DP8, DPF = L::DPF;
  constexpr int NC = D / 32;  // accumulator columns per lane
  extern __shared__ __align__(16) unsigned char smem[];
  // int8 / int4: q8 [kRowTile][DP8], k8 [kKeyTile][DP8], v8 [kKeyTile][D]
  int8_t* q8_s = reinterpret_cast<int8_t*>(smem);
  int8_t* k8_s = q8_s + kRowTile * DP8;
  int8_t* v8_s = k8_s + kKeyTile * DP8;
  // fp8: q [kRowTile][D], k and v [kKeyTile][DPF] as floats
  float* qf_s = reinterpret_cast<float*>(smem);
  float* kf_s = qf_s + kRowTile * D;
  float* vf_s = kf_s + kKeyTile * DPF;

  const int n_rt = a.Rq / kRowTile;
  const int split = blockIdx.x / n_rt;
  const int row0 = (blockIdx.x % n_rt) * kRowTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  const int lp = a.leftpad ? a.leftpad[b] : 0;
  const int cs = a.lens[b];
  const int qbase = a.qpos[b];
  const int n_rows = a.group * a.t_new;

  int qp[kRowsPerWarp];
  bool row_ok[kRowsPerWarp];
  float slope[kRowsPerWarp], q_scale[kRowsPerWarp];
  const T* qb = static_cast<const T*>(a.q) +
                ((static_cast<long long>(b) * a.Hk + h) * a.Rq + row0) * D;
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int rl = warp * kRowsPerWarp + i;  // row within the tile
    const int r = row0 + rl;
    qp[i] = qbase + (a.t_new > 1 ? r % a.t_new : 0);
    row_ok[i] = r < n_rows;
    slope[i] = a.slopes
                   ? a.slopes[(static_cast<long long>(b) * a.Hk + h) * a.Rq + r]
                   : 0.0f;
    // this warp's q rows: int8 per row (int paths) or floats (fp8)
    float x[NC];
    float amax = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      x[c] = fa::to_float(qb[rl * D + lane + 32 * c]);
      amax = fmaxf(amax, fabsf(x[c]));
    }
    q_scale[i] = fa::p_scale_of(fa::warp_max(amax));
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      if constexpr (kInt) {
        q8_s[rl * DP8 + lane + 32 * c] =
            static_cast<int8_t>(rintf(x[c] / q_scale[i]));
      } else {
        qf_s[rl * D + lane + 32 * c] = x[c];
      }
    }
  }

  // this split's cache rows, trimmed to the live / window / causal extent
  const long long span = static_cast<long long>(a.pages_per_split) * a.page_size;
  const long long cap = static_cast<long long>(a.max_pages) * a.page_size;
  const long long split0 = split * span;
  long long j_lo = split0;
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

  const uint8_t* kbase = a.k + h * a.s_h;
  const uint8_t* vbase = a.v + h * a.s_h;
  const int* tbl = a.table + static_cast<long long>(b) * a.max_pages;

  // 16-byte payload loads: a chunk holds kKeyTile rows of D bytes (int8,
  // fp8) or kKeyTile / 2 byte rows of token pairs (int4)
  constexpr int kRowsLoaded = KIND == fa::kInt4 ? kKeyTile / 2 : kKeyTile;
  constexpr int kLoads = kRowsLoaded * (D / 16);
  constexpr int NL = (kLoads + kThreads - 1) / kThreads;
  uint4 kraw[NL], vraw[NL];
  float ks_r = 0.0f, vs_r = 0.0f;  // this lane's key's scales
  auto page_of = [&](long long j, int& off) {
    const int slot = static_cast<int>(j / a.page_size);
    off = static_cast<int>(j - static_cast<long long>(slot) * a.page_size);
    return tbl[slot];
  };
  auto fetch = [&](long long j0) {
#pragma unroll
    for (int u = 0; u < NL; ++u) {
      const int idx = threadIdx.x + u * kThreads;
      const int row = idx / (D / 16);
      const int d16 = (idx % (D / 16)) * 16;
      kraw[u] = vraw[u] = make_uint4(0, 0, 0, 0);
      // int4: byte row `row` holds keys j0 + 2 row and j0 + 2 row + 1
      const long long j = j0 + (KIND == fa::kInt4 ? 2 * row : row);
      const long long j_last = KIND == fa::kInt4 ? j + 1 : j;
      if (idx < kLoads && j_last >= j_lo && j < j_hi) {
        int off;
        const int page = page_of(j, off);
        const long long o = static_cast<long long>(page / a.c2) * a.s_c1 +
                            static_cast<long long>(page % a.c2) * a.s_c2 +
                            static_cast<long long>(
                                KIND == fa::kInt4 ? off / 2 : off) * a.s_tok +
                            d16;
        kraw[u] = *reinterpret_cast<const uint4*>(kbase + o);
        vraw[u] = *reinterpret_cast<const uint4*>(vbase + o);
      }
    }
    ks_r = vs_r = 0.0f;
    const long long j = j0 + lane;
    if (j >= j_lo && j < j_hi) {
      int off;
      const int page = page_of(j, off);
      const long long o = static_cast<long long>(page / a.c2) * a.sc_c1 +
                          h * a.sc_h +
                          static_cast<long long>(page % a.c2) * a.sc_c2 +
                          static_cast<long long>(off) * a.sc_tok;
      ks_r = a.ks[o];
      vs_r = a.vs[o];
    }
  };

  // chunks are aligned to kKeyTile rows from the split's first row: P's
  // int8 groups (the plain twin's p_tile)
  const long long j_first = split0 + ((j_lo - split0) / kKeyTile) * kKeyTile;
  if (j_lo < j_hi) fetch(j_first);

  for (long long j0 = j_first; j0 < j_hi; j0 += kKeyTile) {
    __syncthreads();  // previous chunk fully consumed (and q stored)
#pragma unroll
    for (int u = 0; u < NL; ++u) {
      const int idx = threadIdx.x + u * kThreads;
      if (idx >= kLoads) continue;
      const int row = idx / (D / 16);
      const int d16 = (idx % (D / 16)) * 16;
      if constexpr (KIND == fa::kInt8) {
        const uint32_t* kw = reinterpret_cast<const uint32_t*>(&kraw[u]);
        uint32_t* kd = reinterpret_cast<uint32_t*>(k8_s + row * DP8 + d16);
#pragma unroll
        for (int w = 0; w < 4; ++w) kd[w] = kw[w];
        *reinterpret_cast<uint4*>(v8_s + row * D + d16) = vraw[u];
      } else if constexpr (KIND == fa::kInt4) {
        uint4 ke, ko, ve, vo;
        fa::unpack_int4x16(kraw[u], ke, ko);
        fa::unpack_int4x16(vraw[u], ve, vo);
        uint32_t* k0 = reinterpret_cast<uint32_t*>(k8_s + (2 * row) * DP8 + d16);
        uint32_t* k1 = reinterpret_cast<uint32_t*>(k8_s + (2 * row + 1) * DP8 + d16);
        const uint32_t* e = reinterpret_cast<const uint32_t*>(&ke);
        const uint32_t* o = reinterpret_cast<const uint32_t*>(&ko);
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          k0[w] = e[w];
          k1[w] = o[w];
        }
        *reinterpret_cast<uint4*>(v8_s + (2 * row) * D + d16) = ve;
        *reinterpret_cast<uint4*>(v8_s + (2 * row + 1) * D + d16) = vo;
      } else {
        const uint8_t* kb = reinterpret_cast<const uint8_t*>(&kraw[u]);
        const uint8_t* vb = reinterpret_cast<const uint8_t*>(&vraw[u]);
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          kf_s[row * DPF + d16 + e] = fa::e4m3_to_float(kb[e]);
          vf_s[row * DPF + d16 + e] = fa::e4m3_to_float(vb[e]);
        }
      }
    }
    const float ks_j = ks_r, vs_j = vs_r;
    __syncthreads();
    if (j0 + kKeyTile < j_hi) fetch(j0 + kKeyTile);

    const long long j = j0 + lane;
    const int jl = static_cast<int>(j - lp);  // position in the live frame
    const bool key_ok = j >= j_lo && j < j_hi && jl >= 0 && jl < cs;
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int rl = warp * kRowsPerWarp + i;
      float s;
      if constexpr (kInt) {
        const int* qw = reinterpret_cast<const int*>(q8_s + rl * DP8);
        const int* kw = reinterpret_cast<const int*>(k8_s + lane * DP8);
        int dot = 0;
#pragma unroll 8
        for (int w = 0; w < D / 4; ++w) dot = __dp4a(qw[w], kw[w], dot);
        s = static_cast<float>(dot) * q_scale[i] * ks_j;
      } else {
        const float* qr = qf_s + rl * D;
        const float* kr = kf_s + lane * DPF;
        s = 0.0f;
#pragma unroll 8
        for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr[d], s);
        s = s * ks_j;
      }
      s = fa::score_bias(s, qp[i], jl, a.scale, slope[i], a.mp);
      const bool valid = key_ok && row_ok[i] && fa::position_valid(qp[i], jl, a.mp);
      s = valid ? s : fa::kNegInf;

      const float m_next = fmaxf(m[i], fa::warp_max(s));
      const float alpha = expf(m[i] - m_next);
      const float p = valid ? expf(fmaxf(s - m_next, fa::kExpClamp)) : 0.0f;
      l[i] = alpha * l[i] + fa::warp_sum(p);
      m[i] = m_next;
      const float pv = p * vs_j;  // V's dequant scale folded into P
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
      if constexpr (kInt) {
        const float p_scale = fa::p_scale_of(fa::warp_max(pv));
        const int p8 = static_cast<int>(rintf(pv / p_scale));
        int iacc[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c) iacc[c] = 0;
        for (int jj = 0; jj < kKeyTile; ++jj) {
          const int pj = __shfl_sync(0xffffffffu, p8, jj);
          const int8_t* vr = v8_s + jj * D + lane;
#pragma unroll
          for (int c = 0; c < NC; ++c) iacc[c] += pj * static_cast<int>(vr[32 * c]);
        }
#pragma unroll
        for (int c = 0; c < NC; ++c)
          acc[i][c] += static_cast<float>(iacc[c]) * p_scale;
      } else {
        const float pb = __bfloat162float(__float2bfloat16(pv));
        for (int jj = 0; jj < kKeyTile; ++jj) {
          const float pj = __shfl_sync(0xffffffffu, pb, jj);
          const float* vr = vf_s + jj * DPF + lane;
#pragma unroll
          for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(pj, vr[32 * c], acc[i][c]);
        }
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

template <typename T, int D, int KIND>
cudaError_t launch(const DecodeQuantArgs& a, cudaStream_t stream) {
  const size_t smem = DecodeSmem<D, KIND>::bytes;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        decode_quant_kernel<T, D, KIND>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  dim3 grid(a.S * (a.Rq / kRowTile), a.Hk, a.B);
  decode_quant_kernel<T, D, KIND><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int KIND>
cudaError_t dispatch_d(int D, const DecodeQuantArgs& a, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32, KIND>(a, stream);
    case 64: return launch<T, 64, KIND>(a, stream);
    case 128: return launch<T, 128, KIND>(a, stream);
    case 256: return launch<T, 256, KIND>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_kind(int kind, int D, const DecodeQuantArgs& a,
                          cudaStream_t stream) {
  switch (kind) {
    case fa::kInt8: return dispatch_d<T, fa::kInt8>(D, a, stream);
    case fa::kFp8: return dispatch_d<T, fa::kFp8>(D, a, stream);
    case fa::kInt4: return dispatch_d<T, fa::kInt4>(D, a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// kind: 0 = int8, 1 = fp8 (e4m3), 2 = int4; dtype (of q): 0 = bf16,
// 1 = fp16.  Returns cudaGetLastError() of the launch.
extern "C" int fa_decode_quant_launch(
    int kind, int dtype, const void* q, const void* k, const void* v,
    const float* ks, const float* vs, const int* table, const int* lens,
    const int* leftpad, const int* qpos, const float* slopes, float* o_part,
    float* lse_part, long long s_c1, long long s_h, long long s_c2,
    long long s_tok, long long sc_c1, long long sc_h, long long sc_c2,
    long long sc_tok, int c2, int B, int Hk, int Rq, int D, int S,
    int max_pages, int page_size, int pages_per_split, int t_new, int group,
    float scale, int causal, int window_left, int window_right, float softcap,
    int has_alibi, void* stream) {
  if (Rq % kRowTile != 0 || (kind == fa::kInt4 && page_size % 2 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  DecodeQuantArgs a;
  a.q = q; a.k = static_cast<const uint8_t*>(k);
  a.v = static_cast<const uint8_t*>(v); a.ks = ks; a.vs = vs;
  a.table = table; a.lens = lens; a.leftpad = leftpad; a.qpos = qpos;
  a.slopes = has_alibi ? slopes : nullptr;
  a.o_part = o_part; a.lse_part = lse_part;
  a.s_c1 = s_c1; a.s_h = s_h; a.s_c2 = s_c2; a.s_tok = s_tok;
  a.sc_c1 = sc_c1; a.sc_h = sc_h; a.sc_c2 = sc_c2; a.sc_tok = sc_tok;
  a.c2 = c2; a.B = B; a.Hk = Hk; a.Rq = Rq; a.S = S; a.max_pages = max_pages;
  a.page_size = page_size; a.pages_per_split = pages_per_split;
  a.t_new = t_new; a.group = group; a.scale = scale;
  a.mp.causal = causal; a.mp.window_left = window_left;
  a.mp.window_right = window_right; a.mp.softcap = softcap;
  a.mp.has_alibi = has_alibi;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = dtype == 0 ? dispatch_kind<__nv_bfloat16>(kind, D, a, s)
                             : dispatch_kind<__half>(kind, D, a, s);
  return static_cast<int>(e);
}
