// K8: packed-varlen attention forward with K/V read through a block table
// from an HND page pool, for Hopper (sm_90a).
//
// Replaces flash_attn_v100_tpu/ops/pallas/varlen.py::_varlen_fwd_kernel_paged
// (body shared with _varlen_fwd_kernel), the TPU kernel behind
// flash_attn_varlen_fwd_paged and the engine's large-prefill route.  Same
// contract: q (Tq, Hq, D) packed by cu_seqlens_q, pools (Hk, P, ps, D),
// seqlens_k / seqused_k / leftpad_k per sequence, bottom-right causal and
// window masks per sequence, scale -> ALiBi -> softcap; out (Tq, Hq, D) in
// q's dtype and LSE (Hq, Tq) fp32.  A row with no live key gives O = 0 and
// LSE = -inf.
//
// What bounds it on this card: operations.  A 512-token prefill does
// 4 * D flops per (q row, key) pair against K/V bytes read once per q tile,
// well above the ~295 flop/byte ridge, so the floor is the flops over the
// 989 TFLOP/s of the bf16 tensor cores.
//
// What the design does about it: one block per (q tile of 64 rows, q head,
// sequence); the block finds its rows from cu_seqlens_q and turns the
// ragged bookkeeping of build_ragged_info into closed-form index math: the
// live key range of a row is one contiguous interval [rel_lo, rel_hi], and
// the block loops only over the 64-key tiles that the union of its rows'
// intervals touches (the reference CUDA BlockInfo trim), resolving each
// tile's page from the block table (tiles never straddle pages: ps % 64 ==
// 0).  Both products run on the tensor cores through WMMA 16x16x16
// fragments with fp32 accumulation: S = Q K^T into shared memory, the masked
// online softmax in fp32 by the warp that owns those 16 rows, P rounded to
// the input type, then P V added into an fp32 accumulator in shared memory
// after the per-row rescale.  wgmma, TMA and warp specialisation are left
// for a later change.
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>

#include "masks.cuh"

namespace {

using namespace nvcuda;

constexpr int kBQ = 64;            // q rows per block
constexpr int kBK = 64;            // keys per tile
constexpr int kWarps = kBQ / 16;   // each warp owns 16 q rows
constexpr int kThreads = kWarps * 32;

struct VarlenArgs {
  const void* q;          // (Tq, Hq, D) contiguous
  const void* k;          // pool (Hk, P, ps, D), strides below (elements)
  const void* v;
  const int* table;       // (B, table_stride)
  const int* cu_q;        // (B + 1,)
  const int* seqlens_k;   // (B,)
  const int* seqused_k;   // (B,) or nullptr
  const int* leftpad_k;   // (B,) or nullptr
  const float* slopes;    // (B, Hq) or nullptr
  void* out;              // (Tq, Hq, D)
  float* lse;             // (Hq, Tq)
  long long s_h, s_p, s_tok;
  int table_stride;
  int Tq, Hq, group, page_size, mp;
  float scale;
  fa::MaskParams mp_;
};

template <typename T, int D>
struct Smem {
  static constexpr int DQ = D + 8;     // 16-bit row stride (elements)
  static constexpr int SP = kBK + 4;   // fp32 score row stride
  static constexpr int PP = kBK + 8;   // 16-bit P row stride
  static constexpr int OP = D + 4;     // fp32 accumulator row stride
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = q_off + sizeof(T) * kBQ * DQ;
  static constexpr size_t v_off = k_off + sizeof(T) * kBK * DQ;
  static constexpr size_t s_off = v_off + sizeof(T) * kBK * DQ;
  static constexpr size_t p_off = s_off + sizeof(float) * kBQ * SP;
  static constexpr size_t o_off = p_off + sizeof(T) * kBQ * PP;
  static constexpr size_t w_off = o_off + sizeof(float) * kBQ * OP;
  static constexpr size_t a_off = w_off + sizeof(float) * kWarps * 256;
  static constexpr size_t bytes = a_off + sizeof(float) * kBQ;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) varlen_paged_kernel(VarlenArgs a) {
  using L = Smem<T, D>;
  constexpr int DQ = L::DQ, SP = L::SP, PP = L::PP, OP = L::OP;
  extern __shared__ __align__(128) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem + L::q_off);
  T* k_s = reinterpret_cast<T*>(smem + L::k_off);
  T* v_s = reinterpret_cast<T*>(smem + L::v_off);
  float* s_s = reinterpret_cast<float*>(smem + L::s_off);
  T* p_s = reinterpret_cast<T*>(smem + L::p_off);
  float* o_s = reinterpret_cast<float*>(smem + L::o_off);
  float* w_s = reinterpret_cast<float*>(smem + L::w_off);
  float* a_s = reinterpret_cast<float*>(smem + L::a_off);

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q_first = a.cu_q[b];
  const int slq = a.cu_q[b + 1] - q_first;
  const int qp0 = blockIdx.x * kBQ;
  if (qp0 >= slq) return;  // uniform over the block
  const int nq = min(kBQ, slq - qp0);
  const int kvh = h / a.group;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  // build_ragged_info in closed form for this sequence
  int used = a.seqlens_k[b];
  if (a.seqused_k) used = min(used, a.seqused_k[b]);
  const int lp = a.leftpad_k ? a.leftpad_k[b] : 0;
  const int slk = (used > 0 ? min(a.mp * a.page_size, used) : 0) - lp;
  const int offs = slk - slq;
  const int wl = a.mp_.window_left;
  const int wr = a.mp_.effective_window_right();
  // live keys of q position qp, in the leftpad-relative frame: [lo, hi]
  auto rel_lo = [&](int qp) { return wl >= 0 ? max(qp + offs - wl, 0) : 0; };
  auto rel_hi = [&](int qp) {
    return wr >= 0 ? min(slk - 1, qp + offs + wr) : slk - 1;
  };
  const int blk_lo = rel_lo(qp0);
  const int blk_hi = rel_hi(qp0 + nq - 1);
  const float slope = a.slopes ? a.slopes[b * a.Hq + h] : 0.0f;

  // q tile (rows past the sequence end are zero)
  const T* qg = static_cast<const T*>(a.q);
  for (int idx = threadIdx.x; idx < kBQ * (D / 8); idx += kThreads) {
    const int r = idx / (D / 8);
    const int d8 = (idx % (D / 8)) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < nq) {
      const long long off =
          (static_cast<long long>(q_first + qp0 + r) * a.Hq + h) * D + d8;
      val = *reinterpret_cast<const uint4*>(qg + off);
    }
    *reinterpret_cast<uint4*>(q_s + r * DQ + d8) = val;
  }
  // this warp's rows: accumulator zero, softmax state in registers (every
  // lane holds the same copy of its warp's 16 rows)
  for (int e = lane; e < 16 * OP; e += 32) o_s[warp * 16 * OP + e] = 0.0f;
  float m[16], l[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    m[i] = fa::kNegInf;
    l[i] = 0.0f;
  }

  const T* kg = static_cast<const T*>(a.k) + kvh * a.s_h;
  const T* vg = static_cast<const T*>(a.v) + kvh * a.s_h;
  const int* tbl = a.table + static_cast<long long>(b) * a.table_stride;

  if (blk_hi >= blk_lo) {
    const int raw_lo = lp + blk_lo, raw_hi = lp + blk_hi;  // inclusive
    for (int k0 = (raw_lo / kBK) * kBK; k0 <= raw_hi; k0 += kBK) {
      __syncthreads();  // previous tile consumed; q_s / o_s initialised
      const int slot = k0 / a.page_size;
      const int page = tbl[slot];
      const long long base = static_cast<long long>(page) * a.s_p +
                             static_cast<long long>(k0 - slot * a.page_size) * a.s_tok;
      for (int idx = threadIdx.x; idx < kBK * (D / 8); idx += kThreads) {
        const int kk = idx / (D / 8);
        const int d8 = (idx % (D / 8)) * 8;
        const int raw = k0 + kk;
        uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
        if (raw >= raw_lo && raw <= raw_hi) {
          const long long o = base + static_cast<long long>(kk) * a.s_tok + d8;
          kv = *reinterpret_cast<const uint4*>(kg + o);
          vv = *reinterpret_cast<const uint4*>(vg + o);
        }
        *reinterpret_cast<uint4*>(k_s + kk * DQ + d8) = kv;
        *reinterpret_cast<uint4*>(v_s + kk * DQ + d8) = vv;
      }
      __syncthreads();

      // S = Q K^T for this warp's 16 rows
#pragma unroll
      for (int cb = 0; cb < kBK / 16; ++cb) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
        wmma::fill_fragment(c, 0.0f);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> fa_;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major> fb;
          wmma::load_matrix_sync(fa_, q_s + warp * 16 * DQ + kk * 16, DQ);
          wmma::load_matrix_sync(fb, k_s + cb * 16 * DQ + kk * 16, DQ);
          wmma::mma_sync(c, fa_, fb, c);
        }
        wmma::store_matrix_sync(s_s + warp * 16 * SP + cb * 16, c, SP,
                                wmma::mem_row_major);
      }
      __syncwarp();

      // masked online softmax, one row at a time; lane owns keys lane, lane+32
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int r = warp * 16 + i;
        const int qp = qp0 + r;
        const bool row_ok = r < nq;
        const int lo = rel_lo(qp), hi = rel_hi(qp);
        float s2[2];
        bool ok2[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int c = lane + 32 * u;
          const int rel = k0 + c - lp;  // leftpad-relative key position
          ok2[u] = row_ok && rel >= lo && rel <= hi;
          const float s = fa::score_bias(s_s[r * SP + c], qp + offs, rel,
                                         a.scale, slope, a.mp_);
          s2[u] = ok2[u] ? s : fa::kNegInf;
        }
        const float m_next = fmaxf(m[i], fa::warp_max(fmaxf(s2[0], s2[1])));
        const float alpha = expf(m[i] - m_next);
        float psum = 0.0f;
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const float p = ok2[u] ? expf(s2[u] - m_next) : 0.0f;
          psum += p;
          p_s[r * PP + lane + 32 * u] = fa::from_float<T>(p);
        }
        l[i] = alpha * l[i] + fa::warp_sum(psum);
        m[i] = m_next;
        if (lane == 0) a_s[r] = alpha;
      }
      __syncwarp();

      // O = alpha * O + P V for this warp's 16 rows
#pragma unroll
      for (int cb = 0; cb < D / 16; ++cb) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
        wmma::fill_fragment(c, 0.0f);
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> fa_;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> fb;
          wmma::load_matrix_sync(fa_, p_s + warp * 16 * PP + kk * 16, PP);
          wmma::load_matrix_sync(fb, v_s + kk * 16 * DQ + cb * 16, DQ);
          wmma::mma_sync(c, fa_, fb, c);
        }
        float* w = w_s + warp * 256;
        wmma::store_matrix_sync(w, c, 16, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          const int r = warp * 16 + e / 16;
          float* o = o_s + r * OP + cb * 16 + (e % 16);
          *o = *o * a_s[r] + w[e];
        }
        __syncwarp();
      }
    }
  }
  __syncwarp();

  // store this warp's rows
  T* og = static_cast<T*>(a.out);
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int r = warp * 16 + i;
    if (r >= nq) continue;
    const long long row = q_first + qp0 + r;
    const float inv = l[i] == 0.0f ? 0.0f : 1.0f / l[i];
    for (int d = lane; d < D; d += 32)
      og[(row * a.Hq + h) * D + d] = fa::from_float<T>(o_s[r * OP + d] * inv);
    if (lane == 0)
      a.lse[static_cast<long long>(h) * a.Tq + row] =
          l[i] == 0.0f ? -INFINITY : m[i] + logf(l[i]);
  }
}

template <typename T, int D>
cudaError_t launch(const VarlenArgs& a, int n_q_tiles, int B,
                   cudaStream_t stream) {
  const size_t smem = Smem<T, D>::bytes;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        varlen_paged_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  dim3 grid(n_q_tiles, a.Hq, B);
  varlen_paged_kernel<T, D><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const VarlenArgs& a, int n_q_tiles, int B,
                       cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(a, n_q_tiles, B, stream);
    case 64: return launch<T, 64>(a, n_q_tiles, B, stream);
    case 128: return launch<T, 128>(a, n_q_tiles, B, stream);
    case 256: return launch<T, 256>(a, n_q_tiles, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = bf16, 1 = fp16.  Returns cudaGetLastError() of the launch.
extern "C" int fa_varlen_paged_launch(
    int dtype, const void* q, const void* k, const void* v, const int* table,
    int table_stride, const int* cu_q, const int* seqlens_k,
    const int* seqused_k, const int* leftpad_k, const float* slopes, void* out,
    float* lse, long long s_h, long long s_p, long long s_tok, int B, int Tq,
    int Hq, int Hk, int D, int page_size, int mp, int max_seqlen_q,
    float scale, int causal, int window_left, int window_right, float softcap,
    int has_alibi, void* stream) {
  if (page_size % kBK != 0 || Hq % Hk != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  VarlenArgs a;
  a.q = q; a.k = k; a.v = v; a.table = table; a.cu_q = cu_q;
  a.seqlens_k = seqlens_k; a.seqused_k = seqused_k; a.leftpad_k = leftpad_k;
  a.slopes = has_alibi ? slopes : nullptr; a.out = out; a.lse = lse;
  a.s_h = s_h; a.s_p = s_p; a.s_tok = s_tok; a.table_stride = table_stride;
  a.Tq = Tq; a.Hq = Hq; a.group = Hq / Hk; a.page_size = page_size;
  a.mp = mp; a.scale = scale;
  a.mp_.causal = causal; a.mp_.window_left = window_left;
  a.mp_.window_right = window_right; a.mp_.softcap = softcap;
  a.mp_.has_alibi = has_alibi;
  const int n_q_tiles = (max_seqlen_q + kBQ - 1) / kBQ;
  if (n_q_tiles == 0 || B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = dtype == 0 ? dispatch_d<__nv_bfloat16>(D, a, n_q_tiles, B, s)
                             : dispatch_d<__half>(D, a, n_q_tiles, B, s);
  return static_cast<int>(e);
}
