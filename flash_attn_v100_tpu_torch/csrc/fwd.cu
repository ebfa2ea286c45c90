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
// once per 64-row q tile, far above the ~295 flop/byte ridge, so the floor
// is the flops over the 989 TFLOP/s of the bf16 tensor cores.
//
// What the design does about it: one block per (64-row q tile, q head,
// batch row or sequence); a varlen block reads its sequence's bounds from
// device memory, leaves at once if its tile lies past the sequence, and
// loops only over the 64-key tiles that its rows' causal/window intervals
// touch (the reference CUDA BlockInfo trim), so a causal call does about
// half the tiles.  Both products run on the tensor cores through WMMA
// 16x16x16 fragments with fp32 accumulation: S = Q K^T into shared memory,
// the masked online softmax in fp32 by the warp that owns those 16 rows, P
// rounded to the input type, then P V added into an fp32 accumulator in
// shared memory after the per-row rescale.  wgmma, TMA and warp
// specialisation are left for a later change.
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>

#include "masks.cuh"
#include "philox.cuh"
#include "seq.cuh"

namespace {

using namespace nvcuda;

constexpr int kBQ = 64;            // q rows per block
constexpr int kBK = 64;            // keys per tile
constexpr int kWarps = kBQ / 16;   // each warp owns 16 q rows
constexpr int kThreads = kWarps * 32;

struct FwdArgs {
  const void* q;          // dense (B, M, Hq, D); varlen (Tq, Hq, D)
  const void* k;          // dense (B, N, Hk, D); varlen (Tk, Hk, D)
  const void* v;
  const float* slopes;    // (B, Hq) or nullptr
  void* out;              // q's shape
  float* lse;             // dense (B, Hq, M); varlen (Hq, Tq)
  fa::SeqArgs seq;
  int Hq, Hk, group;
  float scale;
  fa::MaskParams mp_;
  fa::DropoutParams dp;
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
  static constexpr size_t rw_off = a_off + sizeof(float) * kBQ;
  static constexpr size_t cw_off = rw_off + sizeof(uint32_t) * kBQ;
  static constexpr size_t bytes = cw_off + sizeof(uint32_t) * kBK;
};

template <typename T, int D, bool kVarlen>
__global__ void __launch_bounds__(kThreads) fwd_kernel(FwdArgs a) {
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
  uint32_t* rw_s = reinterpret_cast<uint32_t*>(smem + L::rw_off);
  uint32_t* cw_s = reinterpret_cast<uint32_t*>(smem + L::cw_off);

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const fa::Seq sq = fa::seq_info<kVarlen>(a.seq, b, a.Hq);
  const int qp0 = blockIdx.x * kBQ;
  if (qp0 >= sq.slq) return;  // uniform over the block
  const int nq = min(kBQ, sq.slq - qp0);
  const int kvh = h / a.group;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int N = sq.slk;
  const int offs = sq.offs;
  const int wl = a.mp_.window_left;
  const int wr = a.mp_.effective_window_right();
  // live keys of q row qp: [lo, hi]
  auto key_lo = [&](int qp) { return wl >= 0 ? max(qp + offs - wl, 0) : 0; };
  auto key_hi = [&](int qp) {
    return wr >= 0 ? min(N - 1, qp + offs + wr) : N - 1;
  };
  const int blk_lo = key_lo(qp0);
  const int blk_hi = key_hi(qp0 + nq - 1);
  const float slope = a.slopes ? a.slopes[b * a.Hq + h] : 0.0f;
  const bool drop = a.dp.enabled != 0;
  const uint32_t bh = fa::dropout_bh(b, h, a.dp);

  // q tile (rows past the sequence are zero); dropout row words of this tile
  const T* qg = static_cast<const T*>(a.q);
  for (int idx = threadIdx.x; idx < kBQ * (D / 8); idx += kThreads) {
    const int r = idx / (D / 8);
    const int d8 = (idx % (D / 8)) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < nq) {
      const long long off = ((sq.q_base + qp0 + r) * a.Hq + h) * D + d8;
      val = *reinterpret_cast<const uint4*>(qg + off);
    }
    *reinterpret_cast<uint4*>(q_s + r * DQ + d8) = val;
  }
  if (drop)
    for (int r = threadIdx.x; r < kBQ; r += kThreads)
      rw_s[r] = fa::dropout_row_word(qp0 + r + a.dp.q0, bh, a.dp);
  // this warp's rows: accumulator zero, softmax state in registers (every
  // lane holds the same copy of its warp's 16 rows)
  for (int e = lane; e < 16 * OP; e += 32) o_s[warp * 16 * OP + e] = 0.0f;
  float m[16], l[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    m[i] = fa::kNegInf;
    l[i] = 0.0f;
  }

  const T* kg = static_cast<const T*>(a.k);
  const T* vg = static_cast<const T*>(a.v);

  if (blk_hi >= blk_lo) {
    for (int k0 = (blk_lo / kBK) * kBK; k0 <= blk_hi; k0 += kBK) {
      __syncthreads();  // previous tile consumed; q_s / o_s / rw_s ready
      for (int idx = threadIdx.x; idx < kBK * (D / 8); idx += kThreads) {
        const int kk = idx / (D / 8);
        const int d8 = (idx % (D / 8)) * 8;
        const int kp = k0 + kk;
        uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
        if (kp >= blk_lo && kp <= blk_hi) {
          const long long o = ((sq.k_base + kp) * a.Hk + kvh) * D + d8;
          kv = *reinterpret_cast<const uint4*>(kg + o);
          vv = *reinterpret_cast<const uint4*>(vg + o);
        }
        *reinterpret_cast<uint4*>(k_s + kk * DQ + d8) = kv;
        *reinterpret_cast<uint4*>(v_s + kk * DQ + d8) = vv;
      }
      if (drop)
        for (int c = threadIdx.x; c < kBK; c += kThreads)
          cw_s[c] = fa::dropout_col_word(k0 + c + a.dp.k0, bh, a.dp);
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

      // masked online softmax, one row at a time; lane owns keys lane,
      // lane + 32.  l sums the pre-dropout P; P V takes the dropped P.
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int r = warp * 16 + i;
        const int qp = qp0 + r;
        const bool row_ok = r < nq;
        const int lo = key_lo(qp), hi = key_hi(qp);
        float s2[2];
        bool ok2[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int c = lane + 32 * u;
          const int kp = k0 + c;
          ok2[u] = row_ok && kp >= lo && kp <= hi;
          const float s = fa::score_bias(s_s[r * SP + c], qp + offs, kp,
                                         a.scale, slope, a.mp_);
          s2[u] = ok2[u] ? s : fa::kNegInf;
        }
        const float m_next = fmaxf(m[i], fa::warp_max(fmaxf(s2[0], s2[1])));
        const float alpha = expf(m[i] - m_next);
        float psum = 0.0f;
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int c = lane + 32 * u;
          float p = ok2[u] ? expf(s2[u] - m_next) : 0.0f;
          psum += p;
          if (drop)
            p = fa::dropout_keep(rw_s[r], cw_s[c], a.dp) ? p * a.dp.scale
                                                          : 0.0f;
          p_s[r * PP + c] = fa::from_float<T>(p);
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
    const int qp = qp0 + r;
    const float inv = l[i] == 0.0f ? 0.0f : 1.0f / l[i];
    const long long row = (sq.q_base + qp) * a.Hq + h;
    for (int d = lane; d < D; d += 32)
      og[row * D + d] = fa::from_float<T>(o_s[r * OP + d] * inv);
    if (lane == 0)
      a.lse[sq.lse_index(h, qp)] =
          l[i] == 0.0f ? -INFINITY : m[i] + logf(l[i]);
  }
}

template <typename T, int D, bool kVarlen>
cudaError_t launch(const FwdArgs& a, int B, cudaStream_t stream) {
  const size_t smem = Smem<T, D>::bytes;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        fwd_kernel<T, D, kVarlen>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  // varlen: M is max_seqlen_q; blocks past their sequence leave at once
  dim3 grid((a.seq.M + kBQ - 1) / kBQ, a.Hq, B);
  fwd_kernel<T, D, kVarlen><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, bool kVarlen>
cudaError_t dispatch_d(int D, const FwdArgs& a, int B, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32, kVarlen>(a, B, stream);
    case 64: return launch<T, 64, kVarlen>(a, B, stream);
    case 128: return launch<T, 128, kVarlen>(a, B, stream);
    case 256: return launch<T, 256, kVarlen>(a, B, stream);
    default: return cudaErrorInvalidValue;
  }
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
  a.Hq = Hq; a.Hk = Hk; a.group = Hq / Hk; a.scale = scale;
  set_mask_dropout(&a, FA_MASK_DROPOUT_ARGS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = dtype == 0 ? dispatch_d<__nv_bfloat16, false>(D, a, B, s)
                             : dispatch_d<__half, false>(D, a, B, s);
  return static_cast<int>(e);
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
  a.Hq = Hq; a.Hk = Hk; a.group = Hq / Hk; a.scale = scale;
  set_mask_dropout(&a, FA_MASK_DROPOUT_ARGS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = dtype == 0 ? dispatch_d<__nv_bfloat16, true>(D, a, B, s)
                             : dispatch_d<__half, true>(D, a, B, s);
  return static_cast<int>(e);
}
