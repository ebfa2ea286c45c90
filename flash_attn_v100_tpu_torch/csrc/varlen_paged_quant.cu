// K8q: packed-varlen attention forward with K/V read through a block table
// from an int8, fp8 (e4m3) or int4 HND page pool with per-(token, head)
// fp32 scales, for Hopper (sm_90a).
//
// Replaces the kv_quant branches of
// flash_attn_v100_tpu/ops/pallas/varlen.py::_varlen_fwd_kernel, entered
// through _varlen_fwd_kernel_paged (wrapper flash_attn_varlen_fwd_paged with
// k_scales / v_scales), the engine's large-prefill route over a quantized
// pool.  The contract is K8's (varlen_paged.cu): q (Tq, Hq, D) packed by
// cu_seqlens_q, pools (Hk, P, rows, D) with rows = page_size (int8, e4m3)
// or page_size / 2 (int4, two tokens a byte), scales (Hk, P, page_size, 1);
// out (Tq, Hq, D) in q's dtype and LSE (Hq, Tq) fp32.  The arithmetic is
// the TPU kernel's, in its base-2 softmax domain (natural where softcap is
// on):
//   int8 and int4: the q tile is quantized per row to int8 (amax / 127);
//     S = Q8 K8^T in int32, then float(S) * q_scale * k_scale, times
//     softmax_scale * log2(e); P is multiplied by V's per-token scales and
//     quantized per row over the key tile (amax / 127); P8 V8 in int32,
//     added as float(int) * p_scale after the rescale.
//   fp8: K is converted exactly to q's type and V to bf16; S = Q K^T in
//     fp32, times k_scale; P times V's scales is rounded to bf16 for P V.
// P's grouping: the TPU kernel takes P's int8 scale over its kv step (one
// page at kv_unroll 1); this kernel over each 64-key tile of the
// sequence's cache rows (rows [64 t, 64 t + 64)).  The plain twin
// (ops/cuda/varlen.py::flash_attn_varlen_fwd_paged_ref, p_tile=64) groups
// the same way.
//
// What bounds it on this card: operations.  A 512-token prefill does
// 4 * D operations per (q row, key) pair against K/V bytes read once per q
// tile: the floor is the operations over 1,979 TOPS of the int8 tensor
// cores (int8, int4) or 989 TFLOP/s of bf16 (fp8, whose products stay
// 16-bit).
//
// What the design does about it: K8's layout: one block per (64-row q tile,
// q head, sequence), the ragged bookkeeping in closed form, the loop over
// the 64-key tiles the block's live range touches (never straddling a
// page), four warps of 16 q rows.  int8 / int4: both products on the
// tensor cores through WMMA signed-char 16x16x16 fragments with int32
// accumulators; the int8 tiles live in shared memory blocked by 16 columns
// ([D/16][rows][16] bytes) so that every fragment starts 256-byte aligned;
// int4 is unpacked to int8 in token order as the tile is stored.  fp8: the
// tile is converted into K8's 16-bit layout and K8's WMMA float path runs.
// The per-row softmax state stays in registers; wgmma and TMA are left for
// a later change.
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include "masks.cuh"
#include "quant.cuh"

namespace {

using namespace nvcuda;

constexpr int kBQ = 64;            // q rows per block
constexpr int kBK = 64;            // keys per tile: P's int8 group
constexpr int kWarps = kBQ / 16;   // each warp owns 16 q rows
constexpr int kThreads = kWarps * 32;
constexpr float kLn2 = 0.6931471805599453f;

struct VarlenQuantArgs {
  const void* q;          // (Tq, Hq, D) contiguous
  const uint8_t* k;       // payload pool (Hk, P, rows, D), byte strides
  const uint8_t* v;
  const float* ks;        // scale pools (Hk, P, ps, 1), float strides
  const float* vs;
  const int* table;       // (B, table_stride)
  const int* cu_q;        // (B + 1,)
  const int* seqlens_k;   // (B,)
  const int* seqused_k;   // (B,) or nullptr
  const int* leftpad_k;   // (B,) or nullptr
  const float* slopes;    // (B, Hq) or nullptr
  void* out;              // (Tq, Hq, D)
  float* lse;             // (Hq, Tq)
  long long s_h, s_p, s_tok;     // payload strides (bytes)
  long long sc_h, sc_p, sc_tok;  // scale strides (floats)
  int table_stride;
  int Tq, Hq, group, page_size, mp;
  float scale;       // softmax_scale, times log2(e) in the base-2 domain
  float slope_mult;  // log2(e) in the base-2 domain, else 1
  int exp2_domain;
  fa::MaskParams mp_;
};

// int8 / int4 shared memory: q8, k8, v8 blocked [D/16][64][16] bytes; S in
// int32; P8 blocked [4][64][16]; the fp32 accumulator; per-warp product
// staging; per-row alpha and p_scale; per-key scales
template <int D>
struct IntSmem {
  static constexpr int SP = kBK + 4;  // int32 score row stride
  static constexpr int OP = D + 4;    // fp32 accumulator row stride
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = q_off + kBQ * D;
  static constexpr size_t v_off = k_off + kBK * D;
  static constexpr size_t p_off = v_off + kBK * D;
  static constexpr size_t s_off = p_off + kBQ * kBK;
  static constexpr size_t o_off = s_off + sizeof(int) * kBQ * SP;
  static constexpr size_t w_off = o_off + sizeof(float) * kBQ * OP;
  static constexpr size_t a_off = w_off + sizeof(int) * kWarps * 256;
  static constexpr size_t ps_off = a_off + sizeof(float) * kBQ;
  static constexpr size_t ks_off = ps_off + sizeof(float) * kBQ;
  static constexpr size_t vs_off = ks_off + sizeof(float) * kBK;
  static constexpr size_t bytes = vs_off + sizeof(float) * kBK;
};

// fp8 shared memory: K8's layout (q and K in T, V and P in bf16)
template <typename T, int D>
struct FpSmem {
  static constexpr int DQ = D + 8;     // 16-bit row stride (elements)
  static constexpr int SP = kBK + 4;   // fp32 score row stride
  static constexpr int PP = kBK + 8;   // 16-bit P row stride
  static constexpr int OP = D + 4;     // fp32 accumulator row stride
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = q_off + sizeof(T) * kBQ * DQ;
  static constexpr size_t v_off = k_off + sizeof(T) * kBK * DQ;
  static constexpr size_t s_off = v_off + sizeof(__nv_bfloat16) * kBK * DQ;
  static constexpr size_t p_off = s_off + sizeof(float) * kBQ * SP;
  static constexpr size_t o_off = p_off + sizeof(__nv_bfloat16) * kBQ * PP;
  static constexpr size_t w_off = o_off + sizeof(float) * kBQ * OP;
  static constexpr size_t a_off = w_off + sizeof(float) * kWarps * 256;
  static constexpr size_t ks_off = a_off + sizeof(float) * kBQ;
  static constexpr size_t vs_off = ks_off + sizeof(float) * kBK;
  static constexpr size_t bytes = vs_off + sizeof(float) * kBK;
};

template <typename T, int D, int KIND>
constexpr size_t smem_bytes() {
  return KIND == fa::kFp8 ? FpSmem<T, D>::bytes : IntSmem<D>::bytes;
}

// byte offset of (row, col) in a [cols/16][rows][16] blocked int8 tile
__device__ __forceinline__ int blk(int row, int col, int rows) {
  return (col >> 4) * rows * 16 + row * 16 + (col & 15);
}

template <typename T>
__device__ __forceinline__ T from_e4m3(uint8_t x) {
  return fa::from_float<T>(fa::e4m3_to_float(x));  // exact in bf16 and fp16
}

template <typename T, int D, int KIND>
__global__ void __launch_bounds__(kThreads)
    varlen_paged_quant_kernel(VarlenQuantArgs a) {
  constexpr bool kInt = KIND != fa::kFp8;
  extern __shared__ __align__(256) unsigned char smem[];

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

  // build_ragged_info in closed form for this sequence (as K8)
  int used = a.seqlens_k[b];
  if (a.seqused_k) used = min(used, a.seqused_k[b]);
  const int lp = a.leftpad_k ? a.leftpad_k[b] : 0;
  const int slk = (used > 0 ? min(a.mp * a.page_size, used) : 0) - lp;
  const int offs = slk - slq;
  const int wl = a.mp_.window_left;
  const int wr = a.mp_.effective_window_right();
  auto rel_lo = [&](int qp) { return wl >= 0 ? max(qp + offs - wl, 0) : 0; };
  auto rel_hi = [&](int qp) {
    return wr >= 0 ? min(slk - 1, qp + offs + wr) : slk - 1;
  };
  const int blk_lo = rel_lo(qp0);
  const int blk_hi = rel_hi(qp0 + nq - 1);
  const float slope = a.slopes ? a.slopes[b * a.Hq + h] * a.slope_mult : 0.0f;

  // shared memory views of both layouts (only one is used)
  using LI = IntSmem<D>;
  using LF = FpSmem<T, D>;
  int8_t* q8_s = reinterpret_cast<int8_t*>(smem + LI::q_off);
  int8_t* k8_s = reinterpret_cast<int8_t*>(smem + LI::k_off);
  int8_t* v8_s = reinterpret_cast<int8_t*>(smem + LI::v_off);
  int8_t* p8_s = reinterpret_cast<int8_t*>(smem + LI::p_off);
  int* si_s = reinterpret_cast<int*>(smem + LI::s_off);
  T* qf_s = reinterpret_cast<T*>(smem + LF::q_off);
  T* kf_s = reinterpret_cast<T*>(smem + LF::k_off);
  __nv_bfloat16* vf_s = reinterpret_cast<__nv_bfloat16*>(smem + LF::v_off);
  float* sf_s = reinterpret_cast<float*>(smem + LF::s_off);
  __nv_bfloat16* pf_s = reinterpret_cast<__nv_bfloat16*>(smem + LF::p_off);
  float* o_s = reinterpret_cast<float*>(smem + (kInt ? LI::o_off : LF::o_off));
  void* w_s = smem + (kInt ? LI::w_off : LF::w_off);
  float* a_s = reinterpret_cast<float*>(smem + (kInt ? LI::a_off : LF::a_off));
  float* ps_s = reinterpret_cast<float*>(smem + LI::ps_off);
  float* ks_s = reinterpret_cast<float*>(smem + (kInt ? LI::ks_off : LF::ks_off));
  float* vs_s = reinterpret_cast<float*>(smem + (kInt ? LI::vs_off : LF::vs_off));
  constexpr int SP = kInt ? LI::SP : LF::SP;
  constexpr int OP = kInt ? LI::OP : LF::OP;
  constexpr int DQ = LF::DQ, PP = LF::PP;

  // q tile: per-row int8 (int paths) or as stored (fp8); rows past the
  // sequence are zero (q_scale 1)
  const T* qg = static_cast<const T*>(a.q);
  float q_scale[16];
  if constexpr (kInt) {
    constexpr int NC = D / 32;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int r = warp * 16 + i;
      float x[NC];
      float amax = 0.0f;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        x[c] = 0.0f;
        if (r < nq)
          x[c] = fa::to_float(
              qg[(static_cast<long long>(q_first + qp0 + r) * a.Hq + h) * D +
                 lane + 32 * c]);
        amax = fmaxf(amax, fabsf(x[c]));
      }
      q_scale[i] = fa::p_scale_of(fa::warp_max(amax));
#pragma unroll
      for (int c = 0; c < NC; ++c)
        q8_s[blk(r, lane + 32 * c, kBQ)] =
            static_cast<int8_t>(rintf(x[c] / q_scale[i]));
    }
  } else {
    for (int idx = threadIdx.x; idx < kBQ * (D / 8); idx += kThreads) {
      const int r = idx / (D / 8);
      const int d8 = (idx % (D / 8)) * 8;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (r < nq) {
        const long long off =
            (static_cast<long long>(q_first + qp0 + r) * a.Hq + h) * D + d8;
        val = *reinterpret_cast<const uint4*>(qg + off);
      }
      *reinterpret_cast<uint4*>(qf_s + r * DQ + d8) = val;
    }
  }
  for (int e = lane; e < 16 * OP; e += 32) o_s[warp * 16 * OP + e] = 0.0f;
  float m[16], l[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    m[i] = fa::kNegInf;
    l[i] = 0.0f;
  }

  const uint8_t* kg = a.k + kvh * a.s_h;
  const uint8_t* vg = a.v + kvh * a.s_h;
  const int* tbl = a.table + static_cast<long long>(b) * a.table_stride;

  if (blk_hi >= blk_lo) {
    const int raw_lo = lp + blk_lo, raw_hi = lp + blk_hi;  // inclusive
    for (int k0 = (raw_lo / kBK) * kBK; k0 <= raw_hi; k0 += kBK) {
      __syncthreads();  // previous tile consumed; q / o initialised
      const int slot = k0 / a.page_size;
      const int page = tbl[slot];
      const int in_page = k0 - slot * a.page_size;
      if constexpr (KIND == fa::kInt4) {
        // kBK / 2 byte rows of token pairs
        const long long base = static_cast<long long>(page) * a.s_p +
                               static_cast<long long>(in_page / 2) * a.s_tok;
        for (int idx = threadIdx.x; idx < (kBK / 2) * (D / 16); idx += kThreads) {
          const int br = idx / (D / 16);
          const int d16 = (idx % (D / 16)) * 16;
          const int raw = k0 + 2 * br;
          uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
          if (raw + 1 >= raw_lo && raw <= raw_hi) {
            const long long o = base + static_cast<long long>(br) * a.s_tok + d16;
            kv = *reinterpret_cast<const uint4*>(kg + o);
            vv = *reinterpret_cast<const uint4*>(vg + o);
          }
          uint4 ke, ko, ve, vo;
          fa::unpack_int4x16(kv, ke, ko);
          fa::unpack_int4x16(vv, ve, vo);
          *reinterpret_cast<uint4*>(k8_s + blk(2 * br, d16, kBK)) = ke;
          *reinterpret_cast<uint4*>(k8_s + blk(2 * br + 1, d16, kBK)) = ko;
          *reinterpret_cast<uint4*>(v8_s + blk(2 * br, d16, kBK)) = ve;
          *reinterpret_cast<uint4*>(v8_s + blk(2 * br + 1, d16, kBK)) = vo;
        }
      } else {
        const long long base = static_cast<long long>(page) * a.s_p +
                               static_cast<long long>(in_page) * a.s_tok;
        for (int idx = threadIdx.x; idx < kBK * (D / 16); idx += kThreads) {
          const int kk = idx / (D / 16);
          const int d16 = (idx % (D / 16)) * 16;
          const int raw = k0 + kk;
          uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
          if (raw >= raw_lo && raw <= raw_hi) {
            const long long o = base + static_cast<long long>(kk) * a.s_tok + d16;
            kv = *reinterpret_cast<const uint4*>(kg + o);
            vv = *reinterpret_cast<const uint4*>(vg + o);
          }
          if constexpr (KIND == fa::kInt8) {
            *reinterpret_cast<uint4*>(k8_s + blk(kk, d16, kBK)) = kv;
            *reinterpret_cast<uint4*>(v8_s + blk(kk, d16, kBK)) = vv;
          } else {
            const uint8_t* kb = reinterpret_cast<const uint8_t*>(&kv);
            const uint8_t* vb = reinterpret_cast<const uint8_t*>(&vv);
#pragma unroll
            for (int e = 0; e < 16; ++e) {
              kf_s[kk * DQ + d16 + e] = from_e4m3<T>(kb[e]);
              vf_s[kk * DQ + d16 + e] = from_e4m3<__nv_bfloat16>(vb[e]);
            }
          }
        }
      }
      if (threadIdx.x < 2 * kBK) {
        const int kk = threadIdx.x % kBK;
        const int raw = k0 + kk;
        float sc = 0.0f;
        if (raw >= raw_lo && raw <= raw_hi) {
          const float* src = threadIdx.x < kBK ? a.ks : a.vs;
          sc = src[kvh * a.sc_h + static_cast<long long>(page) * a.sc_p +
                   static_cast<long long>(in_page + kk) * a.sc_tok];
        }
        (threadIdx.x < kBK ? ks_s : vs_s)[kk] = sc;
      }
      __syncthreads();

      // S = Q K^T for this warp's 16 rows
#pragma unroll
      for (int cb = 0; cb < kBK / 16; ++cb) {
        if constexpr (kInt) {
          wmma::fragment<wmma::accumulator, 16, 16, 16, int> c;
          wmma::fill_fragment(c, 0);
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char,
                           wmma::row_major> fa_;
            wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char,
                           wmma::col_major> fb;
            wmma::load_matrix_sync(fa_, q8_s + blk(warp * 16, kk * 16, kBQ), 16);
            wmma::load_matrix_sync(fb, k8_s + blk(cb * 16, kk * 16, kBK), 16);
            wmma::mma_sync(c, fa_, fb, c);
          }
          wmma::store_matrix_sync(si_s + warp * 16 * SP + cb * 16, c, SP,
                                  wmma::mem_row_major);
        } else {
          wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
          wmma::fill_fragment(c, 0.0f);
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> fa_;
            wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major> fb;
            wmma::load_matrix_sync(fa_, qf_s + warp * 16 * DQ + kk * 16, DQ);
            wmma::load_matrix_sync(fb, kf_s + cb * 16 * DQ + kk * 16, DQ);
            wmma::mma_sync(c, fa_, fb, c);
          }
          wmma::store_matrix_sync(sf_s + warp * 16 * SP + cb * 16, c, SP,
                                  wmma::mem_row_major);
        }
      }
      __syncwarp();

      // masked online softmax, one row at a time; lane owns keys lane,
      // lane + 32; then P (times V's scales) quantized per row over the tile
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
          float s;
          if constexpr (kInt)
            s = static_cast<float>(si_s[r * SP + c]) * q_scale[i] * ks_s[c];
          else
            s = sf_s[r * SP + c] * ks_s[c];
          s = fa::score_bias(s, qp + offs, rel, a.scale, slope, a.mp_);
          s2[u] = ok2[u] ? s : fa::kNegInf;
        }
        const float m_next = fmaxf(m[i], fa::warp_max(fmaxf(s2[0], s2[1])));
        const float alpha = a.exp2_domain ? exp2f(m[i] - m_next)
                                          : expf(m[i] - m_next);
        float psum = 0.0f, pv[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const float d = s2[u] - m_next;
          const float p = ok2[u] ? (a.exp2_domain ? exp2f(d) : expf(d)) : 0.0f;
          psum += p;
          pv[u] = p * vs_s[lane + 32 * u];  // V's dequant scale folded in
        }
        l[i] = alpha * l[i] + fa::warp_sum(psum);
        m[i] = m_next;
        if constexpr (kInt) {
          const float p_scale =
              fa::p_scale_of(fa::warp_max(fmaxf(pv[0], pv[1])));
#pragma unroll
          for (int u = 0; u < 2; ++u)
            p8_s[blk(r, lane + 32 * u, kBQ)] =
                static_cast<int8_t>(rintf(pv[u] / p_scale));
          if (lane == 0) ps_s[r] = p_scale;
        } else {
#pragma unroll
          for (int u = 0; u < 2; ++u)
            pf_s[r * PP + lane + 32 * u] = __float2bfloat16(pv[u]);
        }
        if (lane == 0) a_s[r] = alpha;
      }
      __syncwarp();

      // O = alpha * O + P V for this warp's 16 rows
#pragma unroll
      for (int cb = 0; cb < D / 16; ++cb) {
        if constexpr (kInt) {
          wmma::fragment<wmma::accumulator, 16, 16, 16, int> c;
          wmma::fill_fragment(c, 0);
#pragma unroll
          for (int kk = 0; kk < kBK / 16; ++kk) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char,
                           wmma::row_major> fa_;
            wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char,
                           wmma::row_major> fb;
            wmma::load_matrix_sync(fa_, p8_s + blk(warp * 16, kk * 16, kBQ), 16);
            wmma::load_matrix_sync(fb, v8_s + blk(kk * 16, cb * 16, kBK), 16);
            wmma::mma_sync(c, fa_, fb, c);
          }
          int* w = static_cast<int*>(w_s) + warp * 256;
          wmma::store_matrix_sync(w, c, 16, wmma::mem_row_major);
          __syncwarp();
          for (int e = lane; e < 256; e += 32) {
            const int r = warp * 16 + e / 16;
            float* o = o_s + r * OP + cb * 16 + (e % 16);
            *o = *o * a_s[r] + static_cast<float>(w[e]) * ps_s[r];
          }
        } else {
          wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
          wmma::fill_fragment(c, 0.0f);
#pragma unroll
          for (int kk = 0; kk < kBK / 16; ++kk) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                           wmma::row_major> fa_;
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                           wmma::row_major> fb;
            wmma::load_matrix_sync(fa_, pf_s + warp * 16 * PP + kk * 16, PP);
            wmma::load_matrix_sync(fb, vf_s + kk * 16 * DQ + cb * 16, DQ);
            wmma::mma_sync(c, fa_, fb, c);
          }
          float* w = static_cast<float*>(w_s) + warp * 256;
          wmma::store_matrix_sync(w, c, 16, wmma::mem_row_major);
          __syncwarp();
          for (int e = lane; e < 256; e += 32) {
            const int r = warp * 16 + e / 16;
            float* o = o_s + r * OP + cb * 16 + (e % 16);
            *o = *o * a_s[r] + w[e];
          }
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
          l[i] == 0.0f ? -INFINITY
                       : (a.exp2_domain ? m[i] * kLn2 : m[i]) + logf(l[i]);
  }
}

template <typename T, int D, int KIND>
cudaError_t launch(const VarlenQuantArgs& a, int n_q_tiles, int B,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes<T, D, KIND>();
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        varlen_paged_quant_kernel<T, D, KIND>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  dim3 grid(n_q_tiles, a.Hq, B);
  varlen_paged_quant_kernel<T, D, KIND><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int KIND>
cudaError_t dispatch_d(int D, const VarlenQuantArgs& a, int n_q_tiles, int B,
                       cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32, KIND>(a, n_q_tiles, B, stream);
    case 64: return launch<T, 64, KIND>(a, n_q_tiles, B, stream);
    case 128: return launch<T, 128, KIND>(a, n_q_tiles, B, stream);
    case 256: return launch<T, 256, KIND>(a, n_q_tiles, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_kind(int kind, int D, const VarlenQuantArgs& a,
                          int n_q_tiles, int B, cudaStream_t stream) {
  switch (kind) {
    case fa::kInt8: return dispatch_d<T, fa::kInt8>(D, a, n_q_tiles, B, stream);
    case fa::kFp8: return dispatch_d<T, fa::kFp8>(D, a, n_q_tiles, B, stream);
    case fa::kInt4: return dispatch_d<T, fa::kInt4>(D, a, n_q_tiles, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// kind: 0 = int8, 1 = fp8 (e4m3), 2 = int4; dtype (of q): 0 = bf16,
// 1 = fp16.  Returns cudaGetLastError() of the launch.
extern "C" int fa_varlen_paged_quant_launch(
    int kind, int dtype, const void* q, const void* k, const void* v,
    const float* ks, const float* vs, const int* table, int table_stride,
    const int* cu_q, const int* seqlens_k, const int* seqused_k,
    const int* leftpad_k, const float* slopes, void* out, float* lse,
    long long s_h, long long s_p, long long s_tok, long long sc_h,
    long long sc_p, long long sc_tok, int B, int Tq, int Hq, int Hk, int D,
    int page_size, int mp, int max_seqlen_q, float scale, float slope_mult,
    int exp2_domain, int causal, int window_left, int window_right,
    float softcap, int has_alibi, void* stream) {
  if (page_size % kBK != 0 || Hq % Hk != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  VarlenQuantArgs a;
  a.q = q; a.k = static_cast<const uint8_t*>(k);
  a.v = static_cast<const uint8_t*>(v); a.ks = ks; a.vs = vs;
  a.table = table; a.cu_q = cu_q;
  a.seqlens_k = seqlens_k; a.seqused_k = seqused_k; a.leftpad_k = leftpad_k;
  a.slopes = has_alibi ? slopes : nullptr; a.out = out; a.lse = lse;
  a.s_h = s_h; a.s_p = s_p; a.s_tok = s_tok;
  a.sc_h = sc_h; a.sc_p = sc_p; a.sc_tok = sc_tok;
  a.table_stride = table_stride;
  a.Tq = Tq; a.Hq = Hq; a.group = Hq / Hk; a.page_size = page_size;
  a.mp = mp; a.scale = scale; a.slope_mult = slope_mult;
  a.exp2_domain = exp2_domain;
  a.mp_.causal = causal; a.mp_.window_left = window_left;
  a.mp_.window_right = window_right; a.mp_.softcap = softcap;
  a.mp_.has_alibi = has_alibi;
  const int n_q_tiles = (max_seqlen_q + kBQ - 1) / kBQ;
  if (n_q_tiles == 0 || B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e =
      dtype == 0 ? dispatch_kind<__nv_bfloat16>(kind, D, a, n_q_tiles, B, s)
                 : dispatch_kind<__half>(kind, D, a, n_q_tiles, B, s);
  return static_cast<int>(e);
}
