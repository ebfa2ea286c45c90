// K6 (dQ) and K7 (dK, dV): packed varlen attention backward for Hopper
// (sm_90a).
//
// Replace flash_attn_v100_tpu/ops/pallas/varlen.py::_varlen_dq_kernel and
// ::_varlen_dkv_kernel, the TPU kernels behind flash_attn_varlen_bwd and the
// backward of flash_attn_varlen_func.  Same contract: q/dout (Tq, Hq, D)
// packed by cu_q, k/v (Tk, Hk, D) by cu_k, optional seqused_k / leftpad_k,
// contiguous; GQA kv_head = h / group; the forward's masks aligned per
// sequence, bias and dropout keying (csrc/fwd.cu, K5); lse (Hq, Tq) clamped
// to >= NEG_INF and delta = rowsum(O * dO) - dlse (Hq, Tq), both fp32 and
// computed by the caller.  Rows and keys no block covers (past cu_q[B] /
// cu_k[B], before leftpad_k, past seqused_k) are left to the caller, which
// zeroes them.  Per score:
//     P      = exp(min(S - lse, 0)) where the position is valid, else 0
//     P_drop = keep ? P / (1 - p) : 0
//     dS     = (P_drop * dO.V^T - P * delta) * scale  [* (1 - (S/cap)^2)]
// dQ = dS K (dS rounded to the input type), dK = dS^T Q, dV = P_drop^T dO
// (P_drop rounded to the input type), all accumulated in fp32.
//
// These are K2's and K3's bodies (csrc/bwd.cu) with each block's sequence
// read from cu_seqlens (csrc/seq.cuh).  They are a copy rather than one
// template shared with K2/K3: the shared template compiled the dense
// kernels differently, K3 7% slower and K2 8% faster on the H100, outputs
// unchanged, so the dense kernels keep their own source.
//
// What bounds them on this card: operations.  dQ does 6 * D flops per live
// (q row, key) pair (S, dO V^T, dS K) and dK/dV 8 * D (S^T, V dO^T,
// P^T dO, dS^T Q), against Q/K/V/dO bytes read once per tile: far above
// the ~295 flop/byte ridge.
//
// What the design does about it: the dQ kernel is q-centric, one block per
// (64-row q tile, q head, sequence), looping over the key tiles its rows'
// intervals touch; the dK/dV kernel is key-centric, one block per (key
// tile, kv head, sequence), looping over the `group` q heads of its kv head
// and, for each, over the live 64-row q tiles of its own sequence.  A block
// whose tile lies past its sequence leaves at once.  Each warp owns 16 rows
// of its block (q rows in dQ, key rows in dK/dV), so a tile needs one block
// barrier, for its shared operand loads.  Products run on WMMA 16x16x16
// with fp32 accumulators kept in shared memory.  Every output element is
// summed by one block in a fixed order with no atomics, so the backward is
// bitwise deterministic.  Key tiles are 64 wide up to D = 128 and 32 wide
// at D = 256 (shared memory).
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>

#include <type_traits>

#include "masks.cuh"
#include "philox.cuh"
#include "seq.cuh"

namespace {

using namespace nvcuda;

constexpr int kBQ = 64;  // q rows per tile (K6: per block; K7: per step)

struct BwdArgs {
  const void* q;          // (Tq, Hq, D)
  const void* k;          // (Tk, Hk, D)
  const void* v;
  const void* dout;       // (Tq, Hq, D)
  const float* lse;       // (Hq, Tq), >= NEG_INF
  const float* delta;     // (Hq, Tq)
  const float* slopes;    // (B, Hq) or nullptr
  void* dq;               // q's shape
  void* dk;               // k's shape
  void* dv;
  fa::SeqArgs seq;
  int Hq, Hk, group;
  float scale;
  fa::MaskParams mp_;
  fa::DropoutParams dp;
};

template <int D>
struct KeyTile {
  static constexpr int BK = D <= 128 ? 64 : 32;
};

// live keys of q row qp: [key_lo, key_hi]
struct Live {
  int N, offs, wl, wr;
  __device__ int key_lo(int qp) const {
    return wl >= 0 ? max(qp + offs - wl, 0) : 0;
  }
  __device__ int key_hi(int qp) const {
    return wr >= 0 ? min(N - 1, qp + offs + wr) : N - 1;
  }
  __device__ bool valid(int qp, int kp) const {
    return kp >= key_lo(qp) && kp <= key_hi(qp);
  }
};

__device__ __forceinline__ Live make_live(const BwdArgs& a, const fa::Seq& sq) {
  Live lv;
  lv.N = sq.slk;
  lv.offs = sq.offs;
  lv.wl = a.mp_.window_left;
  lv.wr = a.mp_.effective_window_right();
  return lv;
}

// dS of one score; p_drop returned through *pd
__device__ __forceinline__ float grad_score(float s_raw, float dp, int qp,
                                            int kp, bool valid, float lse,
                                            float delta, bool keep,
                                            float slope, const BwdArgs& a,
                                            const Live& lv, float* pd) {
  const float s = fa::score_bias(s_raw, qp + lv.offs, kp, a.scale, slope,
                                 a.mp_);
  const float p = valid ? expf(fminf(s - lse, 0.0f)) : 0.0f;
  const float p_drop = a.dp.enabled ? (keep ? p * a.dp.scale : 0.0f) : p;
  float ds = (p_drop * dp - p * delta) * a.scale;
  if (a.mp_.softcap > 0.0f) {
    const float sn = s * (1.0f / a.mp_.softcap);
    ds *= 1.0f - sn * sn;
  }
  *pd = p_drop;
  return ds;
}

// C[16 x 16*NB] (fp32, smem, row stride ldc) (+)= A[16 x 16*KB] B, A row
// major; B row or column major (B(k, n) at b[k * ldb + n] or b[k + n * ldb])
template <typename T, typename LayoutB, int NB, int KB, bool ACC>
__device__ __forceinline__ void warp_mma(const T* a, int lda, const T* b,
                                         int ldb, float* c, int ldc) {
  constexpr bool kColB = std::is_same<LayoutB, wmma::col_major>::value;
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    if (ACC)
      wmma::load_matrix_sync(acc, c + nb * 16, ldc, wmma::mem_row_major);
    else
      wmma::fill_fragment(acc, 0.0f);
#pragma unroll
    for (int kb = 0; kb < KB; ++kb) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> fa_;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, LayoutB> fb;
      wmma::load_matrix_sync(fa_, a + kb * 16, lda);
      wmma::load_matrix_sync(
          fb, kColB ? b + nb * 16 * ldb + kb * 16 : b + kb * 16 * ldb + nb * 16,
          ldb);
      wmma::mma_sync(acc, fa_, fb, acc);
    }
    wmma::store_matrix_sync(c + nb * 16, acc, ldc, wmma::mem_row_major);
  }
}

// one 16-bit row tile of `rows` rows from a (rows, H, D) tensor at
// positions row0.. of a sequence starting at packed row `base`, head h;
// positions at or past the sequence length L are zero
template <typename T, int D, int kThreads>
__device__ __forceinline__ void load_rows(T* dst, int ld, const void* src,
                                          long long base, int row0, int rows,
                                          int L, int H, int h) {
  const T* g = static_cast<const T*>(src);
  for (int idx = threadIdx.x; idx < rows * (D / 8); idx += kThreads) {
    const int r = idx / (D / 8);
    const int d8 = (idx % (D / 8)) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < L) {
      const long long off = ((base + row0 + r) * H + h) * D + d8;
      val = *reinterpret_cast<const uint4*>(g + off);
    }
    *reinterpret_cast<uint4*>(dst + r * ld + d8) = val;
  }
}

// ------------------------------------------------------------------ K6: dQ

template <typename T, int D>
struct DqSmem {
  static constexpr int BK = KeyTile<D>::BK;
  static constexpr int DQ = D + 8;
  static constexpr int SP = BK + 4;
  static constexpr int PP = BK + 8;
  static constexpr int OP = D + 4;
  static constexpr size_t q_off = 0;
  static constexpr size_t do_off = q_off + sizeof(T) * kBQ * DQ;
  static constexpr size_t k_off = do_off + sizeof(T) * kBQ * DQ;
  static constexpr size_t v_off = k_off + sizeof(T) * BK * DQ;
  static constexpr size_t s_off = v_off + sizeof(T) * BK * DQ;
  static constexpr size_t dp_off = s_off + sizeof(float) * kBQ * SP;
  static constexpr size_t ds_off = dp_off + sizeof(float) * kBQ * SP;
  static constexpr size_t acc_off = ds_off + sizeof(T) * kBQ * PP;
  static constexpr size_t lse_off = acc_off + sizeof(float) * kBQ * OP;
  static constexpr size_t delta_off = lse_off + sizeof(float) * kBQ;
  static constexpr size_t rw_off = delta_off + sizeof(float) * kBQ;
  static constexpr size_t cw_off = rw_off + sizeof(uint32_t) * kBQ;
  static constexpr size_t bytes = cw_off + sizeof(uint32_t) * BK;
};

constexpr int kDqThreads = (kBQ / 16) * 32;

template <typename T, int D>
__global__ void __launch_bounds__(kDqThreads) dq_kernel(BwdArgs a) {
  using L = DqSmem<T, D>;
  constexpr int BK = L::BK, DQ = L::DQ, SP = L::SP, PP = L::PP, OP = L::OP;
  extern __shared__ __align__(128) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem + L::q_off);
  T* do_s = reinterpret_cast<T*>(smem + L::do_off);
  T* k_s = reinterpret_cast<T*>(smem + L::k_off);
  T* v_s = reinterpret_cast<T*>(smem + L::v_off);
  float* s_s = reinterpret_cast<float*>(smem + L::s_off);
  float* dp_s = reinterpret_cast<float*>(smem + L::dp_off);
  T* ds_s = reinterpret_cast<T*>(smem + L::ds_off);
  float* acc_s = reinterpret_cast<float*>(smem + L::acc_off);
  float* lse_s = reinterpret_cast<float*>(smem + L::lse_off);
  float* delta_s = reinterpret_cast<float*>(smem + L::delta_off);
  uint32_t* rw_s = reinterpret_cast<uint32_t*>(smem + L::rw_off);
  uint32_t* cw_s = reinterpret_cast<uint32_t*>(smem + L::cw_off);

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const fa::Seq sq = fa::seq_info<true>(a.seq, b, a.Hq);
  const int qp0 = blockIdx.x * kBQ;
  if (qp0 >= sq.slq) return;  // uniform over the block
  const int nq = min(kBQ, sq.slq - qp0);
  const int kvh = h / a.group;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const Live lv = make_live(a, sq);
  const int blk_lo = lv.key_lo(qp0);
  const int blk_hi = lv.key_hi(qp0 + nq - 1);
  const float slope = a.slopes ? a.slopes[b * a.Hq + h] : 0.0f;
  const bool drop = a.dp.enabled != 0;
  const uint32_t bh = fa::dropout_bh(b, h, a.dp);

  load_rows<T, D, kDqThreads>(q_s, DQ, a.q, sq.q_base, qp0, kBQ, sq.slq,
                              a.Hq, h);
  load_rows<T, D, kDqThreads>(do_s, DQ, a.dout, sq.q_base, qp0, kBQ, sq.slq,
                              a.Hq, h);
  for (int r = threadIdx.x; r < kBQ; r += kDqThreads) {
    const long long row = sq.lse_index(h, qp0 + r);
    lse_s[r] = r < nq ? a.lse[row] : 0.0f;
    delta_s[r] = r < nq ? a.delta[row] : 0.0f;
    if (drop) rw_s[r] = fa::dropout_row_word(qp0 + r + a.dp.q0, bh, a.dp);
  }
  for (int e = lane; e < 16 * OP; e += 32) acc_s[warp * 16 * OP + e] = 0.0f;

  if (blk_hi >= blk_lo) {
    for (int k0 = (blk_lo / BK) * BK; k0 <= blk_hi; k0 += BK) {
      __syncthreads();  // previous tile consumed; q/do/lse/delta ready
      load_rows<T, D, kDqThreads>(k_s, DQ, a.k, sq.k_base, k0, BK, sq.slk,
                                  a.Hk, kvh);
      load_rows<T, D, kDqThreads>(v_s, DQ, a.v, sq.k_base, k0, BK, sq.slk,
                                  a.Hk, kvh);
      if (drop)
        for (int c = threadIdx.x; c < BK; c += kDqThreads)
          cw_s[c] = fa::dropout_col_word(k0 + c + a.dp.k0, bh, a.dp);
      __syncthreads();

      // S = Q K^T and dP = dO V^T for this warp's 16 rows
      warp_mma<T, wmma::col_major, BK / 16, D / 16, false>(
          q_s + warp * 16 * DQ, DQ, k_s, DQ, s_s + warp * 16 * SP, SP);
      warp_mma<T, wmma::col_major, BK / 16, D / 16, false>(
          do_s + warp * 16 * DQ, DQ, v_s, DQ, dp_s + warp * 16 * SP, SP);
      __syncwarp();

      for (int i = 0; i < 16; ++i) {
        const int r = warp * 16 + i;
        const int qp = qp0 + r;
        for (int c = lane; c < BK; c += 32) {
          const int kp = k0 + c;
          const bool valid = r < nq && lv.valid(qp, kp);
          const bool keep = drop && fa::dropout_keep(rw_s[r], cw_s[c], a.dp);
          float pd;
          const float ds = grad_score(s_s[r * SP + c], dp_s[r * SP + c], qp,
                                      kp, valid, lse_s[r], delta_s[r], keep,
                                      slope, a, lv, &pd);
          ds_s[r * PP + c] = fa::from_float<T>(ds);
        }
      }
      __syncwarp();

      // dQ += dS K
      warp_mma<T, wmma::row_major, D / 16, BK / 16, true>(
          ds_s + warp * 16 * PP, PP, k_s, DQ, acc_s + warp * 16 * OP, OP);
    }
  }
  __syncwarp();

  T* dqg = static_cast<T*>(a.dq);
  for (int i = 0; i < 16; ++i) {
    const int r = warp * 16 + i;
    if (r >= nq) continue;
    const long long row = (sq.q_base + qp0 + r) * a.Hq + h;
    for (int d = lane; d < D; d += 32)
      dqg[row * D + d] = fa::from_float<T>(acc_s[r * OP + d]);
  }
}

// ------------------------------------------------------------ K7: dK, dV

template <typename T, int D>
struct DkvSmem {
  static constexpr int BK = KeyTile<D>::BK;
  static constexpr int DQ = D + 8;
  static constexpr int SP = kBQ + 4;
  static constexpr int PP = kBQ + 8;
  static constexpr int OP = D + 4;
  static constexpr size_t k_off = 0;
  static constexpr size_t v_off = k_off + sizeof(T) * BK * DQ;
  static constexpr size_t q_off = v_off + sizeof(T) * BK * DQ;
  static constexpr size_t do_off = q_off + sizeof(T) * kBQ * DQ;
  static constexpr size_t st_off = do_off + sizeof(T) * kBQ * DQ;
  static constexpr size_t dpt_off = st_off + sizeof(float) * BK * SP;
  static constexpr size_t pt_off = dpt_off + sizeof(float) * BK * SP;
  static constexpr size_t dst_off = pt_off + sizeof(T) * BK * PP;
  static constexpr size_t dk_off = dst_off + sizeof(T) * BK * PP;
  static constexpr size_t dv_off = dk_off + sizeof(float) * BK * OP;
  static constexpr size_t lse_off = dv_off + sizeof(float) * BK * OP;
  static constexpr size_t delta_off = lse_off + sizeof(float) * kBQ;
  static constexpr size_t rw_off = delta_off + sizeof(float) * kBQ;
  static constexpr size_t cw_off = rw_off + sizeof(uint32_t) * kBQ;
  static constexpr size_t bytes = cw_off + sizeof(uint32_t) * BK;
};

template <int D>
struct DkvThreads {
  static constexpr int value = (KeyTile<D>::BK / 16) * 32;
};

template <typename T, int D>
__global__ void __launch_bounds__(DkvThreads<D>::value) dkv_kernel(BwdArgs a) {
  using L = DkvSmem<T, D>;
  constexpr int BK = L::BK, DQ = L::DQ, SP = L::SP, PP = L::PP, OP = L::OP;
  constexpr int kThreads = DkvThreads<D>::value;
  extern __shared__ __align__(128) unsigned char smem[];
  T* k_s = reinterpret_cast<T*>(smem + L::k_off);
  T* v_s = reinterpret_cast<T*>(smem + L::v_off);
  T* q_s = reinterpret_cast<T*>(smem + L::q_off);
  T* do_s = reinterpret_cast<T*>(smem + L::do_off);
  float* st_s = reinterpret_cast<float*>(smem + L::st_off);
  float* dpt_s = reinterpret_cast<float*>(smem + L::dpt_off);
  T* pt_s = reinterpret_cast<T*>(smem + L::pt_off);
  T* dst_s = reinterpret_cast<T*>(smem + L::dst_off);
  float* dk_s = reinterpret_cast<float*>(smem + L::dk_off);
  float* dv_s = reinterpret_cast<float*>(smem + L::dv_off);
  float* lse_s = reinterpret_cast<float*>(smem + L::lse_off);
  float* delta_s = reinterpret_cast<float*>(smem + L::delta_off);
  uint32_t* rw_s = reinterpret_cast<uint32_t*>(smem + L::rw_off);
  uint32_t* cw_s = reinterpret_cast<uint32_t*>(smem + L::cw_off);

  const int b = blockIdx.z;
  const int kvh = blockIdx.y;
  const fa::Seq sq = fa::seq_info<true>(a.seq, b, a.Hq);
  const int k0 = blockIdx.x * BK;
  if (k0 >= sq.slk) return;  // uniform over the block
  const int nk = min(BK, sq.slk - k0);
  const int M = sq.slq;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const Live lv = make_live(a, sq);
  const bool drop = a.dp.enabled != 0;
  // q rows that see any key of this tile: [q_lo, q_hi]
  const int k_last = k0 + nk - 1;
  const int q_lo = lv.wr >= 0 ? max(0, k0 - lv.offs - lv.wr) : 0;
  const int q_hi = lv.wl >= 0 ? min(M - 1, k_last - lv.offs + lv.wl) : M - 1;

  load_rows<T, D, kThreads>(k_s, DQ, a.k, sq.k_base, k0, BK, sq.slk, a.Hk,
                            kvh);
  load_rows<T, D, kThreads>(v_s, DQ, a.v, sq.k_base, k0, BK, sq.slk, a.Hk,
                            kvh);
  for (int e = lane; e < 16 * OP; e += 32) {
    dk_s[warp * 16 * OP + e] = 0.0f;
    dv_s[warp * 16 * OP + e] = 0.0f;
  }

  for (int g = 0; g < a.group && q_hi >= q_lo; ++g) {
    const int h = kvh * a.group + g;
    const float slope = a.slopes ? a.slopes[b * a.Hq + h] : 0.0f;
    const uint32_t bh = fa::dropout_bh(b, h, a.dp);
    for (int t0 = (q_lo / kBQ) * kBQ; t0 <= q_hi; t0 += kBQ) {
      __syncthreads();  // previous tile consumed; k/v ready
      load_rows<T, D, kThreads>(q_s, DQ, a.q, sq.q_base, t0, kBQ, M, a.Hq,
                                h);
      load_rows<T, D, kThreads>(do_s, DQ, a.dout, sq.q_base, t0, kBQ, M,
                                a.Hq, h);
      for (int c = threadIdx.x; c < kBQ; c += kThreads) {
        const long long row = sq.lse_index(h, t0 + c);
        const bool in = t0 + c < M;
        lse_s[c] = in ? a.lse[row] : 0.0f;
        delta_s[c] = in ? a.delta[row] : 0.0f;
        if (drop) rw_s[c] = fa::dropout_row_word(t0 + c + a.dp.q0, bh, a.dp);
      }
      if (drop)
        for (int kk = threadIdx.x; kk < BK; kk += kThreads)
          cw_s[kk] = fa::dropout_col_word(k0 + kk + a.dp.k0, bh, a.dp);
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T for this warp's 16 key rows
      warp_mma<T, wmma::col_major, kBQ / 16, D / 16, false>(
          k_s + warp * 16 * DQ, DQ, q_s, DQ, st_s + warp * 16 * SP, SP);
      warp_mma<T, wmma::col_major, kBQ / 16, D / 16, false>(
          v_s + warp * 16 * DQ, DQ, do_s, DQ, dpt_s + warp * 16 * SP, SP);
      __syncwarp();

      for (int i = 0; i < 16; ++i) {
        const int kr = warp * 16 + i;
        const int kp = k0 + kr;
        for (int c = lane; c < kBQ; c += 32) {
          const int qp = t0 + c;
          const bool valid = kr < nk && qp < M && lv.valid(qp, kp);
          const bool keep = drop && fa::dropout_keep(rw_s[c], cw_s[kr], a.dp);
          float pd;
          const float ds = grad_score(st_s[kr * SP + c], dpt_s[kr * SP + c],
                                      qp, kp, valid, lse_s[c], delta_s[c],
                                      keep, slope, a, lv, &pd);
          pt_s[kr * PP + c] = fa::from_float<T>(pd);
          dst_s[kr * PP + c] = fa::from_float<T>(ds);
        }
      }
      __syncwarp();

      // dV += P_drop^T dO, dK += dS^T Q
      warp_mma<T, wmma::row_major, D / 16, kBQ / 16, true>(
          pt_s + warp * 16 * PP, PP, do_s, DQ, dv_s + warp * 16 * OP, OP);
      warp_mma<T, wmma::row_major, D / 16, kBQ / 16, true>(
          dst_s + warp * 16 * PP, PP, q_s, DQ, dk_s + warp * 16 * OP, OP);
    }
  }
  __syncwarp();

  T* dkg = static_cast<T*>(a.dk);
  T* dvg = static_cast<T*>(a.dv);
  for (int i = 0; i < 16; ++i) {
    const int kr = warp * 16 + i;
    if (kr >= nk) continue;
    const long long row = (sq.k_base + k0 + kr) * a.Hk + kvh;
    for (int d = lane; d < D; d += 32) {
      dkg[row * D + d] = fa::from_float<T>(dk_s[kr * OP + d]);
      dvg[row * D + d] = fa::from_float<T>(dv_s[kr * OP + d]);
    }
  }
}

// ---------------------------------------------------------------- launch

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes, bool* configured) {
  if (*configured) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e == cudaSuccess) *configured = true;
  return e;
}

// seq.M / seq.N are max_seqlen_q / max_seqlen_k; blocks past their
// sequence leave at once
template <typename T, int D>
cudaError_t launch_dq(const BwdArgs& a, int B, cudaStream_t stream) {
  static bool configured = false;
  const size_t smem = DqSmem<T, D>::bytes;
  cudaError_t e = set_smem(dq_kernel<T, D>, smem, &configured);
  if (e != cudaSuccess) return e;
  dim3 grid((a.seq.M + kBQ - 1) / kBQ, a.Hq, B);
  dq_kernel<T, D><<<grid, kDqThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const BwdArgs& a, int B, cudaStream_t stream) {
  static bool configured = false;
  const size_t smem = DkvSmem<T, D>::bytes;
  cudaError_t e = set_smem(dkv_kernel<T, D>, smem, &configured);
  if (e != cudaSuccess) return e;
  constexpr int BK = KeyTile<D>::BK;
  dim3 grid((a.seq.N + BK - 1) / BK, a.Hk, B);
  dkv_kernel<T, D><<<grid, DkvThreads<D>::value, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(bool dkv, int D, const BwdArgs& a, int B,
                     cudaStream_t s) {
  switch (D) {
    case 32: return dkv ? launch_dkv<T, 32>(a, B, s) : launch_dq<T, 32>(a, B, s);
    case 64: return dkv ? launch_dkv<T, 64>(a, B, s) : launch_dq<T, 64>(a, B, s);
    case 128:
      return dkv ? launch_dkv<T, 128>(a, B, s) : launch_dq<T, 128>(a, B, s);
    case 256:
      return dkv ? launch_dkv<T, 256>(a, B, s) : launch_dq<T, 256>(a, B, s);
    default: return cudaErrorInvalidValue;
  }
}

int launch(bool dkv, int dtype, const void* q, const void* k, const void* v,
           const void* dout, const float* lse, const float* delta,
           const float* slopes, void* dq, void* dk, void* dv,
           const int* cu_q, const int* cu_k, const int* seqused_k,
           const int* leftpad_k, int B, int Tq, int max_seqlen_q,
           int max_seqlen_k, int Hq, int Hk, int D, float scale, int causal,
           int window_left, int window_right, float softcap, int has_alibi,
           int dropout, unsigned int seed_lo, unsigned int seed_hi,
           unsigned int threshold, float drop_scale, void* stream) {
  if (Hk <= 0 || Hq % Hk != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || Hq == 0 || (dkv ? max_seqlen_k : max_seqlen_q) <= 0)
    return 0;
  BwdArgs a = {};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.lse = lse; a.delta = delta;
  a.slopes = has_alibi ? slopes : nullptr;
  a.dq = dq; a.dk = dk; a.dv = dv;
  a.seq.M = max_seqlen_q; a.seq.N = max_seqlen_k; a.seq.Tq = Tq;
  a.seq.cu_q = cu_q; a.seq.cu_k = cu_k; a.seq.seqused_k = seqused_k;
  a.seq.leftpad_k = leftpad_k;
  a.Hq = Hq; a.Hk = Hk; a.group = Hq / Hk; a.scale = scale;
  a.mp_.causal = causal; a.mp_.window_left = window_left;
  a.mp_.window_right = window_right; a.mp_.softcap = softcap;
  a.mp_.has_alibi = has_alibi;
  // dropout keyed on (within-sequence q position, leftpad-relative key
  // position, bh = b * Hq + h)
  a.dp.enabled = dropout; a.dp.seed_lo = seed_lo; a.dp.seed_hi = seed_hi;
  a.dp.threshold = threshold; a.dp.scale = drop_scale;
  a.dp.num_heads = Hq;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = dtype == 0 ? dispatch<__nv_bfloat16>(dkv, D, a, B, s)
                             : dispatch<__half>(dkv, D, a, B, s);
  return static_cast<int>(e);
}

}  // namespace

#define FA_VARLEN_BWD_PARAMS                                                 \
  int dtype, const void *q, const void *k, const void *v, const void *dout,  \
      const float *lse, const float *delta, const float *slopes, void *dq,   \
      void *dk, void *dv, const int *cu_q, const int *cu_k,                   \
      const int *seqused_k, const int *leftpad_k, int B, int Tq,             \
      int max_seqlen_q, int max_seqlen_k, int Hq, int Hk, int D, float scale, \
      int causal, int window_left, int window_right, float softcap,          \
      int has_alibi, int dropout, unsigned int seed_lo, unsigned int seed_hi, \
      unsigned int threshold, float drop_scale, void *stream
#define FA_VARLEN_BWD_ARGS                                                   \
  dtype, q, k, v, dout, lse, delta, slopes, dq, dk, dv, cu_q, cu_k,          \
      seqused_k, leftpad_k, B, Tq, max_seqlen_q, max_seqlen_k, Hq, Hk, D,    \
      scale, causal, window_left, window_right, softcap, has_alibi, dropout, \
      seed_lo, seed_hi, threshold, drop_scale, stream

// dtype: 0 = bf16, 1 = fp16.  Each returns cudaGetLastError() of its launch.
// K6 writes dq (dk, dv unused); K7 writes dk and dv (dq unused).  cu_q and
// cu_k are (B + 1,), seqused_k / leftpad_k (B,) or null; the grids cover
// max_seqlen_q rows (K6) or max_seqlen_k keys (K7) of each sequence.
extern "C" int fa_varlen_dq_launch(FA_VARLEN_BWD_PARAMS) {
  return launch(false, FA_VARLEN_BWD_ARGS);
}
extern "C" int fa_varlen_dkv_launch(FA_VARLEN_BWD_PARAMS) {
  return launch(true, FA_VARLEN_BWD_ARGS);
}
