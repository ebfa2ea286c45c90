// K1 (dense) and K5 (packed varlen): attention forward for Hopper
// (sm_90a), one kernel body (csrc/fwd_body.cuh) instantiated for both
// (csrc/seq.cuh); K8 is its third, paged instantiation.
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
// with no live key gives O = 0 and LSE = -inf.  D is the kernel head dim
// (32, 64, 128, 256) and D_in the rows' columns in memory: D, or at D 32 a
// multiple of 8 below it (head dim 8-24 without padded copies: the tiles'
// other columns are zero and only D_in columns of out are written).
//
// What bounds it and what its design does about it: csrc/fwd_body.cuh.
#include "fwd_body.cuh"

// FA_SWEEP 1 builds the sweep library (ops/cuda/build.py VARIANTS) in
// place of the shipped one: only the tile and schedule variants below.
#ifndef FA_SWEEP
#define FA_SWEEP 0
#endif

namespace {

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

#if !FA_SWEEP
// dtype 0 = bf16, 1 = fp16
cudaError_t find_variant(bool varlen, int dtype, int D, bool extra,
                         Kernel* k) {
  if (varlen)
    return dtype == 0 ? find_d<__nv_bfloat16, kVarlen>(D, extra, k)
                      : find_d<__half, kVarlen>(D, extra, k);
  return dtype == 0 ? find_d<__nv_bfloat16, kDense>(D, extra, k)
                    : find_d<__half, kDense>(D, extra, k);
}
#else
// The sweep's variants of K1 and K5, by id (the names are
// flash_attn_v100_tpu_torch/benchmarks/variants.py's FWD): bf16, D 128,
// without bias or dropout only.
//   1 bk128     128 q rows x 128 keys a step, one S product
//   2 bq64      64 q rows (one warpgroup) x 64 keys
//   3 unmasked  the shipped tile, every tile unmasked (timing only)
//   4 u2        two 64-key sub-tiles a step, one online softmax
//   5 u4        four 32-key sub-tiles a step (four 64-key ones would need
//               2 x 128 KB of stages, past a block's 227 KB)
//   6 pingpong  the shipped tile, the warpgroups' products in turns
//   7 pingpong-bk128
template <int MODE>
cudaError_t sweep_variant(int id, Kernel* k) {
  using B = __nv_bfloat16;
  switch (id) {
    case 1: return variant<B, 128, MODE, false, kKv16, FwdTune<128>>(k);
    case 2: return variant<B, 128, MODE, false, kKv16, FwdTune<64, 1, 1>>(k);
    case 3:
      return variant<B, 128, MODE, false, kKv16, FwdTune<0, 1, 0, true>>(k);
    case 4: return variant<B, 128, MODE, false, kKv16, FwdTune<64, 2>>(k);
    case 5: return variant<B, 128, MODE, false, kKv16, FwdTune<32, 4>>(k);
    case 6:
      return variant<B, 128, MODE, false, kKv16,
                     FwdTune<0, 1, 0, false, true>>(k);
    case 7:
      return variant<B, 128, MODE, false, kKv16,
                     FwdTune<128, 1, 0, false, true>>(k);
    default: return cudaErrorInvalidValue;
  }
}

// the sweep's variant `id` (the argument the shipped entries do not take)
cudaError_t find_variant(bool varlen, int dtype, int D, bool extra, Kernel* k,
                         int id) {
  if (dtype != 0 || D != 128 || extra) return cudaErrorInvalidValue;
  return varlen ? sweep_variant<kVarlen>(id, k) : sweep_variant<kDense>(id, k);
}
#endif

// varlen: a.seq.M is max_seqlen_q; blocks past their sequence leave at once
cudaError_t launch(bool varlen, int dtype, int D, const FwdArgs& a,
                   cudaStream_t stream, int id) {
  Kernel kn;
#if FA_SWEEP
  cudaError_t e = find_variant(varlen, dtype, D, needs_extra(a), &kn, id);
#else
  (void)id;
  cudaError_t e = find_variant(varlen, dtype, D, needs_extra(a), &kn);
#endif
  if (e != cudaSuccess) return e;
  return launch_kernel(kn, a, 0, stream);
}

// D_in: D, or at D 32 a multiple of 8 below it
bool head_dims_ok(int D, int D_in) {
  return D_in == D || (D == 32 && D_in > 0 && D_in < D && D_in % 8 == 0);
}

int dense(int id, int dtype, const void* q, const void* k, const void* v,
          const float* slopes, void* out, float* lse, int B, int M, int N,
          int Hq, int Hk, int D, int D_in, int offset, float scale,
          int causal,
          int window_left, int window_right, float softcap, int has_alibi,
          int dropout, unsigned int seed_lo, unsigned int seed_hi,
          unsigned int threshold, float drop_scale, int q0, int k0, int b0,
          int h0, int num_heads, void* stream) {
  if (Hk <= 0 || Hq % Hk != 0 || !head_dims_ok(D, D_in))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || M == 0 || Hq == 0) return 0;
  FwdArgs a = {};
  a.q = q; a.k = k; a.v = v; a.slopes = has_alibi ? slopes : nullptr;
  a.out = out; a.lse = lse; a.d_in = D_in;
  a.seq.M = M; a.seq.N = N; a.seq.offset = offset;
  a.B = B; a.Hq = Hq; a.Hk = Hk; a.group = Hq / Hk; a.scale = scale;
  set_mask_dropout(&a, causal, window_left, window_right, softcap, has_alibi,
                   dropout, seed_lo, seed_hi, threshold, drop_scale, q0, k0,
                   b0, h0, num_heads);
  return static_cast<int>(
      launch(false, dtype, D, a, static_cast<cudaStream_t>(stream), id));
}

int varlen(int id, int dtype, const void* q, const void* k, const void* v,
           const int* cu_q, const int* cu_k, const int* seqused_k,
           const int* leftpad_k, const float* slopes, void* out, float* lse,
           int B, int Tq, int max_seqlen_q, int Hq, int Hk, int D, int D_in,
           float scale, int causal, int window_left, int window_right,
           float softcap, int has_alibi, int dropout, unsigned int seed_lo,
           unsigned int seed_hi, unsigned int threshold, float drop_scale,
           int q0, int k0, int b0, int h0, int num_heads, void* stream) {
  if (Hk <= 0 || Hq % Hk != 0 || !head_dims_ok(D, D_in))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || max_seqlen_q <= 0 || Hq == 0) return 0;
  FwdArgs a = {};
  a.q = q; a.k = k; a.v = v; a.slopes = has_alibi ? slopes : nullptr;
  a.out = out; a.lse = lse; a.d_in = D_in;
  a.seq.M = max_seqlen_q; a.seq.Tq = Tq; a.seq.cu_q = cu_q;
  a.seq.cu_k = cu_k; a.seq.seqused_k = seqused_k;
  a.seq.leftpad_k = leftpad_k;
  a.B = B; a.Hq = Hq; a.Hk = Hk; a.group = Hq / Hk; a.scale = scale;
  set_mask_dropout(&a, causal, window_left, window_right, softcap, has_alibi,
                   dropout, seed_lo, seed_hi, threshold, drop_scale, q0, k0,
                   b0, h0, num_heads);
  return static_cast<int>(
      launch(true, dtype, D, a, static_cast<cudaStream_t>(stream), id));
}

// out[0] resident blocks a multiprocessor, out[1] dynamic shared memory a
// block (bytes), out[2] threads a block, out[3] registers a thread, out[4]
// local memory a thread (bytes: spills and stack)
int occupancy(const Kernel& kn, int* out) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, kn.fn);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[1] = kn.smem;
  out[2] = kn.threads;
  out[3] = attr.numRegs;
  out[4] = static_cast<int>(attr.localSizeBytes);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, kn.fn, kn.threads, kn.smem));
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
#define FA_DENSE_PARAMS                                                     \
  int dtype, const void *q, const void *k, const void *v,                   \
      const float *slopes, void *out, float *lse, int B, int M, int N,      \
      int Hq, int Hk, int D, int D_in, int offset, float scale,             \
      FA_MASK_DROPOUT_PARAMS, void *stream
#define FA_DENSE_ARGS                                                       \
  dtype, q, k, v, slopes, out, lse, B, M, N, Hq, Hk, D, D_in, offset,       \
      scale, FA_MASK_DROPOUT_ARGS, stream
#define FA_VARLEN_PARAMS                                                    \
  int dtype, const void *q, const void *k, const void *v, const int *cu_q,  \
      const int *cu_k, const int *seqused_k, const int *leftpad_k,          \
      const float *slopes, void *out, float *lse, int B, int Tq,            \
      int max_seqlen_q, int Hq, int Hk, int D, int D_in, float scale,       \
      FA_MASK_DROPOUT_PARAMS, void *stream
#define FA_VARLEN_ARGS                                                      \
  dtype, q, k, v, cu_q, cu_k, seqused_k, leftpad_k, slopes, out, lse, B,    \
      Tq, max_seqlen_q, Hq, Hk, D, D_in, scale, FA_MASK_DROPOUT_ARGS, stream

#if !FA_SWEEP
// dtype: 0 = bf16, 1 = fp16.  Each returns cudaGetLastError() of its launch.
// K1: dense (B, M, Hq, D_in) q against (B, N, Hk, D_in) k/v.
extern "C" int fa_fwd_launch(FA_DENSE_PARAMS) {
  return dense(0, FA_DENSE_ARGS);
}

// K5: packed (Tq, Hq, D_in) q split by cu_q (B + 1,) against packed (Tk,
// Hk, D_in) k/v split by cu_k; seqused_k / leftpad_k (B,) may be null.  The
// grid covers max_seqlen_q rows of each sequence.
extern "C" int fa_varlen_fwd_launch(FA_VARLEN_PARAMS) {
  return varlen(0, FA_VARLEN_ARGS);
}

// The occupancy of K1 for (dtype, D), in the variant without bias and
// dropout (extra 0) or with (extra 1), into out[5] (occupancy() above).
// Returns a cudaError_t.
extern "C" int fa_fwd_occupancy(int dtype, int D, int extra, int* out) {
  Kernel kn;
  cudaError_t e = find_variant(false, dtype, D, extra != 0, &kn);
  return e != cudaSuccess ? static_cast<int>(e) : occupancy(kn, out);
}
#else
// The sweep library's entries: the shipped entries' arguments after the
// variant's id (sweep_variant above).
extern "C" int fa_fwd_sweep_launch(int id, FA_DENSE_PARAMS) {
  return dense(id, FA_DENSE_ARGS);
}

extern "C" int fa_varlen_fwd_sweep_launch(int id, FA_VARLEN_PARAMS) {
  return varlen(id, FA_VARLEN_ARGS);
}

// variant `id` of K1 (varlen 0) or K5 (varlen 1) into out[5] as
// fa_fwd_occupancy
extern "C" int fa_fwd_sweep_occupancy(int id, int varlen, int* out) {
  Kernel kn;
  cudaError_t e = find_variant(varlen != 0, 0, 128, false, &kn, id);
  return e != cudaSuccess ? static_cast<int>(e) : occupancy(kn, out);
}
#endif
