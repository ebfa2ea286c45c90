// K8: packed-varlen attention forward with K/V read through a block table
// from an HND page pool, for Hopper (sm_90a): the paged instantiation of
// the forward body of K1 and K5 (csrc/fwd_body.cuh).
//
// Replaces flash_attn_v100_tpu/ops/pallas/varlen.py::_varlen_fwd_kernel_paged
// (body shared with _varlen_fwd_kernel), the TPU kernel behind
// flash_attn_varlen_fwd_paged and the engine's large-prefill route.  Same
// contract: q (Tq, Hq, D) packed by cu_seqlens_q, pools (Hk, P, ps, D),
// seqlens_k / seqused_k / leftpad_k per sequence (the paged rule of
// csrc/seq.cuh), bottom-right causal and window masks per sequence, scale
// -> ALiBi -> softcap; out (Tq, Hq, D) in q's dtype and LSE (Hq, Tq) fp32.
// A row with no live key gives O = 0 and LSE = -inf; rows no block covers
// (past cu_q[B]) are left to the caller, which fills them with O = 0 and
// LSE = -inf.  No dropout: the variants are the plain one and the one with
// ALiBi / softcap.
//
// What bounds it on this card: operations.  A 512-token prefill does
// 4 * D flops per (q row, key) pair against K/V bytes read once per q tile,
// well above the ~295 flop/byte ridge, so the floor is the flops over the
// 989 TFLOP/s of the bf16 tensor cores.
//
// What the design does about it: K1/K5's body (csrc/fwd_body.cuh): 128 q
// rows in two warpgroups with every product on wgmma (64-byte swizzled
// tiles at D 32), S and O in registers with the base-2 online
// softmax on the fragments, S(s) overlapping P(s - 1) V(s - 1), a two-stage
// cp.async K/V ring, masks on edge tiles only, heaviest tiles first.  Its
// paged mode starts key tiles at cache-row multiples of the step (a tile
// never straddles a page), reads the block's page numbers into shared
// memory once, and copies a tile's rows from one page base at the pool's
// row stride.  With leftpad 0 a sequence's tiles, products and softmax are
// K5's over the same keys, so K8 gives K5's bits on the gathered cache.
#include "fwd_body.cuh"

// FA_SWEEP 1 builds the sweep library (ops/cuda/build.py VARIANTS) in
// place of the shipped one: only the unroll variants below.
#ifndef FA_SWEEP
#define FA_SWEEP 0
#endif

namespace {

#if !FA_SWEEP
// dtype 0 = bf16, 1 = fp16; smem_extra: the block table's bytes
cudaError_t find_variant(int dtype, int D, bool extra, Kernel* k,
                         int smem_extra, int) {
  return dtype == 0
             ? find_d<__nv_bfloat16, kPaged>(D, extra, k, smem_extra)
             : find_d<__half, kPaged>(D, extra, k, smem_extra);
}
#else
// The sweep's variants of K8, by id (flash_attn_v100_tpu_torch/benchmarks/
// variants.py's PAGED): bf16, D 128, without bias, pages a multiple of 128
// rows (a step never straddles a page) only; each steps over 128 keys.
//   1 u2  two 64-key sub-tiles a step, one online softmax
//   2 u4  four 32-key sub-tiles
//   3 u8  eight 16-key sub-tiles
cudaError_t find_variant(int dtype, int D, bool extra, Kernel* k,
                         int smem_extra, int id) {
  using B = __nv_bfloat16;
  if (dtype != 0 || D != 128 || extra) return cudaErrorInvalidValue;
  switch (id) {
    case 1:
      return variant<B, 128, kPaged, false, kKv16, FwdTune<64, 2>>(
          k, smem_extra);
    case 2:
      return variant<B, 128, kPaged, false, kKv16, FwdTune<32, 4>>(
          k, smem_extra);
    case 3:
      return variant<B, 128, kPaged, false, kKv16, FwdTune<16, 8>>(
          k, smem_extra);
    default: return cudaErrorInvalidValue;
  }
}
#endif

int paged(int id, int dtype, const void* q, const void* k, const void* v,
          const int* table, int table_stride, const int* cu_q,
          const int* seqlens_k, const int* seqused_k, const int* leftpad_k,
          const float* slopes, void* out, float* lse, long long s_h,
          long long s_p, long long s_tok, int B, int Tq, int Hq, int Hk,
          int D, int page_size, int mp, int max_seqlen_q, float scale,
          int causal, int window_left, int window_right, float softcap,
          int has_alibi, void* stream) {
  if (page_size <= 0 || page_size % (FA_SWEEP ? 128 : 64) != 0 || Hk <= 0 ||
      Hq % Hk != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || max_seqlen_q <= 0 || Hq == 0) return 0;
  FwdArgs a = {};
  a.q = q; a.k = k; a.v = v; a.slopes = has_alibi ? slopes : nullptr;
  a.out = out; a.lse = lse;
  a.seq.M = max_seqlen_q; a.seq.Tq = Tq; a.seq.cu_q = cu_q;
  a.seq.seqused_k = seqused_k; a.seq.leftpad_k = leftpad_k;
  a.B = B; a.Hq = Hq; a.Hk = Hk; a.group = Hq / Hk; a.scale = scale;
  a.mp_.causal = causal; a.mp_.window_left = window_left;
  a.mp_.window_right = window_right; a.mp_.softcap = softcap;
  a.mp_.has_alibi = has_alibi;
  a.pg.table = table; a.pg.table_stride = table_stride;
  a.pg.seqlens_k = seqlens_k; a.pg.page_size = page_size; a.pg.mp = mp;
  a.pg.s_h = s_h; a.pg.s_p = s_p; a.pg.s_tok = s_tok;
  const int tb = table_bytes(mp);
  Kernel kn;
  cudaError_t e = find_variant(dtype, D, needs_extra(a), &kn, tb, id);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(
      launch_kernel(kn, a, tb, static_cast<cudaStream_t>(stream)));
}

// out[0] resident blocks a multiprocessor, out[1] dynamic shared memory a
// block (bytes), out[2] threads a block, out[3] registers a thread, out[4]
// local memory a thread (bytes: spills and stack)
int occupancy(int dtype, int D, int extra, int id, int* out) {
  Kernel kn;
  cudaFuncAttributes attr;
  cudaError_t e = find_variant(dtype, D, extra != 0, &kn, 0, id);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, kn.fn);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[1] = kn.smem;
  out[2] = kn.threads;
  out[3] = attr.numRegs;
  out[4] = static_cast<int>(attr.localSizeBytes);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, kn.fn, kn.threads, kn.smem));
}

}  // namespace

#define FA_PAGED_PARAMS                                                      \
  int dtype, const void *q, const void *k, const void *v, const int *table,  \
      int table_stride, const int *cu_q, const int *seqlens_k,               \
      const int *seqused_k, const int *leftpad_k, const float *slopes,       \
      void *out, float *lse, long long s_h, long long s_p, long long s_tok,  \
      int B, int Tq, int Hq, int Hk, int D, int page_size, int mp,           \
      int max_seqlen_q, float scale, int causal, int window_left,            \
      int window_right, float softcap, int has_alibi, void *stream
#define FA_PAGED_ARGS                                                        \
  dtype, q, k, v, table, table_stride, cu_q, seqlens_k, seqused_k,           \
      leftpad_k, slopes, out, lse, s_h, s_p, s_tok, B, Tq, Hq, Hk, D,        \
      page_size, mp, max_seqlen_q, scale, causal, window_left, window_right, \
      softcap, has_alibi, stream

#if !FA_SWEEP
// dtype: 0 = bf16, 1 = fp16.  Returns cudaGetLastError() of the launch.
// Pool strides in elements; the grid covers max_seqlen_q rows of each
// sequence.
extern "C" int fa_varlen_paged_launch(FA_PAGED_PARAMS) {
  return paged(0, FA_PAGED_ARGS);
}

// The occupancy of K8 for (dtype, D), in the variant without bias (extra 0)
// or with (extra 1), without the block table's bytes, into out[5]
// (occupancy() above).  Returns a cudaError_t.
extern "C" int fa_varlen_paged_occupancy(int dtype, int D, int extra,
                                         int* out) {
  return occupancy(dtype, D, extra, 0, out);
}
#else
// The sweep library's entries: the shipped entry's arguments after the
// variant's id (find_variant above), and its occupancy.
extern "C" int fa_varlen_paged_sweep_launch(int id, FA_PAGED_PARAMS) {
  return paged(id, FA_PAGED_ARGS);
}

extern "C" int fa_varlen_paged_sweep_occupancy(int id, int* out) {
  return occupancy(0, 128, 0, id, out);
}
#endif
