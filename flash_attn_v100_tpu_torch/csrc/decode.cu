// K4: split-KV paged decode attention over GQA-folded q rows, for Hopper
// (sm_90a).
//
// Replaces flash_attn_v100_tpu/ops/pallas/decode.py::_decode_kernel (with
// _decode_page_update and _decode_tile_update), the TPU kernel behind
// paged_decode_attention.  Same contract: q rows (B, Hk, Rq, D) with row
// r = g * t_new + t, a page pool view (C1, Hk, C2, ps, D) addressed through a
// block table, live cache rows [leftpad, leftpad + lens), q position
// qpos + r % t_new; one normalized partial O and one LSE per split (the
// TPU kernel's outputs, merged outside by merge_partials), or, given
// merged outputs, the split merge inside the same launch: O (B, Hk, Rq, D)
// in q's type and LSE (B, Hk, Rq).  A row with no live key gives O = 0,
// LSE = -inf; an empty split weighs 0 in the merge.
//
// What bounds it on this card, and the design: csrc/decode_body.cuh (the
// body K4q shares): bytes; 16-bit K/V through a three-stage cp.async ring,
// S and P V on mma.sync m16n8k16 with S, P and O in registers, the warps
// splitting the keys at Rq <= 16, the split merge by the last block of
// each (batch row, kv head, q-row tile).
#include "decode_body.cuh"

// FA_SWEEP 1 builds the sweep library (ops/cuda/build.py VARIANTS) in place
// of the shipped one: only the copies ablation (fa_decode_sweep_*)
#ifndef FA_SWEEP
#define FA_SWEEP 0
#endif

using namespace fa::dec;

#define FA_DECODE_PARAMS                                                     \
  int dtype, const void *q, const void *k, const void *v, const int *table,  \
      const int *lens, const int *leftpad, const int *qpos,                  \
      const float *slopes, float *o_part, float *lse_part, void *o,          \
      float *lse, int *counters, long long s_c1, long long s_h,              \
      long long s_c2, long long s_tok, int c2, int B, int Hk, int Rq, int D, \
      int S, int max_pages, int page_size, int pages_per_split, int t_new,   \
      int group, float scale, int causal, int window_left, int window_right, \
      float softcap, int has_alibi, void *stream

namespace {

// the launch's DecodeArgs (pool strides in elements); false where the
// arguments are refused
bool make_args(DecodeArgs* a, FA_DECODE_PARAMS) {
  if (Rq % 8 != 0 || (o != nullptr && counters == nullptr)) return false;
  *a = {};
  set_common(*a, q, k, v, table, lens, leftpad, qpos, slopes, o_part,
             lse_part, o, lse, counters, c2, B, Hk, Rq, S, max_pages,
             page_size, pages_per_split, t_new, group, scale, causal,
             window_left, window_right, softcap, has_alibi);
  a->s_c1 = 2 * s_c1; a->s_h = 2 * s_h; a->s_c2 = 2 * s_c2;
  a->s_tok = 2 * s_tok;
  return true;
}

}  // namespace

#define FA_DECODE_ARGS                                                       \
  dtype, q, k, v, table, lens, leftpad, qpos, slopes, o_part, lse_part, o,   \
      lse, counters, s_c1, s_h, s_c2, s_tok, c2, B, Hk, Rq, D, S, max_pages, \
      page_size, pages_per_split, t_new, group, scale, causal, window_left,  \
      window_right, softcap, has_alibi, stream

#if !FA_SWEEP
// dtype: 0 = bf16, 1 = fp16; pool strides in elements; o / lse / counters
// null for partials only.  Returns cudaGetLastError() of the launch.
extern "C" int fa_decode_launch(FA_DECODE_PARAMS) {
  DecodeArgs a;
  if (!make_args(&a, FA_DECODE_ARGS))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = dtype == 0 ? launch<__nv_bfloat16, kK16>(a, D, st)
                             : launch<__half, kK16>(a, D, st);
  return static_cast<int>(e);
}

// K4's occupancy for (dtype, D) at `rows` q rows a block (16: Rq <= 16,
// else 64): out[0] resident blocks a multiprocessor, out[1] dynamic shared
// memory a block without the table (bytes), out[2] threads a block, out[3]
// registers a thread, out[4] local memory a thread (bytes: spills and
// stack).  Returns a cudaError_t.
extern "C" int fa_decode_occupancy(int dtype, int D, int rows, int* out) {
  return static_cast<int>(dtype == 0
                              ? occupancy<__nv_bfloat16, kK16>(D, rows, out)
                              : occupancy<__half, kK16>(D, rows, out));
}
#else
namespace {

// The sweep's ablation of K4, by id (decode_body.cuh's kAbl*;
// flash_attn_v100_tpu_torch/benchmarks/variants.py's K4): bf16, D 256,
// Rq <= 16 (the decode step's 16-row tile) only.
//   4 copies  the ring alone: copies, waits, barriers, no products
//             (timing only)
cudaError_t find_ablation(int id, const void** fn, size_t* smem,
                          size_t tbl) {
  using B = __nv_bfloat16;
  switch (id) {
    case kAblCopies: return variant<B, 256, kK16, 16, kAblCopies>(fn, smem,
                                                                  tbl);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The sweep library's entries: fa_decode_launch's arguments after the
// ablation's id, and its occupancy (as fa_decode_occupancy's).
extern "C" int fa_decode_sweep_launch(int id, FA_DECODE_PARAMS) {
  DecodeArgs a;
  if (dtype != 0 || D != 256 || Rq > 16 || !make_args(&a, FA_DECODE_ARGS))
    return static_cast<int>(cudaErrorInvalidValue);
  const void* fn;
  size_t smem;
  cudaError_t e = find_ablation(id, &fn, &smem, align16(4 * pages_per_split));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(
      launch_fn(fn, smem, 16, a, static_cast<cudaStream_t>(stream)));
}

extern "C" int fa_decode_sweep_occupancy(int id, int* out) {
  const void* fn;
  size_t smem;
  cudaFuncAttributes attr;
  cudaError_t e = find_ablation(id, &fn, &smem, 0);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, fn);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[1] = static_cast<int>(smem);
  out[2] = kThreads;
  out[3] = attr.numRegs;
  out[4] = static_cast<int>(attr.localSizeBytes);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, fn, kThreads, smem));
}
#endif
