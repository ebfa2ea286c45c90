// K4q: split-KV paged decode attention over int8, fp8 (e4m3) or int4 page
// pools with per-(token, head) fp32 scales, for Hopper (sm_90a).
//
// Replaces the quantized branches of
// flash_attn_v100_tpu/ops/pallas/decode.py::_decode_kernel (with
// _decode_page_update and _decode_tile_update), the TPU kernel behind
// paged_decode_attention(k_scales=, v_scales=, int4=).  The contract is
// K4's (decode.cu): q rows (B, Hk, Rq, D), a page pool view
// (C1, Hk, C2, rows, D) through a block table, one normalized partial O and
// one LSE per split, or the merged O and LSE from the same launch.  The
// payload is int8, e4m3, or int4 packed two tokens a byte (rows =
// page_size / 2); the scales are (C1, Hk, C2, page_size, 1).  The
// arithmetic is the TPU kernel's:
//   int8 and int4: each q row is quantized to int8 (scale amax / 127,
//     rint(q / scale)); the score is the int32 dot q8 . k8, then
//     float(dot) * q_scale * k_scale * softmax_scale -> ALiBi -> softcap;
//     P is multiplied by V's per-token scales and quantized to int8 per row
//     over a group of keys (scale amax / 127); P8 . V8 runs in int32 and is
//     added as float(int) * p_scale to the fp32 accumulator after the
//     online-softmax rescale.
//   fp8: K and V are converted exactly (K to q's type, V to bf16); the
//     score is the fp32 dot, times k_scale, then the pipeline; P times V's
//     scales is rounded to bf16 before the P V product.
// q may be bf16, fp16 or fp32 (the JAX package serves its fp32 test model
// from quantized pools): an fp32 q is quantized as a 16-bit one for int8
// and int4, and for fp8 its S is the fp32 dot (three exact bf16 parts of q,
// csrc/decode_body.cuh); the merged O is in q's type.
// P's grouping: the TPU kernel takes P's int8 scale per page; this kernel
// per (q row, group of 32 consecutive cache rows counted from its split's
// first row).  Where the warps split the keys (Rq <= 16) group g is warp
// g % 4's, and each warp keeps its own running max, so P is taken relative
// to the max of that warp's groups so far.  The plain twin
// (ops/cuda/decode.py::paged_decode_attention_ref, p_tile=32) groups the
// same way and takes the same running maxima.
//
// What bounds it on this card, and the design: csrc/decode_body.cuh (K4's
// body): bytes, 2 * (D + 4) a token and kv head for int8/fp8 and
// 2 * (D / 2 + 4) for int4; payload bytes and scales through the
// three-stage cp.async ring, S and P V on mma.sync (m16n8k32 on int8 for
// int8 and int4, m16n8k16 on e4m3 converted in registers for fp8), S, P
// and O in registers, the split merge inside the launch.
#include "decode_body.cuh"

// FA_SWEEP 1 builds the sweep library (ops/cuda/build.py VARIANTS) in
// place of the shipped one: only int4's ablations (fa_decode_quant_sweep_*)
#ifndef FA_SWEEP
#define FA_SWEEP 0
#endif

using namespace fa::dec;

#if !FA_SWEEP
// the fp16 and fp32 q types' kernels: decode_quant_f16.cu and
// decode_quant_f32.cu, compiled beside this file
namespace fa {
namespace dec {
extern template cudaError_t launch_quant<__half>(int, const DecodeArgs&, int,
                                                 cudaStream_t);
extern template cudaError_t launch_quant<float>(int, const DecodeArgs&, int,
                                                cudaStream_t);
extern template cudaError_t occupancy_quant<__half>(int, int, int, int*);
extern template cudaError_t occupancy_quant<float>(int, int, int, int*);
}  // namespace dec
}  // namespace fa
#endif

#define FA_DECODE_QUANT_PARAMS                                               \
  int kind, int dtype, const void *q, const void *k, const void *v,          \
      const float *ks, const float *vs, const int *table, const int *lens,   \
      const int *leftpad, const int *qpos, const float *slopes,              \
      float *o_part, float *lse_part, void *o, float *lse, int *counters,    \
      long long s_c1, long long s_h, long long s_c2, long long s_tok,        \
      long long sc_c1, long long sc_h, long long sc_c2, long long sc_tok,    \
      int c2, int B, int Hk, int Rq, int D, int S, int max_pages,            \
      int page_size, int pages_per_split, int t_new, int group, float scale, \
      int causal, int window_left, int window_right, float softcap,          \
      int has_alibi, void *stream
#define FA_DECODE_QUANT_ARGS                                                 \
  kind, q, k, v, ks, vs, table, lens, leftpad, qpos, slopes, o_part,         \
      lse_part, o, lse, counters, s_c1, s_h, s_c2, s_tok, sc_c1, sc_h,       \
      sc_c2, sc_tok, c2, B, Hk, Rq, S, max_pages, page_size,                 \
      pages_per_split, t_new, group, scale, causal, window_left,             \
      window_right, softcap, has_alibi

namespace {

// the launch's DecodeArgs; false where the arguments are refused
bool make_args(DecodeArgs* a, int kind, const void* q, const void* k,
               const void* v, const float* ks, const float* vs,
               const int* table, const int* lens, const int* leftpad,
               const int* qpos, const float* slopes, float* o_part,
               float* lse_part, void* o, float* lse, int* counters,
               long long s_c1, long long s_h, long long s_c2, long long s_tok,
               long long sc_c1, long long sc_h, long long sc_c2,
               long long sc_tok, int c2, int B, int Hk, int Rq, int S,
               int max_pages, int page_size, int pages_per_split, int t_new,
               int group, float scale, int causal, int window_left,
               int window_right, float softcap, int has_alibi) {
  if (Rq % 8 != 0 || (kind == fa::kInt4 && page_size % 2 != 0) ||
      (o != nullptr && counters == nullptr))
    return false;
  *a = {};
  set_common(*a, q, k, v, table, lens, leftpad, qpos, slopes, o_part,
             lse_part, o, lse, counters, c2, B, Hk, Rq, S, max_pages,
             page_size, pages_per_split, t_new, group, scale, causal,
             window_left, window_right, softcap, has_alibi);
  a->ks = ks; a->vs = vs;
  a->s_c1 = s_c1; a->s_h = s_h; a->s_c2 = s_c2; a->s_tok = s_tok;
  a->sc_c1 = sc_c1; a->sc_h = sc_h; a->sc_c2 = sc_c2; a->sc_tok = sc_tok;
  return true;
}

}  // namespace

#if !FA_SWEEP
// kind: 0 = int8, 1 = fp8 (e4m3), 2 = int4; dtype (of q and of the merged
// o): 0 = bf16, 1 = fp16, 2 = fp32, any other cudaErrorInvalidValue;
// payload strides in bytes, scale strides in floats; o / lse / counters
// null for partials only.  Returns cudaGetLastError() of the launch.
extern "C" int fa_decode_quant_launch(FA_DECODE_QUANT_PARAMS) {
  DecodeArgs a;
  if (!make_args(&a, FA_DECODE_QUANT_ARGS))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(launch_quant<__nv_bfloat16>(kind, a, D, st));
    case 1: return static_cast<int>(launch_quant<__half>(kind, a, D, st));
    case 2: return static_cast<int>(launch_quant<float>(kind, a, D, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K4q's occupancy for (kind, dtype, D) at `rows` q rows a block, as
// fa_decode_occupancy.  Returns a cudaError_t.
extern "C" int fa_decode_quant_occupancy(int kind, int dtype, int D,
                                         int rows, int* out) {
  switch (dtype) {
    case 0:
      return static_cast<int>(occupancy_quant<__nv_bfloat16>(kind, D, rows,
                                                             out));
    case 1:
      return static_cast<int>(occupancy_quant<__half>(kind, D, rows, out));
    case 2:
      return static_cast<int>(occupancy_quant<float>(kind, D, rows, out));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
#else
namespace {

// The sweep's int4 ablations of K4q, by id (decode_body.cuh's kAbl*;
// flash_attn_v100_tpu_torch/benchmarks/variants.py's INT4): int4 pools, bf16
// q, D 128, Rq <= 16 (the decode step's 16-row tile) only.  Timing only.
//   1 full-qk  the production S, P V over one nibble half of V
//   2 qk-one   one K half's product, duplicated
//   3 no-and   the packed bytes read as int8, no unpacking
cudaError_t find_ablation(int id, const void** fn, size_t* smem,
                          size_t tbl) {
  using B = __nv_bfloat16;
  switch (id) {
    case kAblFullQk:
      return variant<B, 128, fa::kInt4, 16, kAblFullQk>(fn, smem, tbl);
    case kAblQkOne:
      return variant<B, 128, fa::kInt4, 16, kAblQkOne>(fn, smem, tbl);
    case kAblNoAnd:
      return variant<B, 128, fa::kInt4, 16, kAblNoAnd>(fn, smem, tbl);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The sweep library's entries: fa_decode_quant_launch's arguments after the
// ablation's id, and its occupancy (as fa_decode_quant_occupancy's).
extern "C" int fa_decode_quant_sweep_launch(int id, FA_DECODE_QUANT_PARAMS) {
  DecodeArgs a;
  if (kind != fa::kInt4 || dtype != 0 || D != 128 || Rq > 16 ||
      !make_args(&a, FA_DECODE_QUANT_ARGS))
    return static_cast<int>(cudaErrorInvalidValue);
  const void* fn;
  size_t smem;
  cudaError_t e = find_ablation(id, &fn, &smem, align16(4 * pages_per_split));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(
      launch_fn(fn, smem, 16, a, static_cast<cudaStream_t>(stream)));
}

extern "C" int fa_decode_quant_sweep_occupancy(int id, int* out) {
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
