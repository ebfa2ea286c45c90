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

using namespace fa::dec;

namespace {

template <typename T>
cudaError_t launch_kind(int kind, const DecodeArgs& a, int D,
                        cudaStream_t st) {
  switch (kind) {
    case fa::kInt8: return launch<T, fa::kInt8>(a, D, st);
    case fa::kFp8: return launch<T, fa::kFp8>(a, D, st);
    case fa::kInt4: return launch<T, fa::kInt4>(a, D, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t occupancy_kind(int kind, int D, int rows, int* out) {
  switch (kind) {
    case fa::kInt8: return occupancy<T, fa::kInt8>(D, rows, out);
    case fa::kFp8: return occupancy<T, fa::kFp8>(D, rows, out);
    case fa::kInt4: return occupancy<T, fa::kInt4>(D, rows, out);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// kind: 0 = int8, 1 = fp8 (e4m3), 2 = int4; dtype (of q): 0 = bf16,
// 1 = fp16; payload strides in bytes, scale strides in floats; o / lse /
// counters null for partials only.  Returns cudaGetLastError() of the
// launch.
extern "C" int fa_decode_quant_launch(
    int kind, int dtype, const void* q, const void* k, const void* v,
    const float* ks, const float* vs, const int* table, const int* lens,
    const int* leftpad, const int* qpos, const float* slopes, float* o_part,
    float* lse_part, void* o, float* lse, int* counters, long long s_c1,
    long long s_h, long long s_c2, long long s_tok, long long sc_c1,
    long long sc_h, long long sc_c2, long long sc_tok, int c2, int B, int Hk,
    int Rq, int D, int S, int max_pages, int page_size, int pages_per_split,
    int t_new, int group, float scale, int causal, int window_left,
    int window_right, float softcap, int has_alibi, void* stream) {
  if (Rq % 8 != 0 || (kind == fa::kInt4 && page_size % 2 != 0) ||
      (o != nullptr && counters == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  DecodeArgs a = {};
  set_common(a, q, k, v, table, lens, leftpad, qpos, slopes, o_part,
             lse_part, o, lse, counters, c2, B, Hk, Rq, S, max_pages,
             page_size, pages_per_split, t_new, group, scale, causal,
             window_left, window_right, softcap, has_alibi);
  a.ks = ks; a.vs = vs;
  a.s_c1 = s_c1; a.s_h = s_h; a.s_c2 = s_c2; a.s_tok = s_tok;
  a.sc_c1 = sc_c1; a.sc_h = sc_h; a.sc_c2 = sc_c2; a.sc_tok = sc_tok;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = dtype == 0 ? launch_kind<__nv_bfloat16>(kind, a, D, st)
                             : launch_kind<__half>(kind, a, D, st);
  return static_cast<int>(e);
}

// K4q's occupancy for (kind, dtype, D) at `rows` q rows a block, as
// fa_decode_occupancy.  Returns a cudaError_t.
extern "C" int fa_decode_quant_occupancy(int kind, int dtype, int D,
                                         int rows, int* out) {
  return static_cast<int>(dtype == 0
                              ? occupancy_kind<__nv_bfloat16>(kind, D, rows,
                                                              out)
                              : occupancy_kind<__half>(kind, D, rows, out));
}
