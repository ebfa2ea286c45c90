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

using namespace fa::dec;

// dtype: 0 = bf16, 1 = fp16; pool strides in elements; o / lse / counters
// null for partials only.  Returns cudaGetLastError() of the launch.
extern "C" int fa_decode_launch(
    int dtype, const void* q, const void* k, const void* v, const int* table,
    const int* lens, const int* leftpad, const int* qpos, const float* slopes,
    float* o_part, float* lse_part, void* o, float* lse, int* counters,
    long long s_c1, long long s_h, long long s_c2, long long s_tok, int c2,
    int B, int Hk, int Rq, int D, int S, int max_pages, int page_size,
    int pages_per_split, int t_new, int group, float scale, int causal,
    int window_left, int window_right, float softcap, int has_alibi,
    void* stream) {
  if (Rq % 8 != 0 || (o != nullptr && counters == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  DecodeArgs a = {};
  set_common(a, q, k, v, table, lens, leftpad, qpos, slopes, o_part,
             lse_part, o, lse, counters, c2, B, Hk, Rq, S, max_pages,
             page_size, pages_per_split, t_new, group, scale, causal,
             window_left, window_right, softcap, has_alibi);
  a.s_c1 = 2 * s_c1; a.s_h = 2 * s_h; a.s_c2 = 2 * s_c2; a.s_tok = 2 * s_tok;
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
