// K4 over fp32 q and fp32 page pools: split-KV paged decode attention over
// GQA-folded q rows for Hopper (sm_90a), with the split merge in the same
// launch, as csrc/decode.cu is for 16-bit pools.
//
// Replaces, for fp32 inputs, flash_attn_v100_tpu/ops/pallas/decode.py::
// _decode_kernel (with _decode_page_update and _decode_tile_update), the TPU
// kernel behind paged_decode_attention.  The contract is csrc/decode.cu's:
// q rows (B, Hk, Rq, D) with row r = g * t_new + t, a page pool view (C1,
// Hk, C2, ps, D) through a block table, live cache rows [leftpad, leftpad +
// lens), q position qpos + r % t_new; one normalized partial O and one LSE
// per split, or, given merged outputs, the split merge inside the launch:
// O (B, Hk, Rq, D) fp32 and LSE (B, Hk, Rq).  A row with no live key gives
// O = 0, LSE = -inf; an empty split weighs 0 in the merge.
//
// What bounds it on this card: bytes.  Decode reads every live K and V byte
// once and does 4 * Rq operations per K/V element pair; fp32 pools hold
// twice the bytes of 16-bit ones.
//
// What the design does about it: the decode body csrc/decode_body.cuh,
// instantiated for fp32 pools (kK32): the 16-bit body's schedule (the
// split's page ids read once, a three-stage cp.async ring of half the
// 16-bit stage's keys, the warps splitting the keys at Rq <= 16, S, P and
// O in registers, the split merge by the last block of each (batch row,
// kv head, q-row tile)) with S = Q K^T and O += P V as 3 x TF32 split
// products on mma.sync m16n8k8 (csrc/f32_tiles.cuh), O taking each key
// group's P V from a zeroed fragment, and the softmax in the natural base
// (expf) as the fp32 bodies compute it.  Two blocks an SM at D 32-128, one
// at D 256 (shared memory; decode_body.cuh's header).
#include "decode_body.cuh"

using namespace fa::dec;

namespace {

constexpr int kF32 = 2;   // the wrappers' dtype code of fp32

}  // namespace

// The arguments of fa_decode_launch (csrc/decode.cu); dtype must be 2
// (fp32); pool strides in elements; o / lse / counters null for partials
// only.  Returns cudaGetLastError() of the launch.
extern "C" int fa_decode_f32_launch(
    int dtype, const void* q, const void* k, const void* v, const int* table,
    const int* lens, const int* leftpad, const int* qpos, const float* slopes,
    float* o_part, float* lse_part, void* o, float* lse, int* counters,
    long long s_c1, long long s_h, long long s_c2, long long s_tok, int c2,
    int B, int Hk, int Rq, int D, int S, int max_pages, int page_size,
    int pages_per_split, int t_new, int group, float scale, int causal,
    int window_left, int window_right, float softcap, int has_alibi,
    void* stream) {
  if (dtype != kF32 || Rq % 8 != 0 || (o != nullptr && counters == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || Hk == 0 || Rq == 0) return 0;
  DecodeArgs a = {};
  set_common(a, q, k, v, table, lens, leftpad, qpos, slopes, o_part,
             lse_part, o, lse, counters, c2, B, Hk, Rq, S, max_pages,
             page_size, pages_per_split, t_new, group, scale, causal,
             window_left, window_right, softcap, has_alibi);
  a.s_c1 = 4 * s_c1; a.s_h = 4 * s_h; a.s_c2 = 4 * s_c2; a.s_tok = 4 * s_tok;
  return static_cast<int>(
      launch<float, kK32>(a, D, static_cast<cudaStream_t>(stream)));
}

// K4 fp32's occupancy at head dim D and `rows` q rows a block (16: Rq <=
// 16, else 64), as fa_decode_occupancy (csrc/decode.cu) gives K4's; dtype
// must be 2.  Returns a cudaError_t.
extern "C" int fa_decode_f32_occupancy(int dtype, int D, int rows,
                                       int* out) {
  if (dtype != kF32) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(occupancy<float, kK32>(D, rows, out));
}
