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
// the same way.  Both paths compute the softmax in base 2 (a score of the
// natural domain is turned into log2 units before its exponential) and
// give the LSE in the natural log.
//
// What bounds it on this card: operations.  A 512-token prefill does
// 4 * D operations per (q row, key) pair against K/V bytes read once per q
// tile: the floor is the operations over 1,979 TOPS of the int8 tensor
// cores (int8, int4) or 989 TFLOP/s of bf16 (fp8, whose products stay
// 16-bit).
//
// What the design does about it:
//   * fp8 is K8's schedule: the paged instantiation of the forward body
//     (csrc/fwd_body.cuh) with e4m3 K/V tiles converted in registers, the
//     tile's scales in its stage, wgmma at D 64/128/256 and mma.sync at
//     32.
//   * int8 and int4 run a kernel of their own on the int8 tensor cores
//     (mma.sync m16n8k32, int32 accumulators), with S, P and O in
//     registers.  A block is 4 warps of 16 q rows (64 rows; two or three
//     blocks an SM, whose barriers do not hold each other) sharing each
//     64-key tile of a two-stage ring, tile s + 1 copied during step s
//     (running P(s - 1) V(s - 1) during the softmax of S(s), as the body
//     does, took 204 registers at D 64 against 167 and lost more to the
//     third block an SM than the overlap won).  The key step stays 64
//     cache-row-aligned keys at every head dim: it is P's int8 group.  Q is
//     quantized once per block into shared memory, its A fragments read
//     from there once (D <= 128) or at every step (D 256).  K8 is stored [key][dim] (K-major, B of Q K^T) by
//     cp.async (int8) or by a register pass that unpacks int4.  An 8-bit
//     B operand must be K-major, and neither ldmatrix's nor wgmma's
//     transpose takes 8-bit types, so V goes through registers into a
//     transposed tile, [dim][key], 4 x 4 bytes at a time.  Its keys are
//     permuted within each 32 so that the accumulator layout of S, in
//     which a thread holds keys 8 j + 2 (lane % 4) + {0, 1}, is the A
//     layout of P V, which wants keys 4 (lane % 4) + {0..3} and + 16:
//     P8's A fragment for keys [32 kk, 32 kk + 32) packs n-blocks 4 kk,
//     4 kk + 1 (then 4 kk + 2, 4 kk + 3) of the thread's S fragments, and
//     column 16 h + 4 q + 2 a + b of V's tile holds key 16 h + 2 q + 8 a + b
//     (FA3's trick for fp8).  On the fragments: float(S) * q_scale *
//     k_scale and the bias, the row max over the quad, P times the v
//     scale, the row amax over the quad for P's scale, rint(p / p_scale)
//     into int8 A fragments; P8 V8 accumulates in int32 64 columns at a
//     time and is added to O as float(int) * p_scale after the rescale.
//     The conversions between int32 and fp32 (S, P, the P V sums) are
//     exact float additions of 1.5 * 2^23 rather than conversion
//     instructions, which run at a quarter of the FMA rate.
//     Masks on edge tiles only, heaviest q tiles first, the block's pages
//     read into shared memory once, as K8.
//   * fp32 q.  int8 and int4 quantize it as a 16-bit q.  fp8 over an fp32
//     q runs the int kernel's schedule with 16-bit products (the body's
//     16-bit tiles do not take fp32): the TPU kernel's S is the fp32
//     q . k, so q is split into three bf16 tiles whose sum is q exactly
//     (fa::split_bf16x3) and S is three m16n8k16 products against the e4m3
//     K bytes converted in registers (Q's columns permuted as in
//     csrc/decode_body.cuh), fp32 accumulation; P times the v scales is
//     rounded to bf16 and P V runs on m16n8k16 against V's transposed,
//     key-permuted tile (whose byte words are the B fragments of the
//     permuted keys), fp32 accumulation.  Its key tile, 64 cache rows,
//     is the running max's group, as the twin takes it.  O is fp32.
//
// The kernels are in csrc/varlen_paged_quant.cuh; this file instantiates
// them for bf16 q, varlen_paged_quant_f16.cu and _f32.cu for fp16 and fp32.
#include "varlen_paged_quant.cuh"

// kind: 0 = int8, 1 = fp8 (e4m3), 2 = int4; dtype (of q and out): 0 =
// bf16, 1 = fp16, 2 = fp32, any other cudaErrorInvalidValue.  scale is
// softmax_scale; slope_mult and exp2_domain give the TPU kernel's softmax
// domain (base 2 unless softcap is on: ALiBi slopes times slope_mult,
// log2(e) there).  Payload strides in bytes, scale strides in floats.
// Returns cudaGetLastError() of the launch.
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
  switch (dtype) {
    case 0: return launch_quant<__nv_bfloat16>(FA_K8Q_ARGS);
    case 1: return fa::k8q::launch_f16(FA_K8Q_ARGS);
    case 2: return fa::k8q::launch_f32(FA_K8Q_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The occupancy of K8q for (kind, dtype, D), in the variant without bias
// (extra 0) or with (extra 1), without the block table's bytes: out[0]
// resident blocks a multiprocessor, out[1] dynamic shared memory a block
// (bytes), out[2] threads a block, out[3] registers a thread, out[4] local
// memory a thread (bytes: spills and stack).  Returns a cudaError_t.
extern "C" int fa_varlen_paged_quant_occupancy(int kind, int dtype, int D,
                                               int extra, int* out) {
  switch (dtype) {
    case 0: return occupancy_quant<__nv_bfloat16>(kind, D, extra, out);
    case 1: return fa::k8q::occupancy_f16(kind, D, extra, out);
    case 2: return fa::k8q::occupancy_f32(kind, D, extra, out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
