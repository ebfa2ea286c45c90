// Position-keyed dropout bits on the device: Philox-4x32-10 on native
// uint32, bit-equal to flash_attn_v100_tpu_torch/ops/philox.py and
// flash_attn_v100_tpu/ops/philox.py.
//
// One Philox word per absolute ROW and one per absolute COLUMN of a
// (batch, head) slice (bh = batch * num_heads + head), XORed per element and
// passed through a one-multiply finalizer; an element is kept where its word
// is <= the keep threshold.  A kernel computes the row and column words of
// its tile once (O(rows + cols) Philox calls) and combines them per element.
#pragma once

#include <stdint.h>

namespace fa {

constexpr uint32_t kPhiloxMA = 0xD2511F53u;
constexpr uint32_t kPhiloxMB = 0xCD9E8D57u;
constexpr uint32_t kKeyStepA = 0x9E3779B9u;
constexpr uint32_t kKeyStepB = 0xBB67AE85u;
constexpr uint32_t kRowDomain = 0x524F5753u;
constexpr uint32_t kColDomain = 0x434F4C53u;

struct DropoutParams {
  uint32_t seed_lo, seed_hi;
  uint32_t threshold;   // keep <=> bits <= threshold
  float scale;          // 1 / (1 - p)
  int enabled;
  int q0, k0, b0, h0;   // position bases (sequence/head-sharded callers)
  int num_heads;        // heads of the global problem (bh stride)
};

// first output word of Philox-4x32-10
__device__ __forceinline__ uint32_t philox_x(uint32_t c0, uint32_t c1,
                                             uint32_t c2, uint32_t c3,
                                             uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const uint32_t lo0 = kPhiloxMA * c0, hi0 = __umulhi(kPhiloxMA, c0);
    const uint32_t lo1 = kPhiloxMB * c2, hi1 = __umulhi(kPhiloxMB, c2);
    const uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
    k0 += kKeyStepA;
    k1 += kKeyStepB;
  }
  return c0;
}

__device__ __forceinline__ uint32_t dropout_row_word(int row, uint32_t bh,
                                                     const DropoutParams& d) {
  return philox_x(static_cast<uint32_t>(row), bh, kRowDomain, 0u, d.seed_lo,
                  d.seed_hi);
}

__device__ __forceinline__ uint32_t dropout_col_word(int col, uint32_t bh,
                                                     const DropoutParams& d) {
  return philox_x(static_cast<uint32_t>(col), bh, kColDomain, 1u, d.seed_lo,
                  d.seed_hi);
}

__device__ __forceinline__ bool dropout_keep(uint32_t row_word,
                                             uint32_t col_word,
                                             const DropoutParams& d) {
  uint32_t x = row_word ^ col_word;
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  return x <= d.threshold;
}

// bh of local (b, h) in the global problem
__device__ __forceinline__ uint32_t dropout_bh(int b, int h,
                                               const DropoutParams& d) {
  return static_cast<uint32_t>((b + d.b0) * d.num_heads + (h + d.h0));
}

}  // namespace fa
