// Per-sequence bookkeeping of the attention kernels: dense (batch row b),
// packed varlen (sequence b), the dense case being the varlen one with
// cu_seqlens = b * M, or paged (sequence b, keys in pages of a pool).  K1,
// K5 and K8 are one forward body instantiated for the three
// (csrc/fwd_body.cuh), K2/K3 and K6/K7 one backward body each
// (csrc/bwd.cu).
//
// A block reads its sequence's row bases and lengths here once, as the
// reference CUDA kernels' BlockInfo does (include/template.h:55-69 of the
// upstream source).  The varlen case is the torch counterpart of
// flash_attn_v100_tpu/ops/pallas/varlen.py::build_ragged_info reduced to one
// sequence:
//     used = min(len_k, seqused_k) if seqused_k > 0 else 0
//     slk  = used - leftpad_k            (live keys, leftpad-relative)
//     offs = slk - len_q                 (bottom-right alignment)
// and the key at leftpad-relative position j is packed row
// cu_k[b] + leftpad_k[b] + j.  The dense case has slq = M, slk = N, the
// caller's offset, q row b * M + i and key row b * N + j.
//
// The paged case (K8, K8q) is flash_attn_v100_tpu/ops/pallas/varlen.py's
// paged rule, which caps the keys at the block table's mp pages:
//     used = min(seqlens_k, seqused_k)
//     slk  = (used > 0 ? min(mp * ps, used) : 0) - leftpad_k
//     offs = slk - len_q
// and the key at leftpad-relative position j is cache row leftpad_k[b] + j
// of the sequence's pages.  It differs from the varlen rule (no cu_k, the
// cap, seqused_k taken as it is), so the two stay apart.
#pragma once

namespace fa {

struct SeqArgs {
  // dense: q rows and keys of every batch row; varlen: max_seqlen_q and
  // max_seqlen_k, which only size the grid
  int M, N;
  int offset;            // dense: key position - offset aligns with q row
  int Tq;                // varlen: packed q rows (the LSE / delta row stride)
  const int* cu_q;       // varlen: (B + 1,) packed q row of each sequence
  const int* cu_k;       // varlen: (B + 1,)
  const int* seqused_k;  // varlen: (B,) or nullptr
  const int* leftpad_k;  // varlen: (B,) or nullptr
};

struct Seq {
  long long q_base;  // packed q row of q position 0
  long long k_base;  // packed k row of key position 0 (paged: cache row)
  long long lse_b;   // LSE / delta index of (head 0, q position 0)
  long long lse_h;   // LSE / delta stride of one head
  int slq, slk, offs;

  __device__ long long lse_index(int h, int qp) const {
    return lse_b + h * lse_h + qp;
  }
};

// LSE and delta are (B, Hq, M) when dense and (Hq, Tq) when varlen
template <bool kVarlen>
__device__ __forceinline__ Seq seq_info(const SeqArgs& s, int b, int Hq) {
  Seq r;
  if constexpr (kVarlen) {
    const int q0 = s.cu_q[b];
    const int k0 = s.cu_k[b];
    int used = s.cu_k[b + 1] - k0;
    if (s.seqused_k) {
      const int u = s.seqused_k[b];
      used = u > 0 ? min(used, u) : 0;
    }
    const int lp = s.leftpad_k ? s.leftpad_k[b] : 0;
    r.slq = s.cu_q[b + 1] - q0;
    r.slk = used - lp;
    r.offs = r.slk - r.slq;
    r.q_base = q0;
    r.k_base = static_cast<long long>(k0) + lp;
    r.lse_b = q0;
    r.lse_h = s.Tq;
  } else {
    r.slq = s.M;
    r.slk = s.N;
    r.offs = s.offset;
    r.q_base = static_cast<long long>(b) * s.M;
    r.k_base = static_cast<long long>(b) * s.N;
    r.lse_b = static_cast<long long>(b) * Hq * s.M;
    r.lse_h = s.M;
  }
  return r;
}

// the paged rule above for sequence b; cap = mp * page_size
__device__ __forceinline__ Seq paged_seq_info(const SeqArgs& s,
                                              const int* seqlens_k, int cap,
                                              int b) {
  Seq r;
  const int q0 = s.cu_q[b];
  int used = seqlens_k[b];
  if (s.seqused_k) used = min(used, s.seqused_k[b]);
  const int lp = s.leftpad_k ? s.leftpad_k[b] : 0;
  r.slq = s.cu_q[b + 1] - q0;
  r.slk = (used > 0 ? min(cap, used) : 0) - lp;
  r.offs = r.slk - r.slq;
  r.q_base = q0;
  r.k_base = lp;
  r.lse_b = q0;
  r.lse_h = s.Tq;
  return r;
}

}  // namespace fa
