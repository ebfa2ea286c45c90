// K8q's kernels for fp16 q: a translation unit of the varlen_paged_quant
// library, whose entry points are in csrc/varlen_paged_quant.cu; its own
// file so that nvcc compiles the library's q types in parallel.
#include "varlen_paged_quant.cuh"

int fa::k8q::launch_f16(FA_K8Q_PARAMS) {
  return launch_quant<__half>(FA_K8Q_ARGS);
}

int fa::k8q::occupancy_f16(int kind, int D, int extra, int* out) {
  return occupancy_quant<__half>(kind, D, extra, out);
}
