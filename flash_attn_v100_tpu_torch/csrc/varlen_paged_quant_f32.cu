// K8q's kernels for fp32 q: a translation unit of the varlen_paged_quant
// library, whose entry points are in csrc/varlen_paged_quant.cu; its own
// file so that nvcc compiles the library's q types in parallel.
#include "varlen_paged_quant.cuh"

int fa::k8q::launch_f32(FA_K8Q_PARAMS) {
  return launch_quant<float>(FA_K8Q_ARGS);
}

int fa::k8q::occupancy_f32(int kind, int D, int extra, int* out) {
  return occupancy_quant<float>(kind, D, extra, out);
}
