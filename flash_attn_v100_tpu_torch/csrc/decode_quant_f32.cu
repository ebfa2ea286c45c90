// K4q's kernels for fp32 q: a translation unit of the decode_quant
// library, whose entry points are in csrc/decode_quant.cu; its own file so
// that nvcc compiles the library's q types in parallel.
#include "decode_body.cuh"

namespace fa {
namespace dec {
template cudaError_t launch_quant<float>(int, const DecodeArgs&, int,
                                         cudaStream_t);
template cudaError_t occupancy_quant<float>(int, int, int, int*);
}  // namespace dec
}  // namespace fa
