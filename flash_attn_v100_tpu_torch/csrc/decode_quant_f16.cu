// K4q's kernels for fp16 q: a translation unit of the decode_quant
// library, whose entry points are in csrc/decode_quant.cu; its own file so
// that nvcc compiles the library's q types in parallel.
#include "decode_body.cuh"

namespace fa {
namespace dec {
template cudaError_t launch_quant<__half>(int, const DecodeArgs&, int,
                                          cudaStream_t);
template cudaError_t occupancy_quant<__half>(int, int, int, int*);
}  // namespace dec
}  // namespace fa
