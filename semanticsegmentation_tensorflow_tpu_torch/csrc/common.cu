// Shared C entry of the kernel library: readable CUDA error names for the
// Python wrappers, which raise when a launch returns a non-zero code.

#include <cuda_runtime.h>

extern "C" const char* seg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
