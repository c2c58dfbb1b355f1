// C entry points shared by the kernels' Python wrappers.
#include <cuda_runtime.h>

extern "C" const char* cips_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
