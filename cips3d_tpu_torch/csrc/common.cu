// C entry points shared by the kernels' Python wrappers.
#include <cuda_runtime.h>

extern "C" const char* cips_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

namespace {

// The device's clock in nanoseconds when the stream reaches this launch.
__global__ void stamp_kernel(unsigned long long* out) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  *out = t;
}

}  // namespace

// Write the device's clock into one int64 of device memory, on `stream`
// (`utils/trace.py`'s phases); a stream that captures a CUDA graph records
// the launch, and every replay writes the clock again.
extern "C" int cips_stamp(void* out, void* stream) {
  stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(out));
  return static_cast<int>(cudaGetLastError());
}
