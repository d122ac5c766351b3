// Error text for the status codes the kernel entry points return.
#include <cuda_runtime.h>

extern "C" const char* tpuhar_cuda_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
