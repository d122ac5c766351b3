// Error text for the status codes the kernel entry points return, and the compiled
// attributes of the kernels named in csrc/kernel_table.cuh.
#include <cuda_runtime.h>
#include <string.h>

#include "kernel_table.cuh"

extern "C" const char* tpuhar_cuda_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

// out[0..3] = registers a thread, local (spill) bytes a thread, static shared memory and
// the dynamic shared-memory limit (as the entry point last set it) of the kernel `name`;
// returns -1 for a name no table holds, else the CUDA status of cudaFuncGetAttributes
extern "C" int tpuhar_kernel_attributes(const char* name, int* out) {
  const tpuhar_kernels::Entry* tables[] = {tpuhar_kernels::flash_attn_f32, tpuhar_kernels::flash_attn_bwd_f32};
  for (const tpuhar_kernels::Entry* table : tables)
    for (int i = 0; i < 2; ++i) {
      if (strcmp(table[i].name, name) != 0) continue;
      cudaFuncAttributes attr;
      const cudaError_t err = cudaFuncGetAttributes(&attr, table[i].fn);
      if (err != cudaSuccess) return static_cast<int>(err);
      out[0] = attr.numRegs;
      out[1] = static_cast<int>(attr.localSizeBytes);
      out[2] = static_cast<int>(attr.sharedSizeBytes);
      out[3] = attr.maxDynamicSharedSizeBytes;
      return 0;
    }
  return -1;
}
