// Kernels by name, for tpuhar_kernel_attributes (csrc/status.cu), which reads their
// compiled attributes (registers, spills, shared memory) at the card's checks: each table
// is defined in the source of its kernels.
#pragma once

namespace tpuhar_kernels {

struct Entry {
  const char* name;
  const void* fn;  // the kernel, as cudaFuncGetAttributes takes it
};

extern const Entry flash_attn_f32[2];      // csrc/flash_attn_f32.cu: the forward, without and with its LSE
extern const Entry flash_attn_bwd_f32[2];  // csrc/flash_attn_bwd_f32.cu: dQ, dK/dV

}  // namespace tpuhar_kernels
