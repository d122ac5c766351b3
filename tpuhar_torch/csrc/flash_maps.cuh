// The tensor maps through which the flash kernels (csrc/flash_attn.cu, the forward, and
// csrc/flash_attn_bwd.cu, the dK/dV and dQ kernels) read their (B, H, N, 64) bf16
// operands by TMA, and the f32 dQ and dK/dV kernels (csrc/flash_attn_bwd_f32.cu) their
// f32 ones.
// Host code only.
#pragma once
#include <cuda.h>
#include <stdint.h>

#include "hopper.cuh"

namespace flash_maps {

constexpr int D = 64;  // head_dim: one 128-byte row

// One operand, (B, H, N, 64) with element strides (sb, sh, sn, 1): bf16, or f32 where
// `f32`.
struct Operand {
  const void* base;
  int B, H, N;
  long long sb, sh, sn;
  bool f32 = false;
};
// the dimension with the smaller stride comes first in the map (the (B, N, H*64)
// projections have the heads inside the tokens)
inline bool heads_inner(const Operand& t) { return t.H > 1 && (t.N == 1 || t.sh < t.sn); }

// The tensor map of one operand, read in boxes of `rows` tokens x one 128-byte row of one
// (batch, head): the whole head width in bf16, half of it (32 f32, at head column 0 or
// 32) in f32; tokens past N arrive as zeros. Encoded on every call, about a microsecond
// each.
inline bool operand_map(CUtensorMap* map, const Operand& t, int rows) {
  const bool hi = heads_inner(t);
  const cuuint64_t size = t.f32 ? 4 : 2;
  const cuuint64_t n = t.N, h = t.H, sn = t.sn * size, sh = t.sh * size;
  const cuuint64_t dims[4] = {D, hi ? h : n, hi ? n : h, static_cast<cuuint64_t>(t.B)};
  cuuint64_t strides[3] = {hi ? sh : sn, hi ? sn : sh, static_cast<cuuint64_t>(t.sb) * size};
  // a dimension of one element is never stepped over: give it the packed stride, whatever
  // the view says
  cuuint64_t packed = D * size;
  for (int i = 0; i < 3; ++i) {
    if (dims[i + 1] == 1) strides[i] = packed;
    packed = strides[i] * dims[i + 1];
  }
  const cuuint32_t r = rows;
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(128 / size), hi ? 1 : r, hi ? r : 1, 1};
  return hopper::encode_tensor_map(
      map, t.f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, t.base, 4, dims, strides, box);
}

}  // namespace flash_maps
