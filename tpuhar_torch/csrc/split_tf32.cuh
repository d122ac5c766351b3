// The split of f32 values into two TF32 values on which the split-TF32 ("3xTF32") wgmma
// kernels run their f32 products: csrc/conv3x3_f32.cu (split_in_place) and the dQ and
// dK/dV kernels of csrc/flash_attn_bwd_f32.cu (split_raw_lo).
//
// hi = v rounded to TF32 (nearest, ties away from zero) and lo = v - hi rounded the same
// way, so that |v - hi - lo| <= 2^-22 |v| (ops/conv3x3.split_tf32 is the same split in
// torch; a value that would round to inf is cut instead, and inf and NaN keep their
// class). A kernel accumulates lo_a*hi_b + hi_a*lo_b + hi_a*hi_b in f32 on the tensor
// cores and drops lo_a*lo_b (2^-22 of the product): a TF32 product has 11 x 11
// significant bits, exact in f32, so the sum carries the error of an f32 sum.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32x3 {

// v rounded to TF32 at bit 13, to nearest with ties away from zero (an add on the
// magnitude's bits); inf keeps its bits, a NaN stays a NaN in its top 19 bits, and a
// finite value that would round to inf is cut instead
__device__ __forceinline__ uint32_t tf32_round(uint32_t u) {
  if ((u & 0x7F800000u) == 0x7F800000u) return (u & 0x007FFFFFu) ? ((u | 0x00400000u) & 0xFFFFE000u) : u;
  const uint32_t r = (u + 0x1000u) & 0xFFFFE000u;
  return (r & 0x7F800000u) == 0x7F800000u ? (u & 0xFFFFE000u) : r;
}

// v = hi + lo + (at most 2^-22 |v|); lo is 0 for inf and NaN
__device__ __forceinline__ void split_tf32(uint32_t u, uint32_t& hi, uint32_t& lo) {
  hi = tf32_round(u);
  lo = (u & 0x7F800000u) == 0x7F800000u
           ? 0u
           : tf32_round(__float_as_uint(__fsub_rn(__uint_as_float(u), __uint_as_float(hi))));
}

// the same split where |v| < 0x7F7FF000 (finite, and rounding stays finite): two adds
// and two ands on the bits and one f32 subtraction
__device__ __forceinline__ void split_tf32_finite(uint32_t u, uint32_t& hi, uint32_t& lo) {
  hi = (u + 0x1000u) & 0xFFFFE000u;
  lo = (__float_as_uint(__fsub_rn(__uint_as_float(u), __uint_as_float(hi))) + 0x1000u) & 0xFFFFE000u;
}

// Splits the f32 bit patterns of `v` in place into their TF32 halves: v becomes hi, lo
// the rest. The split is most of a consumer's instructions, so the full recipe runs only
// for a thread that holds a value near f32's top, inf or NaN.
template <int R, int C>
__device__ __forceinline__ void split_in_place(uint32_t (&v)[R][C], uint32_t (&lo)[R][C]) {
  uint32_t top = 0;  // the largest magnitude's bits among this thread's values
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int e = 0; e < C; ++e) top = max(top, v[i][e] & 0x7FFFFFFFu);
  if (top < 0x7F7FF000u) {
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int e = 0; e < C; ++e) split_tf32_finite(v[i][e], v[i][e], lo[i][e]);
  } else {
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int e = 0; e < C; ++e) split_tf32(v[i][e], v[i][e], lo[i][e]);
  }
}

// The split where lo is not rounded: a TF32 operand is read from the top 19 bits of its
// register or shared-memory word, so lo = v - hi (exact in f32) goes in as it is, and the
// tensor cores read it as TF32, which leaves |v - hi - lo_read| < 2^-21 |v| (against 2^-22
// for the rounded lo): three operations a value against five. This form takes values
// below 0x7F7FF000 (finite, and rounding stays finite); elsewhere hi or lo may come out
// inf or NaN.
template <int R, int C>
__device__ __forceinline__ void split_raw_lo_finite(uint32_t (&v)[R][C], uint32_t (&lo)[R][C]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int e = 0; e < C; ++e) {
      const uint32_t hi = (v[i][e] + 0x1000u) & 0xFFFFE000u;
      lo[i][e] = __float_as_uint(__fsub_rn(__uint_as_float(v[i][e]), __uint_as_float(hi)));
      v[i][e] = hi;
    }
}

// the same for any values: the full recipe (split_tf32) for a thread that holds a value
// near f32's top, inf or NaN
template <int R, int C>
__device__ __forceinline__ void split_raw_lo(uint32_t (&v)[R][C], uint32_t (&lo)[R][C]) {
  uint32_t top = 0;
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int e = 0; e < C; ++e) top = max(top, v[i][e] & 0x7FFFFFFFu);
  if (top < 0x7F7FF000u) {
    split_raw_lo_finite(v, lo);
  } else {
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int e = 0; e < C; ++e) split_tf32(v[i][e], v[i][e], lo[i][e]);
  }
}

}  // namespace tf32x3
