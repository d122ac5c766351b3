// The epilogue of the int8 kernels (csrc/conv3x3_i8.cu, csrc/stem_u8.cu): one consumer
// warpgroup's 64 x 256 tile of s32 accumulators, in wgmma's layout (hopper.cuh), becomes
//   v   = acc * scale + bias [+ res * res_scale]        (f32, per output channel n)
//   v   = relu ? max(v, 0) : v
//   out = int8_out ? clip(rint(v / out_scale), -127, 127) : v
// with every multiply and add rounded on its own (the _rn intrinsics, never contracted
// into an FMA) in the plain PyTorch versions' order, and the requant equal to the one
// with a correctly rounded division (requant below), so the result is bit for bit theirs.
//
// The tile goes out in PARTS parts of 256 / PARTS channels, one after the other through
// the same free shared memory (PARTS = 2 halves what a kernel must keep free beside its
// ring). For each part the accumulators first go to shared memory as they lie, which
// frees their registers; then thread (t / 16, t % 16) of the warpgroup takes rows
// t / 16 + 8 i and the channels 64 k + 4 (t % 16) .. +3 of the part: it loads their scale
// and bias once, and each row is up to 16 independent chains whose residual comes in, and
// whose result goes out, by coalesced loads and stores straight to device memory. A
// division per element, with its rare slow path a branch of its own, would cut each row
// into one basic block per element and leave the warps waiting on latency.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace epilogue_i8 {

constexpr int TILE_N = 256;
// staged s32 row pitch of a part: a half warp's 8-byte writes land on distinct banks
template <int PARTS>
__host__ __device__ constexpr int acc_pitch() { return TILE_N / PARTS * 4 + 32; }
// free shared memory one warpgroup's tile needs
template <int PARTS>
__host__ __device__ constexpr int smem_bytes() { return 64 * acc_pitch<PARTS>(); }
// 1.5 * 2^23: for |q| <= 2^22, q + MAGIC rounds q to an integer n (ties to even) and
// holds it in its low mantissa bits: the bit pattern is MAGIC_BITS + n, whose low byte is
// n as an int8 for |n| <= 127; MAGIC_BITS + b is the bit pattern of MAGIC + b
constexpr float MAGIC = 12582912.f;
constexpr int MAGIC_BITS = 0x4B400000;

// clip(rint(v / s), -127, 127) in the low byte, with inv = RN(1 / s), unless `hazard` is
// set. As the bounds are integers, clip(rint(x)) = rint(clip(x)). The product
// RN(v * inv) is within 2^-23 |v / s| + 2^-24 |v / s| of RN(v / s), and clipping to
// [-127, 127] keeps the two within 2.3e-5 of each other, so they round to the same
// integer unless the clipped product q lies within 6e-5 of a half-integer: then `hazard`
// is set and the caller divides.
__device__ __forceinline__ uint32_t requant(float v, float inv, bool& hazard) {
  const float q = fminf(fmaxf(__fmul_rn(v, inv), -127.f), 127.f);
  const float t = __fadd_rn(q, MAGIC);
  hazard |= fabsf(__fsub_rn(q, __fsub_rn(t, MAGIC))) > 0.5f - 6e-5f;  // exact |q - rint(q)|
  return __float_as_uint(t);
}
// the low bytes of four words, in order
__device__ __forceinline__ uint32_t pack_low_bytes(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

// byte e of w as a signed int8, in f32 (exact)
__device__ __forceinline__ float byte_f32(uint32_t w, int e) {
  return __fsub_rn(__int_as_float(MAGIC_BITS + (static_cast<int>(w << (24 - 8 * e)) >> 24)), MAGIC);
}

// Part PART of rows m0 .. m0 + 63 of out (M, C_out): channels n0 .. n0 + W - 1 with
// W = 256 / PARTS, accumulator columns PART * W .. + W - 1. Rows past M and channels past
// C_out (C_out % 32 == 0) are not stored. `smem` holds smem_bytes<PARTS>() of shared
// memory no other warpgroup touches; `bar_id` is a named barrier of this warpgroup's 128
// threads.
template <int PARTS, int PART>
__device__ __forceinline__ void store_part(const int (&acc)[128], uint8_t* smem, int bar_id, int m0,
                                           int n0, int M, int C_out,
                                           const float* __restrict__ scale,
                                           const float* __restrict__ bias,
                                           const int8_t* __restrict__ res, float res_scale,
                                           int relu, int int8_out, float out_scale,
                                           void* __restrict__ out) {
  constexpr int J = TILE_N / 8 / PARTS;  // 8-column groups of accumulators in the part
  constexpr int K = 4 / PARTS;           // 64-channel groups of the part
  constexpr int E = 4 * K;               // channels a thread takes in each row
  constexpr int PITCH = acc_pitch<PARTS>();
  const int t = threadIdx.x & 127;
  hopper::bar_sync(bar_id, 128);  // the last part's rows have been read
  {
    const int lane = t & 31;
    const int r = (t >> 5) * 16 + (lane >> 2);
    const int col0 = 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<int2*>(smem + (r + 8 * h) * PITCH + (8 * j + col0) * 4) =
            make_int2(acc[4 * (j + J * PART) + 2 * h], acc[4 * (j + J * PART) + 2 * h + 1]);
  }
  hopper::bar_sync(bar_id, 128);

  const int tc = t & 15, tr = t >> 4;
  float sc[E], bi[E];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int n = n0 + 64 * k + 4 * tc;  // C_out % 32 == 0: n < C_out means n + 3 < C_out
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f), b = s;
    if (n < C_out) {
      s = __ldg(reinterpret_cast<const float4*>(scale + n));
      b = __ldg(reinterpret_cast<const float4*>(bias + n));
    }
    sc[4 * k] = s.x, sc[4 * k + 1] = s.y, sc[4 * k + 2] = s.z, sc[4 * k + 3] = s.w;
    bi[4 * k] = b.x, bi[4 * k + 1] = b.y, bi[4 * k + 2] = b.z, bi[4 * k + 3] = b.w;
  }
  const float inv = __frcp_rn(out_scale);
#pragma unroll 2
  for (int i = 0; i < 8; ++i) {
    const int row = tr + 8 * i;
    const long long m = m0 + row;
    if (m >= M) continue;
    float v[E];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int4 a = *reinterpret_cast<const int4*>(smem + row * PITCH + (64 * k + 4 * tc) * 4);
      const int av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[4 * k + e] = __fadd_rn(__fmul_rn(__int2float_rn(av[e]), sc[4 * k + e]), bi[4 * k + e]);
    }
    if (res != nullptr) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int n = n0 + 64 * k + 4 * tc;
        const uint32_t w = n < C_out ? __ldg(reinterpret_cast<const uint32_t*>(res + m * C_out + n)) : 0u;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          v[4 * k + e] = __fadd_rn(v[4 * k + e], __fmul_rn(byte_f32(w, e), res_scale));
      }
    }
    if (relu) {
#pragma unroll
      for (int e = 0; e < E; ++e) v[e] = fmaxf(v[e], 0.f);
    }
    if (int8_out) {
      uint32_t q[E];
      bool hazard = false;
#pragma unroll
      for (int e = 0; e < E; ++e) q[e] = requant(v[e], inv, hazard);
      if (hazard) {  // about one row of 16 in 600 on uniform data
#pragma unroll
        for (int e = 0; e < E; ++e)
          q[e] = static_cast<uint32_t>(min(max(__float2int_rn(__fdiv_rn(v[e], out_scale)), -127), 127));
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int n = n0 + 64 * k + 4 * tc;
        if (n < C_out)
          *reinterpret_cast<uint32_t*>(static_cast<int8_t*>(out) + m * C_out + n) =
              pack_low_bytes(q[4 * k], q[4 * k + 1], q[4 * k + 2], q[4 * k + 3]);
      }
    } else {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int n = n0 + 64 * k + 4 * tc;
        if (n < C_out)
          *reinterpret_cast<float4*>(static_cast<float*>(out) + m * C_out + n) =
              make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
      }
    }
  }
}

// the whole 64 x 256 tile, channels n0 .. n0 + 255, in PARTS parts
template <int PARTS>
__device__ __forceinline__ void store_tile(const int (&acc)[128], uint8_t* smem, int bar_id, int m0,
                                           int n0, int M, int C_out,
                                           const float* __restrict__ scale,
                                           const float* __restrict__ bias,
                                           const int8_t* __restrict__ res, float res_scale,
                                           int relu, int int8_out, float out_scale,
                                           void* __restrict__ out) {
  static_assert(PARTS == 1 || PARTS == 2, "the tile goes out whole or in halves");
  store_part<PARTS, 0>(acc, smem, bar_id, m0, n0, M, C_out, scale, bias, res, res_scale, relu,
                       int8_out, out_scale, out);
  if constexpr (PARTS == 2)
    store_part<PARTS, 1>(acc, smem, bar_id, m0, n0 + TILE_N / 2, M, C_out, scale, bias, res,
                         res_scale, relu, int8_out, out_scale, out);
}

}  // namespace epilogue_i8
