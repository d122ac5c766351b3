// Fused 3x3 SAME conv + folded BatchNorm + residual + ReLU on Hopper (sm_90a), f32, on the
// TF32 tensor cores in split precision ("3xTF32").
//
// Replaces the TPU kernel tpuhar/ops/conv3x3.py: conv3x3_bn_act (body _kernel) for f32
// operands, which that kernel also takes (tpuhar/ops/conv3x3.py:97-114, :197):
//   out = act(conv3x3_same(x) * scale + bias [+ residual])
// on NHWC planes x (N, S, S, C) f32, scale/bias (C_out,) f32, residual and out (N, S, S,
// C_out) f32. Any C and C_out. An f32 tower runs it: f32 serving of the tpu_cnn flagship,
// and the f32 program an int8 engine recalibrates its logits against.
//
// Arithmetic (csrc/split_tf32.cuh, shared with the f32 flash dK/dV kernel). Each f32
// operand v is split into two TF32 values, hi = v rounded to TF32 and lo = v - hi rounded
// the same way (ops/conv3x3.split_tf32 is the same split in torch). The kernel
// accumulates lo_a*hi_b + hi_a*lo_b + hi_a*hi_b in f32 on the tensor cores and drops
// lo_a*lo_b (2^-22 of the product), so the sum carries the error of an f32 sum and not
// TF32's three decimal digits: the tensor cores keep the f32 function at three times the
// operations.
//
// What bounds it: operations. At batch 256 (4096 frames) each 14x14x256 and 7x7x512 conv
// is 2*M*K*N = 0.947 TFLOP of f32 products, 2.84 TFLOP of TF32 ones: 5.74 ms at the card's
// dense TF32 rate (495 TFLOP/s; 165 TFLOP/s of f32 work), against 0.74 / 0.37 ms for the
// bytes of x, weights, residual and out. The FFMA pipes would need 14.1 ms.
//
// Design: the implicit GEMM of csrc/conv3x3.cu with f32 operands. Rows are M = N*S*S
// output pixels, K is 9 taps x C_pad (C rounded up to 32), columns are C_out. A block owns
// 128 rows x 128 channels (half the bf16 kernel's 256: f32 operands and two weight halves
// take four times the bytes a channel) and runs three warpgroups:
//  - one producer (registers cut to 40 by setmaxnreg) fills a ring of four 48 KB stages.
//    A stage holds one K chunk (one tap, 32 channels: one 128-byte row of f32 a pixel):
//    A, the 128 tap-shifted rows of x, and B_hi and B_lo, the 128 x 32 slices of the two
//    weight halves, all in the 128-byte swizzle. 32-bit wgmma has no transpose bit, so
//    both operands are K-major: the wrapper repacks the HWIO weights once a call into two
//    zero-padded K-major (C_out_pad, 9*C_pad) matrices (ops/conv3x3.pack_conv3x3_f32),
//    and B_hi and B_lo come by TMA, one 16 KB box each with no ragged edge. A is gathered
//    by all 128 threads with 16-byte cp.async (4-byte copies where C is not a multiple
//    of 4): a row whose tap falls off the plane, the rows of a ragged last tile and the
//    channels past C are zero-filled, so SAME padding is exact with no padded copy of x.
//    Both copies arrive on the stage's "full" mbarrier by themselves, so the producer
//    runs the ring's full depth ahead.
//  - two consumers own 64 rows each. A consumer loads its 64 A rows of a stage from
//    shared memory into registers (the RS operand layout, one 4-byte load an element,
//    conflict-free under the swizzle), splits them there, and issues the three products
//    of each of the four k-steps as wgmma m64n128k8 tf32 with A in registers and B_lo or
//    B_hi from shared memory, small terms first. The registers of A must not change while
//    a wgmma reads them, so each stage's products are waited for before the next stage's
//    A is loaded; the other consumer's products keep the tensor cores busy meanwhile.
//    Each stage's twelve products land in a fresh accumulator that is then added to the
//    running sum in f32 registers (round to nearest), so the tensor cores' own
//    accumulation spans one K chunk of 32 and not the whole of K.
//  - epilogue: straight from the accumulators; the residual's loads all issued first;
//    scale, bias, residual and ReLU in f32; each quad of threads stores 32 bytes of a row
//    (a whole sector), two floats a thread.
// One block per SM (193 KB of shared memory), one block a tile. Measured slower on an H100
// (4096 frames, 14x14x256 and 7x7x512): the next stage's A split while one stage's
// products are in flight (two register sets; ptxas serialized every wgmma), the two
// consumers taking turns to issue, and a cluster of two blocks along M that share B by
// TMA multicast (12.5 against 8.2 ms: both blocks' stages then wait on one barrier).
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "split_tf32.cuh"

using namespace hopper;
using tf32x3::split_in_place;

namespace {

constexpr int BM = 128;  // output rows (pixels) per block: 64 per consumer warpgroup
constexpr int BN = 128;  // output channels per block
constexpr int BK = 32;   // input channels per K chunk (within one tap): one 128-byte row
constexpr int STAGES = 4;
constexpr int THREADS = 384;
constexpr int A_BYTES = BM * BK * 4;
constexpr int B_BYTES = BN * BK * 4;  // each half
constexpr int STAGE_BYTES = A_BYTES + 2 * B_BYTES;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024;  // + room to align to 1024

__global__ void __launch_bounds__(THREADS, 1)
conv3x3_bn_act_f32_kernel(const float* __restrict__ x, const float* __restrict__ scale,
                          const float* __restrict__ bias, const float* __restrict__ res,
                          float* __restrict__ out, int M, int S, int C, int C_pad, int C_out,
                          int n_tiles, int relu, int vec_x, int vec_out,
                          const __grid_constant__ CUtensorMap w_hi_map,
                          const __grid_constant__ CUtensorMap w_lo_map) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full_bar[STAGES], empty_bar[STAGES];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t smem_base = smem_addr(smem);

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  // neighbouring blocks share a row tile, so its second read of x finds it in L2
  const int m0 = (blockIdx.x / n_tiles) * BM;
  const int n0 = (blockIdx.x % n_tiles) * BN;
  const int k_chunks = C_pad / BK;
  const int steps = 9 * k_chunks;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full_bar[s], 128 + 1);  // every producer thread, and the TMA's issuer
      mbar_init(&empty_bar[s], 8);       // lane 0 of every consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    // ------------------------------- producer -------------------------------------
    reg_dealloc<40>();
    const int pt = tid - 256;
    const int chunk = pt & 7;  // this thread's 16-byte chunk (4 channels) of every row
    const int row0 = pt >> 3;  // A rows row0 + 16 i
    const uint32_t swz = static_cast<uint32_t>((chunk ^ (row0 & 7)) << 4);

    // nine tap-validity bits for each of this thread's 8 A rows, three rows a register
    uint32_t valid[3] = {0u, 0u, 0u};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = m0 + row0 + 16 * i;
      if (m < M) {
        const int rem = m % (S * S);
        const int y = rem / S, xx = rem % S;
        uint32_t bits = 0;
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          const int yy = y + tap / 3 - 1, xt = xx + tap % 3 - 1;
          if (yy >= 0 && yy < S && xt >= 0 && xt < S) bits |= 1u << tap;
        }
        valid[i / 3] |= bits << (9 * (i % 3));
      }
    }
    const float* a_src = x + static_cast<long long>(m0 + row0) * C + chunk * 4;
    const long long a_step = 16ll * C;

    for (int it = 0; it < steps; ++it) {
      const int s = it % STAGES;
      mbar_wait(&empty_bar[s], ((it / STAGES) & 1) ^ 1);
      const int tap = it / k_chunks;
      const int c0 = (it - tap * k_chunks) * BK;
      const int dy = tap / 3 - 1, dx = tap - (tap / 3) * 3 - 1;
      const uint32_t stage = smem_base + s * STAGE_BYTES;
      if (pt == 0) {
        mbar_arrive_expect_tx(&full_bar[s], 2 * B_BYTES);
        tma_load_2d(stage + A_BYTES, &w_hi_map, &full_bar[s], tap * C_pad + c0, n0);
        tma_load_2d(stage + A_BYTES + B_BYTES, &w_lo_map, &full_bar[s], tap * C_pad + c0, n0);
      }
      const uint32_t a_dst = stage + row0 * 128 + swz;
      const float* a = a_src + static_cast<long long>(dy * S + dx) * C + c0;
      const int c = c0 + chunk * 4;  // this chunk's first channel
      if (vec_x) {  // C % 4 == 0: the chunk's four channels are all in x or all past C
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const bool ok = c < C && ((valid[i / 3] >> (9 * (i % 3) + tap)) & 1u);
          cp_async16(a_dst + i * 16 * 128, ok ? a + i * a_step : x, ok);
        }
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const bool row_ok = (valid[i / 3] >> (9 * (i % 3) + tap)) & 1u;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const bool ok = row_ok && c + j < C;
            cp_async4(a_dst + i * 16 * 128 + 4 * j, ok ? a + i * a_step + j : x, ok);
          }
        }
      }
      cp_async_arrive(&full_bar[s]);
    }
  } else {
    // ------------------------------- consumers ------------------------------------
    reg_alloc<232>();
    float acc[BN / 2], part[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = part[i] = 0.f;
    const int lane = tid & 31;
    const int r0 = 16 * ((tid & 127) >> 5) + (lane >> 2);  // this thread's first A row
    for (int it = 0; it < steps; ++it) {
      const int s = it % STAGES;
      mbar_wait(&full_bar[s], (it / STAGES) & 1);
      const uint8_t* a_rows = smem + s * STAGE_BYTES + wg * (64 * 128);
      const uint32_t b_hi = smem_base + s * STAGE_BYTES + A_BYTES;
      const uint32_t b_lo = b_hi + B_BYTES;
      uint32_t a_hi[BK / 8][4], a_lo[BK / 8][4];
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          a_hi[kk][e] = *reinterpret_cast<const uint32_t*>(
              a_rows + (r0 + 8 * (e & 1)) * 128 + (((2 * kk + (e >> 1)) ^ (r0 & 7)) << 4) +
              4 * (lane & 3));
      split_in_place(a_hi, a_lo);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk) {
        // B: a k-step is 32 bytes along the 128-byte rows of the K-major tile
        const uint64_t d_hi = wgmma_desc(b_hi + kk * 32, 16, 1024);
        const uint64_t d_lo = wgmma_desc(b_lo + kk * 32, 16, 1024);
        wgmma_m64n128k8_rs_tf32(part, a_lo[kk], d_hi, kk != 0);
        wgmma_m64n128k8_rs_tf32(part, a_hi[kk], d_lo, 1);
        wgmma_m64n128k8_rs_tf32(part, a_hi[kk], d_hi, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(&empty_bar[s]);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] += part[i];
    }

    // -------------------------------- epilogue ------------------------------------
    // accumulator layout: for each 8-column group j, acc[4j], acc[4j+1] are row r0,
    // columns 8j + 2(lane%4), +1, and acc[4j+2], acc[4j+3] the same columns of row r0 + 8.
    // The residual comes first, all of its loads in flight at once, into the registers
    // that held each stage's products.
    const int row = m0 + wg * 64 + r0;
    if (res != nullptr) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int n = n0 + j * 8 + 2 * (lane & 3);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = row + 8 * h;
          const long long at = static_cast<long long>(m) * C_out + n;
          float2 rr = make_float2(0.f, 0.f);
          if (m < M && n < C_out) {
            if (vec_out) {  // C_out even and the pointers 8-byte aligned: n + 1 < C_out
              rr = __ldg(reinterpret_cast<const float2*>(res + at));
            } else {
              rr.x = __ldg(res + at);
              if (n + 1 < C_out) rr.y = __ldg(res + at + 1);
            }
          }
          part[4 * j + 2 * h] = rr.x;
          part[4 * j + 2 * h + 1] = rr.y;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = n0 + j * 8 + 2 * (lane & 3);
      if (n >= C_out) continue;
      const bool two = n + 1 < C_out;
      const float sc0 = __ldg(scale + n), bi0 = __ldg(bias + n);
      const float sc1 = two ? __ldg(scale + n + 1) : 0.f, bi1 = two ? __ldg(bias + n + 1) : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = row + 8 * h;
        if (m >= M) continue;
        const long long at = static_cast<long long>(m) * C_out + n;
        float v0 = acc[4 * j + 2 * h] * sc0 + bi0;
        float v1 = acc[4 * j + 2 * h + 1] * sc1 + bi1;
        if (res != nullptr) {
          v0 += part[4 * j + 2 * h];
          v1 += part[4 * j + 2 * h + 1];
        }
        if (relu) {
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
        }
        if (vec_out) {
          *reinterpret_cast<float2*>(out + at) = make_float2(v0, v1);
        } else {
          out[at] = v0;
          if (two) out[at + 1] = v1;
        }
      }
    }
  }
}

}  // namespace

// x, scale, bias, residual and out as above; w_hi and w_lo the two (C_out_pad, 9*C_pad)
// halves of the weights, C_pad = C rounded up to 32, C_out_pad = C_out rounded up to 128
// (ops/conv3x3.pack_conv3x3_f32)
extern "C" int tpuhar_conv3x3_bn_act_f32_split(const void* x, const void* w_hi, const void* w_lo,
                                               const void* scale, const void* bias,
                                               const void* residual, void* out, int M, int S,
                                               int C, int C_out, int relu, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_bn_act_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (M <= 0 || S <= 0 || C <= 0 || C_out <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int C_pad = (C + BK - 1) / BK * BK;
  const int n_tiles = (C_out + BN - 1) / BN;
  const long long blocks = static_cast<long long>((M + BM - 1) / BM) * n_tiles;
  if (blocks > 0x7fffffffll) return static_cast<int>(cudaErrorInvalidValue);
  // each half as a (C_out_pad, 9*C_pad) matrix, read in boxes of 128 rows x 32 K values
  // (128 bytes) that land in the 128-byte swizzle
  CUtensorMap maps[2];
  const void* halves[2] = {w_hi, w_lo};
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(9) * C_pad, static_cast<cuuint64_t>(n_tiles) * BN};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(9) * C_pad * 4};
  const cuuint32_t box[2] = {BK, BN};
  for (int i = 0; i < 2; ++i)
    if (!encode_tensor_map(&maps[i], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, halves[i], 2, dims, strides, box))
      return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x), oa = reinterpret_cast<uintptr_t>(out),
                  ra = reinterpret_cast<uintptr_t>(residual);
  const int vec_x = C % 4 == 0 && xa % 16 == 0;
  const int vec_out = C_out % 2 == 0 && oa % 8 == 0 && ra % 8 == 0;
  conv3x3_bn_act_f32_kernel<<<static_cast<unsigned>(blocks), THREADS, SMEM_BYTES,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<const float*>(residual),
      static_cast<float*>(out), M, S, C, C_pad, C_out, n_tiles, relu, vec_x, vec_out, maps[0],
      maps[1]);
  return static_cast<int>(cudaGetLastError());
}
