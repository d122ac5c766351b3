// Fused int8 3x3 conv on Hopper (sm_90a), int8 tensor cores through wgmma.
//
// The int8 form of the TPU kernel tpuhar/ops/conv3x3.py: conv3x3_bn_act, and what XLA
// ran for ops/quant.py: int8_conv in the int8 tpu_cnn tower (down1 and every residual
// conv) and in the int8 ResNet-18 (its 16 3x3 convs):
//   acc = conv3x3(x, w, stride, pad_lo)               (int8 x int8, int32 accumulate)
//   y   = acc * scale + bias [+ res * res_scale]      (f32, scale = x_scale * w_scale)
//   y   = relu ? max(y, 0) : y
//   out = int8_out ? clip(rint(y / out_scale), -127, 127) : y
// on NHWC int8 x (N, S, S, C), weights (C_out, 9*C) (the HWIO kernel reshaped to
// (9*C, C_out) and transposed, so that each output channel's K run is contiguous),
// scale/bias (C_out,) f32, residual (N, So, So, C_out) int8, out (N, So, So, C_out)
// int8 or f32, So = ceil(S / stride). The source pixel of output (yo, xo) and tap
// (dy, dx) is (yo*stride + dy - pad_lo, xo*stride + dx - pad_lo): XLA's SAME split
// (pad_lo = 1 at stride 1, 0 at stride 2 on an even plane) or an explicit pad, such as
// ResNet-18's (1, 1) at stride 2 (the wrapper takes a pad only where it gives So
// outputs a side). The sums are exact in int32: |acc| <= 4608 * 127^2 < 2^31.
//
// What bounds it: operations. At batch 256 (4096 frames) a 14x14x256 conv is 0.95 TOP
// against about 0.4 GB of x, weights, residual and out: at the card's int8 peak the
// products take 0.48 ms, the bytes 0.12 ms. What competes with the tensor cores is the
// operand traffic from L2: the nine taps read x nine times and every 128-row tile reads
// all the weights (576 KB at C = 256).
//
// Design: the implicit GEMM of csrc/conv3x3.cu in int8. Rows are M = N*So*So output
// pixels, K is 9 taps x C, columns are C_out. A block owns 128 rows x 256 channels and
// runs three warpgroups:
//  - one producer (registers cut to 40 by setmaxnreg) fills a ring of four 48 KB stages
//    in dynamic shared memory. A stage holds one K chunk (one tap, 128 channels: one
//    128-byte row a pixel, four wgmma k-steps): A, the 128 tap-shifted rows of x, and B,
//    the 256 x 128-byte slice of the weights, both in the 128-byte swizzle wgmma reads.
//    8-bit wgmma has no transpose bit, so both operands are K-major; the packed weights
//    already are, and B comes by TMA from a 2-D map over the (C_out, 9*C) matrix as it
//    lies (one thread, one 32 KB box; rows past C_out arrive as zeros). A is gathered by
//    all 128 threads with 16-byte cp.async: each thread keeps, for each of its 8 rows,
//    the source offset of tap (0, 0) and the nine tap-validity bits; a row whose tap
//    falls off the plane and the rows of a ragged last tile are zero-filled, so SAME
//    padding is exact with no padded copy of x, and zero is the pad in int8 code space
//    as in JAX. When C is not a multiple of 128, the 16-byte chunks of a row past C are
//    zero-filled too; B's box then holds the first channels of the next tap (or zeros
//    past 9*C) there, and those products are 0 * w. Both copies arrive on the stage's
//    "full" mbarrier by themselves (cp.async.mbarrier.arrive.noinc, TMA's byte count),
//    so the producer runs the ring's full depth ahead.
//  - two consumers (232 registers each) own 64 rows each and issue wgmma m64n256k32
//    s8 x s8 from shared memory (128 s32 accumulators a thread). One wgmma group stays
//    in flight while the next stage is waited for; a finished stage goes back to the
//    producer through its "empty" mbarrier. No block-wide barrier sits in the K loop.
//  - epilogue (csrc/epilogue_i8.cuh): the ring is free by then, and each consumer stages
//    its 64 x 256 s32 accumulators in one half of it, across two stages (64 KB, more than
//    one stage); the residual comes in and the int8 or f32 tile goes out by coalesced
//    accesses straight to device memory.
// One block per SM at a time (193 KB of shared memory), and the grid is one block a
// tile, as in the bf16 kernel: a persistent block that runs the next tile's loads during
// the epilogue measured slower at 14x14x256 and 7x7x512 on an H100.
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "epilogue_i8.cuh"
#include "hopper.cuh"

using namespace hopper;

namespace {

constexpr int BM = 128;  // output rows (pixels) per block: 64 per consumer warpgroup
constexpr int BN = 256;  // output channels per block
constexpr int BK = 128;  // input channels per K chunk (within one tap): one 128-byte row
constexpr int STAGES = 4;
constexpr int THREADS = 384;
constexpr int A_BYTES = BM * BK;
constexpr int B_BYTES = BN * BK;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int RING_BYTES = STAGES * STAGE_BYTES;
constexpr int SMEM_BYTES = RING_BYTES + 1024;  // + room to align to 1024
static_assert(2 * epilogue_i8::smem_bytes<1>() <= RING_BYTES, "both consumers' tiles fit in the ring");

__global__ void __launch_bounds__(THREADS, 1)
conv3x3_i8_kernel(const int8_t* __restrict__ x, const float* __restrict__ scale,
                  const float* __restrict__ bias, const int8_t* __restrict__ res,
                  void* __restrict__ out, int M, int S, int So, int C, int C_out, int stride,
                  int pad_lo, int n_tiles, int relu, float res_scale, int int8_out,
                  float out_scale, const __grid_constant__ CUtensorMap w_map) {
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
  const int k_chunks = (C + BK - 1) / BK;
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
    const int chunk = pt & 7;  // this thread's 16-byte chunk of every row it copies
    const int row0 = pt >> 3;  // A rows row0 + 16 i
    const uint32_t swz = static_cast<uint32_t>((chunk ^ (row0 & 7)) << 4);

    // for each of this thread's 8 A rows: the offset in x of its chunk at tap (0, 0)
    // (negative where that tap is off the plane) and nine tap-validity bits, three rows
    // a register
    int src[8];
    uint32_t valid[3] = {0u, 0u, 0u};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = m0 + row0 + 16 * i;
      src[i] = 0;
      if (m < M) {
        const int img = m / (So * So);
        const int rem = m - img * So * So;
        const int yo = rem / So;
        const int y0 = yo * stride - pad_lo, x0 = (rem - yo * So) * stride - pad_lo;
        uint32_t bits = 0;
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          const int yy = y0 + tap / 3, xt = x0 + tap % 3;
          if (yy >= 0 && yy < S && xt >= 0 && xt < S) bits |= 1u << tap;
        }
        valid[i / 3] |= bits << (9 * (i % 3));
        src[i] = ((img * S + y0) * S + x0) * C + chunk * 16;
      }
    }

    for (int it = 0; it < steps; ++it) {
      const int s = it % STAGES;
      mbar_wait(&empty_bar[s], ((it / STAGES) & 1) ^ 1);
      const int tap = it / k_chunks;
      const int c0 = (it - tap * k_chunks) * BK;
      const int dy = tap / 3, dx = tap - (tap / 3) * 3;
      const int tap_off = (dy * S + dx) * C + c0;
      const bool chunk_ok = c0 + chunk * 16 < C;
      const uint32_t a_dst = smem_base + s * STAGE_BYTES + row0 * 128 + swz;
      if (pt == 0) {
        mbar_arrive_expect_tx(&full_bar[s], B_BYTES);
        tma_load_2d(smem_base + s * STAGE_BYTES + A_BYTES, &w_map, &full_bar[s], tap * C + c0, n0);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const bool ok = chunk_ok && ((valid[i / 3] >> (9 * (i % 3) + tap)) & 1u);
        cp_async16(a_dst + i * 16 * 128, ok ? x + (src[i] + tap_off) : x, ok);
      }
      cp_async_arrive(&full_bar[s]);
    }
  } else {
    // ------------------------------- consumers ------------------------------------
    reg_alloc<232>();
    int acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    const int lane = tid & 31;
    for (int it = 0; it < steps; ++it) {
      const int s = it % STAGES;
      mbar_wait(&full_bar[s], (it / STAGES) & 1);
      fence_proxy_async();  // the gathered rows were written through the generic proxy
      const uint32_t a_tile = smem_base + s * STAGE_BYTES + wg * (64 * 128);
      const uint32_t b_tile = smem_base + s * STAGE_BYTES + A_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk)
        wgmma_m64n256k32_ss_s8(acc, wgmma_desc_k8(a_tile, kk), wgmma_desc_k8(b_tile, kk),
                               (it | kk) != 0);
      wgmma_commit();
      if (it > 0) {
        wgmma_wait<1>();  // the group of stage it - 1 has read its operands
        if (lane == 0) mbar_arrive(&empty_bar[(it - 1) % STAGES]);
      }
    }
    wgmma_wait<0>();

    bar_sync(1, 256);  // both consumers have left the ring
    epilogue_i8::store_tile<1>(acc, smem + wg * (RING_BYTES / 2), 2 + wg, m0 + wg * 64, n0, M,
                                  C_out, scale, bias, res, res_scale, relu, int8_out, out_scale, out);
  }
}

}  // namespace

extern "C" int tpuhar_conv3x3_i8(const void* x, const void* w, const void* scale,
                                 const void* bias, const void* residual, void* out, int M,
                                 int S, int So, int C, int C_out, int stride, int pad_lo,
                                 int relu, float res_scale, int int8_out, float out_scale,
                                 void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_i8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tiles = (C_out + BN - 1) / BN;
  const long long blocks = static_cast<long long>((M + BM - 1) / BM) * n_tiles;
  if (C % 32 != 0 || C_out % 32 != 0 || blocks > 0x7fffffffll)
    return static_cast<int>(cudaErrorInvalidValue);
  // the weights as a (C_out, 9*C) int8 matrix, read in boxes of 256 channels x 128 K
  // bytes that land in the 128-byte swizzle; rows past C_out and K past 9*C arrive as
  // zeros
  CUtensorMap w_map;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(9) * C, static_cast<cuuint64_t>(C_out)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(9) * C};
  const cuuint32_t box[2] = {BK, BN};
  if (!encode_tensor_map(&w_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, 2, dims, strides, box))
    return static_cast<int>(cudaErrorInvalidValue);
  conv3x3_i8_kernel<<<static_cast<unsigned>(blocks), THREADS, SMEM_BYTES,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<const int8_t*>(residual), out, M, S, So, C,
      C_out, stride, pad_lo, n_tiles, relu, res_scale, int8_out, out_scale, w_map);
  return static_cast<int>(cudaGetLastError());
}
