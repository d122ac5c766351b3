// Fused 3x3 SAME conv + folded BatchNorm + residual + ReLU on Hopper (sm_90a), bf16.
//
// Replaces the TPU kernel tpuhar/ops/conv3x3.py: conv3x3_bn_act (body _kernel):
//   out = act(conv3x3_same(x) * scale + bias [+ residual])
// on NHWC planes x (N, S, S, C), weights (9*C, C_out) (the HWIO kernel reshaped, as
// conv3x3.py:197 does), scale/bias (C_out,) f32, residual and out (N, S, S, C_out).
//
// What bounds it: operations. At batch 256 (4096 frames) each 14x14x256 conv is
// 2*802816*2304*256 = 0.95 TFLOP against about 1.2 GB of x, residual and out, far above
// the card's ~295 FLOP/byte ridge, so the design is built around keeping the tensor
// cores fed. What competes with them is the operand traffic from L2: the nine taps read
// x nine times and every 128-row tile reads all the weights, 48 KB a K step and 10.8 GB a
// call, which alone takes about as long as the products.
//
// Design: an implicit GEMM, warp-specialised. Rows are M = N*S*S output pixels, K is 9
// taps x C, columns are C_out. A block owns 128 rows x 256 channels and runs three
// warpgroups:
//  - one producer (registers cut to 40 by setmaxnreg) fills a ring of four 48 KB stages
//    in dynamic shared memory. A stage holds one K chunk (one tap, 64 channels): A, the
//    128 tap-shifted rows of x, one 128-byte row each, and B, the 64 x 256 weight chunk
//    as it lies in HWIO (channels-out contiguous, four boxes of 64 columns), both in the
//    128-byte swizzle wgmma reads. B comes by TMA from a 2-D map over the (9*C, C_out)
//    matrix (one thread, four boxes; columns past C_out arrive as zeros): the weights
//    need no repacking and two thirds of a stage cost no thread an instruction. A is
//    gathered by all 128 threads with 16-byte cp.async: a row whose tap falls off the
//    plane (the (y, x) validity masks of conv3x3.py:79-88) and the rows of a ragged last
//    tile are zero-filled, so SAME padding is exact with no padded copy of x; each thread
//    keeps its rows' nine validity bits in three registers. The gather stays in threads
//    rather than TMA's im2col mode: it is the step from the gather this kernel had, and
//    one warpgroup has a stage's time (about a thousand clocks) for its 8 copies a
//    thread. Both arrive on the stage's "full" mbarrier by themselves
//    (cp.async.mbarrier.arrive.noinc, TMA's byte count), so the producer never waits for
//    its own copies and runs the ring's full depth ahead.
//  - two consumers (232 registers each) own 64 rows each and issue wgmma m64n256k16
//    (bf16 in, 128 f32 accumulators a thread) from shared memory, A K-major, B MN-major
//    (the trans-b bit). One wgmma group stays in flight while the next stage is waited
//    for; a finished stage goes back to the producer through its "empty" mbarrier. No
//    block-wide barrier sits in the K loop.
//  - epilogue: the ring is free by then, so each consumer stages its 64 x 256 tile
//    there. The residual comes in as 16-byte coalesced loads; every thread applies
//    scale, bias, residual and ReLU in f32 to the accumulators it holds and rounds to
//    bf16 in place (a row pitch of 528 bytes keeps these 4-byte accesses on 32 distinct
//    banks); the tile leaves as 16-byte coalesced stores.
// One block per SM at a time (193 KB of shared memory), and the grid is one block a tile:
// two persistent forms (the epilogue through TMA behind the next tile's K loop, or
// straight from the registers) measured slower on an H100 than leaving the tiles to the
// hardware's block scheduler.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

using namespace hopper;

namespace {

constexpr int BM = 128;  // output rows (pixels) per block: 64 per consumer warpgroup
constexpr int BN = 256;  // output channels per block
constexpr int BK = 64;   // input channels per K chunk (within one tap): one 128-byte row
constexpr int STAGES = 4;
constexpr int THREADS = 384;
constexpr int A_BYTES = BM * BK * 2;
constexpr int B_BLOCK_BYTES = BK * 64 * 2;  // 64 K rows x 64 channels
constexpr int B_BYTES = B_BLOCK_BYTES * (BN / 64);
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024;  // + room to align to 1024
constexpr int OUT_PITCH = BN * 2 + 16;                   // bytes per staged output row
static_assert(64 * OUT_PITCH <= STAGE_BYTES, "a consumer's output tile fits in one stage");

__global__ void __launch_bounds__(THREADS, 1)
conv3x3_bn_act_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ scale,
                      const float* __restrict__ bias, const __nv_bfloat16* __restrict__ res,
                      __nv_bfloat16* __restrict__ out, int M, int S, int C, int C_out,
                      int n_tiles, int relu, const __grid_constant__ CUtensorMap w_map) {
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
  const int k_chunks = C / BK;
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
    const __nv_bfloat16* a_src = x + static_cast<long long>(m0 + row0) * C + chunk * 8;
    const long long a_step = 16ll * C;

    for (int it = 0; it < steps; ++it) {
      const int s = it % STAGES;
      mbar_wait(&empty_bar[s], ((it / STAGES) & 1) ^ 1);
      const int tap = it / k_chunks;
      const int c0 = (it - tap * k_chunks) * BK;
      const int dy = tap / 3 - 1, dx = tap - (tap / 3) * 3 - 1;
      const uint32_t a_dst = smem_base + s * STAGE_BYTES + row0 * 128 + swz;
      if (pt == 0) {
        mbar_arrive_expect_tx(&full_bar[s], B_BYTES);
        const uint32_t b_dst = smem_base + s * STAGE_BYTES + A_BYTES;
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          tma_load_2d(b_dst + j * B_BLOCK_BYTES, &w_map, &full_bar[s], n0 + j * 64, tap * C + c0);
      }
      const __nv_bfloat16* a = a_src + (dy * S + dx) * C + c0;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const bool ok = (valid[i / 3] >> (9 * (i % 3) + tap)) & 1u;
        cp_async16(a_dst + i * 16 * 128, ok ? a + i * a_step : x, ok);
      }
      cp_async_arrive(&full_bar[s]);
    }
  } else {
    // ------------------------------- consumers ------------------------------------
    reg_alloc<232>();
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    const int lane = tid & 31;
    for (int it = 0; it < steps; ++it) {
      const int s = it % STAGES;
      mbar_wait(&full_bar[s], (it / STAGES) & 1);
      fence_proxy_async();  // the gathered rows were written through the generic proxy
      const uint32_t a_tile = smem_base + s * STAGE_BYTES + wg * (64 * 128);
      const uint32_t b_tile = smem_base + s * STAGE_BYTES + A_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        // A: 16 K values are 32 bytes along the row; B: 16 K rows are 2048 bytes
        const uint64_t da = wgmma_desc(a_tile + kk * 32, 16, 1024);
        const uint64_t db = wgmma_desc(b_tile + kk * 16 * 128, B_BLOCK_BYTES, 1024);
        wgmma_m64n256k16_ss_tb(acc, da, db, (it | kk) != 0);
      }
      wgmma_commit();
      if (it > 0) {
        wgmma_wait<1>();  // the group of stage it - 1 has read its operands
        if (lane == 0) mbar_arrive(&empty_bar[(it - 1) % STAGES]);
      }
    }
    wgmma_wait<0>();

    // -------------------------------- epilogue ------------------------------------
    bar_sync(1, 256);  // both consumers have left the ring
    uint8_t* stage = smem + wg * STAGE_BYTES;
    const int wt = tid & 127;
    const int row_base = m0 + wg * 64;
    if (res != nullptr) {
#pragma unroll 4
      for (int i = 0; i < 64 * (BN / 8) / 128; ++i) {
        const int idx = wt + i * 128;
        const int r = idx / (BN / 8), c = idx % (BN / 8);
        const int m = row_base + r, n = n0 + c * 8;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (m < M && n < C_out)
          v = __ldg(reinterpret_cast<const uint4*>(res + static_cast<long long>(m) * C_out + n));
        *reinterpret_cast<uint4*>(stage + r * OUT_PITCH + c * 16) = v;
      }
      bar_sync(2 + wg, 128);
    }
    const int r = (wt >> 5) * 16 + (lane >> 2);
    const int col0 = 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = j * 8 + col0;
      const int n = n0 + col;  // C_out % 8 == 0, so n < C_out means n + 1 < C_out
      float2 sc = make_float2(0.f, 0.f), bi = make_float2(0.f, 0.f);
      if (n < C_out) {
        sc = __ldg(reinterpret_cast<const float2*>(scale + n));
        bi = __ldg(reinterpret_cast<const float2*>(bias + n));
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        __nv_bfloat162* p =
            reinterpret_cast<__nv_bfloat162*>(stage + (r + 8 * h) * OUT_PITCH + col * 2);
        float v0 = acc[4 * j + 2 * h] * sc.x + bi.x;
        float v1 = acc[4 * j + 2 * h + 1] * sc.y + bi.y;
        if (res != nullptr) {
          const float2 rr = __bfloat1622float2(*p);
          v0 += rr.x;
          v1 += rr.y;
        }
        if (relu) {
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
        }
        *p = __floats2bfloat162_rn(v0, v1);
      }
    }
    bar_sync(2 + wg, 128);
#pragma unroll 4
    for (int i = 0; i < 64 * (BN / 8) / 128; ++i) {
      const int idx = wt + i * 128;
      const int rr = idx / (BN / 8), c = idx % (BN / 8);
      const int m = row_base + rr, n = n0 + c * 8;
      if (m < M && n < C_out)
        *reinterpret_cast<uint4*>(out + static_cast<long long>(m) * C_out + n) =
            *reinterpret_cast<const uint4*>(stage + rr * OUT_PITCH + c * 16);
    }
  }
}

}  // namespace

extern "C" int tpuhar_conv3x3_bn_act(const void* x, const void* w, const void* scale,
                                     const void* bias, const void* residual, void* out,
                                     int M, int S, int C, int C_out, int relu,
                                     void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_bn_act_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tiles = (C_out + BN - 1) / BN;
  const long long blocks = static_cast<long long>((M + BM - 1) / BM) * n_tiles;
  if (C % BK != 0 || C_out % 8 != 0 || blocks > 0x7fffffffll)
    return static_cast<int>(cudaErrorInvalidValue);
  // the weights as a (9*C, C_out) matrix, read in boxes of 64 K rows x 64 channels that
  // land in the 128-byte swizzle; columns past C_out arrive as zeros
  CUtensorMap w_map;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(C_out), static_cast<cuuint64_t>(9) * C};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(C_out) * 2};
  const cuuint32_t box[2] = {64, BK};
  if (!encode_tensor_map(&w_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, w, 2, dims, strides, box))
    return static_cast<int>(cudaErrorInvalidValue);
  conv3x3_bn_act_kernel<<<static_cast<unsigned>(blocks), THREADS, SMEM_BYTES,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(bias),
      static_cast<const __nv_bfloat16*>(residual), static_cast<__nv_bfloat16*>(out), M,
      S, C, C_out, n_tiles, relu, w_map);
  return static_cast<int>(cudaGetLastError());
}
