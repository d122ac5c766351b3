// uint8 patch-major stem GEMM on Hopper (sm_90a), int8 tensor cores through wgmma, and
// its signed-int8 form.
//
// Replaces the TPU kernel tpuhar/ops/stem.py: stem_gemm_u8_pallas (body `kernel`) and
// its XLA twin stem_gemm_u8, which the JAX serving program runs:
//   x   = max(u8, 1) ^ 0x80            (= clip(u8 - 128, -127, 127))
//   acc = x @ w.T                       (int8 x int8, int32 accumulate; K = p*p*3 = 768)
//   y   = relu(acc * scale + bias)      (f32, per output channel)
//   out = int8_out ? clip(rint(y / out_scale), -127, 127) : y
// on u8 rows x (M, K), int8 weights w (C0, K) (K-major: the transpose of the JAX
// package's (K, C0), packed once by ops/stem.pack_stem_u8), scale/bias (C0,) f32,
// out (M, C0).
//
// The signed form (tpuhar_int8_gemm, kByteMap = false) reads x as int8 codes and skips
// the byte map: the same epilogue(x @ w.T) stands for the XLA int8 products of the JAX
// package's int8 towers (ops/quant.py: int8_dense, the ViT's dense layers, and
// ResNet-18's 7x7 stem on its im2col rows and its 1x1 downsample convs). Its K-chunk
// zero fill stays 0 (no map), so K past the map's extent adds 0 * 0.
//
// What bounds it: bytes. At batch 256 (802,816 rows) it reads 616 MB of pixels and
// writes 205 MB of int8 codes, 0.25 ms at the card's memory rate, against 0.32 TOP, 0.16
// ms at its int8 peak.
//
// Design: a warp-specialised GEMM on the pieces of csrc/conv3x3_i8.cu. A tile is 128
// rows x 256 channels (all of C0 = 256), so each pixel leaves device memory once. The
// block is persistent, one an SM, and walks the tiles; it runs three warpgroups:
//  - one producer thread (its warpgroup's registers cut to 40 by setmaxnreg) fills a
//    ring of three 48 KB stages by TMA: a K chunk of 128 bytes is A, a 128 x 128 box of a
//    2-D u8 map over the (M, K) pixels, and B, a 256 x 128 box of a 2-D int8 map over the
//    (C0, K) weights, both in the 128-byte swizzle. 8-bit wgmma reads B K-major only,
//    hence the (C0, K) layout. No thread spends an instruction on an address. The K loop
//    is only six chunks, so the producer runs on into the next tile's chunks while the
//    consumers drain the epilogue: on an H100 this was 8.5% faster than one block a tile
//    with four stages and the epilogue in the freed ring.
//  - two consumers (232 registers each) own 64 rows each. For each k-step they ldmatrix
//    the raw bytes of their rows into the A-fragment registers, apply the byte map there
//    (__vmaxu4 with 0x01010101, then an XOR with 0x80808080, four pixels an instruction)
//    and issue wgmma m64n256k32 s8 with A from registers and B from shared memory (the RS
//    form). So the map is never materialised, in device memory or in shared memory, and
//    each pixel byte is read from shared memory once. The A registers are double-buffered
//    so that one wgmma group stays in flight while the next stage is waited for.
//    TMA fills rows past M and K columns past the map's extent with zero bytes, which the
//    map turns into -127, not 0: rows past M are never stored, and the weights' K columns
//    past K arrive as zeros too, so those products are -127 * 0.
//  - epilogue (csrc/epilogue_i8.cuh), in two 128-channel halves through a region of each
//    consumer's own beside the ring (the ring is busy with the next tile), with coalesced
//    stores straight to device memory.
// 144 KB of ring and 68 KB of epilogue staging: one block an SM.
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "epilogue_i8.cuh"
#include "hopper.cuh"

using namespace hopper;

namespace {

constexpr int BM = 128;  // rows per block: 64 per consumer warpgroup
constexpr int BN = 256;  // output channels per block
constexpr int BK = 128;  // K bytes per chunk: one 128-byte row, four wgmma k-steps
constexpr int STAGES = 3;
constexpr int THREADS = 384;
constexpr int A_BYTES = BM * BK;
constexpr int B_BYTES = BN * BK;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int RING_BYTES = STAGES * STAGE_BYTES;
constexpr int EPI_PARTS = 2;  // the epilogue's staging: half a tile at a time
constexpr int EPI_BYTES = epilogue_i8::smem_bytes<EPI_PARTS>();
constexpr int SMEM_BYTES = RING_BYTES + 2 * EPI_BYTES + 1024;  // + room to align to 1024

// four pixels at once: max(u8, 1) ^ 0x80 per byte
__device__ __forceinline__ uint32_t byte_map(uint32_t w) {
  return __vmaxu4(w, 0x01010101u) ^ 0x80808080u;
}

// One K chunk of a consumer: its rows' bytes from the stage's A tile into `a` (the
// ldmatrix address of this lane at k-step 0 is `a_lane`, the swizzle's XOR `a_swz`),
// mapped when kByteMap (the uint8 wire; int8 codes go as they lie), then four RS wgmmas
// against the stage's B tile, committed as one group.
template <bool kByteMap>
__device__ __forceinline__ void mma_chunk(int (&acc)[BN / 2], uint32_t (&a)[4][4], uint32_t a_lane,
                                          int a_chunk, int a_swz, uint32_t b_tile, bool first) {
#pragma unroll
  for (int kk = 0; kk < BK / 32; ++kk) {
    ldmatrix_x4(a[kk], a_lane + (((2 * kk + a_chunk) ^ a_swz) << 4));
    if constexpr (kByteMap) {
#pragma unroll
      for (int q = 0; q < 4; ++q) a[kk][q] = byte_map(a[kk][q]);
    }
  }
  wgmma_fence();  // the A registers were written by this thread
#pragma unroll
  for (int kk = 0; kk < BK / 32; ++kk)
    wgmma_m64n256k32_rs_s8(acc, a[kk], wgmma_desc_k8(b_tile, kk), !(first && kk == 0));
  wgmma_commit();
}

template <bool kByteMap>
__global__ void __launch_bounds__(THREADS, 1)
stem_u8_kernel(const float* __restrict__ scale, const float* __restrict__ bias,
               void* __restrict__ out, int M, int K, int C0, int n_tiles, int relu,
               int int8_out, float out_scale, const __grid_constant__ CUtensorMap x_map,
               const __grid_constant__ CUtensorMap w_map) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full_bar[STAGES], empty_bar[STAGES];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t smem_base = smem_addr(smem);

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int tiles = ((M + BM - 1) / BM) * n_tiles;
  const int steps = (K + BK - 1) / BK;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full_bar[s], 1);  // the TMA's issuer
      mbar_init(&empty_bar[s], 8);  // lane 0 of every consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    // ------------------------------- producer -------------------------------------
    reg_dealloc<40>();
    if (tid == 256) {
      int g = 0;  // K chunks issued so far, over all this block's tiles: the ring position
      // n-tiles of one row tile are neighbours, so the second read of its pixels finds
      // them in L2
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile / n_tiles) * BM, n0 = (tile % n_tiles) * BN;
        for (int it = 0; it < steps; ++it, ++g) {
          const int s = g % STAGES;
          mbar_wait(&empty_bar[s], ((g / STAGES) & 1) ^ 1);
          const uint32_t dst = smem_base + s * STAGE_BYTES;
          mbar_arrive_expect_tx(&full_bar[s], STAGE_BYTES);
          tma_load_2d(dst, &x_map, &full_bar[s], it * BK, m0);
          tma_load_2d(dst + A_BYTES, &w_map, &full_bar[s], it * BK, n0);
        }
      }
    }
  } else {
    // ------------------------------- consumers ------------------------------------
    reg_alloc<232>();
    const int lane = tid & 31;
    // ldmatrix: lane l addresses row l % 8 of matrix l / 8 (rows +8 for odd matrices,
    // bytes +16 for the upper two) of its warp's 16 rows; the rows start on a multiple
    // of 8, so the swizzle's XOR is the row's index within its group of 8
    const int mi = lane >> 3, mr = lane & 7;
    const int row = wg * 64 + ((tid & 127) >> 5) * 16 + (mi & 1) * 8 + mr;
    uint8_t* epi = smem + RING_BYTES + wg * EPI_BYTES;
    uint32_t a0[4][4], a1[4][4];
    int g = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile / n_tiles) * BM, n0 = (tile % n_tiles) * BN;
      int acc[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
      for (int it = 0; it < steps; ++it, ++g) {
        const int s = g % STAGES;
        mbar_wait(&full_bar[s], (g / STAGES) & 1);
        const uint32_t stage = smem_base + s * STAGE_BYTES;
        if (it & 1)
          mma_chunk<kByteMap>(acc, a1, stage + row * 128, mi >> 1, mr, stage + A_BYTES, false);
        else
          mma_chunk<kByteMap>(acc, a0, stage + row * 128, mi >> 1, mr, stage + A_BYTES, it == 0);
        if (it > 0) {
          wgmma_wait<1>();  // the group of chunk g - 1 has read B and its A registers
          if (lane == 0) mbar_arrive(&empty_bar[(g - 1) % STAGES]);
        }
      }
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(&empty_bar[(g - 1) % STAGES]);  // the tile's last chunk
      epilogue_i8::store_tile<EPI_PARTS>(acc, epi, 2 + wg, m0 + wg * 64, n0, M, C0, scale, bias,
                                         nullptr, 0.f, relu, int8_out, out_scale, out);
    }
  }
}

// Launch the kernel over x (M, K) bytes (u8 pixels when kByteMap, else int8 codes) and
// w (C0, K) int8; the arguments of both C entries below.
template <bool kByteMap>
int launch(const void* x, const void* w, const void* scale, const void* bias, void* out, int M,
           int K, int C0, int relu, int int8_out, float out_scale, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(stem_u8_kernel<kByteMap>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tiles = (C0 + BN - 1) / BN;
  const long long tiles = static_cast<long long>((M + BM - 1) / BM) * n_tiles;
  if (K % 64 != 0 || C0 % 32 != 0 || tiles > 0x7fffffffll)
    return static_cast<int>(cudaErrorInvalidValue);
  int device = 0, sms = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return static_cast<int>(err);
  // x (M, K) and weights (C0, K), both read in boxes of 128 K bytes that land in the
  // 128-byte swizzle; rows past M or C0 and K past K arrive as zeros
  CUtensorMap x_map, w_map;
  const cuuint64_t x_dims[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(M)};
  const cuuint64_t w_dims[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(C0)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K)};
  const cuuint32_t x_box[2] = {BK, BM}, w_box[2] = {BK, BN};
  if (!encode_tensor_map(&x_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, x, 2, x_dims, strides, x_box) ||
      !encode_tensor_map(&w_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, 2, w_dims, strides, w_box))
    return static_cast<int>(cudaErrorInvalidValue);
  stem_u8_kernel<kByteMap><<<static_cast<unsigned>(tiles < sms ? tiles : sms), THREADS, SMEM_BYTES,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(scale), static_cast<const float*>(bias), out, M, K, C0, n_tiles,
      relu, int8_out, out_scale, x_map, w_map);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int tpuhar_stem_u8(const void* x, const void* w, const void* scale,
                              const void* bias, void* out, int M, int K, int C0, int relu,
                              int int8_out, float out_scale, void* stream) {
  return launch<true>(x, w, scale, bias, out, M, K, C0, relu, int8_out, out_scale, stream);
}

// epilogue(x_q @ w.T) on int8 codes x_q (M, K): the stem kernel without the byte map
extern "C" int tpuhar_int8_gemm(const void* x_q, const void* w, const void* scale,
                                const void* bias, void* out, int M, int K, int C0, int relu,
                                int int8_out, float out_scale, void* stream) {
  return launch<false>(x_q, w, scale, bias, out, M, K, C0, relu, int8_out, out_scale, stream);
}
