// uint8 patch-major stem GEMM on Hopper (sm_90a), int8 tensor cores.
//
// Replaces the TPU kernel tpuhar/ops/stem.py: stem_gemm_u8_pallas (body `kernel`) and
// its XLA twin stem_gemm_u8, which the JAX serving program runs:
//   x   = max(u8, 1) ^ 0x80            (= clip(u8 - 128, -127, 127))
//   acc = x @ w                         (int8 x int8, int32 accumulate; K = p*p*3 = 768)
//   y   = relu(acc * scale + bias)      (f32, per output channel)
//   out = int8_out ? clip(rint(y / out_scale), -127, 127) : y
// on u8 rows x (M, K), int8 weights w (K, C0), scale/bias (C0,) f32, out (M, C0).
//
// Design: a tiled GEMM. Each block owns 128 rows x 128 channels; its threads read the
// rows as 16-byte vectors into registers, apply the byte map there four bytes at a
// time (__vmaxu4 with 0x01010101, then an XOR with 0x80808080) and store the int8
// codes to shared memory, so the map is never materialised in device memory. The K loop is
// double-buffered through registers: the next chunk's loads are issued before this
// chunk's MMAs (wmma s8 m16n16k16, int32 accumulators). In shared memory every 16-byte
// column slab of a tile is stored contiguously, so each 16x16 fragment is 256
// contiguous, 32-byte-aligned bytes (ld = 16). The epilogue uses the _rn intrinsics
// (never contracted into an FMA), so it is bit-exact against the plain PyTorch version,
// which runs the multiply, the add and the division as separate ops.
//
// What bounds it: not its bytes, although it was designed to be. At batch 256 (802,816
// rows) it reads 616 MB of pixels, writes 205 MB of int8 codes and does
// 2*802816*768*256 = 0.32 TOP. On an H100 SXM (700 W) that takes about 1.75 ms: 352 GB/s
// of pixels (0.47 TB/s with the output), far below HBM bandwidth, and about 180 TOP/s,
// far below the int8 tensor-core peak. Which part holds it back (wmma issue, the
// register double-buffer, the second read of each row tile) has not been measured.
// The n-tiles of one row tile are neighbours in the grid, so the second one reads the
// rows from L2. TMA and wgmma are later work.
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BM = 128;  // rows per block
constexpr int BN = 128;  // output channels per block
constexpr int BK = 64;   // K bytes per chunk
constexpr int WARPS_M = 2, WARPS_N = 4;
constexpr int THREADS = 32 * WARPS_M * WARPS_N;
constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;  // 64 x 32 outputs per warp
constexpr int FM = WM / 16, FN = WN / 16;
// A tile: BK/16 slabs of BM rows x 16 bytes; B tile: BN/16 slabs of BK rows x 16
// bytes. 32 bytes of padding per slab keep slabs 32-byte aligned and spread the
// 16-byte stores of a quarter warp over the banks.
constexpr int A_SLAB = BM * 16 + 32;
constexpr int B_SLAB = BK * 16 + 32;
constexpr int A_TILE = (BK / 16) * A_SLAB;
constexpr int B_TILE = (BN / 16) * B_SLAB;
constexpr int A_VECS = BM * BK / 16 / THREADS;  // 16-byte vectors per thread per chunk
constexpr int B_VECS = BK * BN / 16 / THREADS;
static_assert(A_VECS * THREADS * 16 == BM * BK, "A tile split");
static_assert(B_VECS * THREADS * 16 == BK * BN, "B tile split");

// four pixels at once: max(u8, 1) ^ 0x80 per byte
__device__ __forceinline__ uint32_t byte_map(uint32_t w) {
  return __vmaxu4(w, 0x01010101u) ^ 0x80808080u;
}

__global__ void __launch_bounds__(THREADS)
stem_u8_kernel(const uint8_t* __restrict__ x, const int8_t* __restrict__ w,
               const float* __restrict__ scale, const float* __restrict__ bias,
               void* __restrict__ out, int M, int K, int C0, int relu,
               int int8_out, float out_scale) {
  __shared__ __align__(128) signed char As[2][A_TILE];
  __shared__ __align__(128) signed char Bs[2][B_TILE];
  __shared__ __align__(128) int Cs[WARPS_M * WARPS_N][16 * 16];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int n0 = blockIdx.x * BN;  // n-tiles of one row tile run next to each other
  const int m0 = blockIdx.y * BM;

  // vector i of a thread: A row a_row, 16-byte column a_kq; B row b_k, column slab b_nq
  int a_row[A_VECS], a_kq[A_VECS], b_k[B_VECS], b_nq[B_VECS];
#pragma unroll
  for (int i = 0; i < A_VECS; ++i) {
    const int idx = tid + i * THREADS;
    a_row[i] = idx / (BK / 16);
    a_kq[i] = idx % (BK / 16);
  }
#pragma unroll
  for (int i = 0; i < B_VECS; ++i) {
    const int idx = tid + i * THREADS;
    b_k[i] = idx / (BN / 16);
    b_nq[i] = idx % (BN / 16);
  }

  uint4 ra[A_VECS], rb[B_VECS];
  auto load = [&](int step) {
    const int k0 = step * BK;
#pragma unroll
    for (int i = 0; i < A_VECS; ++i) {
      const int m = m0 + a_row[i];
      ra[i] = m < M ? __ldg(reinterpret_cast<const uint4*>(x + static_cast<size_t>(m) * K +
                                                           k0 + a_kq[i] * 16))
                    : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int i = 0; i < B_VECS; ++i) {
      const int n = n0 + b_nq[i] * 16;
      rb[i] = n < C0 ? __ldg(reinterpret_cast<const uint4*>(
                           w + static_cast<size_t>(k0 + b_k[i]) * C0 + n))
                     : make_uint4(0, 0, 0, 0);
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < A_VECS; ++i) {
      uint4 v = ra[i];
      v.x = byte_map(v.x);
      v.y = byte_map(v.y);
      v.z = byte_map(v.z);
      v.w = byte_map(v.w);
      *reinterpret_cast<uint4*>(&As[buf][a_kq[i] * A_SLAB + a_row[i] * 16]) = v;
    }
#pragma unroll
    for (int i = 0; i < B_VECS; ++i)
      *reinterpret_cast<uint4*>(&Bs[buf][b_nq[i] * B_SLAB + b_k[i] * 16]) = rb[i];
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0);

  const int steps = K / BK;
  load(0);
  store(0);
  __syncthreads();
  for (int step = 0; step < steps; ++step) {
    const int buf = step & 1;
    if (step + 1 < steps) load(step + 1);  // in flight during this chunk's MMAs
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> a[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::row_major> b[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(a[i], &As[buf][kk * A_SLAB + (wm * WM + i * 16) * 16], 16);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(b[j], &Bs[buf][(wn * (WN / 16) + j) * B_SLAB + kk * 16 * 16], 16);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    // the other buffer was last read in the previous step, before its closing barrier
    if (step + 1 < steps) store(buf ^ 1);
    __syncthreads();
  }

  // epilogue: each warp stages one 16x16 tile at a time; a lane then owns 8
  // consecutive channels of one row
  int* cs = Cs[warp];
  const int er = lane >> 1, ec = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < FM; ++i) {
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::store_matrix_sync(cs, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int m = m0 + wm * WM + i * 16 + er;
      const int n = n0 + wn * WN + j * 16 + ec;
      if (m < M && n < C0) {  // C0 % 32 == 0, so n < C0 means n + 8 <= C0
        float v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          v[e] = __fadd_rn(__fmul_rn(__int2float_rn(cs[er * 16 + ec + e]), scale[n + e]),
                           bias[n + e]);
          if (relu) v[e] = fmaxf(v[e], 0.f);
        }
        const size_t off = static_cast<size_t>(m) * C0 + n;
        if (int8_out) {
          alignas(8) int8_t q[8];
#pragma unroll
          for (int e = 0; e < 8; ++e)
            q[e] = static_cast<int8_t>(min(max(__float2int_rn(__fdiv_rn(v[e], out_scale)), -127), 127));
          *reinterpret_cast<uint2*>(static_cast<int8_t*>(out) + off) =
              *reinterpret_cast<const uint2*>(q);
        } else {
          float4* o = reinterpret_cast<float4*>(static_cast<float*>(out) + off);
          o[0] = make_float4(v[0], v[1], v[2], v[3]);
          o[1] = make_float4(v[4], v[5], v[6], v[7]);
        }
      }
      __syncwarp();
    }
  }
}

}  // namespace

extern "C" int tpuhar_stem_u8(const void* x, const void* w, const void* scale,
                              const void* bias, void* out, int M, int K, int C0, int relu,
                              int int8_out, float out_scale, void* stream) {
  const dim3 grid((C0 + BN - 1) / BN, (M + BM - 1) / BM);
  stem_u8_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(bias), out, M, K, C0,
      relu, int8_out, out_scale);
  return static_cast<int>(cudaGetLastError());
}
