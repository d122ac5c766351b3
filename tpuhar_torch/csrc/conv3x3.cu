// Fused 3x3 SAME conv + folded BatchNorm + residual + ReLU on Hopper (sm_90a), bf16.
//
// Replaces the TPU kernel tpuhar/ops/conv3x3.py: conv3x3_bn_act (body _kernel):
//   out = act(conv3x3_same(x) * scale + bias [+ residual])
// on NHWC planes x (N, S, S, C), weights (9*C, C_out) (the HWIO kernel reshaped, as
// conv3x3.py:197 does), scale/bias (C_out,) f32, residual and out (N, S, S, C_out).
//
// Design: a plain implicit GEMM. Rows are M = N*S*S output pixels, K is 9 taps x C,
// columns are C_out. For each K chunk (one tap, BK channels) the block gathers the
// tap-shifted rows of x into shared memory with cp.async, zero-filling every row whose
// tap falls off the plane (the (y, x) validity masks of conv3x3.py:79-88) and the
// ragged last row tile, so plane and frame edges are exact with no padded copy of x.
// The chunk is multiplied on the tensor cores with wmma (bf16 in, f32 accumulate),
// double-buffered so the next chunk's loads overlap this chunk's MMAs. The epilogue
// applies the folded BN, the residual and the ReLU in f32 and stores bf16.
//
// What bounds it: compute. At batch 256 (4096 frames) each 14x14x256 conv is
// 2*802816*2304*256 = 0.95 TFLOP against about 1.2 GB of traffic, far above the
// card's ~295 FLOP/byte ridge. This simple tile design (wmma from shared memory, no
// TMA, no wgmma, no warp specialisation) is a first step; wgmma/TMA is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BM = 128;  // output rows (pixels) per block
constexpr int BN = 128;  // output channels per block
constexpr int BK = 32;   // input channels per K chunk (within one tap)
constexpr int WARPS_M = 2, WARPS_N = 4;
constexpr int THREADS = 32 * WARPS_M * WARPS_N;
constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;  // 64 x 32 outputs per warp
constexpr int FM = WM / 16, FN = WN / 16;
constexpr int A_LD = BK + 8;  // row pitches in bf16 elements: 80 B and 272 B, which
constexpr int B_LD = BN + 8;  // keep the 16-byte rows of a wmma load on distinct banks
constexpr int A_CHUNKS = BM * BK / 8 / THREADS;  // 16-byte copies per thread per chunk
constexpr int B_CHUNKS = BK * BN / 8 / THREADS;
static_assert(A_CHUNKS * THREADS * 8 == BM * BK, "A tile split");
static_assert(B_CHUNKS * THREADS * 8 == BK * BN, "B tile split");

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int bytes = valid ? 16 : 0;  // 0 source bytes: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__global__ void __launch_bounds__(THREADS)
conv3x3_bn_act_kernel(const __nv_bfloat16* __restrict__ x,
                      const __nv_bfloat16* __restrict__ w,
                      const float* __restrict__ scale, const float* __restrict__ bias,
                      const __nv_bfloat16* __restrict__ res,
                      __nv_bfloat16* __restrict__ out, int M, int S, int C, int C_out,
                      int relu) {
  __shared__ __align__(128) __nv_bfloat16 As[2][BM * A_LD];
  __shared__ __align__(128) __nv_bfloat16 Bs[2][BK * B_LD];
  __shared__ __align__(128) float Cs[WARPS_M * WARPS_N][16 * 16];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // the A rows this thread copies: pixel index and its (y, x) in the plane
  int a_row[A_CHUNKS], a_m[A_CHUNKS], a_y[A_CHUNKS], a_x[A_CHUNKS];
  const int a_k = (tid % (BK / 8)) * 8;
#pragma unroll
  for (int i = 0; i < A_CHUNKS; ++i) {
    a_row[i] = (tid + i * THREADS) / (BK / 8);
    a_m[i] = m0 + a_row[i];
    const int rem = a_m[i] % (S * S);
    a_y[i] = rem / S;
    a_x[i] = rem % S;
  }
  int b_row[B_CHUNKS], b_col[B_CHUNKS];
#pragma unroll
  for (int i = 0; i < B_CHUNKS; ++i) {
    b_row[i] = (tid + i * THREADS) / (BN / 8);
    b_col[i] = ((tid + i * THREADS) % (BN / 8)) * 8;
  }

  const int k_chunks = (C + BK - 1) / BK;
  const int steps = 9 * k_chunks;

  auto load = [&](int step, int buf) {
    const int tap = step / k_chunks;
    const int c0 = (step % k_chunks) * BK;
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
#pragma unroll
    for (int i = 0; i < A_CHUNKS; ++i) {
      const int yy = a_y[i] + dy, xx = a_x[i] + dx, c = c0 + a_k;
      const bool ok = a_m[i] < M && yy >= 0 && yy < S && xx >= 0 && xx < S && c < C;
      const __nv_bfloat16* src =
          ok ? x + static_cast<size_t>(a_m[i] + dy * S + dx) * C + c : x;
      cp_async16(&As[buf][a_row[i] * A_LD + a_k], src, ok);
    }
#pragma unroll
    for (int i = 0; i < B_CHUNKS; ++i) {
      const int k = c0 + b_row[i], n = n0 + b_col[i];
      const bool ok = k < C && n < C_out;
      const __nv_bfloat16* src =
          ok ? w + (static_cast<size_t>(tap) * C + k) * C_out + n : w;
      cp_async16(&Bs[buf][b_row[i] * B_LD + b_col[i]], src, ok);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  load(0, 0);
  cp_async_commit();
  for (int step = 0; step < steps; ++step) {
    const int buf = step & 1;
    if (step + 1 < steps) load(step + 1, buf ^ 1);
    cp_async_commit();  // an empty group on the last step keeps the wait count uniform
    cp_async_wait_prev();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(a[i], &As[buf][(wm * WM + i * 16) * A_LD + kk], A_LD);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(b[j], &Bs[buf][kk * B_LD + wn * WN + j * 16], B_LD);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();  // the next iteration's loads overwrite this buffer
  }

  // epilogue: each warp stages one 16x16 tile in shared memory at a time; a lane
  // then owns 8 consecutive channels of one row (one 16-byte load and store)
  float* cs = Cs[warp];
  const int er = lane >> 1, ec = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < FM; ++i) {
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::store_matrix_sync(cs, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int m = m0 + wm * WM + i * 16 + er;
      const int n = n0 + wn * WN + j * 16 + ec;
      if (m < M && n < C_out) {  // C_out % 8 == 0, so n < C_out means n + 8 <= C_out
        float v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = cs[er * 16 + ec + e] * scale[n + e] + bias[n + e];
        const size_t off = static_cast<size_t>(m) * C_out + n;
        if (res != nullptr) {
          const uint4 r = *reinterpret_cast<const uint4*>(res + off);
          const __nv_bfloat16* rb = reinterpret_cast<const __nv_bfloat16*>(&r);
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] += __bfloat162float(rb[e]);
        }
        uint4 o;
        __nv_bfloat16* ob = reinterpret_cast<__nv_bfloat16*>(&o);
#pragma unroll
        for (int e = 0; e < 8; ++e) ob[e] = __float2bfloat16(relu ? fmaxf(v[e], 0.f) : v[e]);
        *reinterpret_cast<uint4*>(out + off) = o;
      }
      __syncwarp();
    }
  }
}

}  // namespace

extern "C" int tpuhar_conv3x3_bn_act(const void* x, const void* w, const void* scale,
                                     const void* bias, const void* residual, void* out,
                                     int M, int S, int C, int C_out, int relu,
                                     void* stream) {
  const dim3 grid((M + BM - 1) / BM, (C_out + BN - 1) / BN);
  conv3x3_bn_act_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<const __nv_bfloat16*>(residual), static_cast<__nv_bfloat16*>(out), M,
      S, C, C_out, relu);
  return static_cast<int>(cudaGetLastError());
}
