// Non-causal flash attention forward on Hopper (sm_90a), f32, head_dim 64.
//
// The f32 form of csrc/flash_attn.cu: it replaces the same two TPU kernels on f32
// operands, tpuhar/ops/flash_lean.py: flash_lean (body _kernel) and the stock Pallas TPU
// flash kernel's forward that tpuhar/ops/attention.py: flash_mha(kernel="library")
// reaches (jax.experimental.pallas.ops.tpu.flash_attention: _flash_attention_kernel),
// which run their products in the operands' type with f32 sums. Per (batch, head):
// out = softmax(Q K^T * sm_scale) V over N tokens, with f32 scores, the running max and
// normalizer, P kept in f32 for the product with V, and the division by the normalizer
// at the end; with `lse` set it also stores each row's log-sum-exp of the scaled scores,
// m * sm_scale + ln(l), at lse[(b * H + h) * N + row], which the backward kernels
// (csrc/flash_attn_bwd_f32.cu) recompute P from. The f32 output is the one the dQ kernel
// forms di = rowsum(O o dO) from, so the training form stores nothing more.
//
// q, k, v and out are (B, H, N, 64) with any strides whose last one is 1 and whose rows
// start on 16-byte boundaries; the wrapper hands over the native (B, N, H*64)
// projections and a (B, N, H, 64) output buffer.
//
// What bounds it: operations. Every product runs in full f32 on the CUDA cores (FFMA; a
// TF32 tensor-core pass keeps about three decimal digits, another function). A batch-8
// videomae_base call (B*H = 96, N = 1568) is 4*96*1568^2*64 = 60.4 GFLOP: 0.90 ms at the
// card's 67 TFLOP/s of f32, against 77 MB of q, k, v and out (0.023 ms at 3.35 TB/s):
// the score matrix never leaves the SM.
//
// Design (csrc/flash_f32.cuh): a block of 128 threads owns 128 query rows of one (batch,
// head), 32 a warp, and walks the 64-row key tiles. Q arrives once, transposed into
// shared memory; each step brings K transposed and V row-major, then S = Q K^T is 64
// k-steps of the register-tiled FFMA product (a thread holds 8 x 8 scores: the wider
// tile needs a quarter fewer shared-memory loads an FFMA than 4 x 8, which set the pace),
// the online softmax runs on those registers in the log2 domain (exp2f of s * sm_scale *
// log2 e minus the row's max; the max and the row sums over a row's eight lanes by
// shuffles), P goes transposed into the warp's own rows of a shared tile (only
// __syncwarp between its store and its reads), and O += P V is 64 more k-steps into the
// thread's 8 x 8 f32 accumulator. 98 KB of shared memory and under 200 registers a thread
// leave two blocks on an SM, so one block's tile loads overlap the other's products. Key
// columns past N (on the last tile where 64 does not divide N) get -inf scores; their V
// rows arrive as zeros. Query rows past N are computed on zeros and not stored.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "flash_f32.cuh"

using namespace flash_f32;

namespace {

constexpr int BQ = 128;     // query rows of a block
constexpr int R = 8;        // rows of a thread's tile: a warp's 32 rows over its four row groups
constexpr int PS = BQ + 4;  // row stride of the P tile: padded, so its transposed stores spread over the banks
constexpr int SMEM_BYTES = (BQ * D + 2 * TILE + T * PS) * 4;

template <bool kStats>
__global__ void __launch_bounds__(THREADS, 2)
flash_attn_f32_kernel(View q, View k, View v, OutView o, float* __restrict__ lse, int H, int N, int q_tiles,
                      float sm_scale, float scale_log2) {
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);  // [d][query row], row stride BQ
  float* kt = qt + BQ * D;                       // [d][key row]
  float* vs = kt + TILE;                         // [key row][d], swizzled
  float* pt = vs + TILE;                         // [key row][query row], row stride PS
  const int item = blockIdx.x;  // query tiles of one head next to each other: its K and V stay in L2
  const int bh = item / q_tiles, q0 = (item % q_tiles) * BQ;
  const int h = bh % H, b = bh / H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane & 7;
  const int r0 = 4 * R * warp + 4 * (lane >> 3);

  load_tile<BQ, true, false>(q, b, h, q0, N, qt, nullptr);
  float m[R], l[R], acc[R][8];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }
  const int tiles = (N + T - 1) / T;
  for (int t = 0; t < tiles; ++t) {
    const int k0 = t * T;
    __syncthreads();  // the last step's K, V and P are read
    load_tile<T, true, false>(k, b, h, k0, N, kt, nullptr);
    load_tile<T, false, true>(v, b, h, k0, N, nullptr, vs);
    __syncthreads();
    float s[R][8];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
    product_tr<R, BQ>(s, qt, kt, r0, g);
    if (k0 + T > N) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (k0 + col_of(g, j) >= N) {
#pragma unroll
          for (int i = 0; i < R; ++i) s[i][j] = -CUDART_INF_F;
        }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      float mx = s[i][0];
#pragma unroll
      for (int j = 1; j < 8; ++j) mx = fmaxf(mx, s[i][j]);
      const float m_new = fmaxf(m[i], row_max(mx));  // finite: every tile has a column below N
      const float alpha = exp2f((m[i] - m_new) * scale_log2);  // 0 on the first tile
      const float mb = m_new * scale_log2;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = exp2f(fmaf(s[i][j], scale_log2, -mb));
        sum += s[i][j];
      }
      l[i] = fmaf(l[i], alpha, sum);  // this thread's columns; summed over the row at the end
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] *= alpha;
      m[i] = m_new;
    }
    store_tr<R, PS>(pt, s, r0, g);
    __syncwarp();  // the warp reads only its own query rows of P
    product_rows<R, PS>(acc, pt, vs, r0, g);
  }
#pragma unroll
  for (int i = 0; i < R; ++i) l[i] = row_sum(l[i]);
  store_rows<R>(o, b, h, q0, N, acc, l, r0, g);
  if constexpr (kStats) {
    if (g == 0) {
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int row = q0 + row_in(r0, i);
        if (row < N) lse[static_cast<long long>(bh) * N + row] = fmaf(m[i], sm_scale, logf(l[i]));
      }
    }
  }
}

}  // namespace

// out = softmax(q k^T * sm_scale) v in f32, and with `lse` non-null each row's
// log-sum-exp; q, k, v and out (B, H, N, 64) f32 through their (batch, head, token)
// element strides, lse (B, H, N) f32 contiguous
extern "C" int tpuhar_flash_attn_f32(const void* q, const void* k, const void* v, void* out, void* lse,
                                     int B, int H, int N, float sm_scale,
                                     long long sqb, long long sqh, long long sqn,
                                     long long skb, long long skh, long long skn,
                                     long long svb, long long svh, long long svn,
                                     long long sob, long long soh, long long son, void* stream) {
  static bool ready[2][64] = {};
  cudaError_t err = allow_smem(flash_attn_f32_kernel<false>, SMEM_BYTES, ready[0]);
  if (err == cudaSuccess) err = allow_smem(flash_attn_f32_kernel<true>, SMEM_BYTES, ready[1]);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || H <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int q_tiles = (N + BQ - 1) / BQ;
  const long long items = static_cast<long long>(B) * H * q_tiles;
  if (items > 0x7fffffffll) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = lse != nullptr ? flash_attn_f32_kernel<true> : flash_attn_f32_kernel<false>;
  kernel<<<static_cast<unsigned>(items), THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      View{static_cast<const float*>(q), sqb, sqh, sqn}, View{static_cast<const float*>(k), skb, skh, skn},
      View{static_cast<const float*>(v), svb, svh, svn}, OutView{static_cast<float*>(out), sob, soh, son},
      static_cast<float*>(lse), H, N, q_tiles, sm_scale, sm_scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}
