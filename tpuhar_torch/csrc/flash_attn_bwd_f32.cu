// Non-causal flash attention backward on Hopper (sm_90a), f32, head_dim 64.
//
// The f32 form of csrc/flash_attn_bwd.cu: it replaces the same two backward kernels of
// the stock Pallas TPU flash kernel that tpuhar/ops/attention.py:
// flash_mha(kernel="library") differentiates through
// (jax.experimental.pallas.ops.tpu.flash_attention: _flash_attention_bwd_dkv, :941, and
// _flash_attention_bwd_dq, :1287) on f32 operands, where they run every product in f32.
// Per (batch, head), with S = Q K^T * sm_scale, P = exp(S - lse) (lse from the forward,
// csrc/flash_attn_f32.cu), dP = dO V^T and di = rowsum(O o dO):
//   dS = P o (dP - di) * sm_scale,   dV = P^T dO,   dK = dS^T Q,   dQ = dS K,
// all in f32 with nothing rounded to a narrower type. As in the bf16 form the dQ kernel
// forms di from the forward's f32 output and writes it for the dK/dV kernel, which runs
// after it on the same stream.
//
// q, k, v, O and dO are (B, H, N, 64) with any strides whose last one is 1 and whose rows
// start on 16-byte boundaries; lse and di are (B, H, N) f32, contiguous; dq, dk and dv are
// written through strides into (B, N, H, 64) buffers.
//
// What bounds it: operations. The backward of one (batch, head) needs five products of
// 2 N^2 64 (S, dP, then dV, dK and dQ; the two kernels compute S and dP in both, seven
// in all). At (16, 12, 1568) the dK/dV kernel's four are 241.7 GFLOP and the dQ kernel's
// three 181.3: 3.61 and 2.71 ms at the card's 67 TFLOP/s of f32 FFMA, against about
// 0.05 ms of memory traffic.
//
// Design (csrc/flash_f32.cuh): both kernels have the shape of the f32 forward: a block
// of 128 threads owns 64 rows of its held operands (16 a warp) and walks the 64-row tiles
// of the other two; every product is 64 k-steps of the register-tiled FFMA product (a
// thread holds a 4 x 8 tile of each result), the streamed tiles arrive transposed for the
// products over the head width and row-major (swizzled) for those over the rows, and a
// P or dS tile goes through the warp's own part of a shared tile with only __syncwarp
// between its store and its reads. No block writes what another writes, so the results
// need no atomics and are the same from call to call.
//  - dQ holds Q and dO (transposed) and streams K (both ways) and V (transposed):
//    S = Q K^T and dP = dO V^T in one loop over d, then dS goes transposed into the
//    warp's query rows of a shared tile and dQ += dS K. Before the loop it forms di for
//    its 64 rows, two threads a row over the f32 O and dO, writes it, and keeps each
//    thread's four rows of lse (times log2 e) and di in registers. Key columns past N get
//    P = 0 (exp(-lse) can overflow where every score of a row is very negative, and
//    inf x 0 is NaN); query rows past N compute on zeros and are not stored.
//    96 KB of shared memory: two blocks an SM.
//  - dK/dV holds K and V (transposed) and streams Q and dO (both ways) with their rows'
//    lse and di: S^T = K Q^T and dP^T = V dO^T in one loop over d, then P and dS in
//    registers; P goes into the warp's key columns of a shared [query row][key row] tile
//    for dV += P^T dO, then dS into the same place for dK += dS^T Q. Query rows past N
//    get P = 0, so they add nothing. 112.5 KB of shared memory: two blocks an SM.
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_f32.cuh"

using namespace flash_f32;

namespace {

constexpr int PS = T + 4;  // row stride of dQ's dS tile, padded as the forward's P tile
constexpr int DQ_SMEM = (5 * TILE + T * PS + T) * 4;
// two blocks an SM: K, V, Q and dO transposed, Q and dO row-major, the P/dS tile
// (unpadded: the padding would not leave room for the second block), lse and di
constexpr int DKV_SMEM = (7 * TILE + 2 * T) * 4;

__global__ void __launch_bounds__(THREADS, 2)
flash_bwd_dq_f32_kernel(View q, View k, View v, View o, View dout, const float* __restrict__ lse,
                        float* __restrict__ di, OutView dq, int H, int N, float sm_scale, float scale_log2) {
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);  // [d][query row]
  float* dot = qt + TILE;                        // [d][query row]
  float* kt = dot + TILE;                        // [d][key row]
  float* vt = kt + TILE;                         // [d][key row]
  float* ks = vt + TILE;                         // [key row][d], swizzled
  float* dst = ks + TILE;                        // [key row][query row], row stride PS
  float* di_s = dst + T * PS;                    // the block's rows of di
  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * T;
  const long long bh = static_cast<long long>(b) * H + h;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane & 7;
  const int r0 = 16 * warp + 4 * (lane >> 3);

  load_tile<T, true, false>(q, b, h, q0, N, qt, nullptr);
  load_tile<T, true, false>(dout, b, h, q0, N, dot, nullptr);
  {  // di = rowsum(O o dO): two neighbouring threads a row, 32 columns each
    const int r = threadIdx.x >> 1, half = threadIdx.x & 1, row = q0 + r;
    float sum = 0.f;
    if (row < N) {
      const float4* po = reinterpret_cast<const float4*>(row_of(o, b, h, row) + 32 * half);
      const float4* pd = reinterpret_cast<const float4*>(row_of(dout, b, h, row) + 32 * half);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 x = po[i], y = pd[i];
        sum = fmaf(x.x, y.x, sum);
        sum = fmaf(x.y, y.y, sum);
        sum = fmaf(x.z, y.z, sum);
        sum = fmaf(x.w, y.w, sum);
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if (half == 0) {
      di_s[r] = sum;
      if (row < N) di[bh * N + row] = sum;
    }
  }
  __syncthreads();
  float lse2[4], di_r[4];  // the thread's rows: lse * log2 e, and di (0 past N)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + r0 + i;
    lse2[i] = row < N ? lse[bh * N + row] * LOG2E : 0.f;
    di_r[i] = di_s[r0 + i];
  }
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int tiles = (N + T - 1) / T;
  for (int t = 0; t < tiles; ++t) {
    const int k0 = t * T;
    __syncthreads();  // the last step's K, V and dS are read
    load_tile<T, true, true>(k, b, h, k0, N, kt, ks);
    load_tile<T, true, false>(v, b, h, k0, N, vt, nullptr);
    __syncthreads();
    float s[4][8], dp[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      outer<4>(s, {ld4(qt + d * T + r0)}, ld4(kt + d * T + 4 * g), ld4(kt + d * T + 32 + 4 * g));
      outer<4>(dp, {ld4(dot + d * T + r0)}, ld4(vt + d * T + 4 * g), ld4(vt + d * T + 32 + 4 * g));
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const bool valid = k0 + col_of(g, j) < N;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = valid ? exp2f(fmaf(s[i][j], scale_log2, -lse2[i])) : 0.f;
        s[i][j] = p * (dp[i][j] - di_r[i]) * sm_scale;  // dS
      }
    }
    store_tr<4, PS>(dst, s, r0, g);
    __syncwarp();  // the warp reads only its own query rows of dS
    product_rows<4, PS>(acc, dst, ks, r0, g);
  }
  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  store_rows<4>(dq, b, h, q0, N, acc, one, r0, g);
}

__global__ void __launch_bounds__(THREADS, 2)
flash_bwd_dkv_f32_kernel(View q, View k, View v, View dout, const float* __restrict__ lse,
                         const float* __restrict__ di, OutView dk, OutView dv, int H, int N, float sm_scale,
                         float scale_log2) {
  extern __shared__ float4 smem4[];
  float* kt = reinterpret_cast<float*>(smem4);  // [d][key row]
  float* vt = kt + TILE;                         // [d][key row]
  float* qt = vt + TILE;                         // [d][query row]
  float* dot = qt + TILE;                        // [d][query row]
  float* qs = dot + TILE;                        // [query row][d], swizzled
  float* dos = qs + TILE;                        // [query row][d], swizzled
  float* buf = dos + TILE;                       // P, then dS: [query row][key row]
  float* lse_s = buf + TILE;                     // the tile's rows: lse * log2 e
  float* di_s = lse_s + T;                       // and di
  const int h = blockIdx.y, b = blockIdx.z, k0 = blockIdx.x * T;
  const long long bh = static_cast<long long>(b) * H + h;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane & 7;
  const int c0 = 16 * warp + 4 * (lane >> 3);  // the thread's key rows

  load_tile<T, true, false>(k, b, h, k0, N, kt, nullptr);
  load_tile<T, true, false>(v, b, h, k0, N, vt, nullptr);
  float dk_acc[4][8], dv_acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  const int tiles = (N + T - 1) / T;
  for (int t = 0; t < tiles; ++t) {
    const int row0 = t * T;
    __syncthreads();  // the last step's tiles are read
    load_tile<T, true, true>(q, b, h, row0, N, qt, qs);
    load_tile<T, true, true>(dout, b, h, row0, N, dot, dos);
    if (threadIdx.x < T) {
      const int row = row0 + threadIdx.x;
      lse_s[threadIdx.x] = row < N ? lse[bh * N + row] * LOG2E : 0.f;
      di_s[threadIdx.x] = row < N ? di[bh * N + row] : 0.f;
    }
    __syncthreads();
    float s[4][8], dp[4][8];  // S^T and dP^T: key rows c0 + i, query rows col_of(g, j)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      outer<4>(s, {ld4(kt + d * T + c0)}, ld4(qt + d * T + 4 * g), ld4(qt + d * T + 32 + 4 * g));
      outer<4>(dp, {ld4(vt + d * T + c0)}, ld4(dot + d * T + 4 * g), ld4(dot + d * T + 32 + 4 * g));
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int r = col_of(g, j);
      const bool valid = row0 + r < N;
      const float l2 = lse_s[r], dj = di_s[r];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = valid ? exp2f(fmaf(s[i][j], scale_log2, -l2)) : 0.f;
        s[i][j] = p;
        dp[i][j] = p * (dp[i][j] - dj) * sm_scale;  // dS^T
      }
    }
    store_tr<4, T>(buf, s, c0, g);  // P at [query row][key row]
    __syncwarp();  // the warp reads only its own key columns
    product_rows<4, T>(dv_acc, buf, dos, c0, g);
    __syncwarp();
    store_tr<4, T>(buf, dp, c0, g);  // dS
    __syncwarp();
    product_rows<4, T>(dk_acc, buf, qs, c0, g);
  }
  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  store_rows<4>(dk, b, h, k0, N, dk_acc, one, c0, g);
  store_rows<4>(dv, b, h, k0, N, dv_acc, one, c0, g);
}

bool grid_fits(int B, int H, int N) { return B > 0 && H > 0 && N > 0 && B <= 65535 && H <= 65535; }

}  // namespace

// dq of one backward, and di = rowsum(O o dO) (B, H, N) f32 for the dK/dV kernel, from
// q, k, v, the forward's f32 output o, dO and lse
extern "C" int tpuhar_flash_bwd_dq_f32(const void* q, const void* k, const void* v, const void* o,
                                       const void* dout, const void* lse, void* di, void* dq,
                                       int B, int H, int N, float sm_scale,
                                       long long sqb, long long sqh, long long sqn,
                                       long long skb, long long skh, long long skn,
                                       long long svb, long long svh, long long svn,
                                       long long sob, long long soh, long long son,
                                       long long sdb, long long sdh, long long sdn,
                                       long long sqgb, long long sqgh, long long sqgn,
                                       void* stream) {
  if (!grid_fits(B, H, N)) return static_cast<int>(cudaErrorInvalidValue);
  static bool ready[64] = {};
  const cudaError_t err = allow_smem(flash_bwd_dq_f32_kernel, DQ_SMEM, ready);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + T - 1) / T, H, B);
  flash_bwd_dq_f32_kernel<<<grid, THREADS, DQ_SMEM, static_cast<cudaStream_t>(stream)>>>(
      View{static_cast<const float*>(q), sqb, sqh, sqn}, View{static_cast<const float*>(k), skb, skh, skn},
      View{static_cast<const float*>(v), svb, svh, svn}, View{static_cast<const float*>(o), sob, soh, son},
      View{static_cast<const float*>(dout), sdb, sdh, sdn}, static_cast<const float*>(lse),
      static_cast<float*>(di), OutView{static_cast<float*>(dq), sqgb, sqgh, sqgn}, H, N, sm_scale,
      sm_scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}

// dk and dv of one backward: q, k, v, dO (B, H, N, 64) f32 through their (batch, head,
// token) element strides, lse and di (B, H, N) f32 contiguous (di from the dQ kernel),
// dk and dv written through theirs
extern "C" int tpuhar_flash_bwd_dkv_f32(const void* q, const void* k, const void* v, const void* dout,
                                        const void* lse, const void* di, void* dk, void* dv,
                                        int B, int H, int N, float sm_scale,
                                        long long sqb, long long sqh, long long sqn,
                                        long long skb, long long skh, long long skn,
                                        long long svb, long long svh, long long svn,
                                        long long sdb, long long sdh, long long sdn,
                                        long long skgb, long long skgh, long long skgn,
                                        long long svgb, long long svgh, long long svgn,
                                        void* stream) {
  if (!grid_fits(B, H, N)) return static_cast<int>(cudaErrorInvalidValue);
  static bool ready[64] = {};
  const cudaError_t err = allow_smem(flash_bwd_dkv_f32_kernel, DKV_SMEM, ready);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + T - 1) / T, H, B);
  flash_bwd_dkv_f32_kernel<<<grid, THREADS, DKV_SMEM, static_cast<cudaStream_t>(stream)>>>(
      View{static_cast<const float*>(q), sqb, sqh, sqn}, View{static_cast<const float*>(k), skb, skh, skn},
      View{static_cast<const float*>(v), svb, svh, svn}, View{static_cast<const float*>(dout), sdb, sdh, sdn},
      static_cast<const float*>(lse), static_cast<const float*>(di),
      OutView{static_cast<float*>(dk), skgb, skgh, skgn}, OutView{static_cast<float*>(dv), svgb, svgh, svgn},
      H, N, sm_scale, sm_scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}
