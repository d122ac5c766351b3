// Fused per-window IMU featurization on Hopper (sm_90a).
//
// Replaces the TPU kernel tpuhar/ops/fused_window.py: featurize_windows_pallas
// (body _fused_kernel), and the reference's fallback for the kernel sizes that kernel
// does not take: for each raw (T, C=6) window of IMU counts, scale channels 0-2 by
// 1/Racc and 3-5 by 1/Rgyro, take the median of k taps along time with zero-padded
// edges (k odd; 1 is no filter), then per channel the population mean and variance and
// (x - mean) / (std + 1e-8). Output is (B, C, T) f32.
//
// What bounds it: memory. A 250x6 f32 window is 6 KB read and 6 KB written against a
// few hundred FLOPs per channel. So the kernel reads each window once, coalesced, into
// shared memory, does there the (T, C) -> (C, T) transpose that the TPU version does
// outside its kernel, and writes each channel's row contiguous. One block per window,
// one warp per channel; the mean and variance are warp-shuffle reductions.
//
// Any T: the window goes through shared memory in tiles of `tile` samples, each with the
// k / 2 samples on either side that its medians reach (only those inside the window:
// the zero pads are implicit). Each lane writes its filtered samples to the output row
// and keeps its share of their sum; the statistics cover the whole window, so the
// z-score reads the row back (each lane only what it wrote) once for the variance and
// once to normalize. k = 3 and 5 use min/max networks; other k find the median by rank.
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float med3(float a, float b, float c) {
  return fmaxf(fminf(a, b), fminf(fmaxf(a, b), c));
}

// the min/max network of _med5 (fused_window.py:30-34)
__device__ __forceinline__ float med5(float a, float b, float c, float d, float e) {
  const float f = fmaxf(fminf(a, b), fminf(c, d));
  const float g = fminf(fmaxf(a, b), fmaxf(c, d));
  return med3(e, f, g);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The median of the k = 2 h + 1 taps t - h .. t + h, those outside [0, T) zero: the one
// value whose rank range (how many taps are below it, how many at most it) holds h.
__device__ float median_rank(const float* span, int lo, int t, int h, int T, int C, int c,
                             float s) {
  const int a = max(t - h, 0), e = min(t + h, T - 1);
  const int zeros = 2 * h + 1 - (e - a + 1);
  for (int u = a; u <= e; ++u) {
    const float v = span[(u - lo) * C + c] * s;
    int below = v > 0.f ? zeros : 0, at_most = v >= 0.f ? zeros : 0;
    for (int w = a; w <= e; ++w) {
      const float x = span[(w - lo) * C + c] * s;
      below += x < v;
      at_most += x <= v;
    }
    if (below <= h && h < at_most) return v;
  }
  return 0.f;  // rank h falls on the zero pads
}

// blockDim.x == 32 * C; dynamic shared memory holds one tile's span of the window, as
// stored: (min(T, tile + k - 1), C) samples.
__global__ void fused_window_kernel(const float* __restrict__ raw, float* __restrict__ out,
                                    int T, int C, float acc_scale, float gyro_scale, int k,
                                    int tile, int normalize) {
  extern __shared__ float span[];
  const float* src = raw + static_cast<size_t>(blockIdx.x) * T * C;
  const int c = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int h = k / 2;
  const float s = c < 3 ? acc_scale : gyro_scale;
  float* dst = out + (static_cast<size_t>(blockIdx.x) * C + c) * T;
  float sum = 0.f;
  for (int t0 = 0; t0 < T; t0 += tile) {
    const int lo = max(t0 - h, 0), hi = min(t0 + tile + h, T);
    __syncthreads();  // the tile before is read
    for (int i = threadIdx.x; i < (hi - lo) * C; i += blockDim.x) span[i] = src[lo * C + i];
    __syncthreads();
    const int end = min(t0 + tile, T);
    for (int t = t0 + lane; t < end; t += 32) {
      auto tap = [&](int u) { return (u >= 0 && u < T) ? span[(u - lo) * C + c] * s : 0.f; };
      float m;
      if (k == 1) {
        m = tap(t);
      } else if (k == 3) {
        m = med3(tap(t + 1), tap(t), tap(t - 1));
      } else if (k == 5) {  // the order of _med5's arguments: x[t+2] .. x[t-2]
        m = med5(tap(t + 2), tap(t + 1), tap(t), tap(t - 1), tap(t - 2));
      } else {
        m = median_rank(span, lo, t, h, T, C, c, s);
      }
      dst[t] = m;
      sum += m;
    }
  }
  if (!normalize) return;
  // each lane reads back only the samples it wrote, so no barrier is needed below
  const float n = static_cast<float>(T);
  const float mean = warp_sum(sum) / n;
  float sq = 0.f;
  for (int t = lane; t < T; t += 32) {
    const float d = dst[t] - mean;
    sq += d * d;
  }
  const float var = warp_sum(sq) / n;
  const float inv = 1.f / (sqrtf(var) + 1e-8f);
  for (int t = lane; t < T; t += 32) dst[t] = (dst[t] - mean) * inv;
}

}  // namespace

// k: the median's taps, odd (1 = no filter); tile: samples a tile (the wrapper's
// choice, ops/fused_window.py); the span a tile needs is opted in above 48 KB
extern "C" int tpuhar_fused_window(const void* raw, void* out, int B, int T, int C,
                                   float acc_scale, float gyro_scale, int k, int tile,
                                   int normalize, void* stream) {
  if (k < 1 || k % 2 == 0 || tile < 1 || B < 1 || T < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = T < static_cast<long long>(tile) + k - 1 ? T : static_cast<long long>(tile) + k - 1;
  const size_t smem = static_cast<size_t>(rows) * C * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_window_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  fused_window_kernel<<<B, 32 * C, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(raw), static_cast<float*>(out), T, C, acc_scale,
      gyro_scale, k, tile, normalize);
  return static_cast<int>(cudaGetLastError());
}
