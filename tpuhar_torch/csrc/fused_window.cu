// Fused per-window IMU featurization on Hopper (sm_90a).
//
// Replaces the TPU kernel tpuhar/ops/fused_window.py: featurize_windows_pallas
// (body _fused_kernel). For each raw (T, C=6) window of IMU counts: scale channels
// 0-2 by 1/Racc and 3-5 by 1/Rgyro, median-of-5 along time with zero-padded edges
// (skipped when medfilt is 0), then per channel the population mean and variance and
// (x - mean) / (std + 1e-8). Output is (B, C, T) f32.
//
// What bounds it: memory. A 250x6 f32 window is 6 KB read and 6 KB written against a
// few hundred FLOPs per channel. So the kernel reads each window once, coalesced, into
// shared memory, does there the (T, C) -> (C, T) transpose that the TPU version does
// outside its kernel, and writes each channel's row contiguous. One block per window,
// one warp per channel; the mean and variance are warp-shuffle reductions.
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

// blockDim.x == 32 * C; dynamic shared memory holds the window and the filtered rows.
__global__ void fused_window_kernel(const float* __restrict__ raw, float* __restrict__ out,
                                    int T, int C, float acc_scale, float gyro_scale,
                                    int medfilt, int normalize) {
  extern __shared__ float smem[];
  float* win = smem;           // (T, C), as stored
  float* rows = smem + T * C;  // (C, T), scaled and filtered
  const float* src = raw + static_cast<size_t>(blockIdx.x) * T * C;
  for (int i = threadIdx.x; i < T * C; i += blockDim.x) win[i] = src[i];
  __syncthreads();

  const int c = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float s = c < 3 ? acc_scale : gyro_scale;
  float* row = rows + c * T;
  float sum = 0.f;
  // each lane reads back only the samples it wrote, so no barrier is needed below
  for (int t = lane; t < T; t += 32) {
    float m;
    if (medfilt) {
      float v[5];
#pragma unroll
      for (int k = 0; k < 5; ++k) {
        const int u = t + 2 - k;  // the order of _med5's arguments: x[t+2] .. x[t-2]
        v[k] = (u >= 0 && u < T) ? win[u * C + c] * s : 0.f;
      }
      m = med5(v[0], v[1], v[2], v[3], v[4]);
    } else {
      m = win[t * C + c] * s;
    }
    row[t] = m;
    sum += m;
  }

  float* dst = out + (static_cast<size_t>(blockIdx.x) * C + c) * T;
  if (!normalize) {
    for (int t = lane; t < T; t += 32) dst[t] = row[t];
    return;
  }
  const float n = static_cast<float>(T);
  const float mean = warp_sum(sum) / n;
  float sq = 0.f;
  for (int t = lane; t < T; t += 32) {
    const float d = row[t] - mean;
    sq += d * d;
  }
  const float var = warp_sum(sq) / n;
  const float inv = 1.f / (sqrtf(var) + 1e-8f);
  for (int t = lane; t < T; t += 32) dst[t] = (row[t] - mean) * inv;
}

}  // namespace

extern "C" int tpuhar_fused_window(const void* raw, void* out, int B, int T, int C,
                                   float acc_scale, float gyro_scale, int medfilt,
                                   int normalize, void* stream) {
  const size_t smem = 2 * static_cast<size_t>(T) * C * sizeof(float);
  fused_window_kernel<<<B, 32 * C, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(raw), static_cast<float*>(out), T, C, acc_scale,
      gyro_scale, medfilt, normalize);
  return static_cast<int>(cudaGetLastError());
}
