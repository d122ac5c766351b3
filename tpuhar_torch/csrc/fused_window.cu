// Fused per-window IMU featurization on Hopper (sm_90a).
//
// Replaces the TPU kernel tpuhar/ops/fused_window.py: featurize_windows_pallas
// (body _fused_kernel), and the reference's fallback for the kernel sizes that kernel
// does not take: for each raw (T, C=6) window of IMU counts, scale channels 0-2 by
// 1/Racc and 3-5 by 1/Rgyro, take the median of k taps along time with zero-padded
// edges (k odd; 1 is no filter), then per channel the population mean and variance and
// (x - mean) / (std + 1e-8). Output is (B, C, T) f32.
//
// What bounds it: memory, and at serving batches latency. A 250x6 f32 window is 6 KB
// read and 6 KB written against a few hundred FLOPs per channel; at batch 256 the 3 MB
// a call moves take 0.9 us at 3.35 TB/s, less than one chain of dependent memory round
// trips. So a block's work is one load round trip, one pass over shared memory and one
// store, with as many bytes in flight as the block can issue. One block per window, one
// warp per channel (192 threads); the mean and variance are warp-shuffle reductions. The
// entry picks one of two forms from T (ops/fused_window.launch_plan mirrors the choice):
//
// - T <= 32 * MAX_LANE (1024): the register form, fused_window_kernel<R, K>, R the
//   samples a lane holds (the least power of two with 32 R >= T). The window is staged
//   in 16-byte loads, all issued before the first is used (a scalar head up to the first
//   16-byte boundary and a scalar tail, so any base and any T take this path), and
//   transposed on the way into one row per channel in static shared memory (at most
//   24.7 KB), scaled, with explicit zeros before and after the samples: the median's
//   taps are unit-stride reads, free of bank conflicts and of a branch per tap. Lane
//   `lane` of warp c filters samples t = lane + 32 j into registers, so each store of the
//   warp is 128 contiguous bytes; the mean, the centred squares and the z-score come
//   from those registers, and each output sample is written once. Nothing is read back
//   from global memory. K (1, 3 or 5: the identity or a min/max network in _med5's
//   argument order; 0: any other k, by rank) is a template parameter, outside the loop.
// - T > 1024: the tiled form, fused_window_tiled_kernel. The window goes through shared
//   memory in tiles of `tile` samples, each with the k / 2 samples on either side that its
//   medians reach (only those inside the window: the zero pads are implicit). Each lane
//   writes its filtered samples to the output row and keeps its share of their sum; the
//   statistics cover the whole window, so the z-score reads the row back (each lane only
//   what it wrote) once for the variance and once to normalize. A tile's span of
//   min(T, tile + k - 1) samples must fit one block's shared memory (227 KB): any k up to
//   8661 taps at tile = 1024, and any k at all for T <= 9685.
//
// Both forms sum in the same order (each lane's samples in rising t, then xor-shuffle
// folds), so for T <= 1024 the register form's output equals the tiled form's bit for bit.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int C = 6;             // channels: 0-2 accelerometer, 3-5 gyroscope
constexpr int THREADS = 32 * C;  // one warp a channel
constexpr int MAX_LANE = 32;     // samples a lane holds in the register form
constexpr int PAD = 2;           // zeros before and after a channel's row: the median-of-5's reach
constexpr int SMEM_MAX = 232448; // the shared memory one block can use on an H100

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
// tap(u) is the scaled sample u, for u in [0, T).
template <typename Tap>
__device__ __noinline__ float median_rank(Tap tap, int t, int h, int T) {
  const int a = max(t - h, 0), e = min(t + h, T - 1);
  const int zeros = 2 * h + 1 - (e - a + 1);
  for (int u = a; u <= e; ++u) {
    const float v = tap(u);
    int below = v > 0.f ? zeros : 0, at_most = v >= 0.f ? zeros : 0;
    for (int w = a; w <= e; ++w) {
      const float x = tap(w);
      below += x < v;
      at_most += x <= v;
    }
    if (below <= h && h < at_most) return v;
  }
  return 0.f;  // rank h falls on the zero pads
}

// a channel's row in shared memory, scaled
struct RowTap {
  const float* row;
  __device__ float operator()(int u) const { return row[u]; }
};

// a tile's span as stored, (rows, C), scaled at the read
struct SpanTap {
  const float* span;
  int lo, c;
  float s;
  __device__ float operator()(int u) const { return span[(u - lo) * C + c] * s; }
};

// The register form: one block per window, T <= 32 R. K: the median's taps when 1, 3 or
// 5, else 0 (by rank, k taps).
template <int R, int K>
__global__ void __launch_bounds__(THREADS) fused_window_kernel(
    const float* __restrict__ raw, float* __restrict__ out, int T, float acc_scale,
    float gyro_scale, int k, int normalize) {
  constexpr int S = 32 * R + 2 * PAD;  // a row: PAD zeros, T samples, zeros up to S
  constexpr int LOADS = (C * 32 * R / 4 + THREADS - 1) / THREADS;  // 16-byte loads a thread
  __shared__ float rows[C * S];

  const float* src = raw + static_cast<size_t>(blockIdx.x) * T * C;
  const int n = T * C;
  // the floats before the first 16-byte boundary, the 16-byte body, the floats after it
  const int head = min(n, static_cast<int>(((16 - (reinterpret_cast<uintptr_t>(src) & 15)) & 15) >> 2));
  const int body = (n - head) >> 2;
  const int tail = n - head - 4 * body;
  const float4* vec = reinterpret_cast<const float4*>(src + head);
  float4 v[LOADS];
#pragma unroll
  for (int i = 0; i < LOADS; ++i) {
    const int q = threadIdx.x + THREADS * i;
    if (q < body) v[i] = __ldg(vec + q);
  }
  int at = -1;  // threads 0-2 take the head's floats, threads 4-6 the tail's
  if (threadIdx.x < head) at = threadIdx.x;
  else if (threadIdx.x >= 4 && threadIdx.x < 4 + tail) at = head + 4 * body + threadIdx.x - 4;
  const float edge = at >= 0 ? __ldg(src + at) : 0.f;

  // while the loads are in flight: the zeros of every row, before and after its samples
  const int zeros = S - T;
  for (int i = threadIdx.x; i < C * zeros; i += THREADS) {
    const int c = i / zeros, j = i - c * zeros;
    rows[c * S + (j < PAD ? j : T + j)] = 0.f;
  }
  // element idx of the window is sample idx / C of channel idx % C
  auto put = [&](int idx, float x) {
    const int t = idx / C, c = idx - t * C;
    rows[c * S + PAD + t] = x * (c < 3 ? acc_scale : gyro_scale);
  };
#pragma unroll
  for (int i = 0; i < LOADS; ++i) {
    const int q = threadIdx.x + THREADS * i;
    if (q < body) {
      const int idx = head + 4 * q;
      put(idx, v[i].x);
      put(idx + 1, v[i].y);
      put(idx + 2, v[i].z);
      put(idx + 3, v[i].w);
    }
  }
  if (at >= 0) put(at, edge);
  __syncthreads();

  const int c = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* row = rows + c * S + PAD;  // row[u] for u in [-PAD, 32 R + PAD)
  float m[R];
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < R; ++j) {
    if (32 * j >= T) break;  // uniform: no sample of the warp here
    const int t = lane + 32 * j;
    if constexpr (K == 1) {
      m[j] = row[t];
    } else if constexpr (K == 3) {
      m[j] = med3(row[t + 1], row[t], row[t - 1]);
    } else if constexpr (K == 5) {  // the order of _med5's arguments: x[t+2] .. x[t-2]
      m[j] = med5(row[t + 2], row[t + 1], row[t], row[t - 1], row[t - 2]);
    } else {
      m[j] = t < T ? median_rank(RowTap{row}, t, k / 2, T) : 0.f;
    }
    if (t < T) sum += m[j];
  }
  if (normalize) {
    const float nf = static_cast<float>(T);
    const float mean = warp_sum(sum) / nf;
    float sq = 0.f;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      if (32 * j >= T) break;
      if (lane + 32 * j < T) {
        const float d = m[j] - mean;
        sq += d * d;
      }
    }
    const float var = warp_sum(sq) / nf;
    const float inv = 1.f / (sqrtf(var) + 1e-8f);
#pragma unroll
    for (int j = 0; j < R; ++j) {
      if (32 * j >= T) break;
      m[j] = (m[j] - mean) * inv;
    }
  }
  float* dst = out + (static_cast<size_t>(blockIdx.x) * C + c) * T;
#pragma unroll
  for (int j = 0; j < R; ++j) {
    if (32 * j >= T) break;
    if (lane + 32 * j < T) dst[lane + 32 * j] = m[j];
  }
}

// The tiled form, for any T. blockDim.x == THREADS; dynamic shared memory holds one
// tile's span of the window, as stored: (min(T, tile + k - 1), C) samples.
__global__ void fused_window_tiled_kernel(const float* __restrict__ raw, float* __restrict__ out,
                                          int T, float acc_scale, float gyro_scale, int k,
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
        m = median_rank(SpanTap{span, lo, c, s}, t, h, T);
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

template <int R>
void launch_registers(const float* raw, float* out, int B, int T, float acc_scale,
                      float gyro_scale, int k, int normalize, cudaStream_t stream) {
  const int K = k <= 5 ? k : 0;
  switch (K) {
    case 1: fused_window_kernel<R, 1><<<B, THREADS, 0, stream>>>(raw, out, T, acc_scale, gyro_scale, k, normalize); break;
    case 3: fused_window_kernel<R, 3><<<B, THREADS, 0, stream>>>(raw, out, T, acc_scale, gyro_scale, k, normalize); break;
    case 5: fused_window_kernel<R, 5><<<B, THREADS, 0, stream>>>(raw, out, T, acc_scale, gyro_scale, k, normalize); break;
    default: fused_window_kernel<R, 0><<<B, THREADS, 0, stream>>>(raw, out, T, acc_scale, gyro_scale, k, normalize);
  }
}

// once per device, at its first call (eager, before any graph captures one): leave the
// tiled form to use up to SMEM_MAX bytes of dynamic shared memory
cudaError_t allow_smem() {
  static bool ready[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (!ready[device]) {
    err = cudaFuncSetAttribute(fused_window_tiled_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (err != cudaSuccess) return err;
    ready[device] = true;
  }
  return cudaSuccess;
}

}  // namespace

// raw (B, T, C) f32 contiguous, any 4-byte aligned base; out (B, C, T) f32. k: the
// median's taps, odd (1 = no filter); tile: samples a tile of the tiled form (the
// wrapper's choice, ops/fused_window.py). The form follows from T alone.
extern "C" int tpuhar_fused_window(const void* raw, void* out, int B, int T, int channels,
                                   float acc_scale, float gyro_scale, int k, int tile,
                                   int normalize, void* stream) {
  if (k < 1 || k % 2 == 0 || tile < 1 || B < 1 || T < 1 || channels != C)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = allow_smem();
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* x = static_cast<const float*>(raw);
  auto* y = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  if (T <= 32 * MAX_LANE) {
    if (T <= 32) launch_registers<1>(x, y, B, T, acc_scale, gyro_scale, k, normalize, s);
    else if (T <= 64) launch_registers<2>(x, y, B, T, acc_scale, gyro_scale, k, normalize, s);
    else if (T <= 128) launch_registers<4>(x, y, B, T, acc_scale, gyro_scale, k, normalize, s);
    else if (T <= 256) launch_registers<8>(x, y, B, T, acc_scale, gyro_scale, k, normalize, s);
    else if (T <= 512) launch_registers<16>(x, y, B, T, acc_scale, gyro_scale, k, normalize, s);
    else launch_registers<32>(x, y, B, T, acc_scale, gyro_scale, k, normalize, s);
  } else {
    const long long rows = T < static_cast<long long>(tile) + k - 1 ? T : static_cast<long long>(tile) + k - 1;
    const size_t smem = static_cast<size_t>(rows) * C * sizeof(float);
    if (smem > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
    fused_window_tiled_kernel<<<B, THREADS, smem, s>>>(x, y, T, acc_scale, gyro_scale, k, tile,
                                                       normalize);
  }
  return static_cast<int>(cudaGetLastError());
}
