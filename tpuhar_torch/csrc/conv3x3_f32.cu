// Fused 3x3 SAME conv + folded BatchNorm + residual + ReLU, f32 form.
//
// The same function as conv3x3.cu (the port of tpuhar/ops/conv3x3.py: conv3x3_bn_act)
// for f32 operands, which the JAX package's kernel also takes:
//   out = act(conv3x3_same(x) * scale + bias [+ residual])
// on NHWC planes x (N, S, S, C) f32, weights (9*C, C_out) f32 (the HWIO kernel
// reshaped), scale/bias (C_out,) f32, residual and out (N, S, S, C_out) f32.
//
// A tower in f32 runs it where the bf16 kernel cannot: an int8 engine's logit
// recalibration against the f32 program, and f32 serving. Its shapes there are small
// (the dry run's 2x2 and 1x1 maps), so it is the simple form: one thread an output
// element, the output channel fastest across a warp (the weight loads and the stores
// coalesce; the warp's x loads are one broadcast), the sum over the nine taps and C in
// f32 fused multiply-adds in the order (tap, c). Taps that fall off the plane are
// skipped, which is SAME padding with zeros. No tensor core: TF32 would round the
// operands, and the f32 function is the point.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
    conv3x3_bn_act_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                              const float* __restrict__ scale, const float* __restrict__ bias,
                              const float* __restrict__ residual, float* __restrict__ out,
                              long long M, int S, int C, int C_out, int relu) {
  const long long idx = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (idx >= M * C_out) return;
  const int n = static_cast<int>(idx % C_out);
  const long long m = idx / C_out;
  const int rem = static_cast<int>(m % (static_cast<long long>(S) * S));
  const int y = rem / S, xx = rem % S;
  const long long plane = m - rem;  // the first pixel of this pixel's frame
  float acc = 0.f;
  for (int tap = 0; tap < 9; ++tap) {
    const int yy = y + tap / 3 - 1, xt = xx + tap % 3 - 1;
    if (yy < 0 || yy >= S || xt < 0 || xt >= S) continue;
    const float* xr = x + (plane + static_cast<long long>(yy) * S + xt) * C;
    const float* wr = w + static_cast<long long>(tap) * C * C_out + n;
    for (int c = 0; c < C; ++c) acc = fmaf(xr[c], wr[static_cast<long long>(c) * C_out], acc);
  }
  float v = acc * scale[n] + bias[n];
  if (residual != nullptr) v += residual[idx];
  if (relu) v = fmaxf(v, 0.f);
  out[idx] = v;
}

}  // namespace

extern "C" int tpuhar_conv3x3_bn_act_f32(const void* x, const void* w, const void* scale,
                                         const void* bias, const void* residual, void* out,
                                         int M, int S, int C, int C_out, int relu,
                                         void* stream) {
  const long long elements = static_cast<long long>(M) * C_out;
  const long long blocks = (elements + THREADS - 1) / THREADS;
  if (M <= 0 || S <= 0 || C <= 0 || C_out <= 0 || blocks > 0x7fffffffll)
    return static_cast<int>(cudaErrorInvalidValue);
  conv3x3_bn_act_f32_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<const float*>(residual), static_cast<float*>(out), M, S, C, C_out, relu);
  return static_cast<int>(cudaGetLastError());
}
