// Fused int8 3x3 SAME conv on Hopper (sm_90a), int8 tensor cores.
//
// The int8 form of the TPU kernel tpuhar/ops/conv3x3.py: conv3x3_bn_act, and what XLA
// ran for ops/quant.py: int8_conv in the int8 tpu_cnn tower (down1 and every residual
// conv):
//   acc = conv3x3_same(x, w, stride)                  (int8 x int8, int32 accumulate)
//   y   = acc * scale + bias [+ res * res_scale]      (f32, scale = x_scale * w_scale)
//   y   = relu ? max(y, 0) : y
//   out = int8_out ? clip(rint(y / out_scale), -127, 127) : y
// on NHWC int8 x (N, S, S, C), weights (C_out, 9*C) (the HWIO kernel reshaped to
// (9*C, C_out) and transposed, so that each output channel's K run is contiguous),
// scale/bias (C_out,) f32, residual (N, So, So, C_out) int8, out (N, So, So, C_out)
// int8 or f32, So = ceil(S / stride). The source pixel of output (yo, xo) and tap
// (dy, dx) is (yo*stride + dy - pad_lo, xo*stride + dx - pad_lo), with XLA's SAME
// split: pad_lo = 1 at stride 1, 0 at stride 2 on an even plane.
//
// Design: the implicit GEMM of csrc/conv3x3.cu in int8. Rows are M = N*So*So output
// pixels, K is 9 taps x C, columns are C_out. For each K chunk (one tap, 64 channels)
// the block gathers the tap-shifted rows of x into shared memory with cp.async,
// zero-filling every row whose tap falls off the plane and the ragged last row tile,
// so edges are exact with no padded copy of x; the weights come the same way, 16
// bytes of one output channel's K run at a time. Both tiles keep each 16-byte K
// column as its own slab, so every 8x16-byte ldmatrix read is 128 contiguous bytes.
// Warps multiply with mma.sync m16n8k32 s8 (int32 accumulators in registers, exact:
// |acc| <= 4608 * 127^2 < 2^31), double-buffered so the next chunk's loads overlap
// this chunk's MMAs. The epilogue stages each 16x16 accumulator tile in shared memory
// and runs in JAX's order with the _rn intrinsics (never contracted into an FMA), so
// it is bit-exact against the plain PyTorch version, which runs each multiply, add and
// division as its own op.
//
// What bounds it: compute. At batch 256 (4096 frames) a 14x14x256 conv is 0.95 TOP
// against about 0.4 GB of int8 traffic. This tile design (mma.sync from shared memory,
// no TMA, no wgmma) is a first step; the int8 rate of wgmma is later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;  // output rows (pixels) per block
constexpr int BN = 128;  // output channels per block
constexpr int BK = 64;   // input channels per K chunk (within one tap)
constexpr int WARPS_M = 2, WARPS_N = 4;
constexpr int THREADS = 32 * WARPS_M * WARPS_N;
constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;  // 64 x 32 outputs per warp
constexpr int FM = WM / 16, FN = WN / 8;             // m16 x n8 MMA tiles per warp
// A tile: BK/16 slabs of BM rows x 16 bytes; B tile: BK/16 slabs of BN rows x 16
// bytes. 32 bytes of padding per slab spread a quarter warp's cp.async stores over
// the banks.
constexpr int SLAB = 128 * 16 + 32;
constexpr int A_TILE = (BK / 16) * SLAB;
constexpr int B_TILE = (BK / 16) * SLAB;
constexpr int A_VECS = BM * BK / 16 / THREADS;  // 16-byte copies per thread per chunk
constexpr int B_VECS = BN * BK / 16 / THREADS;
static_assert(BM == 128 && BN == 128, "slab size");
static_assert(A_VECS * THREADS * 16 == BM * BK, "A tile split");
static_assert(B_VECS * THREADS * 16 == BN * BK, "B tile split");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const int bytes = valid ? 16 : 0;  // 0 source bytes: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(smem)),
               "l"(gmem), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}
// four 8x16-byte matrices; lane l gives the address of row l % 8 of matrix l / 8 and
// receives, from matrix i, bytes 4*(l % 4) .. +3 of row l / 4 in r[i]
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(THREADS)
conv3x3_i8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                  const float* __restrict__ scale, const float* __restrict__ bias,
                  const int8_t* __restrict__ res, void* __restrict__ out, int M, int S,
                  int So, int C, int C_out, int stride, int pad_lo, int relu,
                  float res_scale, int int8_out, float out_scale) {
  __shared__ __align__(128) signed char As[2][A_TILE];
  __shared__ __align__(128) signed char Bs[2][B_TILE];
  __shared__ __align__(128) int Cs[WARPS_M * WARPS_N][16 * 16];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int n0 = blockIdx.x * BN;  // n-tiles of one row tile run next to each other
  const int m0 = blockIdx.y * BM;
  const int K = 9 * C;

  // the A rows this thread copies: output pixel, its frame, and its tap origin
  int a_row[A_VECS], a_kq[A_VECS], a_m[A_VECS], a_img[A_VECS], a_y0[A_VECS], a_x0[A_VECS];
#pragma unroll
  for (int i = 0; i < A_VECS; ++i) {
    const int idx = tid + i * THREADS;
    a_row[i] = idx / (BK / 16);
    a_kq[i] = idx % (BK / 16);
    a_m[i] = m0 + a_row[i];
    a_img[i] = a_m[i] / (So * So);
    const int rem = a_m[i] % (So * So);
    a_y0[i] = (rem / So) * stride - pad_lo;
    a_x0[i] = (rem % So) * stride - pad_lo;
  }
  // the B rows (output channels) this thread copies
  int b_row[B_VECS], b_kq[B_VECS];
#pragma unroll
  for (int i = 0; i < B_VECS; ++i) {
    const int idx = tid + i * THREADS;
    b_row[i] = idx / (BK / 16);
    b_kq[i] = idx % (BK / 16);
  }

  const int k_chunks = (C + BK - 1) / BK;
  const int steps = 9 * k_chunks;

  auto load = [&](int step, int buf) {
    const int tap = step / k_chunks;
    const int c0 = (step % k_chunks) * BK;
    const int dy = tap / 3, dx = tap % 3;
#pragma unroll
    for (int i = 0; i < A_VECS; ++i) {
      const int yy = a_y0[i] + dy, xx = a_x0[i] + dx, c = c0 + a_kq[i] * 16;
      const bool ok = a_m[i] < M && yy >= 0 && yy < S && xx >= 0 && xx < S && c < C;
      const int8_t* src =
          ok ? x + (static_cast<size_t>(a_img[i] * S + yy) * S + xx) * C + c : x;
      cp_async16(&As[buf][a_kq[i] * SLAB + a_row[i] * 16], src, ok);
    }
#pragma unroll
    for (int i = 0; i < B_VECS; ++i) {
      const int n = n0 + b_row[i], c = c0 + b_kq[i] * 16;
      const bool ok = n < C_out && c < C;
      const int8_t* src = ok ? w + static_cast<size_t>(n) * K + tap * C + c : w;
      cp_async16(&Bs[buf][b_kq[i] * SLAB + b_row[i] * 16], src, ok);
    }
  };

  int acc[FM][FN][4];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  // ldmatrix addressing: matrix mi = lane / 8 of an x4 load, row lane % 8 within it
  const int mi = lane >> 3, mr = lane & 7;

  load(0, 0);
  cp_async_commit();
  for (int step = 0; step < steps; ++step) {
    const int buf = step & 1;
    if (step + 1 < steps) load(step + 1, buf ^ 1);
    cp_async_commit();  // an empty group on the last step keeps the wait count uniform
    cp_async_wait_prev();
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {  // one m16n8k32 K step: slabs 2ks, 2ks+1
      uint32_t a[FM][4], b[FN][2];
#pragma unroll
      for (int i = 0; i < FM; ++i)  // matrices: rows 0-7 / 8-15 x K bytes 0-15 / 16-31
        ldmatrix_x4(a[i], &As[buf][(2 * ks + (mi >> 1)) * SLAB +
                                   (wm * WM + i * 16 + (mi & 1) * 8 + mr) * 16]);
#pragma unroll
      for (int j = 0; j < FN; j += 2) {  // matrices: n-tile j / j+1 x K bytes 0-15 / 16-31
        uint32_t r[4];
        ldmatrix_x4(r, &Bs[buf][(2 * ks + (mi & 1)) * SLAB +
                                (wn * WN + j * 8 + (mi >> 1) * 8 + mr) * 16]);
        b[j][0] = r[0];
        b[j][1] = r[1];
        b[j + 1][0] = r[2];
        b[j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) mma_s8(acc[i][j], a[i], b[j][0], b[j][1]);
    }
    __syncthreads();  // the next iteration's loads overwrite this buffer
  }

  // epilogue: each warp stages one 16x16 tile (two n8 MMA tiles) at a time in shared
  // memory; a lane then owns 8 consecutive channels of one row
  int* cs = Cs[warp];
  const int g = lane >> 2, t = lane & 3;  // the MMA's row group and column pair
  const int er = lane >> 1, ec = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < FM; ++i) {
#pragma unroll
    for (int j = 0; j < FN; j += 2) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        cs[g * 16 + h * 8 + 2 * t] = acc[i][j + h][0];
        cs[g * 16 + h * 8 + 2 * t + 1] = acc[i][j + h][1];
        cs[(g + 8) * 16 + h * 8 + 2 * t] = acc[i][j + h][2];
        cs[(g + 8) * 16 + h * 8 + 2 * t + 1] = acc[i][j + h][3];
      }
      __syncwarp();
      const int m = m0 + wm * WM + i * 16 + er;
      const int n = n0 + wn * WN + j * 8 + ec;
      if (m < M && n < C_out) {  // C_out % 32 == 0, so n < C_out means n + 8 <= C_out
        const size_t off = static_cast<size_t>(m) * C_out + n;
        float v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          v[e] = __fadd_rn(__fmul_rn(__int2float_rn(cs[er * 16 + ec + e]), scale[n + e]),
                           bias[n + e]);
        if (res != nullptr) {
          const uint2 r = *reinterpret_cast<const uint2*>(res + off);
          const int8_t* rq = reinterpret_cast<const int8_t*>(&r);
#pragma unroll
          for (int e = 0; e < 8; ++e)
            v[e] = __fadd_rn(v[e], __fmul_rn(static_cast<float>(rq[e]), res_scale));
        }
        if (relu) {
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] = fmaxf(v[e], 0.f);
        }
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

extern "C" int tpuhar_conv3x3_i8(const void* x, const void* w, const void* scale,
                                 const void* bias, const void* residual, void* out, int M,
                                 int S, int So, int C, int C_out, int stride, int pad_lo,
                                 int relu, float res_scale, int int8_out, float out_scale,
                                 void* stream) {
  const dim3 grid((C_out + BN - 1) / BN, (M + BM - 1) / BM);
  conv3x3_i8_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<const int8_t*>(residual), out, M, S, So, C, C_out, stride, pad_lo, relu,
      res_scale, int8_out, out_scale);
  return static_cast<int>(cudaGetLastError());
}
