// What the f32 flash kernels (csrc/flash_attn_f32.cu, the forward, and
// csrc/flash_attn_bwd_f32.cu, the dQ and dK/dV kernels) share: the (B, H, N, 64) f32
// views they read and write and the shared-memory opt-in; and the forward's load of a
// tile into shared memory and register-tiled product step on the CUDA cores (the
// backward kernels run theirs on the tensor cores in split TF32).
//
// Every product of the forward is a tile product C += A B in f32 FFMA over k = 0 ..
// 63. A block has 128 threads; a thread owns an R x 8 tile of C, R = 4 or 8: rows r0 ..
// r0 + 3 (and r0 + 16 .. r0 + 19 for R = 8), r0 = 4 R * warp + 4 * (lane / 8), so a warp
// owns 4 R rows of its own, and columns 4 g .. 4 g + 3 and 32 + 4 g .. 32 + 4 g + 3,
// g = lane % 8, so the eight lanes of one row group hold a whole row between them (their
// row statistics are three shuffles). One step of k reads A's column k at each quad of
// the thread's rows and B's row k at its eight columns, R / 4 + 2 16-byte shared-memory
// loads, and issues 8 R FFMA: A is kept k-major (At[k][m]) and B as B[k][n]. A q, k or v
// tile is stored k-major over the head width (transposed, [d][row]) for the products
// that sum over d, and row-major ([row][d], its 16-byte chunks swizzled by the row) for
// those that sum over the rows. The shared-memory loads, not the FFMA, set the pace of
// a 4 x 8 tile: three loads of 16 bytes a lane for 32 FFMA; an 8 x 8 tile needs four
// for 64, where the registers allow it (the forward's two accumulators).
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash_f32 {

constexpr int D = 64;        // head_dim
constexpr int T = 64;        // rows of a tile: query rows of a block, key rows of a step
constexpr int THREADS = 128;
constexpr int TILE = T * D;  // floats of a tile
constexpr float LOG2E = 1.4426950408889634f;

struct View {  // a (B, H, N, 64) f32 input: element strides of batch, head, token
  const float* p;
  long long sb, sh, sn;
};
struct OutView {  // the same, an output
  float* p;
  long long sb, sh, sn;
};

__device__ __forceinline__ const float* row_of(const View& t, int b, int h, int row) {
  return t.p + b * t.sb + h * t.sh + row * t.sn;
}
__device__ __forceinline__ float* row_of(const OutView& t, int b, int h, int row) {
  return t.p + b * t.sb + h * t.sh + row * t.sn;
}

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ void st4(float* p, float4 x) { *reinterpret_cast<float4*>(p) = x; }

// the float offset of 16-byte chunk `chunk` (0 .. 15) of row `row` in a row-major tile:
// the chunk index XOR row % 8, so that the 32 lanes of a warp storing one chunk of 32
// consecutive rows hit every bank, and eight lanes reading chunks 0 .. 7 (or 8 .. 15) of
// one row do too
__device__ __forceinline__ int swz(int row, int chunk) { return row * D + ((chunk ^ (row & 7)) << 2); }

// Rows row0 .. row0 + kTileRows - 1 of one (batch, head) of `t` into shared memory:
// transposed into `tr` ([d][row], row stride kTileRows; kTr) and, for 64-row tiles,
// row-major, swizzled, into `rows` (kRowMajor); rows past N as zeros. Thread i loads
// 64 / (128 / kTileRows) floats of row i % kTileRows, eight 16-byte pieces at a time, so a
// warp's transposed stores go to 32 consecutive floats.
template <int kTileRows, bool kTr, bool kRowMajor>
__device__ __forceinline__ void load_tile(const View& t, int b, int h, int row0, int N, float* tr, float* rows) {
  static_assert(THREADS % kTileRows == 0 && (!kRowMajor || kTileRows == T), "a tile the block's threads cover");
  constexpr int kParts = THREADS / kTileRows;  // threads a row
  const int r = threadIdx.x % kTileRows, part = threadIdx.x / kTileRows;
#pragma unroll
  for (int c = 0; c < D / kParts / 32; ++c) {
    const int d0 = D / kParts * part + 32 * c;  // this pass's 32 columns
    float4 x[8];
    if (row0 + r < N) {
      const float4* src = reinterpret_cast<const float4*>(row_of(t, b, h, row0 + r) + d0);
#pragma unroll
      for (int i = 0; i < 8; ++i) x[i] = src[i];
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) x[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if constexpr (kTr) {
        float* col = tr + (d0 + 4 * i) * kTileRows + r;
        col[0] = x[i].x;
        col[kTileRows] = x[i].y;
        col[2 * kTileRows] = x[i].z;
        col[3 * kTileRows] = x[i].w;
      }
      if constexpr (kRowMajor) st4(rows + swz(r, d0 / 4 + i), x[i]);
    }
  }
}

// The thread's tile of a product holds R = 4 or 8 rows: r0 .. r0 + 3 and, for R = 8,
// r0 + 16 .. r0 + 19 (a warp's 32 rows), so that each quad of rows is one 16-byte load.
__device__ __forceinline__ int row_in(int r0, int i) { return r0 + (i & 3) + 16 * (i >> 2); }

// the thread's column j (0 .. 7) of a 64-wide tile
__device__ __forceinline__ int col_of(int g, int j) { return 4 * g + j + (j >= 4 ? 28 : 0); }

// c[i][j] += a[i] * (b0, b1)[j], a one float4 per quad of rows
template <int R>
__device__ __forceinline__ void outer(float (&c)[R][8], const float4 (&a)[R / 4], float4 b0, float4 b1) {
  const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
  for (int q = 0; q < R / 4; ++q) {
    const float av[4] = {a[q].x, a[q].y, a[q].z, a[q].w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) c[4 * q + i][j] = fmaf(av[i], bv[j], c[4 * q + i][j]);
  }
}

// the thread's rows of A's column k: At k-major with row stride kLda
template <int R, int kLda>
__device__ __forceinline__ void column(float4 (&a)[R / 4], const float* At, int k, int r0) {
#pragma unroll
  for (int q = 0; q < R / 4; ++q) a[q] = ld4(At + k * kLda + r0 + 16 * q);
}

// c += At^T B over k = 0 .. 63: At k-major with row stride kLda (A's column k at
// At + k * kLda), B k-major [k][64], read as stored
template <int R, int kLda>
__device__ __forceinline__ void product_tr(float (&c)[R][8], const float* At, const float* B, int r0, int g) {
#pragma unroll 8
  for (int k = 0; k < D; ++k) {
    float4 a[R / 4];
    column<R, kLda>(a, At, k, r0);
    outer<R>(c, a, ld4(B + k * T + 4 * g), ld4(B + k * T + 32 + 4 * g));
  }
}

// the same with B a swizzled row-major tile (`load_tile`'s `rows`)
template <int R, int kLda>
__device__ __forceinline__ void product_rows(float (&c)[R][8], const float* At, const float* B, int r0, int g) {
#pragma unroll 8
  for (int k = 0; k < T; ++k) {
    float4 a[R / 4];
    column<R, kLda>(a, At, k, r0);
    outer<R>(c, a, ld4(B + swz(k, g)), ld4(B + swz(k, 8 + g)));
  }
}

// the transpose of the thread's R x 8 tile into rows col_of(g, j) of a k-major tile of
// row stride kLd, at the thread's rows
template <int R, int kLd>
__device__ __forceinline__ void store_tr(float* dst, const float (&c)[R][8], int r0, int g) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int q = 0; q < R / 4; ++q)
      st4(dst + col_of(g, j) * kLd + r0 + 16 * q,
          make_float4(c[4 * q][j], c[4 * q + 1][j], c[4 * q + 2][j], c[4 * q + 3][j]));
}

// the sum (or max) of x over the eight lanes of the thread's row group
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int m = 1; m < 8; m <<= 1) x += __shfl_xor_sync(0xffffffffu, x, m);
  return x;
}
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int m = 1; m < 8; m <<= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, m));
  return x;
}

// the thread's rows of `c` (row_in) at rows row0 + that (those below N) of `out`,
// columns as col_of, each row's value divided by div[i]
template <int R>
__device__ __forceinline__ void store_rows(const OutView& out, int b, int h, int row0, int N, const float (&c)[R][8],
                                           const float (&div)[R], int r0, int g) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = row0 + row_in(r0, i);
    if (row >= N) continue;
    float* dst = row_of(out, b, h, row);
    st4(dst + 4 * g, make_float4(c[i][0] / div[i], c[i][1] / div[i], c[i][2] / div[i], c[i][3] / div[i]));
    st4(dst + 32 + 4 * g, make_float4(c[i][4] / div[i], c[i][5] / div[i], c[i][6] / div[i], c[i][7] / div[i]));
  }
}

// leave to use `bytes` of dynamic shared memory and the whole carveout, once per device
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, bool (&ready)[64]) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (!ready[device]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 static_cast<int>(cudaSharedmemCarveoutMaxShared));
    if (err != cudaSuccess) return err;
    ready[device] = true;
  }
  return cudaSuccess;
}

}  // namespace flash_f32
