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
// three 181.3, against about 0.05 ms of memory traffic: on the tensor cores in split TF32
// (three TF32 products an f32 one, 165 TFLOP/s of f32 work) 1.46 and 1.10 ms, on the
// CUDA cores' f32 FFMA (67 TFLOP/s) 3.61 and 2.71 ms.
//
// No block writes what another writes, so the results need no atomics and are the same
// from call to call.
//
// dQ (FFMA, csrc/flash_f32.cuh): a block of 128 threads owns 64 query rows (16 a warp) and
// walks the 64-row tiles of K and V; every product is 64 k-steps of the register-tiled
// FFMA product (a thread holds a 4 x 8 tile of each result). It holds Q and dO
// (transposed) and streams K (both ways) and V (transposed): S = Q K^T and dP = dO V^T in
// one loop over d, then dS goes transposed into the warp's query rows of a shared tile
// (only __syncwarp between its store and its reads) and dQ += dS K. Before the loop it
// forms di for its 64 rows, two threads a row over the f32 O and dO, writes it, and keeps
// each thread's four rows of lse (times log2 e) and di in registers. Key columns past N
// get P = 0 (exp(-lse) can overflow where every score of a row is very negative, and
// inf x 0 is NaN); query rows past N compute on zeros and are not stored. 96 KB of shared
// memory: two blocks an SM.
//
// dK/dV (split-TF32 wgmma, csrc/split_tf32.cuh; the block shape of the bf16 dK/dV
// kernel): a block owns 128 key rows and runs three warpgroups, launched with 168
// registers a thread that setmaxnreg moves to where they are needed (72 + 216 + 216).
//  - The producer warpgroup brings the block's K and V rows once by TMA (raw f32, 64 KB,
//    in 128-byte swizzled rows of 32 head columns) and then walks the query rows in
//    stages of 64: lane 0 brings a stage's raw Q and dO rows by TMA into a landing buffer
//    (4-D tensor maps over the strided views, csrc/flash_maps.cuh; rows past N arrive as
//    zeros); its 128 threads split them into TF32 hi and lo halves as [query][d] tiles,
//    the K-major B of S^T and dP^T, and then transpose those into [d][query] tiles, the
//    K-major B of dV and dK (TF32 wgmma reads both operands K-major). There is room for
//    one stage (64 KB a layout), so its two layouts are two parts with their own full and
//    empty mbarriers: the producer writes the next stage's [query][d] part while the
//    consumers run dV and dK on the [d][query] part, and the next [d][query] part while
//    they run S^T and dP^T; the next landing goes out as soon as the [query][d] part is
//    written. A thread owns two 4 x 4 blocks of each operand (query rows 8 j + par + 2 i,
//    head columns 4 c .. 4 c + 3) in every layout, so it reads back only what it wrote,
//    its loads and stores are 16 bytes, and no eight lanes of one share a bank. The
//    stage's lse (times log2 e; +inf past N) goes beside the [query][d] part, its di (0
//    past N) beside the other.
//  - Two consumer warpgroups own 64 key rows each. A stage: S^T = K Q^T and dP^T = V dO^T
//    (the sum over d), A from the raw K or V rows in shared memory, loaded into registers
//    and split there, three m64n64k8 products a k-step, small terms first (lo_a hi_b,
//    hi_a lo_b, hi_a hi_b; lo_a lo_b is dropped). Every split here leaves lo unrounded
//    (split_raw_lo: the tensor cores read its top 19 bits, within 2^-21 of the value
//    against 2^-22 rounded). P = 2^(S scale log2 e - lse log2 e) while dP^T is
//    multiplied, so query rows past N get P = 0 (their lse is +inf); then the [query][d]
//    part goes back; dS = P (dP - di) scale; then dV += P^T dO and dK += dS^T Q (the sum
//    over the stage's 64 query rows) with A straight from the S^T and dP^T accumulators,
//    split in registers. An accumulator's 8-column group j holds, in a thread's
//    d[4j .. 4j+3], columns 2t and 2t + 1 (t = lane % 4) of two rows; the register A
//    operand of a k-step holds columns t and t + 4. So a = {d[4j], d[4j+2], d[4j+1],
//    d[4j+3]} is the A of the k-step whose k-th column is query row 8 j + sigma(k),
//    sigma = (0, 2, 4, 6, 1, 3, 5, 7), and the [d][query] tiles hold the query rows in
//    that order: P and dS never go through shared memory. Each product runs in two
//    halves of its k-steps, each half's A in its own registers, so one half is split
//    while the other's products run; a register is written again only after the products
//    that read it have been waited for (ptxas serializes every wgmma otherwise). Each
//    stage's dV and dK products land in a fresh accumulator that is added to the running
//    sum in f32 registers, so the tensor cores' own accumulation spans 64 query rows and
//    not N. A consumer whose 64 key rows all lie past N hands every stage straight back;
//    key rows past N compute on zeros and are not stored. dk and dv leave as f32, each
//    quad of threads storing 32 bytes of a row.
//  225 KB of shared memory: one block an SM.
//  Measured on an H100 (80GB HBM3, 700 W) at (16, 12, 1568, 64) by time_flash_f32, each
//  change against the form before it in turns: stages of 64 query rows against 32 in a two-stage ring (N = 32 for S^T and dP^T,
//  K and V split again every 32 rows): 3.19-3.27 against 3.53-3.81 ms; lo unrounded
//  3.00-3.05 against 3.23-3.30; the [d][query] tiles transposed from the split [query][d]
//  ones rather than split again 2.90-2.93 against 2.96-3.01; K and V's finiteness
//  checked once 2.82-2.83 against 2.88-2.93; the halves 2.79-2.81 against 2.82-2.86. The
//  register split (56/224, 88/208), exp2 by ex2.approx and a skew between the consumers
//  moved it by 1% or less. Left out, for its time alone: the producer's split and
//  transpose (-17%), the consumers' K and V loads and splits (-15%).
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_f32.cuh"
#include "flash_maps.cuh"
#include "hopper.cuh"
#include "split_tf32.cuh"

using namespace flash_f32;
using namespace hopper;
using tf32x3::split_raw_lo;
using tf32x3::split_raw_lo_finite;

namespace {

constexpr int PS = T + 4;  // row stride of dQ's dS tile, padded as the forward's P tile
constexpr int DQ_SMEM = (5 * TILE + T * PS + T) * 4;

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

// ---- dK/dV: split-TF32 wgmma, Q and dO split by a producer warpgroup ---------------------
constexpr int KV_ROWS = 128;               // key rows a block owns: 64 a consumer warpgroup
constexpr int BQ = 64;                     // query rows of one stage
constexpr int DKV_THREADS = 384;           // two consumer warpgroups, then the producer
constexpr int KV_BYTES = KV_ROWS * D * 4;  // the block's K or V rows, raw: two 16 KB halves
constexpr int KV_HALF = KV_BYTES / 2;      // head columns 0-31, then 32-63
constexpr int TILE_BYTES = BQ * D * 4;     // a stage's Q or dO tile, hi or lo: two 8 KB halves
constexpr int TILE_HALF = TILE_BYTES / 2;  // [query][d]: head columns 0-31, then 32-63;
                                           // [d][query]: query rows 0-31, then 32-63
// the stage's two parts, each Q hi, Q lo, dO hi, dO lo: [query][d], the B of S^T and dP^T,
// then [d][query], the B of dV and dK
constexpr int Q_HI = 0, Q_LO = TILE_BYTES, DO_HI = 2 * TILE_BYTES, DO_LO = 3 * TILE_BYTES;
constexpr int PART_BYTES = 4 * TILE_BYTES;  // 64 KB
constexpr int LAND_BYTES = 2 * TILE_BYTES;  // the stage's raw Q, then dO rows, as TMA lands them
// K, V, the two parts, the landing buffer, and room to align to 1024 bytes
constexpr int DKV_SMEM = 2 * KV_BYTES + 2 * PART_BYTES + LAND_BYTES + 1024;

// Producer thread (j, par, c)'s 4 x 4 blocks of one operand's stage: query rows
// 8 (j + 4 g) + 2 i + par (i = 0..3) of block g = 0, 1 at head columns 4 c .. 4 c + 3.
// Eight lanes of a load or store are (j, par) = all eight pairs at one parity of c and
// four values of c % 8, so their 16-byte chunks fall on eight different bank groups in
// every layout.
// rows_at: the offset of query row q's chunk of head columns 4 c .. 4 c + 3 in a
// [query][d] tile (two halves of BQ rows x 128 bytes, swizzled), as TMA lands raw rows
__device__ __forceinline__ int rows_at(int q, int c) { return (c >> 3) * TILE_HALF + q * 128 + (((c & 7) ^ (q & 7)) << 4); }

// the raw rows of blocks 0 and 1 at `land` into TF32 halves at `tile` ([query][d]; hi,
// then lo TILE_BYTES on), a row at a time
__device__ __forceinline__ void split_rows(const uint8_t* land, uint8_t* tile, int j, int par, int c) {
#pragma unroll
  for (int g = 0; g < 2; ++g)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int at = rows_at(8 * (j + 4 * g) + 2 * i + par, c);
      const uint4 x = *reinterpret_cast<const uint4*>(land + at);
      uint32_t v[1][4] = {{x.x, x.y, x.z, x.w}}, lo[1][4];
      split_raw_lo(v, lo);
      *reinterpret_cast<uint4*>(tile + at) = make_uint4(v[0][0], v[0][1], v[0][2], v[0][3]);
      *reinterpret_cast<uint4*>(tile + TILE_BYTES + at) = make_uint4(lo[0][0], lo[0][1], lo[0][2], lo[0][3]);
    }
}

// the same blocks of the split [query][d] tiles at `rows` (hi, lo) transposed into
// `tile` as [d][query] (64 swizzled rows of 128 bytes a half; hi, then lo TILE_BYTES on),
// where position 8 j + 4 par + i of a half's row holds query row 8 j + 2 i + par (sigma:
// the order in which an accumulator's columns make the register A operand's k), so the
// thread's 4 rows at one head column are one 16-byte chunk
__device__ __forceinline__ void transpose_rows(const uint8_t* rows, uint8_t* tile, int j, int par, int c) {
#pragma unroll
  for (int g = 0; g < 2; ++g)
#pragma unroll
    for (int half = 0; half < 2; ++half) {  // hi, then lo
      uint32_t v[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint4 x =
            *reinterpret_cast<const uint4*>(rows + half * TILE_BYTES + rows_at(8 * (j + 4 * g) + 2 * i + par, c));
        v[i][0] = x.x;
        v[i][1] = x.y;
        v[i][2] = x.z;
        v[i][3] = x.w;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = 4 * c + e;
        const int at = half * TILE_BYTES + g * TILE_HALF + n * 128 + (((2 * j + par) ^ (n & 7)) << 4);
        *reinterpret_cast<uint4*>(tile + at) = make_uint4(v[0][e], v[1][e], v[2][e], v[3][e]);
      }
    }
}

// the register A operand of the 4 k-steps (8 head columns each) of head-column half
// `half` from this thread's rows r0 and r0 + 8 of 64 raw K or V rows at `rows` (head
// columns 0-31; 32-63 KV_HALF on): one 4-byte load an element, conflict-free under the
// swizzle
__device__ __forceinline__ void load_a(uint32_t (&a)[4][4], const uint8_t* rows, int half, int r0, int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      a[kk][e] = *reinterpret_cast<const uint32_t*>(rows + half * KV_HALF + (r0 + 8 * (e & 1)) * 128 +
                                                    (((2 * kk + (e >> 1)) ^ (r0 & 7)) << 4) + 4 * (lane & 3));
}

// the register A operand of the four k-steps over 32 of an accumulator's columns (half
// `half` of its 64; see the head of the file), as f32 bits to be split
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4][4], const float (&d)[BQ / 2], int half) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int j = 4 * half + kk;
    a[kk][0] = __float_as_uint(d[4 * j]);
    a[kk][1] = __float_as_uint(d[4 * j + 2]);
    a[kk][2] = __float_as_uint(d[4 * j + 1]);
    a[kk][3] = __float_as_uint(d[4 * j + 3]);
  }
}

// acc (+)= A B over half `half` of 64 k (its four k-steps kk): three m64n64k8 products a
// k-step, small terms first, B a K-major tile pair (hi at b, lo TILE_BYTES on) whose
// k-step lies `half` halves and kk 32-byte steps along its 128-byte rows; `first` starts
// the sum
__device__ __forceinline__ void split_product(float (&acc)[32], const uint32_t (&a)[4][4], const uint32_t (&a_lo)[4][4],
                                              uint32_t b, int half, bool first) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t at = b + half * TILE_HALF + kk * 32;
    wgmma_m64n64k8_rs_tf32(acc, a_lo[kk], wgmma_desc(at, 16, 1024), !(first && kk == 0));
    wgmma_m64n64k8_rs_tf32(acc, a[kk], wgmma_desc(at + TILE_BYTES, 16, 1024), 1);
    wgmma_m64n64k8_rs_tf32(acc, a[kk], wgmma_desc(at, 16, 1024), 1);
  }
}

__global__ void __launch_bounds__(DKV_THREADS, 1)
flash_bwd_dkv_f32_kernel(const float* __restrict__ lse, const float* __restrict__ di, OutView dk, OutView dv,
                         int H, int N, float sm_scale, int heads_inner,
                         const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
                         const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap do_map) {
  extern __shared__ uint8_t smem_raw[];
  // each part of the stage: full (the producer's 128 threads, after their stores) and
  // empty (lane 0 of every consumer warp); the landing buffer and K/V: TMA bytes
  __shared__ uint64_t rows_full, rows_empty, tr_full, tr_empty, landed, kv_full;
  __shared__ __align__(16) float s_lse[BQ];  // the stage's query rows: lse log2 e, +inf past N (rows part)
  __shared__ __align__(16) float s_di[BQ];   // and di, 0 past N ([d][query] part)
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* rows = smem + 2 * KV_BYTES;  // K, V, the [query][d] part, the [d][query] part, landing
  uint8_t* tr = rows + PART_BYTES;
  uint8_t* land = tr + PART_BYTES;
  const int kv0 = blockIdx.x * KV_ROWS, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  const int q_tiles = (N + BQ - 1) / BQ;

  if (tid == 0) {
    mbar_init(&rows_full, 128);
    mbar_init(&tr_full, 128);
    mbar_init(&rows_empty, 8);
    mbar_init(&tr_empty, 8);
    mbar_init(&landed, 1);
    mbar_init(&kv_full, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    // ------------------------------- producer -------------------------------------
    reg_dealloc<72>();
    const int p = tid - 256;
    // a map's dimensions are (64, heads, tokens, batch) where its bit of heads_inner is
    // set, else (64, tokens, heads, batch); a box is 32 head columns from d0
    auto load = [&](uint8_t* dst, const CUtensorMap* map, uint64_t* bar, int bit, int d0, int row) {
      if (heads_inner >> bit & 1)
        tma_load_4d(smem_addr(dst), map, bar, d0, h, row, b);
      else
        tma_load_4d(smem_addr(dst), map, bar, d0, row, h, b);
    };
    auto land_stage = [&](int t) {  // the raw Q and dO rows of stage t
      mbar_arrive_expect_tx(&landed, LAND_BYTES);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        load(land + half * TILE_HALF, &q_map, &landed, 0, 32 * half, t * BQ);
        load(land + TILE_BYTES + half * TILE_HALF, &do_map, &landed, 3, 32 * half, t * BQ);
      }
    };
    if (p == 0) {
      mbar_arrive_expect_tx(&kv_full, 2 * KV_BYTES);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        load(smem + half * KV_HALF, &k_map, &kv_full, 1, 32 * half, kv0);
        load(smem + KV_BYTES + half * KV_HALF, &v_map, &kv_full, 2, 32 * half, kv0);
      }
      land_stage(0);
    }
    // this thread's 4 x 4 blocks of a stage (split_rows, split_tr)
    const int par = p & 1, j = (p >> 1) & 3;
    const int c = 2 * ((j + (p >> 4)) & 3) + ((p >> 3) & 1) + 8 * (p >> 6);
    const long long bh = static_cast<long long>(b) * H + h;
    for (int t = 0; t < q_tiles; ++t) {
      const int parity = t & 1;
      // lse log2 e (threads 0-63) or di (64-127) of query row t BQ + p % 64
      const int row = t * BQ + (p & (BQ - 1));
      float stat = 0.f;
      if (p < BQ)
        stat = row < N ? lse[bh * N + row] * LOG2E : __int_as_float(0x7F800000);
      else if (row < N)
        stat = di[bh * N + row];
      mbar_wait(&landed, parity);
      mbar_wait(&rows_empty, parity ^ 1);  // the consumers are past S^T and dP^T of stage t - 1
      split_rows(land, rows + Q_HI, j, par, c);
      split_rows(land + TILE_BYTES, rows + DO_HI, j, par, c);
      if (p < BQ) s_lse[p] = stat;
      fence_proxy_async();  // the stores become visible to wgmma's reads
      mbar_arrive(&rows_full);
      bar_sync(1, 128);  // every producer thread has read the landing buffer
      if (p == 0 && t + 1 < q_tiles) land_stage(t + 1);
      mbar_wait(&tr_empty, parity ^ 1);  // and past dV and dK of stage t - 1
      // the thread reads back only the blocks it wrote itself
      transpose_rows(rows + Q_HI, tr + Q_HI, j, par, c);
      transpose_rows(rows + DO_HI, tr + DO_HI, j, par, c);
      if (p >= BQ) s_di[p - BQ] = stat;
      fence_proxy_async();
      mbar_arrive(&tr_full);
    }
  } else {
    // ------------------------------- consumers ------------------------------------
    reg_alloc<216>();
    const int warp = (tid & 127) >> 5;
    const int r0 = 16 * warp + (lane >> 2);  // this thread's key rows r0 and r0 + 8 of its 64
    const int key0 = kv0 + 64 * wg;
    if (key0 >= N) {
      // the last block's consumer whose 64 key rows all lie past N: hand every stage
      // straight back, so that the other consumer has the SM to itself
      for (int t = 0; t < q_tiles; ++t) {
        mbar_wait(&rows_full, t & 1);
        if (lane == 0) mbar_arrive(&rows_empty);
        mbar_wait(&tr_full, t & 1);
        if (lane == 0) mbar_arrive(&tr_empty);
      }
      return;
    }
    const uint8_t* k_rows = smem + wg * (64 * 128);
    const uint8_t* v_rows = k_rows + KV_BYTES;
    const uint32_t rows_addr = smem_addr(rows), tr_addr = smem_addr(tr);
    float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    const float scale_log2 = sm_scale * LOG2E;
    const int col = 2 * (lane & 3);  // element e of an accumulator's group j: column 8 j + col + e % 2
    mbar_wait(&kv_full, 0);
    // K and V are split again every stage: whether the thread's values need split_raw_lo's
    // full recipe is known once
    bool kv_finite;
    {
      uint32_t a[4][4], top = 0;
#pragma unroll
      for (int kv = 0; kv < 4; ++kv) {
        load_a(a, kv & 2 ? v_rows : k_rows, kv & 1, r0, lane);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e) top = max(top, a[kk][e] & 0x7FFFFFFFu);
      }
      kv_finite = top < 0x7F7FF000u;
    }
    auto split_kv = [&](uint32_t (&a)[4][4], uint32_t (&a_lo)[4][4]) {
      if (kv_finite)
        split_raw_lo_finite(a, a_lo);
      else
        split_raw_lo(a, a_lo);
    };

    for (int t = 0; t < q_tiles; ++t) {
      // two sets of A operands, a half (four k-steps) each: one is split while the
      // products of the other run, and each is written again only after those products
      // have been waited for
      uint32_t a0[4][4], a0_lo[4][4], a1[4][4], a1_lo[4][4];
      float st[BQ / 2], dpt[BQ / 2];
      // S^T = K Q^T and dP^T = V dO^T (64 key rows x 64 query columns), each over two
      // halves of d: B is the stage's [query][d] tiles
      mbar_wait(&rows_full, t & 1);
      load_a(a0, k_rows, 0, r0, lane);
      split_kv(a0, a0_lo);
      wgmma_fence();
      split_product(st, a0, a0_lo, rows_addr + Q_HI, 0, true);
      wgmma_commit();
      load_a(a1, k_rows, 1, r0, lane);
      split_kv(a1, a1_lo);
      wgmma_fence();
      split_product(st, a1, a1_lo, rows_addr + Q_HI, 1, false);
      wgmma_commit();
      wgmma_wait<1>();  // S^T's first half: a0 is free
      load_a(a0, v_rows, 0, r0, lane);
      split_kv(a0, a0_lo);
      wgmma_fence();
      split_product(dpt, a0, a0_lo, rows_addr + DO_HI, 0, true);
      wgmma_commit();
      wgmma_wait<1>();  // S^T: a1 is free
      load_a(a1, v_rows, 1, r0, lane);
      split_kv(a1, a1_lo);
      wgmma_fence();
      split_product(dpt, a1, a1_lo, rows_addr + DO_HI, 1, false);
      wgmma_commit();
      // P = 2^(S scale log2 e - lse log2 e) in place of S^T while dP^T is multiplied
#pragma unroll
      for (int jj = 0; jj < BQ / 8; ++jj) {
        const float2 l2 = *reinterpret_cast<const float2*>(&s_lse[8 * jj + col]);
#pragma unroll
        for (int e = 0; e < 4; ++e) st[4 * jj + e] = exp2f(fmaf(st[4 * jj + e], scale_log2, -(e & 1 ? l2.y : l2.x)));
      }
      wgmma_wait<0>();
      __syncwarp();
      if (lane == 0) mbar_arrive(&rows_empty);  // the [query][d] part goes back to the producer
      // dS = P (dP - di) scale in place of dP^T
      mbar_wait(&tr_full, t & 1);
#pragma unroll
      for (int jj = 0; jj < BQ / 8; ++jj) {
        const float2 d2 = *reinterpret_cast<const float2*>(&s_di[8 * jj + col]);
#pragma unroll
        for (int e = 0; e < 4; ++e) dpt[4 * jj + e] = st[4 * jj + e] * (dpt[4 * jj + e] - (e & 1 ? d2.y : d2.x)) * sm_scale;
      }
      // dV += P^T dO, then dK += dS^T Q, each over two halves of the stage's 64 query
      // rows: A straight from the accumulators, split in registers (P <= 1 on every key
      // row below N; past N it may overflow, in rows that are not stored); B the
      // [d][query] tiles. Each into a fresh accumulator, added to the running sum in f32.
      float part[D / 2];
      acc_to_a(a0, st, 0);
      split_raw_lo_finite(a0, a0_lo);
      wgmma_fence();
      split_product(part, a0, a0_lo, tr_addr + DO_HI, 0, true);
      wgmma_commit();
      acc_to_a(a1, st, 1);
      split_raw_lo_finite(a1, a1_lo);
      wgmma_fence();
      split_product(part, a1, a1_lo, tr_addr + DO_HI, 1, false);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dv_acc[i] += part[i];
      acc_to_a(a0, dpt, 0);
      split_raw_lo(a0, a0_lo);
      wgmma_fence();
      split_product(part, a0, a0_lo, tr_addr + Q_HI, 0, true);
      wgmma_commit();
      acc_to_a(a1, dpt, 1);
      split_raw_lo(a1, a1_lo);
      wgmma_fence();
      split_product(part, a1, a1_lo, tr_addr + Q_HI, 1, false);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dk_acc[i] += part[i];
      __syncwarp();
      if (lane == 0) mbar_arrive(&tr_empty);  // and the [d][query] part
    }
    // accumulator layout: group j's d[4j], d[4j+1] are row r0, head columns 8 j + col, +1;
    // d[4j+2], d[4j+3] the same columns of row r0 + 8
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = key0 + r0 + 8 * half;
      if (row >= N) continue;
      float* pk = row_of(dk, b, h, row);
      float* pv = row_of(dv, b, h, row);
#pragma unroll
      for (int jj = 0; jj < D / 8; ++jj) {
        *reinterpret_cast<float2*>(pk + 8 * jj + col) = make_float2(dk_acc[4 * jj + 2 * half], dk_acc[4 * jj + 2 * half + 1]);
        *reinterpret_cast<float2*>(pv + 8 * jj + col) = make_float2(dv_acc[4 * jj + 2 * half], dv_acc[4 * jj + 2 * half + 1]);
      }
    }
  }
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
  // q, k, v, dO: boxes of a stage's query rows, or of a block's key rows
  const flash_maps::Operand ops[4] = {
      {q, B, H, N, sqb, sqh, sqn, true}, {k, B, H, N, skb, skh, skn, true},
      {v, B, H, N, svb, svh, svn, true}, {dout, B, H, N, sdb, sdh, sdn, true}};
  const int rows[4] = {BQ, KV_ROWS, KV_ROWS, BQ};
  CUtensorMap maps[4];
  int order = 0;  // bit i set where operand i has its heads inside its tokens
  for (int i = 0; i < 4; ++i) {
    if (!flash_maps::operand_map(&maps[i], ops[i], rows[i])) return static_cast<int>(cudaErrorInvalidValue);
    order |= flash_maps::heads_inner(ops[i]) << i;
  }
  const dim3 grid((N + KV_ROWS - 1) / KV_ROWS, H, B);
  flash_bwd_dkv_f32_kernel<<<grid, DKV_THREADS, DKV_SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lse), static_cast<const float*>(di),
      OutView{static_cast<float*>(dk), skgb, skgh, skgn}, OutView{static_cast<float*>(dv), svgb, svgh, svgn},
      H, N, sm_scale, order, maps[0], maps[1], maps[2], maps[3]);
  return static_cast<int>(cudaGetLastError());
}
