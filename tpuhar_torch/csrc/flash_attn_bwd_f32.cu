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
// Both kernels run every product on the tensor cores in split TF32 on the block shape of
// the f32 flash kernels (csrc/flash_f32.cuh, which holds what they share with the
// forward): a block holds 128 rows of one (batch, head), 64 for each of two consumer
// warpgroups, and a producer warpgroup walks the other side's rows in stages of 64.
// Launched with 168 registers a thread, which setmaxnreg moves to where they are needed
// (72 + 216 + 216).
//  - The producer brings the block's held rows once by TMA (raw f32, 64 KB) and then, each
//    stage, the stage's raw rows of two operands; its 128 threads split them into TF32 hi
//    and lo halves as [row][d] tiles, the K-major B of the products that sum over d, and
//    transpose those that a product summing over the stage's rows reads into [d][row]
//    tiles. A stage's two layouts are two parts with their own full and empty mbarriers,
//    so the producer writes one while the consumers read the other.
//  - A consumer's products over d take A from its held raw rows in shared memory, loaded
//    into registers and split there (whether a thread's values need split_raw_lo's full
//    recipe is known once a block), three m64n64k8 products a k-step, small terms first
//    (lo_a hi_b, hi_a lo_b, hi_a hi_b; lo_a lo_b is dropped). Every split here leaves lo
//    unrounded (split_raw_lo: the tensor cores read its top 19 bits, within 2^-21 of the
//    value against 2^-22 rounded). The products over the stage's rows take A straight from
//    the accumulators of those over d (acc_to_a), each stage's into a fresh accumulator
//    added to the running sum in f32 registers. A consumer whose 64 rows all lie past N
//    hands every stage straight back; held rows past N compute on zeros and are not
//    stored, each quad of threads storing 32 bytes of a row.
//
// dQ (a block holds 128 query rows, Q and dO; a stage is 64 key rows, K and V): before the
// loop each consumer thread forms di for its two query rows, a quarter of each row a lane
// over the f32 O (global) and dO (shared), writes it, and keeps it beside its rows'
// lse * log2 e; then it rewrites its own A fragments of Q and dO fragment-major, so that
// a half's A is four 16-byte loads. A stage: S = Q K^T and dP = dO V^T against the
// [key][d] tiles of K and V; P = 2^(S scale log2 e - lse log2 e) while dP is multiplied,
// with P = 0 in the key columns past N (exp(-lse) can overflow where every score of a row
// is very negative, and inf x 0 is NaN); the [key][d] part goes back; dS = P (dP - di)
// scale; dQ += dS K against K's [d][key] tiles. The [key][d] parts are a ring of two (64
// KB each): TMA lands a stage's raw K and V rows in a part's lo tiles and the producer
// splits them in place, so it splits stage t + 1 while the consumers still run S and dP
// of stage t. Only K needs the [d][key] layout (32 KB). With Q and dO, 225 KB: one block
// an SM.
//
// dK/dV (a block holds 128 key rows, K and V; a stage is 64 query rows, Q and dO): S^T =
// K Q^T and dP^T = V dO^T against the [query][d] tiles; P = 2^(S scale log2 e - lse
// log2 e) in place of S^T while dP^T is multiplied (query rows past N have lse = +inf, so
// P = 0); the [query][d] part goes back; dS = P (dP - di) scale; dV += P^T dO and dK +=
// dS^T Q against the [d][query] tiles. One stage of both layouts (128 KB) and a 32 KB
// landing buffer for the next stage's raw rows: the producer writes the next [query][d]
// part while the consumers run dV and dK, and the next [d][query] part while they run S^T
// and dP^T. The stage's lse (times log2 e; +inf past N) goes beside the [query][d] part,
// its di (0 past N) beside the other. 225 KB: one block an SM.
//
// Measured on an H100 (80GB HBM3, 700 W) at (16, 12, 1568, 64) by time_flash_f32, each
// change against the form before it in turns. dK/dV: stages of 64 query rows against 32
// in a two-stage ring (N = 32 for S^T and dP^T, K and V split again every 32 rows):
// 3.19-3.27 against 3.53-3.81 ms; lo unrounded 3.00-3.05 against 3.23-3.30; the
// [d][query] tiles transposed from the split [query][d] ones rather than split again
// 2.90-2.93 against 2.96-3.01; K and V's finiteness checked once 2.82-2.83 against
// 2.88-2.93; the halves 2.79-2.81 against 2.82-2.86. The register split (56/224, 88/208),
// exp2 by ex2.approx and a skew between the consumers moved it by 1% or less. Left out,
// for its time alone: the producer's split and transpose (-17%), the consumers' K and V
// loads and splits (-15%). dQ, against the FFMA form's 6.43-6.70 ms: one [key][d] part
// and a landing buffer (dK/dV's shape) 2.54-2.60; the ring of two parts 2.18-2.21 against
// 2.54-2.57 (without it the producer's split and transpose held 28% of the kernel, 8%
// with it); the fragment-major A 2.13-2.14 against 2.18-2.20; final 2.14-2.15 against
// 6.53-6.70. Slower, each in turns against the form it changed: Q and dO split once into
// hi and lo tiles, S and dP read A through descriptors (m64n32k8, stages of 32 key rows
// to fit) 2.54-2.56 against 2.18-2.20 (168 against 88 KB of shared-memory reads a
// consumer every 32 key rows); the next stage's Q prefetched while dQ runs (it spills)
// 2.67-2.71 against 2.54-2.58; 40/232 registers 2.29-2.31, 56/224 2.20-2.23 against
// 2.19-2.20; two [d][key] parts without the ring, level. held_finite taking the larger of
// one scan an operand (against one loop over both) leaves dK/dV 20 bytes of spills against
// 156: 2.63-2.69 ms against 2.76-2.81 in turns (dQ level).
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_f32.cuh"
#include "kernel_table.cuh"

using namespace flash_f32;

namespace {

// ---- what both kernels share beyond csrc/flash_f32.cuh --------------------------------
// The dQ kernel's held rows, fragment-major: consumer thread i's 16 values of head-column
// half `half` (what load_a gives it, a[kk][e]) as four 16-byte chunks at 64 i, chunk kk at
// position kk ^ (i / 2 % 4), so that the eight lanes of a 16-byte access cover every bank
__device__ __forceinline__ int frag_at(int half, int i, int kk) {
  return half * HELD_HALF + 64 * i + ((kk ^ ((i >> 1) & 3)) << 4);
}

__device__ __forceinline__ void load_frag(uint32_t (&a)[4][4], const uint8_t* rows, int half, int i) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint4 x = *reinterpret_cast<const uint4*>(rows + frag_at(half, i, kk));
    a[kk][0] = x.x;
    a[kk][1] = x.y;
    a[kk][2] = x.z;
    a[kk][3] = x.w;
  }
}

// the largest magnitude's bits among this thread's held raw rows r0 and r0 + 8 at `x`
__device__ __forceinline__ uint32_t held_top(const uint8_t* x, int r0, int lane) {
  uint32_t a[4][4], top = 0;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    load_a(a, x, half, r0, lane);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) top = max(top, a[kk][e] & 0x7FFFFFFFu);
  }
  return top;
}

// whether every value of this thread's held rows of the operands at `x` and `y` lies below
// 0x7F7FF000, where split_raw_lo_finite takes them (known once a block)
__device__ __forceinline__ bool held_finite(const uint8_t* x, const uint8_t* y, int r0, int lane) {
  return max(held_top(x, r0, lane), held_top(y, r0, lane)) < 0x7F7FF000u;
}

// acc (+)= A B over head-column half `half` of d, A a half of held raw rows loaded into
// `a` and split there (split_raw_lo's full recipe unless `finite`), B the K-major tile
// pair at b ([row][d]); leaves the half's products in flight as one commit group
__device__ __forceinline__ void held_half(float (&acc)[32], uint32_t (&a)[4][4], uint32_t (&a_lo)[4][4], uint32_t b,
                                          int half, bool finite) {
  if (finite)
    split_raw_lo_finite(a, a_lo);
  else
    split_raw_lo(a, a_lo);
  wgmma_fence();
  split_product(acc, a, a_lo, b, half, half == 0);
  wgmma_commit();
}

// acc = A B over the stage's 64 rows, A from accumulator `d` (acc_to_a; split_raw_lo's
// full recipe where `any`, else its finite form), B the [d][row] tile pair at b; waits
// for its products
template <bool kAny>
__device__ __forceinline__ void stage_product(float (&acc)[32], uint32_t (&a0)[4][4], uint32_t (&a0_lo)[4][4],
                                              uint32_t (&a1)[4][4], uint32_t (&a1_lo)[4][4], const float (&d)[BS / 2],
                                              uint32_t b) {
  acc_to_a(a0, d, 0);
  if constexpr (kAny)
    split_raw_lo(a0, a0_lo);
  else
    split_raw_lo_finite(a0, a0_lo);
  wgmma_fence();
  split_product(acc, a0, a0_lo, b, 0, true);
  wgmma_commit();
  acc_to_a(a1, d, 1);
  if constexpr (kAny)
    split_raw_lo(a1, a1_lo);
  else
    split_raw_lo_finite(a1, a1_lo);
  wgmma_fence();
  split_product(acc, a1, a1_lo, b, 1, false);
  wgmma_commit();
  wgmma_wait<0>();
}

// ---- dQ: a block holds 128 query rows; stages of 64 key rows -------------------------
// Q, dO, a ring of two [key][d] parts, the [d][key] part (K), and room to align to 1024
// bytes
constexpr int DQ_SMEM = 2 * HELD_BYTES + 2 * PART_BYTES + TR_BYTES + 1024;

__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_f32_kernel(View o, const float* __restrict__ lse, float* __restrict__ di, OutView dq, int H, int N,
                        float sm_scale, int heads_inner,
                        const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
                        const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap do_map) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ KeyRing ring;
  __shared__ uint64_t qo_full;  // Q and dO: TMA bytes
  uint8_t* smem = align_1024(smem_raw);
  uint8_t* rows = smem + 2 * HELD_BYTES;  // Q, dO, the two [key][d] parts, the [d][key] part
  uint8_t* tr = rows + 2 * PART_BYTES;
  const int q0 = blockIdx.x * HELD, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  const int k_tiles = (N + BS - 1) / BS;

  if (tid == 0) {
    ring.init();
    mbar_init(&qo_full, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    // ------------------------------- producer -------------------------------------
    reg_dealloc<72>();
    const int p = tid - 256;
    if (p == 0) {
      mbar_arrive_expect_tx(&qo_full, 2 * HELD_BYTES);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        load_box(smem + half * HELD_HALF, &q_map, &qo_full, heads_inner, 0, 32 * half, q0, h, b);
        load_box(smem + HELD_BYTES + half * HELD_HALF, &do_map, &qo_full, heads_inner, 3, 32 * half, q0, h, b);
      }
    }
    // K and V split in place, the B of S and dP; K transposed from its split tiles into the
    // [d][key] part, the B of dQ
    produce_keys(
        ring, rows, k_tiles, &k_map, &v_map, heads_inner, h, b, p,
        [](uint8_t* part, Blocks m) {
          split_rows(part + K_HI + TILE_BYTES, part + K_HI, m);
          split_rows(part + V_HI + TILE_BYTES, part + V_HI, m);
        },
        [tr](uint8_t* part, Blocks m) { transpose_rows(part + K_HI, tr, m); });
  } else {
    // ------------------------------- consumers ------------------------------------
    reg_alloc<216>();
    const int warp = (tid & 127) >> 5;
    const int r0 = 16 * warp + (lane >> 2);  // this thread's query rows r0 and r0 + 8 of its 64
    const int row0 = q0 + 64 * wg;
    if (row0 >= N) {
      hand_back_keys(ring, k_tiles, lane);
      return;
    }
    uint8_t* q_rows = smem + wg * (64 * 128);
    uint8_t* do_rows = q_rows + HELD_BYTES;
    const uint32_t rows_addr = smem_addr(rows), tr_addr = smem_addr(tr);
    const long long bh = static_cast<long long>(b) * H + h;
    const int col = 2 * (lane & 3);  // element e of an accumulator's group j: column 8 j + col + e % 2
    // this thread's rows: lse log2 e, and a quarter of O (head columns 16 (lane % 4) ..
    // +15), read while Q and dO land (rows past N: 0, where Q and dO are zeros)
    float lse2[2];
    float4 o_part[2][4];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + r0 + 8 * half;
      const bool valid = row < N;
      lse2[half] = valid ? lse[bh * N + row] * LOG2E : 0.f;
      const float* o_row = row_of(o, b, h, valid ? row : 0) + 16 * (lane & 3);
#pragma unroll
      for (int i = 0; i < 4; ++i) o_part[half][i] = valid ? ld4(o_row + 4 * i) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    mbar_wait(&qo_full, 0);
    // di = rowsum(O o dO) in f32: the four lanes of a row add their quarters
    float di_r[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + 8 * half;
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int chunk = 4 * (lane & 3) + i;  // head columns 4 chunk .. +3
        const float4 x = o_part[half][i];
        const float4 y = *reinterpret_cast<const float4*>(do_rows + (chunk >> 3) * HELD_HALF + r * 128 +
                                                          (((chunk & 7) ^ (r & 7)) << 4));
        sum = fmaf(x.x, y.x, sum);
        sum = fmaf(x.y, y.y, sum);
        sum = fmaf(x.z, y.z, sum);
        sum = fmaf(x.w, y.w, sum);
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      di_r[half] = sum;
      const int row = row0 + r;
      if ((lane & 3) == 0 && row < N) di[bh * N + row] = sum;
    }
    // Q and dO are loaded and split again every stage: whether the thread's values need
    // split_raw_lo's full recipe is known once, and its A fragments are rewritten
    // fragment-major once (four 16-byte loads a half then, not sixteen of 4 bytes)
    const bool qo_finite = held_finite(q_rows, do_rows, r0, lane);
    const int fi = tid & 127;
    {
      uint32_t f[4][4][4];  // Q's halves, then dO's
#pragma unroll
      for (int set = 0; set < 4; ++set) load_a(f[set], set & 2 ? do_rows : q_rows, set & 1, r0, lane);
      bar_sync(2 + wg, 128);  // every thread of this consumer has read its rows (and di its dO)
#pragma unroll
      for (int set = 0; set < 4; ++set)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          *reinterpret_cast<uint4*>((set & 2 ? do_rows : q_rows) + frag_at(set & 1, fi, kk)) =
              make_uint4(f[set][kk][0], f[set][kk][1], f[set][kk][2], f[set][kk][3]);
    }
    float dq_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq_acc[i] = 0.f;
    const float scale_log2 = sm_scale * LOG2E;

    for (int t = 0; t < k_tiles; ++t) {
      // two sets of A operands, a half (four k-steps) each: one is split while the
      // products of the other run, and each is written again only after those products
      // have been waited for
      uint32_t a0[4][4], a0_lo[4][4], a1[4][4], a1_lo[4][4];
      float s[BS / 2], dp[BS / 2];
      // S = Q K^T, then dP = dO V^T (64 query rows x 64 key columns), each over two halves
      // of d: B is the stage's [key][d] tiles
      const uint32_t kv = rows_addr + (t & 1) * PART_BYTES;  // the stage's [key][d] part
      mbar_wait(&ring.rows_full[t & 1], (t >> 1) & 1);
      load_frag(a0, q_rows, 0, fi);
      held_half(s, a0, a0_lo, kv + K_HI, 0, qo_finite);
      load_frag(a1, q_rows, 1, fi);
      held_half(s, a1, a1_lo, kv + K_HI, 1, qo_finite);
      wgmma_wait<1>();  // S's first half: a0 is free
      load_frag(a0, do_rows, 0, fi);
      held_half(dp, a0, a0_lo, kv + V_HI, 0, qo_finite);
      wgmma_wait<1>();  // S: a1 is free
      load_frag(a1, do_rows, 1, fi);
      held_half(dp, a1, a1_lo, kv + V_HI, 1, qo_finite);
      // P = 2^(S scale log2 e - lse log2 e) in place of S while dP is multiplied; 0 in
      // the key columns past N (8 jj + e % 2 >= lim)
      const int lim = N - t * BS - col;
#pragma unroll
      for (int jj = 0; jj < BS / 8; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = exp2f(fmaf(s[4 * jj + e], scale_log2, -lse2[e >> 1]));
          s[4 * jj + e] = 8 * jj + (e & 1) < lim ? x : 0.f;
        }
      wgmma_wait<0>();
      __syncwarp();
      if (lane == 0) mbar_arrive(&ring.rows_empty[t & 1]);  // the [key][d] part goes back to the producer
      // dS = P (dP - di) scale in place of dP
#pragma unroll
      for (int i = 0; i < BS / 2; ++i) dp[i] = s[i] * (dp[i] - di_r[(i >> 1) & 1]) * sm_scale;
      // dQ += dS K over the stage's 64 key rows: A straight from the dS accumulator, B
      // K's [d][key] tiles; into a fresh accumulator, added to the running sum in f32
      mbar_wait(&ring.tr_full, t & 1);
      float part[D / 2];
      stage_product<true>(part, a0, a0_lo, a1, a1_lo, dp, tr_addr);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dq_acc[i] += part[i];
      __syncwarp();
      if (lane == 0) mbar_arrive(&ring.tr_empty);  // and the [d][key] part
    }
    // accumulator layout: group j's d[4j], d[4j+1] are row r0, head columns 8 j + col, +1;
    // d[4j+2], d[4j+3] the same columns of row r0 + 8
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + r0 + 8 * half;
      if (row >= N) continue;
      float* pq = row_of(dq, b, h, row);
#pragma unroll
      for (int jj = 0; jj < D / 8; ++jj)
        *reinterpret_cast<float2*>(pq + 8 * jj + col) = make_float2(dq_acc[4 * jj + 2 * half], dq_acc[4 * jj + 2 * half + 1]);
    }
  }
}

// ---- dK/dV: a block holds 128 key rows; stages of 64 query rows ----------------------
// the stage's two parts, each Q hi, Q lo, dO hi, dO lo: [query][d], the B of S^T and dP^T,
// then [d][query], the B of dV and dK
constexpr int Q_HI = 0, DO_HI = 2 * TILE_BYTES;
// K, V, the two parts, the landing buffer, and room to align to 1024 bytes
constexpr int DKV_SMEM = 2 * HELD_BYTES + 2 * PART_BYTES + LAND_BYTES + 1024;

__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_f32_kernel(const float* __restrict__ lse, const float* __restrict__ di, OutView dk, OutView dv,
                         int H, int N, float sm_scale, int heads_inner,
                         const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
                         const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap do_map) {
  extern __shared__ uint8_t smem_raw[];
  // each part of the stage: full (the producer's 128 threads, after their stores) and
  // empty (lane 0 of every consumer warp); the landing buffer and K/V: TMA bytes
  __shared__ uint64_t rows_full, rows_empty, tr_full, tr_empty, landed, kv_full;
  __shared__ __align__(16) float s_lse[BS];  // the stage's query rows: lse log2 e, +inf past N (rows part)
  __shared__ __align__(16) float s_di[BS];   // and di, 0 past N ([d][query] part)
  uint8_t* smem = align_1024(smem_raw);
  uint8_t* rows = smem + 2 * HELD_BYTES;  // K, V, the [query][d] part, the [d][query] part, landing
  uint8_t* tr = rows + PART_BYTES;
  uint8_t* land = tr + PART_BYTES;
  const int kv0 = blockIdx.x * HELD, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  const int q_tiles = (N + BS - 1) / BS;

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
    auto land_stage = [&](int t) {  // the raw Q and dO rows of stage t
      mbar_arrive_expect_tx(&landed, LAND_BYTES);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        load_box(land + half * TILE_HALF, &q_map, &landed, heads_inner, 0, 32 * half, t * BS, h, b);
        load_box(land + TILE_BYTES + half * TILE_HALF, &do_map, &landed, heads_inner, 3, 32 * half, t * BS, h, b);
      }
    };
    if (p == 0) {
      mbar_arrive_expect_tx(&kv_full, 2 * HELD_BYTES);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        load_box(smem + half * HELD_HALF, &k_map, &kv_full, heads_inner, 1, 32 * half, kv0, h, b);
        load_box(smem + HELD_BYTES + half * HELD_HALF, &v_map, &kv_full, heads_inner, 2, 32 * half, kv0, h, b);
      }
      land_stage(0);
    }
    const Blocks m(p);  // this thread's 4 x 4 blocks of a stage (split_rows, transpose_rows)
    const long long bh = static_cast<long long>(b) * H + h;
    for (int t = 0; t < q_tiles; ++t) {
      const int parity = t & 1;
      // lse log2 e (threads 0-63) or di (64-127) of query row t BS + p % 64
      const int row = t * BS + (p & (BS - 1));
      float stat = 0.f;
      if (p < BS)
        stat = row < N ? lse[bh * N + row] * LOG2E : __int_as_float(0x7F800000);
      else if (row < N)
        stat = di[bh * N + row];
      mbar_wait(&landed, parity);
      mbar_wait(&rows_empty, parity ^ 1);  // the consumers are past S^T and dP^T of stage t - 1
      split_rows(land, rows + Q_HI, m);
      split_rows(land + TILE_BYTES, rows + DO_HI, m);
      if (p < BS) s_lse[p] = stat;
      fence_proxy_async();  // the stores become visible to wgmma's reads
      mbar_arrive(&rows_full);
      bar_sync(1, 128);  // every producer thread has read the landing buffer
      if (p == 0 && t + 1 < q_tiles) land_stage(t + 1);
      mbar_wait(&tr_empty, parity ^ 1);  // and past dV and dK of stage t - 1
      // the thread reads back only the blocks it wrote itself
      transpose_rows(rows + Q_HI, tr + Q_HI, m);
      transpose_rows(rows + DO_HI, tr + DO_HI, m);
      if (p >= BS) s_di[p - BS] = stat;
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
    const uint8_t* v_rows = k_rows + HELD_BYTES;
    const uint32_t rows_addr = smem_addr(rows), tr_addr = smem_addr(tr);
    float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    const float scale_log2 = sm_scale * LOG2E;
    const int col = 2 * (lane & 3);  // element e of an accumulator's group j: column 8 j + col + e % 2
    mbar_wait(&kv_full, 0);
    // K and V are split again every stage: whether the thread's values need split_raw_lo's
    // full recipe is known once
    const bool kv_finite = held_finite(k_rows, v_rows, r0, lane);

    for (int t = 0; t < q_tiles; ++t) {
      // two sets of A operands, a half (four k-steps) each: one is split while the
      // products of the other run, and each is written again only after those products
      // have been waited for
      uint32_t a0[4][4], a0_lo[4][4], a1[4][4], a1_lo[4][4];
      float st[BS / 2], dpt[BS / 2];
      // S^T = K Q^T and dP^T = V dO^T (64 key rows x 64 query columns), each over two
      // halves of d: B is the stage's [query][d] tiles
      mbar_wait(&rows_full, t & 1);
      load_a(a0, k_rows, 0, r0, lane);
      held_half(st, a0, a0_lo, rows_addr + Q_HI, 0, kv_finite);
      load_a(a1, k_rows, 1, r0, lane);
      held_half(st, a1, a1_lo, rows_addr + Q_HI, 1, kv_finite);
      wgmma_wait<1>();  // S^T's first half: a0 is free
      load_a(a0, v_rows, 0, r0, lane);
      held_half(dpt, a0, a0_lo, rows_addr + DO_HI, 0, kv_finite);
      wgmma_wait<1>();  // S^T: a1 is free
      load_a(a1, v_rows, 1, r0, lane);
      held_half(dpt, a1, a1_lo, rows_addr + DO_HI, 1, kv_finite);
      // P = 2^(S scale log2 e - lse log2 e) in place of S^T while dP^T is multiplied
#pragma unroll
      for (int jj = 0; jj < BS / 8; ++jj) {
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
      for (int jj = 0; jj < BS / 8; ++jj) {
        const float2 d2 = *reinterpret_cast<const float2*>(&s_di[8 * jj + col]);
#pragma unroll
        for (int e = 0; e < 4; ++e) dpt[4 * jj + e] = st[4 * jj + e] * (dpt[4 * jj + e] - (e & 1 ? d2.y : d2.x)) * sm_scale;
      }
      // dV += P^T dO, then dK += dS^T Q, each over the stage's 64 query rows: A straight
      // from the accumulators (P <= 1 on every key row below N; past N it may overflow, in
      // rows that are not stored); B the [d][query] tiles. Each into a fresh accumulator,
      // added to the running sum in f32.
      float part[D / 2];
      stage_product<false>(part, a0, a0_lo, a1, a1_lo, st, tr_addr + DO_HI);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dv_acc[i] += part[i];
      stage_product<true>(part, a0, a0_lo, a1, a1_lo, dpt, tr_addr + Q_HI);
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

namespace tpuhar_kernels {
extern const Entry flash_attn_bwd_f32[2] = {
    {"flash_bwd_dq_f32", reinterpret_cast<const void*>(&flash_bwd_dq_f32_kernel)},
    {"flash_bwd_dkv_f32", reinterpret_cast<const void*>(&flash_bwd_dkv_f32_kernel)},
};
}  // namespace tpuhar_kernels

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
  // q and dO: boxes of a block's query rows; k and v: of a stage's key rows
  const flash_maps::Operand ops[4] = {
      {q, B, H, N, sqb, sqh, sqn, true}, {k, B, H, N, skb, skh, skn, true},
      {v, B, H, N, svb, svh, svn, true}, {dout, B, H, N, sdb, sdh, sdn, true}};
  CUtensorMap maps[4];
  int order = 0;
  const int boxes[4] = {HELD, BS, BS, HELD};
  if (!operand_maps(maps, order, ops, boxes)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + HELD - 1) / HELD, H, B);
  flash_bwd_dq_f32_kernel<<<grid, THREADS, DQ_SMEM, static_cast<cudaStream_t>(stream)>>>(
      View{static_cast<const float*>(o), sob, soh, son}, static_cast<const float*>(lse), static_cast<float*>(di),
      OutView{static_cast<float*>(dq), sqgb, sqgh, sqgn}, H, N, sm_scale, order, maps[0], maps[1], maps[2], maps[3]);
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
  // q and dO: boxes of a stage's query rows; k and v: of a block's key rows
  const flash_maps::Operand ops[4] = {
      {q, B, H, N, sqb, sqh, sqn, true}, {k, B, H, N, skb, skh, skn, true},
      {v, B, H, N, svb, svh, svn, true}, {dout, B, H, N, sdb, sdh, sdn, true}};
  CUtensorMap maps[4];
  int order = 0;
  const int boxes[4] = {BS, HELD, HELD, BS};
  if (!operand_maps(maps, order, ops, boxes)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + HELD - 1) / HELD, H, B);
  flash_bwd_dkv_f32_kernel<<<grid, THREADS, DKV_SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lse), static_cast<const float*>(di),
      OutView{static_cast<float*>(dk), skgb, skgh, skgn}, OutView{static_cast<float*>(dv), svgb, svgh, svgn},
      H, N, sm_scale, order, maps[0], maps[1], maps[2], maps[3]);
  return static_cast<int>(cudaGetLastError());
}
