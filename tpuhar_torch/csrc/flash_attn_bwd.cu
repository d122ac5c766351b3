// Non-causal flash attention backward on Hopper (sm_90a), bf16, head_dim 64.
//
// Replaces the two backward kernels of the stock Pallas TPU flash kernel that
// tpuhar/ops/attention.py: flash_mha(kernel="library") differentiates through
// (jax.experimental.pallas.ops.tpu.flash_attention: _flash_attention_bwd_dkv, :941, and
// _flash_attention_bwd_dq, :1287). Per (batch, head), with S = Q K^T * sm_scale,
// P = exp(S - lse) (lse from the forward, csrc/flash_attn.cu), dP = dO V^T and
// di = rowsum(O o dO) in f32:
//   dS = P o (dP - di) * sm_scale,   dV = P^T dO,   dK = dS^T Q,   dQ = dS K.
// The TPU computes di in XLA outside its kernels, from its bf16 O; here the dQ kernel
// computes it from the forward's O in f32 (csrc/flash_attn.cu's `o32`) and the dO rows it
// holds anyway, and writes it out for the dK/dV kernel, which runs after it on the same
// stream. di must be the O of the P that the backward recomputes: Sum_j dS_ij = 0 only
// for that one, and where attention is near uniform (the deep blocks of a model at init)
// dP - di is a small difference, so the bf16 rounding of O moved dq and dk by up to 9% of
// their largest element against an f32 backward (an H100, the pretraining model's first
// step); from the f32 O they stay within bf16's own error.
// P and dS are rounded to bf16 before their products, as the TPU kernels round them to
// dO's type; every product accumulates in f32, and dq, dk, dv are rounded to bf16 once.
//
// q, k, v and dO are (B, H, N, 64) with any strides whose last one is 1 (the wrapper
// hands over views of the (B, N, H*64) projections); lse and di are (B, H, N) f32,
// contiguous; dq, dk and dv are written through strides too, into (B, N, H, 64)
// buffers, so the projections' gradients need no transposing copy.
//
// What bounds it: operations. The backward of one (batch, head) needs five products of
// 2 N^2 64 (S, dP, then dV, dK and dQ; the two kernels here compute S and dP in both,
// seven in all) against q, k, v, dO, dq, dk, dv in bf16 and O in f32, each read or
// written once. At (16, 12, 1568) that is 0.31 ms of tensor-core work at 989 TFLOP/s
// against 0.10 ms of memory traffic.
//
// Design: two kernels, so that no block writes what another writes and the result needs
// no atomics. Both have one shape: one block per (128 rows of one operand pair, head,
// batch), three warpgroups launched with 168 registers a thread, which setmaxnreg moves
// to where they are needed (24 + 240 + 240 = 3 x 168). Two consumer warpgroups own 64 of
// the block's rows each; the block's rows of its two held operands arrive once by TMA
// and go from shared memory into registers, as the register A operands of the first two
// products. One producer warp (registers cut to 24) walks the tiles of 64 rows of the
// other two operands: lane 0 brings them by TMA into a four-stage ring, from 4-D tensor
// maps over the strided views (csrc/flash_maps.cuh: rows past N arrive as zeros, every
// 128-byte row in the swizzle wgmma reads), each stage counted on its full mbarrier.
// Each tile brought in serves all 128 rows, which halves its L2 traffic against 64-row
// blocks. Per tile a consumer starts its two products (wgmma m64n64k16, B K-major: the
// tile's head_dim along its 128-byte rows), takes P's exponentials while the second
// runs, forms dS, and starts its last products with A straight from the accumulators
// (their layout, packed to bf16 pairs, is the register A layout) and B = a tile as it
// lies (MN-major); then lane 0 of each warp hands the stage back through its empty
// mbarrier. While one consumer computes, the other's products hold the tensor cores. A
// consumer whose 64 rows all lie past N (the last block at N = 1568 holds 32 rows)
// hands every stage straight back. The results are rounded to bf16 once and stored
// through strides, 4 bytes a thread.
//  - dK/dV holds K and V and streams Q and dO: S^T = K Q^T and dP^T = V dO^T, then
//    dV += P^T dO and dK += dS^T Q. lse and di belong to the streamed query rows, so the
//    producer warp brings them into the ring by 4-byte cp.async (a (B, H, N) row starts
//    on a 16-byte boundary only where N % 4 == 0, which TMA needs), arriving on the full
//    mbarrier beside lane 0's TMA bytes. Query rows past N need no mask: their Q and dO
//    are zeros and their lse and di arrive as 0, so P = 1 there meets dP = 0, dS = 0 and
//    a zero dO row.
//  - dQ holds Q and dO and streams K and V: S = Q K^T and dP = dO V^T, then dQ += dS K.
//    lse and di belong to the held query rows: two scalars a thread, the same for every
//    tile, so they are read (lse) and formed (di) once, before the loop: the thread reads
//    the f32 O at the 16 columns of each of its two rows that its dO fragment holds,
//    and the four threads of a row sum their parts by shuffles. Query rows past N have
//    zero Q and dO and lse and di 0: dS = 0 there, and nothing is stored. Key rows past N
//    arrive as zero K and V rows, so dS K gets nothing from them, but P must be 0 there
//    (2^(-lse log2 e) overflows where every score of a row is very negative, and
//    inf x 0 is NaN): the last key tile, where N is not a multiple of 64, is peeled out
//    of the loop and masked; no other tile is.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <type_traits>

#include "flash_maps.cuh"
#include "hopper.cuh"

using namespace hopper;
using flash_maps::heads_inner;
using flash_maps::Operand;
using flash_maps::operand_map;

namespace {

constexpr int D = 64;  // head_dim
constexpr float LOG2E = 1.4426950408889634f;

struct OutView {  // a (B, H, N, 64) output: element strides of batch, head, token
  __nv_bfloat16* p;
  long long sb, sh, sn;
};
struct View32 {  // the same, an f32 input
  const float* p;
  long long sb, sh, sn;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// the warp's 16 rows of a (16, 64) f32 accumulator, rounded to bf16, at rows row0 .. of
// one (batch, head) of `out`; rows past N are not stored
__device__ __forceinline__ void store_rows(const OutView& out, int b, int h, int row0, int N,
                                           const float (&acc)[D / 8][4], int lane) {
  __nv_bfloat16* base = out.p + b * out.sb + h * out.sh;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + (lane >> 2) + 8 * half;
    if (row >= N) continue;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(base + row * out.sn + 8 * n + 2 * (lane & 3)) =
          pack_bf16(acc[n][2 * half], acc[n][2 * half + 1]);
  }
}

// ---- dK/dV: wgmma, with Q, dO, lse and di in a ring fed by one producer warp -----------
constexpr int KV_ROWS = 128;                    // key rows a block owns
constexpr int CONSUMERS = KV_ROWS / 64;         // consumer warpgroups, 64 key rows each
constexpr int BQ = 64;                          // query rows of one tile of the ring
constexpr int STAGES = 4;
constexpr int DKV_THREADS = 128 * (CONSUMERS + 1);
constexpr int KV_BYTES = KV_ROWS * D * 2;       // the block's K or V rows: 16 KB
constexpr int QT_BYTES = BQ * D * 2;            // a Q or dO tile: 8 KB
constexpr int STAGE_BYTES = 2 * QT_BYTES;       // Q then dO
// K, V, the ring, and room to align to 1024 bytes
constexpr int DKV_SMEM = 2 * KV_BYTES + STAGES * STAGE_BYTES + 1024;

// the 4 k-steps (16 head columns each) of the register A operand from this thread's
// rows r0 and r0 + 8 of 64 swizzled 128-byte rows at `rows`
__device__ __forceinline__ void load_a_swizzled(uint32_t (&a)[D / 16][4], const uint8_t* rows, int r0,
                                                int lane) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      a[kk][e] = *reinterpret_cast<const uint32_t*>(
          rows + (r0 + 8 * (e & 1)) * 128 + (((2 * kk + (e >> 1)) ^ (r0 & 7)) << 4) + 4 * (lane & 3));
}

__global__ void __launch_bounds__(DKV_THREADS, 1)
flash_bwd_dkv_kernel(const float* __restrict__ lse, const float* __restrict__ di, OutView dk,
                     OutView dv, int H, int N, float sm_scale, int heads_inner,
                     const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map,
                     const __grid_constant__ CUtensorMap do_map) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full_bar[STAGES], empty_bar[STAGES], kv_full;
  __shared__ __align__(16) float s_lse[STAGES][BQ];
  __shared__ __align__(16) float s_di[STAGES][BQ];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t k_tile = smem_addr(smem);  // then the V rows, then STAGES x (Q tile, dO tile)
  const uint32_t v_tile = k_tile + KV_BYTES;
  const uint32_t ring = v_tile + KV_BYTES;
  const int kv0 = blockIdx.x * KV_ROWS, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  const int q_tiles = (N + BQ - 1) / BQ;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      // the producer's lane 0 with the tiles' byte count, and the 32 lanes' cp.async of
      // lse and di
      mbar_init(&full_bar[s], 1 + 32);
      mbar_init(&empty_bar[s], 4 * CONSUMERS);  // lane 0 of every consumer warp
    }
    mbar_init(&kv_full, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // ------------------------------- producer -------------------------------------
    reg_dealloc<24>();
    if (tid < 128 * CONSUMERS + 32) {  // the producer warpgroup's first warp
      // a map's dimensions are (64, heads, tokens, batch) where its bit of heads_inner is
      // set, else (64, tokens, heads, batch)
      auto load = [&](uint32_t dst, const CUtensorMap* map, uint64_t* bar, int bit, int row) {
        if (heads_inner >> bit & 1)
          tma_load_4d(dst, map, bar, 0, h, row, b);
        else
          tma_load_4d(dst, map, bar, 0, row, h, b);
      };
      if (lane == 0) {
        mbar_arrive_expect_tx(&kv_full, 2 * KV_BYTES);
        load(k_tile, &k_map, &kv_full, 1, kv0);
        load(v_tile, &v_map, &kv_full, 2, kv0);
      }
      const long long bh = static_cast<long long>(b) * H + h;
      const float* lse_bh = lse + bh * N;
      const float* di_bh = di + bh * N;
      for (int t = 0; t < q_tiles; ++t) {
        const int s = t % STAGES;
        mbar_wait(&empty_bar[s], ((t / STAGES) & 1) ^ 1);
        if (lane == 0) {
          mbar_arrive_expect_tx(&full_bar[s], STAGE_BYTES);
          load(ring + s * STAGE_BYTES, &q_map, &full_bar[s], 0, t * BQ);
          load(ring + s * STAGE_BYTES + QT_BYTES, &do_map, &full_bar[s], 3, t * BQ);
        }
        // lse and di by 4-byte cp.async (a (B, H, N) row starts on a 16-byte boundary only
        // where N % 4 == 0); rows past N read as 0, where Q and dO are 0 too, so that P = 1
        // there meets only zeros: dP = 0, dS = 0, and P^T dO adds nothing
#pragma unroll
        for (int c = 0; c < BQ / 32; ++c) {
          const int i = lane + 32 * c, row = t * BQ + i;
          const bool valid = row < N;
          cp_async4(smem_addr(&s_lse[s][i]), lse_bh + (valid ? row : 0), valid);
          cp_async4(smem_addr(&s_di[s][i]), di_bh + (valid ? row : 0), valid);
        }
        cp_async_arrive(&full_bar[s]);
      }
    }
  } else {
    // ------------------------------- consumers ------------------------------------
    reg_alloc<240>();
    const int warp = (tid & 127) >> 5;
    const int r0 = warp * 16 + (lane >> 2);  // this thread's key rows r0 and r0 + 8 of its 64
    const int row0 = kv0 + 64 * wg;
    if (row0 >= N) {
      // the last block's consumer whose 64 key rows all lie past N: hand every tile
      // straight back, so that the other consumer has the SM to itself
      for (int t = 0; t < q_tiles; ++t) {
        mbar_wait(&full_bar[t % STAGES], (t / STAGES) & 1);
        if (lane == 0) mbar_arrive(&empty_bar[t % STAGES]);
      }
      return;
    }
    // K and V rows into registers, once, as the A operands of S^T = K Q^T and dP^T = V dO^T
    uint32_t ka[D / 16][4], va[D / 16][4];
    mbar_wait(&kv_full, 0);
    load_a_swizzled(ka, smem + wg * (64 * 128), r0, lane);
    load_a_swizzled(va, smem + KV_BYTES + wg * (64 * 128), r0, lane);

    float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    const float scale_log2 = sm_scale * LOG2E;

    // One tile a step: S^T and dP^T as two groups, P's exponentials while dP^T is still
    // being multiplied, then dS, then dV and dK as one group, then the stage goes back.
    // While one consumer computes, the other's products hold the tensor cores. (Starting
    // the next tile's S^T and dP^T behind dK, so that each consumer keeps a product in
    // flight, made ptxas serialize the wgmma: 0.63 against 0.48 ms at (16, 12, 1568, 64)
    // on an H100.) Element i of an
    // accumulator lies in query column 8 (i / 4) + 2 (lane % 4) + i % 2 of the tile.
    const int col = 2 * (lane & 3);
    for (int t = 0; t < q_tiles; ++t) {
      const int s = t % STAGES;
      const uint32_t q_tile = ring + s * STAGE_BYTES, do_tile = q_tile + QT_BYTES;
      mbar_wait(&full_bar[s], (t / STAGES) & 1);
      // S^T = K Q^T and dP^T = V dO^T (64 key rows x 64 query columns): B is the Q or dO
      // tile, K-major (head_dim along its 128-byte rows), 32 bytes a k-step
      float st[BQ / 2], dpt[BQ / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_m64n64k16_rs(st, ka[kk], wgmma_desc(q_tile + kk * 32, 16, 1024), kk != 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_m64n64k16_rs(dpt, va[kk], wgmma_desc(do_tile + kk * 32, 16, 1024), kk != 0);
      wgmma_commit();
      wgmma_wait<1>();  // S^T
      // P = 2^(S scale log2 e - lse log2 e), in place of S^T
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(&s_lse[s][8 * j + col]);
        const float neg_lse2[2] = {-l2.x * LOG2E, -l2.y * LOG2E};
#pragma unroll
        for (int e = 0; e < 4; ++e) st[4 * j + e] = ex2(fmaf(st[4 * j + e], scale_log2, neg_lse2[e & 1]));
      }
      wgmma_wait<0>();  // dP^T
      // dS = P (dP - di) scale, in place of dP^T
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
        const float2 d2 = *reinterpret_cast<const float2*>(&s_di[s][8 * j + col]);
        const float dis[2] = {d2.x, d2.y};
#pragma unroll
        for (int e = 0; e < 4; ++e) dpt[4 * j + e] = st[4 * j + e] * (dpt[4 * j + e] - dis[e & 1]) * sm_scale;
      }
      // P^T and dS^T rounded to bf16: the accumulator layout is the register A layout of
      // the k-steps over the tile's 64 query rows
      uint32_t pa[BQ / 16][4], dsa[BQ / 16][4];
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) pa[kk][e] = pack_bf16(st[8 * kk + 2 * e], st[8 * kk + 2 * e + 1]);
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) dsa[kk][e] = pack_bf16(dpt[8 * kk + 2 * e], dpt[8 * kk + 2 * e + 1]);
      // dV += P^T dO and dK += dS^T Q: B is the dO or Q tile read as it lies (query rows
      // along k, head_dim contiguous: MN-major), 16 rows (2048 bytes) a k-step
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        wgmma_m64n64k16_rs_tb(dv_acc, pa[kk], wgmma_desc(do_tile + kk * 16 * 128, 16, 1024), 1);
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        wgmma_m64n64k16_rs_tb(dk_acc, dsa[kk], wgmma_desc(q_tile + kk * 16 * 128, 16, 1024), 1);
      wgmma_commit();
      wgmma_wait<0>();
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty_bar[s]);  // the stage goes back to the producer
    }
    // a warp's 16 rows of a wgmma accumulator lie as the m16n8 accumulators of mma.sync
    using Rows = const float(&)[D / 8][4];
    store_rows(dk, b, h, row0 + 16 * warp, N, reinterpret_cast<Rows>(dk_acc), lane);
    store_rows(dv, b, h, row0 + 16 * warp, N, reinterpret_cast<Rows>(dv_acc), lane);
  }
}

// ---- dQ: wgmma, with K and V in a ring fed by one producer warp ------------------------
constexpr int Q_ROWS = 64 * CONSUMERS;          // query rows a block owns, 64 a consumer
constexpr int BK = 64;                          // key rows of one tile of the ring
constexpr int DQ_THREADS = 128 * (CONSUMERS + 1);
constexpr int QO_BYTES = Q_ROWS * D * 2;        // the block's Q or dO rows: 16 KB
constexpr int KT_BYTES = BK * D * 2;            // a K or V tile: 8 KB
constexpr int DQ_STAGE_BYTES = 2 * KT_BYTES;    // K then V
// Q, dO, the ring, and room to align to 1024 bytes
constexpr int DQ_SMEM = 2 * QO_BYTES + STAGES * DQ_STAGE_BYTES + 1024;

__global__ void __launch_bounds__(DQ_THREADS, 1)
flash_bwd_dq_kernel(View32 o, const float* __restrict__ lse, float* __restrict__ di, OutView dq,
                    int H, int N, float sm_scale, int heads_inner,
                    const __grid_constant__ CUtensorMap q_map,
                    const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map,
                    const __grid_constant__ CUtensorMap do_map) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full_bar[STAGES], empty_bar[STAGES], qo_full;
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t q_tile = smem_addr(smem);  // then the dO rows, then STAGES x (K tile, V tile)
  const uint32_t do_tile = q_tile + QO_BYTES;
  const uint32_t ring = do_tile + QO_BYTES;
  const int q0 = blockIdx.x * Q_ROWS, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  const int kv_tiles = (N + BK - 1) / BK;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full_bar[s], 1);               // the producer's lane 0 with the tiles' bytes
      mbar_init(&empty_bar[s], 4 * CONSUMERS);  // lane 0 of every consumer warp
    }
    mbar_init(&qo_full, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // ------------------------------- producer -------------------------------------
    reg_dealloc<24>();
    if (tid == 128 * CONSUMERS) {  // lane 0 of the producer warpgroup
      // a map's dimensions are (64, heads, tokens, batch) where its bit of heads_inner is
      // set, else (64, tokens, heads, batch)
      auto load = [&](uint32_t dst, const CUtensorMap* map, uint64_t* bar, int bit, int row) {
        if (heads_inner >> bit & 1)
          tma_load_4d(dst, map, bar, 0, h, row, b);
        else
          tma_load_4d(dst, map, bar, 0, row, h, b);
      };
      mbar_arrive_expect_tx(&qo_full, 2 * QO_BYTES);
      load(q_tile, &q_map, &qo_full, 0, q0);
      load(do_tile, &do_map, &qo_full, 3, q0);
      for (int t = 0; t < kv_tiles; ++t) {
        const int s = t % STAGES;
        mbar_wait(&empty_bar[s], ((t / STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(&full_bar[s], DQ_STAGE_BYTES);
        load(ring + s * DQ_STAGE_BYTES, &k_map, &full_bar[s], 1, t * BK);
        load(ring + s * DQ_STAGE_BYTES + KT_BYTES, &v_map, &full_bar[s], 2, t * BK);
      }
    }
  } else {
    // ------------------------------- consumers ------------------------------------
    reg_alloc<240>();
    const int warp = (tid & 127) >> 5;
    const int r0 = warp * 16 + (lane >> 2);  // this thread's query rows r0 and r0 + 8 of its 64
    const int row0 = q0 + 64 * wg;
    if (row0 >= N) {
      // the last block's consumer whose 64 query rows all lie past N: hand every tile
      // straight back, so that the other consumer has the SM to itself
      for (int t = 0; t < kv_tiles; ++t) {
        mbar_wait(&full_bar[t % STAGES], (t / STAGES) & 1);
        if (lane == 0) mbar_arrive(&empty_bar[t % STAGES]);
      }
      return;
    }
    // this thread's two rows' lse, scaled by log2 e, and the f32 O at the columns of those
    // rows that its dO fragment will hold: 8 c + col, +1 for c = 0 .. 7 (rows past N: lse
    // 0 and O 0, where Q and dO are zeros)
    const long long bh = static_cast<long long>(b) * H + h;
    const int col = 2 * (lane & 3);
    float neg_lse2[2];
    float2 o_part[2][D / 8];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + r0 + 8 * half;
      const bool valid = row < N;
      neg_lse2[half] = valid ? -lse[bh * N + row] * LOG2E : 0.f;
      const float* o_row = o.p + b * o.sb + h * o.sh + (valid ? row : 0) * o.sn + col;
#pragma unroll
      for (int c = 0; c < D / 8; ++c)
        o_part[half][c] = valid ? *reinterpret_cast<const float2*>(o_row + 8 * c) : make_float2(0.f, 0.f);
    }
    // Q and dO rows into registers, once, as the A operands of S = Q K^T and dP = dO V^T
    uint32_t qa[D / 16][4], doa[D / 16][4];
    mbar_wait(&qo_full, 0);
    load_a_swizzled(qa, smem + wg * (64 * 128), r0, lane);
    load_a_swizzled(doa, smem + QO_BYTES + wg * (64 * 128), r0, lane);
    // di = rowsum(O o dO) in f32: doa[kk][e] holds row r0 + 8 (e % 2), columns
    // 16 kk + 8 (e / 2) + col, +1; the four threads of a row add their parts
    float di_r[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float acc = 0.f;
#pragma unroll
      for (int c = 0; c < D / 8; ++c) {
        const uint32_t pair = doa[c >> 1][2 * (c & 1) + half];
        const float2 d2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&pair));
        acc = fmaf(o_part[half][c].x, d2.x, acc);
        acc = fmaf(o_part[half][c].y, d2.y, acc);
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      di_r[half] = acc;
      const int row = row0 + r0 + 8 * half;
      if ((lane & 3) == 0 && row < N) di[bh * N + row] = acc;
    }

    float dq_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq_acc[i] = 0.f;
    const float scale_log2 = sm_scale * LOG2E;

    // One tile a step: S and dP as two groups, P's exponentials while dP is still being
    // multiplied, then dS, then dQ, then the stage goes back. Element i of an accumulator
    // lies in row r0 + 8 ((i / 2) % 2), key column 8 (i / 4) + col + i % 2 of the tile.
    // `masked` (the last tile, where N % 64 != 0) sets P to 0 in the columns past N.
    auto step = [&](int t, auto masked) {
      const int s = t % STAGES;
      const uint32_t k_tile = ring + s * DQ_STAGE_BYTES, v_tile = k_tile + KT_BYTES;
      mbar_wait(&full_bar[s], (t / STAGES) & 1);
      // S = Q K^T and dP = dO V^T (64 query rows x 64 key columns): B is the K or V tile,
      // K-major (head_dim along its 128-byte rows), 32 bytes a k-step
      float sc[BK / 2], dp[BK / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_m64n64k16_rs(sc, qa[kk], wgmma_desc(k_tile + kk * 32, 16, 1024), kk != 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_m64n64k16_rs(dp, doa[kk], wgmma_desc(v_tile + kk * 32, 16, 1024), kk != 0);
      wgmma_commit();
      wgmma_wait<1>();  // S
      // P = 2^(S scale log2 e - lse log2 e), in place of S
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        sc[i] = ex2(fmaf(sc[i], scale_log2, neg_lse2[(i >> 1) & 1]));
        if constexpr (decltype(masked)::value)
          if (t * BK + 8 * (i >> 2) + col + (i & 1) >= N) sc[i] = 0.f;
      }
      wgmma_wait<0>();  // dP
      // dS = P (dP - di) scale, in place of dP, rounded to bf16: the accumulator layout
      // is the register A layout of the k-steps over the tile's 64 key rows
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) dp[i] = sc[i] * (dp[i] - di_r[(i >> 1) & 1]) * sm_scale;
      uint32_t dsa[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) dsa[kk][e] = pack_bf16(dp[8 * kk + 2 * e], dp[8 * kk + 2 * e + 1]);
      // dQ += dS K: B is the K tile read as it lies (key rows along k, head_dim
      // contiguous: MN-major), 16 rows (2048 bytes) a k-step
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_m64n64k16_rs_tb(dq_acc, dsa[kk], wgmma_desc(k_tile + kk * 16 * 128, 16, 1024), 1);
      wgmma_commit();
      wgmma_wait<0>();
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty_bar[s]);  // the stage goes back to the producer
    };
    const bool ragged = N % BK != 0;
    for (int t = 0; t < kv_tiles - ragged; ++t) step(t, std::false_type{});
    if (ragged) step(kv_tiles - 1, std::true_type{});
    // a warp's 16 rows of a wgmma accumulator lie as the m16n8 accumulators of mma.sync
    using Rows = const float(&)[D / 8][4];
    store_rows(dq, b, h, row0 + 16 * warp, N, reinterpret_cast<Rows>(dq_acc), lane);
  }
}

bool grid_fits(int B, int H, int N) {
  return B > 0 && H > 0 && N > 0 && B <= 65535 && H <= 65535;
}

// once per device and kernel: leave to use `bytes` (more than 48 KB) of shared memory
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, bool (&ready)[64]) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (!ready[device]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    ready[device] = true;
  }
  return cudaSuccess;
}

// the tensor maps of q, k, v and dO, in boxes of 128 tokens for the operands a block
// holds (k and v where `hold_kv`, the dK/dV kernel; else q and dO, the dQ kernel) and 64
// for those it streams, and the order of their dimensions: bit i set where operand i
// (q, k, v, dO) has its heads inside its tokens
struct Maps {
  CUtensorMap q, k, v, d;
  int order;
};
bool make_maps(Maps& m, const Operand& qt, const Operand& kt, const Operand& vt, const Operand& dt,
               bool hold_kv) {
  const int qd_rows = hold_kv ? BQ : Q_ROWS, kv_rows = hold_kv ? KV_ROWS : BK;
  m.order = heads_inner(qt) | heads_inner(kt) << 1 | heads_inner(vt) << 2 | heads_inner(dt) << 3;
  return operand_map(&m.q, qt, qd_rows) && operand_map(&m.k, kt, kv_rows) &&
         operand_map(&m.v, vt, kv_rows) && operand_map(&m.d, dt, qd_rows);
}

}  // namespace

// dk and dv of one backward: q, k, v, dO (B, H, N, 64) bf16 through their (batch, head,
// token) element strides, lse and di (B, H, N) f32 contiguous (di from the dQ kernel),
// dk and dv written through theirs
extern "C" int tpuhar_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                    const void* dout, const void* lse, const void* di,
                                    void* dk, void* dv, int B, int H, int N, float sm_scale,
                                    long long sqb, long long sqh, long long sqn,
                                    long long skb, long long skh, long long skn,
                                    long long svb, long long svh, long long svn,
                                    long long sdb, long long sdh, long long sdn,
                                    long long skgb, long long skgh, long long skgn,
                                    long long svgb, long long svgh, long long svgn,
                                    void* stream) {
  if (!grid_fits(B, H, N)) return static_cast<int>(cudaErrorInvalidValue);
  static bool ready[64] = {};
  const cudaError_t err = allow_smem(flash_bwd_dkv_kernel, DKV_SMEM, ready);
  if (err != cudaSuccess) return static_cast<int>(err);
  Maps m;
  if (!make_maps(m, Operand{q, B, H, N, sqb, sqh, sqn}, Operand{k, B, H, N, skb, skh, skn},
                 Operand{v, B, H, N, svb, svh, svn}, Operand{dout, B, H, N, sdb, sdh, sdn}, true))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + KV_ROWS - 1) / KV_ROWS, H, B);
  flash_bwd_dkv_kernel<<<grid, DKV_THREADS, DKV_SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lse), static_cast<const float*>(di),
      OutView{static_cast<__nv_bfloat16*>(dk), skgb, skgh, skgn},
      OutView{static_cast<__nv_bfloat16*>(dv), svgb, svgh, svgn}, H, N, sm_scale, m.order, m.q,
      m.k, m.v, m.d);
  return static_cast<int>(cudaGetLastError());
}

// dq of one backward, and di = rowsum(O o dO) (B, H, N) f32 for the dK/dV kernel, from
// q, k, v, the forward's output o in f32 (rows of 16-byte aligned floats), dO and lse
extern "C" int tpuhar_flash_bwd_dq(const void* q, const void* k, const void* v, const void* o,
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
  const cudaError_t err = allow_smem(flash_bwd_dq_kernel, DQ_SMEM, ready);
  if (err != cudaSuccess) return static_cast<int>(err);
  Maps m;
  if (!make_maps(m, Operand{q, B, H, N, sqb, sqh, sqn}, Operand{k, B, H, N, skb, skh, skn},
                 Operand{v, B, H, N, svb, svh, svn}, Operand{dout, B, H, N, sdb, sdh, sdn}, false))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + Q_ROWS - 1) / Q_ROWS, H, B);
  flash_bwd_dq_kernel<<<grid, DQ_THREADS, DQ_SMEM, static_cast<cudaStream_t>(stream)>>>(
      View32{static_cast<const float*>(o), sob, soh, son}, static_cast<const float*>(lse),
      static_cast<float*>(di), OutView{static_cast<__nv_bfloat16*>(dq), sqgb, sqgh, sqgn}, H, N,
      sm_scale, m.order, m.q, m.k, m.v, m.d);
  return static_cast<int>(cudaGetLastError());
}
