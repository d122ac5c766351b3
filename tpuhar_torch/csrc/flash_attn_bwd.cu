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
// loads anyway, and writes it out for the dK/dV kernel, which runs after it on the same
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
// no atomics.
//  - dK/dV (wgmma, TMA): one block per (128 key rows, head, batch), three warpgroups,
//    launched with 168 registers a thread; setmaxnreg moves them to where they are
//    needed (24 + 240 + 240 = 3 x 168). Two consumer warpgroups own 64 key rows each;
//    each Q/dO tile brought in serves all 128, which halves the L2 traffic of Q and dO
//    against 64-row blocks. K and V of the block's rows arrive once by TMA and go from
//    shared memory into registers: the register A operands of S^T = K Q^T and
//    dP^T = V dO^T. One producer warp (registers cut to 24) walks the query tiles of 64
//    rows: lane 0 brings Q and dO by TMA into a four-stage ring, from 4-D tensor maps
//    over the strided views (csrc/flash_maps.cuh: rows past N arrive as zeros, every
//    128-byte row in the swizzle wgmma reads), and the warp brings the tile's lse and di
//    by 4-byte cp.async (a (B, H, N) row starts on a 16-byte boundary only where
//    N % 4 == 0, which TMA needs), all counted on the stage's full mbarrier. Per tile a
//    consumer starts S^T and dP^T (wgmma m64n64k16, B K-major), takes P's exponentials
//    while dP^T runs, forms dS, and starts dV += P^T dO and dK += dS^T Q with P^T and
//    dS^T straight from the accumulators (their layout, packed to bf16 pairs, is the
//    register A layout) and B = the dO or Q tile as it lies (MN-major); then lane 0 of
//    each warp hands the stage back through its empty mbarrier. While one consumer
//    computes, the other's products hold the tensor cores. Query rows past N need no
//    mask: their Q and dO are zeros and their lse and di arrive as 0, so P = 1 there
//    meets dP = 0, dS = 0 and a zero dO row. A consumer whose 64 key rows all lie past N
//    (the last block at N = 1568 holds 32 rows) hands every stage straight back.
//    dK and dV are rounded to bf16 once and stored through strides, 4 bytes a thread.
//  - dQ (mma.sync): one block per (64 query rows, head, batch), four warps of 16 query
//    rows each. Q and dO of the block's rows go once from shared memory into registers;
//    the block walks over the key tiles of 64 rows, K and V brought into a two-stage ring
//    in shared memory by cp.async (rows past N arrive as zeros; key columns past N are
//    masked), the next tile on its way while this one is multiplied. dQ += dS K takes dS
//    straight from the accumulators of the products before it: the m16n8 accumulator
//    layout, packed to bf16 pairs, is the m16n8k16 A operand. Before its loop it reads the
//    block's rows of the f32 O too and forms di (two threads a row). Its products are
//    mma.sync m16n8k16 bf16 -> f32; the B operands come from shared memory by ldmatrix
//    (.trans where the tile lies with k along its rows), from rows padded to 144 bytes so
//    that the eight rows of an 8x8 matrix hit distinct banks.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_maps.cuh"
#include "hopper.cuh"

using namespace hopper;
using flash_maps::heads_inner;
using flash_maps::Operand;
using flash_maps::operand_map;

namespace {

constexpr int D = 64;          // head_dim
// the dQ kernel
constexpr int BR = 64;         // rows a block owns: 16 per warp
constexpr int BC = 64;         // rows of the other operand per step of the loop
constexpr int THREADS = 128;   // four warps
constexpr int LD = D + 8;      // padded shared row in elements (144 bytes)
constexpr int TILE = BC * LD;  // one staged (64, 64) tile, in elements
constexpr float LOG2E = 1.4426950408889634f;

struct View {  // a (B, H, N, 64) operand: element strides of batch, head, token
  const __nv_bfloat16* p;
  long long sb, sh, sn;
};
struct OutView {
  __nv_bfloat16* p;
  long long sb, sh, sn;
};
struct View32 {  // the same, f32
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

// ldmatrix.x4 with the transpose: from matrix i lane l receives, in r[i], the elements
// (row 2 (l % 4), column l / 4) and (row 2 (l % 4) + 1, column l / 4)
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t smem) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem));
}

// d (16 x 8, f32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col). Lane l (g = l / 4,
// t = l % 4) holds d[0..1] = row g, columns 2t, 2t+1 and d[2..3] = row g + 8; a[0] = row g,
// k 2t..2t+1, a[1] = row g + 8, a[2] and a[3] the same rows at k + 8; b[0] = k 2t..2t+1 of
// column g, b[1] = k + 8.
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows row0 .. row0 + 63 of one (batch, head) of `v` into a padded shared tile; rows past
// N arrive as zeros
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long sn, int row0, int N) {
  for (int i = threadIdx.x; i < BC * (D / 8); i += THREADS) {
    const int r = i >> 3, c = i & 7;
    const int row = row0 + r;
    const bool valid = row < N;
    cp_async16(smem_addr(dst + r * LD + c * 8), src + (valid ? row : 0) * sn + c * 8, valid);
  }
}

// a warp's 16 rows of a padded (64, 64) tile as the A operand of four k-steps over the
// 64 columns
__device__ __forceinline__ void load_a(uint32_t (&a)[D / 16][4], const __nv_bfloat16* tile,
                                       int warp, int lane) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldmatrix_x4(a[kk], smem_addr(tile + (16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1)) * LD +
                                 16 * kk + 8 * (lane >> 4)));
}

// acc (16 x 64) = A (the warp's 16 rows, in registers) * T^T, T a padded (64, 64) tile with
// the product's n along its rows and k along its columns
__device__ __forceinline__ void mma_abt(float (&acc)[BC / 8][4], const uint32_t (&a)[D / 16][4],
                                        const __nv_bfloat16* t, int lane) {
#pragma unroll
  for (int n = 0; n < BC / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int p = 0; p < BC / 16; ++p) {
      uint32_t b[4];
      ldmatrix_x4(b, smem_addr(t + (16 * p + (lane & 7) + 8 * (lane >> 4)) * LD + 16 * kk +
                               8 * ((lane >> 3) & 1)));
      mma16816(acc[2 * p], a[kk], b[0], b[1]);
      mma16816(acc[2 * p + 1], a[kk], b[2], b[3]);
    }
}

// acc (16 x 64) += X (16 x 64, bf16 from the f32 accumulator layout of x) * T, T a padded
// (64, 64) tile with the product's k along its rows and n along its columns
__device__ __forceinline__ void mma_xt(float (&acc)[D / 8][4], const float (&x)[BC / 8][4],
                                       const __nv_bfloat16* t, int lane) {
#pragma unroll
  for (int kk = 0; kk < BC / 16; ++kk) {
    const uint32_t a[4] = {pack_bf16(x[2 * kk][0], x[2 * kk][1]),
                           pack_bf16(x[2 * kk][2], x[2 * kk][3]),
                           pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]),
                           pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3])};
#pragma unroll
    for (int p = 0; p < D / 16; ++p) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, smem_addr(t + (16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1)) * LD +
                                     16 * p + 8 * (lane >> 4)));
      mma16816(acc[2 * p], a, b[0], b[1]);
      mma16816(acc[2 * p + 1], a, b[2], b[3]);
    }
  }
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

__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(View q, View k, View v, View32 o, View dout, const float* __restrict__ lse,
                    float* __restrict__ di, OutView dq, int H, int N, float sm_scale) {
  __shared__ __align__(16) __nv_bfloat16 s_k[2][TILE];
  __shared__ __align__(16) __nv_bfloat16 s_v[2][TILE];
  __shared__ float s_di[BR];
  const int q0 = blockIdx.x * BR, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long bh = static_cast<long long>(b) * H + h;
  const __nv_bfloat16* qb = q.p + b * q.sb + h * q.sh;
  const __nv_bfloat16* kb = k.p + b * k.sb + h * k.sh;
  const __nv_bfloat16* vb = v.p + b * v.sb + h * v.sh;
  const float* ob = o.p + b * o.sb + h * o.sh;
  const __nv_bfloat16* dob = dout.p + b * dout.sb + h * dout.sh;
  const float scale_log2 = sm_scale * LOG2E;
  const int kv_tiles = (N + BC - 1) / BC;

  // this block's Q and dO rows through stage 1 (into registers below); key tile 0 into
  // stage 0
  load_tile(s_k[1], qb, q.sn, q0, N);
  load_tile(s_v[1], dob, dout.sn, q0, N);
  load_tile(s_k[0], kb, k.sn, 0, N);
  load_tile(s_v[0], vb, v.sn, 0, N);
  cp_async_commit();
  // this thread's two rows' lse, scaled by log2 e
  float lse2[2], di_r[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + 16 * warp + (lane >> 2) + 8 * half;
    lse2[half] = row < N ? lse[bh * N + row] * LOG2E : 0.f;
  }
  // di = rowsum(O o dO) in f32 from the f32 O, two threads a row, 32 columns each
  const int di_row = threadIdx.x >> 1, c0 = (threadIdx.x & 1) * (D / 2);
  float4 o_part[D / 8];
#pragma unroll
  for (int c = 0; c < D / 8; ++c)
    o_part[c] = q0 + di_row < N
                    ? *reinterpret_cast<const float4*>(ob + (q0 + di_row) * o.sn + c0 + 4 * c)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
  cp_async_wait<0>();
  __syncthreads();
  {
    const __nv_bfloat16* d_row = s_v[1] + di_row * LD + c0;
    float acc = 0.f;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      acc = fmaf(o_part[c].x, __bfloat162float(d_row[4 * c]), acc);
      acc = fmaf(o_part[c].y, __bfloat162float(d_row[4 * c + 1]), acc);
      acc = fmaf(o_part[c].z, __bfloat162float(d_row[4 * c + 2]), acc);
      acc = fmaf(o_part[c].w, __bfloat162float(d_row[4 * c + 3]), acc);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if ((threadIdx.x & 1) == 0) {
      s_di[di_row] = acc;
      if (q0 + di_row < N) di[bh * N + q0 + di_row] = acc;
    }
  }
  __syncthreads();
#pragma unroll
  for (int half = 0; half < 2; ++half) di_r[half] = s_di[16 * warp + (lane >> 2) + 8 * half];
  uint32_t qa[D / 16][4], doa[D / 16][4];
  load_a(qa, s_k[1], warp, lane);
  load_a(doa, s_v[1], warp, lane);
  __syncthreads();  // stage 1 is free for key tile 1

  float dq_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[n][e] = 0.f;

  for (int j = 0; j < kv_tiles; ++j) {
    const int st = j & 1;
    if (j + 1 < kv_tiles) {
      load_tile(s_k[st ^ 1], kb, k.sn, (j + 1) * BC, N);
      load_tile(s_v[st ^ 1], vb, v.sn, (j + 1) * BC, N);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    float p[BC / 8][4], ds[BC / 8][4];
    mma_abt(p, qa, s_k[st], lane);    // S: 16 query rows x 64 key columns
    mma_abt(ds, doa, s_v[st], lane);  // dP
#pragma unroll
    for (int n = 0; n < BC / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * BC + 8 * n + 2 * (lane & 3) + (e & 1);  // key row
        const int r = e >> 1;
        const float pe = col < N ? ex2(fmaf(p[n][e], scale_log2, -lse2[r])) : 0.f;
        ds[n][e] = pe * (ds[n][e] - di_r[r]) * sm_scale;
      }
    mma_xt(dq_acc, ds, s_k[st], lane);  // dQ += dS K
    __syncthreads();
  }
  store_rows(dq, b, h, q0 + 16 * warp, N, dq_acc, lane);
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

bool grid_fits(int B, int H, int N) {
  return B > 0 && H > 0 && N > 0 && B <= 65535 && H <= 65535;
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
  // once per device: leave to use more than 48 KB of shared memory
  static bool ready[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess || device < 0 || device >= 64)
    return static_cast<int>(err != cudaSuccess ? err : cudaErrorInvalidDevice);
  if (!ready[device]) {
    err = cudaFuncSetAttribute(flash_bwd_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               DKV_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready[device] = true;
  }
  const Operand qt{q, B, H, N, sqb, sqh, sqn}, kt{k, B, H, N, skb, skh, skn},
      vt{v, B, H, N, svb, svh, svn}, dt{dout, B, H, N, sdb, sdh, sdn};
  CUtensorMap q_map, k_map, v_map, do_map;
  if (!operand_map(&q_map, qt, BQ) || !operand_map(&k_map, kt, KV_ROWS) ||
      !operand_map(&v_map, vt, KV_ROWS) || !operand_map(&do_map, dt, BQ))
    return static_cast<int>(cudaErrorInvalidValue);
  const int order = heads_inner(qt) | heads_inner(kt) << 1 | heads_inner(vt) << 2 | heads_inner(dt) << 3;
  const dim3 grid((N + KV_ROWS - 1) / KV_ROWS, H, B);
  flash_bwd_dkv_kernel<<<grid, DKV_THREADS, DKV_SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lse), static_cast<const float*>(di),
      OutView{static_cast<__nv_bfloat16*>(dk), skgb, skgh, skgn},
      OutView{static_cast<__nv_bfloat16*>(dv), svgb, svgh, svgn}, H, N, sm_scale, order, q_map,
      k_map, v_map, do_map);
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
  const dim3 grid((N + BR - 1) / BR, H, B);
  flash_bwd_dq_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      View{static_cast<const __nv_bfloat16*>(q), sqb, sqh, sqn},
      View{static_cast<const __nv_bfloat16*>(k), skb, skh, skn},
      View{static_cast<const __nv_bfloat16*>(v), svb, svh, svn},
      View32{static_cast<const float*>(o), sob, soh, son},
      View{static_cast<const __nv_bfloat16*>(dout), sdb, sdh, sdn},
      static_cast<const float*>(lse), static_cast<float*>(di),
      OutView{static_cast<__nv_bfloat16*>(dq), sqgb, sqgh, sqgn}, H, N, sm_scale);
  return static_cast<int>(cudaGetLastError());
}
