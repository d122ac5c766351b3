// Non-causal flash attention forward on Hopper (sm_90a), bf16, head_dim 64.
//
// Replaces two TPU kernels that compute one function:
//   tpuhar/ops/flash_lean.py: flash_lean (body _kernel), and
//   tpuhar/ops/attention.py: flash_mha(kernel="library"), the stock Pallas TPU flash
//   kernel (jax.experimental.pallas.ops.tpu.flash_attention with segment-id padding).
// Per (batch, head): out = softmax(Q K^T * sm_scale) V over N tokens, with the scores
// and the softmax in f32, P rounded to bf16 for P V, the P V sum in f32, then / l.
//
// q, k, v and out are (B, H, N, 64) with any strides whose last one is 1; the wrapper
// hands over the native (B, N, H*64) projections (strides H*64 per token and 64 per
// head), so no (B, N, H, Dh) <-> (B, H, N, Dh) copy surrounds the kernel.
//
// What bounds it: operations, of two kinds that weigh about the same. A batch-8
// videomae_base call (B*H = 96, N = 1568) is 4*96*1568^2*64 = 60.4 GFLOP of tensor-core
// work (0.061 ms at 989 TFLOP/s) and 236 M exponentials on the special-function units
// (16 per SM per clock: about 0.06 ms), against 77 MB of q, k, v and out (0.023 ms at
// 3.35 TB/s): the score matrix never leaves the SM. Beside the exponential every score
// costs a max, a multiply-add, a sum and half a bf16 pack on the ordinary pipes, and with
// a few consumer warps a scheduler these chains, not the tensor cores, set the pace. So the
// design keeps every other cost out of the consumers' way: both products on wgmma, the
// loads on TMA, no work on padding tiles, and no start-up per query tile.
//
// Design (FlashAttention-3 shaped): one persistent block per SM walks over work items of
// 192 query rows of one (batch, head), neighbouring blocks on the same head so that its
// K and V stay in L2, and runs four warpgroups. The block's 512 threads start with 128
// registers each; setmaxnreg moves them to where they are needed (24 x 128 + 160 x 384 of
// the SM's 65536).
//  - The producer (registers cut to 24) is one thread: it brings the Q tile
//    and then 112-row K and V tiles into a four-stage ring in dynamic shared memory by
//    TMA, from 4-D tensor maps over the strided views (rows past N arrive as zeros, every
//    128-byte row in the 128-byte swizzle wgmma reads). The bytes are counted on the
//    stage's mbarrier, so no thread spends instructions on addresses and the consumers
//    need no proxy fence. The ring runs on across work items: the next item's Q, K and V
//    are on their way while this item's last tiles are still being multiplied. The
//    three maps are encoded on the host at every call (about a microsecond each).
//  - Three consumers (160 registers) own 64 query rows each: three warps a scheduler
//    hide one another's softmax latencies better than two (0.161 against 0.169 ms at
//    (8, 12, 1568, 64) on an H100). Q goes from shared memory into
//    registers once per item (wgmma's register A operand), which frees the Q tile for the
//    producer at once. S = Q K^T is four wgmma m64n112k16 with K from shared memory
//    (K-major), 56 f32 scores a thread. 112 = 1568 / 14: the ViT's sequence is a whole
//    number of tiles, so no tile is padding and no column is masked there; other N mask
//    key columns >= N on the last tile only. The online softmax runs on those registers
//    in the log2 domain (sm_scale * log2 e folded into one multiply-add, ex2.approx for
//    the exponential), maxima and sums as eight independent chains. P, rounded to bf16,
//    is already laid out as the register A operand, so O += P V is seven wgmma m64n64k16
//    with V read from shared memory as it lies ([kv][d], d contiguous: MN-major B, the
//    trans-b bit). Tile t's S is issued before tile t-1's P V and its softmax runs while
//    that P V is in flight; while one consumer is in its softmax the others' products
//    own the tensor cores. A finished stage goes back to the producer through its "empty"
//    mbarrier; no block-wide barrier sits in the loop. A consumer whose 64 rows all lie
//    past N (on a ragged last item) hands its tiles straight back.
//  - O * (1 / l) in f32, rounded to bf16, is staged through the warp's own 16 rows of an
//    O tile, so each row leaves as 16-byte stores; ragged Q rows are not stored.
//  - Training passes two more outputs, for the backward kernels (csrc/flash_attn_bwd.cu):
//    `lse`, each row's log-sum-exp of the scaled scores, m * sm_scale + ln(l) in f32, at
//    lse[(b * H + h) * N + row], which they recompute P from; and `o32`, O * (1 / l) in
//    f32 before its rounding to bf16, through the element strides of `o`, which the dQ
//    kernel forms di = rowsum(O o dO) from (from the bf16 O, di is off by the rounding,
//    and where attention is near uniform dP - di is a small difference that this moves
//    by percents). The serving path passes nulls and stores nothing more; O is computed
//    the same either way. The stores are compiled in one instantiation of the kernel
//    (kStats), picked on the host from the pointers, so the serving form's code is the
//    forward-only kernel's, register allocation included.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "flash_maps.cuh"
#include "hopper.cuh"

using namespace hopper;
using flash_maps::heads_inner;
using flash_maps::Operand;
using flash_maps::operand_map;

namespace {

constexpr int D = 64;     // head_dim: one 128-byte row
constexpr int CONSUMERS = 3;        // consumer warpgroups, 64 query rows each
constexpr int BQ = 64 * CONSUMERS;  // query rows per work item
constexpr int BKV = 112;  // key/value rows per tile: 14 x 112 = 1568 = 8 x 14 x 14 tokens
static_assert(BKV % 16 == 0, "whole k-steps of P V");
constexpr int STAGES = 4;
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int Q_BYTES = BQ * D * 2;        // a Q or O tile: 24 KB
constexpr int KV_BYTES = BKV * D * 2;      // a K or V tile: whole 1024-byte swizzle atoms
constexpr int STAGE_BYTES = 2 * KV_BYTES;  // K then V
// the Q tile, the K/V ring, the O staging tile, and room to align to 1024 bytes
constexpr int SMEM_BYTES = Q_BYTES + STAGES * STAGE_BYTES + Q_BYTES + 1024;

struct Strides {
  long long b, h, n;  // in elements
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {  // 2^x on the special-function unit
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <bool kStats>
__global__ void __launch_bounds__(THREADS, 1)
flash_attn_kernel(__nv_bfloat16* __restrict__ o, float* __restrict__ lse, float* __restrict__ o32,
                  int H, int N, int q_tiles, int items,
                  float scale_log2, Strides so, int heads_inner,
                  const __grid_constant__ CUtensorMap q_map,
                  const __grid_constant__ CUtensorMap k_map,
                  const __grid_constant__ CUtensorMap v_map) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full_bar[STAGES], empty_bar[STAGES], q_full, q_empty;
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t q_tile = smem_addr(smem);  // then STAGES x (K tile, V tile), then O
  const uint32_t ring = q_tile + Q_BYTES;

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int tiles = (N + BKV - 1) / BKV;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full_bar[s], 1);  // the producer thread, with the tiles' byte count
      mbar_init(&empty_bar[s], 4 * CONSUMERS);  // lane 0 of every consumer warp
    }
    mbar_init(&q_full, 1);
    mbar_init(&q_empty, 4 * CONSUMERS);
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // ------------------------------- producer -------------------------------------
    reg_dealloc<24>();
    if (tid == 128 * CONSUMERS) {
      int it = 0;  // K/V tiles since the kernel began: the ring does not stop at work items
      int local = 0;
      for (int w = blockIdx.x; w < items; w += gridDim.x, ++local) {
        const int bh = w / q_tiles, q0 = (w - bh * q_tiles) * BQ;
        const int b = bh / H, h = bh - b * H;
        mbar_wait(&q_empty, (local & 1) ^ 1);  // the consumers hold the last Q in registers
        mbar_arrive_expect_tx(&q_full, Q_BYTES);
        // a map's dimensions are (64, heads, tokens, batch) where its bit of heads_inner
        // is set, else (64, tokens, heads, batch)
        auto load = [&](uint32_t dst, const CUtensorMap* map, uint64_t* bar, int bit, int row) {
          if (heads_inner >> bit & 1)
            tma_load_4d(dst, map, bar, 0, h, row, b);
          else
            tma_load_4d(dst, map, bar, 0, row, h, b);
        };
        load(q_tile, &q_map, &q_full, 0, q0);
        for (int t = 0; t < tiles; ++t, ++it) {
          const int s = it % STAGES;
          mbar_wait(&empty_bar[s], ((it / STAGES) & 1) ^ 1);
          mbar_arrive_expect_tx(&full_bar[s], STAGE_BYTES);
          load(ring + s * STAGE_BYTES, &k_map, &full_bar[s], 1, t * BKV);
          load(ring + s * STAGE_BYTES + KV_BYTES, &v_map, &full_bar[s], 2, t * BKV);
        }
      }
    }
  } else {
    // ------------------------------- consumers ------------------------------------
    reg_alloc<160>();
    const int wt = tid & 127;
    const int warp = wt >> 5, lane = tid & 31;
    const int r0 = warp * 16 + (lane >> 2);  // this thread's rows r0 and r0 + 8 of its 64
    const uint8_t* q_rows = smem + wg * (64 * 128);  // this warpgroup's 64 rows of Q
    uint8_t* o_rows = smem + Q_BYTES + STAGES * STAGE_BYTES + wg * (64 * 128);

    int it = 0, local = 0;
    for (int w = blockIdx.x; w < items; w += gridDim.x, ++local, it += tiles) {
      const int bh = w / q_tiles, q0 = (w - bh * q_tiles) * BQ;
      const int b = bh / H, h = bh - b * H;

      // Q into registers as the A operand of S = Q K^T (k-step kk covers head_dim
      // 16 kk .. 16 kk + 15); the shared tile goes back to the producer at once
      uint32_t qa[D / 16][4];
      mbar_wait(&q_full, local & 1);
      if (q0 + wg * 64 >= N) {
        // a ragged last item whose 64 rows all lie past N: hand every tile straight back,
        // so that the other warpgroups have the SM to themselves
        if (lane == 0) mbar_arrive(&q_empty);
        for (int t = 0; t < tiles; ++t) {
          mbar_wait(&full_bar[(it + t) % STAGES], ((it + t) / STAGES) & 1);
          if (lane == 0) mbar_arrive(&empty_bar[(it + t) % STAGES]);
        }
        continue;
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          qa[kk][e] = *reinterpret_cast<const uint32_t*>(
              q_rows + (r0 + 8 * (e & 1)) * 128 + (((2 * kk + (e >> 1)) ^ (r0 & 7)) << 4) +
              4 * (lane & 3));
      __syncwarp();
      if (lane == 0) mbar_arrive(&q_empty);

      float acc[D / 2];  // O: rows r0 and r0 + 8
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
      // running max of the raw scores of the two rows, and this thread's share of their
      // normalizers (its 2 of every 8 columns; the quad's shares are summed at the end)
      float m_run[2] = {-CUDART_INF_F, -CUDART_INF_F};
      float l_run[2] = {0.f, 0.f};
      float s[BKV / 2];         // this tile's scores, then its probabilities in f32
      uint32_t p[BKV / 16][4];  // the probabilities of the tile before, P V's A operand
      float alpha[2];

      // S = Q K^T of tile t: 64 rows x BKV key columns, head_dim in four k-steps (32 bytes
      // along K's rows)
      auto issue_s = [&](int t) {
        const uint32_t k_tile = ring + ((it + t) % STAGES) * STAGE_BYTES;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_m64n112k16_rs(s, qa[kk], wgmma_desc(k_tile + kk * 32, 16, 1024), kk != 0);
        wgmma_commit();
      };
      // O += P V of tile t: V's rows are the k dimension, 16 of them (2048 bytes) a k-step
      auto issue_pv = [&](int t) {
        const uint32_t v_tile = ring + ((it + t) % STAGES) * STAGE_BYTES + KV_BYTES;
#pragma unroll
        for (int kk = 0; kk < BKV / 16; ++kk)
          wgmma_m64n64k16_rs_tb(acc, p[kk], wgmma_desc(v_tile + kk * 16 * 128, 16, 1024), 1);
        wgmma_commit();
      };
      // the online softmax of tile t on s: masks key columns >= N on the ragged last
      // tile, moves the running max, leaves alpha = 2^((m_old - m_new) scale) and P in s
      // (f32). Score i belongs to row (i >> 1) & 1; the maxima and sums run as eight
      // chains (i & 7) so that two warps a scheduler keep its pipes busy.
      auto softmax = [&](int t) {
        if (t == tiles - 1 && N % BKV != 0) {
          const int col0 = t * BKV + 2 * (lane & 3);
#pragma unroll
          for (int i = 0; i < BKV / 2; ++i)
            if (col0 + (i >> 2) * 8 + (i & 1) >= N) s[i] = -CUDART_INF_F;
        }
        float part[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) part[i] = s[i];
#pragma unroll
        for (int i = 8; i < BKV / 2; ++i) part[i & 7] = fmaxf(part[i & 7], s[i]);
        float m_scaled[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float mx = fmaxf(fmaxf(part[2 * r], part[2 * r + 1]), fmaxf(part[2 * r + 4], part[2 * r + 5]));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          // every tile holds at least one column < N, so the new max is finite
          const float m_new = fmaxf(m_run[r], mx);
          alpha[r] = ex2((m_run[r] - m_new) * scale_log2);  // 0 on the first tile
          m_run[r] = m_new;
          m_scaled[r] = m_new * scale_log2;
        }
        // P = 2^(S scale - m scale): one multiply-add and one exponential a score
#pragma unroll
        for (int i = 0; i < BKV / 2; ++i) {
          s[i] = ex2(fmaf(s[i], scale_log2, -m_scaled[(i >> 1) & 1]));
          part[i & 7] = i < 8 ? s[i] : part[i & 7] + s[i];
        }
#pragma unroll
        for (int r = 0; r < 2; ++r)
          l_run[r] = fmaf(l_run[r], alpha[r],
                          (part[2 * r] + part[2 * r + 1]) + (part[2 * r + 4] + part[2 * r + 5]));
      };
      // O takes the new max; P, rounded to bf16, becomes the next P V's A operand
      auto rescale_and_pack = [&]() {
#pragma unroll
        for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
#pragma unroll
        for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e) p[kk][e] = pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
      };
      auto wait_full = [&](int t) {
        mbar_wait(&full_bar[(it + t) % STAGES], ((it + t) / STAGES) & 1);
      };
      auto release = [&](int t) {
        if (lane == 0) mbar_arrive(&empty_bar[(it + t) % STAGES]);
      };

      // Tile t's S product is issued before tile t-1's P V, and tile t's softmax runs
      // while that P V is in flight: the tensor cores work through this warpgroup's
      // softmax, and the other warpgroups' products fill what is left.
      wait_full(0);
      wgmma_fence();
      issue_s(0);
      wgmma_wait<0>();
      softmax(0);
      rescale_and_pack();
      for (int t = 1; t < tiles; ++t) {
        wait_full(t);
        wgmma_fence();
        issue_s(t);
        issue_pv(t - 1);
        wgmma_wait<1>();  // S of tile t
        softmax(t);
        wgmma_wait<0>();  // P V of tile t - 1: its stage goes back to the producer
        release(t - 1);
        rescale_and_pack();
      }
      wgmma_fence();
      issue_pv(tiles - 1);
      wgmma_wait<0>();
      release(tiles - 1);

      // O / l in f32, bf16 into this warp's own 16 rows of the staging tile, then
      // 16-byte row stores
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
        l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
      }
      const float inv_l[2] = {1.f / l_run[0], 1.f / l_run[1]};
      if (kStats && (lane & 3) == 0) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = q0 + wg * 64 + r0 + 8 * r;
          // ln(sum_j e^(s_j sm_scale)) = (m scale_log2 + log2 l) ln 2
          if (row < N)
            lse[static_cast<long long>(bh) * N + row] =
                (m_run[r] * scale_log2 + log2f(l_run[r])) * 0.69314718055994531f;
        }
      }
      if constexpr (kStats) {
        float* ob32 = o32 + b * so.b + h * so.h;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = q0 + wg * 64 + r0 + 8 * r;
          if (row < N) {
#pragma unroll
            for (int j = 0; j < D / 8; ++j)
              *reinterpret_cast<float2*>(ob32 + row * so.n + 8 * j + 2 * (lane & 3)) =
                  make_float2(acc[4 * j + 2 * r] * inv_l[r], acc[4 * j + 2 * r + 1] * inv_l[r]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int within = 4 * (lane & 3);  // byte offset of this thread's pair in the chunk
        *reinterpret_cast<uint32_t*>(o_rows + r0 * 128 + ((j ^ (r0 & 7)) << 4) + within) =
            pack_bf16(acc[4 * j] * inv_l[0], acc[4 * j + 1] * inv_l[0]);
        *reinterpret_cast<uint32_t*>(o_rows + (r0 + 8) * 128 + ((j ^ (r0 & 7)) << 4) + within) =
            pack_bf16(acc[4 * j + 2] * inv_l[1], acc[4 * j + 3] * inv_l[1]);
      }
      __syncwarp();
      __nv_bfloat16* ob = o + b * so.b + h * so.h;
      const int c = lane & 7;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = warp * 16 + (lane >> 3) + 4 * i;
        const int row = q0 + wg * 64 + r;
        if (row < N)
          *reinterpret_cast<uint4*>(ob + row * so.n + c * 8) =
              *reinterpret_cast<const uint4*>(o_rows + r * 128 + ((c ^ (r & 7)) << 4));
      }
      __syncwarp();  // the rows are read before the next work item overwrites them
    }
  }
}

}  // namespace

extern "C" int tpuhar_flash_attn(const void* q, const void* k, const void* v, void* out,
                                 void* lse, void* o32, int B, int H, int N, float sm_scale,
                                 long long sqb, long long sqh, long long sqn,
                                 long long skb, long long skh, long long skn,
                                 long long svb, long long svh, long long svn,
                                 long long sob, long long soh, long long son, void* stream) {
  // once per device: the SM count, and leave to use more than 48 KB of shared memory
  static int sms_of[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess || device < 0 || device >= 64)
    return static_cast<int>(err != cudaSuccess ? err : cudaErrorInvalidDevice);
  if (sms_of[device] == 0) {
    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(flash_attn_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 SMEM_BYTES);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(flash_attn_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 SMEM_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    sms_of[device] = sms;
  }
  const int sms = sms_of[device];
  const int q_tiles = (N + BQ - 1) / BQ;
  const long long items = static_cast<long long>(B) * H * q_tiles;
  if (items <= 0 || items > 0x7fffffffll) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap q_map, k_map, v_map;
  const Operand qt{q, B, H, N, sqb, sqh, sqn}, kt{k, B, H, N, skb, skh, skn},
      vt{v, B, H, N, svb, svh, svn};
  if (!operand_map(&q_map, qt, BQ) || !operand_map(&k_map, kt, BKV) || !operand_map(&v_map, vt, BKV))
    return static_cast<int>(cudaErrorInvalidValue);
  const int order = heads_inner(qt) | heads_inner(kt) << 1 | heads_inner(vt) << 2;
  const float scale_log2 = sm_scale * 1.4426950408889634f;  // log2(e)
  const int blocks = items < sms ? static_cast<int>(items) : sms;
  // lse and o32 come together (training) or not at all (serving)
  if ((lse == nullptr) != (o32 == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = lse != nullptr ? flash_attn_kernel<true> : flash_attn_kernel<false>;
  kernel<<<blocks, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), static_cast<float*>(o32), H, N,
      q_tiles, static_cast<int>(items), scale_log2, Strides{sob, soh, son}, order, q_map, k_map,
      v_map);
  return static_cast<int>(cudaGetLastError());
}
