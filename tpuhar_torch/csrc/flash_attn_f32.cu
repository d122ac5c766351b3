// Non-causal flash attention forward on Hopper (sm_90a), f32, head_dim 64.
//
// The f32 form of csrc/flash_attn.cu: it replaces the same two TPU kernels on f32
// operands, tpuhar/ops/flash_lean.py: flash_lean (body _kernel) and the stock Pallas TPU
// flash kernel's forward that tpuhar/ops/attention.py: flash_mha(kernel="library")
// reaches (jax.experimental.pallas.ops.tpu.flash_attention: _flash_attention_kernel),
// which run their products in the operands' type with f32 sums. Per (batch, head):
// out = softmax(Q K^T * sm_scale) V over N tokens, with f32 scores, the running max and
// normalizer, P kept in f32 for the product with V, and the division by the normalizer
// at the end; with `lse` set it also stores each row's log-sum-exp of the scaled scores,
// m * sm_scale + ln(l), at lse[(b * H + h) * N + row], which the backward kernels
// (csrc/flash_attn_bwd_f32.cu) recompute P from. The f32 output is the one the dQ kernel
// forms di = rowsum(O o dO) from, so the training form stores nothing more.
//
// q, k, v and out are (B, H, N, 64) with any strides whose last one is 1 and whose rows
// start on 16-byte boundaries; the wrapper hands over the native (B, N, H*64)
// projections and a (B, N, H, 64) output buffer. A 1-D grid of B * H * ceil(N / 128) work
// items, the query blocks of one head next to each other so that its K and V stay in L2.
// Each block owns its query rows: no atomics, the same bits from call to call.
//
// What bounds it: operations. Both products run in f32 on the tensor cores in split TF32
// (three TF32 products an f32 one, csrc/split_tf32.cuh; a single TF32 pass keeps about
// three decimal digits, another function). A batch-8 videomae_base call (B*H = 96,
// N = 1568) is 4*96*1568^2*64 = 60.4 GFLOP: 0.366 ms at 165 TFLOP/s of f32 work (0.90 ms
// at the CUDA cores' 67 TFLOP/s of FFMA), against 77 MB of q, k, v and out (0.023 ms at
// 3.35 TB/s): the score matrix never leaves the SM.
//
// Design: the dQ kernel's block (csrc/flash_f32.cuh) with one product fewer. A block holds
// 128 query rows, 64 for each of two consumer warpgroups, and a producer warpgroup walks
// the key rows in stages of 64; launched with 168 registers a thread, setmaxnreg 88/208/208.
//  - Q arrives once by TMA (raw f32, 32 KB; query rows past N as zeros). Each consumer
//    thread loads its A fragments of Q (rows r0 and r0 + 8, all 64 head columns), splits
//    them once (split_raw_lo) and holds them in 64 registers for the whole loop.
//  - The producer lands each stage's raw K and V rows in the lo tiles of one of a ring of
//    two [key][d] parts (key rows past N as zeros). It splits K in place into the part's
//    hi and lo tiles, the B of S = Q K^T, and hands the part over; then it splits V's raw
//    rows and transposes them in one pass into the one [d][key] part (32 KB), the key rows
//    in the sigma order of acc_to_a, the B of O += P V. With Q, 193 KB: one block an SM.
//  - A stage: S = Q K^T against K's tiles (three m64n64k8 TF32 products a k-step, the two
//    small terms in an accumulator of their own, added to hi_q hi_k's in f32 after the
//    products), and the part goes back; the online softmax on the accumulator (a row
//    over the four lanes of a quad: the max by two shuffles; key columns past N get -inf,
//    and every stage starts below N, so the running max stays finite), P = 2^(S scale
//    log2 e - m scale log2 e) in place of S (ex2.approx.ftz: a subnormal P adds nothing an
//    f32 sum keeps), each thread's share of l = l alpha + its row sum (summed over the
//    quad after the loop); O_stage = P V with A straight from the S accumulator (P in
//    [0, 1]: split_raw_lo_finite) in quarters of 16 key rows, two register sets taking
//    turns, into a fresh accumulator; then O = alpha O + O_stage in f32 registers, so the
//    tensor cores' own accumulation spans 64 keys and not N.
//  - After the loop: O / l through the output's strides, each quad storing 32 bytes of a
//    row, for rows below N; with the LSE, m scale + ln(l).
// A block's second consumer whose 64 query rows lie past N (the last block of a head at
// N = 1568 holds 32 rows) hands every stage straight back.
//
// Measured on an H100 (80GB HBM3, 700 W) by time_flash_f32 at (8, 12, 1568, 64), in turns
// (with the LSE at (16, 12, 1568, 64) alike). The first form, dQ's design with V in place
// of K (V split in place, then transposed from its split tiles; Q reloaded from
// fragment-major shared memory and split every stage; 72/216 registers): 0.889-0.906 ms
// against the FFMA form's 1.83-1.91. Against it in the same turns: V split and transposed
// in one pass from its raw rows, so that the part goes to the consumers once K is split,
// 0.686-0.704; exp2f by ex2.approx.ftz, 0.865-0.881. Then, against both: Q split once and
// held in registers, P V in quarters, 88/208 registers (at 72 the producer's one-pass
// split spilled 36 bytes), 0.630-0.676 against 0.686-0.713. S's small terms in their own
// accumulator: 0.642-0.664 against 0.629-0.656, the LSE's mean error -1.8e-7 against
// -4.0e-7 and O's largest 1.2e-6 against 2.3e-6 at (2, 12, 1568). Final: 0.641-0.650 ms
// against the FFMA form's 1.87-1.94 in six turns of one call; with the LSE 1.240-1.249
// against 3.62-3.77. Level or slower, each in turns against the form it changed: the
// consumers taking turns to issue S (named barriers), a second [d][key] part, S(t + 1)
// issued while P V(t) runs (the last stage peeled), B read as [hi | lo] by one m64n128k8 a
// k-step (it spills), V split a head column at a time (no spill, four checks), Q split
// once into hi and lo tiles in shared memory; P V's small terms in their own accumulator
// too, with Q from shared memory to make room (O's largest error 9.2e-7), 0.696-0.728.
// Ablations (timing only): no exponentials, level; Q neither loaded nor split, 8% faster;
// the producer splitting nothing, 13% faster.
#include <cuda.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "flash_f32.cuh"
#include "kernel_table.cuh"

using namespace flash_f32;

namespace {

// 2^x by the MUFU instruction alone, subnormal results flushed to 0 (exp2f adds a
// subnormal path; P and alpha below 2^-126 add nothing an f32 sum keeps)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// S (+)= Q K^T over half `half` of d as split_product computes it, with the products of
// the small terms in an accumulator of their own: s_hi (+)= hi_q hi_k and s_lo (+)= lo_q
// hi_k + hi_q lo_k, added in f32 after the products. The tensor cores' additions into an
// accumulator truncate, so the small terms added into the large sum left S biased toward
// zero (an LSE 4.0e-7 low on average at (2, 12, 1568), which moved the f32 ViT's second
// training step at batch 8 by 6.3e-4 in its gradient norm against float64); apart, each
// sum truncates at its own scale (1.8e-7)
__device__ __forceinline__ void score_product(float (&s_hi)[BS / 2], float (&s_lo)[BS / 2], const uint32_t (&a)[4][4],
                                              const uint32_t (&a_lo)[4][4], uint32_t b, int half) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t at = b + half * TILE_HALF + kk * 32;
    const int keep = !(half == 0 && kk == 0);
    wgmma_m64n64k8_rs_tf32(s_lo, a_lo[kk], wgmma_desc(at, 16, 1024), keep);
    wgmma_m64n64k8_rs_tf32(s_hi, a[kk], wgmma_desc(at, 16, 1024), keep);
    wgmma_m64n64k8_rs_tf32(s_lo, a[kk], wgmma_desc(at + TILE_BYTES, 16, 1024), 1);
  }
}

// Q, the ring of two [key][d] parts, the [d][key] part (V), and room to align to 1024 bytes
constexpr int SMEM_BYTES = HELD_BYTES + 2 * PART_BYTES + TR_BYTES + 1024;

template <bool kStats>
__global__ void __launch_bounds__(THREADS, 1)
flash_attn_f32_kernel(OutView o, float* __restrict__ lse, int H, int N, int q_tiles, float sm_scale, int heads_inner,
                      const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
                      const __grid_constant__ CUtensorMap v_map) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ KeyRing ring;
  __shared__ uint64_t q_full;  // Q: TMA bytes
  uint8_t* smem = align_1024(smem_raw);
  uint8_t* rows = smem + HELD_BYTES;  // Q, the two [key][d] parts, the [d][key] part
  uint8_t* tr = rows + 2 * PART_BYTES;
  const int item = blockIdx.x;  // query blocks of one head next to each other: its K and V stay in L2
  const int bh = item / q_tiles, q0 = (item % q_tiles) * HELD;
  const int h = bh % H, b = bh / H;
  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  const int k_tiles = (N + BS - 1) / BS;

  if (tid == 0) {
    ring.init();
    mbar_init(&q_full, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    // ------------------------------- producer -------------------------------------
    reg_dealloc<88>();
    const int p = tid - 256;
    if (p == 0) {
      mbar_arrive_expect_tx(&q_full, HELD_BYTES);
#pragma unroll
      for (int half = 0; half < 2; ++half)
        load_box(smem + half * HELD_HALF, &q_map, &q_full, heads_inner, 0, 32 * half, q0, h, b);
    }
    // K split in place, the B of S; V split and transposed in one pass from its raw rows
    // into the [d][key] part, the B of P V (no product reads V's [key][d] tiles)
    produce_keys(
        ring, rows, k_tiles, &k_map, &v_map, heads_inner, h, b, p,
        [](uint8_t* part, Blocks m) { split_rows(part + K_HI + TILE_BYTES, part + K_HI, m); },
        [tr](uint8_t* part, Blocks m) { split_transpose_rows(part + V_HI + TILE_BYTES, tr, m); });
  } else {
    // ------------------------------- consumers ------------------------------------
    reg_alloc<208>();
    const int warp = (tid & 127) >> 5;
    const int r0 = 16 * warp + (lane >> 2);  // this thread's query rows r0 and r0 + 8 of its 64
    const int row0 = q0 + 64 * wg;
    if (row0 >= N) {
      hand_back_keys(ring, k_tiles, lane);
      return;
    }
    uint8_t* q_rows = smem + wg * (64 * 128);
    const uint32_t rows_addr = smem_addr(rows), tr_addr = smem_addr(tr);
    const int col = 2 * (lane & 3);  // element e of an accumulator's group j: column 8 j + col + e % 2
    mbar_wait(&q_full, 0);
    // Q's A fragments (this thread's rows r0 and r0 + 8, both halves of d), split once and
    // held in registers for the whole loop
    uint32_t q_hi[2][4][4], q_lo[2][4][4];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      load_a(q_hi[half], q_rows, half, r0, lane);
      split_raw_lo(q_hi[half], q_lo[half]);
    }
    // accumulator layout: group j's d[4j], d[4j+1] are row r0, head (or key) columns
    // 8 j + col, +1; d[4j+2], d[4j+3] the same columns of row r0 + 8: element i's row is
    // r0 + 8 ((i >> 1) & 1)
    float o_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o_acc[i] = 0.f;
    float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};  // raw running max; the thread's share of l
    const float scale_log2 = sm_scale * LOG2E;

    for (int t = 0; t < k_tiles; ++t) {
      // S = Q K^T (64 query rows x 64 key columns) over d: B is the stage's [key][d] K tiles
      float s[BS / 2], s_lo[BS / 2];
      const uint32_t kv = rows_addr + (t & 1) * PART_BYTES;  // the stage's [key][d] part
      mbar_wait(&ring.rows_full[t & 1], (t >> 1) & 1);
      wgmma_fence();
      score_product(s, s_lo, q_hi[0], q_lo[0], kv + K_HI, 0);
      score_product(s, s_lo, q_hi[1], q_lo[1], kv + K_HI, 1);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < BS / 2; ++i) s[i] += s_lo[i];
      __syncwarp();
      if (lane == 0) mbar_arrive(&ring.rows_empty[t & 1]);  // the [key][d] part goes back to the producer
      // the online softmax: -inf in the key columns past N (8 jj + e % 2 >= lim), the
      // rows' max over the quad, alpha and P in place of S, the thread's row sums
      const int lim = N - t * BS - col;
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int jj = 0; jj < BS / 8; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (8 * jj + (e & 1) >= lim) s[4 * jj + e] = -CUDART_INF_F;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * jj + e]);
        }
      float alpha[2], mb[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 1));
        mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 2));
        alpha[half] = ex2((m[half] - mx[half]) * scale_log2);  // 0 on the first stage
        mb[half] = mx[half] * scale_log2;
        m[half] = mx[half];
      }
#pragma unroll
      for (int i = 0; i < BS / 2; ++i) {
        s[i] = ex2(fmaf(s[i], scale_log2, -mb[(i >> 1) & 1]));
        sum[(i >> 1) & 1] += s[i];
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) l[half] = fmaf(l[half], alpha[half], sum[half]);
      // O_stage = P V over the stage's 64 key rows: A straight from the P accumulator (P in
      // [0, 1]: split_raw_lo_finite), B V's [d][key] tiles; in quarters of 16 key rows, two
      // sets of A registers taking turns (each written again only after the products that
      // read it have been waited for); into a fresh accumulator, then O = alpha O + O_stage
      // in f32
      mbar_wait(&ring.tr_full, t & 1);
      float part[D / 2];
      uint32_t pa[2][4], pa_lo[2][4], pb[2][4], pb_lo[2][4];
      auto quarter = [&](uint32_t (&a)[2][4], uint32_t (&a_lo)[2][4], int q) {
        acc_to_a(a, s, q);
        split_raw_lo_finite(a, a_lo);
        wgmma_fence();
        split_product(part, a, a_lo, tr_addr, q, q == 0);
        wgmma_commit();
      };
      quarter(pa, pa_lo, 0);
      quarter(pb, pb_lo, 1);
      wgmma_wait<1>();  // quarter 0, which read pa
      quarter(pa, pa_lo, 2);
      wgmma_wait<1>();  // quarter 1, which read pb
      quarter(pb, pb_lo, 3);
      wgmma_wait<0>();
      __syncwarp();
      if (lane == 0) mbar_arrive(&ring.tr_empty);  // and the [d][key] part
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o_acc[i] = fmaf(o_acc[i], alpha[(i >> 1) & 1], part[i]);
    }
    const long long bh64 = bh;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      l[half] += __shfl_xor_sync(0xffffffffu, l[half], 1);
      l[half] += __shfl_xor_sync(0xffffffffu, l[half], 2);
      const int row = row0 + r0 + 8 * half;
      if (row >= N) continue;
      float* po = row_of(o, b, h, row);
#pragma unroll
      for (int jj = 0; jj < D / 8; ++jj)
        *reinterpret_cast<float2*>(po + 8 * jj + col) =
            make_float2(o_acc[4 * jj + 2 * half] / l[half], o_acc[4 * jj + 2 * half + 1] / l[half]);
      if constexpr (kStats) {
        if ((lane & 3) == 0) lse[bh64 * N + row] = fmaf(m[half], sm_scale, logf(l[half]));
      }
    }
  }
}

}  // namespace

namespace tpuhar_kernels {
extern const Entry flash_attn_f32[2] = {
    {"flash_attn_f32", reinterpret_cast<const void*>(&flash_attn_f32_kernel<false>)},
    {"flash_attn_f32_stats", reinterpret_cast<const void*>(&flash_attn_f32_kernel<true>)},
};
}  // namespace tpuhar_kernels

// out = softmax(q k^T * sm_scale) v in f32, and with `lse` non-null each row's
// log-sum-exp; q, k, v and out (B, H, N, 64) f32 through their (batch, head, token)
// element strides, lse (B, H, N) f32 contiguous
extern "C" int tpuhar_flash_attn_f32(const void* q, const void* k, const void* v, void* out, void* lse,
                                     int B, int H, int N, float sm_scale,
                                     long long sqb, long long sqh, long long sqn,
                                     long long skb, long long skh, long long skn,
                                     long long svb, long long svh, long long svn,
                                     long long sob, long long soh, long long son, void* stream) {
  static bool ready[2][64] = {};
  cudaError_t err = allow_smem(flash_attn_f32_kernel<false>, SMEM_BYTES, ready[0]);
  if (err == cudaSuccess) err = allow_smem(flash_attn_f32_kernel<true>, SMEM_BYTES, ready[1]);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || H <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int q_tiles = (N + HELD - 1) / HELD;
  const long long items = static_cast<long long>(B) * H * q_tiles;
  if (items > 0x7fffffffll) return static_cast<int>(cudaErrorInvalidValue);
  // q: boxes of a block's query rows; k and v: of a stage's key rows
  const flash_maps::Operand ops[3] = {
      {q, B, H, N, sqb, sqh, sqn, true}, {k, B, H, N, skb, skh, skn, true}, {v, B, H, N, svb, svh, svn, true}};
  CUtensorMap maps[3];
  int order = 0;
  const int boxes[3] = {HELD, BS, BS};
  if (!operand_maps(maps, order, ops, boxes)) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = lse != nullptr ? flash_attn_f32_kernel<true> : flash_attn_f32_kernel<false>;
  kernel<<<static_cast<unsigned>(items), THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      OutView{static_cast<float*>(out), sob, soh, son}, static_cast<float*>(lse), H, N, q_tiles, sm_scale, order,
      maps[0], maps[1], maps[2]);
  return static_cast<int>(cudaGetLastError());
}
