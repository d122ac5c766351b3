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
// Design (FlashAttention-2 shaped): one block of 4 warps per (64-row Q tile,
// batch*head); each warp owns 16 Q rows, whose A fragments stay in registers. The block
// walks 64-row K/V tiles, brought into shared memory by cp.async and double-buffered,
// with each 128-byte row's 16-byte chunks XOR-swizzled so ldmatrix reads hit distinct
// banks. S = Q K^T and O += P V run on ldmatrix + mma.sync.m16n8k16 (bf16 in, f32
// accumulate). The online softmax keeps a running max and normalizer per row in
// registers, in the log2 domain (sm_scale * log2 e folded into one multiply of the f32
// scores). Key columns >= N of the ragged last tile are -inf; K, V and Q rows past N are
// zero-filled by cp.async, and ragged Q rows are not stored. The output is staged
// through shared memory so each row leaves as 16-byte stores.
//
// What bounds it: operations. A batch-8 videomae_base call (B*H = 96, N = 1568) is
// 4*96*1568^2*64 = 60.4 GFLOP of tensor-core work (0.061 ms at 989 TFLOP/s) and 236 M
// exponentials, against 77 MB of q, k, v and out (0.023 ms at 3.35 TB/s): the score
// matrix never leaves the SM. This simple design (mma.sync from shared memory, no TMA,
// no wgmma, no warp specialisation) is a first step; those are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int D = 64;         // head_dim
constexpr int BQ = 64;        // query rows per block: 16 per warp
constexpr int BKV = 64;       // key/value rows per tile
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int CHUNKS = D * 2 / 16;                 // 16-byte chunks per row: 8
constexpr int TILE = BKV * D;                      // elements per tile
constexpr int ROWS_PER_PASS = THREADS / CHUNKS;    // rows one pass of the block copies
constexpr int COPIES = BKV / ROWS_PER_PASS;        // 16-byte copies per thread per tile
static_assert(BQ == BKV && BQ == 16 * WARPS, "tile shapes");

struct Strides {
  long long b, h, n;  // in elements
};

// element offset of (row, 16-byte chunk) in a 64x64 bf16 tile: chunk c of row r is
// stored at c ^ (r & 7), so the 8 rows one ldmatrix matrix reads at one chunk sit in 8
// distinct bank groups
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * D + ((chunk ^ (row & 7)) << 3);
}

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

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__global__ void __launch_bounds__(THREADS)
flash_attn_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int H,
                  int N, float scale_log2, Strides sq, Strides sk, Strides sv, Strides so) {
  __shared__ __align__(128) __nv_bfloat16 Qs[TILE];
  __shared__ __align__(128) __nv_bfloat16 Ks[2][TILE];
  __shared__ __align__(128) __nv_bfloat16 Vs[2][TILE];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const __nv_bfloat16* qb = q + b * sq.b + h * sq.h;
  const __nv_bfloat16* kb = k + b * sk.b + h * sk.h;
  const __nv_bfloat16* vb = v + b * sv.b + h * sv.h;
  __nv_bfloat16* ob = o + b * so.b + h * so.h;

  // rows row0.. row0+63 of a (N, 64) matrix into a swizzled tile; rows >= N are zeros
  auto load_tile = [&](__nv_bfloat16* dst, const __nv_bfloat16* src, long long sn, int row0) {
    const int c = tid % CHUNKS;
#pragma unroll
    for (int i = 0; i < COPIES; ++i) {
      const int r = tid / CHUNKS + i * ROWS_PER_PASS;
      const bool ok = row0 + r < N;
      const __nv_bfloat16* g = ok ? src + static_cast<long long>(row0 + r) * sn + c * 8 : src;
      cp_async16(dst + swz(r, c), g, ok);
    }
  };

  const int tiles = (N + BKV - 1) / BKV;
  load_tile(Qs, qb, sq.n, q0);
  load_tile(Ks[0], kb, sk.n, 0);
  load_tile(Vs[0], vb, sv.n, 0);
  cp_async_commit();

  uint32_t qf[4][4];  // this warp's Q as A fragments: 4 k-steps of 16 over head_dim
  float acc[8][4];    // O: 8 n-tiles of 8 head_dim columns; rows lane/4 and lane/4 + 8
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  // running max (log2 domain) of rows lane/4 and lane/4 + 8, and this thread's share of
  // their normalizers (its 2 of every 8 columns; the quad's shares are summed at the end)
  float m_run[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l_run[2] = {0.f, 0.f};

  for (int t = 0; t < tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < tiles) {
      load_tile(Ks[buf ^ 1], kb, sk.n, (t + 1) * BKV);
      load_tile(Vs[buf ^ 1], vb, sv.n, (t + 1) * BKV);
    }
    cp_async_commit();  // an empty group on the last tile keeps the wait count uniform
    cp_async_wait_prev();
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        ldsm_x4(qf[kk], Qs + swz(warp * 16 + (lane & 15), kk * 2 + (lane >> 4)));
    }

    // S = Q K^T: 16 rows x 64 key columns per warp, as 8 n-tiles of 8 columns
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {  // each x4 load covers two k-steps
        uint32_t kf[4];
        ldsm_x4(kf, Ks[buf] + swz(j * 8 + (lane & 7), kk * 4 + (lane >> 3)));
        mma_bf16(s[j], qf[2 * kk], kf[0], kf[1]);
        mma_bf16(s[j], qf[2 * kk + 1], kf[2], kf[3]);
      }
    }

    // scale (f32, log2 domain), mask key columns >= N, this tile's row maxima
    const int col0 = t * BKV + 2 * (lane & 3);
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = col0 + j * 8 + (e & 1) < N ? s[j][e] * scale_log2 : -CUDART_INF_F;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // every tile holds at least one column < N, so the new max is finite
      const float m_new = fmaxf(m_run[r], mx[r]);
      alpha[r] = exp2f(m_run[r] - m_new);  // 0 on the first tile
      m_run[r] = m_new;
      l_run[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }

    // P = exp2(S - m) in f32 for the normalizer, rounded to bf16 as P V's A fragments:
    // key n-tiles 2kk and 2kk+1 form k-step kk
    uint32_t pf[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[j][e] - m_run[e >> 1]);
        l_run[e >> 1] += p;
        s[j][e] = p;
      }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pf[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pf[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pf[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pf[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    }

    // O += P V: V's rows are the k dimension, so its B fragments load transposed
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int c = 0; c < 4; ++c) {  // each x4 load covers two head_dim n-tiles
        uint32_t vf[4];
        ldsm_x4_trans(vf, Vs[buf] + swz(kk * 16 + (lane & 15), c * 2 + (lane >> 4)));
        mma_bf16(acc[2 * c], pf[kk], vf[0], vf[1]);
        mma_bf16(acc[2 * c + 1], pf[kk], vf[2], vf[3]);
      }
    __syncthreads();  // the next tile's loads overwrite this buffer
  }

  // O / l in f32, bf16 into this warp's own 16 rows of Qs, then 16-byte row stores
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  const int r0 = warp * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = j * 8 + 2 * (lane & 3);
    *reinterpret_cast<uint32_t*>(Qs + swz(r0, j) + (col & 7)) =
        pack_bf16(acc[j][0] / l_run[0], acc[j][1] / l_run[0]);
    *reinterpret_cast<uint32_t*>(Qs + swz(r0 + 8, j) + (col & 7)) =
        pack_bf16(acc[j][2] / l_run[1], acc[j][3] / l_run[1]);
  }
  __syncwarp();
  const int c = lane % CHUNKS;
#pragma unroll
  for (int i = 0; i < 16 * CHUNKS / 32; ++i) {
    const int r = warp * 16 + lane / CHUNKS + i * (32 / CHUNKS);
    if (q0 + r < N)
      *reinterpret_cast<uint4*>(ob + static_cast<long long>(q0 + r) * so.n + c * 8) =
          *reinterpret_cast<const uint4*>(Qs + swz(r, c));
  }
}

}  // namespace

extern "C" int tpuhar_flash_attn(const void* q, const void* k, const void* v, void* out,
                                 int B, int H, int N, float sm_scale,
                                 long long sqb, long long sqh, long long sqn,
                                 long long skb, long long skh, long long skn,
                                 long long svb, long long svh, long long svn,
                                 long long sob, long long soh, long long son, void* stream) {
  const float scale_log2 = sm_scale * 1.4426950408889634f;  // log2(e)
  const dim3 grid((N + BQ - 1) / BQ, B * H);
  flash_attn_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), H, N,
      scale_log2, Strides{sqb, sqh, sqn}, Strides{skb, skh, skn}, Strides{svb, svh, svn},
      Strides{sob, soh, son});
  return static_cast<int>(cudaGetLastError());
}
