// What the f32 flash kernels (csrc/flash_attn_f32.cu, the forward, and
// csrc/flash_attn_bwd_f32.cu, the dQ and dK/dV kernels) share. All three run every
// product on the tensor cores in split TF32 (csrc/split_tf32.cuh: three m64n64k8 TF32
// products an f32 one) on one block shape: a block holds 128 rows of one (batch, head), 64
// for each of two consumer warpgroups, and a producer warpgroup walks the other side's
// rows in stages of 64, landing them by TMA (4-D tensor maps over the strided views,
// csrc/flash_maps.cuh; rows past N arrive as zeros), splitting them into TF32 hi and lo
// halves as [row][d] tiles and transposing what a product over the stage's rows reads
// into [d][row] tiles (TF32 wgmma reads both operands K-major).
//
// Here: the (B, H, N, 64) f32 views the kernels read and write and the shared-memory
// opt-in; the producer's split and transpose of a stage (Blocks, split_rows,
// transpose_rows, split_transpose_rows); a consumer's load of its held rows' A fragments
// (load_a); the register shuffle that makes an accumulator the A operand of the next
// product (acc_to_a) and the split product itself (split_product); and the ring of two
// [key][d] parts and one [d][key] part through which the forward and the dQ kernel, which
// hold 128 query rows, stream the key rows (KeyRing, produce_keys, hand_back_keys).
//
// Layouts. Held raw rows, as TMA lands them: two halves (head columns 0-31, 32-63) of 128
// rows of 128 bytes, each 16-byte chunk c of row r at r * 128 + ((c ^ (r & 7)) << 4). A
// stage's [row][d] tile: the same, 64 rows a half. A [d][row] tile: two halves (stage rows
// 0-31, 32-63) of 64 head-column rows of 128 bytes, swizzled the same way, where position
// 8 j + 4 par + i of a row holds stage row 8 j + 2 i + par (sigma, below). hi and lo of one
// tile lie TILE_BYTES apart.
//
// The products over the stage's rows take A straight from the accumulators of those over
// d: an accumulator's 8-column group j holds, in a thread's d[4j .. 4j+3], columns 2t and
// 2t + 1 (t = lane % 4) of two rows; the register A operand of a k-step holds columns t
// and t + 4. So a = {d[4j], d[4j+2], d[4j+1], d[4j+3]} is the A of the k-step whose k-th
// column is stage row 8 j + sigma(k), sigma = (0, 2, 4, 6, 1, 3, 5, 7), and the [d][row]
// tiles hold the stage's rows in that order: P and dS never go through shared memory.
// Each product runs in parts of its k-steps (halves; the forward's P V in quarters), each
// part's A in one of two register sets, so one part is split while the other's products
// run; a register is written again only after the products that read it have been waited
// for (ptxas serializes every wgmma otherwise). Each stage's products over its rows land
// in a fresh accumulator that the kernel adds to its running sum in f32 registers, so the
// tensor cores' own accumulation spans 64 rows and not N.
#pragma once
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_maps.cuh"
#include "hopper.cuh"
#include "split_tf32.cuh"

namespace flash_f32 {

using namespace hopper;
using tf32x3::split_raw_lo;
using tf32x3::split_raw_lo_finite;

constexpr int D = 64;  // head_dim
constexpr float LOG2E = 1.4426950408889634f;
constexpr int HELD = 128;                  // rows a block holds: 64 a consumer warpgroup
constexpr int BS = 64;                     // rows of one stage
constexpr int THREADS = 384;               // two consumer warpgroups, then the producer
constexpr int HELD_BYTES = HELD * D * 4;   // the block's rows of one operand, raw: two 16 KB halves
constexpr int HELD_HALF = HELD_BYTES / 2;  // head columns 0-31, then 32-63
constexpr int TILE_BYTES = BS * D * 4;     // a stage's tile of one operand, hi or lo: two 8 KB halves
constexpr int TILE_HALF = TILE_BYTES / 2;  // [row][d]: head columns 0-31, then 32-63;
                                           // [d][row]: stage rows 0-31, then 32-63
constexpr int LAND_BYTES = 2 * TILE_BYTES;  // the stage's raw rows of two operands, as TMA lands them
constexpr int PART_BYTES = 4 * TILE_BYTES;  // a part of a stage: two operands' tiles, hi and lo (64 KB)
constexpr int TR_BYTES = 2 * TILE_BYTES;    // one operand's [d][row] tiles, hi and lo (32 KB)

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

// Producer thread (j, par, c)'s 4 x 4 blocks of one operand's stage: stage rows
// 8 (j + 4 g) + 2 i + par (i = 0..3) of block g = 0, 1 at head columns 4 c .. 4 c + 3.
// Eight lanes of a load or store are (j, par) = all eight pairs at one parity of c and
// four values of c % 8, so their 16-byte chunks fall on eight different bank groups in
// every layout.
struct Blocks {
  int j, par, c;
  __device__ __forceinline__ explicit Blocks(int p)
      : j((p >> 1) & 3), par(p & 1), c(2 * ((((p >> 1) & 3) + (p >> 4)) & 3) + ((p >> 3) & 1) + 8 * (p >> 6)) {}
};

// rows_at: the offset of stage row r's chunk of head columns 4 c .. 4 c + 3 in a
// [row][d] tile (two halves of BS rows x 128 bytes, swizzled), as TMA lands raw rows
__device__ __forceinline__ int rows_at(int r, int c) { return (c >> 3) * TILE_HALF + r * 128 + (((c & 7) ^ (r & 7)) << 4); }

// the raw rows of blocks 0 and 1 at `raw` into TF32 halves at `tile` ([row][d]; hi, then
// lo TILE_BYTES on), a row at a time; `raw` may be the lo tile itself, since each chunk is
// read before it is written
__device__ __forceinline__ void split_rows(const uint8_t* raw, uint8_t* tile, Blocks m) {
#pragma unroll
  for (int g = 0; g < 2; ++g)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int at = rows_at(8 * (m.j + 4 * g) + 2 * i + m.par, m.c);
      const uint4 x = *reinterpret_cast<const uint4*>(raw + at);
      uint32_t v[1][4] = {{x.x, x.y, x.z, x.w}}, lo[1][4];
      split_raw_lo(v, lo);
      *reinterpret_cast<uint4*>(tile + at) = make_uint4(v[0][0], v[0][1], v[0][2], v[0][3]);
      *reinterpret_cast<uint4*>(tile + TILE_BYTES + at) = make_uint4(lo[0][0], lo[0][1], lo[0][2], lo[0][3]);
    }
}

// the same blocks of the split [row][d] tiles at `rows` (hi, lo) transposed into `tile`
// as [d][row] (64 swizzled rows of 128 bytes a half; hi, then lo TILE_BYTES on), where
// position 8 j + 4 par + i of a half's row holds stage row 8 j + 2 i + par (sigma: the
// order in which an accumulator's columns make the register A operand's k), so the
// thread's 4 rows at one head column are one 16-byte chunk
__device__ __forceinline__ void transpose_rows(const uint8_t* rows, uint8_t* tile, Blocks m) {
#pragma unroll
  for (int g = 0; g < 2; ++g)
#pragma unroll
    for (int half = 0; half < 2; ++half) {  // hi, then lo
      uint32_t v[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint4 x =
            *reinterpret_cast<const uint4*>(rows + half * TILE_BYTES + rows_at(8 * (m.j + 4 * g) + 2 * i + m.par, m.c));
        v[i][0] = x.x;
        v[i][1] = x.y;
        v[i][2] = x.z;
        v[i][3] = x.w;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = 4 * m.c + e;
        const int at = half * TILE_BYTES + g * TILE_HALF + n * 128 + (((2 * m.j + m.par) ^ (n & 7)) << 4);
        *reinterpret_cast<uint4*>(tile + at) = make_uint4(v[0][e], v[1][e], v[2][e], v[3][e]);
      }
    }
}

// the raw rows of blocks 0 and 1 at `raw` split and transposed into `tile` in one pass
// (the layout of transpose_rows): for an operand that only a product over the stage's rows
// reads
__device__ __forceinline__ void split_transpose_rows(const uint8_t* raw, uint8_t* tile, Blocks m) {
#pragma unroll
  for (int g = 0; g < 2; ++g) {
    uint32_t v[4][4], lo[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint4 x = *reinterpret_cast<const uint4*>(raw + rows_at(8 * (m.j + 4 * g) + 2 * i + m.par, m.c));
      v[i][0] = x.x;
      v[i][1] = x.y;
      v[i][2] = x.z;
      v[i][3] = x.w;
    }
    split_raw_lo(v, lo);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = 4 * m.c + e;
      const int at = g * TILE_HALF + n * 128 + (((2 * m.j + m.par) ^ (n & 7)) << 4);
      *reinterpret_cast<uint4*>(tile + at) = make_uint4(v[0][e], v[1][e], v[2][e], v[3][e]);
      *reinterpret_cast<uint4*>(tile + TILE_BYTES + at) = make_uint4(lo[0][e], lo[1][e], lo[2][e], lo[3][e]);
    }
  }
}

// the register A operand of the 4 k-steps (8 head columns each) of head-column half
// `half` from this thread's rows r0 and r0 + 8 of a consumer's 64 held raw rows at `rows`
// (head columns 0-31; 32-63 HELD_HALF on): one 4-byte load an element, conflict-free
// under the swizzle
__device__ __forceinline__ void load_a(uint32_t (&a)[4][4], const uint8_t* rows, int half, int r0, int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      a[kk][e] = *reinterpret_cast<const uint32_t*>(rows + half * HELD_HALF + (r0 + 8 * (e & 1)) * 128 +
                                                    (((2 * kk + (e >> 1)) ^ (r0 & 7)) << 4) + 4 * (lane & 3));
}

// the register A operand of kSteps k-steps over 8 kSteps of an accumulator's columns
// (part `part` of its 64: a half for kSteps = 4, a quarter for 2; see the head of the
// file), as f32 bits to be split
template <int kSteps>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[kSteps][4], const float (&d)[BS / 2], int part) {
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    const int j = kSteps * part + kk;
    a[kk][0] = __float_as_uint(d[4 * j]);
    a[kk][1] = __float_as_uint(d[4 * j + 2]);
    a[kk][2] = __float_as_uint(d[4 * j + 1]);
    a[kk][3] = __float_as_uint(d[4 * j + 3]);
  }
}

// acc (+)= A B over part `part` of 64 k (its kSteps k-steps kk: a half for kSteps = 4, a
// quarter for 2): three m64n64k8 products a k-step, small terms first, B a K-major tile
// pair (hi at b, lo TILE_BYTES on) whose k-step ks lies ks / 4 halves and ks % 4 32-byte
// steps along its 128-byte rows; `first` starts the sum
template <int kSteps>
__device__ __forceinline__ void split_product(float (&acc)[32], const uint32_t (&a)[kSteps][4],
                                              const uint32_t (&a_lo)[kSteps][4], uint32_t b, int part, bool first) {
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    const int ks = kSteps * part + kk;
    const uint32_t at = b + (ks >> 2) * TILE_HALF + (ks & 3) * 32;
    wgmma_m64n64k8_rs_tf32(acc, a_lo[kk], wgmma_desc(at, 16, 1024), !(first && kk == 0));
    wgmma_m64n64k8_rs_tf32(acc, a[kk], wgmma_desc(at + TILE_BYTES, 16, 1024), 1);
    wgmma_m64n64k8_rs_tf32(acc, a[kk], wgmma_desc(at, 16, 1024), 1);
  }
}

// a map's dimensions are (64, heads, tokens, batch) where its bit of heads_inner is set,
// else (64, tokens, heads, batch); a box is 32 head columns from d0
__device__ __forceinline__ void load_box(uint8_t* dst, const CUtensorMap* map, uint64_t* bar, int heads_inner, int bit,
                                         int d0, int row, int h, int b) {
  if (heads_inner >> bit & 1)
    tma_load_4d(smem_addr(dst), map, bar, d0, h, row, b);
  else
    tma_load_4d(smem_addr(dst), map, bar, d0, row, h, b);
}

__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(p) + 1023) & ~static_cast<uintptr_t>(1023));
}

// ---- the key-row stream of the kernels that hold 128 query rows (the forward, dQ) -----
// A [key][d] part: K hi, K lo, V hi, V lo. TMA lands a stage's raw K and V rows in its lo
// tiles; the parts are a ring of two, so the producer prepares stage t + 1 while the
// consumers still read stage t. Each stage also fills the one [d][key] part.
constexpr int K_HI = 0, V_HI = 2 * TILE_BYTES;

// each part: full (the producer's 128 threads, after their stores) and empty (lane 0 of
// every consumer warp); a [key][d] part's raw rows: TMA bytes
struct KeyRing {
  uint64_t rows_full[2], rows_empty[2], landed[2], tr_full, tr_empty;
  __device__ __forceinline__ void init() {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      mbar_init(&rows_full[u], 128);
      mbar_init(&rows_empty[u], 8);
      mbar_init(&landed[u], 1);
    }
    mbar_init(&tr_full, 128);
    mbar_init(&tr_empty, 8);
  }
};

// The producer warpgroup's part (thread p = tid - 256) of the stream of k_tiles stages of
// 64 key rows through the ring of [key][d] parts at `rows`; k and v read through their
// maps (bits 1 and 2 of heads_inner). For each stage, split(part, m) makes from the raw
// rows the [key][d] tiles that the products over d read, and transpose(part, m) then
// fills the [d][key] part, once the consumers are past the last stage's; m is the
// thread's blocks of a stage, and each reads back only what the thread itself wrote, or
// raw rows no other thread writes.
template <typename Split, typename Transpose>
__device__ __forceinline__ void produce_keys(KeyRing& ring, uint8_t* rows, int k_tiles, const CUtensorMap* k_map,
                                             const CUtensorMap* v_map, int heads_inner, int h, int b, int p,
                                             Split split, Transpose transpose) {
  auto land_stage = [&](int t) {  // the raw K and V rows of stage t, into part t % 2's lo tiles
    uint8_t* part = rows + (t & 1) * PART_BYTES;
    mbar_arrive_expect_tx(&ring.landed[t & 1], LAND_BYTES);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      load_box(part + K_HI + TILE_BYTES + half * TILE_HALF, k_map, &ring.landed[t & 1], heads_inner, 1, 32 * half,
               t * BS, h, b);
      load_box(part + V_HI + TILE_BYTES + half * TILE_HALF, v_map, &ring.landed[t & 1], heads_inner, 2, 32 * half,
               t * BS, h, b);
    }
  };
  if (p == 0) {
    land_stage(0);
    if (k_tiles > 1) land_stage(1);
  }
  const Blocks m(p);
  for (int t = 0; t < k_tiles; ++t) {
    const int u = t & 1;
    uint8_t* part = rows + u * PART_BYTES;
    // the part's raw rows are in, and the consumers are past the products over d of stage
    // t - 2 (the same part's last use: its landing waited for that)
    mbar_wait(&ring.landed[u], (t >> 1) & 1);
    split(part, m);
    fence_proxy_async();  // the stores become visible to wgmma's reads
    mbar_arrive(&ring.rows_full[u]);
    // every producer thread is past stage t - 1 (which read the other part): the other
    // part takes stage t + 1 once the consumers are past the products over d of t - 1
    bar_sync(1, 128);
    if (p == 0 && t >= 1 && t + 1 < k_tiles) {
      mbar_wait(&ring.rows_empty[u ^ 1], ((t - 1) >> 1) & 1);
      land_stage(t + 1);
    }
    mbar_wait(&ring.tr_empty, (t & 1) ^ 1);  // the consumers are past the [d][key] part of stage t - 1
    transpose(part, m);
    fence_proxy_async();
    mbar_arrive(&ring.tr_full);
  }
}

// a consumer whose 64 rows all lie past N (the last block's second one): hand every stage
// straight back, so that the other consumer has the SM to itself
__device__ __forceinline__ void hand_back_keys(KeyRing& ring, int k_tiles, int lane) {
  for (int t = 0; t < k_tiles; ++t) {
    mbar_wait(&ring.rows_full[t & 1], (t >> 1) & 1);
    if (lane == 0) mbar_arrive(&ring.rows_empty[t & 1]);
    mbar_wait(&ring.tr_full, t & 1);
    if (lane == 0) mbar_arrive(&ring.tr_empty);
  }
}

// ---- host ------------------------------------------------------------------------------
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

// the operands' tensor maps, operand i read in boxes of rows[i] tokens; `order` gets bit i
// set where operand i has its heads inside its tokens
template <int kN>
inline bool operand_maps(CUtensorMap (&maps)[kN], int& order, const flash_maps::Operand (&ops)[kN],
                         const int (&rows)[kN]) {
  order = 0;
  for (int i = 0; i < kN; ++i) {
    if (!flash_maps::operand_map(&maps[i], ops[i], rows[i])) return false;
    order |= flash_maps::heads_inner(ops[i]) << i;
  }
  return true;
}

}  // namespace flash_f32
