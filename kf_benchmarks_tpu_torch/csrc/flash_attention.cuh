// Shared pieces of the flash-attention kernels for Hopper (sm_90a), bf16.
//
//   flash_attention_fwd.cu  o = softmax(scale*Q K^T + mask) V, lse per row
//   flash_attention_bwd.cu  dK, dV (one kernel) and dQ (another), recomputed
//                           from lse and di = rowsum(o * dO)
//
// Layout: q, k, v are (B, L, H, D) with D contiguous; the kernels take the
// batch and position strides, so q, k and v may be views into one packed
// (B, L, 3, H, D) projection. Outputs and dO are contiguous (B, L, H, D);
// lse and di are contiguous (B, H, Lq) f32.
//
// Mask: a (q row r, key c) pair is admissible when c < Lk, c <= r under
// `causal` (top-left aligned: row 0 sees key 0, also when Lq != Lk), and
// q_seg[r] == kv_seg[c] when segment ids are given. An inadmissible pair
// contributes exactly 0: its score is -inf before the row max, and the
// exponent base of a row that has no admissible key yet is 0, not -inf.
//
// Design (a plain first kernel; wgmma, TMA and a persistent layout are later
// work): one block of 4 warps per (64-row tile, head, batch); each warp owns
// 16 rows of the tile and all 64 columns of the score tile, computed with
// `mma.sync.m16n8k16` bf16 products into f32 registers. The score tile's
// accumulator fragments are re-packed in registers as the A operand of the
// next product (P V, P^T dO, dS K, ...), so no score or probability tile
// ever goes to shared or device memory. Operand tiles are staged in shared
// memory with a padded row pitch (D + 8) that keeps the 32-bit fragment
// reads free of bank conflicts; tiles are loaded synchronously (no cp.async
// pipeline yet), and enough blocks are resident per SM to hide the latency.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace kfattn {

typedef __nv_bfloat16 bf16;

constexpr int BQ = 64;        // q rows of a tile: 4 warps x 16
constexpr int BKV = 64;       // key rows of a tile
constexpr int THREADS = 128;
constexpr int NT = BKV / 8;   // 8-column n-tiles of a 64-wide score tile
constexpr unsigned FULL = 0xffffffffu;

// Element strides of q, k, v: between batches (_b) and positions (_l).
struct Strides {
  long long q_b, q_l, k_b, k_l, v_b, v_l;
};

// c += a * b for one 16x8x16 bf16 tile, f32 accumulation. Fragment layout
// (g = lane / 4, t = lane % 4):
//   a[0] (row g,   k 2t..2t+1)  a[1] (row g+8, k 2t..2t+1)
//   a[2] (row g,   k 2t+8..+9)  a[3] (row g+8, k 2t+8..+9)
//   b0   (k 2t..2t+1, col g)    b1   (k 2t+8..+9, col g)
//   c[0..1] (row g, col 2t..2t+1)   c[2..3] (row g+8, col 2t..2t+1)
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two bf16 values from two addresses as one register, `lo` in the low half.
__device__ __forceinline__ uint32_t pack_two(const bf16* lo, const bf16* hi) {
  return static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(lo)) |
         (static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(hi)) << 16);
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Rows [row0, row0 + 64) of an (L, D) slice with row stride `ld` (elements)
// into a [64][D + 8] shared tile; rows at or past L are zero.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int row0,
                                          int L, long long ld) {
  constexpr int VPR = D / 8;  // 16-byte vectors per row
  for (int v = threadIdx.x; v < 64 * VPR; v += THREADS) {
    const int r = v / VPR;
    const int c = (v % VPR) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < L)
      val = *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) * ld + c);
    *reinterpret_cast<uint4*>(dst + r * (D + 8) + c) = val;
  }
}

// Segment ids of rows [row0, row0 + 64) (0 past L or without segment ids).
__device__ __forceinline__ void load_seg(int* dst, const int* seg, int row0,
                                         int L) {
  for (int r = threadIdx.x; r < 64; r += THREADS)
    dst[r] = (seg != nullptr && row0 + r < L) ? seg[row0 + r] : 0;
}

// A operand (16 rows x 16 k) from a row-major shared tile at (r0, k0).
template <int P>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* tile,
                                       int r0, int k0, int g, int t) {
  a[0] = ld32(tile + (r0 + g) * P + k0 + 2 * t);
  a[1] = ld32(tile + (r0 + g + 8) * P + k0 + 2 * t);
  a[2] = ld32(tile + (r0 + g) * P + k0 + 2 * t + 8);
  a[3] = ld32(tile + (r0 + g + 8) * P + k0 + 2 * t + 8);
}

// B operand (16 k x 8 n) with B[k][n] = tile[n0 + n][k0 + k]: the tile's rows
// are the product's columns (K in Q K^T), contiguous along k.
template <int P>
__device__ __forceinline__ void frag_b_nk(uint32_t& b0, uint32_t& b1,
                                          const bf16* tile, int n0, int k0,
                                          int g, int t) {
  b0 = ld32(tile + (n0 + g) * P + k0 + 2 * t);
  b1 = ld32(tile + (n0 + g) * P + k0 + 2 * t + 8);
}

// B operand (16 k x 8 n) with B[k][n] = tile[k0 + k][n0 + n]: the tile's rows
// are the product's depth (V in P V).
template <int P>
__device__ __forceinline__ void frag_b_kn(uint32_t& b0, uint32_t& b1,
                                          const bf16* tile, int k0, int n0,
                                          int g, int t) {
  b0 = pack_two(tile + (k0 + 2 * t) * P + n0 + g,
                tile + (k0 + 2 * t + 1) * P + n0 + g);
  b1 = pack_two(tile + (k0 + 2 * t + 8) * P + n0 + g,
                tile + (k0 + 2 * t + 9) * P + n0 + g);
}

// A operand for depth chunk kc (columns 16kc..16kc+15) from a score tile in
// accumulator layout, rounded to bf16: n-tiles 2kc and 2kc+1.
__device__ __forceinline__ void frag_a_from_acc(uint32_t (&a)[4],
                                                const float (&s)[NT][4],
                                                int kc) {
  a[0] = pack_f32(s[2 * kc][0], s[2 * kc][1]);
  a[1] = pack_f32(s[2 * kc][2], s[2 * kc][3]);
  a[2] = pack_f32(s[2 * kc + 1][0], s[2 * kc + 1][1]);
  a[3] = pack_f32(s[2 * kc + 1][2], s[2 * kc + 1][3]);
}

// Sum and max over the four lanes that share a row (t = 0..3).
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(FULL, x, 1);
  return x + __shfl_xor_sync(FULL, x, 2);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(FULL, x, 1));
  return fmaxf(x, __shfl_xor_sync(FULL, x, 2));
}

// Number of key tiles a q tile starting at q0 reaches: under `causal`, the
// tiles whose first key is at or before the tile's last row.
__device__ __forceinline__ int kv_tiles(int q0, int Lk, int causal) {
  int n = (Lk + BKV - 1) / BKV;
  if (causal) n = min(n, (q0 + BQ - 1) / BKV + 1);
  return n;
}

// Opt a kernel into more than 48 KB of dynamic shared memory when needed.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace kfattn
