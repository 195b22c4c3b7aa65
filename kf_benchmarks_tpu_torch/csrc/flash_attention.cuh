// Shared pieces of the flash-attention kernels for Hopper (sm_90a), bf16:
//
//   flash_attention_fwd.cu  o = softmax(scale*Q K^T + mask) V, lse per row
//   flash_attention_bwd.cu  dK, dV (one kernel) and dQ (another), recomputed
//                           from lse and di = rowsum(o * dO)
//
// Layout: q, k, v are (B, L, H, D) with D contiguous and heads adjacent;
// the kernels take the batch and position strides, so q, k and v may be
// views into one packed (B, L, 3, H, D) projection. Outputs and dO are
// contiguous (B, L, H, D); lse and di are contiguous (B, H, Lq) f32.
//
// Mask: a (q row r, key c) pair is admissible when c < Lk, c <= r under
// `causal` (top-left aligned: row 0 sees key 0, also when Lq != Lk), and
// q_seg[r] == kv_seg[c] when segment ids are given. An inadmissible pair
// contributes exactly 0: in the forward its score is -inf before the row
// max, and the exponent base of a row that has no admissible key yet is 0,
// not -inf; in the backward its probability is selected to 0, and a row
// with no admissible key (lse = +inf) gives 2^-inf = 0 everywhere.
//
// All three kernels share one shape (sm90.cuh has the building blocks):
// warpgroup 0 is the producer, whose warp 0 loads 64-row tiles by TMA
// through 4-D tensor maps over the (B, L, H, D) views (rows past L read as
// zero), 128-byte swizzled, into a ring of stages handed over by `full`
// and `empty` mbarriers; the other warpgroups are consumers, each owning
// 64 rows of the block's output and running m64nNk16 `wgmma`s on the
// tiles. Products that read two stored tiles are ss with both operands
// K-major as stored (S = Q K^T, dP = dO V^T, and their transposes); a
// product whose A is a score-shaped tile (P, dS, or their transposes) takes
// it from registers -- the accumulator layout is the rs A-fragment layout
// -- and reads its B (V, K, Q or dO) MN-major as stored.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace kfattn {

typedef __nv_bfloat16 bf16;

constexpr unsigned FULL = 0xffffffffu;
constexpr int TILE = 64;       // rows of a ring tile and of a warpgroup
constexpr int SUB = 64 * 128;  // bytes of a [64 rows][64] swizzled sub-tile
constexpr float LOG2E = 1.4426950408889634f;

// Element strides of q, k, v: between batches (_b) and positions (_l).
struct Strides {
  long long q_b, q_l, k_b, k_l, v_b, v_l;
};

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
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

// 2^x (ex2.approx: 2^-inf = 0), the exponential __expf is built on.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Key tiles a run of `rows` q rows from q0 reaches: under `causal`, those
// whose first key is at or before the run's last row.
__device__ __forceinline__ int kv_tiles(int q0, int rows, int Lk,
                                        int causal) {
  int n = (Lk + TILE - 1) / TILE;
  if (causal) n = min(n, (q0 + rows - 1) / TILE + 1);
  return n;
}

// Whether a 64 x 64 tile of q rows from q0 and keys from k0 may hold an
// inadmissible pair: segment ids, a ragged last key tile, or the causal
// diagonal. Tiles wholly inside the admissible region skip the
// per-element mask. (Rows past Lq need none: no kernel stores them, and
// the backward gives them lse = +inf, so they add 0 to dK and dV.)
__device__ __forceinline__ bool tile_needs_mask(int q0, int k0, int Lk,
                                                int causal, bool seg) {
  return seg || k0 + TILE > Lk || (causal && k0 + TILE - 1 > q0);
}

// Column (within the 64-wide tile) and row half (0: row g, 1: row g + 8)
// of element e of an m64n64 accumulator (sm90.cuh's layout).
__device__ __forceinline__ int acc_col(int e, int t) {
  return (e / 4) * 8 + 2 * t + (e & 1);
}

__device__ __forceinline__ int acc_half(int e) { return (e / 2) % 2; }

// s = A B^T over depth D, started (not committed): A and B are [D/64][64]
// [64] swizzled tiles in shared memory, both K-major as stored (rows along
// M and N, D contiguous); +32 bytes (2 descriptor units) per 16-deep step
// within a 64-wide column block.
template <int D>
__device__ __forceinline__ void start_abt(float (&s)[32],
                                          const unsigned char* a,
                                          const unsigned char* b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint64_t da = sm90::desc_sw128(a + (kk / 4) * SUB) + 2 * (kk % 4);
    const uint64_t db = sm90::desc_sw128(b + (kk / 4) * SUB) + 2 * (kk % 4);
    sm90::wgmma_ss_m64n64<0>(s, da, db, kk > 0 ? 1 : 0);
  }
}

// acc += A B, started: A the bf16 fragments of a 64 x 64 score-shaped
// tile in registers (depth chunk kc = columns 16kc..16kc+15), B a
// [D/64][64][64] swizzled tile MN-major as stored (its 64 rows are the
// depth): +16 rows (2048 bytes) per step, the 64-wide column blocks of
// D = 128 LBO = SUB apart.
template <int D>
__device__ __forceinline__ void start_ab(float (&acc)[D / 2],
                                         const uint32_t (&a)[4][4],
                                         const unsigned char* b) {
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    const uint64_t db = sm90::desc_sw128(b, SUB) + kc * (2048 >> 4);
    if constexpr (D == 64)
      sm90::wgmma_rs_m64n64<1>(acc, a[kc], db, 1);
    else
      sm90::wgmma_rs_m64n128<1>(acc, a[kc], db, 1);
  }
}

// A 64 x 64 f32 accumulator tile rounded to the bf16 A fragments of an rs
// product: chunk kc holds n-tiles 2kc and 2kc + 1.
__device__ __forceinline__ void pack_frags(uint32_t (&a)[4][4],
                                           const float (&s)[32]) {
#pragma unroll
  for (int kc = 0; kc < 4; ++kc)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[kc][r] = pack_f32(s[8 * kc + 2 * r], s[8 * kc + 2 * r + 1]);
}

// -- the ring -------------------------------------------------------------------

// Producer warp: ring stage j % STAGES gets the 64-row tiles at row r0 of
// two tensor maps (K and V, or Q and dO), each [DH][64][64] at `a_ring` /
// `b_ring` + stage * DH * SUB, once the consumers have released the stage.
// Lane 0 starts the two copies first; fill(stage) then writes the stage's
// small vectors (segment ids, ...) with plain stores while they fly, and
// every lane's arrival publishes its stores.
template <int DH, int STAGES, class Fill>
__device__ __forceinline__ void produce_stage(
    unsigned char* a_ring, unsigned char* b_ring, uint64_t* full,
    uint64_t* empty, const CUtensorMap* a_map, const CUtensorMap* b_map,
    int j, int h, int r0, int b, Fill fill) {
  const int s = j % STAGES;
  sm90::mbar_wait(&empty[s], ((j / STAGES) & 1) ^ 1);
  if (threadIdx.x % 32 == 0) {
    sm90::mbar_expect_tx(&full[s], 2 * DH * SUB);
    for (int dh = 0; dh < DH; ++dh) {
      sm90::tma_load_4d(a_ring + (s * DH + dh) * SUB, a_map, &full[s],
                        dh * 64, h, r0, b);
      sm90::tma_load_4d(b_ring + (s * DH + dh) * SUB, b_map, &full[s],
                        dh * 64, h, r0, b);
    }
  }
  fill(s);
  sm90::mbar_arrive(&full[s]);
}

// Consumer: wait for ring tile j, and release it (one arrival per warp).
template <int STAGES>
__device__ __forceinline__ void ring_wait(uint64_t* full, int j) {
  sm90::mbar_wait(&full[j % STAGES], (j / STAGES) & 1);
}

template <int STAGES>
__device__ __forceinline__ void ring_release(uint64_t* empty, int j) {
  __syncwarp();
  if (threadIdx.x % 32 == 0) sm90::mbar_arrive(&empty[j % STAGES]);
}

// Producer warp: `count` 64-row tiles of one tensor map from row r0 on,
// each [DH][64][64], into `dst` (loaded once, onto barrier `bar`, whose
// expected bytes the caller has set).
template <int DH>
__device__ __forceinline__ void load_rows(unsigned char* dst,
                                          const CUtensorMap* map,
                                          uint64_t* bar, int count, int h,
                                          int r0, int b) {
  for (int i = 0; i < count; ++i)
    for (int dh = 0; dh < DH; ++dh)
      sm90::tma_load_4d(dst + (i * DH + dh) * SUB, map, bar, dh * 64, h,
                        r0 + i * 64, b);
}

// Stores rows g and g + 8 of this thread's warp (the 64-row tile's rows
// row[0], row[1], those below `L`) of an m64nN accumulator as bf16 into
// columns col0 .. col0 + N - 1 of a contiguous (B, L, H, D) tensor, each
// value times mul[half].
template <int D, int N = D>
__device__ __forceinline__ void store_rows(bf16* __restrict__ out,
                                           const float (&acc)[N / 2],
                                           const int (&row)[2],
                                           const float (&mul)[2], int L,
                                           int H, int b, int h, int t,
                                           int col0 = 0) {
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    if (row[ri] >= L) continue;
    bf16* p = out + (((long long)b * L + row[ri]) * H + h) * D + col0;
#pragma unroll
    for (int n = 0; n < N / 8; ++n)
      *reinterpret_cast<uint32_t*>(p + n * 8 + 2 * t) =
          pack_f32(acc[4 * n + 2 * ri] * mul[ri],
                   acc[4 * n + 2 * ri + 1] * mul[ri]);
  }
}

// -- host ------------------------------------------------------------------------

// A tensor map over one of q, k, v, dO: (B, L, H, D) with element strides
// st_b, st_l between batches and positions, heads adjacent and D
// contiguous; boxes of 64 positions x 64 columns of one head.
template <int D>
int qkv_map(CUtensorMap* map, const void* base, int B, int L, int H,
            long long st_b, long long st_l) {
  const uint64_t dims[4] = {(uint64_t)D, (uint64_t)H, (uint64_t)L,
                            (uint64_t)B};
  const uint64_t strides[3] = {(uint64_t)D * 2, (uint64_t)st_l * 2,
                               (uint64_t)st_b * 2};
  const uint32_t box[4] = {64, 1, (uint32_t)TILE, 1};
  return sm90::encode_bf16_sw128(map, base, 4, dims, strides, box);
}

}  // namespace kfattn
