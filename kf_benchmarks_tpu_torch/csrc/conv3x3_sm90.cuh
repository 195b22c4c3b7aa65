// Implicit-GEMM 3x3 SAME stride-1 convolution on Hopper's wgmma and TMA
// (sm_90a), NHWC bf16 in and out, f32 accumulation.
//
// The product is C[M, CO] = A[M, 9*C] * B[9*C, CO] with M = N*H*W output
// pixels and K index k = (dy*3 + dx)*C + c. B is the weight tensor as the
// K-major [CO, 3, 3, C] array (the wrapper hands the kernel that layout).
// A is never materialised: each 64-deep K tile of A is one TMA load of a
// box of the NHWC image -- wb x hb pixels of nb images, 64 channels --
// shifted by the tap (dy, dx). Coordinates outside the image read zero,
// which is exactly the one-pixel SAME padding: the box for tap (0, 0) of
// the tile at w = 0 starts at w = -1.
//
// What bounds it: the tensor cores need 9*C*CO*2 FLOP a pixel, but every
// 64-deep stage brings (box pixels + BN) x 128 bytes from L2 to shared
// memory for 2 * BM * BN * 64 FLOP, and an SM draws only ~24-40 bytes a
// cycle from L2 (measured on an H100: a 128 x 128 tile fed by 16-byte
// gathers ran at ~24, ~38% of the bf16 peak). So A comes by TMA, the tile
// is as large as the registers allow -- BM x BN of 256 x 64, 256 x 128 or
// 128 x 256 beside the 128-row ones -- and the wrapper (ops/conv_bn.py
// `conv_tile`) picks the tile and the box per shape from a cost fitted to
// the measured stages (waves x (rows moved + products)). A box of
// wb * hb * nb <= BM pixels fills the first rows of the BM-row A tile; the
// rows past it compute values nobody stores (a box that fits the image's
// width and height exactly, 28 x 4 x 2 = 224 of 256 rows at 28 x 28,
// wastes 12.5% of the products).
//
// Design (one persistent block of 384 threads per SM):
//   * warpgroup 0 is the producer: one thread loads A and B by TMA (both
//     CU_TENSOR_MAP_SWIZZLE_128B, the layout the wgmma descriptors name)
//     into a ring of STAGES stages (~200 KB), each with a `full` mbarrier
//     (its arrival and the bytes) and an `empty` one (one arrival per
//     consumer warp);
//   * warpgroups 1 and 2 are the consumers: each owns BM/2 rows (WM slabs
//     of 64) of the BM x BN output tile and runs m64nBNk16 `wgmma`s from
//     shared memory, 4 * WM per stage, keeping one stage's products in
//     flight while it releases the stage before;
//   * tiles are walked persistently (tile += gridDim.x, BN-tiles of one
//     box adjacent so they share its pixels in L2), so one tile's epilogue
//     overlaps the next tile's loads, and the last wave is at most one tile
//     per SM ragged;
//   * the epilogue rounds the f32 sums to bf16 once and stores 16-byte
//     vectors straight from registers: the four lanes that hold a row's
//     eight columns of four n-tiles transpose them by shuffles, so each lane
//     stores one n-tile's 16 bytes; rows outside the box or the image are
//     masked.
//
// Where K-B's BN-apply/ReLU prologue goes (later work): between the
// consumer's wait on `full` and its products. The consumer would load its
// 64 x 64 A slices from the swizzled stage into registers (ldmatrix), apply
// relu(x*sc + sh) there, with the padding kept at exact zero -- the box
// reads 0 outside the image, which the prologue would turn into relu(sh);
// a consumer knows from the tap and the row's pixel which rows those are --
// and run `wgmma_rs` (A from registers) instead of `wgmma_ss`.
// K-B's statistics are a second Epilogue policy beside StoreY: the sums of
// the stored bf16 values per column, reduced over the tile's rows into
// per-tile partials as conv3x3_igemm.cuh does.

#pragma once

#include "sm90.cuh"

namespace kfconv90 {

typedef __nv_bfloat16 bf16;

constexpr int BK = 64;        // K depth of a stage: 128 bytes of bf16
constexpr int THREADS = 384;  // producer warpgroup + 2 consumer warpgroups
constexpr unsigned FULL = 0xffffffffu;

// Shared-memory plan of a BM x BN tile (BM = 128 * WM).
template <int BN, int WM>
struct Layout {
  static constexpr int BM = 128 * WM;
  static constexpr int A_STAGE = BM * BK * 2;  // bytes
  static constexpr int B_STAGE = BN * BK * 2;
  static constexpr int STAGES_FIT = 200 * 1024 / (A_STAGE + B_STAGE);
  static constexpr int STAGES = STAGES_FIT > 8 ? 8 : STAGES_FIT;
  static constexpr int A_OFF = 0;
  static constexpr int B_OFF = A_OFF + STAGES * A_STAGE;
  static constexpr int BAR_OFF = B_OFF + STAGES * B_STAGE;
  // + 1024 for aligning the dynamic shared memory base to the swizzle atom.
  static constexpr int SMEM = BAR_OFF + 2 * STAGES * 8 + 1024;
  static_assert(STAGES >= 3, "the ring is too shallow");
  static_assert(A_STAGE % 1024 == 0 && B_STAGE % 1024 == 0,
                "swizzled tiles must stay 1024-byte aligned");
};

// One warpgroup's WM x (64 x BN) products over a stage: 4 wgmmas of 16 deep
// per 64-row slab; +32 bytes (2 descriptor units) per 16-deep step.
template <int BN, int WM>
__device__ __forceinline__ void mma_stage(float (&acc)[WM][BN / 2],
                                          uint64_t da, uint64_t db,
                                          bool first) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const int scale_d = (first && kk == 0) ? 0 : 1;
#pragma unroll
    for (int i = 0; i < WM; ++i) {
      // Slab i starts 64 rows (8 KB, 512 descriptor units) further on.
      const uint64_t a = da + i * 512 + 2 * kk;
      if constexpr (BN == 64)
        sm90::wgmma_ss_m64n64<0>(acc[i], a, db + 2 * kk, scale_d);
      else if constexpr (BN == 128)
        sm90::wgmma_ss_m64n128<0>(acc[i], a, db + 2 * kk, scale_d);
      else
        sm90::wgmma_ss_m64n256<0>(acc[i], a, db + 2 * kk, scale_d);
    }
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Epilogue policy of K-A: round the f32 sums to bf16 and store y.
struct StoreY {
  // acc: one 64 x BN slab in accumulator layout; mrow: the y rows of this
  // lane's two rows of it (16w + g and 16w + g + 8), -1 where not stored;
  // n0: the slab's first column.
  template <int BN>
  __device__ static void run(const float (&acc)[BN / 2], bf16* y,
                             const int (&mrow)[2], int n0, int CO, int lane) {
    const int t = lane & 3;
    const bool b0 = t & 1, b1 = t & 2;
#pragma unroll
    for (int half = 0; half < 2; ++half) {  // rows g and g + 8
      const int m = mrow[half];
#pragma unroll
      for (int jq = 0; jq < BN / 32; ++jq) {  // four n-tiles at a time
        uint32_t v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          v[j] = pack_bf16(acc[4 * (4 * jq + j) + 2 * half],
                           acc[4 * (4 * jq + j) + 2 * half + 1]);
        // Lane t holds columns 2t, 2t+1 of n-tiles 4jq..4jq+3; after two
        // butterfly exchanges it holds all 8 columns of n-tile 4jq + t.
        const uint32_t r0 = __shfl_xor_sync(FULL, b1 ? v[0] : v[2], 2);
        const uint32_t r1 = __shfl_xor_sync(FULL, b1 ? v[1] : v[3], 2);
        const uint32_t a = b1 ? v[2] : v[0], b = b1 ? v[3] : v[1];
        const uint32_t q0 = __shfl_xor_sync(FULL, b0 ? a : b, 1);
        const uint32_t q1 = __shfl_xor_sync(FULL, b0 ? r0 : r1, 1);
        const uint32_t own = b0 ? b : a;     // from lane t
        const uint32_t own2 = b0 ? r1 : r0;  // from lane t ^ 2
        uint32_t u[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {  // columns 2k, 2k+1 come from lane k
          const int d = k ^ t;           // = lane t ^ d
          u[k] = d == 0 ? own : d == 1 ? q0 : d == 2 ? own2 : q1;
        }
        if (m >= 0)
          *reinterpret_cast<uint4*>(y + (size_t)m * CO + n0 + 8 * (4 * jq + t)) =
              make_uint4(u[0], u[1], u[2], u[3]);
      }
    }
  }
};

// The tile grid: output tiles of one box each, tw x th x tn boxes over
// (W, H, N), times CO / BN column tiles.
struct Boxes {
  int wb, hb, nb;  // box extent in pixels along W, H and images
  int tw, th;      // boxes along W and H
};

// y row of row r of the tile whose box starts at (w0, h0, n0); -1 when r
// is past the box or its pixel past the image.
__device__ __forceinline__ int tile_row(int r, const Boxes& bx, int w0,
                                        int h0, int n0, int N, int H, int W) {
  const int wl = r % bx.wb, rest = r / bx.wb;
  const int hl = rest % bx.hb, nl = rest / bx.hb;
  const int w = w0 + wl, h = h0 + hl, n = n0 + nl;
  if (nl >= bx.nb || w >= W || h >= H || n >= N) return -1;
  return (n * H + h) * W + w;
}

template <int BN, int WM, typename Epilogue>
__global__ void __launch_bounds__(THREADS, 1)
conv3x3_wgmma_kernel(const __grid_constant__ CUtensorMap x_map,
                     const __grid_constant__ CUtensorMap w_map,
                     bf16* __restrict__ y, int N, int H, int W, int C, int CO,
                     Boxes bx, int m_tiles) {
  using L = Layout<BN, WM>;
  constexpr int BM = L::BM, STAGES = L::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* As = smem + L::A_OFF;
  unsigned char* Bs = smem + L::B_OFF;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* empty = full + STAGES;

  const int n_tiles = CO / BN;
  const int tiles = m_tiles * n_tiles;
  const int c_tiles = C / BK;
  const int k_tiles = 9 * c_tiles;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 8);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread loads A (an image box) and B by TMA ----
    // Its warpgroup gives up registers to the consumers: 128 x (168 - 40)
    // = 256 x (232 - 168), so 64 x 256 f32 accumulators a consumer fit.
    sm90::regs_dealloc<40>();
    if (threadIdx.x != 0) return;
    const uint32_t bytes = bx.wb * bx.hb * bx.nb * BK * 2 + L::B_STAGE;
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int mt = tile / n_tiles;
      const int n0 = (tile % n_tiles) * BN;
      const int w0 = (mt % bx.tw) * bx.wb;
      const int h0 = (mt / bx.tw % bx.th) * bx.hb;
      const int i0 = mt / (bx.tw * bx.th) * bx.nb;
      int tap = 0, c0 = 0;
      for (int kt = 0; kt < k_tiles; ++kt, ++it) {
        const int s = it % STAGES;
        sm90::mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(&full[s], bytes);
        sm90::tma_load_4d(As + s * L::A_STAGE, &x_map, &full[s], c0,
                          w0 + tap % 3 - 1, h0 + tap / 3 - 1, i0);
        sm90::tma_load_2d(Bs + s * L::B_STAGE, &w_map, &full[s], kt * BK,
                          n0);
        c0 += BK;
        if (c0 == C) {
          c0 = 0;
          ++tap;
        }
      }
    }
  } else {
    // ---- consumers: wgmma over the ring, then the epilogue ----
    sm90::regs_alloc<232>();
    const int cw = wg - 1;  // this warpgroup's WM slabs: rows cw * BM / 2 ..
    const int lane = threadIdx.x % 32;
    const int warp = (threadIdx.x % 128) / 32;
    float acc[WM][BN / 2];
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      int prev = -1;
      for (int kt = 0; kt < k_tiles; ++kt, ++it) {
        const int s = it % STAGES;
        sm90::mbar_wait(&full[s], (it / STAGES) & 1);
        const uint64_t da =
            sm90::desc_sw128(As + s * L::A_STAGE + cw * (BM / 2) * 128);
        const uint64_t db = sm90::desc_sw128(Bs + s * L::B_STAGE);
#pragma unroll
        for (int i = 0; i < WM; ++i) sm90::fence_regs(acc[i]);
        sm90::wgmma_fence();
        mma_stage<BN, WM>(acc, da, db, kt == 0);
        sm90::wgmma_commit();
        sm90::wgmma_wait<1>();  // the previous stage's products are done
        if (prev >= 0 && lane == 0) sm90::mbar_arrive(&empty[prev]);
        prev = s;
      }
      sm90::wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < WM; ++i) sm90::fence_regs(acc[i]);
      if (lane == 0) sm90::mbar_arrive(&empty[prev]);

      const int mt = tile / n_tiles;
      const int n0 = (tile % n_tiles) * BN;
      const int w0 = (mt % bx.tw) * bx.wb;
      const int h0 = (mt / bx.tw % bx.th) * bx.hb;
      const int i0 = mt / (bx.tw * bx.th) * bx.nb;
#pragma unroll
      for (int i = 0; i < WM; ++i) {
        const int r = cw * (BM / 2) + i * 64 + warp * 16 + lane / 4;
        const int mrow[2] = {tile_row(r, bx, w0, h0, i0, N, H, W),
                             tile_row(r + 8, bx, w0, h0, i0, N, H, W)};
        Epilogue::template run<BN>(acc[i], y, mrow, n0, CO, lane);
      }
    }
  }
}

template <int BN, int WM, typename Epilogue>
inline int launch_tile(const CUtensorMap& x_map, const CUtensorMap& w_map,
                       bf16* y, int N, int H, int W, int C, int CO,
                       const Boxes& bx, int m_tiles, int grid,
                       cudaStream_t stream) {
  auto kernel = conv3x3_wgmma_kernel<BN, WM, Epilogue>;
  constexpr int smem = Layout<BN, WM>::SMEM;
  cudaError_t e = sm90::allow_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, THREADS, smem, stream>>>(x_map, w_map, y, N, H, W, C, CO,
                                          bx, m_tiles);
  return static_cast<int>(cudaGetLastError());
}

// Launches the kernel on `stream`: BM x BN output tiles, A of each from a
// box of wb x hb pixels of nb images (wb * hb * nb <= BM), on `grid`
// persistent blocks. x [N,H,W,C] and y [N,H,W,CO] NHWC bf16, w_k the
// K-major [CO, 3, 3, C] bf16 weights; C % 64 == 0, CO % BN == 0, (BM, BN)
// one of (128, 64), (256, 64), (128, 128), (256, 128), (128, 256).
// Returns a cudaError_t (0 on success).
template <typename Epilogue>
inline int launch(const void* x, const void* w_k, void* y, int N, int H,
                  int W, int C, int CO, int bm, int bn, int wb, int hb,
                  int nb, int grid, cudaStream_t stream) {
  if (C % BK != 0 || bn <= 0 || CO % bn != 0 || grid <= 0 || wb <= 0 ||
      hb <= 0 || nb <= 0 || wb * hb * nb > bm || wb > 256 || hb > 256 ||
      nb > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap x_map, w_map;
  const uint64_t x_dims[4] = {(uint64_t)C, (uint64_t)W, (uint64_t)H,
                              (uint64_t)N};
  const uint64_t x_strides[3] = {(uint64_t)C * 2, (uint64_t)W * C * 2,
                                 (uint64_t)H * W * C * 2};
  const uint32_t x_box[4] = {BK, (uint32_t)wb, (uint32_t)hb, (uint32_t)nb};
  int err = sm90::encode_bf16_sw128(&x_map, x, 4, x_dims, x_strides, x_box);
  if (err != 0) return err;
  const uint64_t w_dims[2] = {(uint64_t)9 * C, (uint64_t)CO};
  const uint64_t w_strides[1] = {(uint64_t)9 * C * 2};
  const uint32_t w_box[2] = {BK, (uint32_t)bn};
  err = sm90::encode_bf16_sw128(&w_map, w_k, 2, w_dims, w_strides, w_box);
  if (err != 0) return err;
  Boxes bx{wb, hb, nb, (W + wb - 1) / wb, (H + hb - 1) / hb};
  const int m_tiles = bx.tw * bx.th * ((N + nb - 1) / nb);
  auto* yb = static_cast<bf16*>(y);
  if (bm == 128 && bn == 64)
    return launch_tile<64, 1, Epilogue>(x_map, w_map, yb, N, H, W, C, CO, bx,
                                        m_tiles, grid, stream);
  if (bm == 256 && bn == 64)
    return launch_tile<64, 2, Epilogue>(x_map, w_map, yb, N, H, W, C, CO, bx,
                                        m_tiles, grid, stream);
  if (bm == 128 && bn == 128)
    return launch_tile<128, 1, Epilogue>(x_map, w_map, yb, N, H, W, C, CO,
                                         bx, m_tiles, grid, stream);
  if (bm == 256 && bn == 128)
    return launch_tile<128, 2, Epilogue>(x_map, w_map, yb, N, H, W, C, CO,
                                         bx, m_tiles, grid, stream);
  if (bm == 128 && bn == 256)
    return launch_tile<256, 1, Epilogue>(x_map, w_map, yb, N, H, W, C, CO,
                                         bx, m_tiles, grid, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace kfconv90
