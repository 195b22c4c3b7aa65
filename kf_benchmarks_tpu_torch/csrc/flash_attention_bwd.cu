// The two backward kernels of flash attention, bf16 in and out, f32 sums:
//
//   flash_attention_bwd_dkv  dK, dV    replaces `_flash_attention_bwd_dkv`
//   flash_attention_bwd_dq   dQ        replaces `_flash_attention_bwd_dq`
//
// of JAX's library flash attention (jax/experimental/pallas/ops/tpu/
// flash_attention.py, the VJP of the call in parallel/sequence.py
// `pallas_flash_attention`). Both recompute the probabilities from the
// forward's row log-sum-exp, P = exp(scale * Q K^T - lse), and take
// di = rowsum(o * dO) (f32, one plain op before the kernels, as the library
// computes it in XLA outside its kernels):
//
//   dV = P^T dO                 (P rounded to bf16, as the library does)
//   dS = scale * P o (dO V^T - di)
//   dK = dS^T Q,  dQ = dS K     (dS rounded to bf16, as the library does)
//
// The TPU kernels carry these sums in VMEM scratch across their sequential
// grid; here each block owns its output rows and loops over the other axis
// itself, so neither kernel needs atomics and the gradients are the same
// from run to run. The library's `ds` output is the gradient of an
// attention bias this repository never passes, and is not computed.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense) at the LM's shape (B 8,
// H 8, L 2048, D 64, causal): the backward's work is five products over the
// L(L+1)/2 admissible pairs, 2.5 x the forward's, 86 GFLOP = 0.087 ms
// (operations); these two kernels do seven (each recomputes S and dP):
// dK/dV four, 0.070 ms, and dQ three, 0.052 ms.
//
// Design (flash_attention.cuh's shape, on sm90.cuh's building blocks): a
// producer warpgroup whose warp 0 loads by TMA into a ring of 3 stages,
// and two or three consumer warpgroups on `wgmma`, each owning 64 output
// rows; the producer hands its registers to the consumers (`setmaxnreg`).
//   * dK/dV: one block per (128 keys at D = 64, 64 at D = 128; b * h),
//     key tile 0 first (under `causal` it reaches the most q tiles). K and
//     V are loaded once; the ring carries, per 64-row q tile from the
//     first that reaches the block's keys, the Q and dO tiles (TMA) and
//     the tile's -lse * log2(e), di and q segment ids (plain loads by the
//     producer warp while the tiles' copies fly: a (B, H, Lq) f32 row is
//     16-byte aligned only when Lq % 4 == 0, so no bulk copy).
//     A consumer computes S^T = K Q^T and dP^T = V dO^T (ss, all four
//     operands K-major as stored), P^T = 2^(S^T scale log2(e) - lse
//     log2(e)) selected to exactly 0 on inadmissible pairs (only on tiles
//     that may hold one), dS^T = P^T o (dP^T - di) scale, rounds both to
//     bf16 A fragments in registers and adds dV += P^T dO and dK += dS^T Q
//     (rs, dO and Q MN-major as stored). At D = 64 the products are
//     software-pipelined: S^T, dP^T of q tile i go to the tensor cores
//     with dV, dK of tile i - 1, whose fragments stay live meanwhile. At
//     D = 128 the two warpgroups share 64 keys, take one column half of dK
//     and dV each and run unpipelined (DkvLayout says why). A warpgroup
//     whose keys no q tile reaches writes zeros.
//   * dQ: the forward's structure. One block per (192 q rows at D = 64,
//     128 at D = 128; b * h), the longest q tiles first (the grid's slow
//     axis counts down); Q and dO loaded once, lse and di per row in
//     registers; the ring carries K, V and the key tile's segment ids.
//     S = Q K^T and dP = dO V^T (ss), dS in registers, dQ += dS K (rs, K
//     MN-major), pipelined as the forward is.

#include "flash_attention.cuh"

namespace kfattn {

// Ring stages of both kernels: with each stage's copies started before its
// small vectors are loaded, more stages gained nothing at the LM's shape
// on an H100, and two left the consumers waiting.
constexpr int STAGES = 3;
constexpr int CW = 2;                  // consumer warpgroups a dK/dV block
constexpr int THREADS = 128 * (CW + 1);
// Registers a consumer thread takes from the producer warpgroup, which
// keeps 32: 128 x (168 - 32) >= 256 x (232 - 168).
constexpr int CONSUMER_REGS = 232;

// A dK/dV consumer warpgroup accumulates 64 keys x 64 columns of dK and of
// dV (64 f32 registers a thread): at D = 64 the two warpgroups take 64 keys
// each; at D = 128 both take the block's 64 keys, one column half each,
// and each computes the full-depth S^T and dP^T itself (1.5 x the
// products), unpipelined: with m64n128 dK and dV accumulators ptxas spills
// past the 232 registers a consumer thread has even unpipelined, and with
// column halves it still spills pipelined.
template <int D>
struct DkvLayout {
  static constexpr bool PIPE = D == 64;
  static constexpr int DH = D / 64;     // 64-wide column blocks of a row
  static constexpr int KG = CW / DH;    // 64-key groups a block
  static constexpr int KEYS = 64 * KG;  // keys a block
  static constexpr int K_OFF = 0;       // [KG][DH][64][64]
  static constexpr int V_OFF = K_OFF + KG * DH * SUB;
  static constexpr int Q_OFF = V_OFF + KG * DH * SUB;  // [STAGES][DH][64][64]
  static constexpr int O_OFF = Q_OFF + STAGES * DH * SUB;  // dO, the same
  // [STAGES][3][64]: -lse * log2(e), di (f32) and q segment ids (int32).
  static constexpr int VEC_OFF = O_OFF + STAGES * DH * SUB;
  static constexpr int BAR_OFF = VEC_OFF + STAGES * 3 * TILE * 4;
  // full[STAGES], empty[STAGES], K and V's barrier; + 1024 to align the
  // base to the swizzle atom.
  static constexpr int SMEM = BAR_OFF + (2 * STAGES + 1) * 8 + 1024;
};

// dQ: three consumer warpgroups at D = 64, as the forward (192 q rows a
// block, faster than two at the LM's shape on an H100), two at D = 128.
template <int D>
struct DqLayout {
  static constexpr int CW = D == 64 ? 3 : 2;
  static constexpr int ROWS = TILE * CW;  // q rows a block
  static constexpr int THREADS = 128 * (CW + 1);
  // 128 x (128 - 32) = 384 x (160 - 128) with three consumer warpgroups.
  static constexpr int CONSUMER_REGS = CW == 3 ? 160 : 232;
  static constexpr int DH = D / 64;
  static constexpr int Q_OFF = 0;  // [CW][DH][64][64]
  static constexpr int O_OFF = Q_OFF + CW * DH * SUB;  // dO, the same
  static constexpr int K_OFF = O_OFF + CW * DH * SUB;  // [STAGES][DH][64][64]
  static constexpr int V_OFF = K_OFF + STAGES * DH * SUB;
  static constexpr int SEG_OFF = V_OFF + STAGES * DH * SUB;  // [STAGES][64]
  static constexpr int BAR_OFF = SEG_OFF + STAGES * TILE * 4;
  static constexpr int SMEM = BAR_OFF + (2 * STAGES + 1) * 8 + 1024;
};

// A consumer warpgroup's loop over ring tiles [first, last): scores(j)
// starts the two ss products of tile j (S and dP, or their transposes),
// math(j) turns them into the score-shaped A operands in place, pack()
// rounds those to bf16 fragments, accum(j) starts the rs products that
// add them into the output accumulators. fence_scores / fence_acc /
// fence_frags pin the registers of the three groups around each wgmma
// launch and wait. With PIPE, a software pipeline: tile j's scores go to
// the tensor cores together with tile j - 1's accumulation (groups
// complete in order, so waiting for all but the newest waits for the
// scores), and math(j) runs while the accumulation does; the fragments of
// tile j - 1 stay live meanwhile. A tile is released once its
// accumulation is done.
template <bool PIPE, class Scores, class Math, class Pack, class Accum,
          class FenceScores, class FenceAcc, class FenceFrags>
__device__ __forceinline__ void run_tiles(uint64_t* full, uint64_t* empty,
                                          int first, int last,
                                          Scores scores, Math math, Pack pack,
                                          Accum accum,
                                          FenceScores fence_scores,
                                          FenceAcc fence_acc,
                                          FenceFrags fence_frags) {
  if (first >= last) return;
  auto accumulate = [&](int j) {
    fence_acc();
    sm90::wgmma_fence();
    accum(j);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    fence_frags();
    fence_acc();
    ring_release<STAGES>(empty, j);
  };
  ring_wait<STAGES>(full, first);
  fence_scores();
  sm90::wgmma_fence();
  scores(first);
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  fence_scores();
  math(first);
  pack();
  if constexpr (!PIPE) accumulate(first);
  for (int j = first + 1; j < last; ++j) {
    ring_wait<STAGES>(full, j);
    fence_scores();
    fence_acc();
    sm90::wgmma_fence();
    scores(j);
    sm90::wgmma_commit();
    if constexpr (PIPE) {
      accum(j - 1);
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();  // the scores are done; accum(j - 1) runs on
      fence_scores();
      math(j);
      sm90::wgmma_wait<0>();
      // The fragments and accumulators were operands of the product just
      // waited for: keep the compiler from reusing or touching their
      // registers before here.
      fence_frags();
      fence_acc();
      ring_release<STAGES>(empty, j - 1);
      pack();
    } else {
      sm90::wgmma_wait<0>();
      fence_scores();
      math(j);
      pack();
      accumulate(j);
    }
  }
  if constexpr (PIPE) accumulate(last - 1);
}

// -- dK, dV ----------------------------------------------------------------------

// One consumer warpgroup: its 64 keys and 64 columns of dK and dV (see
// DkvLayout), over the block's q tiles i0 .. n_q - 1.
template <int D>
__device__ __forceinline__ void dkv_consume(
    unsigned char* smem, const int* __restrict__ kv_seg,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int Lk, float scale,
    int causal, bool seg, int b, int h, int k0, int i0, int n_q) {
  using L = DkvLayout<D>;
  const float* vec = reinterpret_cast<const float*>(smem + L::VEC_OFF);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* empty = full + STAGES;
  uint64_t* kvbar = empty + STAGES;
  const int cw = threadIdx.x / 128 - 1;
  const int lane = threadIdx.x % 32;
  const int warp = (threadIdx.x % 128) / 32;
  const int t = lane % 4;
  const int kc0 = k0 + (cw / L::DH) * 64;  // this warpgroup's first key
  const int cb = cw % L::DH;                // its 64-column block
  // The first q tile these keys reach: under `causal`, the one holding row
  // kc0 (q tile i covers rows 64i..64i+63). Keys at or past Lk reach none.
  const int first =
      kc0 >= Lk ? n_q : causal ? min(kc0 / TILE, n_q) : i0;
  const int krow[2] = {kc0 + warp * 16 + lane / 4,
                       kc0 + warp * 16 + lane / 4 + 8};
  int sk[2] = {0, 0};
  if (seg) {
#pragma unroll
    for (int ri = 0; ri < 2; ++ri)
      if (krow[ri] < Lk) sk[ri] = kv_seg[(long long)b * Lk + krow[ri]];
  }
  const float scale_log2 = scale * LOG2E;
  const unsigned char* sK = smem + L::K_OFF + (cw / L::DH) * L::DH * SUB;
  const unsigned char* sV = smem + L::V_OFF + (cw / L::DH) * L::DH * SUB;
  // Ring tile j holds q tile i0 + j.
  auto sQ = [&](int j) { return smem + L::Q_OFF + (j % STAGES) * L::DH * SUB; };
  auto sO = [&](int j) { return smem + L::O_OFF + (j % STAGES) * L::DH * SUB; };

  float dk_acc[32], dv_acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  float st[32], dpt[32];         // S^T then P^T; dP^T then dS^T
  uint32_t pa[4][4], da[4][4];   // P^T and dS^T as bf16 A fragments

  auto scores = [&](int j) {
    start_abt<D>(st, sK, sQ(j));
    start_abt<D>(dpt, sV, sO(j));
  };
  auto math = [&](int j) {
    const int q0 = (i0 + j) * TILE;
    const float* nl = vec + (j % STAGES) * 3 * TILE;  // -lse * log2(e)
    const float* dis = nl + TILE;                     // di
    const int* qs = reinterpret_cast<const int*>(nl + 2 * TILE);
    if (tile_needs_mask(q0, kc0, Lk, causal, seg)) {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int ri = acc_half(e);
        const int cl = acc_col(e, t);
        const bool ok = krow[ri] < Lk && (!causal || krow[ri] <= q0 + cl) &&
                        (!seg || qs[cl] == sk[ri]);
        // A select, never a branch; a masked pair's exponent may overflow
        // to inf before it is dropped, but never reaches dS.
        const float p = ok ? ex2(fmaf(st[e], scale_log2, nl[cl])) : 0.f;
        st[e] = p;
        dpt[e] = (dpt[e] - dis[cl]) * p * scale;
      }
    } else {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int cl = acc_col(e, t);
        const float p = ex2(fmaf(st[e], scale_log2, nl[cl]));
        st[e] = p;
        dpt[e] = (dpt[e] - dis[cl]) * p * scale;
      }
    }
  };
  auto pack = [&]() {
    pack_frags(pa, st);
    pack_frags(da, dpt);
  };
  auto accum = [&](int j) {
    start_ab<64>(dv_acc, pa, sO(j) + cb * SUB);
    start_ab<64>(dk_acc, da, sQ(j) + cb * SUB);
  };
  auto fence_scores = [&]() {
    sm90::fence_regs(st);
    sm90::fence_regs(dpt);
  };
  auto fence_acc = [&]() {
    sm90::fence_regs(dk_acc);
    sm90::fence_regs(dv_acc);
  };
  auto fence_frags = [&]() {
    sm90::fence_regs_u32(pa);
    sm90::fence_regs_u32(da);
  };

  sm90::mbar_wait(kvbar, 0);
  // q tiles before this warpgroup's diagonal were loaded for the block's
  // other keys: released unread.
  for (int j = 0; j < first - i0; ++j) {
    ring_wait<STAGES>(full, j);
    ring_release<STAGES>(empty, j);
  }
  run_tiles<L::PIPE>(full, empty, first - i0, n_q - i0, scores, math, pack,
                     accum, fence_scores, fence_acc, fence_frags);
  const float one[2] = {1.f, 1.f};
  store_rows<D, 64>(dk, dk_acc, krow, one, Lk, H, b, h, t, cb * 64);
  store_rows<D, 64>(dv, dv_acc, krow, one, Lk, H, b, h, t, cb * 64);
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map,
                     const __grid_constant__ CUtensorMap do_map,
                     const int* __restrict__ q_seg,
                     const int* __restrict__ kv_seg,
                     const float* __restrict__ lse,
                     const float* __restrict__ di, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int H, int Lq, int Lk,
                     float scale, int causal) {
  using L = DkvLayout<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  float* vec = reinterpret_cast<float*>(smem + L::VEC_OFF);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* empty = full + STAGES;
  uint64_t* kvbar = empty + STAGES;

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int k0 = blockIdx.y * L::KEYS;  // key tile 0 first: the longest
  const int n_q = (Lq + TILE - 1) / TILE;
  // The block's first q tile: under `causal`, the one holding row k0.
  const int i0 = causal ? min(k0 / TILE, n_q) : 0;
  const bool seg = q_seg != nullptr;
  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&full[s], 32);
      sm90::mbar_init(&empty[s], 4 * CW);
    }
    sm90::mbar_init(kvbar, 1);
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    sm90::regs_dealloc<32>();
    if (threadIdx.x >= 32) return;
    // K and V are loaded even when no q tile reaches them: the consumers
    // wait for them, so no copy is in flight when the block ends.
    if (lane == 0) {
      sm90::mbar_arrive_expect_tx(kvbar, 2 * L::KG * L::DH * SUB);
      load_rows<L::DH>(smem + L::K_OFF, &k_map, kvbar, L::KG, h, k0, b);
      load_rows<L::DH>(smem + L::V_OFF, &v_map, kvbar, L::KG, h, k0, b);
    }
    const long long bh = ((long long)b * H + h) * Lq;
    for (int i = i0; i < n_q; ++i) {
      const int q0 = i * TILE;
      produce_stage<L::DH, STAGES>(
          smem + L::Q_OFF, smem + L::O_OFF, full, empty, &q_map, &do_map,
          i - i0, h, q0, b, [&](int s) {
            float* nl = vec + s * 3 * TILE;
            int* qs = reinterpret_cast<int*>(nl + 2 * TILE);
            for (int r = lane; r < TILE; r += 32) {
              // Rows past Lq: lse = +inf, so P = 2^-inf = 0 there.
              const bool in = q0 + r < Lq;
              nl[r] = in ? -lse[bh + q0 + r] * LOG2E : -INFINITY;
              nl[TILE + r] = in ? di[bh + q0 + r] : 0.f;
              if (seg) qs[r] = in ? q_seg[(long long)b * Lq + q0 + r] : 0;
            }
          });
    }
  } else {
    sm90::regs_alloc<CONSUMER_REGS>();
    dkv_consume<D>(smem, kv_seg, dk, dv, H, Lk, scale, causal, seg, b, h,
                   k0, i0, n_q);
  }
}

// -- dQ --------------------------------------------------------------------------

// One consumer warpgroup: the 64 q rows q0 + 64 * (warpgroup - 1), over
// the key tiles they reach of the block's n_kv, then dQ.
template <int D>
__device__ __forceinline__ void dq_consume(
    unsigned char* smem, const int* __restrict__ q_seg,
    const float* __restrict__ lse, const float* __restrict__ di,
    bf16* __restrict__ dq, int H, int Lq, int Lk, float scale, int causal,
    bool seg, int b, int h, int q0, int n_kv) {
  using L = DqLayout<D>;
  const int* sseg = reinterpret_cast<const int*>(smem + L::SEG_OFF);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* empty = full + STAGES;
  uint64_t* qbar = empty + STAGES;
  const int cw = threadIdx.x / 128 - 1;
  const int lane = threadIdx.x % 32;
  const int warp = (threadIdx.x % 128) / 32;
  const int t = lane % 4;
  const int q0w = q0 + cw * 64;  // this warpgroup's first row
  const int n_mine = q0w < Lq ? kv_tiles(q0w, 64, Lk, causal) : 0;
  const int row[2] = {q0w + warp * 16 + lane / 4,
                      q0w + warp * 16 + lane / 4 + 8};
  int sq[2] = {0, 0};
  float nl[2], dr[2];  // -lse * log2(e) and di of the two rows
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    const bool in = row[ri] < Lq;
    const long long at = ((long long)b * H + h) * Lq + row[ri];
    nl[ri] = in ? -lse[at] * LOG2E : -INFINITY;
    dr[ri] = in ? di[at] : 0.f;
    if (seg && in) sq[ri] = q_seg[(long long)b * Lq + row[ri]];
  }
  const float scale_log2 = scale * LOG2E;
  const unsigned char* sQ = smem + L::Q_OFF + cw * L::DH * SUB;
  const unsigned char* sO = smem + L::O_OFF + cw * L::DH * SUB;
  auto sK = [&](int j) { return smem + L::K_OFF + (j % STAGES) * L::DH * SUB; };
  auto sV = [&](int j) { return smem + L::V_OFF + (j % STAGES) * L::DH * SUB; };

  float dq_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq_acc[i] = 0.f;
  float s[32], dp[32];   // S; dP then dS
  uint32_t da[4][4];     // dS as bf16 A fragments

  auto scores = [&](int j) {
    start_abt<D>(s, sQ, sK(j));
    start_abt<D>(dp, sO, sV(j));
  };
  auto math = [&](int j) {
    const int k0 = j * TILE;
    if (tile_needs_mask(q0w, k0, Lk, causal, seg)) {
      const int* ks = sseg + (j % STAGES) * TILE;
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int ri = acc_half(e);
        const int cl = acc_col(e, t);
        const int col = k0 + cl;
        const bool ok = col < Lk && (!causal || col <= row[ri]) &&
                        (!seg || ks[cl] == sq[ri]);
        const float p = ok ? ex2(fmaf(s[e], scale_log2, nl[ri])) : 0.f;
        dp[e] = (dp[e] - dr[ri]) * p * scale;
      }
    } else {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int ri = acc_half(e);
        const float p = ex2(fmaf(s[e], scale_log2, nl[ri]));
        dp[e] = (dp[e] - dr[ri]) * p * scale;
      }
    }
  };
  auto pack = [&]() { pack_frags(da, dp); };
  auto accum = [&](int j) { start_ab<D>(dq_acc, da, sK(j)); };
  auto fence_scores = [&]() {
    sm90::fence_regs(s);
    sm90::fence_regs(dp);
  };
  auto fence_acc = [&]() { sm90::fence_regs(dq_acc); };
  auto fence_frags = [&]() { sm90::fence_regs_u32(da); };

  sm90::mbar_wait(qbar, 0);
  run_tiles<true>(full, empty, 0, n_mine, scores, math, pack, accum,
                  fence_scores, fence_acc, fence_frags);
  // Key tiles past this warpgroup's diagonal were loaded for the block's
  // later rows: released unread.
  for (int j = n_mine; j < n_kv; ++j) {
    ring_wait<STAGES>(full, j);
    ring_release<STAGES>(empty, j);
  }
  const float one[2] = {1.f, 1.f};
  store_rows<D>(dq, dq_acc, row, one, Lq, H, b, h, t);
}

template <int D>
__global__ void __launch_bounds__(DqLayout<D>::THREADS, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap q_map,
                    const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map,
                    const __grid_constant__ CUtensorMap do_map,
                    const int* __restrict__ q_seg,
                    const int* __restrict__ kv_seg,
                    const float* __restrict__ lse,
                    const float* __restrict__ di, bf16* __restrict__ dq,
                    int H, int Lq, int Lk, float scale, int causal) {
  using L = DqLayout<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  int* sseg = reinterpret_cast<int*>(smem + L::SEG_OFF);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* empty = full + STAGES;
  uint64_t* qbar = empty + STAGES;

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * L::ROWS;  // longest tiles first
  const int n_kv = kv_tiles(q0, L::ROWS, Lk, causal);
  const bool seg = q_seg != nullptr;
  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&full[s], 32);
      sm90::mbar_init(&empty[s], 4 * L::CW);
    }
    sm90::mbar_init(qbar, 1);
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    sm90::regs_dealloc<32>();
    if (threadIdx.x >= 32) return;
    if (lane == 0) {
      sm90::mbar_arrive_expect_tx(qbar, 2 * L::CW * L::DH * SUB);
      load_rows<L::DH>(smem + L::Q_OFF, &q_map, qbar, L::CW, h, q0, b);
      load_rows<L::DH>(smem + L::O_OFF, &do_map, qbar, L::CW, h, q0, b);
    }
    for (int j = 0; j < n_kv; ++j) {
      const int k0 = j * TILE;
      produce_stage<L::DH, STAGES>(
          smem + L::K_OFF, smem + L::V_OFF, full, empty, &k_map, &v_map, j,
          h, k0, b, [&](int s) {
            if (seg) {
              for (int c = lane; c < TILE; c += 32)
                sseg[s * TILE + c] =
                    k0 + c < Lk ? kv_seg[(long long)b * Lk + k0 + c] : 0;
            }
          });
    }
  } else {
    sm90::regs_alloc<L::CONSUMER_REGS>();
    dq_consume<D>(smem, q_seg, lse, di, dq, H, Lq, Lk, scale, causal, seg,
                  b, h, q0, n_kv);
  }
}

// -- host ------------------------------------------------------------------------

struct BwdArgs {
  const void *q, *k, *v, *q_seg, *kv_seg, *dout, *lse, *di;
  int B, H, Lq, Lk;
  Strides st;
  float scale;
  int causal;
  cudaStream_t stream;
};

// Tensor maps over q, k, v (strided views) and dO (contiguous).
template <int D>
int bwd_maps(const BwdArgs& a, CUtensorMap* qm, CUtensorMap* km,
             CUtensorMap* vm, CUtensorMap* om) {
  int err = qkv_map<D>(qm, a.q, a.B, a.Lq, a.H, a.st.q_b, a.st.q_l);
  if (err == 0) err = qkv_map<D>(km, a.k, a.B, a.Lk, a.H, a.st.k_b, a.st.k_l);
  if (err == 0) err = qkv_map<D>(vm, a.v, a.B, a.Lk, a.H, a.st.v_b, a.st.v_l);
  if (err == 0)
    err = qkv_map<D>(om, a.dout, a.B, a.Lq, a.H, (long long)a.Lq * a.H * D,
                     (long long)a.H * D);
  return err;
}

template <int D>
int launch_dkv(const BwdArgs& a, void* dk, void* dv) {
  CUtensorMap qm, km, vm, om;
  int err = bwd_maps<D>(a, &qm, &km, &vm, &om);
  if (err != 0) return err;
  using L = DkvLayout<D>;
  cudaError_t e = sm90::allow_smem(flash_bwd_dkv_kernel<D>, L::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(a.B * a.H, (a.Lk + L::KEYS - 1) / L::KEYS);
  flash_bwd_dkv_kernel<D><<<grid, THREADS, L::SMEM, a.stream>>>(
      qm, km, vm, om, static_cast<const int*>(a.q_seg),
      static_cast<const int*>(a.kv_seg), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.di), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), a.H, a.Lq, a.Lk, a.scale, a.causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dq(const BwdArgs& a, void* dq) {
  CUtensorMap qm, km, vm, om;
  int err = bwd_maps<D>(a, &qm, &km, &vm, &om);
  if (err != 0) return err;
  using L = DqLayout<D>;
  cudaError_t e = sm90::allow_smem(flash_bwd_dq_kernel<D>, L::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(a.B * a.H, (a.Lq + L::ROWS - 1) / L::ROWS);
  flash_bwd_dq_kernel<D><<<grid, L::THREADS, L::SMEM, a.stream>>>(
      qm, km, vm, om, static_cast<const int*>(a.q_seg),
      static_cast<const int*>(a.kv_seg), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.di), static_cast<bf16*>(dq), a.H, a.Lq,
      a.Lk, a.scale, a.causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace kfattn

// Both return the cudaError_t of the launch (0 on success). dout is the
// contiguous (B, Lq, H, D) cotangent of o; lse and di are (B, H, Lq) f32.
extern "C" int flash_attention_bwd_dkv_bf16(
    const void* q, const void* k, const void* v, const void* q_seg,
    const void* kv_seg, const void* dout, const void* lse, const void* di,
    void* dk, void* dv, int B, int H, int Lq, int Lk, int D, long long q_sb,
    long long q_sl, long long k_sb, long long k_sl, long long v_sb,
    long long v_sl, float scale, int causal, void* stream) {
  const kfattn::BwdArgs a{q, k, v, q_seg, kv_seg, dout, lse, di, B, H, Lq, Lk,
                          {q_sb, q_sl, k_sb, k_sl, v_sb, v_sl}, scale, causal,
                          static_cast<cudaStream_t>(stream)};
  if (D == 64) return kfattn::launch_dkv<64>(a, dk, dv);
  if (D == 128) return kfattn::launch_dkv<128>(a, dk, dv);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int flash_attention_bwd_dq_bf16(
    const void* q, const void* k, const void* v, const void* q_seg,
    const void* kv_seg, const void* dout, const void* lse, const void* di,
    void* dq, int B, int H, int Lq, int Lk, int D, long long q_sb,
    long long q_sl, long long k_sb, long long k_sl, long long v_sb,
    long long v_sl, float scale, int causal, void* stream) {
  const kfattn::BwdArgs a{q, k, v, q_seg, kv_seg, dout, lse, di, B, H, Lq, Lk,
                          {q_sb, q_sl, k_sb, k_sl, v_sb, v_sl}, scale, causal,
                          static_cast<cudaStream_t>(stream)};
  if (D == 64) return kfattn::launch_dq<64>(a, dq);
  if (D == 128) return kfattn::launch_dq<128>(a, dq);
  return static_cast<int>(cudaErrorInvalidValue);
}
