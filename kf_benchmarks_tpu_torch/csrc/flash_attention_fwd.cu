// flash_attention_fwd: o = softmax(scale * Q K^T + mask) V and the row
// log-sum-exp lse, bf16 in and out, f32 softmax.
//
// Replaces the TPU kernel `_flash_attention_impl` of JAX's library flash
// attention (jax/experimental/pallas/ops/tpu/flash_attention.py, its
// `pl.pallas_call` of `_flash_attention_kernel`), which the JAX package
// reaches through parallel/sequence.py `pallas_flash_attention`. The TPU
// kernel walks the key blocks as the sequential last grid axis, carrying m,
// l and the output accumulator in VMEM scratch from one grid step to the
// next, and saves l and m as 128-lane tiles. Here one block owns a q tile
// of 64 rows per consumer warpgroup and loops over the key tiles itself
// (Hopper blocks run in no order), carrying m, l and the accumulator in
// registers, and saves one lse = m + log(l) per row, which carries the same
// information for the backward (flash_attention_bwd.cu reads it).
//
// Per key tile: S = Q K^T, mask to -inf, scale, online softmax (running max
// m, sum l of the f32 probabilities), P rounded to bf16 for the P V product
// as the library does (`p.astype(v.dtype)`). Under `causal` the key tiles
// wholly above the diagonal are not visited (the library's
// `below_or_on_diag`); a ragged last tile is masked. The mask contract is
// flash_attention.cuh's.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s) at the LM's shape
// B 8, H 8, L 2048, D 64, causal: 4 * B * H * D * L(L+1)/2 = 34.4 GFLOP,
// 0.035 ms, against ~67 MB of q, k, v, o and lse (0.020 ms): operations-
// bound. The design goes after the tensor cores' rate (sm90.cuh has the
// building blocks):
//   * warpgroup 0 is the producer, and CW more warpgroups (3 at D = 64, 2
//     at D = 128) are the consumers, each owning 64 rows of the 64*CW-row
//     q tile;
//   * the producer's warp 0 loads the q tile once and the K and V tiles of
//     each key step by TMA (4-D tensor maps over the (B, L, H, D) strided
//     views, so q, k and v may be views into one packed projection; rows
//     past L read as zero) into a ring of STAGES stages, 128-byte swizzled,
//     with the key tile's segment ids beside them; `full` and `empty`
//     mbarriers hand the stages over;
//   * a consumer computes S = Q K^T with m64n64k16 `wgmma`s from shared
//     memory (K is K-major as stored), runs the online softmax on the S
//     accumulators in registers, converts P to bf16 in registers -- the
//     accumulator layout is the A-from-registers fragment layout -- and
//     adds P V with m64nDk16 `wgmma`s whose B is V as stored, MN-major.
//     The two products are software-pipelined: S_j and P_{j-1} V_{j-1} go
//     to the tensor cores together and the softmax of S_j runs while the
//     second one does (on an H100 this beat the unpipelined loop by ~10% at
//     the LM's shape). The producer warpgroup hands its
//     registers to the consumers (`setmaxnreg`), which the pipeline needs
//     at three consumer warpgroups;
//   * the per-element mask runs only on tiles that need it: the causal
//     diagonal, a ragged last key tile, or segment ids; tiles wholly below
//     the diagonal only scale;
//   * the q tiles of a head are launched longest first (the grid's slow
//     axis counts down the q tiles), so under `causal` the short tiles fill
//     the last wave.

#include "flash_attention.cuh"

namespace kfattn {

// Keys a step: ops/flash_attention.py KEY_TILE, the tile the plain version
// rounds P at (128 with two consumer warpgroups measured slower on an H100).
constexpr int BKV = TILE;
constexpr int STAGES = 3;

// Consumer warpgroups a block: three at D = 64 (a 192-row q tile in 512
// threads; the kernel needs ~106 registers a thread, under the 128 that
// allows), two at D = 128 (~161 registers).
template <int D>
constexpr int consumers() {
  return D == 64 ? 3 : 2;
}

template <int D>
struct FwdLayout {
  static constexpr int CW = consumers<D>();
  static constexpr int BQ = 64 * CW;           // q rows a block
  static constexpr int THREADS = 128 * (CW + 1);
  // Registers a consumer thread takes from the producer warpgroup (which
  // keeps 32): 128 x (128 - 32) = 384 x (160 - 128) with three consumer
  // warpgroups, 128 x (168 - 32) >= 256 x (232 - 168) with two.
  static constexpr int CONSUMER_REGS = CW == 3 ? 160 : 232;
  static constexpr int DH = D / 64;  // 64-wide column blocks of a row
  static constexpr int Q_OFF = 0;    // [CW][DH][64][64]
  static constexpr int K_OFF = Q_OFF + CW * DH * SUB;  // [STAGES][DH][64][64]
  static constexpr int V_OFF = K_OFF + STAGES * DH * SUB;
  static constexpr int SEG_OFF = V_OFF + STAGES * DH * SUB;  // [STAGES][BKV]
  static constexpr int BAR_OFF = SEG_OFF + STAGES * BKV * 4;
  // full[STAGES], empty[STAGES], the q tile's barrier; + 1024 to align the
  // base to the swizzle atom.
  static constexpr int SMEM = BAR_OFF + (2 * STAGES + 1) * 8 + 1024;
};

// One consumer warpgroup: the 64 q rows q0 + 64 * (warpgroup - 1) of the
// block's tile, over the block's n_kv key tiles, then o and lse.
template <int D>
__device__ __forceinline__ void consume(unsigned char* smem,
                                        const int* __restrict__ q_seg,
                                        bf16* __restrict__ o,
                                        float* __restrict__ lse, int H,
                                        int Lq, int Lk, float scale,
                                        int causal, int b, int h, int q0,
                                        int n_kv) {
  using L = FwdLayout<D>;
  const int* sseg = reinterpret_cast<const int*>(smem + L::SEG_OFF);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* empty = full + STAGES;
  uint64_t* qbar = empty + STAGES;
  const bool seg = q_seg != nullptr;
  const int cw = threadIdx.x / 128 - 1;
  const int lane = threadIdx.x % 32;
  const int q0w = q0 + cw * 64;  // this warpgroup's first row
  const int n_mine = q0w < Lq ? kv_tiles(q0w, 64, Lk, causal) : 0;
  const int warp = (threadIdx.x % 128) / 32;
  const int t = lane % 4;
  const int row[2] = {q0w + warp * 16 + lane / 4, q0w + warp * 16 + lane / 4 + 8};
  int sq[2] = {0, 0};
  if (seg) {
#pragma unroll
    for (int ri = 0; ri < 2; ++ri)
      if (row[ri] < Lq) sq[ri] = q_seg[(long long)b * Lq + row[ri]];
  }

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max of the raw scores
  float l[2] = {0.f, 0.f};
  const float scale_log2 = scale * LOG2E;
  const unsigned char* sQ = smem + L::Q_OFF + cw * L::DH * SUB;
  auto sK = [&](int j) { return smem + L::K_OFF + (j % STAGES) * L::DH * SUB; };
  auto sV = [&](int j) { return smem + L::V_OFF + (j % STAGES) * L::DH * SUB; };

  // The online softmax of S_j in place (sc becomes P, f32), m and l
  // updated; alpha gets each row's rescale factor of the accumulator. The
  // running max is kept in unscaled scores (scale > 0 commutes with max)
  // and the scale folds into the exponent: p = 2^(s * scale * log2(e) -
  // m * scale * log2(e)), one FFMA and one ex2 per element. The mask runs
  // only where a pair may be inadmissible: the causal diagonal, a ragged
  // last key tile, or segment ids.
  auto softmax = [&](int j, float (&sc)[BKV / 2], float (&alpha)[2]) {
    const int k0 = j * BKV;
    float mx[2] = {-INFINITY, -INFINITY};
    if (tile_needs_mask(q0w, k0, Lk, causal, seg)) {
      const int* ks = sseg + (j % STAGES) * BKV;
#pragma unroll
      for (int i = 0; i < BKV / 2; ++i) {
        const int ri = acc_half(i);
        const int cl = acc_col(i, t);
        const int col = k0 + cl;
        const bool ok = col < Lk && (!causal || col <= row[ri]) &&
                        (!seg || ks[cl] == sq[ri]);
        sc[i] = ok ? sc[i] : -INFINITY;  // a select: a branch here costs
        mx[ri] = fmaxf(mx[ri], sc[i]);   // ~1.7x on masked tiles
      }
    } else {
#pragma unroll
      for (int i = 0; i < BKV / 2; ++i)
        mx[acc_half(i)] = fmaxf(mx[acc_half(i)], sc[i]);
    }
    float nb[2];  // -(exponent base) * scale * log2(e)
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      const float m_new = fmaxf(m[ri], quad_max(mx[ri]));
      nb[ri] = m_new == -INFINITY ? 0.f : -m_new * scale_log2;
      alpha[ri] = ex2(fmaf(m[ri], scale_log2, nb[ri]));  // 0 for -inf
      m[ri] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < BKV / 2; ++i) {
      sc[i] = ex2(fmaf(sc[i], scale_log2, nb[acc_half(i)]));  // 2^-inf = 0
      rs[acc_half(i)] += sc[i];
    }
#pragma unroll
    for (int ri = 0; ri < 2; ++ri)
      l[ri] = l[ri] * alpha[ri] + quad_sum(rs[ri]);
  };

  sm90::mbar_wait(qbar, 0);
  if (n_mine > 0) {
    // A software pipeline over the key tiles: the tensor cores compute
    // S_j = Q K_j^T and then P_{j-1} V_{j-1} while this warpgroup's
    // threads run the softmax of S_j (wgmma groups complete in order, so
    // waiting for all but the newest group waits for S_j).
    float sc[BKV / 2];
    uint32_t pa[BKV / 16][4];
    float alpha[2];
    ring_wait<STAGES>(full, 0);
    sm90::fence_regs(sc);
    sm90::wgmma_fence();
    start_abt<D>(sc, sQ, sK(0));
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(sc);
    softmax(0, sc, alpha);
    pack_frags(pa, sc);
    for (int j = 1; j < n_mine; ++j) {
      ring_wait<STAGES>(full, j);
      sm90::fence_regs(sc);
      sm90::fence_regs(acc);
      sm90::wgmma_fence();
      start_abt<D>(sc, sQ, sK(j));
      sm90::wgmma_commit();
      start_ab<D>(acc, pa, sV(j - 1));
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();  // S_j is done; P_{j-1} V_{j-1} may run on
      sm90::fence_regs(sc);
      softmax(j, sc, alpha);
      sm90::wgmma_wait<0>();
      // pa and acc were operands of the product just waited for: keep the
      // compiler from reusing or touching their registers before here.
      sm90::fence_regs_u32(pa);
      sm90::fence_regs(acc);
      ring_release<STAGES>(empty, j - 1);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[acc_half(i)];
      pack_frags(pa, sc);
    }
    sm90::fence_regs(acc);
    sm90::wgmma_fence();
    start_ab<D>(acc, pa, sV(n_mine - 1));
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs_u32(pa);
    sm90::fence_regs(acc);
    ring_release<STAGES>(empty, n_mine - 1);
  }
  // Key tiles past this warpgroup's diagonal were loaded for the block's
  // later rows: released unread.
  for (int j = n_mine; j < n_kv; ++j) {
    ring_wait<STAGES>(full, j);
    ring_release<STAGES>(empty, j);
  }

  const float inv[2] = {l[0] > 0.f ? 1.f / l[0] : 0.f,
                        l[1] > 0.f ? 1.f / l[1] : 0.f};
  store_rows<D>(o, acc, row, inv, Lq, H, b, h, t);
#pragma unroll
  for (int ri = 0; ri < 2; ++ri)
    if (row[ri] < Lq && t == 0)
      lse[((long long)b * H + h) * Lq + row[ri]] =
          l[ri] > 0.f ? m[ri] * scale + logf(l[ri]) : INFINITY;
}

template <int D>
__global__ void __launch_bounds__(FwdLayout<D>::THREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap q_map,
                 const __grid_constant__ CUtensorMap k_map,
                 const __grid_constant__ CUtensorMap v_map,
                 const int* __restrict__ q_seg, const int* __restrict__ kv_seg,
                 bf16* __restrict__ o, float* __restrict__ lse, int H, int Lq,
                 int Lk, float scale, int causal) {
  using L = FwdLayout<D>;
  constexpr int BQ = L::BQ;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  int* sseg = reinterpret_cast<int*>(smem + L::SEG_OFF);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* empty = full + STAGES;
  uint64_t* qbar = empty + STAGES;

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest tiles first
  const int n_kv = kv_tiles(q0, BQ, Lk, causal);
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
    // ---- producer: warp 0 loads; the other three warps have no work ----
    // The warpgroup hands most of its registers to the consumers.
    sm90::regs_dealloc<32>();
    if (threadIdx.x >= 32) return;
    if (lane == 0) {
      sm90::mbar_arrive_expect_tx(qbar, L::CW * L::DH * SUB);
      load_rows<L::DH>(smem + L::Q_OFF, &q_map, qbar, L::CW, h, q0, b);
    }
    for (int j = 0; j < n_kv; ++j) {
      const int k0 = j * BKV;
      produce_stage<L::DH, STAGES>(
          smem + L::K_OFF, smem + L::V_OFF, full, empty, &k_map, &v_map, j,
          h, k0, b, [&](int s) {
            if (seg) {
              for (int c = lane; c < BKV; c += 32)
                sseg[s * BKV + c] =
                    k0 + c < Lk ? kv_seg[(long long)b * Lk + k0 + c] : 0;
            }
          });
    }
  } else {
    sm90::regs_alloc<L::CONSUMER_REGS>();
    consume<D>(smem, q_seg, o, lse, H, Lq, Lk, scale, causal, b, h, q0,
               n_kv);
  }
}

template <int D>
int launch_fwd(const void* q, const void* k, const void* v, const void* q_seg,
               const void* kv_seg, void* o, void* lse, int B, int H, int Lq,
               int Lk, Strides st, float scale, int causal,
               cudaStream_t stream) {
  CUtensorMap qm, km, vm;
  int err = qkv_map<D>(&qm, q, B, Lq, H, st.q_b, st.q_l);
  if (err == 0) err = qkv_map<D>(&km, k, B, Lk, H, st.k_b, st.k_l);
  if (err == 0) err = qkv_map<D>(&vm, v, B, Lk, H, st.v_b, st.v_l);
  if (err != 0) return err;
  using L = FwdLayout<D>;
  cudaError_t e = sm90::allow_smem(flash_fwd_kernel<D>, L::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(B * H, (Lq + L::BQ - 1) / L::BQ);
  flash_fwd_kernel<D><<<grid, L::THREADS, L::SMEM, stream>>>(
      qm, km, vm, static_cast<const int*>(q_seg),
      static_cast<const int*>(kv_seg), static_cast<bf16*>(o),
      static_cast<float*>(lse), H, Lq, Lk, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace kfattn

// Returns the cudaError_t of the launch (0 on success). q_seg and kv_seg
// are both null (no segment mask) or both (B, Lq) / (B, Lk) int32.
extern "C" int flash_attention_fwd_bf16(
    const void* q, const void* k, const void* v, const void* q_seg,
    const void* kv_seg, void* o, void* lse, int B, int H, int Lq, int Lk,
    int D, long long q_sb, long long q_sl, long long k_sb, long long k_sl,
    long long v_sb, long long v_sl, float scale, int causal, void* stream) {
  const kfattn::Strides st{q_sb, q_sl, k_sb, k_sl, v_sb, v_sl};
  auto s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return kfattn::launch_fwd<64>(q, k, v, q_seg, kv_seg, o, lse, B, H, Lq,
                                  Lk, st, scale, causal, s);
  if (D == 128)
    return kfattn::launch_fwd<128>(q, k, v, q_seg, kv_seg, o, lse, B, H,
                                   Lq, Lk, st, scale, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
