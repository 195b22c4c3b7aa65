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
// dK/dV: one block per (64-row key tile, head, batch) loops over the q tiles
// on or below the diagonal, with dK and dV in registers. dQ: one block per
// (64-row q tile, head, batch) loops over the key tiles, with dQ in
// registers. The TPU kernels carry these sums in VMEM scratch across their
// sequential grid; here each block owns its output rows, so neither kernel
// needs atomics and the gradients are the same from run to run. The
// library's `ds` output is the gradient of an attention bias this repository
// never passes, and is not computed.
//
// Bound on an H100 SXM at the LM's shape (B 8, H 8, L 2048, D 64, causal):
// the backward's work is five products over the L(L+1)/2 admissible pairs,
// 2.5 x the forward's, 86 GFLOP = 0.087 ms (operations); this design does
// seven (each kernel recomputes S and dP).

#include "flash_attention.cuh"

namespace kfattn {

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const int* __restrict__ q_seg,
                     const int* __restrict__ kv_seg,
                     const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ di, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int H, int Lq, int Lk, Strides st,
                     float scale, int causal) {
  constexpr int P = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + BKV * P;
  bf16* sQ = sV + BKV * P;
  bf16* sO = sQ + BQ * P;  // dO
  float* sLse = reinterpret_cast<float*>(sO + BQ * P);
  float* sDi = sLse + BQ;
  int* sQs = reinterpret_cast<int*>(sDi + BQ);
  int* sKs = sQs + BQ;

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int k0 = blockIdx.x * BKV;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const bool seg = q_seg != nullptr;

  const bf16* qp = q + b * st.q_b + (long long)h * D;
  const bf16* kp = k + b * st.k_b + (long long)h * D;
  const bf16* vp = v + b * st.v_b + (long long)h * D;
  const bf16* op = dout + (long long)b * Lq * H * D + (long long)h * D;
  const float* lp = lse + ((long long)b * H + h) * Lq;
  const float* dp = di + ((long long)b * H + h) * Lq;
  const int* qs = seg ? q_seg + (long long)b * Lq : nullptr;
  const int* ks = seg ? kv_seg + (long long)b * Lk : nullptr;

  load_tile<D>(sK, kp, k0, Lk, st.k_l);
  load_tile<D>(sV, vp, k0, Lk, st.v_l);
  load_seg(sKs, ks, k0, Lk);
  __syncthreads();

  // This lane's key rows of the tile: local rl and rl + 8.
  const int rl = warp * 16 + g;
  const int krow[2] = {k0 + rl, k0 + rl + 8};
  const int sk[2] = {sKs[rl], sKs[rl + 8]};

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[dt][e] = dv_acc[dt][e] = 0.f;

  // Under `causal` the q tiles before this key tile's diagonal hold no
  // admissible pair (BQ == BKV).
  const int n_q = (Lq + BQ - 1) / BQ;
  for (int i = causal ? k0 / BQ : 0; i < n_q; ++i) {
    const int q0 = i * BQ;
    __syncthreads();  // every warp is done with the previous q tile
    load_tile<D>(sQ, qp, q0, Lq, st.q_l);
    load_tile<D>(sO, op, q0, Lq, (long long)H * D);
    for (int r = threadIdx.x; r < BQ; r += THREADS) {
      const bool in = q0 + r < Lq;
      sLse[r] = in ? lp[q0 + r] : 0.f;
      sDi[r] = in ? dp[q0 + r] : 0.f;
    }
    load_seg(sQs, qs, q0, Lq);
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T for this warp's 16 key rows.
    float s[NT][4], d[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = d[nt][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      uint32_t ak[4], av[4];
      frag_a<P>(ak, sK, warp * 16, kc * 16, g, t);
      frag_a<P>(av, sV, warp * 16, kc * 16, g, t);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t b0, b1;
        frag_b_nk<P>(b0, b1, sQ, nt * 8, kc * 16, g, t);
        mma16816(s[nt], ak, b0, b1);
        frag_b_nk<P>(b0, b1, sO, nt * 8, kc * 16, g, t);
        mma16816(d[nt], av, b0, b1);
      }
    }
    // P^T and dS^T in place of S^T and dP^T.
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ri = e / 2;
        const int cl = nt * 8 + 2 * t + (e & 1);
        const int qc = q0 + cl;
        const bool ok = qc < Lq && krow[ri] < Lk &&
                        (!causal || krow[ri] <= qc) &&
                        (!seg || sQs[cl] == sk[ri]);
        const float p = ok ? __expf(s[nt][e] * scale - sLse[cl]) : 0.f;
        s[nt][e] = p;
        d[nt][e] = ok ? (d[nt][e] - sDi[cl]) * p * scale : 0.f;
      }
    }
    // dV += P^T dO, dK += dS^T Q (depth: this q tile's 64 rows).
#pragma unroll
    for (int kc = 0; kc < BQ / 16; ++kc) {
      uint32_t ap[4], ad[4];
      frag_a_from_acc(ap, s, kc);
      frag_a_from_acc(ad, d, kc);
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        uint32_t b0, b1;
        frag_b_kn<P>(b0, b1, sO, kc * 16, dt * 8, g, t);
        mma16816(dv_acc[dt], ap, b0, b1);
        frag_b_kn<P>(b0, b1, sQ, kc * 16, dt * 8, g, t);
        mma16816(dk_acc[dt], ad, b0, b1);
      }
    }
  }

#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    if (krow[ri] >= Lk) continue;
    const long long off = (((long long)b * Lk + krow[ri]) * H + h) * D;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      *reinterpret_cast<uint32_t*>(dk + off + dt * 8 + 2 * t) =
          pack_f32(dk_acc[dt][2 * ri], dk_acc[dt][2 * ri + 1]);
      *reinterpret_cast<uint32_t*>(dv + off + dt * 8 + 2 * t) =
          pack_f32(dv_acc[dt][2 * ri], dv_acc[dt][2 * ri + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const int* __restrict__ q_seg,
                    const int* __restrict__ kv_seg,
                    const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ di, bf16* __restrict__ dq, int H,
                    int Lq, int Lk, Strides st, float scale, int causal) {
  constexpr int P = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sO = sQ + BQ * P;  // dO
  bf16* sK = sO + BQ * P;
  bf16* sV = sK + BKV * P;
  int* sQs = reinterpret_cast<int*>(sV + BKV * P);
  int* sKs = sQs + BQ;

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const bool seg = q_seg != nullptr;

  const bf16* qp = q + b * st.q_b + (long long)h * D;
  const bf16* kp = k + b * st.k_b + (long long)h * D;
  const bf16* vp = v + b * st.v_b + (long long)h * D;
  const bf16* op = dout + (long long)b * Lq * H * D + (long long)h * D;
  const int* qs = seg ? q_seg + (long long)b * Lq : nullptr;
  const int* ks = seg ? kv_seg + (long long)b * Lk : nullptr;

  load_tile<D>(sQ, qp, q0, Lq, st.q_l);
  load_tile<D>(sO, op, q0, Lq, (long long)H * D);
  load_seg(sQs, qs, q0, Lq);
  __syncthreads();

  const int rl = warp * 16 + g;
  const int row[2] = {q0 + rl, q0 + rl + 8};
  const int sq[2] = {sQs[rl], sQs[rl + 8]};
  float lse_r[2], di_r[2];
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    const bool in = row[ri] < Lq;
    const long long at = ((long long)b * H + h) * Lq + row[ri];
    lse_r[ri] = in ? lse[at] : 0.f;
    di_r[ri] = in ? di[at] : 0.f;
  }
  uint32_t qf[D / 16][4], of[D / 16][4];
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    frag_a<P>(qf[kc], sQ, warp * 16, kc * 16, g, t);
    frag_a<P>(of[kc], sO, warp * 16, kc * 16, g, t);
  }
  float dq_acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[dt][e] = 0.f;

  const int n_kv = kv_tiles(q0, Lk, causal);
  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * BKV;
    __syncthreads();
    load_tile<D>(sK, kp, k0, Lk, st.k_l);
    load_tile<D>(sV, vp, k0, Lk, st.v_l);
    load_seg(sKs, ks, k0, Lk);
    __syncthreads();

    // S = Q K^T and dP = dO V^T for this warp's 16 q rows.
    float s[NT][4], d[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = d[nt][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t b0, b1;
        frag_b_nk<P>(b0, b1, sK, nt * 8, kc * 16, g, t);
        mma16816(s[nt], qf[kc], b0, b1);
        frag_b_nk<P>(b0, b1, sV, nt * 8, kc * 16, g, t);
        mma16816(d[nt], of[kc], b0, b1);
      }
    }
    // dS in place of dP.
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ri = e / 2;
        const int cl = nt * 8 + 2 * t + (e & 1);
        const int col = k0 + cl;
        const bool ok = row[ri] < Lq && col < Lk &&
                        (!causal || col <= row[ri]) &&
                        (!seg || sKs[cl] == sq[ri]);
        const float p = ok ? __expf(s[nt][e] * scale - lse_r[ri]) : 0.f;
        d[nt][e] = ok ? (d[nt][e] - di_r[ri]) * p * scale : 0.f;
      }
    }
    // dQ += dS K (depth: this key tile's 64 rows).
#pragma unroll
    for (int kc = 0; kc < BKV / 16; ++kc) {
      uint32_t a[4];
      frag_a_from_acc(a, d, kc);
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        uint32_t b0, b1;
        frag_b_kn<P>(b0, b1, sK, kc * 16, dt * 8, g, t);
        mma16816(dq_acc[dt], a, b0, b1);
      }
    }
  }

#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    if (row[ri] >= Lq) continue;
    bf16* out = dq + (((long long)b * Lq + row[ri]) * H + h) * D;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      *reinterpret_cast<uint32_t*>(out + dt * 8 + 2 * t) =
          pack_f32(dq_acc[dt][2 * ri], dq_acc[dt][2 * ri + 1]);
  }
}

struct BwdArgs {
  const void *q, *k, *v, *q_seg, *kv_seg, *dout, *lse, *di;
  int B, H, Lq, Lk;
  Strides st;
  float scale;
  int causal;
  cudaStream_t stream;
};

template <int D>
int launch_dkv(const BwdArgs& a, void* dk, void* dv) {
  const size_t smem = 4 * 64 * (D + 8) * sizeof(bf16) +
                      2 * 64 * sizeof(float) + 2 * 64 * sizeof(int);
  cudaError_t err = allow_smem(flash_bwd_dkv_kernel<D>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((a.Lk + BKV - 1) / BKV, a.H, a.B);
  flash_bwd_dkv_kernel<D><<<grid, THREADS, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const int*>(a.q_seg),
      static_cast<const int*>(a.kv_seg), static_cast<const bf16*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.di),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), a.H, a.Lq, a.Lk, a.st,
      a.scale, a.causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dq(const BwdArgs& a, void* dq) {
  const size_t smem = 4 * 64 * (D + 8) * sizeof(bf16) + 2 * 64 * sizeof(int);
  cudaError_t err = allow_smem(flash_bwd_dq_kernel<D>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((a.Lq + BQ - 1) / BQ, a.H, a.B);
  flash_bwd_dq_kernel<D><<<grid, THREADS, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const int*>(a.q_seg),
      static_cast<const int*>(a.kv_seg), static_cast<const bf16*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.di),
      static_cast<bf16*>(dq), a.H, a.Lq, a.Lk, a.st, a.scale, a.causal);
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
