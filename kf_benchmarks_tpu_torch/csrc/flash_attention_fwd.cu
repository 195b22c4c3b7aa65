// flash_attention_fwd: o = softmax(scale * Q K^T + mask) V and the row
// log-sum-exp lse, bf16 in and out, f32 softmax.
//
// Replaces the TPU kernel `_flash_attention_impl` of JAX's library flash
// attention (jax/experimental/pallas/ops/tpu/flash_attention.py, its
// `pl.pallas_call` of `_flash_attention_kernel`), which the JAX package
// reaches through parallel/sequence.py `pallas_flash_attention`. The TPU
// kernel walks the key blocks as the sequential last grid axis, carrying m,
// l and the output accumulator in VMEM scratch from one grid step to the
// next, and saves l and m as 128-lane tiles. Here one block owns a 64-row q
// tile and loops over the key tiles itself (Hopper blocks run in no order),
// carrying m, l and the accumulator in registers, and saves one lse = m +
// log(l) per row, which carries the same information for the backward.
//
// Per key tile: S = Q K^T (mma.sync, f32), scale, mask to -inf, online
// softmax (running max m, sum l of the f32 probabilities), P rounded to bf16
// for the P V product as the library does (`p.astype(v.dtype)`). Under
// `causal` the key tiles wholly above the diagonal are not visited (the
// library's `below_or_on_diag`); a ragged last tile is masked.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s) at the LM's shape
// B 8, H 8, L 2048, D 64, causal: 4 * B * H * D * L(L+1)/2 = 34.4 GFLOP,
// 0.035 ms, against ~67 MB of q, k, v, o and lse (0.020 ms): operations-
// bound. See flash_attention.cuh for what the plain design leaves out.

#include "flash_attention.cuh"

namespace kfattn {

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const int* __restrict__ q_seg,
                 const int* __restrict__ kv_seg, bf16* __restrict__ o,
                 float* __restrict__ lse, int H, int Lq, int Lk, Strides st,
                 float scale, int causal) {
  constexpr int P = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + BQ * P;
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
  const int* qs = seg ? q_seg + (long long)b * Lq : nullptr;
  const int* ks = seg ? kv_seg + (long long)b * Lk : nullptr;

  load_tile<D>(sQ, qp, q0, Lq, st.q_l);
  load_seg(sQs, qs, q0, Lq);
  __syncthreads();

  // This lane's rows of the tile: local rl and rl + 8.
  const int rl = warp * 16 + g;
  const int row[2] = {q0 + rl, q0 + rl + 8};
  const int sq[2] = {sQs[rl], sQs[rl + 8]};
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) frag_a<P>(qf[kc], sQ, warp * 16, kc * 16, g, t);

  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;

  const int n_kv = kv_tiles(q0, Lk, causal);
  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * BKV;
    __syncthreads();  // every warp is done with the previous key tile
    load_tile<D>(sK, kp, k0, Lk, st.k_l);
    load_tile<D>(sV, vp, k0, Lk, st.v_l);
    load_seg(sKs, ks, k0, Lk);
    __syncthreads();

    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t b0, b1;
        frag_b_nk<P>(b0, b1, sK, nt * 8, kc * 16, g, t);
        mma16816(s[nt], qf[kc], b0, b1);
      }
    }

    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ri = e / 2;
        const int cl = nt * 8 + 2 * t + (e & 1);
        const int col = k0 + cl;
        const bool ok = col < Lk && (!causal || col <= row[ri]) &&
                        (!seg || sKs[cl] == sq[ri]);
        const float x = ok ? s[nt][e] * scale : -INFINITY;
        s[nt][e] = x;
        mx[ri] = fmaxf(mx[ri], x);
      }
    }
    float alpha[2], base[2];
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      const float m_new = fmaxf(m[ri], quad_max(mx[ri]));
      base[ri] = m_new == -INFINITY ? 0.f : m_new;
      alpha[ri] = __expf(m[ri] - base[ri]);
      m[ri] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = __expf(s[nt][e] - base[e / 2]);  // exp(-inf) = 0
        s[nt][e] = p;
        rs[e / 2] += p;
      }
    }
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) l[ri] = l[ri] * alpha[ri] + quad_sum(rs[ri]);
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      acc[dt][0] *= alpha[0];
      acc[dt][1] *= alpha[0];
      acc[dt][2] *= alpha[1];
      acc[dt][3] *= alpha[1];
    }
#pragma unroll
    for (int kc = 0; kc < BKV / 16; ++kc) {
      uint32_t a[4];
      frag_a_from_acc(a, s, kc);
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        uint32_t b0, b1;
        frag_b_kn<P>(b0, b1, sV, kc * 16, dt * 8, g, t);
        mma16816(acc[dt], a, b0, b1);
      }
    }
  }

#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    if (row[ri] >= Lq) continue;
    const float inv = l[ri] > 0.f ? 1.f / l[ri] : 0.f;
    bf16* op = o + (((long long)b * Lq + row[ri]) * H + h) * D;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      *reinterpret_cast<uint32_t*>(op + dt * 8 + 2 * t) =
          pack_f32(acc[dt][2 * ri] * inv, acc[dt][2 * ri + 1] * inv);
    if (t == 0)
      lse[((long long)b * H + h) * Lq + row[ri]] =
          l[ri] > 0.f ? m[ri] + logf(l[ri]) : INFINITY;
  }
}

template <int D>
int launch_fwd(const void* q, const void* k, const void* v, const void* q_seg,
               const void* kv_seg, void* o, void* lse, int B, int H, int Lq,
               int Lk, Strides st, float scale, int causal,
               cudaStream_t stream) {
  const size_t smem = 3 * 64 * (D + 8) * sizeof(bf16) + 2 * 64 * sizeof(int);
  cudaError_t err = allow_smem(flash_fwd_kernel<D>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Lq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const int*>(q_seg),
      static_cast<const int*>(kv_seg), static_cast<bf16*>(o),
      static_cast<float*>(lse), H, Lq, Lk, st, scale, causal);
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
    return kfattn::launch_fwd<128>(q, k, v, q_seg, kv_seg, o, lse, B, H, Lq,
                                   Lk, st, scale, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
