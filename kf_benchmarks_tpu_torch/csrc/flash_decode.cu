// flash_decode: single-query attention over a KV ring buffer, bf16 in and
// out, f32 softmax -- the serving decode step's attention.
//
//   o[b, 0, h] = sum_{s <= pos[b]} softmax_s(scale * q[b,0,h] . k[b,s,h])
//                                  * v[b,s,h]
//
// over the admitted slots s < min(pos[b] + 1, T): a slot past pos[b] is
// never read, so stale ring contents (a packed neighbour's K/V, NaN) cannot
// reach the result, and once pos[b] >= T - 1 (the ring has wrapped) every
// slot takes part.
//
// Replaces the TPU kernel `_flash_attention_impl` of JAX's library flash
// attention (jax/experimental/pallas/ops/tpu/flash_attention.py, its
// `pl.pallas_call` at :758) in decode mode, as the JAX package calls it from
// kf_benchmarks_tpu/parallel/sequence.py `decode_attention(impl='flash')`
// (:664-677): q length 1, causal=False, SegmentIds(q = 1,
// kv = kpos <= pos[b]). The TPU kernel walks every key block of the ring in
// its sequential grid and masks; it has one q row per (b, h).
//
// Bound on an H100 SXM: decode reads each admitted K and V element once
// and does 2 multiply-adds per element pair, ~1 FLOP per byte against the
// card's ~295 FLOP/byte ridge (bf16) or ~20 (f32 CUDA cores): bound by
// bytes (3.35 TB/s). At the LM's shape (B 64, T 2048, H 8, D 64, full
// ring) the admitted K and V are 268 MB, ~0.080 ms. The only lever is to
// read the admitted bytes once with enough blocks in flight, so the design
// splits the keys (flash-decoding):
//
// * flash_decode_partial: grid (B*H, S). Split s of row b takes keys
//   [s*chunk, min((s+1)*chunk, n)), chunk = 64*ceil(n / (64*S)), n the
//   admitted count, and never a slot past pos[b]. 128 threads; D/8 threads
//   own one key (16-byte loads, neighbouring threads on neighbouring D
//   elements), so a block has 1024/D keys in flight. Each key group keeps
//   its own online softmax (running max m, sum l, unnormalised output) in
//   f32 registers on the CUDA cores -- P stays f32, no tensor core is needed
//   at one query row -- and the groups merge in shared memory. The split
//   writes f32 partials m, l (B, H, S) and o (B, H, S, D). A split with no
//   admitted key writes m = -inf, l = 0, o = 0 and contributes exactly 0.
// * flash_decode_combine: grid (B*H), D threads; merges the S partials in a
//   fixed order (no atomics: the result is the same run to run) and rounds
//   once to bf16.
//
// The wrapper (ops/flash_attention.py flash_decode) chooses S so that
// B*H*S covers the SMs twice where the ring allows. k and v may be strided
// views (one layer of the (L, B, T, H, D) cache): the kernel takes batch and
// position strides; heads are adjacent and D contiguous. Left for later:
// cp.async/TMA pipelining of the key loads and a fused single-pass combine.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace kfdecode {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 128;
constexpr int SPLIT_ALIGN = 64;   // a split's keys are a multiple of this
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ void load8(const bf16* p, float (&f)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h2[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// Keys [k0, k1) of split s for a row with n admitted keys.
__device__ __forceinline__ void split_range(int n, int S, int s, int& k0,
                                            int& k1) {
  const int per = SPLIT_ALIGN * ((n + SPLIT_ALIGN * S - 1) / (SPLIT_ALIGN * S));
  k0 = min(n, s * per);
  k1 = min(n, k0 + per);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_decode_partial_kernel(const bf16* __restrict__ q,
                            const bf16* __restrict__ k,
                            const bf16* __restrict__ v,
                            const int* __restrict__ pos,
                            float* __restrict__ m_out,
                            float* __restrict__ l_out,
                            float* __restrict__ o_out, int H, int T, int S,
                            long long q_b, long long k_b, long long k_t,
                            long long v_b, long long v_t, float scale) {
  constexpr int TPK = D / 8;         // threads per key
  constexpr int G = THREADS / TPK;   // keys in flight per block
  __shared__ float sm_m[G];
  __shared__ float sm_l[G];
  __shared__ float sm_o[G][D];

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int s = blockIdx.y;
  const int grp = threadIdx.x / TPK;
  const int lane = threadIdx.x % TPK;

  const int n = max(0, min(pos[b] + 1, T));
  int k0, k1;
  split_range(n, S, s, k0, k1);

  float qf[8];
  load8(q + b * q_b + (long long)h * D + lane * 8, qf);
  const bf16* kp = k + b * k_b + (long long)h * D + lane * 8;
  const bf16* vp = v + b * v_b + (long long)h * D + lane * 8;

  float m = -INFINITY, l = 0.f;
  float acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.f;

  // Every lane runs the same trip count (the shuffles below need the whole
  // warp); a lane whose key lies past k1 loads nothing and updates nothing.
  for (int j0 = k0; j0 < k1; j0 += G) {
    const int j = j0 + grp;
    const bool live = j < k1;
    float kf[8], vf[8];
    if (live) {
      load8(kp + j * k_t, kf);
      load8(vp + j * v_t, vf);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) kf[i] = vf[i] = 0.f;
    }
    float dot = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) dot = fmaf(qf[i], kf[i], dot);
#pragma unroll
    for (int off = TPK / 2; off > 0; off >>= 1)
      dot += __shfl_xor_sync(FULL, dot, off);
    if (live) {
      const float sc = dot * scale;
      const float m_new = fmaxf(m, sc);
      const float alpha = expf(m - m_new);  // 0 at a group's first key
      const float p = expf(sc - m_new);
      l = l * alpha + p;
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] = fmaf(p, vf[i], acc[i] * alpha);
      m = m_new;
    }
  }

  if (lane == 0) {
    sm_m[grp] = m;
    sm_l[grp] = l;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) sm_o[grp][lane * 8 + i] = acc[i];
  __syncthreads();

  // Merge the G key groups, one output element per thread.
  for (int d = threadIdx.x; d < D; d += THREADS) {
    float mx = -INFINITY;
#pragma unroll
    for (int g = 0; g < G; ++g) mx = fmaxf(mx, sm_m[g]);
    const float base = mx == -INFINITY ? 0.f : mx;  // no key: weights 0
    float lsum = 0.f, o = 0.f;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float w = expf(sm_m[g] - base);
      lsum = fmaf(sm_l[g], w, lsum);
      o = fmaf(sm_o[g][d], w, o);
    }
    const long long row = (long long)bh * S + s;
    o_out[row * D + d] = o;
    if (d == 0) {
      m_out[row] = mx;
      l_out[row] = lsum;
    }
  }
}

__global__ void flash_decode_combine_kernel(const float* __restrict__ m,
                                            const float* __restrict__ l,
                                            const float* __restrict__ o_part,
                                            bf16* __restrict__ o, int S,
                                            int D) {
  const int bh = blockIdx.x;
  const int d = threadIdx.x;
  const float* mp = m + (long long)bh * S;
  const float* lp = l + (long long)bh * S;
  const float* op = o_part + (long long)bh * S * D;
  float mx = -INFINITY;
  for (int s = 0; s < S; ++s) mx = fmaxf(mx, mp[s]);
  const float base = mx == -INFINITY ? 0.f : mx;
  float lsum = 0.f, acc = 0.f;
  for (int s = 0; s < S; ++s) {
    const float w = expf(mp[s] - base);
    lsum = fmaf(lp[s], w, lsum);
    acc = fmaf(op[(long long)s * D + d], w, acc);
  }
  o[(long long)bh * D + d] = __float2bfloat16(lsum > 0.f ? acc / lsum : 0.f);
}

template <int D>
int launch_partial(const void* q, const void* k, const void* v,
                   const void* pos, void* m, void* l, void* o, int B, int H,
                   int T, int S, long long q_b, long long k_b, long long k_t,
                   long long v_b, long long v_t, float scale,
                   cudaStream_t stream) {
  dim3 grid(B * H, S);
  flash_decode_partial_kernel<D><<<grid, THREADS, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const int*>(pos),
      static_cast<float*>(m), static_cast<float*>(l), static_cast<float*>(o),
      H, T, S, q_b, k_b, k_t, v_b, v_t, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace kfdecode

// q (B, 1, H, D) with batch stride q_b; k and v (B, T, H, D) with batch and
// position strides; pos (B,) int32; m, l (B, H, S) and o (B, H, S, D) f32
// contiguous. Returns the cudaError_t of the launch (0 on success).
extern "C" int flash_decode_partial_bf16(
    const void* q, const void* k, const void* v, const void* pos, void* m,
    void* l, void* o, int B, int H, int T, int D, int S, long long q_b,
    long long k_b, long long k_t, long long v_b, long long v_t, float scale,
    void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return kfdecode::launch_partial<64>(q, k, v, pos, m, l, o, B, H, T, S,
                                        q_b, k_b, k_t, v_b, v_t, scale, st);
  if (D == 128)
    return kfdecode::launch_partial<128>(q, k, v, pos, m, l, o, B, H, T, S,
                                         q_b, k_b, k_t, v_b, v_t, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// m, l (B, H, S) and o_part (B, H, S, D) f32 from flash_decode_partial_bf16;
// o (B, 1, H, D) bf16 contiguous.
extern "C" int flash_decode_combine_bf16(const void* m, const void* l,
                                         const void* o_part, void* o, int B,
                                         int H, int D, int S, void* stream) {
  if (D != 64 && D != 128) return static_cast<int>(cudaErrorInvalidValue);
  kfdecode::flash_decode_combine_kernel<<<B * H, D, 0,
                                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(m), static_cast<const float*>(l),
      static_cast<const float*>(o_part), static_cast<__nv_bfloat16*>(o), S, D);
  return static_cast<int>(cudaGetLastError());
}
