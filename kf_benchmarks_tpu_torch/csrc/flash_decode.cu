// flash_decode: single-query attention over a KV ring buffer, bf16 in and
// out, f32 softmax -- the serving decode step's attention, in one launch.
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
// its sequential grid and carries m, l and the accumulator in scratch.
//
// Bound on an H100 SXM: decode reads each admitted K and V element once
// and does 2 multiply-adds per element pair, ~1 FLOP per byte against the
// card's ~295 FLOP/byte ridge (bf16): bound by bytes (3.35 TB/s). At the
// LM's shape (B 64, T 2048, H 8, D 64) the admitted K and V of the decode
// phase's positions are ~194 MB, ~0.058 ms. What the design does about it:
//
// * Enough blocks, few keys each. The keys of a row (b, h) are split S ways
//   (flash-decoding), S chosen by the wrapper (ops/flash_attention.py
//   `decode_plan`) so that a block walks at most ~256 keys even at B 64-256
//   and the blocks cover the SMs at B 1-16. Split s takes keys
//   [s*per, min((s+1)*per, n)), per = 64*ceil(n / (64*S)), n the row's
//   admitted count: a short row spreads over all S blocks too.
// * Enough bytes in flight. 128 threads; D/8 threads own a key (16-byte
//   loads, neighbouring threads on neighbouring D elements), so a pass
//   covers 1024/D keys, and each thread issues the K and V loads of
//   U = 64 / (1024/D) keys of a 64-key tile before it uses any: 16 KB of
//   loads in flight a block (Little's law at 3.35 TB/s and ~1 us of DRAM
//   latency wants ~25 KB an SM; several blocks share an SM).
// * One launch. The S blocks of a row form a thread-block cluster. Each
//   block merges its key groups' online softmax (f32 m, l and output,
//   exp2 of log2e-scaled scores) into f32 (m, l, o[D]) in its shared
//   memory; after cluster.sync() the cluster's rank 0 reads its peers'
//   partials through distributed shared memory in rank order, divides once
//   and rounds once to bf16. No partials in global memory, no atomics, no
//   second launch: the result is the same run to run. A split with no
//   admitted key holds m = -inf, l = 0, o = 0 and contributes exactly 0.
//
// k and v may be strided views (one layer of the (L, B, T, H, D) cache):
// the kernel takes batch and position strides; heads are adjacent and D
// contiguous.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace cg = cooperative_groups;

namespace kfdecode {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 128;
constexpr int TILE = 64;          // keys a block takes per pass of its loop
constexpr int SPLIT_ALIGN = 64;   // a split's keys are a multiple of this
constexpr int MAX_SPLITS = 16;    // the largest (non-portable) cluster
constexpr int MAX_DEVICES = 64;   // devices whose cluster opt-in is cached
constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ void unpack8(const uint4& raw, float (&f)[8]) {
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

// One block's merged partial, read by the cluster's rank 0.
template <int D>
struct Partial {
  float m, l;
  float o[D];
};

// Grid: S * B * H blocks in clusters of S along x; block x takes split
// x % S (its rank in the cluster) of row x / S = b * H + h.
template <int D>
__global__ void __launch_bounds__(THREADS)
flash_decode_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const int* __restrict__ pos,
                    bf16* __restrict__ o_out, int H, int T, int S,
                    long long q_b, long long k_b, long long k_t,
                    long long v_b, long long v_t, float scale_log2) {
  constexpr int TPK = D / 8;         // threads per key
  constexpr int G = THREADS / TPK;   // key groups: keys a pass covers
  constexpr int U = TILE / G;        // keys a group takes per tile
  __shared__ float sm_m[G];
  __shared__ float sm_l[G];
  __shared__ float sm_o[G][D];
  __shared__ Partial<D> part;

  cg::cluster_group cluster = cg::this_cluster();
  const int s = static_cast<int>(cluster.block_rank());
  const int row = blockIdx.x / S;  // b * H + h
  const int b = row / H;
  const int h = row % H;
  const int grp = threadIdx.x / TPK;
  const int lane = threadIdx.x % TPK;

  const int n = max(0, min(pos[b] + 1, T));
  int k0, k1;
  split_range(n, S, s, k0, k1);

  float qf[8];
  unpack8(*reinterpret_cast<const uint4*>(q + b * q_b + (long long)h * D +
                                          lane * 8),
          qf);
#pragma unroll
  for (int i = 0; i < 8; ++i) qf[i] *= scale_log2;
  const bf16* kp = k + b * k_b + (long long)h * D + lane * 8;
  const bf16* vp = v + b * v_b + (long long)h * D + lane * 8;

  float m = -INFINITY, l = 0.f;
  float acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.f;

  // Every lane runs the same trip count (the shuffles need the whole warp);
  // a key past k1 is neither loaded nor counted.
  for (int j0 = k0; j0 < k1; j0 += TILE) {
    uint4 kr[U], vr[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = j0 + u * G + grp;
      if (j < k1) {
        kr[u] = __ldg(reinterpret_cast<const uint4*>(kp + j * k_t));
        vr[u] = __ldg(reinterpret_cast<const uint4*>(vp + j * v_t));
      } else {
        kr[u] = vr[u] = make_uint4(0, 0, 0, 0);
      }
    }
    float sc[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[8];
      unpack8(kr[u], kf);
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) dot = fmaf(qf[i], kf[i], dot);
      sc[u] = dot;
    }
#pragma unroll
    for (int off = TPK / 2; off > 0; off >>= 1)
#pragma unroll
      for (int u = 0; u < U; ++u) sc[u] += __shfl_xor_sync(FULL, sc[u], off);
    // The group's online softmax over its live keys of the tile (the same
    // values on each of its TPK lanes).
    float mx = m;
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (j0 + u * G + grp < k1) mx = fmaxf(mx, sc[u]);
    if (mx != -INFINITY) {
      const float alpha = exp2f(m - mx);  // 0 at the group's first key
      l *= alpha;
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] *= alpha;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (j0 + u * G + grp < k1) {
          const float p = exp2f(sc[u] - mx);
          float vf[8];
          unpack8(vr[u], vf);
          l += p;
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[i] = fmaf(p, vf[i], acc[i]);
        }
      }
      m = mx;
    }
  }

  if (lane == 0) {
    sm_m[grp] = m;
    sm_l[grp] = l;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) sm_o[grp][lane * 8 + i] = acc[i];
  __syncthreads();

  // The block's G key groups, in group order, one output element a thread.
  if (threadIdx.x < D) {
    const int d = threadIdx.x;
    float mb = -INFINITY;
#pragma unroll
    for (int g = 0; g < G; ++g) mb = fmaxf(mb, sm_m[g]);
    const float base = mb == -INFINITY ? 0.f : mb;  // no key: weights 0
    float lsum = 0.f, o = 0.f;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float w = exp2f(sm_m[g] - base);
      lsum = fmaf(sm_l[g], w, lsum);
      o = fmaf(sm_o[g][d], w, o);
    }
    part.o[d] = o;
    if (d == 0) {
      part.m = mb;
      part.l = lsum;
    }
  }
  cluster.sync();  // every split's partial is written and visible

  // Rank 0 merges the S splits, in rank order, from distributed shared
  // memory; one division and one rounding to bf16.
  if (s == 0 && threadIdx.x < D) {
    const int d = threadIdx.x;
    float mc = -INFINITY;
    for (int r = 0; r < S; ++r)
      mc = fmaxf(mc, cluster.map_shared_rank(&part, r)->m);
    const float base = mc == -INFINITY ? 0.f : mc;
    float lsum = 0.f, o = 0.f;
    for (int r = 0; r < S; ++r) {
      const Partial<D>* p = cluster.map_shared_rank(&part, r);
      const float w = exp2f(p->m - base);
      lsum = fmaf(p->l, w, lsum);
      o = fmaf(p->o[d], w, o);
    }
    o_out[(long long)row * D + d] =
        __float2bfloat16(lsum > 0.f ? o / lsum : 0.f);
  }
  cluster.sync();  // peers keep their shared memory until rank 0 is done
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* pos,
           void* o, int B, int H, int T, int S, long long q_b, long long k_b,
           long long k_t, long long v_b, long long v_t, float scale,
           cudaStream_t stream) {
  auto kernel = flash_decode_kernel<D>;
  // Clusters of more than 8 blocks are an opt-in of the H100 (up to 16).
  // The attribute is the current device's, so it is set once for each
  // device this instantiation launches on (every launch past MAX_DEVICES).
  int device = 0;
  cudaError_t opt_in = cudaGetDevice(&device);
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  static std::atomic<bool> opted_in[MAX_DEVICES];
  const bool cached = device < MAX_DEVICES;
  if (!cached || !opted_in[device].load(std::memory_order_acquire)) {
    opt_in = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
    if (cached) opted_in[device].store(true, std::memory_order_release);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(S) * B * H);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const int*>(pos),
      static_cast<bf16*>(o), H, T, S, q_b, k_b, k_t, v_b, v_t,
      scale * LOG2E);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace kfdecode

// q (B, 1, H, D) with batch stride q_b; k and v (B, T, H, D) with batch and
// position strides; pos (B,) int32; o (B, 1, H, D) bf16 contiguous; S the
// split count (the cluster size, 1..16). Returns the cudaError_t of the
// launch (0 on success).
extern "C" int flash_decode_bf16(const void* q, const void* k, const void* v,
                                 const void* pos, void* o, int B, int H,
                                 int T, int D, int S, long long q_b,
                                 long long k_b, long long k_t, long long v_b,
                                 long long v_t, float scale, void* stream) {
  if (S < 1 || S > kfdecode::MAX_SPLITS || B < 1 || H < 1 || T < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return kfdecode::launch<64>(q, k, v, pos, o, B, H, T, S, q_b, k_b, k_t,
                                v_b, v_t, scale, st);
  if (D == 128)
    return kfdecode::launch<128>(q, k, v, pos, o, B, H, T, S, q_b, k_b, k_t,
                                 v_b, v_t, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
