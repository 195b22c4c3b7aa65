// K-B: the fused BN-apply -> ReLU -> 3x3 SAME conv -> BN-statistics unit.
//
// Replaces the TPU kernels `fused_kernel` / `pallas_unit` of
// experiments/pallas_fused_chain_probe.py (stage-3 shape, C=128) and
// experiments/pallas_stage2_probe.py (stage-2 shape, C=64, taps N-packed in
// pairs for the TPU's 128-wide matrix unit; Hopper needs no such packing).
//
//   y[n,h,w,o]   = sum_{dy,dx,c} relu(x[n,h+dy-1,w+dx-1,c]*sc[c] + sh[c])
//                                 * w[dy,dx,c,o]   (zero outside the image)
//   stats[0, o]  = sum_{n,h,w} y[n,h,w,o]
//   stats[1, o]  = sum_{n,h,w} y[n,h,w,o]^2
//
// x and y are NHWC bf16, w the K-major [CO,3,3,C] bf16 weights
// (ops/conv_bn.py permutes the HWIO tensor); sc, sh and stats are f32. The
// caller folds its batch norm into sc = gamma*rsqrt(var+eps),
// sh = beta - mean*sc; the probe instead built sc, sh from raw [sum, sumsq]
// with no affine.
//
// Differences from the TPU kernel, each deliberate:
//   * Statistics are summed over the stored bf16-rounded y, which is what
//     the consumer's batch norm computes from y; the probe summed the f32
//     accumulator. The two differ by at most one bf16 ulp per element.
//   * The TPU accumulated the statistics across a sequential grid in one
//     output block. Hopper blocks run in no order, so every persistent
//     block writes its own partial sums (over its tiles, in its fixed tile
//     order) and a second kernel adds them in a fixed order: the result is
//     the same run to run.
//   * No halo layout: the padding comes from the TMA box's zero fill, and
//     the prologue sets the padding rows back to exact zero after
//     relu(x*sc + sh), as the probe's mask did.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s), per unit at
// batch 256: 2*M*9*C*CO = 5.92e10 FLOP at each of the four stage shapes
// (~60 us); x + y bytes are ~103 MB at stage 3 (~31 us) and ~206 MB at
// stage 2 (~61 us). Every stage is at or above the operations line, stage 2
// right at the memory line. The design is K-A's (conv3x3_sm90.cuh: a TMA
// ring of image boxes and weight tiles, wgmma in two consumer warpgroups,
// persistent tiles) with the BnRelu prologue (ldmatrix, relu(x*sc + sh) in
// registers, rs wgmma, the prologue of stage i overlapping the products of
// stage i-1) and the StoreYStats epilogue; ops/conv_bn.py `kb_tile` picks
// the tile and box.

#include "conv3x3_sm90.cuh"

namespace {

constexpr int RED_X = 32;
constexpr int RED_Y = 32;

// stats[s][o] = sum over blocks t, in increasing t, of partial[t][s][o],
// then the RED_Y lane sums in a fixed tree order: deterministic.
__global__ void __launch_bounds__(RED_X * RED_Y)
reduce_partials_kernel(const float* __restrict__ partial,
                       float* __restrict__ stats, int tiles, int CO) {
  __shared__ float s[RED_Y][RED_X + 1];
  const int col = blockIdx.x * RED_X + threadIdx.x;  // in [0, 2*CO)
  float v = 0.f;
  if (col < 2 * CO) {
    for (int t = threadIdx.y; t < tiles; t += RED_Y)
      v += partial[(size_t)t * 2 * CO + col];
  }
  s[threadIdx.y][threadIdx.x] = v;
  __syncthreads();
  for (int step = RED_Y / 2; step > 0; step /= 2) {
    if (threadIdx.y < step)
      s[threadIdx.y][threadIdx.x] += s[threadIdx.y + step][threadIdx.x];
    __syncthreads();
  }
  if (threadIdx.y == 0 && col < 2 * CO) stats[col] = s[0][threadIdx.x];
}

}  // namespace

// y [N,H,W,CO] and stats [2, CO] from x [N,H,W,C], sc, sh [C] and the
// K-major weights w_k [CO,3,3,C], on `grid` persistent blocks of BM x BN
// output tiles whose A comes from boxes of wb x hb pixels of nb images
// (ops/conv_bn.py `kb_tile` picks them). partial must hold grid * 2 * CO
// floats. C % 64 == 0, C <= 512, CO <= 512, CO % BN == 0, BN 64 or 128.
// Returns the cudaError_t of the launches (0 on success).
extern "C" int bn_relu_conv3x3_stats_bf16(const void* x, const float* sc,
                                          const float* sh, const void* w_k,
                                          void* y, float* partial,
                                          float* stats, int N, int H, int W,
                                          int C, int CO, int bm, int bn,
                                          int wb, int hb, int nb, int grid,
                                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = kfconv90::launch<kfconv90::BnRelu, kfconv90::StoreYStats>(
      x, w_k, y, N, H, W, C, CO, bm, bn, wb, hb, nb, grid,
      kfconv90::UnitArgs{sc, sh, partial}, s);
  if (err != 0) return err;
  dim3 blocks((2 * CO + RED_X - 1) / RED_X);
  dim3 block(RED_X, RED_Y);
  reduce_partials_kernel<<<blocks, block, 0, s>>>(partial, stats, grid, CO);
  return static_cast<int>(cudaGetLastError());
}
