// K-A: 3x3 SAME stride-1 convolution, NHWC bf16 in and out, f32 accumulation.
//
// Replaces the TPU kernel `conv_kernel` / `pallas_conv` of
// experiments/pallas_conv_probe.py (9 shifted matmuls over a pre-padded
// image, one grid step per image). Here the padding is never materialised:
// the implicit GEMM in conv3x3_sm90.cuh loads each tap's pixels as a TMA
// box, which reads zeros where the tap falls outside the image.
//
//   y[n,h,w,o] = sum_{dy,dx,c} x[n,h+dy-1,w+dx-1,c] * w[dy,dx,c,o]
//
// In the port it carries the input gradient of the fused BN-ReLU-conv unit:
// dX = conv3x3(dY, w') with w'[dy,dx,o,c] = w[2-dy,2-dx,c,o].
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): at the probe's
// shape x[256,28,28,128] * w[3,3,128,128], 5.92e10 FLOP (~60 us) against
// ~103 MB of x + y (~31 us): operations-bound. At the stage-2 shape
// (C = CO = 64, 56x56) the two lines meet (~60 us each). The design that
// goes after the operations line (wgmma from a TMA ring, a producer
// warpgroup, persistent tiles) is in conv3x3_sm90.cuh.

#include "conv3x3_sm90.cuh"

// y [N,H,W,CO] = conv3x3_SAME(x [N,H,W,C], w), with w the K-major
// [CO, 3, 3, C] weights (the HWIO tensor permuted; ops/conv_bn.py makes
// it), on `grid` persistent blocks of BM x BN output tiles whose A comes
// from boxes of wb x hb pixels of nb images (ops/conv_bn.py `conv_tile`
// picks them). C % 64 == 0, CO % BN == 0, x and w 16-byte aligned.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int conv3x3_same_bf16(const void* x, const void* w, void* y, int N,
                                 int H, int W, int C, int CO, int bm, int bn,
                                 int wb, int hb, int nb, int grid,
                                 void* stream) {
  return kfconv90::launch<kfconv90::Identity, kfconv90::StoreY>(
      x, w, y, N, H, W, C, CO, bm, bn, wb, hb, nb, grid,
      kfconv90::UnitArgs{nullptr, nullptr, nullptr},
      static_cast<cudaStream_t>(stream));
}
