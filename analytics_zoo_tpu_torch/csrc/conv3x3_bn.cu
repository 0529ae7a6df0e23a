// C entry point of the training 3x3 SAME conv + BN statistics
// (`conv3x3_bn` in analytics_zoo_tpu_torch/ops/conv_bn.py): bf16 runs the
// wgmma kernels of conv3x3_bn_sm90.cuh (partials: one row per M tile of
// 128 or 256 rows), f32 the KS = 3 statistics instance of
// conv_bn_fwd.cuh's f32 template (one row per 64-row tile); then the
// fixed-order column sums of colsum.cuh. x and w share one type (the
// wrapper casts w). The caller passes TF-SAME's low pads (pad_t, pad_l);
// any extent and stride 1 or 2 are taken. Writes y (M, N) and stats (2N:
// the column sums of acc - sh, then of its squares).

#include "colsum.cuh"
#include "conv3x3_bn_sm90.cuh"
#include "conv_bn_fwd.cuh"

extern "C" int conv3x3_bn_launch(
    const void* x, const void* w, const void* in_scale,
    const void* in_shift, const void* sh, void* y, void* partial,
    void* work, void* stats, int B, int H, int W, int Cin, int Ho, int Wo,
    int N, int stride, int pad_t, int pad_l, int affine_in, int relu_in,
    int x_bf16, int w_bf16, void* stream) {
  if (x_bf16 != w_bf16) return static_cast<int>(cudaErrorInvalidValue);
  zoo::ConvBnArgs a = zoo::make_args(
      x, w, in_scale, in_shift, nullptr, nullptr, nullptr, y, B, H, W, Cin,
      Ho, Wo, N, stride, pad_t, pad_l, affine_in, relu_in, 0);
  a.sh = static_cast<const float*>(sh);
  a.partial = static_cast<float*>(partial);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * Ho * Wo;
  int tiles;
  if (x_bf16) {
    const int err = zoo::conv3_sm90::launch(a, s);
    if (err != 0) return err;
    tiles = zoo::conv3_sm90::partial_rows(a);
  } else {
    tiles = (M + zoo::kBM - 1) / zoo::kBM;
    zoo::note_launch("conv_bn_f32_kernel<float, 3, true>");
    zoo::conv_bn_f32_kernel<float, 3, true>
        <<<dim3(tiles, N / zoo::kBN), 256, 0, s>>>(a);
    const int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  return zoo::colsum(a.partial, static_cast<float*>(work),
                     static_cast<float*>(stats), tiles, 2 * N, s);
}

// The instance this library launched last (last_launch.cuh).
ZOO_EXPORT_LAST_KERNEL(conv3x3_bn)
