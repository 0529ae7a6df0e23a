// C entry point of the training 3x3 SAME conv + BN statistics
// (`conv3x3_bn` in analytics_zoo_tpu_torch/ops/conv_bn.py): the KS = 3
// statistics instance of conv_bn_fwd.cuh, then the fixed-order column
// sums of colsum.cuh. The caller passes TF-SAME's low pads (pad_t,
// pad_l); any extent and stride 1 or 2 are taken. Writes y (M, N) and
// stats (2N: the column sums of acc - sh, then of its squares).

#include "colsum.cuh"
#include "conv_bn_fwd.cuh"

extern "C" int conv3x3_bn_launch(
    const void* x, const void* w, const void* in_scale,
    const void* in_shift, const void* sh, void* y, void* partial,
    void* work, void* stats, int B, int H, int W, int Cin, int Ho, int Wo,
    int N, int stride, int pad_t, int pad_l, int affine_in, int relu_in,
    int x_bf16, int w_bf16, void* stream) {
  zoo::ConvBnArgs a = zoo::make_args(
      x, w, in_scale, in_shift, nullptr, nullptr, nullptr, y, B, H, W, Cin,
      Ho, Wo, N, stride, pad_t, pad_l, affine_in, relu_in, 0);
  a.sh = static_cast<const float*>(sh);
  a.partial = static_cast<float*>(partial);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = zoo::launch_conv_bn<3, true>(a, x_bf16, w_bf16, s);
  if (err != 0) return err;
  const int tiles = (B * Ho * Wo + zoo::kBM - 1) / zoo::kBM;
  return zoo::colsum(a.partial, static_cast<float*>(work),
                     static_cast<float*>(stats), tiles, 2 * N, s);
}
