// C entry point of the eval 3x3 SAME conv + BN fold (`conv3x3_bn_apply`
// in analytics_zoo_tpu_torch/ops/conv_bn.py); the kernel is the KS = 3
// instance of conv_bn_fwd.cuh. The caller passes TF-SAME's low pads
// (pad_t, pad_l); any extent and stride 1 or 2 are taken.

#include "conv_bn_fwd.cuh"

extern "C" int conv3x3_bn_apply_launch(
    const void* x, const void* w, const void* in_scale,
    const void* in_shift, const void* out_scale, const void* out_shift,
    void* y, int B, int H, int W, int Cin, int Ho, int Wo, int N, int stride,
    int pad_t, int pad_l, int affine_in, int relu_in, int relu_out,
    int x_bf16, int w_bf16, void* stream) {
  const zoo::ConvBnArgs a = zoo::make_args(
      x, w, in_scale, in_shift, out_scale, out_shift, nullptr, y, B, H, W,
      Cin, Ho, Wo, N, stride, pad_t, pad_l, affine_in, relu_in, relu_out);
  return zoo::launch_conv_bn<3, false>(
      a, x_bf16, w_bf16, static_cast<cudaStream_t>(stream));
}
