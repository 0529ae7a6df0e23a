// C entry point of the eval 1x1 conv + BN fold (`matmul_bn_apply` and
// `conv1x1_bn_apply` in analytics_zoo_tpu_torch/ops/conv_bn.py); the
// kernel is the KS = 1 instance of conv_bn_fwd.cuh. A strided 1x1
// reads every stride-th pixel in place (no sliced copy of x).

#include "conv_bn_fwd.cuh"

extern "C" int matmul_bn_apply_launch(
    const void* x, const void* w, const void* in_scale,
    const void* in_shift, const void* out_scale, const void* out_shift,
    const void* res, void* y, int B, int H, int W, int Cin, int Ho, int Wo,
    int N, int stride, int affine_in, int relu_in, int relu_out, int x_bf16,
    int w_bf16, void* stream) {
  const zoo::ConvBnArgs a = zoo::make_args(
      x, w, in_scale, in_shift, out_scale, out_shift, res, y, B, H, W, Cin,
      Ho, Wo, N, stride, 0, 0, affine_in, relu_in, relu_out);
  return zoo::launch_conv_bn<1, false>(
      a, x_bf16, w_bf16, static_cast<cudaStream_t>(stream));
}
