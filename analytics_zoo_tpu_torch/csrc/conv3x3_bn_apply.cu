// C entry point of the eval 3x3 SAME conv + BN fold (`conv3x3_bn_apply`
// in analytics_zoo_tpu_torch/ops/conv_bn.py). bf16 (x and w bf16) runs
// B2's wgmma kernels of conv3x3_bn_sm90.cuh with the fold epilogue on
// the tile the caller picked (window != 0: the stride-1 window kernel;
// else the generic one, bn columns wide); f32 the KS = 3 fold instance
// of conv_bn_fwd.cuh's f32 template (window and bn unused). The caller
// passes TF-SAME's low pads (pad_t, pad_l); any extent and stride 1 or
// 2 are taken.

#include "conv3x3_bn_sm90.cuh"
#include "conv_bn_fwd.cuh"

extern "C" int conv3x3_bn_apply_launch(
    const void* x, const void* w, const void* in_scale,
    const void* in_shift, const void* out_scale, const void* out_shift,
    void* y, int B, int H, int W, int Cin, int Ho, int Wo, int N, int stride,
    int pad_t, int pad_l, int affine_in, int relu_in, int relu_out,
    int x_bf16, int w_bf16, int window, int bn, void* stream) {
  if (x_bf16 != w_bf16) return static_cast<int>(cudaErrorInvalidValue);
  const zoo::ConvBnArgs a = zoo::make_args(
      x, w, in_scale, in_shift, out_scale, out_shift, nullptr, y, B, H, W,
      Cin, Ho, Wo, N, stride, pad_t, pad_l, affine_in, relu_in, relu_out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16) return zoo::conv3_sm90::launch_fold(a, window, bn, s);
  const int M = B * Ho * Wo;
  zoo::note_launch("conv_bn_f32_kernel<float, 3, false>");
  zoo::conv_bn_f32_kernel<float, 3, false>
      <<<dim3((M + zoo::kBM - 1) / zoo::kBM, N / zoo::kBN), 256, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The instance this library launched last (last_launch.cuh).
ZOO_EXPORT_LAST_KERNEL(conv3x3_bn_apply)
