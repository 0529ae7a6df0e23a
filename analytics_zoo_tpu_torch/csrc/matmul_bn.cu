// C entry point of the training 1x1 conv + BN statistics (`matmul_bn` and
// `conv1x1_bn` in analytics_zoo_tpu_torch/ops/conv_bn.py): bf16 (x, w and
// in_res bf16) runs the wgmma kernel of matmul_bn_sm90.cuh on 128 x bn
// tiles, one wave of blocks walking them (one partial row per 128-row M
// tile); f32 the KS = 1 statistics instance of conv_bn_fwd.cuh's FMA
// template (one per 64-row tile; bn unused); then the fixed-order
// column sums of colsum.cuh. Writes y (M, N) and stats (2N: the column
// sums of acc - sh, then of its squares). A strided 1x1 reads every
// stride-th pixel in place; in_res (M, Cin) joins the prologue after the
// affine, before the ReLU. partial holds that many rows of 2N floats,
// work what colsum() asks for.

#include "colsum.cuh"
#include "conv_bn_fwd.cuh"
#include "matmul_bn_sm90.cuh"

extern "C" int matmul_bn_launch(
    const void* x, const void* w, const void* in_scale,
    const void* in_shift, const void* in_res, const void* sh, void* y,
    void* partial, void* work, void* stats, int B, int H, int W, int Cin,
    int Ho, int Wo, int N, int stride, int affine_in, int relu_in,
    int bf16, int bn, void* stream) {
  zoo::ConvBnArgs a = zoo::make_args(
      x, w, in_scale, in_shift, nullptr, nullptr, nullptr, y, B, H, W, Cin,
      Ho, Wo, N, stride, 0, 0, affine_in, relu_in, 0);
  a.in_res = in_res;
  a.sh = static_cast<const float*>(sh);
  a.partial = static_cast<float*>(partial);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * Ho * Wo;
  int tiles, err;
  if (bf16) {
    tiles = zoo::mm_sm90::partial_rows(M);
    err = zoo::mm_sm90::launch_stats(a, bn, s);
  } else {
    tiles = (M + zoo::kBM - 1) / zoo::kBM;
    zoo::note_launch("conv_bn_f32_kernel<float, 1, true>");
    zoo::conv_bn_f32_kernel<float, 1, true>
        <<<dim3(tiles, N / zoo::kBN), 256, 0, s>>>(a);
    err = static_cast<int>(cudaGetLastError());
  }
  if (err != 0) return err;
  return zoo::colsum(a.partial, static_cast<float*>(work),
                     static_cast<float*>(stats), tiles, 2 * N, s);
}

// The instance this library launched last (last_launch.cuh).
ZOO_EXPORT_LAST_KERNEL(matmul_bn)
