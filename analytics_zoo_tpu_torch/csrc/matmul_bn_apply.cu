// C entry point of the eval 1x1 conv + BN fold (`matmul_bn_apply` and
// `conv1x1_bn_apply` in analytics_zoo_tpu_torch/ops/conv_bn.py). The
// product runs in the weights' type, on the kernel the caller's route
// names (`fold_route` there): 0, f32 weights, the tf32-split wgmma
// kernel of matmul_bn_apply_sm90.cuh in three passes (f32-accurate); 1,
// the same in two passes, for a bf16 x without a prologue (exact in
// tf32); 2, bf16 x and weights, B1's wgmma kernel of matmul_bn_sm90.cuh
// with its fold epilogue; 3, bf16 weights with an f32 x, the tf32
// kernel in one pass on the bf16-rounded prologue (exact in tf32). x
// (and res, y) are f32 or bf16. A strided 1x1 reads every stride-th
// pixel in place (no sliced copy of x).

#include "matmul_bn_apply_sm90.cuh"
#include "matmul_bn_sm90.cuh"

extern "C" int matmul_bn_apply_launch(
    const void* x, const void* w, const void* in_scale,
    const void* in_shift, const void* out_scale, const void* out_shift,
    const void* res, void* y, int B, int H, int W, int Cin, int Ho, int Wo,
    int N, int stride, int affine_in, int relu_in, int relu_out, int x_bf16,
    int route, void* stream) {
  const zoo::ConvBnArgs a = zoo::make_args(
      x, w, in_scale, in_shift, out_scale, out_shift, res, y, B, H, W, Cin,
      Ho, Wo, N, stride, 0, 0, affine_in, relu_in, relu_out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 2)
    return x_bf16 ? zoo::mm_sm90::launch_fold(a, s)
                  : static_cast<int>(cudaErrorInvalidValue);
  return zoo::apply_sm90::launch(a, x_bf16, route, s);
}

// The instance this library launched last (last_launch.cuh).
ZOO_EXPORT_LAST_KERNEL(matmul_bn_apply)
