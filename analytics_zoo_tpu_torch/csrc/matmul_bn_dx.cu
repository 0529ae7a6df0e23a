// C entry point of the dx half of the training 1x1 conv + BN backward
// (`matmul_bn`'s VJP in analytics_zoo_tpu_torch/ops/conv_bn.py): the dx
// kernel of conv_bn_bwd.cuh, then, with affine_in, the fixed-order
// column sums of its ds/dt partials (colsum.cuh) into dsdt (2K: ds, then
// dt). bf16 selects the tensor-core path (every tensor bf16), else f32.
// partial holds ceil(M / 64) * 2K floats, work what colsum() asks for.

#include "colsum.cuh"
#include "conv_bn_bwd.cuh"

extern "C" int matmul_bn_dx_launch(
    const void* dy, const void* y, const void* x, const void* w,
    const void* s, const void* t, const void* r, const void* sh,
    const void* dsum, const void* dsq, void* dx, void* dr, void* partial,
    void* work, void* dsdt, int M, int K, int N, int affine_in,
    int relu_in, int bf16, void* stream) {
  zoo::BwdArgs a;
  a.dy = dy;
  a.y = y;
  a.x = x;
  a.w = w;
  a.s = static_cast<const float*>(s);
  a.t = static_cast<const float*>(t);
  a.r = r;
  a.sh = static_cast<const float*>(sh);
  a.dsum = static_cast<const float*>(dsum);
  a.dsq = static_cast<const float*>(dsq);
  a.dx = dx;
  a.dr = dr;
  a.partial = affine_in ? static_cast<float*>(partial) : nullptr;
  a.M = M;
  a.K = K;
  a.N = N;
  a.affine_in = affine_in;
  a.relu_in = relu_in;
  a.m_chunk = 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles = (M + zoo::kBM - 1) / zoo::kBM;
  const dim3 grid(tiles, K / zoo::kBN);
  if (bf16)
    zoo::conv_bn_dx_bf16_kernel<<<grid, 128, 0, st>>>(a);
  else
    zoo::conv_bn_dx_f32_kernel<<<grid, 256, 0, st>>>(a);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0 || !affine_in) return err;
  return zoo::colsum(a.partial, static_cast<float*>(work),
                     static_cast<float*>(dsdt), tiles, 2 * K, st);
}
