// C entry point of the dx half of the training 1x1 conv + BN backward
// (`matmul_bn`'s VJP in analytics_zoo_tpu_torch/ops/conv_bn.py): bf16
// (every tensor bf16) runs the wgmma kernel of matmul_bn_dx_sm90.cuh on
// 128 x bk tiles (one ds/dt partial row per 128-row M tile), f32 the FMA
// kernel of conv_bn_bwd.cuh (one per 64-row tile, bk unused); then, with
// affine_in, the fixed-order column sums of the partials (colsum.cuh)
// into dsdt (2K: ds, then dt). partial holds that many rows of 2K
// floats, work what colsum() asks for.

#include "colsum.cuh"
#include "conv_bn_bwd.cuh"
#include "matmul_bn_dx_sm90.cuh"

extern "C" int matmul_bn_dx_launch(
    const void* dy, const void* y, const void* x, const void* w,
    const void* s, const void* t, const void* r, const void* sh,
    const void* dsum, const void* dsq, void* dx, void* dr, void* partial,
    void* work, void* dsdt, int M, int K, int N, int affine_in,
    int relu_in, int bk, int bf16, void* stream) {
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
  int tiles, err;
  if (bf16) {
    tiles = zoo::dx_sm90::partial_rows(M);
    err = zoo::dx_sm90::launch(a, bk, st);
  } else {
    tiles = (M + zoo::kBM - 1) / zoo::kBM;
    zoo::note_launch("conv_bn_dx_f32_kernel");
    zoo::conv_bn_dx_f32_kernel<<<dim3(tiles, K / zoo::kBN), 256, 0, st>>>(
        a);
    err = static_cast<int>(cudaGetLastError());
  }
  if (err != 0 || !affine_in) return err;
  return zoo::colsum(a.partial, static_cast<float*>(work),
                     static_cast<float*>(dsdt), tiles, 2 * K, st);
}

// The instance this library launched last (last_launch.cuh).
ZOO_EXPORT_LAST_KERNEL(matmul_bn_dx)
