// C entry point of the dW half of the training 1x1 conv + BN backward
// (`matmul_bn`'s VJP in analytics_zoo_tpu_torch/ops/conv_bn.py): a
// split-M dW kernel over `splits` chunks of m_chunk rows into partial
// (splits * K * N floats), then a fixed-order sum of the splits into dw
// (K, N). bf16 (every tensor bf16) runs the wgmma kernel of
// matmul_bn_dw_sm90.cuh (chunks a multiple of 64 rows) and its own sum
// into a bf16 dw (work unused); f32 the FMA kernel of conv_bn_bwd.cuh
// (a multiple of 32) and colsum.cuh into an f32 dw (work what colsum()
// asks for).

#include "colsum.cuh"
#include "conv_bn_bwd.cuh"
#include "matmul_bn_dw_sm90.cuh"

extern "C" int matmul_bn_dw_launch(
    const void* dy, const void* y, const void* x, const void* s,
    const void* t, const void* r, const void* sh, const void* dsum,
    const void* dsq, void* partial, void* work, void* dw, int M, int K,
    int N, int affine_in, int relu_in, int splits, int m_chunk, int bk,
    int bn, int bf16, void* stream) {
  zoo::BwdArgs a;
  a.dy = dy;
  a.y = y;
  a.x = x;
  a.w = nullptr;
  a.s = static_cast<const float*>(s);
  a.t = static_cast<const float*>(t);
  a.r = r;
  a.sh = static_cast<const float*>(sh);
  a.dsum = static_cast<const float*>(dsum);
  a.dsq = static_cast<const float*>(dsq);
  a.dx = nullptr;
  a.dr = nullptr;
  a.partial = static_cast<float*>(partial);
  a.M = M;
  a.K = K;
  a.N = N;
  a.affine_in = affine_in;
  a.relu_in = relu_in;
  a.m_chunk = m_chunk;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) return zoo::dw_sm90::launch(a, splits, bk, bn, dw, st);
  const dim3 grid(K / zoo::kBM, N / zoo::kBN, splits);
  zoo::note_launch("conv_bn_dw_f32_kernel");
  zoo::conv_bn_dw_f32_kernel<<<grid, 256, 0, st>>>(a);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  return zoo::colsum(a.partial, static_cast<float*>(work),
                     static_cast<float*>(dw), splits, K * N, st);
}

// The instance this library launched last (last_launch.cuh).
ZOO_EXPORT_LAST_KERNEL(matmul_bn_dw)
