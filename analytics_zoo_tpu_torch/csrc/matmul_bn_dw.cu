// C entry point of the dW half of the training 1x1 conv + BN backward
// (`matmul_bn`'s VJP in analytics_zoo_tpu_torch/ops/conv_bn.py): the
// split-M dW kernel of conv_bn_bwd.cuh over `splits` chunks of m_chunk
// rows (a multiple of 32), then the fixed-order sum of the splits'
// (K, N) partials (colsum.cuh) into dw (K, N) f32. bf16 selects the
// tensor-core path (every tensor bf16), else f32. partial holds
// splits * K * N floats, work what colsum() asks for.

#include "colsum.cuh"
#include "conv_bn_bwd.cuh"

extern "C" int matmul_bn_dw_launch(
    const void* dy, const void* y, const void* x, const void* s,
    const void* t, const void* r, const void* sh, const void* dsum,
    const void* dsq, void* partial, void* work, void* dw, int M, int K,
    int N, int affine_in, int relu_in, int splits, int m_chunk, int bf16,
    void* stream) {
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
  const dim3 grid(K / zoo::kBM, N / zoo::kBN, splits);
  if (bf16)
    zoo::conv_bn_dw_bf16_kernel<<<grid, 128, 0, st>>>(a);
  else
    zoo::conv_bn_dw_f32_kernel<<<grid, 256, 0, st>>>(a);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  return zoo::colsum(a.partial, static_cast<float*>(work),
                     static_cast<float*>(dw), splits, K * N, st);
}
