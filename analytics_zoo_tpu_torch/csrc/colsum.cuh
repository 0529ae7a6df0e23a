// Deterministic column sums of a (R, C) f32 matrix of per-block partial
// sums: the second pass of every cross-block reduction of the training
// kernels (the BN statistics of conv_bn_fwd.cuh, ds/dt of the dx kernel
// and the split-M dW of conv_bn_bwd.cuh).
//
// The TPU kernels carry these sums across a sequential grid; on the H100
// blocks run in no order, so the first pass writes one row of partials
// per block and this pass adds the rows in a fixed order: each launch
// folds groups of 64 rows into one (8 strided partial sums per column,
// then those 8 in order), and the launches repeat until one row is left.
// No atomics, so a run repeats bit for bit. Bound by bytes: it reads
// each partial once; the rows number M / 64 at most.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace zoo {

constexpr int kColsumRows = 64;

// in (R, C) -> out (ceil(R / 64), C); C a multiple of 32. Block (32, 8):
// column blockIdx.x * 32 + tx, rows blockIdx.y * 64 + ty + 8 i.
__global__ void __launch_bounds__(256)
    colsum_kernel(const float* in, float* out, int R, int C) {
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int c = blockIdx.x * 32 + tx;
  const int r0 = blockIdx.y * kColsumRows;
  float s = 0.f;
#pragma unroll
  for (int i = ty; i < kColsumRows; i += 8) {
    const int r = r0 + i;
    if (r < R) s += in[static_cast<int64_t>(r) * C + c];
  }
  __shared__ float red[8][33];
  red[ty][tx] = s;
  __syncthreads();
  if (ty == 0) {
    float t = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) t += red[j][tx];
    out[static_cast<int64_t>(blockIdx.y) * C + c] = t;
  }
}

// Sums the R rows of `in` into `out` (C floats). `work` holds the
// intermediate rows: sum over the passes before the last of
// ceil(R / 64^p) * C floats (colsum_work_floats in ops/conv_bn.py).
inline int colsum(const float* in, float* work, float* out, int R, int C,
                  cudaStream_t stream) {
  const float* src = in;
  int r = R;
  while (true) {
    const int r1 = (r + kColsumRows - 1) / kColsumRows;
    float* dst = r1 == 1 ? out : work;
    colsum_kernel<<<dim3(C / 32, r1), dim3(32, 8), 0, stream>>>(src, dst,
                                                                r, C);
    const int err = static_cast<int>(cudaGetLastError());
    if (err != 0 || r1 == 1) return err;
    src = dst;
    work += static_cast<int64_t>(r1) * C;
    r = r1;
  }
}

}  // namespace zoo
