// Backward of the training 1x1 conv + BN statistics (`matmul_bn`) for
// Hopper (sm_90a): the two products of its VJP, each one GEMM whose
// operands are computed while they are staged into shared memory.
//
// The statistics cotangents fold into one augmented cotangent
//     g[m, n] = dy[m, n] + dsum[n] + 2 (y[m, n] - sh[n]) dsq[n]
// which is recomputed per tile from dy and y (it never exists in device
// memory), and the forward's prologue
//     xa[m, k] = affine_in? x[m, k] s[k] + t[k] : x[m, k]  [+ r[m, k]]
//     xp[m, k] = relu_in? max(xa, 0) : xa
// is recomputed from x (it was never stored either). Then
// - dx kernel (replaces `_dx_kernel` of analytics_zoo_tpu/ops/conv_bn.py;
//   f32 here, bf16 in matmul_bn_dx_sm90.cuh):
//     dxp = mask(g @ W^T), mask = relu_in? xa > 0 : 1
//     dx = affine_in? dxp s : dxp;  dr = dxp;
//     ds[k] = sum_m dxp x,  dt[k] = sum_m dxp  (per-block partials)
// - dW kernel (replaces `_dw_kernel`; f32 here, bf16 in
//   matmul_bn_dw_sm90.cuh):
//     dW = xp^T @ g over all M rows, f32 accumulation
// Both products take g and xp rounded to the activation type (bf16
// operands on the tensor cores, or f32 FMA), as the reference does; the
// wrapper rounds dW to that type too.
//
// Reductions across blocks: the TPU carries ds/dt and dW across a
// sequential grid. Here ds/dt are written as one row of partials per
// block (gridDim.x, 2K), and dW splits the M reduction over gridDim.z
// (split-K: at ResNet-50's stage 0 dW is only 64x64 while M is 401,408
// rows at batch 128, so one block per output tile would leave 131 SMs
// idle); each split writes its (K, N) partial and colsum.cuh adds the
// partials in a fixed order. No atomics: a run repeats bit for bit.
// Rows past M are masked (g and xp are zero there), never padded, so no
// padding correction exists.
//
// What bounds it on the H100: both products have the forward's shape
// (2 M K N FLOP), the dx kernel reading dy, y (M, N) and x (M, K) and
// writing dx (M, K), the dW kernel reading the same three. On the f32
// FMA path (ridge about 20 FLOP/byte: 67 TFLOP/s over 3.35 TB/s) every
// ResNet-50 shape is bound by operations. The design reads each operand
// once per output tile and keeps g, xp and dxp in registers and shared
// memory only; a first, simple kernel: 64x64 output tiles, 32-deep
// slices through shared memory without double buffering, 256 threads
// of 4x4 FMA sub-tiles. The bf16 paths run on the tensor cores in the
// wgmma kernels of matmul_bn_dx_sm90.cuh and matmul_bn_dw_sm90.cuh.

#pragma once

#include "conv_bn_fwd.cuh"

namespace zoo {

struct BwdArgs {
  const void* dy;       // (M, N), Tx
  const void* y;        // (M, N), Tx
  const void* x;        // (M, K), Tx
  const void* w;        // (K, N), Tx
  const float* s;       // (K,), read only when affine_in
  const float* t;       // (K,)
  const void* r;        // (M, K), Tx, or null
  const float* sh;      // (N,)
  const float* dsum;    // (N,)
  const float* dsq;     // (N,)
  void* dx;             // (M, K), Tx
  void* dr;             // (M, K), Tx, or null
  float* partial;       // dx: (gridDim.x, 2K) or null; dW: (splits, K*N)
  int M, K, N;
  int affine_in, relu_in;
  int m_chunk;          // dW: rows per split, a multiple of kBK
};

// V consecutive values of g for row m, columns n .. n + V - 1.
template <typename Tx, int V>
__device__ __forceinline__ void load_g(const BwdArgs& a, int m, int n,
                                       float (&v)[V]) {
  const int64_t off = static_cast<int64_t>(m) * a.N + n;
  float dy[V], y[V];
  load_vec<Tx, V>(static_cast<const Tx*>(a.dy) + off, dy);
  load_vec<Tx, V>(static_cast<const Tx*>(a.y) + off, y);
#pragma unroll
  for (int j = 0; j < V; ++j)
    v[j] = (dy[j] + a.dsum[n + j]) + 2.f * (y[j] - a.sh[n + j]) *
                                         a.dsq[n + j];
}

// V consecutive values of xp for row m, columns k .. k + V - 1.
template <typename Tx, int V>
__device__ __forceinline__ void load_xp(const BwdArgs& a, int m, int k,
                                        float (&v)[V]) {
  const int64_t off = static_cast<int64_t>(m) * a.K + k;
  load_vec<Tx, V>(static_cast<const Tx*>(a.x) + off, v);
  if (a.affine_in) {
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = fmaf(v[j], a.s[k + j], a.t[k + j]);
  }
  if (a.r != nullptr) {
    float r[V];
    load_vec<Tx, V>(static_cast<const Tx*>(a.r) + off, r);
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] += r[j];
  }
  if (a.relu_in) {
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = fmaxf(v[j], 0.f);
  }
}

// The dx epilogue for one element: writes dx (and dr), returns dxp for
// the ds/dt sums through *dxp_out and x through *x_out.
template <typename Tx>
__device__ __forceinline__ void dx_element(const BwdArgs& a, int row,
                                           int col, float acc,
                                           float* dxp_out, float* x_out) {
  const int64_t off = static_cast<int64_t>(row) * a.K + col;
  const float xf = to_f32(static_cast<const Tx*>(a.x)[off]);
  // the mask's input rounded as the plain version rounds it (a product,
  // then each sum; no fused multiply-add), so both agree on its sign
  float xa = a.affine_in ? __fadd_rn(__fmul_rn(xf, a.s[col]), a.t[col])
                         : xf;
  if (a.r != nullptr)
    xa = __fadd_rn(xa, to_f32(static_cast<const Tx*>(a.r)[off]));
  const float dxp = (a.relu_in && !(xa > 0.f)) ? 0.f : acc;
  if (a.dr != nullptr) store1(static_cast<Tx*>(a.dr) + off, dxp);
  store1(static_cast<Tx*>(a.dx) + off, a.affine_in ? dxp * a.s[col] : dxp);
  *dxp_out = dxp;
  *x_out = xf;
}

// ---- dx = mask(g @ W^T): rows m, columns k, reduction over n ----------

__global__ void __launch_bounds__(256)
    conv_bn_dx_f32_kernel(BwdArgs a) {
  __shared__ __align__(16) float As[kBK][kBM + 4];  // g [n][m]
  __shared__ __align__(16) float Bs[kBK][kBN + 4];  // W [n][k]

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kBM;
  const int k0 = blockIdx.y * kBN;
  const float* w = static_cast<const float*>(a.w);
  const int sr = tid >> 2;           // staged row (m for A, k for B)
  const int sc = (tid & 3) * 8;      // staged columns (n) sc .. +7
  const bool row_ok = m0 + sr < a.M;
  const int ty = tid >> 4;
  const int tx = tid & 15;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int n0 = 0; n0 < a.N; n0 += kBK) {
    float v[8];
    if (row_ok) {
      load_g<float, 8>(a, m0 + sr, n0 + sc, v);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) As[sc + j][sr] = v[j];
    float wv[8];
    load_vec<float, 8>(w + static_cast<int64_t>(k0 + sr) * a.N + n0 + sc,
                       wv);
#pragma unroll
    for (int j = 0; j < 8; ++j) Bs[sc + j][sr] = wv[j];
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float ar4[4] = {av.x, av.y, av.z, av.w};
      const float br4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] = fmaf(ar4[i], br4[j], acc[i][j]);
    }
    __syncthreads();
  }

  __shared__ float red[2][16][kBN];  // [ds, dt][ty][column]
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float cs = 0.f, ct = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = m0 + ty * 4 + i;
      if (row >= a.M) continue;
      float dxp, xf;
      dx_element<float>(a, row, k0 + tx * 4 + j, acc[i][j], &dxp, &xf);
      cs += dxp * xf;
      ct += dxp;
    }
    red[0][ty][tx * 4 + j] = cs;
    red[1][ty][tx * 4 + j] = ct;
  }
  if (a.partial == nullptr) return;
  __syncthreads();
  if (tid < kBN) {
    float s = 0.f, q = 0.f;
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      s += red[0][r][tid];
      q += red[1][r][tid];
    }
    float* p = a.partial + static_cast<int64_t>(blockIdx.x) * 2 * a.K;
    p[k0 + tid] = s;
    p[a.K + k0 + tid] = q;
  }
}

// ---- dW partial = xp^T @ g over one split of M: rows k, columns n -----

__global__ void __launch_bounds__(256)
    conv_bn_dw_f32_kernel(BwdArgs a) {
  __shared__ __align__(16) float As[kBK][kBM + 4];  // xp [m][k]
  __shared__ __align__(16) float Bs[kBK][kBN + 4];  // g [m][n]

  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int mb = blockIdx.z * a.m_chunk;
  const int me = min(a.M, mb + a.m_chunk);
  const int sm = tid >> 3;           // staged reduction row (m) 0 .. 31
  const int sc = (tid & 7) * 8;      // staged columns (k or n) sc .. +7
  const int ty = tid >> 4;
  const int tx = tid & 15;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int m = mb; m < me; m += kBK) {
    float xv[8], gv[8];
    if (m + sm < me) {
      load_xp<float, 8>(a, m + sm, k0 + sc, xv);
      load_g<float, 8>(a, m + sm, n0 + sc, gv);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) xv[j] = gv[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < 8; j += 4) {
      *reinterpret_cast<float4*>(&As[sm][sc + j]) =
          make_float4(xv[j], xv[j + 1], xv[j + 2], xv[j + 3]);
      *reinterpret_cast<float4*>(&Bs[sm][sc + j]) =
          make_float4(gv[j], gv[j + 1], gv[j + 2], gv[j + 3]);
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float ar4[4] = {av.x, av.y, av.z, av.w};
      const float br4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] = fmaf(ar4[i], br4[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* p = a.partial + static_cast<int64_t>(blockIdx.z) * a.K * a.N;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      p[static_cast<int64_t>(k0 + ty * 4 + i) * a.N + n0 + tx * 4 + j] =
          acc[i][j];
}

}  // namespace zoo
