// Conv + BatchNorm forward for Hopper (sm_90a), the f32 paths: one
// implicit-GEMM FMA template shared by the 1x1 kernels (KS = 1) and the
// 3x3 SAME kernels (KS = 3), with two epilogues:
//
// - the eval fold (`conv3x3_bn_apply` in f32):
//     y[m, n] = relu_out?( acc[m, n] * os[n] + ot[n] [+ res[m, n]] )
// - the training statistics (`matmul_bn`, `conv3x3_bn` in f32):
//     y[m, n] = acc[m, n], and per column n the partial sums
//     sum_m (acc - sh[n]) and sum_m (acc - sh[n])^2 of this block's rows
// where
//   acc[m, n] = sum_k A[m, k] * W[k, n]
//   A[m, (tap, c)] = relu_in?( affine_in? x[pixel(m, tap), c] * s[c] + t[c]
//                              [+ in_res[m, c]] )
//
// Rows m are output pixels (b, oy, ox) of an NHWC activation; the
// reduction runs over KS*KS taps times Cin channels and reads the HWIO
// weight as a (KS*KS*Cin, N) matrix. The A-tile loader computes each
// tap's input pixel itself and writes 0 where the tap falls outside the
// image, so the halo is zero AFTER the prologue (affine(0) = t never
// enters the sum). Rows past M are masked, not padded: they are neither
// stored nor counted in the statistics, so no padding correction exists.
//
// Replaces, in f32 only, the TPU's Pallas kernels of
// analytics_zoo_tpu/ops/conv_bn.py `_kernel` (the 1x1 with statistics,
// called by `_matmul_bn_fwd_pallas`), `_conv3_apply_kernel` (3x3 fold)
// and `_conv3_kernel` (the 3x3 with statistics). The bf16 paths run the
// wgmma kernels: matmul_bn_sm90.cuh (the 1x1, and the 1x1 fold with bf16
// weights), conv3x3_bn_sm90.cuh (the 3x3s); the 1x1 fold with f32
// weights runs matmul_bn_apply_sm90.cuh's tf32 split.
//
// Statistics across blocks: the TPU carries the column sums across a
// sequential grid; here blocks run in no order, so each block writes its
// 64 columns' partial sums into row blockIdx.x of a (gridDim.x, 2N)
// buffer (sums, then sums of squares), and colsum.cuh reduces the rows
// in a fixed order. The sums come from the f32 accumulator, never from
// the rounded y, and a run repeats bit for bit (no atomics).
//
// What bounds it on the H100: f32 operands run as f32 FMA, whose ridge
// is about 20 FLOP/byte (67 TFLOP/s over 3.35 TB/s), so ResNet-50's
// 1x1s (51 FLOP/byte and up) and 3x3s are bound by operations. The
// design keeps every intermediate out of device memory: the previous
// BN's apply + ReLU (and in training the deferred residual) runs while
// the A tile is staged into shared memory, and the epilogue (this BN's
// fold, or the column statistics) runs on the accumulators in registers
// while the tile is written, so each activation is read once and
// written once. It is a first, simple kernel: 256 threads, each a 4x4
// sub-tile of a 64x64 output tile, a K loop in 32-deep slices through
// shared memory without double buffering. (mma_bf16 and lds32 below
// serve the flash-attention kernels.)

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "last_launch.cuh"

namespace zoo {

struct ConvBnArgs {
  const void* x;            // (B, H, W, Cin), Tx
  const void* w;            // (KS*KS*Cin, N), compute type
  const float* in_scale;    // (Cin,), read only when affine_in
  const float* in_shift;    // (Cin,)
  const float* out_scale;   // (N,), fold epilogue
  const float* out_shift;   // (N,)
  const void* res;          // (M, N), Tx, or null: fold epilogue residual
  void* y;                  // (M, N), Tx
  int B, H, W, Cin, Ho, Wo, N;
  int stride, pad_t, pad_l;
  int affine_in, relu_in, relu_out;
  const void* in_res = nullptr;  // (M, Cin), Tx, or null: prologue
                                 // residual (KS = 1 only)
  const float* sh = nullptr;     // (N,): statistics shift
  float* partial = nullptr;      // (gridDim.x, 2N): statistics partials
};

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 32;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// V consecutive Tx values (V * sizeof(Tx) a multiple of 16 bytes, p
// 16-byte aligned) into f32 registers.
template <typename Tx, int V>
__device__ __forceinline__ void load_vec(const Tx* p, float (&out)[V]) {
  constexpr int kPer = 16 / sizeof(Tx);
#pragma unroll
  for (int i = 0; i < V / kPer; ++i) {
    const uint4 raw = reinterpret_cast<const uint4*>(p)[i];
    const Tx* e = reinterpret_cast<const Tx*>(&raw);
#pragma unroll
    for (int j = 0; j < kPer; ++j) out[i * kPer + j] = to_f32(e[j]);
  }
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a,
                                       float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store1(float* p, float a) { *p = a; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float a) {
  *p = __float2bfloat16(a);
}

// Where one output row's taps start in the input.
struct RowGeom {
  int64_t base;   // b * H
  int iy0, ix0;   // top-left input pixel of the window
  int m;          // the row
  bool ok;        // row < M
};

__device__ __forceinline__ RowGeom row_geom(const ConvBnArgs& a, int m,
                                            int M) {
  RowGeom g;
  g.ok = m < M;
  const int mm = g.ok ? m : 0;
  const int hw = a.Ho * a.Wo;
  const int b = mm / hw;
  const int rem = mm - b * hw;
  const int oy = rem / a.Wo;
  const int ox = rem - oy * a.Wo;
  g.base = static_cast<int64_t>(b) * a.H;
  g.iy0 = oy * a.stride - a.pad_t;
  g.ix0 = ox * a.stride - a.pad_l;
  g.m = mm;
  return g;
}

// V prologue-applied A values of one row for the K slice starting at
// k0 (a slice never crosses a tap: Cin is a multiple of 64), channels
// cq .. cq + V - 1 of the slice. Outside the image: zeros.
template <typename Tx, int V, int KS>
__device__ __forceinline__ void load_a(const ConvBnArgs& a, const Tx* x,
                                       const RowGeom& g, int k0, int cq,
                                       float (&v)[V]) {
  int c = k0 + cq;
  int iy = g.iy0;
  int ix = g.ix0;
  if (KS > 1) {
    const int tap = k0 / a.Cin;
    c -= tap * a.Cin;
    iy += tap / KS;
    ix += tap % KS;
  }
  if (!g.ok || iy < 0 || iy >= a.H || ix < 0 || ix >= a.W) {
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = 0.f;
    return;
  }
  load_vec<Tx, V>(x + ((g.base + iy) * a.W + ix) * a.Cin + c, v);
  if (a.affine_in) {
#pragma unroll
    for (int j = 0; j < V; ++j)
      v[j] = fmaf(v[j], a.in_scale[c + j], a.in_shift[c + j]);
  }
  if (KS == 1 && a.in_res != nullptr) {
    float r[V];
    load_vec<Tx, V>(static_cast<const Tx*>(a.in_res) +
                        static_cast<int64_t>(g.m) * a.Cin + c, r);
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] += r[j];
  }
  if (a.relu_in) {
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = fmaxf(v[j], 0.f);
  }
}

__device__ __forceinline__ float epilogue(const ConvBnArgs& a, float acc,
                                          float os, float ot, float r) {
  float y = fmaf(acc, os, ot) + r;
  return a.relu_out ? fmaxf(y, 0.f) : y;
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
        "r"(b[1]));
}

// f32 weights: plain FMA. 256 threads; thread (ty, tx) owns rows
// ty*4 .. +3 and columns tx*4 .. +3. A is staged k-major so a thread
// reads its 4 rows as one float4.
template <typename Tx, int KS, bool kStats>
__global__ void __launch_bounds__(256)
    conv_bn_f32_kernel(ConvBnArgs a) {
  __shared__ __align__(16) float As[kBK][kBM + 4];  // [k][m]
  __shared__ __align__(16) float Bs[kBK][kBN];      // [k][n]

  const int tid = threadIdx.x;
  const int M = a.B * a.Ho * a.Wo;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int K = KS * KS * a.Cin;
  const Tx* x = static_cast<const Tx*>(a.x);
  const float* w = static_cast<const float*>(a.w);

  const int ar = tid >> 2;
  const int ac = (tid & 3) * 8;
  const int bk = tid >> 3;
  const int bn = (tid & 7) * 8;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const RowGeom geom = row_geom(a, m0 + ar, M);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    float v[8];
    load_a<Tx, 8, KS>(a, x, geom, k0, ac, v);
#pragma unroll
    for (int j = 0; j < 8; ++j) As[ac + j][ar] = v[j];
    const float4* wp = reinterpret_cast<const float4*>(
        w + static_cast<int64_t>(k0 + bk) * a.N + n0 + bn);
    *reinterpret_cast<float4*>(&Bs[bk][bn]) = wp[0];
    *reinterpret_cast<float4*>(&Bs[bk][bn + 4]) = wp[1];
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

  Tx* y = static_cast<Tx*>(a.y);
  if constexpr (!kStats) {
    const Tx* res = static_cast<const Tx*>(a.res);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      const float os = a.out_scale[col];
      const float ot = a.out_shift[col];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = m0 + ty * 4 + i;
        if (row >= M) continue;
        const int64_t off = static_cast<int64_t>(row) * a.N + col;
        const float r = res != nullptr ? to_f32(res[off]) : 0.f;
        store1(y + off, epilogue(a, acc[i][j], os, ot, r));
      }
    }
  } else {
    // y, then per column the sums over this thread's valid rows, then
    // over the 16 row groups (ty) through shared memory in order
    __shared__ float red[2][16][kBN];  // [sum, sumsq][ty][column]
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      const float sh = a.sh[col];
      float cs = 0.f, cq = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = m0 + ty * 4 + i;
        if (row >= M) continue;
        store1(y + static_cast<int64_t>(row) * a.N + col, acc[i][j]);
        const float d = acc[i][j] - sh;
        cs += d;
        cq += d * d;
      }
      red[0][ty][tx * 4 + j] = cs;
      red[1][ty][tx * 4 + j] = cq;
    }
    __syncthreads();
    if (tid < kBN) {
      float s = 0.f, q = 0.f;
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        s += red[0][r][tid];
        q += red[1][r][tid];
      }
      float* p = a.partial + static_cast<int64_t>(blockIdx.x) * 2 * a.N;
      p[n0 + tid] = s;
      p[a.N + n0 + tid] = q;
    }
  }
}

inline ConvBnArgs make_args(const void* x, const void* w,
                            const void* in_scale, const void* in_shift,
                            const void* out_scale, const void* out_shift,
                            const void* res, void* y, int B, int H, int W,
                            int Cin, int Ho, int Wo, int N, int stride,
                            int pad_t, int pad_l, int affine_in,
                            int relu_in, int relu_out) {
  ConvBnArgs a;
  a.x = x;
  a.w = w;
  a.in_scale = static_cast<const float*>(in_scale);
  a.in_shift = static_cast<const float*>(in_shift);
  a.out_scale = static_cast<const float*>(out_scale);
  a.out_shift = static_cast<const float*>(out_shift);
  a.res = res;
  a.y = y;
  a.B = B;
  a.H = H;
  a.W = W;
  a.Cin = Cin;
  a.Ho = Ho;
  a.Wo = Wo;
  a.N = N;
  a.stride = stride;
  a.pad_t = pad_t;
  a.pad_l = pad_l;
  a.affine_in = affine_in;
  a.relu_in = relu_in;
  a.relu_out = relu_out;
  return a;
}

}  // namespace zoo
