// Conv + BatchNorm forward for Hopper (sm_90a): one implicit-GEMM
// template shared by the 1x1 kernels (KS = 1) and the 3x3 SAME kernels
// (KS = 3), with two epilogues:
//
// - the eval fold (`matmul_bn_apply`, `conv3x3_bn_apply`):
//     y[m, n] = relu_out?( acc[m, n] * os[n] + ot[n] [+ res[m, n]] )
// - the training statistics (`matmul_bn`, `conv3x3_bn`):
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
// Replaces the TPU's Pallas kernels of analytics_zoo_tpu/ops/conv_bn.py:
// `_apply_kernel` (1x1 fold), `_kernel` (the 1x1 with statistics, called
// by `_matmul_bn_fwd_pallas`), and in f32 only `_conv3_apply_kernel`
// (3x3 fold) and `_conv3_kernel` (the 3x3 with statistics): the bf16
// 3x3s run the wgmma kernels of conv3x3_bn_sm90.cuh.
//
// Statistics across blocks: the TPU carries the column sums across a
// sequential grid; here blocks run in no order, so each block writes its
// 64 columns' partial sums into row blockIdx.x of a (gridDim.x, 2N)
// buffer (sums, then sums of squares), and colsum.cuh reduces the rows
// in a fixed order. The sums come from the f32 accumulator, never from
// the rounded y, and a run repeats bit for bit (no atomics).
//
// What bounds it on the H100: at ResNet-50's stage 0 (K = 64, N = 256)
// the 1x1 does 2*64*256 FLOP per row against (64 + 256) * 2 bytes of
// bf16 traffic, about 51 FLOP/byte, far below the tensor cores' bf16
// ridge of about 295 FLOP/byte, so on tensor cores it is bound by bytes.
// With f32 operands the product runs as f32 FMA, whose ridge is about 20
// FLOP/byte (67 TFLOP/s over 3.35 TB/s), and the same shapes are bound by
// operations; so are the 3x3s. The design keeps every intermediate out
// of device memory: the previous BN's apply + ReLU (and in training the
// deferred residual) runs while the A tile is staged into shared memory,
// and the epilogue (this BN's fold, residual and ReLU, or the column
// statistics) runs on the accumulators in registers while the tile is
// written, so each activation is read once and written once. It is a
// first, simple kernel: one 64x64 output tile per block, a K loop in
// 32-deep slices through shared memory without double buffering.
//
// Two math paths, chosen by the weight (compute) type:
// - bf16 weights (the 1x1s only): tensor cores through mma.sync
//   m16n8k16 bf16 with f32 accumulators; 4 warps, each a 32x32
//   sub-tile.
// - f32 weights: plain f32 FMA (not TF32, which would not match the
//   reference's full-f32 product); 256 threads, each a 4x4 sub-tile.
// Activations (x, in_res, res, y) are f32 or bf16 independently of the
// weights; scale, shift and statistics vectors are f32; the output has
// x's type.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// One 16-deep step of a warp's 32x32 sub-tile: A rows arow0 .. +31 and
// B rows (output columns) brow0 .. +31 of [row][k] shared tiles.
template <int LDS>
__device__ __forceinline__ void warp_mma_32x32(
    float (&acc)[2][4][4], const __nv_bfloat16 (*As)[LDS],
    const __nv_bfloat16 (*Bs)[LDS], int arow0, int brow0, int ks, int g,
    int t4) {
  uint32_t af[2][4];
  uint32_t bf[4][2];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    const int r = arow0 + mi * 16 + g;
    af[mi][0] = lds32(&As[r][ks + 2 * t4]);
    af[mi][1] = lds32(&As[r + 8][ks + 2 * t4]);
    af[mi][2] = lds32(&As[r][ks + 2 * t4 + 8]);
    af[mi][3] = lds32(&As[r + 8][ks + 2 * t4 + 8]);
  }
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int c = brow0 + ni * 8 + g;
    bf[ni][0] = lds32(&Bs[c][ks + 2 * t4]);
    bf[ni][1] = lds32(&Bs[c][ks + 2 * t4 + 8]);
  }
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], af[mi], bf[ni]);
}

// bf16 weights: tensor cores. 128 threads; warp (wm, wn) owns rows
// wm*32 .. +31 and columns wn*32 .. +31 of the 64x64 tile as 2 x 4
// m16n8 fragments. Shared rows are padded to 40 halves (80 bytes) so
// the fragment loads of a warp hit 32 distinct banks.
template <typename Tx, int KS, bool kStats>
__global__ void __launch_bounds__(128)
    conv_bn_bf16_kernel(ConvBnArgs a) {
  constexpr int kLds = kBK + 8;
  __shared__ __align__(16) __nv_bfloat16 As[kBM][kLds];
  __shared__ __align__(16) __nv_bfloat16 Bs[kBN][kLds];  // [n][k]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int wm = warp >> 1;
  const int wn = warp & 1;
  const int M = a.B * a.Ho * a.Wo;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int K = KS * KS * a.Cin;
  const Tx* x = static_cast<const Tx*>(a.x);
  const __nv_bfloat16* w = static_cast<const __nv_bfloat16*>(a.w);

  // staging roles: A row ar, channels ac..ac+15; W row bk, cols bn..+15
  const int ar = tid >> 1;
  const int ac = (tid & 1) * 16;
  const int bk = tid >> 2;
  const int bn = (tid & 3) * 16;
  const RowGeom geom = row_geom(a, m0 + ar, M);

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    float v[16];
    load_a<Tx, 16, KS>(a, x, geom, k0, ac, v);
    __align__(16) __nv_bfloat16 hv[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) hv[j] = __float2bfloat16(v[j]);
    *reinterpret_cast<uint4*>(&As[ar][ac]) =
        *reinterpret_cast<const uint4*>(&hv[0]);
    *reinterpret_cast<uint4*>(&As[ar][ac + 8]) =
        *reinterpret_cast<const uint4*>(&hv[8]);

    const uint4* wp = reinterpret_cast<const uint4*>(
        w + static_cast<int64_t>(k0 + bk) * a.N + n0 + bn);
    const uint4 w0 = wp[0];
    const uint4 w1 = wp[1];
    const __nv_bfloat16* we0 = reinterpret_cast<const __nv_bfloat16*>(&w0);
    const __nv_bfloat16* we1 = reinterpret_cast<const __nv_bfloat16*>(&w1);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      Bs[bn + j][bk] = we0[j];
      Bs[bn + 8 + j][bk] = we1[j];
    }
    __syncthreads();

#pragma unroll
    for (int ks = 0; ks < kBK; ks += 16)
      warp_mma_32x32<kLds>(acc, As, Bs, wm * 32, wn * 32, ks, g, t4);
    __syncthreads();
  }

  // epilogue in registers: fragment element (2h + e) sits at row
  // g + 8h, column 2*t4 + e of its m16n8 tile
  Tx* y = static_cast<Tx*>(a.y);
  if constexpr (!kStats) {
    const Tx* res = static_cast<const Tx*>(a.res);
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = n0 + wn * 32 + ni * 8 + 2 * t4;
      const float os0 = a.out_scale[col], os1 = a.out_scale[col + 1];
      const float ot0 = a.out_shift[col], ot1 = a.out_shift[col + 1];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = m0 + wm * 32 + mi * 16 + g + 8 * h;
          if (row >= M) continue;
          const int64_t off = static_cast<int64_t>(row) * a.N + col;
          float r0 = 0.f, r1 = 0.f;
          if (res != nullptr) {
            r0 = to_f32(res[off]);
            r1 = to_f32(res[off + 1]);
          }
          store2(y + off, epilogue(a, acc[mi][ni][2 * h], os0, ot0, r0),
                 epilogue(a, acc[mi][ni][2 * h + 1], os1, ot1, r1));
        }
      }
    }
  } else {
    // y, then each column's shifted sums over this thread's valid rows;
    // the 8 lanes sharing t4 (g = 0..7) reduce by a fixed butterfly, the
    // two row warps (wm) through shared memory in a fixed order
    __shared__ float red[2][2][kBN];  // [wm][sum, sumsq][column]
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = n0 + wn * 32 + ni * 8 + 2 * t4;
      const float sh[2] = {a.sh[col], a.sh[col + 1]};
      float cs[2] = {0.f, 0.f};
      float cq[2] = {0.f, 0.f};
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = m0 + wm * 32 + mi * 16 + g + 8 * h;
          if (row >= M) continue;
          const float v0 = acc[mi][ni][2 * h];
          const float v1 = acc[mi][ni][2 * h + 1];
          store2(y + static_cast<int64_t>(row) * a.N + col, v0, v1);
          const float d0 = v0 - sh[0];
          const float d1 = v1 - sh[1];
          cs[0] += d0;
          cq[0] += d0 * d0;
          cs[1] += d1;
          cq[1] += d1 * d1;
        }
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          cs[e] += __shfl_xor_sync(0xffffffffu, cs[e], off);
          cq[e] += __shfl_xor_sync(0xffffffffu, cq[e], off);
        }
        if (g == 0) {
          const int c = wn * 32 + ni * 8 + 2 * t4 + e;
          red[wm][0][c] = cs[e];
          red[wm][1][c] = cq[e];
        }
      }
    }
    __syncthreads();
    if (tid < kBN) {
      float* p = a.partial + static_cast<int64_t>(blockIdx.x) * 2 * a.N;
      p[n0 + tid] = red[0][0][tid] + red[1][0][tid];
      p[a.N + n0 + tid] = red[0][1][tid] + red[1][1][tid];
    }
  }
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

// Launches the GEMM on `stream` (grid: M tiles x N tiles); returns
// cudaGetLastError() so the caller can raise on a refused launch.
// Allocates nothing.
template <int KS, bool kStats>
inline int launch_conv_bn(const ConvBnArgs& a, int x_bf16, int w_bf16,
                          cudaStream_t stream) {
  const int M = a.B * a.Ho * a.Wo;
  const dim3 grid((M + kBM - 1) / kBM, a.N / kBN);
  if (w_bf16) {
    if (x_bf16)
      conv_bn_bf16_kernel<__nv_bfloat16, KS, kStats>
          <<<grid, 128, 0, stream>>>(a);
    else
      conv_bn_bf16_kernel<float, KS, kStats><<<grid, 128, 0, stream>>>(a);
  } else {
    if (x_bf16)
      conv_bn_f32_kernel<__nv_bfloat16, KS, kStats>
          <<<grid, 256, 0, stream>>>(a);
    else
      conv_bn_f32_kernel<float, KS, kStats><<<grid, 256, 0, stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
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
