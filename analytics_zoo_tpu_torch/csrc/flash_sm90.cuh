// Pieces the flash-attention kernels for Hopper (sm_90a) share: the
// forward (flash_fwd_sm90.cuh: B7, B8) and the backward
// (flash_bwd_sm90.cuh: B9, B10) at head dims 64 and 128. A wait on a
// transaction barrier that traps instead of hanging, the 3-D tensor maps
// their bulk tensor copies (TMA) read q, k, v and dO through, and the
// f32 products as three tf32 passes on warpgroup MMA (wgmma): the
// hi/lo split of each operand, its A fragments and B tiles, and the
// k8 step that adds each step's fresh accumulator to an f32 sum with
// round-to-nearest (the tensor cores' own accumulation truncates).
// bf16: the A fragments of an accumulator and the hardware exp2.

#pragma once

#include <cuda.h>

#include "wgmma_sm90.cuh"

namespace zoo {
namespace fsm90 {

constexpr int kMaxSmem = 232448;   // a block's opt-in maximum on the H100

// sm90::mbar_wait, except that a phase that has not completed after
// about ten seconds traps (a launch error) instead of hanging the card.
__device__ __forceinline__ void wait(uint32_t bar, uint32_t parity) {
  const long long t0 = clock64();
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > 20000000000ll) __trap();
  }
}

// A 3-D tensor map over a (B, T, H*D) operand read in place (row
// stride st, batch stride sb, in elements), in boxes of `cols`
// elements (128 bytes) by `rows` rows, 128-byte swizzled. The encoded
// maps are kept per thread by shape and only moved to a new base
// (cuTensorMapReplaceAddress), as tensor_map_2d does.
inline int tensor_map_3d(CUtensorMap* map, const void* base, int esize,
                         int inner, int t, int b, long long st,
                         long long sb, int cols, int rows) {
  using Encode = CUresult (*)(
      CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
      const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
      const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
      CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  using Replace = CUresult (*)(CUtensorMap*, void*);
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  static Encode encode = nullptr;
  static Replace replace = nullptr;
  if (encode == nullptr || replace == nullptr) {
    void* fn[2] = {nullptr, nullptr};
    const char* names[2] = {"cuTensorMapEncodeTiled",
                            "cuTensorMapReplaceAddress"};
    for (int i = 0; i < 2; ++i) {
      cudaDriverEntryPointQueryResult found;
      const cudaError_t e = cudaGetDriverEntryPoint(names[i], &fn[i],
                                                    cudaEnableDefault, &found);
      if (e != cudaSuccess || found != cudaDriverEntryPointSuccess)
        return bad;
    }
    replace = reinterpret_cast<Replace>(fn[1]);
    encode = reinterpret_cast<Encode>(fn[0]);
  }
  if (b == 1) sb = st * t;   // a single batch's stride is never used
  struct Entry {
    CUtensorMap map;
    long long key[8];
  };
  constexpr int kEntries = 64;
  thread_local Entry cache[kEntries];
  thread_local int used = 0;
  const long long key[8] = {esize, inner, t, b, st, sb, cols, rows};
  for (int i = 0; i < used; ++i) {
    bool same = true;
    for (int f = 0; f < 8; ++f) same = same && cache[i].key[f] == key[f];
    if (same) {
      *map = cache[i].map;
      return replace(map, const_cast<void*>(base)) == CUDA_SUCCESS ? 0 : bad;
    }
  }
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(t),
                              static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(st) * esize,
                                 static_cast<cuuint64_t>(sb) * esize};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(cols),
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(
      map,
      esize == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      3, const_cast<void*>(base), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return bad;
  if (used < kEntries) {
    cache[used].map = *map;
    for (int f = 0; f < 8; ++f) cache[used].key[f] = key[f];
    ++used;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// f32: the tf32 split, fragments and the three-pass product
// ---------------------------------------------------------------------------

// v = hi + lo to within 2^-22 |v|: hi = tf32(v), lo = tf32(v - hi), both
// rounded to nearest with ties away from zero as cvt.rna.tf32 rounds
// (sm90::split_tf32), here by integer operations: half an ulp of tf32
// added to the magnitude's bits, the low 13 cleared. ptxas lowers the
// conversion to the same operations and a test for infinities; the
// operands here are finite, and the f32 kernels split every operand
// once per tile.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
  lo = (__float_as_uint(v - __uint_as_float(hi)) + 0x1000u) & 0xFFFFE000u;
}

// A raw f32 tile (D / 32 sub-tiles of R rows by 128 bytes, as TMA's
// 128-byte swizzle lays them out) into its transposed hi and lo tiles:
// R / 32 sub-tiles of D rows (the former columns) by 128 bytes, row d's
// chunk c holding rows 4 c .. 4 c + 3 of its 32 in the split order
// (logical p of each 8 is row 2 p, or 2 (p - 4) + 1 from p = 4). A warp
// takes 32 neighbouring d of one source row (distinct banks) and writes
// 32 rows' chunks (eight distinct per 128 bytes).
template <int D, int R, int NT>
__device__ __forceinline__ void split_transposed(const uint8_t* raw,
                                                 uint8_t* hi, uint8_t* lo,
                                                 int tid) {
#pragma unroll 2
  for (int it = tid; it < D * R / 4; it += NT) {
    const int d = it % D;
    const int jj = it / D;
    const int half = jj & 1;
    const int grp = jj >> 1;
    const uint8_t* src = raw + (d >> 5) * (R * 128) + (d & 3) * 4;
    const int cd = (d & 31) >> 2;
    uint32_t h4[4], l4[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = 8 * grp + 2 * e + half;
      const float v = *reinterpret_cast<const float*>(
          src + r * 128 + ((cd ^ (r & 7)) << 4));
      split_tf32(v, h4[e], l4[e]);
    }
    const int c = jj & 7;
    const int off = (jj >> 3) * (D * 128) + d * 128 + ((c ^ (d & 7)) << 4);
    *reinterpret_cast<uint4*>(hi + off) =
        make_uint4(h4[0], h4[1], h4[2], h4[3]);
    *reinterpret_cast<uint4*>(lo + off) =
        make_uint4(l4[0], l4[1], l4[2], l4[3]);
  }
}

// A raw f32 tile into hi (in place) and lo (beside it, the same layout).
template <int BYTES, int NT>
__device__ __forceinline__ void split_in_place(uint8_t* t, uint8_t* lo,
                                               int tid) {
#pragma unroll 2
  for (int off = tid * 16; off < BYTES; off += NT * 16) {
    const float4 v = *reinterpret_cast<const float4*>(t + off);
    uint32_t h[4], l[4];
    split_tf32(v.x, h[0], l[0]);
    split_tf32(v.y, h[1], l[1]);
    split_tf32(v.z, h[2], l[2]);
    split_tf32(v.w, h[3], l[3]);
    *reinterpret_cast<uint4*>(t + off) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(lo + off) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// The k8 A fragment of k8 step `st` (of D / 8) of a resident f32 tile
// (D / 32 sub-tiles of OWN rows by 128 swizzled bytes), split; `row` is
// this lane's ldmatrix row (16 q + lane % 16 within its warpgroup's
// rows): ldmatrix on f32 gives the tf32 fragment layout directly.
template <int OWN>
__device__ __forceinline__ void frag_smem(uint32_t (&hi)[4],
                                          uint32_t (&lo)[4], uint32_t res,
                                          int st, int row, int lane) {
  uint32_t v[4];
  const int ch = 2 * (st & 3) + (lane >> 4);
  sm90::ldsm_x4(res + (st >> 2) * (OWN * 128) + row * 128 +
                    ((ch ^ (row & 7)) << 4),
                v);
#pragma unroll
  for (int e = 0; e < 4; ++e)
    split_tf32(__uint_as_float(v[e]), hi[e], lo[e]);
}

// The k8 A fragment of accumulator columns 8 st .. 8 st + 7, split, in
// the split order of the transposed B tiles: d[4 st + e] holds columns
// 8 st + 2 t4 + (e & 1), which are the fragment's logical t4 and t4 + 4.
template <int N>
__device__ __forceinline__ void frag_acc(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                         const float (&d)[N], int st) {
  split_tf32(d[4 * st], hi[0], lo[0]);
  split_tf32(d[4 * st + 2], hi[1], lo[1]);
  split_tf32(d[4 * st + 1], hi[2], lo[2]);
  split_tf32(d[4 * st + 3], hi[3], lo[3]);
}

template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t desc, int scale_d) {
  static_assert(N == 32 || N == 64, "tf32 products are 32 or 64 wide");
  if constexpr (N == 64)
    sm90::wgmma_m64n64k8_tf32(d, a, desc, scale_d);
  else
    sm90::wgmma_m64n32k8_tf32(d, a, desc, scale_d);
}

__device__ __forceinline__ void fence_frag(uint32_t (&a)[4]) {
  asm volatile("" : "+r"(a[0]), "+r"(a[1]), "+r"(a[2]), "+r"(a[3])::"memory");
}

// One k8 step of two independent products x = A_x B_x and y = A_y B_y
// (64 x N), three tf32 passes each (lo hi, then hi lo, then hi hi; B's
// hi and lo tiles K-major at bxh, bxl and byh, byl, k8 steps kx, ky of
// their 128-byte rows), added
// into f32 sums with round-to-nearest: sx[ox + j] += x[j], sy[oy + j] +=
// y[j] (sy may be sx: then x is added first). The tensor cores add a
// step's products to an accumulator by truncation, so every step starts
// fresh accumulators: one truncation per 8 products, where a chain of
// k8 steps in one accumulator drifted to several times f32's error. At N
// 64 the step runs as two 32-column halves in two commit groups (B rows
// 32 .. 63 4096 bytes on), the first half's sums added while the second
// multiplies.
template <int N, int NX, int NY>
__device__ __forceinline__ void tf32x3_step(
    float (&sx)[NX], int ox, uint32_t (&xh)[4], uint32_t (&xl)[4],
    uint32_t bxh, uint32_t bxl, float (&sy)[NY], int oy, uint32_t (&yh)[4],
    uint32_t (&yl)[4], uint32_t byh, uint32_t byl, int kx, int ky) {
  constexpr int H = N == 64 ? 2 : 1;   // column halves
  constexpr int W = N / H;             // columns per commit group
  float x[H][W / 2], y[H][W / 2];
  fence_frag(xh);
  fence_frag(xl);
  fence_frag(yh);
  fence_frag(yl);
  sm90::wgmma_fence();
#pragma unroll
  for (int g = 0; g < H; ++g) {
    const uint32_t o = g * (W * 128);
    wgmma_tf32<W>(x[g], xl, sm90::kmajor_desc(bxh + o, kx), 0);
    wgmma_tf32<W>(y[g], yl, sm90::kmajor_desc(byh + o, ky), 0);
    wgmma_tf32<W>(x[g], xh, sm90::kmajor_desc(bxl + o, kx), 1);
    wgmma_tf32<W>(y[g], yh, sm90::kmajor_desc(byl + o, ky), 1);
    wgmma_tf32<W>(x[g], xh, sm90::kmajor_desc(bxh + o, kx), 1);
    wgmma_tf32<W>(y[g], yh, sm90::kmajor_desc(byh + o, ky), 1);
    sm90::wgmma_commit();
  }
#pragma unroll
  for (int g = 0; g < H; ++g) {
    if (g + 1 < H)
      sm90::wgmma_wait<1>();
    else
      sm90::wgmma_wait<0>();
    sm90::fence_regs(x[g]);
    sm90::fence_regs(y[g]);
#pragma unroll
    for (int j = 0; j < W / 2; ++j) {
      sx[ox + g * (W / 2) + j] += x[g][j];
      sy[oy + g * (W / 2) + j] += y[g][j];
    }
  }
}

// sx (64 x D) += FX BX and sy += FY BY: F the R-deep accumulators fx, fy
// (split into A fragments), B the transposed hi and lo tiles (R / 32
// sub-tiles of D rows), k8 step by k8 step and 64 columns of D at a
// time (tf32x3_step).
template <int D, int R>
__device__ __forceinline__ void tf32x3_into(
    float (&sx)[D / 2], const float (&fx)[R / 2], uint32_t bxh,
    uint32_t bxl, float (&sy)[D / 2], const float (&fy)[R / 2],
    uint32_t byh, uint32_t byl) {
#pragma unroll
  for (int st = 0; st < R / 8; ++st) {
    uint32_t xh[4], xl[4], yh[4], yl[4];
    frag_acc(xh, xl, fx, st);
    frag_acc(yh, yl, fy, st);
#pragma unroll
    for (int nc = 0; nc < D / 64; ++nc) {
      const uint32_t off = (st >> 2) * (D * 128) + nc * (64 * 128);
      tf32x3_step<64>(sx, nc * 32, xh, xl, bxh + off, bxl + off, sy,
                      nc * 32, yh, yl, byh + off, byl + off, st & 3, st & 3);
    }
  }
}

// sum (64 x D) += F B for one product (B10's dQ): two k8 steps at a time
// as the two products of tf32x3_step, added in order.
template <int D, int R>
__device__ __forceinline__ void tf32x3_into(float (&sum)[D / 2],
                                            const float (&f)[R / 2],
                                            uint32_t bh, uint32_t bl) {
  static_assert(R % 16 == 0, "k8 steps in pairs");
#pragma unroll
  for (int st = 0; st < R / 8; st += 2) {
    uint32_t xh[4], xl[4], yh[4], yl[4];
    frag_acc(xh, xl, f, st);
    frag_acc(yh, yl, f, st + 1);
#pragma unroll
    for (int nc = 0; nc < D / 64; ++nc) {
      const uint32_t ox = (st >> 2) * (D * 128) + nc * (64 * 128);
      const uint32_t oy = ((st + 1) >> 2) * (D * 128) + nc * (64 * 128);
      tf32x3_step<64>(sum, nc * 32, xh, xl, bh + ox, bl + ox, sum, nc * 32,
                      yh, yl, bh + oy, bl + oy, st & 3, (st + 1) & 3);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16
// ---------------------------------------------------------------------------

// The bf16 A fragments of a 64 x 16 N accumulator (k16 step kk: columns
// 16 kk ..), rounded: the accumulator's layout is the fragment's.
template <int N>
__device__ __forceinline__ void frags_bf16(uint32_t (&a)[N][4],
                                           const float (&d)[8 * N]) {
#pragma unroll
  for (int kk = 0; kk < N; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[kk][r] = sm90::pack_bf16x2(d[8 * kk + 2 * r], d[8 * kk + 2 * r + 1]);
}

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

}  // namespace fsm90
}  // namespace zoo
