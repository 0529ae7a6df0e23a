// The flash-attention backward for Hopper (sm_90a) on warpgroup MMA
// (wgmma), fed by bulk tensor copies (TMA): one kernel template per
// kernel for both operand types, at head dims 64 and 128.
//
// - `flash_bwd_dkdv` (B9): a block owns kOwn keys (one or two consumer
//   warpgroups of 64), keeps their K and V resident and walks the query
//   tiles that can see them:
//     S^T = K Q^T,  dP^T = V dO^T          (rows keys, columns queries)
//     dV += P^T dO, dK += dS^T Q
// - `flash_bwd_dq` (B10): a block owns kOwn query rows, keeps their Q
//   and dO resident and walks the key tiles they can see:
//     S = Q K^T,  dP = dO V^T,  dQ += dS K
// with p, ds, delta and the masks exactly as flash_attn_bwd.cuh's note
// states (p = exp(s - m) / max(l, 1e-30), not exp(s - lse); ds masked to
// 0; a row that sees no key gets no gradient). Each block owns its
// output tile: no atomics, the same bits every run.
//
// Replaces the TPU's Pallas kernels of analytics_zoo_tpu/ops/
// flash_attention.py `_bwd_dkdv_kernel[_masked]` and
// `_bwd_dq_kernel[_masked]` (called from `_flash_vjp_bwd`), at D 64
// and 128; D 32 and 256 keep flash_attn_bwd.cuh's kernels (`bwd_route`
// in ops/flash_attention.py names the route).
//
// What bounds it on the H100: B9 does 8 d and B10 6 d FLOP per visible
// (query, key) pair, far above the bytes (each operand is read once per
// tile of the other side, mostly from L2). bf16 runs on the tensor cores
// at 989 TFLOP/s. f32 keeps the reference's f32 products: each operand
// v is split into hi = tf32(v) and lo = tf32(v - hi), and a product is
// lo*hi + hi*lo + hi*hi, three tf32 passes at 495 TFLOP/s (a third of
// the FMA bound's time), dropping lo*lo (about 2^-22 of each term). The
// tensor cores add to an accumulator by truncation, so every k8 step
// (the small passes first) goes into a fresh accumulator that is added
// to an f32 sum with round-to-nearest (tf32x3_step): against the plain
// version in float64 the kernels' error is about the f32 plain
// version's. The flash_attn_bwd.cuh kernels it replaces at D 64 took
// 1.111 + 0.937 ms per f32 BERT-base launch (batch 16, T 512, FMA) and
// 0.460 + 0.239 in bf16 (mma.sync), against SDPA's backward's 1.199
// and 0.231 (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py).
//
// The design:
// - Tiles (Cfg; `bwd_tile` in ops/flash_attention.py): a block owns 64
//   rows per warpgroup and walks 64-row tiles. f32 at D 64 runs two
//   warpgroups, which share each tile's split; f32 at D 128 one, on
//   32-row tiles (the split tiles' shared memory); bf16 one, so that
//   two or three blocks share an SM (faster than two in one block).
// - Loads: warp 0 chooses the next tile that has work and its lane 0
//   issues the tile's bulk tensor copies (q, k, v, dO read in place
//   through 3-D tensor maps over (H D, T, B) with their strides, so
//   column slices of one projection need no copy) and the row
//   statistics or key mask by bulk copies, into a ring of two slots on
//   per-slot transaction barriers: the next tile lands while this one
//   multiplies. The slot's header words say which tile it holds (-1
//   when the walk is done) and, in B10, whether any of its keys is
//   padding. The resident operands land the same way.
// - Skipped tiles: causal tiles above the diagonal; in B10 a key tile
//   whose keys are all padding (its ds is 0); in B9 a query tile
//   against a block whose keys are all padding unless one of its rows
//   has m = -1e30 (a row that sees no unmasked key, whose uniform p
//   still feeds dV), the producer reading m as it chooses; a warpgroup
//   whose own 64 keys are all padding skips such tiles' products too.
// - P and dS (p_ds): tiles whose keys are all live and visible skip
//   every mask test; 1 / l once per row; bf16 takes the hardware exp2.
// - bf16: K (B9) or Q (B10) fragments by ldmatrix; the K-major B tiles
//   are the TMA boxes as they land (128-byte swizzle), and the same
//   tiles serve as MN-major B (the transpose bit) for dV += P^T dO,
//   dK += dS^T Q and dQ += dS K. P and dS go from the accumulators
//   straight into bf16 A fragments (FlashAttention-3's layout match).
// - f32: tf32 wgmma reads B only K-major, so once a tile lands the
//   block splits it: hi in place and lo beside it for the S and dP
//   products, and hi and lo transposed (queries or keys contiguous) for
//   dV, dK, dQ. The accumulator holds columns (2 t4, 2 t4 + 1) where a
//   tf32 A fragment wants (t4, t4 + 4), so the transposed tiles store
//   each 8 rows in that order (row p of each 8 holds 2 p, or 2 (p - 4)
//   + 1 from p = 4) and P and dS pass from registers to A fragments
//   without a shuffle. The split rounds by integer operations
//   (split_tf32).
// - What still holds f32 back: every k8 step waits for its products
//   (the sums' round-to-nearest), about 250 registers leave no room for
//   a second accumulator set, and the whole block splits each tile
//   while the tensor cores idle.

#pragma once

#include <cuda.h>

#include <type_traits>

#include "flash_attn_bwd.cuh"
#include "wgmma_sm90.cuh"

namespace zoo {
namespace fbwd {

using flash::BwdArgs;
using flash::kNegInf;
using sm90::smem_u32;

constexpr int kMaxSmem = 232448;   // a block's opt-in maximum on the H100

// kDkDv: B9 (owns keys, walks query tiles), else B10 (owns query rows,
// walks key tiles). T: the operand type.
template <bool kDkDv, typename T, int D>
struct Cfg {
  static constexpr bool kF32 = sizeof(T) == 4;
  // warpgroups: f32 two (they share the tile's split) but one at D 128
  // (shared memory); bf16 one, so that two or three blocks share an SM
  static constexpr int kWG = kF32 && D == 64 ? 2 : 1;
  static constexpr int kOwn = 64 * kWG;                  // rows owned
  static constexpr int kRows = kF32 && D == 128 ? 32 : 64;   // walked
  static constexpr int kThreads = 128 * kWG;
  static constexpr int kBox = 128 / sizeof(T);    // elements per 128 B
  static constexpr int kSub = D / kBox;           // 128-byte sub-tiles
  static constexpr int kOwnBytes = kOwn * D * sizeof(T);
  static constexpr int kTileBytes = kRows * D * sizeof(T);
  static constexpr int kSplitBytes = kRows * D * 4;
  // f32 split tiles: B9 q_lo, o_lo, q^T hi/lo, o^T hi/lo; B10 k_lo,
  // v_lo, k^T hi/lo
  static constexpr int kNSplit = kF32 ? (kDkDv ? 6 : 4) : 0;
  // per slot: m, l, delta of the query tile (B9); the key mask (B10)
  static constexpr int kStatFloats = kDkDv ? 3 * kRows : kRows;
  // layout (every tile 1024-byte aligned): the two resident operands,
  // the ring's two slots of two tiles, the split tiles, the slots'
  // statistics, their header words, per-warp flags, three barriers
  static constexpr int kRing = 2 * kOwnBytes;
  static constexpr int kSplit = kRing + 4 * kTileBytes;
  static constexpr int kStats = kSplit + kNSplit * kSplitBytes;
  static constexpr int kHdr = kStats + 2 * kStatFloats * 4;
  static constexpr int kFlags = kHdr + 16;
  static constexpr int kBars = kFlags + 32;
  static constexpr int kSmem = kBars + 24 + 1024;   // + alignment slack
  static_assert(kSmem <= kMaxSmem, "the tiles must fit shared memory");
  static_assert(kRows % 32 == 0 && D % 64 == 0, "tile shapes");
};

struct Maps {
  CUtensorMap q, k, v, o;   // o: dO
};

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

// s (64 x R) = A0 B0 and dp = A1 B1, A the resident tiles' rows (res0,
// res1), B the walked tiles' hi and lo (K-major, D / 32 sub-tiles of R
// rows), k8 step by k8 step (tf32x3_step).
template <int D, int R, int OWN>
__device__ __forceinline__ void tf32x3_rows(
    float (&s)[R / 2], float (&dp)[R / 2], uint32_t res0, uint32_t res1,
    int row, int lane, uint32_t b0h, uint32_t b0l, uint32_t b1h,
    uint32_t b1l) {
#pragma unroll
  for (int i = 0; i < R / 2; ++i) s[i] = dp[i] = 0.f;
#pragma unroll
  for (int st = 0; st < D / 8; ++st) {
    uint32_t xh[4], xl[4], yh[4], yl[4];
    frag_smem<OWN>(xh, xl, res0, st, row, lane);
    frag_smem<OWN>(yh, yl, res1, st, row, lane);
    const uint32_t off = (st >> 2) * (R * 128);
    tf32x3_step<R>(s, 0, xh, xl, b0h + off, b0l + off, dp, 0, yh, yl,
                   b1h + off, b1l + off, st & 3, st & 3);
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

// S (64 x 64) = A (the resident tile's rows by ldmatrix) B (D x 64: the
// walked tile, K-major, D / 64 sub-tiles of 64 rows), for two products
// at once (s from res0 and b0, dp from res1 and b1).
template <int D, int OWN>
__device__ __forceinline__ void bf16_rows(float (&s)[32], float (&dp)[32],
                                          uint32_t res0, uint32_t res1,
                                          int row, int lane, uint32_t b0,
                                          uint32_t b1) {
  uint32_t f0[4][4], f1[4][4];
#pragma unroll
  for (int c = 0; c < D / 64; ++c) {
    sm90::load_fragments(f0, res0 + c * (OWN * 128), row, lane, true, true);
    sm90::load_fragments(f1, res1 + c * (OWN * 128), row, lane, true, true);
    sm90::fence_regs(f0);
    sm90::fence_regs(f1);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      sm90::wgmma_tile<64, 0>(s, f0[kk],
                              sm90::kmajor_desc(b0 + c * (64 * 128), kk),
                              c > 0 || kk > 0);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      sm90::wgmma_tile<64, 0>(dp, f1[kk],
                              sm90::kmajor_desc(b1 + c * (64 * 128), kk),
                              c > 0 || kk > 0);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
  }
  sm90::fence_regs(s);
  sm90::fence_regs(dp);
}

// The bf16 A fragments of a 64 x 64 accumulator (k16 step kk: columns
// 16 kk ..), rounded: the accumulator's layout is the fragment's.
__device__ __forceinline__ void frags_bf16(uint32_t (&a)[4][4],
                                           const float (&d)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
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

// The softmax constants of one query row: m, m log2(e) (bf16's exp is
// the hardware exp2), 1 / max(l, 1e-30) and delta.
struct RowStat {
  float m, m2, rl, delta;
};

template <bool kF32>
__device__ __forceinline__ RowStat row_stat(float m, float l, float delta) {
  const float lc = fmaxf(l, 1e-30f);
  return {m, m * kLog2e, kF32 ? 1.f / lc : __fdividef(1.f, lc), delta};
}

// One element of P and dS in place of its raw logit s and dO . v (dp),
// as the plain version forms them: p = exp(s scale - m) / max(l, 1e-30),
// 0 where the key is causally invisible (vis false); ds = p (dp - delta)
// scale, 0 where the key is also padding (ok false: its logit -1e30, so
// a row that sees only padding keys averages them). f32 takes the
// accurate expf (the reference's f32 softmax), bf16 the hardware exp2
// (p is rounded to bf16 next). kMasked false: every key is visible and
// live, and no test is made.
template <bool kF32, bool kMasked>
__device__ __forceinline__ void p_ds(float& s, float& dp, float scale,
                                     float sl2, const RowStat& r, bool vis,
                                     bool ok) {
  float e;
  if constexpr (kF32)
    e = expf(((kMasked && !ok) ? kNegInf : s * scale) - r.m);
  else
    e = exp2_approx((kMasked && !ok) ? (kNegInf - r.m) * kLog2e
                                     : fmaf(s, sl2, -r.m2));
  const float p = (kMasked && !vis) ? 0.f : e * r.rl;
  dp = (kMasked && !ok) ? 0.f : p * (dp - r.delta) * scale;
  s = p;
}

// ---------------------------------------------------------------------------
// B9: dK, dV
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(Cfg<true, T, D>::kThreads, 1)
    flash_dkdv_sm90_kernel(BwdArgs a, const __grid_constant__ Maps maps) {
  using C = Cfg<true, T, D>;
  constexpr bool kF32 = C::kF32;
  constexpr int R = C::kRows;    // query rows per walked tile
  constexpr int NT = C::kThreads;
  extern __shared__ uint8_t smem_raw[];
  // 1024-byte aligned (the 128-byte swizzle's period), kept in the
  // shared window so that plain loads from it are shared loads
  uint8_t* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t sb = smem_u32(smem);
  volatile int* hdr = reinterpret_cast<volatile int*>(smem + C::kHdr);
  int* flags = reinterpret_cast<int*>(smem + C::kFlags);
  const uint32_t bars = sb + C::kBars;   // slot 0, slot 1, resident

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wg = tid >> 7;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int k0 = blockIdx.x * C::kOwn;
  const int b = blockIdx.y / a.H;
  const int h = blockIdx.y - b * a.H;

  // this thread's key rows (local kl, kl + 8) and their mask; whether
  // this warpgroup's and the block's keys have any that is not padding
  const int kl = 64 * wg + 16 * (warp & 3) + g;
  float km[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
    km[hh] = a.kmask == nullptr
                 ? 1.f
                 : a.kmask[static_cast<long long>(b) * a.Tk + k0 + kl +
                           8 * hh];
  const unsigned live =
      __ballot_sync(~0u, km[0] > 0.f || km[1] > 0.f);
  const unsigned all = __ballot_sync(~0u, km[0] > 0.f && km[1] > 0.f);
  if (lane == 0) flags[warp] = (live != 0u) | (all == ~0u ? 2 : 0);
  if (tid == 0) {
    for (int i = 0; i < 3; ++i) sm90::mbar_init(bars + 8 * i);
    sm90::mbar_init_fence();
  }
  __syncthreads();
  bool wg_live = false, block_live = false, wg_full = true;
#pragma unroll
  for (int w = 0; w < NT / 32; ++w) {
    block_live |= (flags[w] & 1) != 0;
    if (w / 4 == wg) {
      wg_live |= (flags[w] & 1) != 0;
      wg_full &= (flags[w] & 2) != 0;
    }
  }
  if (tid == 0) {   // K and V, resident
    const uint32_t bar = bars + 16;
    sm90::mbar_expect(bar, 2 * C::kOwnBytes);
#pragma unroll
    for (int c = 0; c < C::kSub; ++c) {
      sm90::tma_load_3d(sb + c * (C::kOwn * 128), &maps.k,
                        h * D + c * C::kBox, k0, b, bar);
      sm90::tma_load_3d(sb + C::kOwnBytes + c * (C::kOwn * 128), &maps.v,
                        h * D + c * C::kBox, k0, b, bar);
    }
  }

  // Warp 0 chooses the next query tile that has work and issues its
  // copies into slot j & 1 (header -1: none left).
  int next = flash::first_q(a, k0) / R * R;
  auto issue = [&](int j) {
    const int slot = j & 1;
    int q0 = -1;
    while (next < a.Tq) {
      const int cand = next;
      next += R;
      bool take = block_live;
      if (!take) {   // all keys padding: only rows with m = -1e30 add
        bool dead = false;
        for (int r = lane; r < R; r += 32)
          dead |= a.m[flash::stat_idx(a, b, h, cand + r)] == kNegInf;
        take = __any_sync(~0u, dead);
      }
      if (take) {
        q0 = cand;
        break;
      }
    }
    if (lane == 0) {
      hdr[slot] = q0;
      const uint32_t bar = bars + 8 * slot;
      if (q0 < 0) {
        sm90::mbar_arrive(bar);
      } else {
        const uint32_t dst = sb + C::kRing + slot * (2 * C::kTileBytes);
        sm90::mbar_expect(bar, 2 * C::kTileBytes + 3 * R * 4);
#pragma unroll
        for (int c = 0; c < C::kSub; ++c) {
          sm90::tma_load_3d(dst + c * (R * 128), &maps.q,
                            h * D + c * C::kBox, q0, b, bar);
          sm90::tma_load_3d(dst + C::kTileBytes + c * (R * 128), &maps.o,
                            h * D + c * C::kBox, q0, b, bar);
        }
        const uint32_t sd = sb + C::kStats + slot * (C::kStatFloats * 4);
        const long long si = flash::stat_idx(a, b, h, q0);
        sm90::bulk_load(sd, a.m + si, R * 4, bar);
        sm90::bulk_load(sd + R * 4, a.l + si, R * 4, bar);
        sm90::bulk_load(sd + 2 * R * 4, a.delta + si, R * 4, bar);
      }
    }
  };
  if (warp == 0) {
    issue(0);
    issue(1);
  }

  // f32: running sums; bf16: the wgmma accumulators themselves
  float dvs[D / 2], dks[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dvs[i] = dks[i] = 0.f;
  bool started = false;
  const float sl2 = a.scale * kLog2e;
  const int arow = 64 * wg + 16 * (warp & 3) + (lane & 15);
  const uint32_t kres = sb;
  const uint32_t vres = sb + C::kOwnBytes;
  wait(bars + 16, 0);

  for (int j = 0;; ++j) {
    const int slot = j & 1;
    wait(bars + 8 * slot, (j >> 1) & 1);
    const int q0 = hdr[slot];
    if (q0 < 0) break;
    uint8_t* qt = smem + C::kRing + slot * (2 * C::kTileBytes);
    uint8_t* ot = qt + C::kTileBytes;
    const float* ms = reinterpret_cast<const float*>(
        smem + C::kStats + slot * (C::kStatFloats * 4));
    const float* ls = ms + R;
    const float* dl = ms + 2 * R;
    uint8_t* sp = smem + C::kSplit;
    constexpr int S = C::kSplitBytes;
    if constexpr (kF32) {
      split_transposed<D, R, NT>(qt, sp + 2 * S, sp + 3 * S, tid);
      split_transposed<D, R, NT>(ot, sp + 4 * S, sp + 5 * S, tid);
      __syncthreads();
      split_in_place<C::kTileBytes, NT>(qt, sp, tid);
      split_in_place<C::kTileBytes, NT>(ot, sp + S, tid);
      sm90::fence_proxy_async();
      __syncthreads();
    }
    bool dead = false;
    for (int r = lane; r < R; r += 32) dead |= ms[r] == kNegInf;
    if (wg_live || __any_sync(~0u, dead)) {
      const uint32_t qhi = smem_u32(qt);
      const uint32_t ohi = smem_u32(ot);
      const uint32_t spb = smem_u32(sp);
      float s[R / 2], dp[R / 2];
      if constexpr (kF32)
        tf32x3_rows<D, R, C::kOwn>(s, dp, kres, vres, arow, lane, qhi, spb,
                                   ohi, spb + S);
      else
        bf16_rows<D, C::kOwn>(s, dp, kres, vres, arow, lane, qhi, ohi);
      // P^T and dS^T in place: rows keys kl, kl + 8; columns queries
      // 8 i + 2 t4 (+1); no masks where every key of this warpgroup is
      // live and visible to every query of the tile
      auto pds = [&](auto masked) {
        constexpr bool kM = decltype(masked)::value;
#pragma unroll
        for (int i = 0; i < R / 8; ++i) {
          const int qc = 8 * i + 2 * t4;
          const float2 m2 = *reinterpret_cast<const float2*>(ms + qc);
          const float2 l2 = *reinterpret_cast<const float2*>(ls + qc);
          const float2 d2 = *reinterpret_cast<const float2*>(dl + qc);
          const RowStat rs[2] = {row_stat<kF32>(m2.x, l2.x, d2.x),
                                 row_stat<kF32>(m2.y, l2.y, d2.y)};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int hh = e >> 1;
            const int c = e & 1;
            bool vis = true, ok = true;
            if constexpr (kM) {
              vis = !a.causal || q0 + qc + c + a.off >= k0 + kl + 8 * hh;
              ok = vis && km[hh] > 0.f;
            }
            p_ds<kF32, kM>(s[4 * i + e], dp[4 * i + e], a.scale, sl2,
                           rs[c], vis, ok);
          }
        }
      };
      if (wg_full && (!a.causal || q0 + a.off >= k0 + 64 * wg + 63))
        pds(std::false_type{});
      else
        pds(std::true_type{});
      if constexpr (kF32) {
        tf32x3_into<D, R>(dvs, s, spb + 4 * S, spb + 5 * S, dks, dp,
                          spb + 2 * S, spb + 3 * S);
      } else {
        uint32_t pf[4][4], df[4][4];
        frags_bf16(pf, s);
        frags_bf16(df, dp);
        sm90::fence_regs(pf);
        sm90::fence_regs(df);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          sm90::wgmma_tile<D, 1>(dvs, pf[kk], sm90::btile_desc(ohi, kk),
                                 started || kk > 0);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          sm90::wgmma_tile<D, 1>(dks, df[kk], sm90::btile_desc(qhi, kk),
                                 started || kk > 0);
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(dvs);
        sm90::fence_regs(dks);
        started = true;
      }
    }
    __syncthreads();   // the slot and the split tiles are free again
    if (warp == 0) issue(j + 2);
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const long long base =
        flash::out_idx(b, a.Tk, a.H, k0 + kl + 8 * hh, h, D);
    T* dkp = static_cast<T*>(a.dk) + base;
    T* dvp = static_cast<T*>(a.dv) + base;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      store2(dkp + 8 * i + 2 * t4, dks[4 * i + 2 * hh],
             dks[4 * i + 2 * hh + 1]);
      store2(dvp + 8 * i + 2 * t4, dvs[4 * i + 2 * hh],
             dvs[4 * i + 2 * hh + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// B10: dQ
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(Cfg<false, T, D>::kThreads, 1)
    flash_dq_sm90_kernel(BwdArgs a, const __grid_constant__ Maps maps) {
  using C = Cfg<false, T, D>;
  constexpr bool kF32 = C::kF32;
  constexpr int R = C::kRows;    // keys per walked tile
  constexpr int NT = C::kThreads;
  extern __shared__ uint8_t smem_raw[];
  // 1024-byte aligned (the 128-byte swizzle's period), kept in the
  // shared window so that plain loads from it are shared loads
  uint8_t* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t sb = smem_u32(smem);
  volatile int* hdr = reinterpret_cast<volatile int*>(smem + C::kHdr);
  const uint32_t bars = sb + C::kBars;   // slot 0, slot 1, resident

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wg = tid >> 7;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int q0 = blockIdx.x * C::kOwn;
  const int b = blockIdx.y / a.H;
  const int h = blockIdx.y - b * a.H;

  // this thread's query rows (local ql, ql + 8) and their statistics
  const int ql = 64 * wg + 16 * (warp & 3) + g;
  RowStat rs[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const long long si = flash::stat_idx(a, b, h, q0 + ql + 8 * hh);
    rs[hh] = row_stat<kF32>(a.m[si], a.l[si], a.delta[si]);
  }
  const float sl2 = a.scale * kLog2e;
  if (tid == 0) {
    for (int i = 0; i < 3; ++i) sm90::mbar_init(bars + 8 * i);
    sm90::mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {   // Q and dO, resident
    const uint32_t bar = bars + 16;
    sm90::mbar_expect(bar, 2 * C::kOwnBytes);
#pragma unroll
    for (int c = 0; c < C::kSub; ++c) {
      sm90::tma_load_3d(sb + c * (C::kOwn * 128), &maps.q,
                        h * D + c * C::kBox, q0, b, bar);
      sm90::tma_load_3d(sb + C::kOwnBytes + c * (C::kOwn * 128), &maps.o,
                        h * D + c * C::kBox, q0, b, bar);
    }
  }

  // Warp 0 chooses the next key tile that is visible and not all
  // padding and issues its copies into slot j & 1 (header -1: none).
  const int k_end = flash::key_end(a, q0, C::kOwn);
  const float* kmask = a.kmask == nullptr
                           ? nullptr
                           : a.kmask + static_cast<long long>(b) * a.Tk;
  int next = 0;
  auto issue = [&](int j) {
    const int slot = j & 1;
    int k0 = -1;
    bool full = true;   // no key of the tile is padding
    while (next < k_end) {
      const int cand = next;
      next += R;
      bool take = kmask == nullptr;
      if (!take) {
        bool live = false, all = true;
        for (int r = lane; r < R; r += 32) {
          live |= kmask[cand + r] > 0.f;
          all &= kmask[cand + r] > 0.f;
        }
        take = __any_sync(~0u, live);
        full = __all_sync(~0u, all);
      }
      if (take) {
        k0 = cand;
        break;
      }
    }
    if (lane == 0) {
      hdr[slot] = k0;
      hdr[2 + slot] = full;
      const uint32_t bar = bars + 8 * slot;
      if (k0 < 0) {
        sm90::mbar_arrive(bar);
      } else {
        const uint32_t dst = sb + C::kRing + slot * (2 * C::kTileBytes);
        sm90::mbar_expect(bar, 2 * C::kTileBytes +
                                   (kmask == nullptr ? 0 : R * 4));
#pragma unroll
        for (int c = 0; c < C::kSub; ++c) {
          sm90::tma_load_3d(dst + c * (R * 128), &maps.k,
                            h * D + c * C::kBox, k0, b, bar);
          sm90::tma_load_3d(dst + C::kTileBytes + c * (R * 128), &maps.v,
                            h * D + c * C::kBox, k0, b, bar);
        }
        if (kmask != nullptr)
          sm90::bulk_load(sb + C::kStats + slot * (C::kStatFloats * 4),
                          kmask + k0, R * 4, bar);
      }
    }
  };
  if (warp == 0) {
    issue(0);
    issue(1);
  }

  float dqs[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dqs[i] = 0.f;
  bool started = false;
  const int arow = 64 * wg + 16 * (warp & 3) + (lane & 15);
  const uint32_t qres = sb;
  const uint32_t ores = sb + C::kOwnBytes;
  wait(bars + 16, 0);

  for (int j = 0;; ++j) {
    const int slot = j & 1;
    wait(bars + 8 * slot, (j >> 1) & 1);
    const int k0 = hdr[slot];
    if (k0 < 0) break;
    uint8_t* kt = smem + C::kRing + slot * (2 * C::kTileBytes);
    uint8_t* vt = kt + C::kTileBytes;
    const float* kms = reinterpret_cast<const float*>(
        smem + C::kStats + slot * (C::kStatFloats * 4));
    uint8_t* sp = smem + C::kSplit;
    constexpr int S = C::kSplitBytes;
    if constexpr (kF32) {   // k_lo, v_lo, k^T hi, k^T lo
      split_transposed<D, R, NT>(kt, sp + 2 * S, sp + 3 * S, tid);
      split_in_place<C::kTileBytes, NT>(vt, sp + S, tid);
      __syncthreads();
      split_in_place<C::kTileBytes, NT>(kt, sp, tid);
      sm90::fence_proxy_async();
      __syncthreads();
    }
    const uint32_t khi = smem_u32(kt);
    const uint32_t vhi = smem_u32(vt);
    const uint32_t spb = smem_u32(sp);
    float s[R / 2], dp[R / 2];
    if constexpr (kF32)
      tf32x3_rows<D, R, C::kOwn>(s, dp, qres, ores, arow, lane, khi, spb,
                                 vhi, spb + S);
    else
      bf16_rows<D, C::kOwn>(s, dp, qres, ores, arow, lane, khi, vhi);
    // dS in place of dP: rows queries ql, ql + 8; columns keys; no masks
    // where no key of the tile is padding and each is visible to every
    // row of this warpgroup
    auto pds = [&](auto masked) {
      constexpr bool kM = decltype(masked)::value;
#pragma unroll
      for (int i = 0; i < R / 8; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hh = e >> 1;
          const int kc = 8 * i + 2 * t4 + (e & 1);
          bool vis = true, ok = true;
          if constexpr (kM) {
            vis = !a.causal || q0 + ql + 8 * hh + a.off >= k0 + kc;
            ok = vis && (kmask == nullptr || kms[kc] > 0.f);
          }
          p_ds<kF32, kM>(s[4 * i + e], dp[4 * i + e], a.scale, sl2, rs[hh],
                         vis, ok);
        }
      }
    };
    if (hdr[2 + slot] != 0 &&
        (!a.causal || q0 + 64 * wg + a.off >= k0 + R - 1))
      pds(std::false_type{});
    else
      pds(std::true_type{});
    if constexpr (kF32) {
      tf32x3_into<D, R>(dqs, dp, spb + 2 * S, spb + 3 * S);
    } else {
      uint32_t df[4][4];
      frags_bf16(df, dp);
      sm90::fence_regs(df);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        sm90::wgmma_tile<D, 1>(dqs, df[kk], sm90::btile_desc(khi, kk),
                               started || kk > 0);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dqs);
      started = true;
    }
    __syncthreads();   // the slot and the split tiles are free again
    if (warp == 0) issue(j + 2);
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    T* dqp = static_cast<T*>(a.dq) +
             flash::out_idx(b, a.Tq, a.H, q0 + ql + 8 * hh, h, D);
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      store2(dqp + 8 * i + 2 * t4, dqs[4 * i + 2 * hh],
             dqs[4 * i + 2 * hh + 1]);
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

// Launches B9 (kDkDv) or B10 at one instance; returns an error code.
template <bool kDkDv, typename T, int D>
inline int launch_sm90(const BwdArgs& a, cudaStream_t stream) {
  using C = Cfg<kDkDv, T, D>;
  constexpr int es = sizeof(T);
  // boxes: the owned operands kOwn rows, the walked ones kRows
  constexpr int q_rows = kDkDv ? C::kRows : C::kOwn;
  constexpr int k_rows = kDkDv ? C::kOwn : C::kRows;
  const int inner = a.H * D;
  Maps maps;
  int err = tensor_map_3d(&maps.q, a.q, es, inner, a.Tq, a.B, a.q_st,
                          a.q_sb, C::kBox, q_rows);
  err |= tensor_map_3d(&maps.o, a.dout, es, inner, a.Tq, a.B, a.do_st,
                       a.do_sb, C::kBox, q_rows);
  err |= tensor_map_3d(&maps.k, a.k, es, inner, a.Tk, a.B, a.k_st, a.k_sb,
                       C::kBox, k_rows);
  err |= tensor_map_3d(&maps.v, a.v, es, inner, a.Tk, a.B, a.v_st, a.v_sb,
                       C::kBox, k_rows);
  if (err != 0) return err;
  void (*kernel)(BwdArgs, const Maps);
  if constexpr (kDkDv)
    kernel = flash_dkdv_sm90_kernel<T, D>;
  else
    kernel = flash_dq_sm90_kernel<T, D>;
  static int allowed = 0;   // the shared memory this instance allows
  if (C::kSmem > allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    allowed = C::kSmem;
  }
  const dim3 grid((kDkDv ? a.Tk : a.Tq) / C::kOwn, a.B * a.H);
  kernel<<<grid, C::kThreads, C::kSmem, stream>>>(a, maps);
  return static_cast<int>(cudaGetLastError());
}

// Launches B9 (kDkDv) or B10 on `stream`, on the kernels above at D 64
// and 128 (`bwd_route` in ops/flash_attention.py), else on
// flash_attn_bwd.cuh's; returns an error code.
template <bool kDkDv>
inline int launch(const BwdArgs& a, int D, int bf16, cudaStream_t stream) {
  const int rows = kDkDv ? a.Tk : a.Tq;   // the owned side
  if (rows == 0 || a.B * a.H == 0) return 0;
  if (D != 64 && D != 128) return flash::launch_bwd<kDkDv>(a, D, bf16, stream);
  if ((kDkDv ? a.Tq : a.Tk) == 0) {   // nothing to walk: the gradients are 0
    const size_t bytes = static_cast<size_t>(a.B) * rows * a.H * D *
                         (bf16 ? 2 : 4);
    cudaError_t e = cudaMemsetAsync(kDkDv ? a.dk : a.dq, 0, bytes, stream);
    if (kDkDv && e == cudaSuccess) e = cudaMemsetAsync(a.dv, 0, bytes, stream);
    return static_cast<int>(e);
  }
  using B = __nv_bfloat16;
  if (D == 64)
    return bf16 ? launch_sm90<kDkDv, B, 64>(a, stream)
                : launch_sm90<kDkDv, float, 64>(a, stream);
  return bf16 ? launch_sm90<kDkDv, B, 128>(a, stream)
              : launch_sm90<kDkDv, float, 128>(a, stream);
}

// An instance's tile, written to out: {1 on the wgmma route, else 0;
// warpgroups (0 off it); rows per walked tile; shared-memory bytes}.
template <bool kDkDv, typename T, int D>
inline void config_sm90(int* out) {
  using C = Cfg<kDkDv, T, D>;
  out[0] = 1;
  out[1] = C::kWG;
  out[2] = C::kRows;
  out[3] = C::kSmem;
}

template <bool kDkDv>
inline int config(int D, int bf16, int* out) {
  using B = __nv_bfloat16;
  if (D == 64) {
    bf16 ? config_sm90<kDkDv, B, 64>(out) : config_sm90<kDkDv, float, 64>(out);
    return 0;
  }
  if (D == 128) {
    bf16 ? config_sm90<kDkDv, B, 128>(out)
         : config_sm90<kDkDv, float, 128>(out);
    return 0;
  }
  out[0] = 0;
  out[1] = 0;
  switch (D) {
    case 32:
      out[2] = bf16 ? 64 : flash::f32_tile<32>();
      out[3] = static_cast<int>(bf16 ? flash::bwd_bf16_smem<32>()
                                     : flash::bwd_f32_smem<32>());
      return 0;
    case 256:
      out[2] = bf16 ? 64 : flash::f32_tile<256>();
      out[3] = static_cast<int>(bf16 ? flash::bwd_bf16_smem<256>()
                                     : flash::bwd_f32_smem<256>());
      return 0;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace fbwd
}  // namespace zoo
