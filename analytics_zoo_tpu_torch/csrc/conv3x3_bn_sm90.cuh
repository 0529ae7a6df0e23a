// The 3x3 SAME conv + BN in bf16 for Hopper (sm_90a), training (with
// the BN statistics) and eval (with the BN fold): an implicit GEMM on
// warpgroup MMA (wgmma) fed by a ring of asynchronous copies.
//
// Replaces the TPU's Pallas kernels `_conv3_kernel` of
// analytics_zoo_tpu/ops/conv_bn.py (driver `_conv3_fwd_pallas`, public
// `conv3x3_bn`; B2) and `_conv3_apply_kernel` (public
// `conv3x3_bn_apply`; B6), and on this card the bf16 instances of
// conv_bn_fwd.cuh's template, which keeps the f32 paths. The kernels
// take an epilogue flag: kFold = false (B2) computes
//     acc[m, n] = sum_(tap, c) A[m, (tap, c)] W[(tap, c), n]
//     A[m, (tap, c)] = relu_in?(affine_in?(x[pixel(m, tap), c] s[c] + t[c]))
//                      where the tap falls inside the image, else 0
//     y = bf16(acc); per column sum(acc - sh), sum((acc - sh)^2) over
//     the rows m < M
// as conv_bn_fwd.cuh does (any extent, stride 1 or 2, TF-SAME low pads,
// ragged M; the row geometry is its row_geom); kFold = true (B6) ends
// instead in y = bf16(relu_out?(acc os + ot)) and writes no statistics.
//
// What bounds it on the H100: 2 M 9 Cin Cout FLOP against the bytes of
// x, W and y: at ResNet-50's train-step shapes (batch 128) some 29.6
// GFLOP per call over 20-60 MB, several hundred FLOP per byte, above
// the bf16 ridge (about 295): bound by operations, 0.030 ms at 989
// TFLOP/s. But an implicit GEMM reads far more than that from L2: every
// M tile reads the whole weight, every tap re-reads the activation
// rows; at BM x BN tiles the weight alone is 2 M 9 Cin Cout / BM bytes,
// 231 MB per call at BM = 128. Those reads, not the tensor cores, set
// the pace. The design it replaces (mma.sync on 64x64 tiles, one
// synchronous stage, scalar transposed weight stores, 32-bit fragment
// loads, the affine read from device memory per element) took 0.42-0.44
// ms at every shape, 6.835 ms per bf16 train step (NVIDIA H100 80GB
// HBM3, 700 W; chip_smoke.py), 7.9x cuDNN.
//
// The design, two kernels:
// - Stride 1 (13 of ResNet-50's 16 calls), conv3x3_bn_s1_sm90_kernel:
//   a tap is a fixed shift of the flattened pixel index,
//   pixel(m, tap) = m + (ky - 1) W + (kx - 1), so the rows of all nine
//   taps of one 64-channel slice lie in one window of BM + 2 W + 2
//   consecutive pixels. The window is copied once per channel slice (two
//   alternate: the next arrives in four pieces during the current's
//   nine taps), the prologue is applied to it once, in place, and each
//   tap reads its rows at a shifted offset, only zeroing the rows whose
//   tap leaves the image (a 9-bit mask per row, computed once), so the
//   halo is zero after the prologue. Against one copy and one prologue
//   per tap this cuts the activation reads and the prologue's arithmetic
//   3-7 times. The tile is 256 rows (four warpgroups of 64) by 128
//   columns, which halves the weight reads against 128 rows; where Cout
//   is 64, 128 rows by 64 and two blocks per SM. The weight ring holds 5
//   slices, loaded 3 ahead.
// - Any stride, conv3x3_bn_sm90_kernel: 128 rows (two warpgroups) by
//   BN = 256 (128, 64) columns; each slice (one tap, 64 channels) is
//   copied and put through the prologue in registers as it arrives; the
//   ring holds 4 slices, loaded 2 ahead.
// - Both: the weight slices (64 x BN) arrive by 16-byte cp.async,
//   stored in wgmma's 128-byte-swizzled MN-major layout
//   (wgmma_sm90.cuh). Each warp takes its 16 rows by ldmatrix into
//   registers (the A fragment), and wgmma m64nBNk16 multiplies them by
//   the swizzled tile; one wgmma group stays in flight while the next
//   slice's fragments form (two register sets alternate), and the slot
//   being refilled is never the one it reads.
// - Epilogue from the f32 accumulators: y staged through shared memory
//   and written in 16-byte stores; each column's shifted sums over the
//   valid rows by shuffles, then across the warps in shared memory in a
//   fixed order, one partial row per M tile (the row index is the M
//   tile), which colsum.cuh sums in a fixed order: a launch repeats bit
//   for bit.
// - The eval fold (B6) serves batches of 1 to 32, M from 49 to 100,352
//   rows, where a fixed tile would leave most SMs idle at small M: the
//   caller picks the kernel and tile by M (`conv3x3_apply_tile` in
//   ops/conv_bn.py, launch_fold here); its epilogue applies the fold to
//   the f32 accumulators and stores y through the same staging. The
//   design it replaces (mma.sync on 64x64 tiles, one synchronous stage,
//   the prologue per tap, each activation row read per tap and the
//   weights per 64-row tile) took 1.693 ms per bf16 batch-32 forward
//   (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py), 5.0x cuDNN.
// - What still holds it back (PERF.md): each block fills its ring and
//   runs its epilogue alone, against only 9-72 slices, and the slices
//   themselves run well below the tensor cores' rate; ptxas serialises
//   the window kernel's wgmmas (C7513: its second step is conditional).
//   A persistent, warp-specialised schedule with TMA loads and stores is
//   the next step.

#pragma once

#include "conv_bn_fwd.cuh"
#include "wgmma_sm90.cuh"

namespace zoo {
namespace conv3_sm90 {

using sm90::smem_u32;

constexpr int kMaxSmem = 232448;   // a block's opt-in maximum on the H100

template <int BN>
__host__ __device__ constexpr int wtile_bytes() {
  return sm90::kSliceRows * BN * 2;
}

// Bit tap = 3 ky + kx set where the row exists and its tap falls inside
// the image.
__device__ __forceinline__ uint32_t tap_mask(const ConvBnArgs& a,
                                             const RowGeom& g) {
  if (!g.ok) return 0u;
  uint32_t mask = 0u;
#pragma unroll
  for (int ky = 0; ky < 3; ++ky)
#pragma unroll
    for (int kx = 0; kx < 3; ++kx) {
      const int iy = g.iy0 + ky, ix = g.ix0 + kx;
      if (iy >= 0 && iy < a.H && ix >= 0 && ix < a.W)
        mask |= 1u << (3 * ky + kx);
    }
  return mask;
}

// Rows k0 .. k0 + 63, columns n0 .. n0 + BN - 1 of the (9 Cin, Cout)
// weight matrix into a B tile at shared address `tile`, by T threads.
template <int BN, int T>
__device__ __forceinline__ void copy_wtile(uint32_t tile,
                                           const __nv_bfloat16* w, int k0,
                                           int n, int n0, int tid) {
  constexpr int kRowChunks = BN / 8;
#pragma unroll
  for (int c = tid; c < sm90::kSliceRows * kRowChunks; c += T) {
    const int r = c / kRowChunks;
    const int j = c - r * kRowChunks;
    sm90::cp_async16(tile + sm90::btile_offset(r, j),
                     w + static_cast<int64_t>(k0 + r) * n + n0 + j * 8, 16);
  }
}

// Shared memory the epilogue stages through (y, then the sums).
template <int BN, int BM, int T>
__host__ __device__ constexpr int staging_bytes() {
  return BM * (BN + 8) * 2 + (T / 32) * 2 * BN * 4;
}

// The epilogue from the f32 accumulators of a BM x BN tile computed by
// T threads (warpgroup wg owns rows 64 wg ..): y in 16-byte stores, and
// each column's shifted sums over the valid rows into the partial row
// of this M tile. `smem` is free (every copy has landed).
template <int BN, int BM, int T>
__device__ __forceinline__ void store_tile(const ConvBnArgs& a,
                                           const float (&acc)[BN / 2],
                                           uint8_t* smem, int m0, int n0,
                                           int M, int fr, int tid) {
  constexpr int kPitch = BN + 8;   // staged y row, in bf16
  const int warp = tid >> 5;
  const int g = (tid & 31) >> 2;
  const int t4 = tid & 3;
  __nv_bfloat16* ys = reinterpret_cast<__nv_bfloat16*>(smem);
  float* red = reinterpret_cast<float*>(smem + BM * kPitch * 2);
  const bool ok0 = m0 + fr < M;
  const bool ok1 = m0 + fr + 8 < M;
#pragma unroll
  for (int i = 0; i < BN / 8; ++i) {
    const int col = 8 * i + 2 * t4;
    *reinterpret_cast<uint32_t*>(&ys[fr * kPitch + col]) =
        sm90::pack_bf16x2(acc[4 * i], acc[4 * i + 1]);
    *reinterpret_cast<uint32_t*>(&ys[(fr + 8) * kPitch + col]) =
        sm90::pack_bf16x2(acc[4 * i + 2], acc[4 * i + 3]);
    float cs[2], cq2[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float sh = a.sh[n0 + col + e];
      const float d0 = acc[4 * i + e] - sh;
      const float d1 = acc[4 * i + 2 + e] - sh;
      cs[e] = (ok0 ? d0 : 0.f) + (ok1 ? d1 : 0.f);
      cq2[e] = (ok0 ? d0 * d0 : 0.f) + (ok1 ? d1 * d1 : 0.f);
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        cs[e] += __shfl_xor_sync(0xffffffffu, cs[e], off);
        cq2[e] += __shfl_xor_sync(0xffffffffu, cq2[e], off);
      }
    }
    if (g == 0) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        red[(warp * 2) * BN + col + e] = cs[e];
        red[(warp * 2 + 1) * BN + col + e] = cq2[e];
      }
    }
  }
  __syncthreads();
  __nv_bfloat16* y = static_cast<__nv_bfloat16*>(a.y);
  constexpr int kRowChunks = BN / 8;
  for (int c = tid; c < BM * kRowChunks; c += T) {
    const int r = c / kRowChunks;
    const int j = c - r * kRowChunks;
    if (m0 + r < M)
      *reinterpret_cast<uint4*>(y + static_cast<int64_t>(m0 + r) * a.N +
                                n0 + j * 8) =
          *reinterpret_cast<const uint4*>(&ys[r * kPitch + j * 8]);
  }
  if (tid < BN) {
    float s = 0.f, sq = 0.f;
#pragma unroll
    for (int wi = 0; wi < T / 32; ++wi) {
      s += red[(wi * 2) * BN + tid];
      sq += red[(wi * 2 + 1) * BN + tid];
    }
    float* p = a.partial + static_cast<int64_t>(blockIdx.x) * 2 * a.N;
    p[n0 + tid] = s;
    p[a.N + n0 + tid] = sq;
  }
}

// The eval fold's epilogue (B6) from the f32 accumulators of a BM x BN
// tile: y = relu_out?(acc os + ot), staged through shared memory and
// written in 16-byte stores; no statistics.
template <int BN, int BM, int T>
__device__ __forceinline__ void store_fold_tile(const ConvBnArgs& a,
                                                const float (&acc)[BN / 2],
                                                uint8_t* smem, int m0,
                                                int n0, int M, int fr,
                                                int tid) {
  constexpr int kPitch = BN + 8;   // staged y row, in bf16
  const int t4 = tid & 3;
  __nv_bfloat16* ys = reinterpret_cast<__nv_bfloat16*>(smem);
#pragma unroll
  for (int i = 0; i < BN / 8; ++i) {
    const int col = 8 * i + 2 * t4;
    const float2 os = *reinterpret_cast<const float2*>(a.out_scale + n0 +
                                                       col);
    const float2 ot = *reinterpret_cast<const float2*>(a.out_shift + n0 +
                                                       col);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v0 = fmaf(acc[4 * i + 2 * h], os.x, ot.x);
      float v1 = fmaf(acc[4 * i + 2 * h + 1], os.y, ot.y);
      if (a.relu_out) {
        v0 = fmaxf(v0, 0.f);
        v1 = fmaxf(v1, 0.f);
      }
      *reinterpret_cast<uint32_t*>(&ys[(fr + 8 * h) * kPitch + col]) =
          sm90::pack_bf16x2(v0, v1);
    }
  }
  __syncthreads();
  __nv_bfloat16* y = static_cast<__nv_bfloat16*>(a.y);
  constexpr int kRowChunks = BN / 8;
  for (int c = tid; c < BM * kRowChunks; c += T) {
    const int r = c / kRowChunks;
    const int j = c - r * kRowChunks;
    if (m0 + r < M)
      *reinterpret_cast<uint4*>(y + static_cast<int64_t>(m0 + r) * a.N +
                                n0 + j * 8) =
          *reinterpret_cast<const uint4*>(&ys[r * kPitch + j * 8]);
  }
}

// The prologue on one k16 A fragment: channels c, c + 1 in registers 0
// and 1, c + 8, c + 9 in 2 and 3 (s and t staged in shared memory); a
// zeroed row stays zero.
__device__ __forceinline__ void prologue(uint32_t (&r)[4], const float* st,
                                         int cin, int c, bool v0, bool v1,
                                         int affine_in, int relu_in) {
  float2 s[2] = {make_float2(1.f, 1.f), make_float2(1.f, 1.f)};
  float2 t[2] = {make_float2(0.f, 0.f), make_float2(0.f, 0.f)};
  if (affine_in) {
    s[0] = *reinterpret_cast<const float2*>(st + c);
    s[1] = *reinterpret_cast<const float2*>(st + c + 8);
    t[0] = *reinterpret_cast<const float2*>(st + cin + c);
    t[1] = *reinterpret_cast<const float2*>(st + cin + c + 8);
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    float2 v = sm90::unpack_bf16x2(r[e]);
    v.x = fmaf(v.x, s[e >> 1].x, t[e >> 1].x);
    v.y = fmaf(v.y, s[e >> 1].y, t[e >> 1].y);
    if (relu_in) {
      v.x = fmaxf(v.x, 0.f);
      v.y = fmaxf(v.y, 0.f);
    }
    r[e] = ((e & 1) ? v1 : v0) ? sm90::pack_bf16x2(v.x, v.y) : 0u;
  }
}

// ---- any stride: one copy and one prologue per (tap, channel slice) ----

constexpr int kBM = 128;
constexpr int kThreads = 256;

template <int BN>
struct Cfg {
  static constexpr int kStages = 4;   // ring slots, loaded 2 ahead
  static constexpr int kDist = 2;
  static constexpr int kMinBlocks = BN == 64 ? 2 : 1;
  static constexpr int kABytes = kBM * 128;   // 128 rows x 64 channels
  static constexpr int kStageBytes = kABytes + wtile_bytes<BN>();
  static constexpr int kRingBytes = kStages * kStageBytes;
  static_assert(staging_bytes<BN, kBM, kThreads>() <= kRingBytes,
                "the epilogue's staging must fit the ring");
};

// Dynamic shared memory of one block: the ring, s and t, alignment slack.
template <int BN>
inline int smem_bytes(int cin) {
  return Cfg<BN>::kRingBytes + 8 * cin + 1024;
}

template <int BN, bool kFold>
__global__ void __launch_bounds__(kThreads, (Cfg<BN>::kMinBlocks))
    conv3x3_bn_sm90_kernel(ConvBnArgs a) {
  using C = Cfg<BN>;
  constexpr int S = C::kStages;
  constexpr int D = C::kDist;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t sbase = smem_u32(smem);
  float* st = reinterpret_cast<float*>(smem + C::kRingBytes);  // s, t

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int M = a.B * a.Ho * a.Wo;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * BN;
  const int cin = a.Cin;
  const int nslices = 9 * cin / sm90::kSliceRows;
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(a.x);
  const __nv_bfloat16* w = static_cast<const __nv_bfloat16*>(a.w);

  if (a.affine_in) {
    for (int c = tid; c < cin; c += kThreads) {
      st[c] = a.in_scale[c];
      st[cin + c] = a.in_shift[c];
    }
  }

  // copy role: row cr of the A slice, chunks cq .. cq + 3
  const int cr = tid >> 1;
  const int cq = (tid & 1) * 4;
  const RowGeom cgeo = row_geom(a, m0 + cr, M);
  const uint32_t cmask = tap_mask(a, cgeo);
  // fragment rows fr and fr + 8 of the tile; lrow this lane's ldmatrix
  // row
  const int fr = (warp >> 2) * 64 + (warp & 3) * 16 + g;
  const int lrow = fr - g + (lane & 15);
  const uint32_t fmask0 = tap_mask(a, row_geom(a, m0 + fr, M));
  const uint32_t fmask1 = tap_mask(a, row_geom(a, m0 + fr + 8, M));

  auto issue = [&](int sl) {
    const int k0 = sl * sm90::kSliceRows;
    const int tap = k0 / cin;
    const int c0 = k0 - tap * cin;
    const int ky = tap / 3;
    const int kx = tap - 3 * ky;
    const uint32_t aslot = sbase + (sl % S) * C::kStageBytes;
    const bool v = (cmask >> tap) & 1u;
    const __nv_bfloat16* src =
        v ? x + ((cgeo.base + cgeo.iy0 + ky) * a.W + cgeo.ix0 + kx) * cin +
                c0
          : x;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = cq + i;
      sm90::cp_async16(aslot + cr * 128 + ((j ^ (cr & 7)) << 4),
                       v ? src + j * 8 : x, v ? 16 : 0);
    }
    copy_wtile<BN, kThreads>(aslot + C::kABytes, w, k0, a.N, n0, tid);
  };

  float acc[BN / 2];   // the first product overwrites it (scale-d 0)

#pragma unroll
  for (int sl = 0; sl < D; ++sl) {
    if (sl < nslices) issue(sl);
    sm90::cp_async_commit();
  }

  // One slice: its copies landed, the copies of slice + D start, its A
  // fragments are formed and its products issued; the products of the
  // slice before run on meanwhile (one wgmma group stays in flight, so
  // the A registers alternate between two sets).
  auto step = [&](int sl, uint32_t (&af)[4][4]) {
    sm90::cp_async_wait<D - 1>();
    sm90::fence_proxy_async();
    __syncthreads();
    if (sl + D < nslices) issue(sl + D);
    sm90::cp_async_commit();

    const uint32_t aslot = sbase + (sl % S) * C::kStageBytes;
    const int k0 = sl * sm90::kSliceRows;
    const int tap = k0 / cin;
    const int c0 = k0 - tap * cin;
    const bool v0 = (fmask0 >> tap) & 1u;
    const bool v1 = (fmask1 >> tap) & 1u;
    sm90::load_fragments(af, aslot, lrow, lane, v0, v1);
    if (a.affine_in || a.relu_in) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        prologue(af[kk], st, cin, c0 + kk * 16 + 2 * t4, v0, v1,
                 a.affine_in, a.relu_in);
    }
    sm90::fence_regs(af);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      sm90::wgmma_tile<BN>(acc, af[kk],
                           sm90::btile_desc(aslot + C::kABytes, kk),
                           sl + kk > 0);
    sm90::wgmma_commit();
    sm90::wgmma_wait<1>();
  };
  uint32_t af0[4][4], af1[4][4];
  for (int sl = 0; sl < nslices; sl += 2) {
    step(sl, af0);
    if (sl + 1 < nslices) step(sl + 1, af1);
  }
  sm90::wgmma_wait<0>();
  sm90::fence_regs(acc);

  sm90::cp_async_wait<0>();
  __syncthreads();
  if constexpr (kFold)
    store_fold_tile<BN, kBM, kThreads>(a, acc, smem, m0, n0, M, fr, tid);
  else
    store_tile<BN, kBM, kThreads>(a, acc, smem, m0, n0, M, fr, tid);
}

// ---- stride 1: one window per channel slice serves all nine taps -------

// The window kernel's tile: NWG warpgroups of 64 rows by BN columns;
// its weight ring holds 5 slices, loaded 3 ahead.
template <int BN>
struct S1 {
  static constexpr int kNWG = BN == 64 ? 2 : 4;   // 128 or 256 rows
  static constexpr int kBM = 64 * kNWG;
  static constexpr int kThreads = 128 * kNWG;
  static constexpr int kMinBlocks = BN == 64 ? 2 : 1;
  static constexpr int kStages = 5;
  static constexpr int kDist = 3;
  static constexpr int kPieces = 4;   // the next window, over taps 1 .. 4
};

template <int BN>
inline int window_rows(int w) {
  return S1<BN>::kBM + 2 * w + 2;
}
// (ldmatrix and cp.async need 16-byte alignment only: no rounding up)
template <int BN>
inline int window_bytes(int w) {
  return window_rows<BN>(w) * 128;
}
// windows: one per channel slice in flight, two at most
inline int windows(int cin) { return cin > 64 ? 2 : 1; }
template <int BN>
inline int s1_smem_bytes(int cin, int w) {
  return S1<BN>::kStages * wtile_bytes<BN>() +
         windows(cin) * window_bytes<BN>(w) + 8 * cin + 1024;
}
template <int BN>
inline bool s1_fits(int cin, int w) {
  using P = S1<BN>;
  return s1_smem_bytes<BN>(cin, w) <= kMaxSmem &&
         staging_bytes<BN, P::kBM, P::kThreads>() <=
             P::kStages * wtile_bytes<BN>() +
                 windows(cin) * window_bytes<BN>(w);
}

template <int BN, bool kFold>
__global__ void __launch_bounds__(S1<BN>::kThreads, S1<BN>::kMinBlocks)
    conv3x3_bn_s1_sm90_kernel(ConvBnArgs a, int win_rows, int win_bytes) {
  using P = S1<BN>;
  constexpr int S = P::kStages;
  constexpr int D = P::kDist;
  constexpr int T = P::kThreads;
  constexpr int kW = wtile_bytes<BN>();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t sbase = smem_u32(smem);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int M = a.B * a.Ho * a.Wo;              // = B H W at stride 1
  const int m0 = blockIdx.x * P::kBM;
  const int n0 = blockIdx.y * BN;
  const int cin = a.Cin;
  const int ncs = cin / sm90::kSliceRows;       // channel slices
  const int nslices = 9 * ncs;                  // (channel slice, tap)
  const int p0 = m0 - a.W - 1;                  // window row 0's pixel
  const bool pro = a.affine_in || a.relu_in;
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(a.x);
  const __nv_bfloat16* w = static_cast<const __nv_bfloat16*>(a.w);
  const uint32_t wring = sbase;                 // S weight tiles
  const uint32_t win = sbase + S * kW;          // the windows
  uint8_t* win_ptr = smem + S * kW;
  float* st = reinterpret_cast<float*>(           // s, t
      win_ptr + (ncs > 1 ? 2 : 1) * win_bytes);

  if (a.affine_in) {
    for (int c = tid; c < cin; c += T) {
      st[c] = a.in_scale[c];
      st[cin + c] = a.in_shift[c];
    }
  }
  // fragment rows fr and fr + 8 of the tile; lrow this lane's ldmatrix
  // row (tap (ky, kx) reads window row lrow + ky W + kx)
  const int fr = (warp >> 2) * 64 + (warp & 3) * 16 + g;
  const int lrow = fr - g + (lane & 15);
  const uint32_t fmask0 = tap_mask(a, row_geom(a, m0 + fr, M));
  const uint32_t fmask1 = tap_mask(a, row_geom(a, m0 + fr + 8, M));

  // weight tile of slice sl = 9 cs + tap: rows tap Cin + 64 cs ..
  auto issue_w = [&](int sl) {
    const int cs = sl / 9;
    const int tap = sl - 9 * cs;
    copy_wtile<BN, T>(wring + (sl % S) * kW, w,
                      tap * cin + cs * sm90::kSliceRows, a.N, n0, tid);
  };
  // rows r0 .. r1 - 1 of the window of channel slice cs: pixels p0 + r
  // (zeros outside the tensor; only taps that leave the image read
  // those); a thread always takes chunk tid % 8 of its rows
  const int wj = tid & 7;
  auto issue_win = [&](int cs, int r0, int r1) {
    const uint32_t buf = win + (cs & 1) * win_bytes;
    for (int r = r0 + (tid >> 3); r < r1; r += T / 8) {
      const int p = p0 + r;
      const bool ok = p >= 0 && p < M;
      sm90::cp_async16(
          buf + r * 128 + ((wj ^ (r & 7)) << 4),
          x + static_cast<int64_t>(ok ? p : 0) * cin + cs * 64 + wj * 8,
          ok ? 16 : 0);
    }
  };
  // the prologue once per window element, in place, rounded to bf16
  auto transform = [&](int cs) {
    uint8_t* buf = win_ptr + (cs & 1) * win_bytes;
    const int ch = cs * 64 + wj * 8;
    float sv[8], tv[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      sv[e] = a.affine_in ? st[ch + e] : 1.f;
      tv[e] = a.affine_in ? st[cin + ch + e] : 0.f;
    }
    for (int r = tid >> 3; r < win_rows; r += T / 8) {
      uint4* pv = reinterpret_cast<uint4*>(buf + r * 128 +
                                           ((wj ^ (r & 7)) << 4));
      uint4 v = *pv;
      uint32_t* e = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        float2 f = sm90::unpack_bf16x2(e[h]);
        f.x = fmaf(f.x, sv[2 * h], tv[2 * h]);
        f.y = fmaf(f.y, sv[2 * h + 1], tv[2 * h + 1]);
        if (a.relu_in) {
          f.x = fmaxf(f.x, 0.f);
          f.y = fmaxf(f.y, 0.f);
        }
        e[h] = sm90::pack_bf16x2(f.x, f.y);
      }
      *pv = v;
    }
  };

  float acc[BN / 2];   // the first product overwrites it (scale-d 0)

  issue_win(0, 0, win_rows);
#pragma unroll
  for (int sl = 0; sl < D; ++sl) {
    if (sl < nslices) issue_w(sl);
    sm90::cp_async_commit();
  }

  // One slice (channel slice cs, tap): the weight slice D ahead starts
  // loading, and at taps 1 .. kPieces a quarter of the next window (each
  // piece then lands D steps later, like a weight slice); at tap 0 the
  // window is put through the prologue; the tap's rows are read at their
  // shift.
  const int piece = (win_rows + P::kPieces - 1) / P::kPieces;
  auto step = [&](int sl, uint32_t (&af)[4][4]) {
    const int cs = sl / 9;
    const int tap = sl - 9 * cs;
    sm90::cp_async_wait<D - 1>();
    sm90::fence_proxy_async();
    __syncthreads();
    if (sl + D < nslices) issue_w(sl + D);
    if (tap >= 1 && tap <= P::kPieces && cs + 1 < ncs)
      issue_win(cs + 1, (tap - 1) * piece, min(win_rows, tap * piece));
    sm90::cp_async_commit();
    if (tap == 0 && pro) {
      transform(cs);
      __syncthreads();
    }
    const int ky = tap / 3;
    sm90::load_fragments(af, win + (cs & 1) * win_bytes,
                   lrow + ky * a.W + (tap - 3 * ky), lane,
                   (fmask0 >> tap) & 1u, (fmask1 >> tap) & 1u);
    const uint32_t bslot = wring + (sl % S) * kW;
    sm90::fence_regs(af);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      sm90::wgmma_tile<BN>(acc, af[kk], sm90::btile_desc(bslot, kk),
                           sl + kk > 0);
    sm90::wgmma_commit();
    sm90::wgmma_wait<1>();
  };
  uint32_t af0[4][4], af1[4][4];
  for (int sl = 0; sl < nslices; sl += 2) {
    step(sl, af0);
    if (sl + 1 < nslices) step(sl + 1, af1);
  }
  sm90::wgmma_wait<0>();
  sm90::fence_regs(acc);

  sm90::cp_async_wait<0>();
  __syncthreads();
  if constexpr (kFold)
    store_fold_tile<BN, P::kBM, T>(a, acc, smem, m0, n0, M, fr, tid);
  else
    store_tile<BN, P::kBM, T>(a, acc, smem, m0, n0, M, fr, tid);
}

// ---- launch -------------------------------------------------------------

// Raises a kernel's dynamic shared memory allowance once it needs more.
template <typename K>
inline int allow_smem(K kernel, int bytes, int* allowed) {
  if (bytes <= *allowed) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  *allowed = bytes;
  return 0;
}

template <int BN, bool kFold>
inline int launch_generic(const ConvBnArgs& a, cudaStream_t stream) {
  static int allowed = 0;
  const int bytes = smem_bytes<BN>(a.Cin);
  const int err =
      allow_smem(conv3x3_bn_sm90_kernel<BN, kFold>, bytes, &allowed);
  if (err != 0) return err;
  const int M = a.B * a.Ho * a.Wo;
  const dim3 grid((M + kBM - 1) / kBM, a.N / BN);
  note_launch("conv3x3_bn_sm90_kernel<%d, %s>", BN, bool_name(kFold));
  conv3x3_bn_sm90_kernel<BN, kFold><<<grid, kThreads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int BN, bool kFold>
inline int launch_s1(const ConvBnArgs& a, cudaStream_t stream) {
  using P = S1<BN>;
  static int allowed = 0;
  const int bytes = s1_smem_bytes<BN>(a.Cin, a.W);
  const int err =
      allow_smem(conv3x3_bn_s1_sm90_kernel<BN, kFold>, bytes, &allowed);
  if (err != 0) return err;
  const int M = a.B * a.Ho * a.Wo;
  const dim3 grid((M + P::kBM - 1) / P::kBM, a.N / BN);
  note_launch("conv3x3_bn_s1_sm90_kernel<%d, %s>", BN, bool_name(kFold));
  conv3x3_bn_s1_sm90_kernel<BN, kFold><<<grid, P::kThreads, bytes,
                                         stream>>>(
      a, window_rows<BN>(a.W), window_bytes<BN>(a.W));
  return static_cast<int>(cudaGetLastError());
}

// Whether the stride-1 window kernel takes this call.
inline bool is_s1(const ConvBnArgs& a) {
  return a.stride == 1 && a.pad_t == 1 && a.pad_l == 1 && a.Ho == a.H &&
         a.Wo == a.W;
}
inline bool takes_s1(const ConvBnArgs& a) {
  if (!is_s1(a)) return false;
  return a.N % 128 == 0 ? s1_fits<128>(a.Cin, a.W)
                        : s1_fits<64>(a.Cin, a.W);
}

// Rows of the statistics partials: one per M tile (the window kernel's
// 256 or 128 rows, the generic one's 128); the wrapper allocates one per
// 128 rows, enough for any.
inline int partial_rows(const ConvBnArgs& a) {
  const int M = a.B * a.Ho * a.Wo;
  const int bm = !takes_s1(a) ? kBM
                 : a.N % 128 == 0 ? S1<128>::kBM : S1<64>::kBM;
  return (M + bm - 1) / bm;
}

// Launches the bf16 kernel (x, w and y bf16; a.partial holds
// partial_rows(a) rows of 2N); returns cudaGetLastError(). Stride 1 runs
// the window kernel where its shared memory fits (tiles 128 columns
// wide, 64 where Cout is 64), else the generic one (256 columns where
// Cout allows, else 128, else 64).
inline int launch(const ConvBnArgs& a, cudaStream_t stream) {
  if (takes_s1(a))
    return a.N % 128 == 0 ? launch_s1<128, false>(a, stream)
                          : launch_s1<64, false>(a, stream);
  if (a.N % 256 == 0) return launch_generic<256, false>(a, stream);
  return a.N % 128 == 0 ? launch_generic<128, false>(a, stream)
                        : launch_generic<64, false>(a, stream);
}

// Launches the bf16 eval fold (B6; x, w and y bf16) on the tile the
// caller picked (`conv3x3_apply_tile` in ops/conv_bn.py, by M): window
// != 0 the stride-1 window kernel, 256 x 128 (bn 128) or 128 x 64 (bn
// 64) tiles, where its geometry and shared memory allow; else the
// generic kernel, 128 x bn (256, 128 or 64). Returns cudaGetLastError(),
// or cudaErrorInvalidValue for a tile the call cannot take.
inline int launch_fold(const ConvBnArgs& a, int window, int bn,
                       cudaStream_t stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (a.N % bn) return bad;
  if (window) {
    if (!is_s1(a)) return bad;
    if (bn == 128 && s1_fits<128>(a.Cin, a.W))
      return launch_s1<128, true>(a, stream);
    if (bn == 64 && s1_fits<64>(a.Cin, a.W))
      return launch_s1<64, true>(a, stream);
    return bad;
  }
  if (bn == 256) return launch_generic<256, true>(a, stream);
  if (bn == 128) return launch_generic<128, true>(a, stream);
  if (bn == 64) return launch_generic<64, true>(a, stream);
  return bad;
}

}  // namespace conv3_sm90
}  // namespace zoo
