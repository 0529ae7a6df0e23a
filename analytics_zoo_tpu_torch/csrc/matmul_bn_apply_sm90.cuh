// The eval 1x1 conv + BN fold with f32 weights for Hopper (sm_90a): an
// f32-accurate product on the tensor cores by the three-pass TF32 split
// ("3xTF32") on warpgroup MMA (wgmma), fed by a ring of asynchronous
// copies.
//
// Replaces the TPU's Pallas kernel `_apply_kernel` of
// analytics_zoo_tpu/ops/conv_bn.py (public `matmul_bn_apply`/
// `conv1x1_bn_apply`; B5) where the weights are f32, which is how the
// served model keeps them, and where an f32 x meets bf16 weights; bf16
// x and weights run B1's kernel (matmul_bn_sm90.cuh) with its fold
// epilogue. For a tile of 128 rows m by 64 columns n it computes
//     A[m, c] = relu_in?(affine_in?(x[pixel(m), c] s[c] + t[c]))   (f32)
//     y[m, n] = relu_out?(sum_c A[m, c] W[c, n] os[n] + ot[n] [+ res])
// with x and y f32 or bf16, pixel(m) every stride-th pixel of the NHWC
// x read in place, rows past M masked. With bf16 weights the product
// runs in bf16 as the reference's does (`xf.astype(w.dtype)`): A is
// rounded to bf16 after the prologue, and bf16 A and W are exact in
// tf32, so one pass, A_hi W_hi, is the whole product.
//
// The product multiplies in the weights' type, f32, as the reference
// does, and plain TF32 (10-bit mantissas) would not keep that. Each
// operand v is split into hi = tf32(v) and lo = tf32(v - hi), and
//     A W = A_lo W_hi + A_hi W_lo + A_hi W_hi
// drops only A_lo W_lo and the rounding of lo, about 2^-22 of each
// product, below what f32 accumulation over K 64-2048 already varies
// by; hi and lo are exact on the tensor cores. A bf16 x without a
// prologue is exact in tf32 (A_lo = 0), and its A_lo W_hi pass is left
// out. The tensor cores sum a k8 step's products with the accumulator
// by truncation, so a long run of sums would drift; each 32-deep group
// therefore starts a fresh accumulator (the small terms first) and is
// added into an f32 running sum with round-to-nearest once its products
// are done: every truncation is against a 32-term partial sum.
//
// What bounds it on the H100: 2 M K N FLOP; as an f32 FMA product that
// is 67 TFLOP/s, here tf32 passes at 495 TFLOP/s, three, or two for a
// bf16 x without a prologue (an f32-accurate product's least time is
// the smaller of the two, and against ResNet-50 serving's 1x1s at batch
// 32 that is the tf32 one: with the bytes, 0.650 ms a bf16 forward and
// 1.100 ms an f32 one; scripts/conv_bn_ab.py). The design it replaces
// (f32 FMA on 64 x 64 tiles, one synchronous 32-deep stage) took 5.145
// ms per bf16 batch-32 forward and 5.576 ms per f32 one (NVIDIA H100
// 80GB HBM3, 700 W; chip_smoke.py), 1.5x cuBLAS's f32 product.
//
// The design:
// - Tiles of 128 rows (two warpgroups of 64) by 64 columns; a ring of
//   three 64-deep slots (the x rows as they lie, f32 as two 128-byte-row
//   subtiles of 32 channels, bf16 as one; the raw f32 W slice), filled
//   two slices ahead by bulk tensor copies (TMA) that complete on the
//   slot's transaction barrier (zeros past M); a strided x (every
//   stride-th pixel) comes by 16-byte cp.async.
// - W is split on every call, in the kernel: once a slice has landed,
//   the block splits it into a hi and a lo tile, both K-major (tf32
//   wgmma takes no MN-major B), 128-byte swizzled (kmajor_desc), double
//   buffered: the next slice's split runs while this slice's products
//   do (it was most of the kernel's time when it ran alone), and never
//   touches a tile a product still reads. No weight cache and no state
//   between calls.
// - A: each warp takes its 16 rows by ldmatrix into registers, applies
//   the prologue there and splits them. An f32 x gives the tf32
//   fragment layout directly; a bf16 x gives bf16 pairs, channels
//   (2 t4, 2 t4 + 1) where tf32 wants (t4, t4 + 4), so the split W
//   tiles store each 8 channels in that order instead (row p of each 8
//   holds channel 2 p, or 2 (p - 4) + 1 from p = 4): the product is the
//   same sum in another order.
// - Per 32-deep group, twelve wgmma m64n64k8 (A_lo W_hi, A_hi W_lo,
//   A_hi W_hi, four k8 steps each; eight without A_lo, four with bf16
//   weights) into a fresh accumulator; the next group's fragments form
//   while they run, then the accumulator joins the running sum (no
//   wgmma in flight) and the next group is issued.
// - Epilogue: y = relu_out?(acc os + ot [+ res]) formed in registers,
//   res from a tile TMA brought into a free ring slot during the last
//   slice, staged in another free slot in TMA's swizzled layout and
//   written by bulk tensor stores (rows past M clipped).

#pragma once

#include "matmul_bn_sm90.cuh"

namespace zoo {
namespace apply_sm90 {

using sm90::smem_u32;

constexpr int kBM = mm_sm90::kBM;   // 128 rows: two warpgroups
constexpr int kBN = 64;
constexpr int kThreads = 256;
constexpr int kStages = 3;                    // ring slots, 2 ahead
constexpr int kDist = 2;
constexpr int kHalfBytes = kBN * 128;         // 64 n rows x 32 k, tf32
constexpr int kSplitBytes = 4 * kHalfBytes;   // hi, lo of both halves

template <typename Tx, typename Tw>
struct Cfg {
  static constexpr int kABytes = kBM * 64 * sizeof(Tx);   // x slice
  static constexpr int kWRawBytes = 64 * kBN * sizeof(Tw);   // W rows k
  static constexpr int kSlotBytes = kABytes + kWRawBytes;
  static constexpr int kRingBytes = kStages * kSlotBytes;
  // the ring, the split tiles, the slots' transaction barriers, slack
  static constexpr int kSmem = kRingBytes + 2 * kSplitBytes + 64 + 1024;
  static_assert(kBM * kBN * sizeof(Tx) <= kSlotBytes,
                "the res and y tiles must fit a ring slot");
};

// Logical channel p (0 .. 7) of each 8 in the split W tiles: the x
// fragment's channel order (see the note at the top).
template <typename Tx>
__device__ __forceinline__ int split_channel(int p) {
  if constexpr (sizeof(Tx) == 2) return p < 4 ? 2 * p : 2 * (p - 4) + 1;
  return p;
}

// The raw W slice (64 k rows of 64 Tw) at `raw` into its hi and lo
// tiles at `split` (bf16 weights: the hi tile alone, exact in tf32):
// half h (channels 32 h ..) of each at h * 2 (hi) and h * 2 + 1 (lo)
// times kHalfBytes; row n, 16-byte chunk j holds logical channels
// 4 j .. 4 j + 3 of the half, at chunk j ^ (n % 8). A warp reads 32
// neighbouring n of one k row (distinct banks) and writes 32 rows'
// chunks (eight distinct per 128 bytes).
template <typename Tx, typename Tw>
__device__ __forceinline__ void split_w(uint8_t* split, const Tw* raw,
                                        int tid) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = tid + i * kThreads;
    const int n = c & 63;
    const int rest = c >> 6;        // 0 .. 15
    const int h = rest >> 3;
    const int j = rest & 7;
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int logical = 4 * j + e;   // within the half
      const int k = h * 32 + (logical & ~7) + split_channel<Tx>(logical & 7);
      if constexpr (sizeof(Tw) == 4)
        sm90::split_tf32(raw[k * kBN + n], hi[e], lo[e]);
      else
        hi[e] = __float_as_uint(__bfloat162float(raw[k * kBN + n]));
    }
    const uint32_t off = sm90::row128_offset(n, j);
    *reinterpret_cast<uint4*>(split + (h * 2) * kHalfBytes + off) =
        make_uint4(hi[0], hi[1], hi[2], hi[3]);
    if constexpr (sizeof(Tw) == 4)
      *reinterpret_cast<uint4*>(split + (h * 2 + 1) * kHalfBytes + off) =
          make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
}

// One 32-deep group's A fragments (half gi of a slice at `aslot`, c0
// the slice's first channel), the prologue applied (then rounded to
// bf16 where kBf16A: bf16 weights), split: hi[s], lo[s] for the k8
// steps s = 0 .. 3 (each the tf32 m64nNk8 layout).
template <typename Tx, bool kALo, bool kBf16A>
__device__ __forceinline__ void group_fragments(uint32_t (&hi)[4][4],
                                                uint32_t (&lo)[4][4],
                                                const ConvBnArgs& a,
                                                uint32_t aslot, int gi,
                                                int row, int lane, int c0,
                                                bool pro) {
  const int t4 = lane & 3;
  const int cg = c0 + 32 * gi;   // the group's first channel
  float f[4][4];
  if constexpr (sizeof(Tx) == 4) {
    // subtile gi; per k8 step s (chunks 2 s, 2 s + 1), register e at row
    // g + 8 (e & 1), channel 8 s + t4 + 4 (e >> 1)
    const uint32_t sub = aslot + gi * (kBM * 128);
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      uint32_t v[4];
      const int ch = 2 * s + (lane >> 4);
      sm90::ldsm_x4(sub + row * 128 + ((ch ^ (row & 7)) << 4), v);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        f[s][e] = __uint_as_float(v[e]);
        if (pro)
          f[s][e] = mm_sm90::prologue_f32(f[s][e], a,
                                          cg + 8 * s + t4 + 4 * (e >> 1));
      }
    }
  } else {
    // per bf16 k16 load kk (channels 16 kk ..): register e holds rows
    // g + 8 (e & 1), channels 2 t4 (+1) + 8 (e >> 1); k8 step 2 kk + h
    // takes registers 2 h, 2 h + 1, the low halves as tf32 column t4,
    // the high halves as t4 + 4
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      uint32_t v[4];
      const int ch = (2 * gi + kk) * 2 + (lane >> 4);
      sm90::ldsm_x4(aslot + row * 128 + ((ch ^ (row & 7)) << 4), v);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          float2 p = sm90::unpack_bf16x2(v[2 * h + rr]);
          if (pro) {
            const int c = cg + 16 * kk + 8 * h + 2 * t4;
            p.x = mm_sm90::prologue_f32(p.x, a, c);
            p.y = mm_sm90::prologue_f32(p.y, a, c + 1);
          }
          f[2 * kk + h][rr] = p.x;
          f[2 * kk + h][2 + rr] = p.y;
        }
      }
    }
  }
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if constexpr (kALo)
        sm90::split_tf32(f[s][e], hi[s][e], lo[s][e]);
      else if constexpr (kBf16A)   // the reference's x.astype(bf16)
        hi[s][e] = __float_as_uint(
            __bfloat162float(__float2bfloat16(f[s][e])));
      else
        hi[s][e] = __float_as_uint(f[s][e]);   // exact in tf32
    }
}

// Byte offset of element (r, c) of a 128-row by 64-column tile of Tx
// kept as 128-byte-row subtiles of 128 / sizeof(Tx) columns, swizzled
// as TMA's 128-byte swizzle lays them out (the res tile it loads, the y
// tile it stores).
template <typename Tx>
__device__ __forceinline__ uint32_t tile_offset(int r, int c) {
  constexpr int kE = 128 / sizeof(Tx);    // columns per subtile
  constexpr int kC = 16 / sizeof(Tx);     // columns per 16-byte chunk
  const int cc = c % kE;
  return (c / kE) * (kBM * 128) + r * 128 +
         (((cc / kC) ^ (r & 7)) << 4) + (cc % kC) * sizeof(Tx);
}

// The fold's epilogue: y = relu_out?(acc os + ot [+ res]) in Tx, formed
// in registers (res from the tile TMA brought into `rt` during the last
// slice, once `rbar`'s phase completes) into the staging tile `yt` (a
// free ring slot), then written by bulk tensor stores (rows past M
// clipped) issued by thread 0, which waits for their sources to be read
// before the block exits.
template <typename Tx>
__device__ __forceinline__ void fold_epilogue(const ConvBnArgs& a,
                                              const mm_sm90::Maps& maps,
                                              const float (&acc)[32],
                                              uint8_t* yt, uint8_t* rt,
                                              uint32_t rbar, int parity,
                                              int m0, int n0, int fr,
                                              int tid) {
  const int t4 = tid & 3;
  if (rt != nullptr) sm90::mbar_wait(rbar, parity);
#pragma unroll
  for (int i = 0; i < kBN / 8; ++i) {
    const int col = 8 * i + 2 * t4;
    const float2 os = __ldg(reinterpret_cast<const float2*>(a.out_scale +
                                                            n0 + col));
    const float2 ot = __ldg(reinterpret_cast<const float2*>(a.out_shift +
                                                            n0 + col));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = fr + 8 * h;
      const uint32_t off = tile_offset<Tx>(r, col);
      float v0 = fmaf(acc[4 * i + 2 * h], os.x, ot.x);
      float v1 = fmaf(acc[4 * i + 2 * h + 1], os.y, ot.y);
      if (rt != nullptr) {
        if constexpr (sizeof(Tx) == 4) {
          const float2 rv = *reinterpret_cast<const float2*>(rt + off);
          v0 += rv.x;
          v1 += rv.y;
        } else {
          const float2 rv =
              sm90::unpack_bf16x2(*reinterpret_cast<const uint32_t*>(rt +
                                                                     off));
          v0 += rv.x;
          v1 += rv.y;
        }
      }
      if (a.relu_out) {
        v0 = fmaxf(v0, 0.f);
        v1 = fmaxf(v1, 0.f);
      }
      if constexpr (sizeof(Tx) == 4)
        *reinterpret_cast<float2*>(yt + off) = make_float2(v0, v1);
      else
        *reinterpret_cast<uint32_t*>(yt + off) = sm90::pack_bf16x2(v0, v1);
    }
  }
  sm90::fence_proxy_async();   // the staged y, for the bulk stores
  __syncthreads();
  if (tid == 0) {
#pragma unroll
    for (int h = 0; h < static_cast<int>(sizeof(Tx)) / 2; ++h)
      sm90::tma_store_2d(&maps.y, smem_u32(yt) + h * kBM * 128,
                         n0 + h * (128 / static_cast<int>(sizeof(Tx))), m0);
    sm90::bulk_commit();
  }
}

// kALo: A has a low part (an f32 x, or a prologue, with f32 weights);
// a bf16 x without one is exact in tf32, and its A_lo W_hi pass is left
// out (every term of it is zero). Tw: the weights' type; bf16 weights
// have no low part either, and A is rounded to bf16.
template <typename Tx, typename Tw, bool kALo>
__global__ void __launch_bounds__(kThreads, 1)
    matmul_bn_apply_sm90_kernel(ConvBnArgs a, int tma_x,
                                const __grid_constant__ mm_sm90::Maps maps) {
  using C = Cfg<Tx, Tw>;
  constexpr bool kWLo = sizeof(Tw) == 4;
  static_assert(kWLo || !kALo, "bf16 weights take a bf16-rounded A");
  constexpr int S = kStages;
  constexpr int D = kDist;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t sbase = smem_u32(smem);
  uint8_t* split = smem + C::kRingBytes;      // two buffers
  const uint32_t sp_base = sbase + C::kRingBytes;
  const uint32_t bars = sp_base + 2 * kSplitBytes;   // one per slot

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int M = a.B * a.Ho * a.Wo;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int cin = a.Cin;
  const int ns = cin / 64;
  const bool pro = a.affine_in || a.relu_in;
  const Tx* x = static_cast<const Tx*>(a.x);

  const int cr = tid >> 1;
  const int64_t cpix = m0 + cr < M ? mm_sm90::src_pixel(a, m0 + cr) : -1;
  const int fr = (warp >> 2) * 64 + (warp & 3) * 16 + (lane >> 2);
  const int lrow = fr - (lane >> 2) + (lane & 15);

  // the bulk tensor copies' bytes per slot: the raw W slice, and x at
  // stride 1; after the last slice, item ns is the res tile
  const int tma_bytes = C::kWRawBytes + (tma_x ? C::kABytes : 0);
  const bool has_res = a.res != nullptr;
  if (tid == 0) {
    for (int b = 0; b < S; ++b) sm90::mbar_init(bars + 8 * b);
    sm90::mbar_init_fence();
  }
  __syncthreads();

  // slice sl into slot sl % S: thread 0's bulk tensor copies (W; x at
  // stride 1, f32 as two 32-channel boxes), cp.async for a strided x;
  // item ns the res tile, by thread 0
  auto issue = [&](int sl) {
    if (sl > ns || (sl == ns && !has_res)) return;
    const uint32_t s0 = sbase + (sl % S) * C::kSlotBytes;
    const uint32_t bar = bars + 8 * (sl % S);
    if (sl == ns) {   // res, 128 rows of 64 columns as 128-byte subtiles
      if (tid == 0) {
        sm90::mbar_expect(bar, kBM * kBN * sizeof(Tx));
#pragma unroll
        for (int h = 0; h < static_cast<int>(sizeof(Tx)) / 2; ++h)
          sm90::tma_load_2d(s0 + h * kBM * 128, &maps.r,
                            n0 + h * (128 / static_cast<int>(sizeof(Tx))),
                            m0, bar);
      }
      return;
    }
    if (tid == 0) {
      sm90::mbar_expect(bar, tma_bytes);
      if (tma_x) {
#pragma unroll
        for (int h = 0; h < static_cast<int>(sizeof(Tx)) / 2; ++h)
          sm90::tma_load_2d(s0 + h * kBM * 128, &maps.x,
                            sl * 64 + h * 32, m0, bar);
      }
      sm90::tma_load_2d(s0 + C::kABytes, &maps.w, n0, sl * 64, bar);
    }
    if (!tma_x)
      mm_sm90::copy_arow<Tx>(s0, x, cpix, cin, sl * 64, cr, tid & 1);
  };
#pragma unroll
  for (int sl = 0; sl < D; ++sl) {
    issue(sl);
    sm90::cp_async_commit();
  }

  float acc[32];   // a group's first product overwrites it
  float sum[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) sum[i] = 0.f;
  uint32_t hi0[4][4], lo0[4][4], hi1[4][4], lo1[4][4];

  // One group: its fragments form while the group before multiplies;
  // once that one is done (no wgmma in flight: ptxas serialises every
  // wgmma of a function whose accumulators are read while one may be
  // pending) its sums join the running sum, and this group's products
  // are issued.
  auto group = [&](uint32_t (&hi)[4][4], uint32_t (&lo)[4][4],
                   uint32_t aslot, uint32_t btiles, int gi, int c0,
                   bool first) {
    group_fragments<Tx, kALo, !kWLo>(hi, lo, a, aslot, gi, lrow, lane, c0,
                                     pro);
    const uint32_t bhi = btiles + gi * 2 * kHalfBytes;
    const uint32_t blo = bhi + kHalfBytes;
    sm90::wgmma_wait<0>();
    if (!first) {
      sm90::fence_regs(acc);
#pragma unroll
      for (int i = 0; i < 32; ++i) sum[i] += acc[i];
    }
    sm90::fence_regs(hi);
    if constexpr (kALo) sm90::fence_regs(lo);
    sm90::wgmma_fence();
    // the small terms first, then A_hi W_hi onto them; the group's first
    // product overwrites the accumulator
    if constexpr (kALo) {
#pragma unroll
      for (int s = 0; s < 4; ++s)
        sm90::wgmma_m64n64k8_tf32(acc, lo[s], sm90::kmajor_desc(bhi, s),
                                  s > 0);
    }
    if constexpr (kWLo) {
#pragma unroll
      for (int s = 0; s < 4; ++s)
        sm90::wgmma_m64n64k8_tf32(acc, hi[s], sm90::kmajor_desc(blo, s),
                                  kALo || s > 0);
    }
#pragma unroll
    for (int s = 0; s < 4; ++s)
      sm90::wgmma_m64n64k8_tf32(acc, hi[s], sm90::kmajor_desc(bhi, s),
                                kALo || kWLo || s > 0);
    sm90::wgmma_commit();
  };

  // slice sl's W split into buffer sl & 1, once its bytes have landed
  auto split_slice = [&](int sl) {
    sm90::mbar_wait(bars + 8 * (sl % S), (sl / S) & 1);
    split_w<Tx, Tw>(split + (sl & 1) * kSplitBytes,
                    reinterpret_cast<const Tw*>(smem + (sl % S) *
                                                C::kSlotBytes + C::kABytes),
                    tid);
    sm90::fence_proxy_async();
  };

  // Each slice's products run while the next slice's W is split: its
  // first group is issued, every warpgroup is past the slice before
  // (whose products read the buffer the split overwrites), the next
  // split runs, then the second group.
  split_slice(0);
  for (int sl = 0; sl < ns; ++sl) {
    sm90::cp_async_wait<D - 1>();
    __syncthreads();
    issue(sl + D);
    sm90::cp_async_commit();
    const uint32_t s0 = sbase + (sl % S) * C::kSlotBytes;
    const uint32_t bt = sp_base + (sl & 1) * kSplitBytes;
    group(hi0, lo0, s0, bt, 0, sl * 64, sl == 0);
    if (sl + 1 < ns) {
      __syncthreads();
      split_slice(sl + 1);
    }
    group(hi1, lo1, s0, bt, 1, sl * 64, false);
  }
  sm90::wgmma_wait<0>();
  sm90::fence_regs(acc);
#pragma unroll
  for (int i = 0; i < 32; ++i) sum[i] += acc[i];

  sm90::cp_async_wait<0>();
  __syncthreads();
  fold_epilogue<Tx>(a, maps, sum,
                    smem + ((ns - 1) % S) * C::kSlotBytes,
                    has_res ? smem + (ns % S) * C::kSlotBytes : nullptr,
                    has_res ? bars + 8 * (ns % S) : 0u, (ns / S) & 1, m0,
                    n0, fr, tid);
  if (tid == 0) sm90::bulk_wait_read();
}

// Launches one instance (x and y f32 or bf16; the grid M tiles by
// N / 64); returns cudaGetLastError().
template <typename Tx, typename Tw, bool kALo>
inline int launch_tile(const ConvBnArgs& a, cudaStream_t stream) {
  constexpr int bytes = Cfg<Tx, Tw>::kSmem;
  const int M = a.B * a.Ho * a.Wo;
  // x by TMA where its rows are the tile's rows (stride 1): 128-byte
  // boxes of 64 bf16 or 32 f32 channels; W's raw slices as they lie
  const int tma_x = a.stride == 1;
  mm_sm90::Maps maps = {};
  int err = mm_sm90::tensor_map_2d(&maps.w, a.w, sizeof(Tw), a.N, a.Cin,
                                   kBN, 64, false);
  // y and res as 128-byte subtiles: 64 bf16 or 32 f32 columns
  err |= mm_sm90::tensor_map_2d(&maps.y, a.y, sizeof(Tx), a.N, M,
                                128 / sizeof(Tx), kBM);
  if (a.res != nullptr)
    err |= mm_sm90::tensor_map_2d(&maps.r, a.res, sizeof(Tx), a.N, M,
                                  128 / sizeof(Tx), kBM);
  if (tma_x)
    err |= mm_sm90::tensor_map_2d(&maps.x, a.x, sizeof(Tx), a.Cin, M,
                                  128 / sizeof(Tx), kBM);
  if (err != 0) return err;
  static int allowed = 0;   // the shared memory this instance allows
  if (bytes > allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        matmul_bn_apply_sm90_kernel<Tx, Tw, kALo>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    allowed = bytes;
  }
  const dim3 grid((M + kBM - 1) / kBM, a.N / kBN);
  note_launch("matmul_bn_apply_sm90_kernel<%s, %s, %s>", type_name<Tx>(),
              type_name<Tw>(), bool_name(kALo));
  matmul_bn_apply_sm90_kernel<Tx, Tw, kALo>
      <<<grid, kThreads, bytes, stream>>>(a, tma_x, maps);
  return static_cast<int>(cudaGetLastError());
}

// The instance a route names (`fold_route` in ops/conv_bn.py): 0, f32
// weights in three passes; 1, f32 weights in two, which takes only a
// bf16 x without a prologue (its A_lo is zero); 3, bf16 weights with an
// f32 x, one pass. Route 2 (bf16 x and weights) runs matmul_bn_sm90.cuh.
inline int launch(const ConvBnArgs& a, int x_bf16, int route,
                  cudaStream_t stream) {
  using B = __nv_bfloat16;
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (route == 0)
    return x_bf16 ? launch_tile<B, float, true>(a, stream)
                  : launch_tile<float, float, true>(a, stream);
  if (route == 1)
    return x_bf16 && !a.affine_in && !a.relu_in
               ? launch_tile<B, float, false>(a, stream)
               : bad;
  if (route == 3)
    return x_bf16 ? bad : launch_tile<float, B, false>(a, stream);
  return bad;
}

}  // namespace apply_sm90
}  // namespace zoo
