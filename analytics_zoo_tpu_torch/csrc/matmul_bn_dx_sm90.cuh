// The dx half of the training 1x1 conv + BN backward in bf16 for Hopper
// (sm_90a): a GEMM over N on warpgroup MMA (wgmma) fed by a ring of
// asynchronous copies, with the cotangent formed on the way in and the
// ReLU mask, scale and ds/dt sums on the way out.
//
// Replaces the TPU's Pallas kernel `_dx_kernel` of
// analytics_zoo_tpu/ops/conv_bn.py (driver `_bwd_pallas`), and on this
// card conv_bn_bwd.cuh's mma.sync dx kernel, which keeps the f32 path.
// For a tile of 128 rows m by BK columns k it computes
//     g[m, n] = dy + dsum + 2 (y - sh) dsq              (rounded to bf16)
//     dxp[m, k] = mask(sum_n g[m, n] W[k, n]),  mask = relu_in? xa > 0 : 1
//     xa[m, k] = affine_in?(x s + t) [+ r]
//     dx = affine_in? dxp s : dxp;  dr = dxp;
//     ds[k], dt[k]: this tile's sum_m dxp x and sum_m dxp
// with f32 accumulation; rows past M are zero in g and never stored.
// Each M tile writes one ds/dt partial row and colsum.cuh adds the rows
// in a fixed order, so a launch repeats bit for bit.
//
// What bounds it on the H100: 2 M K N FLOP against reading dy and y
// (M, N), x (M, K) where a prologue needs it (and r), writing dx (and
// dr). At ResNet-50's train-step shapes (batch 128) that is under 200
// FLOP per byte at all but the two late 2048-wide shapes: bound by
// bytes, 2.063 ms per step at 3.35 TB/s. The design it replaces (64x64 tiles, so every
// block formed g from the raw dy and y over all of N and the strips were
// read and transformed K / 64 times, up to 32 times; 32-deep slices
// through shared memory without double buffering; mma.sync; an
// epilogue moving x, r, dx and dr two bytes at a time) took 12.388 ms
// per bf16 train step (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py),
// 7.1x cuBLAS's g W^T.
//
// The design:
// - Tiles: 128 rows (two warpgroups of 64) by BK = 64, 128 or 256
//   columns (`dx_tile` in ops/conv_bn.py: min(K, 256), narrowed where
//   the M tiles are too few to fill the SMs), so g is formed once per M
//   tile up to K 256 and K / 256 times above (at most 8, not 32).
// - Copies in flight: a ring of 3 slots (2 at BK 64, where two blocks
//   share an SM), each holding one 64-deep slice of the raw dy and y
//   rows and of W (BK rows of 64 n), filled by 16-byte cp.async a slot
//   ahead of the one in use (zeros past M). The rows, from device
//   memory, are issued as soon as their slot's g has formed; the W
//   slice, from L2, once the products that read the slot are done.
//   Once the slices run out, the free slots take the x tile and the r
//   tile, so the epilogue's inputs arrive while the last slices
//   multiply.
// - Operands: g is formed once per slice from the raw dy and y (GCols,
//   wgmma_sm90.cuh) into a 128-byte-swizzled shared tile and taken into
//   registers by ldmatrix as the A operand. B = W^T has the reduction
//   index n contiguous, so the W slice is copied as it lies into a
//   K-major 128-byte-swizzled tile (kmajor_desc, transpose flag clear):
//   no transpose anywhere.
// - Overlap: one wgmma group stays in flight while the next slice's g
//   forms; it is waited for before the fragments load (so no other
//   instruction defines a wgmma input while one is pending, which
//   ptxas would answer by serialising every wgmma) and before its W
//   slot is refilled.
// - Epilogue from the f32 accumulators: the mask and scale against the
//   staged x (and r) tiles, dx (and dr) written back into those tiles in
//   place and stored in 16-byte rows; each column's ds/dt over the rows
//   by shuffles, then across the eight warps in a fixed order into the M
//   tile's partial row. Without a prologue (20 of the step's 36 calls)
//   dx is g W^T alone: x is not read, its slot only stages dx.
// - Tried on the card and not kept: a persistent version (one wave of
//   blocks walking the tiles, the next tile's slices loading during an
//   epilogue) ran 5% slower; asking L2 to fetch 256-byte blocks around
//   the dy and y reads, 3% slower; waiting for the products before g
//   forms, so that every copy can start early, 2% slower.

#pragma once

#include "conv_bn_bwd.cuh"
#include "wgmma_sm90.cuh"

namespace zoo {
namespace dx_sm90 {

using sm90::smem_u32;

constexpr int kBM = 128;
constexpr int kThreads = 256;
constexpr int kSlice = sm90::kSliceRows;   // reduction depth (n)

template <int BK>
struct Cfg {
  // ring slots, items issued kStages - 1 ahead; at BK 64 two blocks
  // share an SM (one's fill and epilogue overlap the other's slices)
  static constexpr int kStages = BK == 64 ? 2 : 3;
  static constexpr int kMinBlocks = BK == 64 ? 2 : 1;
  static constexpr int kGBytes = kBM * 128;          // the g slice
  static constexpr int kDyBytes = kBM * 128;         // raw dy (or y) slice
  static constexpr int kWBytes = BK * 128;           // W slice, K-major
  static constexpr int kSlotBytes = 2 * kDyBytes + kWBytes;
  static constexpr int kTileBytes = kBM * BK * 2;    // x or r tile
  static constexpr int kRedBytes = (kThreads / 32) * 2 * BK * 4;
  static constexpr int kSmem = kGBytes + kStages * kSlotBytes + 1024;
  static_assert(kTileBytes <= kSlotBytes, "x and r tiles fill a slot");
  static_assert(kRedBytes <= kGBytes, "ds/dt sums fill the g tile");
};

// Byte offset of chunk j (columns 8j .. 8j + 7) of row r in a staged x,
// r or dx tile of BK columns: rows of 2 BK bytes, the chunk swizzled
// within its 128-byte group, so the fragment-layout reads of a warp hit
// 32 distinct banks.
template <int BK>
__device__ __forceinline__ uint32_t tile_offset(int r, int j) {
  return r * (BK * 2) + (((j & ~7) | ((j ^ r) & 7)) << 4);
}

template <int BK>
__global__ void __launch_bounds__(kThreads, Cfg<BK>::kMinBlocks)
    matmul_bn_dx_sm90_kernel(BwdArgs a) {
  using C = Cfg<BK>;
  constexpr int S = C::kStages;
  constexpr int D = S - 1;   // issue distance, in items
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t gtile = smem_u32(smem);
  const uint32_t ring = gtile + C::kGBytes;
  uint8_t* ring_ptr = smem + C::kGBytes;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int m0 = blockIdx.x * kBM;
  const int k0 = blockIdx.y * BK;
  const int ns = a.N / kSlice;
  const bool has_r = a.r != nullptr;
  // x feeds the mask, the scale and ds; without a prologue dx = g W^T
  // and x is never read (its slot only stages dx)
  const bool need_x = a.affine_in || a.relu_in || has_r;
  // items, each in ring slot item % S: the ns slices, then the x tile,
  // then the r tile
  const int nitems = ns + 1 + (has_r ? 1 : 0);
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(a.x);
  const __nv_bfloat16* r = static_cast<const __nv_bfloat16*>(a.r);
  const __nv_bfloat16* dy = static_cast<const __nv_bfloat16*>(a.dy);
  const __nv_bfloat16* y = static_cast<const __nv_bfloat16*>(a.y);
  const __nv_bfloat16* w = static_cast<const __nv_bfloat16*>(a.w);

  // the raw dy and y rows of slice sl (the early copies: their slot's
  // rows were consumed when the slice before formed its g)
  auto issue_rows = [&](int sl) {
    if (sl >= ns) return;
    const uint32_t slot = ring + (sl % S) * C::kSlotBytes;
    const int n0 = sl * kSlice;
#pragma unroll
    for (int c = tid; c < kBM * 8; c += kThreads) {
      const int rr = c >> 3;
      const int j = c & 7;
      const bool ok = m0 + rr < a.M;
      const int64_t off =
          static_cast<int64_t>(ok ? m0 + rr : 0) * a.N + n0 + j * 8;
      const uint32_t dst = rr * 128 + (j << 4);
      sm90::cp_async16(slot + dst, dy + off, ok ? 16 : 0);
      sm90::cp_async16(slot + C::kDyBytes + dst, y + off, ok ? 16 : 0);
    }
  };
  // the rest of an item: a slice's W, or the x or r tile (the late
  // copies: their slot's W was read by products that must be done)
  auto issue_late = [&](int item) {
    if (item >= nitems || (item == ns && !need_x)) return;
    const uint32_t slot = ring + (item % S) * C::kSlotBytes;
    if (item < ns) {
      const int n0 = item * kSlice;
#pragma unroll
      for (int c = tid; c < BK * 8; c += kThreads) {
        const int kr = c >> 3;
        const int j = c & 7;
        sm90::cp_async16(
            slot + 2 * C::kDyBytes + sm90::row128_offset(kr, j),
            w + static_cast<int64_t>(k0 + kr) * a.N + n0 + j * 8, 16);
      }
    } else {
      const __nv_bfloat16* src = item == ns ? x : r;
      constexpr int kChunks = BK / 8;
#pragma unroll
      for (int c = tid; c < kBM * kChunks; c += kThreads) {
        const int rr = c / kChunks;
        const int j = c - rr * kChunks;
        const bool ok = m0 + rr < a.M;
        sm90::cp_async16(
            slot + tile_offset<BK>(rr, j),
            src + static_cast<int64_t>(ok ? m0 + rr : 0) * a.K + k0 + j * 8,
            ok ? 16 : 0);
      }
    }
  };

  // g role: chunk gj (columns 8 gj ..) of rows gr0 + 32 i
  const int gj = tid & 7;
  const int gr0 = tid >> 3;
  // fragment rows: warp q of warpgroup wg owns rows 64 wg + 16 q + g, + 8;
  // lrow is this lane's ldmatrix row
  const int fr = (warp >> 2) * 64 + (warp & 3) * 16 + g;
  const int lrow = fr - g + (lane & 15);

  // every item is two copy groups, rows then the rest (either may be
  // empty), committed in item order: the waits count groups
#pragma unroll
  for (int it = 0; it < D; ++it) {
    issue_rows(it);
    sm90::cp_async_commit();
    issue_late(it);
    sm90::cp_async_commit();
  }

  // One slice: its copies landed; the rows of the slice D ahead start;
  // g forms from the raw dy and y into the g tile while the slice before
  // multiplies; once those products are done, g goes into the A
  // registers, the item D ahead gets the rest of its copies (into the
  // slot the slice before used), and this slice's products are issued.
  float acc[BK / 2];   // the first product overwrites it (scale-d 0)
  uint32_t af[4][4];
  for (int sl = 0; sl < ns; ++sl) {
    sm90::GCols gc;   // loaded before the wait, which hides its latency
    gc.load(a.dsum, a.sh, a.dsq, sl * kSlice + gj * 8);
    sm90::cp_async_wait<2 * (D - 1)>();
    sm90::fence_proxy_async();
    __syncthreads();
    issue_rows(sl + D);
    sm90::cp_async_commit();
    const uint8_t* raw = ring_ptr + (sl % S) * C::kSlotBytes;
#pragma unroll
    for (int i = 0; i < kBM / 32; ++i) {
      const int rr = gr0 + 32 * i;
      const uint32_t src = rr * 128 + (gj << 4);
      const uint4 dv = *reinterpret_cast<const uint4*>(raw + src);
      const uint4 yv =
          *reinterpret_cast<const uint4*>(raw + C::kDyBytes + src);
      *reinterpret_cast<uint4*>(smem + sm90::row128_offset(rr, gj)) =
          gc.g(dv, yv, m0 + rr < a.M);
    }
    __syncthreads();
    sm90::wgmma_wait<0>();
    sm90::load_fragments(af, gtile, lrow, lane, true, true);
    __syncthreads();   // every warpgroup's products of sl - 1 are done
    issue_late(sl + D);
    sm90::cp_async_commit();
    const uint32_t wslot = ring + (sl % S) * C::kSlotBytes + 2 * C::kDyBytes;
    sm90::fence_regs(af);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      sm90::wgmma_tile<BK, 0>(acc, af[kk], sm90::kmajor_desc(wslot, kk),
                              sl + kk > 0);
    sm90::wgmma_commit();
  }
  sm90::wgmma_wait<0>();
  sm90::fence_regs(acc);
  if (ns + D < nitems) {   // a 2-slot ring: r goes where the last slice was
    __syncthreads();
    issue_late(ns + D);
    sm90::cp_async_commit();
  }
  sm90::cp_async_wait<0>();
  __syncthreads();

  // epilogue: x in slot ns, r in slot ns + 1 (mod S); dx and dr go back
  // into them in place; the ds/dt sums per warp into the g tile's space
  uint8_t* xt = ring_ptr + (ns % S) * C::kSlotBytes;
  uint8_t* rt = ring_ptr + ((ns + 1) % S) * C::kSlotBytes;
  float* red = reinterpret_cast<float*>(smem);
  const bool sums = a.partial != nullptr;
  if (!need_x) {
#pragma unroll
    for (int i = 0; i < BK / 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<uint32_t*>(
            xt + tile_offset<BK>(fr + 8 * h, i) + 4 * t4) =
            sm90::pack_bf16x2(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
  } else {
#pragma unroll
    for (int i = 0; i < BK / 8; ++i) {
      const int col = 8 * i + 2 * t4;
      float2 s = make_float2(1.f, 1.f), t = make_float2(0.f, 0.f);
      if (a.affine_in) {
        s = *reinterpret_cast<const float2*>(a.s + k0 + col);
        t = *reinterpret_cast<const float2*>(a.t + k0 + col);
      }
      float cs[2] = {0.f, 0.f}, ct[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t off = tile_offset<BK>(fr + 8 * h, i) + 4 * t4;
        uint32_t* xp = reinterpret_cast<uint32_t*>(xt + off);
        uint32_t* rp = reinterpret_cast<uint32_t*>(rt + off);
        const float2 xv = sm90::unpack_bf16x2(*xp);
        // the mask's input rounded as the plain version rounds it (a
        // product, then each sum; no fused multiply-add), so both agree
        // on its sign
        float2 xa = xv;
        if (a.affine_in) {
          xa.x = __fadd_rn(__fmul_rn(xv.x, s.x), t.x);
          xa.y = __fadd_rn(__fmul_rn(xv.y, s.y), t.y);
        }
        if (has_r) {
          const float2 rv = sm90::unpack_bf16x2(*rp);
          xa.x = __fadd_rn(xa.x, rv.x);
          xa.y = __fadd_rn(xa.y, rv.y);
        }
        float d0 = acc[4 * i + 2 * h];
        float d1 = acc[4 * i + 2 * h + 1];
        if (a.relu_in) {
          d0 = xa.x > 0.f ? d0 : 0.f;
          d1 = xa.y > 0.f ? d1 : 0.f;
        }
        *xp = a.affine_in ? sm90::pack_bf16x2(d0 * s.x, d1 * s.y)
                          : sm90::pack_bf16x2(d0, d1);
        if (has_r) *rp = sm90::pack_bf16x2(d0, d1);
        cs[0] += d0 * xv.x;
        cs[1] += d1 * xv.y;
        ct[0] += d0;
        ct[1] += d1;
      }
      if (sums) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
#pragma unroll
          for (int off = 4; off < 32; off <<= 1) {
            cs[e] += __shfl_xor_sync(0xffffffffu, cs[e], off);
            ct[e] += __shfl_xor_sync(0xffffffffu, ct[e], off);
          }
          if (g == 0) {
            red[(warp * 2) * BK + col + e] = cs[e];
            red[(warp * 2 + 1) * BK + col + e] = ct[e];
          }
        }
      }
    }
  }
  __syncthreads();
  __nv_bfloat16* dx = static_cast<__nv_bfloat16*>(a.dx);
  __nv_bfloat16* dr = static_cast<__nv_bfloat16*>(a.dr);
  constexpr int kChunks = BK / 8;
  for (int c = tid; c < kBM * kChunks; c += kThreads) {
    const int rr = c / kChunks;
    const int j = c - rr * kChunks;
    if (m0 + rr >= a.M) continue;
    const int64_t off = static_cast<int64_t>(m0 + rr) * a.K + k0 + j * 8;
    const uint32_t src = tile_offset<BK>(rr, j);
    *reinterpret_cast<uint4*>(dx + off) =
        *reinterpret_cast<const uint4*>(xt + src);
    if (dr != nullptr)
      *reinterpret_cast<uint4*>(dr + off) =
          *reinterpret_cast<const uint4*>(rt + src);
  }
  if (sums && tid < BK) {
    float s = 0.f, q = 0.f;
#pragma unroll
    for (int wi = 0; wi < kThreads / 32; ++wi) {
      s += red[(wi * 2) * BK + tid];
      q += red[(wi * 2 + 1) * BK + tid];
    }
    float* p = a.partial + static_cast<int64_t>(blockIdx.x) * 2 * a.K;
    p[k0 + tid] = s;
    p[a.K + k0 + tid] = q;
  }
}

template <int BK>
inline int launch_tile(const BwdArgs& a, cudaStream_t stream) {
  static int allowed = 0;   // the shared memory this instance allows
  constexpr int bytes = Cfg<BK>::kSmem;
  if (bytes > allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        matmul_bn_dx_sm90_kernel<BK>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    allowed = bytes;
  }
  const dim3 grid((a.M + kBM - 1) / kBM, a.K / BK);
  note_launch("matmul_bn_dx_sm90_kernel<%d>", BK);
  matmul_bn_dx_sm90_kernel<BK><<<grid, kThreads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Rows of the ds/dt partials: one per 128-row M tile.
inline int partial_rows(int M) { return (M + kBM - 1) / kBM; }

// The bf16 dx on 128 x bk tiles (bk 64, 128 or 256 dividing K; `dx_tile`
// in ops/conv_bn.py picks it); with a.partial, one ds/dt row per M tile.
inline int launch(const BwdArgs& a, int bk, cudaStream_t stream) {
  if (bk > a.K || a.K % bk) return static_cast<int>(cudaErrorInvalidValue);
  if (bk == 256) return launch_tile<256>(a, stream);
  if (bk == 128) return launch_tile<128>(a, stream);
  if (bk == 64) return launch_tile<64>(a, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace dx_sm90
}  // namespace zoo
