// The dW half of the training 1x1 conv + BN backward in bf16 for Hopper
// (sm_90a): a split-M GEMM on warpgroup MMA (wgmma) fed by a ring of
// asynchronous copies.
//
// Replaces the TPU's Pallas kernel `_dw_kernel` of
// analytics_zoo_tpu/ops/conv_bn.py (driver `_bwd_pallas`), and on this
// card conv_bn_bwd.cuh's mma.sync dW kernel, which keeps the f32 path.
// Over one chunk of M rows it computes the (BK, BN) tile of
//     dW partial = xp^T @ g,
//     xp[m, k] = relu_in?(affine_in?(x s + t) [+ r])   (rounded to bf16)
//     g[m, n] = dy + dsum + 2 (y - sh) dsq              (rounded to bf16)
// with f32 accumulation; rows past M count zero (g is zero there). Each
// split writes its f32 partial once and colsum.cuh adds the splits in a
// fixed order, so a launch repeats bit for bit.
//
// What bounds it on the H100: 2 M K N FLOP against reading x (and r)
// (M, K) and dy, y (M, N) once. At ResNet-50's early train-step shapes
// (K or N of 64-256, M up to 401,408) that is under 100 FLOP per byte:
// bound by bytes. At the late ones (K N up to 2048 x 512 over M 6,272)
// it nears or passes the bf16 ridge (about 295 FLOP per byte): bound by
// operations. The design it replaces (64x64 tiles over 32-row slices,
// g and xp recomputed with the column constants read from device
// memory per element, both operands transposed by scalar shared stores,
// no copy in flight) took 0.096-0.674 ms per call, 14.187 ms per bf16
// train step (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py), 7.4x
// cuBLAS's x^T dy.
//
// The design:
// - Tiles: dW tile BK x BN with BK = 128 (64 where K = 64) and BN = 128
//   (64 where N = 64): g is formed K / BK times in all, xp N / BN
//   times. Two warpgroups: at BK = 128 each owns 64 rows; at BK = 64
//   both own the same 64 rows and take alternate k16 steps of every
//   slice, their sums added in a fixed order at the end.
// - Copies in flight: a ring of 3 stages of raw 64-row slices of x, r
//   (when present), dy and y, filled by 16-byte cp.async (zeros past the
//   chunk), so slices i + 1 and i + 2 load while slice i is multiplied.
// - Constants once per block: each thread forms g for a fixed 8 columns,
//   so their dsum, sh and 2 dsq sit in registers for the whole loop; its
//   xp rows are fixed too, so are their s and t.
// - The operands: g = dy + dsum + 2 (y - sh) dsq is formed once per
//   slice from the raw dy and y and stored as the bf16 B tile in
//   wgmma's 128-byte-swizzled MN-major layout (wgmma_sm90.cuh: the same
//   GCols transform and tile layout serve B3's redesign); xp is formed
//   as x (and r) move from the raw slice into the A registers by
//   ldmatrix.trans (x is [m][k], A is [k][m]); without an affine, ReLU
//   or residual, x goes in as it is.
// - Overlap: two g tiles and two A register sets alternate, so one
//   slice's wgmma group stays in flight while the next slice's g and xp
//   form.
// - The split: dw_splits in ops/conv_bn.py fills one wave of blocks
//   (two per SM for 64-column tiles, else one) with as few, large chunks
//   as that takes, multiples of the 64-row slice; dw_sum_kernel then adds
//   the splits in a fixed order straight into the bf16 dW.

#pragma once

#include "conv_bn_bwd.cuh"
#include "wgmma_sm90.cuh"

namespace zoo {
namespace dw_sm90 {

using sm90::smem_u32;

constexpr int kThreads = 256;
constexpr int kStages = 3;
constexpr int kRows = sm90::kSliceRows;

template <int BK, int BN>
struct Cfg {
  static constexpr int kXBytes = kRows * BK * 2;
  static constexpr int kDyBytes = kRows * BN * 2;
  static constexpr int kGBytes = kRows * BN * 2;
  static constexpr int kMinBlocks = BN == 64 ? 2 : 1;
};

// Bytes of one ring stage and of a block's dynamic shared memory.
template <int BK, int BN>
inline int stage_bytes(bool residual) {
  using C = Cfg<BK, BN>;
  return C::kXBytes * (residual ? 2 : 1) + 2 * C::kDyBytes;
}
template <int BK, int BN>
inline int smem_bytes(bool residual) {
  return 2 * Cfg<BK, BN>::kGBytes +
         kStages * stage_bytes<BK, BN>(residual) + 1024;
}

// One k16 A fragment of xp from the raw x (and r) slice (layouts in
// wgmma_sm90.cuh): registers 0, 2 hold row k of s0/t0, 1, 3 row k + 8.
__device__ __forceinline__ void xp_fragment(uint32_t (&a)[4],
                                            const uint32_t (&rr)[4],
                                            bool has_r, const float (&s)[2],
                                            const float (&t)[2],
                                            int affine_in, int relu_in) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    float2 v = sm90::unpack_bf16x2(a[e]);
    const int h = e & 1;
    if (affine_in) {
      v.x = fmaf(v.x, s[h], t[h]);
      v.y = fmaf(v.y, s[h], t[h]);
    }
    if (has_r) {
      const float2 r = sm90::unpack_bf16x2(rr[e]);
      v.x += r.x;
      v.y += r.y;
    }
    if (relu_in) {
      v.x = fmaxf(v.x, 0.f);
      v.y = fmaxf(v.y, 0.f);
    }
    a[e] = sm90::pack_bf16x2(v.x, v.y);
  }
}

template <int BK, int BN>
__global__ void __launch_bounds__(kThreads, (Cfg<BK, BN>::kMinBlocks))
    matmul_bn_dw_sm90_kernel(BwdArgs a, int stage) {
  using C = Cfg<BK, BN>;
  constexpr bool kSplitK16 = BK == 64;   // both warpgroups on 64 rows
  constexpr int kXChunks = BK / 8;       // 16-byte chunks per x row
  constexpr int kNChunks = BN / 8;       // per dy, y and g row
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t gtile = smem_u32(smem);   // two g tiles, alternating
  const uint32_t ring = gtile + 2 * C::kGBytes;
  uint8_t* ring_ptr = smem + 2 * C::kGBytes;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wg = warp >> 2;
  const int q = warp & 3;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int k0 = blockIdx.x * BK;
  const int n0 = blockIdx.y * BN;
  const int mb = blockIdx.z * a.m_chunk;
  const int me = min(a.M, mb + a.m_chunk);
  const int nslices = (me - mb + kRows - 1) / kRows;
  const bool has_r = a.r != nullptr;
  const bool pro = a.affine_in || a.relu_in || has_r;   // else xp = x
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(a.x);
  const __nv_bfloat16* r = static_cast<const __nv_bfloat16*>(a.r);
  const __nv_bfloat16* dy = static_cast<const __nv_bfloat16*>(a.dy);
  const __nv_bfloat16* y = static_cast<const __nv_bfloat16*>(a.y);
  const uint32_t xoff = 0;
  const uint32_t roff = C::kXBytes;
  const uint32_t dyoff = C::kXBytes * (has_r ? 2 : 1);
  const uint32_t yoff = dyoff + C::kDyBytes;

  // g role (and dy/y copy role): columns gj, rows gr0 + i * kGStep
  constexpr int kGStep = kThreads / kNChunks;
  const int gj = tid % kNChunks;
  const int gr0 = tid / kNChunks;
  sm90::GCols gc;
  gc.load(a.dsum, a.sh, a.dsq, n0 + gj * 8);

  // A role: dW rows kr and kr + 8 of the tile
  const int kr = (kSplitK16 ? 0 : wg * 64) + q * 16 + g;
  float s[2] = {1.f, 1.f}, t[2] = {0.f, 0.f};
  if (a.affine_in) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      s[h] = a.s[k0 + kr + 8 * h];
      t[h] = a.t[k0 + kr + 8 * h];
    }
  }

  auto issue = [&](int sl) {
    const int m = mb + sl * kRows;
    const uint32_t slot = ring + (sl % kStages) * stage;
#pragma unroll
    for (int c = tid; c < kRows * kXChunks; c += kThreads) {
      const int rr = c / kXChunks;
      const int j = c - rr * kXChunks;
      const bool ok = m + rr < me;
      const int64_t off =
          static_cast<int64_t>(ok ? m + rr : 0) * a.K + k0 + j * 8;
      const uint32_t dst = rr * (BK * 2) + ((j ^ (rr & 7)) << 4);
      sm90::cp_async16(slot + xoff + dst, x + off, ok ? 16 : 0);
      if (has_r) sm90::cp_async16(slot + roff + dst, r + off, ok ? 16 : 0);
    }
#pragma unroll
    for (int i = 0; i < kRows / kGStep; ++i) {
      const int rr = gr0 + i * kGStep;
      const bool ok = m + rr < me;
      const int64_t off =
          static_cast<int64_t>(ok ? m + rr : 0) * a.N + n0 + gj * 8;
      const uint32_t dst = rr * (BN * 2) + gj * 16;
      sm90::cp_async16(slot + dyoff + dst, dy + off, ok ? 16 : 0);
      sm90::cp_async16(slot + yoff + dst, y + off, ok ? 16 : 0);
    }
  };

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

#pragma unroll
  for (int sl = 0; sl < kStages - 1; ++sl) {
    if (sl < nslices) issue(sl);
    sm90::cp_async_commit();
  }

  // One slice: its raw copies landed, those of slice + 2 start, g goes
  // into the g tile of the slice's parity, xp into the A registers of
  // that parity, and its products are issued; the products of the slice
  // before run on meanwhile (one wgmma group stays in flight).
  constexpr int kSteps = kSplitK16 ? 2 : 4;
  auto step = [&](int sl, uint32_t (&af)[kSteps][4]) {
    sm90::cp_async_wait<kStages - 2>();
    __syncthreads();
    if (sl + kStages - 1 < nslices) issue(sl + kStages - 1);
    sm90::cp_async_commit();

    const int m = mb + sl * kRows;
    const uint32_t slot_off = (sl % kStages) * stage;
    const uint8_t* slot = ring_ptr + slot_off;
    const uint32_t gbuf = (sl & 1) * C::kGBytes;
#pragma unroll
    for (int i = 0; i < kRows / kGStep; ++i) {
      const int rr = gr0 + i * kGStep;
      const uint32_t src = rr * (BN * 2) + gj * 16;
      const uint4 dv = *reinterpret_cast<const uint4*>(slot + dyoff + src);
      const uint4 yv = *reinterpret_cast<const uint4*>(slot + yoff + src);
      *reinterpret_cast<uint4*>(smem + gbuf + sm90::btile_offset(rr, gj)) =
          gc.g(dv, yv, m + rr < me);
    }
    sm90::fence_proxy_async();
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      const int kk = kSplitK16 ? 2 * wg + i : i;
      const int mrow = kk * 16 + ((lane >> 4) & 1) * 8 + (lane & 7);
      const int chunk = (kr - g) / 8 + ((lane >> 3) & 1);
      const uint32_t off = mrow * (BK * 2) + ((chunk ^ (mrow & 7)) << 4);
      sm90::ldsm_x4_trans(ring + slot_off + xoff + off, af[i]);
      if (pro) {
        uint32_t rf[4] = {0u, 0u, 0u, 0u};
        if (has_r) sm90::ldsm_x4_trans(ring + slot_off + roff + off, rf);
        xp_fragment(af[i], rf, has_r, s, t, a.affine_in, a.relu_in);
      }
    }
    sm90::fence_regs(af);
    sm90::wgmma_fence();
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      const int kk = kSplitK16 ? 2 * wg + i : i;
      sm90::wgmma_tile<BN>(acc, af[i], sm90::btile_desc(gtile + gbuf, kk));
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<1>();
  };
  uint32_t af0[kSteps][4], af1[kSteps][4];
  for (int sl = 0; sl < nslices; sl += 2) {
    step(sl, af0);
    if (sl + 1 < nslices) step(sl + 1, af1);
  }
  sm90::wgmma_wait<0>();
  sm90::fence_regs(acc);

  if constexpr (kSplitK16) {
    // the second warpgroup's sums join the first's, in that order
    sm90::cp_async_wait<0>();
    __syncthreads();
    float* red = reinterpret_cast<float*>(ring_ptr);
    const int lt = tid & 127;
    if (wg == 1) {
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) red[e * 128 + lt] = acc[e];
    }
    __syncthreads();
    if (wg == 1) return;
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) acc[e] += red[e * 128 + lt];
  }
  float* p = a.partial + static_cast<int64_t>(blockIdx.z) * a.K * a.N;
#pragma unroll
  for (int i = 0; i < BN / 8; ++i) {
    const int col = n0 + 8 * i + 2 * t4;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      store2(p + static_cast<int64_t>(k0 + kr + 8 * h) * a.N + col,
             acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
  }
}

// The splits' sum, rounded to bf16: dw[i] = sum over splits s, in order,
// of partial[s][i] (K N a multiple of 128). Thread (x, y) of a 32 x 8
// block sums splits y, y + 8, ... of 4 consecutive elements, then row
// y = 0 adds the 8 sums in order: a fixed order, so a launch repeats bit
// for bit. It replaces colsum.cuh's pass, the f32 dW and its cast on
// this path (three launches and their traffic, which cost more than the
// products at the late stages' K N of up to 1M).
__global__ void __launch_bounds__(256)
    dw_sum_kernel(const float* partial, int splits, int64_t kn,
                  __nv_bfloat16* dw) {
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int64_t i = (static_cast<int64_t>(blockIdx.x) * 32 + tx) * 4;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int sp = ty; sp < splits; sp += 8) {
    const float4 v =
        *reinterpret_cast<const float4*>(partial + sp * kn + i);
    acc.x += v.x;
    acc.y += v.y;
    acc.z += v.z;
    acc.w += v.w;
  }
  __shared__ float4 red[8][32];
  red[ty][tx] = acc;
  __syncthreads();
  if (ty != 0) return;
#pragma unroll
  for (int j = 1; j < 8; ++j) {
    const float4 v = red[j][tx];
    acc.x += v.x;
    acc.y += v.y;
    acc.z += v.z;
    acc.w += v.w;
  }
  uint2 out;
  out.x = sm90::pack_bf16x2(acc.x, acc.y);
  out.y = sm90::pack_bf16x2(acc.z, acc.w);
  *reinterpret_cast<uint2*>(dw + i) = out;
}

template <int BK, int BN>
inline int launch_tile(const BwdArgs& a, int splits, cudaStream_t stream) {
  static int attr_bytes = 0;   // the shared memory this instance allows
  const bool residual = a.r != nullptr;
  const int bytes = smem_bytes<BK, BN>(residual);
  if (bytes > attr_bytes) {
    const cudaError_t e = cudaFuncSetAttribute(
        matmul_bn_dw_sm90_kernel<BK, BN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_bytes = bytes;
  }
  const dim3 grid(a.K / BK, a.N / BN, splits);
  note_launch("matmul_bn_dw_sm90_kernel<%d, %d>", BK, BN);
  matmul_bn_dw_sm90_kernel<BK, BN><<<grid, kThreads, bytes, stream>>>(
      a, stage_bytes<BK, BN>(residual));
  return static_cast<int>(cudaGetLastError());
}

// The bf16 dW of `splits` chunks of a.m_chunk rows on BK x BN tiles
// (each 64 or 128; `dw_tile` in ops/conv_bn.py picks them): the partials
// into a.partial (splits, K, N) f32, then their fixed-order sum into dw
// (K, N) bf16.
inline int launch(const BwdArgs& a, int splits, int bk, int bn, void* dw,
                  cudaStream_t stream) {
  int err;
  if (bk == 128 && bn == 128)
    err = launch_tile<128, 128>(a, splits, stream);
  else if (bk == 128 && bn == 64)
    err = launch_tile<128, 64>(a, splits, stream);
  else if (bk == 64 && bn == 128)
    err = launch_tile<64, 128>(a, splits, stream);
  else if (bk == 64 && bn == 64)
    err = launch_tile<64, 64>(a, splits, stream);
  else
    err = static_cast<int>(cudaErrorInvalidValue);
  if (err != 0) return err;
  const int64_t kn = static_cast<int64_t>(a.K) * a.N;
  dw_sum_kernel<<<static_cast<unsigned>(kn / 128), dim3(32, 8), 0,
                  stream>>>(a.partial, splits, kn,
                            static_cast<__nv_bfloat16*>(dw));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dw_sm90
}  // namespace zoo
