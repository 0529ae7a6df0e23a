// The flash-attention forward for Hopper (sm_90a) on warpgroup MMA
// (wgmma), fed by bulk tensor copies (TMA): one kernel template for both
// forward kernels and both operand types, at head dims 64 and 128.
//
// - `flash_fwd` (B7, kPartial false) writes the normalised output in q's
//   type;
// - `flash_block` (B8, kPartial true) writes the unnormalised f32
//   accumulator and the f32 row statistics m and l,
// under the contract flash_attn_fwd.cuh's note states: masked logits are
// -1e30 (a sample whose keys are all padding averages them uniformly),
// causal alignment is bottom-right at a runtime offset (any int for B8),
// a row that sees no key outputs 0 with m = -1e30 and l = 0, and q, k, v
// are read in place in (B, T, H, D) through their strides.
//
// Replaces the TPU's Pallas kernels of analytics_zoo_tpu/ops/
// flash_attention.py `_fwd_kernel[_masked]` (called from `_flash_fwd`)
// and `_block_kernel[_masked]` (called from `_block_partials`), at D 64
// and 128; D 32 and 256 keep flash_attn_fwd.cuh's kernels (`fwd_route`
// in ops/flash_attention.py names the route).
//
// What bounds it on the H100: 4 d FLOP per visible (query, key) pair
// against each operand read once, so by operations on BERT's and GPT's
// shapes. bf16 runs on the tensor cores at 989 TFLOP/s. f32 keeps the
// reference's f32 products as three tf32 passes (hi*hi + hi*lo + lo*hi
// of each operand's split, flash_sm90.cuh) at 495 TFLOP/s, a third of
// the FMA bound's time, each k8 step into a fresh accumulator added to
// the f32 sum with round-to-nearest (the tensor cores truncate). The
// kernels it replaces at D 64 took 0.687 (B8) and 0.685 (B7) ms per f32
// BERT-base launch (batch 16, T 512; FMA) and 0.137 and 0.114 in bf16
// (mma.sync), against SDPA's forward's 0.490 and 0.085 (NVIDIA H100
// 80GB HBM3, 700 W; chip_smoke.py).
//
// The design:
// - Tiles (Cfg, Tile; `fwd_tile` in ops/flash_attention.py): a block
//   owns 64 query rows per consumer warpgroup and walks key tiles of R
//   keys. A block of two warpgroups and the producer (nine warps) gets
//   at most 168 registers a thread from ptxas; f32 at D 64 spills a few
//   bytes there and is still the fastest tile measured.
// - Loads: the block's Q tile arrives once by TMA and stays. A producer
//   warp (the block's last) walks the key tiles the block can see and
//   keeps their K and V boxes (and the key mask's row, by a bulk copy) in
//   flight in a ring of two slots, on per-slot transaction barriers
//   (full); the consumer warps release a slot on another (empty). The
//   slot's header words say which tile it holds (-1: the walk is done)
//   and whether any of its keys is padding. Maps over (H D, T, B) with
//   the operands' strides, so column slices of one projection need no
//   copy.
// - Skipped tiles: key tiles past the block's last visible key (causal),
//   and key tiles whose keys are all padding where that is exact: the
//   sample has a live key and the block's first row sees the first one
//   (skip_rule), so every row's m is a real logit and the skipped
//   entries would add exp(-1e30 - m) = 0 and never move m. Otherwise
//   (a sample of length 0, rows whose visible keys are all padding) the
//   tiles run with their masks, as the plain version computes them.
// - S = Q K^T on wgmma with K read K-major as it lies; the online
//   softmax on the accumulator in registers (row max and sum by quad
//   shuffles; O rescaled only where m moved); masks only on tiles that
//   need them (a causal tile the warpgroup's first row does not wholly
//   see, a tile with padding). P goes from the accumulator straight into
//   A fragments for O += P V.
// - bf16: Q's fragments by ldmatrix per tile; V an MN-major B
//   (the transpose bit); p rounded to bf16 before P V (the reference's
//   rounding), exp2 with log2 e folded in.
// - f32: Q split once (hi in place, lo beside it; fragments by
//   ldmatrix), K once per tile likewise; tf32 takes B only K-major, so
//   V's hi and lo go into transposed tiles in the accumulator's column
//   order (split_transposed), as B10 does for K. The accurate expf.
// - Epilogue: B7 takes 1 / max(l, 1e-30) once per row and writes q's
//   type in 16-byte rows through the warpgroup's own Q rows; B8 writes
//   acc (f32 pairs) and m, l.

#pragma once

#include "flash_attn_fwd.cuh"
#include "flash_sm90.cuh"

namespace zoo {
namespace ffwd {

using flash::FwdArgs;
using flash::kNegInf;
using sm90::smem_u32;
using namespace fsm90;

// T: the operand type; WG consumer warpgroups of 64 query rows; R keys
// per walked tile.
template <typename T, int D, int WG, int R>
struct Cfg {
  static constexpr bool kF32 = sizeof(T) == 4;
  static constexpr int kWG = WG;
  static constexpr int kRowsQ = 64 * WG;          // query rows per block
  static constexpr int kKeys = R;
  static constexpr int kSlots = 2;
  static constexpr int kConsumers = 128 * WG;
  static constexpr int kThreads = kConsumers + 32;   // + the producer warp
  // bf16 blocks of one warpgroup: two or more share an SM
  static constexpr int kMinBlocks = !kF32 && WG == 1 ? 2 : 1;
  static constexpr int kBox = 128 / sizeof(T);    // elements per 128 B
  static constexpr int kSub = D / kBox;           // 128-byte sub-tiles
  static constexpr int kQBytes = kRowsQ * D * sizeof(T);
  static constexpr int kTileBytes = R * D * sizeof(T);
  static constexpr int kSplitBytes = R * D * 4;
  // layout (every tile 1024-byte aligned): Q (f32: hi in place) and Q lo
  // (f32), the ring's slots of K and V, the split tiles (f32: K lo, V^T
  // hi, V^T lo), the slots' key masks, their header words, barriers
  static constexpr int kQLo = kQBytes;
  static constexpr int kRing = kQLo + (kF32 ? kQBytes : 0);
  static constexpr int kSplit = kRing + kSlots * 2 * kTileBytes;
  static constexpr int kMask = kSplit + (kF32 ? 3 * kSplitBytes : 0);
  static constexpr int kHdr = kMask + kSlots * R * 4;
  static constexpr int kBars = kHdr + 8 * kSlots;
  static constexpr int kSmem = kBars + 8 * (2 * kSlots + 1) + 1024;
  static_assert(kSmem <= kMaxSmem, "the tiles must fit shared memory");
  static_assert(D % 64 == 0 && R % 32 == 0 && (kF32 ? R <= 64 : R >= 64),
                "tile shapes (bf16 S tiles are 64 or 128 keys wide, tf32 "
                "ones 32 or 64)");
};

// The tile each instance runs (`fwd_tile` in ops/flash_attention.py):
// {consumer warpgroups, keys per tile}, the fastest of those measured on
// the H100 at BERT's shapes (PERF.md): f32 at D 64 two warpgroups, which
// share each key tile's split; f32 at D 128 one on 32-key tiles (the
// split tiles' shared memory); bf16 one warpgroup on 64-key tiles, two
// or three blocks to an SM.
template <typename T, int D>
struct Tile {
  static constexpr bool kF32 = sizeof(T) == 4;
  static constexpr int kWG = kF32 && D == 64 ? 2 : 1;
  static constexpr int kKeys = kF32 && D == 128 ? 32 : 64;
};

struct Maps {
  CUtensorMap q, k, v;
};

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Whether a key tile that is all padding may be skipped: the sample has
// a live key (first < Tk, its first live key) and the block's first
// query row q0 sees it, so every row of the block has a real logit and
// the tile's entries add exp(-1e30 - m) = 0 without moving m
// (`fwd_skip_dead` in ops/flash_attention.py pins the rule).
__device__ __forceinline__ bool skip_rule(const FwdArgs& a, int q0,
                                          int first) {
  return first < a.Tk &&
         (!a.causal || static_cast<long long>(q0) + a.off >= first);
}

// ---------------------------------------------------------------------------
// Products
// ---------------------------------------------------------------------------

// s (64 x R) = Q K^T in bf16: Q's fragments by ldmatrix from its tile
// (D / 64 sub-tiles of ROWS rows by 128 swizzled bytes; `row` this lane's
// ldmatrix row), K the tile as it lies (K-major, D / 64 sub-tiles of R
// rows by 128 bytes). The fragments are loaded for every tile: kept in
// registers across the walk, they came back corrupted from the second
// tile on where R = D (ptxas, measured on the H100).
template <int D, int R, int ROWS>
__device__ __forceinline__ void qk_bf16(float (&s)[R / 2], uint32_t qs,
                                        int row, int lane, uint32_t kt) {
  uint32_t qf[D / 64][4][4];
#pragma unroll
  for (int c = 0; c < D / 64; ++c) {
    sm90::load_fragments(qf[c], qs + c * (ROWS * 128), row, lane, true, true);
    sm90::fence_regs(qf[c]);
  }
  sm90::wgmma_fence();
#pragma unroll
  for (int c = 0; c < D / 64; ++c)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      sm90::wgmma_tile<R, 0>(s, qf[c][kk],
                             sm90::kmajor_desc(kt + c * (R * 128), kk),
                             c > 0 || kk > 0);
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_regs(s);
}

// The split k8 A fragment of step st of Q (hi at qhi, lo at qlo: D / 32
// sub-tiles of ROWS rows by 128 swizzled bytes); `row` is this lane's
// ldmatrix row. ldmatrix on f32 gives the tf32 fragment layout.
template <int ROWS>
__device__ __forceinline__ void frag_split(uint32_t (&hi)[4],
                                           uint32_t (&lo)[4], uint32_t qhi,
                                           uint32_t qlo, int st, int row,
                                           int lane) {
  const int ch = 2 * (st & 3) + (lane >> 4);
  const uint32_t off =
      (st >> 2) * (ROWS * 128) + row * 128 + ((ch ^ (row & 7)) << 4);
  sm90::ldsm_x4(qhi + off, hi);
  sm90::ldsm_x4(qlo + off, lo);
}

// s (64 x R) = Q K^T in three tf32 passes: Q's split tiles, K's hi (the
// tile) and lo (K-major, D / 32 sub-tiles of R rows), two k8 steps at a
// time added in order (tf32x3_step).
template <int D, int R, int ROWS>
__device__ __forceinline__ void qk_tf32x3(float (&s)[R / 2], uint32_t qhi,
                                          uint32_t qlo, int row, int lane,
                                          uint32_t khi, uint32_t klo) {
#pragma unroll
  for (int i = 0; i < R / 2; ++i) s[i] = 0.f;
#pragma unroll
  for (int st = 0; st < D / 8; st += 2) {
    uint32_t xh[4], xl[4], yh[4], yl[4];
    frag_split<ROWS>(xh, xl, qhi, qlo, st, row, lane);
    frag_split<ROWS>(yh, yl, qhi, qlo, st + 1, row, lane);
    const uint32_t ox = (st >> 2) * (R * 128);
    const uint32_t oy = ((st + 1) >> 2) * (R * 128);
    tf32x3_step<R>(s, 0, xh, xl, khi + ox, klo + ox, s, 0, yh, yl, khi + oy,
                   klo + oy, st & 3, (st + 1) & 3);
  }
}

// ---------------------------------------------------------------------------
// The online softmax of one tile
// ---------------------------------------------------------------------------

// On the S accumulator in place (this thread's rows row0 and row0 + 8,
// columns k0 + 8 i + 2 t4 (+1)): scales the logits, masks them to -1e30
// where a key is padding or causally invisible (kMasked; kms the tile's
// key mask in shared memory, or null), moves m, rescales l, and leaves
// p = exp(s - m) in s (0 where the key is causally invisible). alpha is
// exp(m_old - m_new) per row, by which O must be rescaled. f32 takes the
// accurate expf; bf16 the hardware exp2 (p is rounded to bf16 next).
template <bool kF32, bool kMasked, int R>
__device__ __forceinline__ void softmax_tile(
    float (&s)[R / 2], float (&m)[2], float (&l)[2], float (&alpha)[2],
    const FwdArgs& a, int row0, int k0, const float* kms, int t4) {
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int i = 0; i < R / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[4 * i + e] * a.scale;
      if constexpr (kMasked) {
        const int c = 8 * i + 2 * t4 + (e & 1);
        const bool vis = !a.causal || row0 + 8 * (e >> 1) + a.off >= k0 + c;
        if (!vis || (kms != nullptr && !(kms[c] > 0.f))) x = kNegInf;
      }
      s[4 * i + e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  float m2[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(~0u, mx[hh], 1));
    mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(~0u, mx[hh], 2));
    const float m_new = fmaxf(m[hh], mx[hh]);
    alpha[hh] = kF32 ? expf(m[hh] - m_new)
                     : exp2_approx((m[hh] - m_new) * kLog2e);
    m[hh] = m_new;
    m2[hh] = m_new * kLog2e;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < R / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int hh = e >> 1;
      const float x = s[4 * i + e];
      float p;
      if constexpr (kF32)
        p = expf(x - m[hh]);
      else if constexpr (kMasked)   // x and m may both be -1e30
        p = exp2_approx((x - m[hh]) * kLog2e);
      else
        p = exp2_approx(fmaf(x, kLog2e, -m2[hh]));
      if constexpr (kMasked) {
        const int c = 8 * i + 2 * t4 + (e & 1);
        if (a.causal && row0 + 8 * hh + a.off < k0 + c) p = 0.f;
      }
      s[4 * i + e] = p;
      sum[hh] += p;
    }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    sum[hh] += __shfl_xor_sync(~0u, sum[hh], 1);
    sum[hh] += __shfl_xor_sync(~0u, sum[hh], 2);
    l[hh] = l[hh] * alpha[hh] + sum[hh];
  }
}

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

template <typename T, int D, bool kPartial, int WG, int R>
__global__ void __launch_bounds__(Cfg<T, D, WG, R>::kThreads,
                                  Cfg<T, D, WG, R>::kMinBlocks)
    flash_fwd_sm90_kernel(FwdArgs a, const __grid_constant__ Maps maps) {
  using C = Cfg<T, D, WG, R>;
  constexpr bool kF32 = C::kF32;
  constexpr int S = C::kSlots;
  constexpr int NC = C::kConsumers;
  constexpr int ROWS = C::kRowsQ;
  extern __shared__ uint8_t smem_raw[];
  // 1024-byte aligned (the 128-byte swizzle's period), kept in the
  // shared window so that plain loads from it are shared loads
  uint8_t* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t sb = smem_u32(smem);
  volatile int* hdr = reinterpret_cast<volatile int*>(smem + C::kHdr);
  const uint32_t full = sb + C::kBars;        // S barriers: a tile landed
  const uint32_t empty = full + 8 * S;        // S barriers: a slot is free
  const uint32_t q_bar = empty + 8 * S;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = blockIdx.x * ROWS;
  const int b = blockIdx.y / a.H;
  const int h = blockIdx.y - b * a.H;
  if (tid == 0) {
    for (int i = 0; i < S; ++i) {
      sm90::mbar_init(full + 8 * i);
      sm90::mbar_init(empty + 8 * i, NC / 32);
    }
    sm90::mbar_init(q_bar);
    sm90::mbar_init_fence();
  }
  __syncthreads();

  if (warp == NC / 32) {
    // The producer: Q, then the key tiles the block sees, in order.
    const float* kmask = a.kmask == nullptr
                             ? nullptr
                             : a.kmask + static_cast<long long>(b) * a.Tk;
    if (lane == 0) {
      sm90::mbar_expect(q_bar, C::kQBytes);
#pragma unroll
      for (int c = 0; c < C::kSub; ++c)
        sm90::tma_load_3d(sb + c * (ROWS * 128), &maps.q, h * D + c * C::kBox,
                          q0, b, q_bar);
    }
    int first = 0;   // the sample's first live key (Tk: none)
    if (kmask != nullptr) {
      first = a.Tk;
      for (int k = 0; k < a.Tk; k += 32) {
        const unsigned live = __ballot_sync(~0u, kmask[k + lane] > 0.f);
        if (live != 0u) {
          first = k + __ffs(live) - 1;
          break;
        }
      }
    }
    const bool skip_dead = skip_rule(a, q0, first);
    const int k_end = flash::key_end(a, q0, ROWS);
    int j = 0;
    auto claim = [&](int jj) {   // wait until slot jj % S is free
      if (jj >= S) wait(empty + 8 * (jj % S), ((jj / S) - 1) & 1);
    };
    for (int k0 = 0; k0 < k_end; k0 += R) {
      bool whole = true;   // no key of the tile is padding
      if (kmask != nullptr) {
        bool live = false, all = true;
#pragma unroll
        for (int r = lane; r < R; r += 32) {
          const bool x = kmask[k0 + r] > 0.f;
          live |= x;
          all &= x;
        }
        whole = __all_sync(~0u, all);
        if (!__any_sync(~0u, live) && skip_dead) continue;
      }
      const int slot = j % S;
      claim(j);
      if (lane == 0) {
        hdr[slot] = k0;
        hdr[S + slot] = whole;
        const uint32_t bar = full + 8 * slot;
        sm90::mbar_expect(bar,
                          2 * C::kTileBytes + (kmask == nullptr ? 0 : R * 4));
        const uint32_t dst = sb + C::kRing + slot * (2 * C::kTileBytes);
#pragma unroll
        for (int c = 0; c < C::kSub; ++c) {
          sm90::tma_load_3d(dst + c * (R * 128), &maps.k, h * D + c * C::kBox,
                            k0, b, bar);
          sm90::tma_load_3d(dst + C::kTileBytes + c * (R * 128), &maps.v,
                            h * D + c * C::kBox, k0, b, bar);
        }
        if (kmask != nullptr)
          sm90::bulk_load(sb + C::kMask + slot * (R * 4), kmask + k0, R * 4,
                          bar);
      }
      ++j;
    }
    claim(j);
    if (lane == 0) {
      hdr[j % S] = -1;
      sm90::mbar_arrive(full + 8 * (j % S));
    }
    return;
  }

  // The consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63; this
  // thread rows ql and ql + 8 of the block.
  const int wg = tid >> 7;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int ql = 64 * wg + 16 * (warp & 3) + g;
  const int arow = 64 * wg + 16 * (warp & 3) + (lane & 15);
  const uint32_t qhi = sb;
  const uint32_t qlo = sb + C::kQLo;
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  wait(q_bar, 0);
  if constexpr (kF32) {
    split_in_place<C::kQBytes, NC>(smem, smem + C::kQLo, tid);
    bar_sync(1, NC);
  }

  for (int j = 0;; ++j) {
    const int slot = j % S;
    wait(full + 8 * slot, (j / S) & 1);
    const int k0 = hdr[slot];
    if (k0 < 0) break;
    uint8_t* kt = smem + C::kRing + slot * (2 * C::kTileBytes);
    uint8_t* vt = kt + C::kTileBytes;
    const float* kms =
        a.kmask == nullptr
            ? nullptr
            : reinterpret_cast<const float*>(smem + C::kMask + slot * (R * 4));
    uint8_t* sp = smem + C::kSplit;
    constexpr int SB = C::kSplitBytes;
    float s[R / 2];
    if constexpr (kF32) {   // K lo beside K's hi; V^T hi, lo
      split_transposed<D, R, NC>(vt, sp + SB, sp + 2 * SB, tid);
      split_in_place<C::kTileBytes, NC>(kt, sp, tid);
      sm90::fence_proxy_async();
      bar_sync(1, NC);
      qk_tf32x3<D, R, ROWS>(s, qhi, qlo, arow, lane, smem_u32(kt),
                            smem_u32(sp));
    } else {
      qk_bf16<D, R, ROWS>(s, qhi, arow, lane, smem_u32(kt));
    }
    // no masks where no key of the tile is padding and the warpgroup's
    // first row sees its last key
    float alpha[2];
    const int row0 = q0 + ql;
    if (hdr[S + slot] != 0 &&
        (!a.causal ||
         static_cast<long long>(q0) + 64 * wg + a.off >= k0 + R - 1))
      softmax_tile<kF32, false, R>(s, m, l, alpha, a, row0, k0, kms, t4);
    else
      softmax_tile<kF32, true, R>(s, m, l, alpha, a, row0, k0, kms, t4);
    if (alpha[0] != 1.f || alpha[1] != 1.f) {   // m moved
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        o[4 * i] *= alpha[0];
        o[4 * i + 1] *= alpha[0];
        o[4 * i + 2] *= alpha[1];
        o[4 * i + 3] *= alpha[1];
      }
    }
    if constexpr (kF32) {
      tf32x3_into<D, R>(o, s, smem_u32(sp + SB), smem_u32(sp + 2 * SB));
      bar_sync(1, NC);   // the split tiles are free again
    } else {
      uint32_t pf[R / 16][4];
      frags_bf16(pf, s);
      sm90::fence_regs(pf);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < R / 16; ++kk)
        sm90::wgmma_tile<D, 1>(o, pf[kk],
                               sm90::btile_desc(smem_u32(vt), kk, R * 128));
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(o);
    }
    if (lane == 0) sm90::mbar_arrive(empty + 8 * slot);
  }

  if constexpr (kPartial) {
    float* acc = static_cast<float*>(a.o);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = q0 + ql + 8 * hh;
      float* p = acc + flash::out_idx(b, a.Tq, a.H, row, h, D);
#pragma unroll
      for (int i = 0; i < D / 8; ++i)
        store2(p + 8 * i + 2 * t4, o[4 * i + 2 * hh],
                      o[4 * i + 2 * hh + 1]);
      if (t4 == 0) {
        const long long si = flash::stat_idx(a, b, h, row);
        a.m[si] = m[hh];
        a.l[si] = l[hh];
      }
    }
  } else {
    // o / max(l, 1e-30) in q's type, staged in the warpgroup's own Q rows
    // (the Q boxes' swizzled layout), then out in 16-byte rows
    const float inv[2] = {1.f / fmaxf(l[0], 1e-30f), 1.f / fmaxf(l[1], 1e-30f)};
    constexpr int es = sizeof(T);
    uint8_t* stage = smem + (64 * wg) * 128;
    bar_sync(2 + wg, 128);   // the warpgroup's reads of Q are done
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = ql - 64 * wg + 8 * hh;
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        const int col = 8 * i + 2 * t4;
        const int byte = (col % C::kBox) * es;
        uint8_t* p = stage + (col / C::kBox) * (ROWS * 128) + r * 128 +
                     (((byte >> 4) ^ (r & 7)) << 4) + (byte & 15);
        store2(reinterpret_cast<T*>(p), o[4 * i + 2 * hh] * inv[hh],
                      o[4 * i + 2 * hh + 1] * inv[hh]);
      }
    }
    bar_sync(2 + wg, 128);
    constexpr int kChunks = D * es / 16;   // 16-byte chunks per row
    T* out = static_cast<T*>(a.o);
    for (int idx = tid & 127; idx < 64 * kChunks; idx += 128) {
      const int r = idx / kChunks;
      const int ch = idx - r * kChunks;
      const uint4 v = *reinterpret_cast<const uint4*>(
          stage + (ch >> 3) * (ROWS * 128) + r * 128 +
          (((ch & 7) ^ (r & 7)) << 4));
      *reinterpret_cast<uint4*>(
          out + flash::out_idx(b, a.Tq, a.H, q0 + 64 * wg + r, h, D) +
          ch * (16 / es)) = v;
    }
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

// Launches B7 (kPartial false) or B8 at one instance and tile; returns
// an error code.
template <typename T, int D, bool kPartial, int WG, int R>
inline int launch_tile(const FwdArgs& a, cudaStream_t stream) {
  using C = Cfg<T, D, WG, R>;
  constexpr int es = sizeof(T);
  const int inner = a.H * D;
  Maps maps = {};
  int err = tensor_map_3d(&maps.q, a.q, es, inner, a.Tq, a.B, a.q_st, a.q_sb,
                          C::kBox, C::kRowsQ);
  if (a.Tk > 0) {   // else no key tile is ever loaded
    err |= tensor_map_3d(&maps.k, a.k, es, inner, a.Tk, a.B, a.k_st, a.k_sb,
                         C::kBox, R);
    err |= tensor_map_3d(&maps.v, a.v, es, inner, a.Tk, a.B, a.v_st, a.v_sb,
                         C::kBox, R);
  }
  if (err != 0) return err;
  auto kernel = flash_fwd_sm90_kernel<T, D, kPartial, WG, R>;
  static int allowed = 0;   // the shared memory this instance allows
  if (C::kSmem > allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    allowed = C::kSmem;
  }
  const dim3 grid(a.Tq / C::kRowsQ, a.B * a.H);
  note_launch("flash_fwd_sm90_kernel<%s, %d, %s, %d, %d>", type_name<T>(), D,
              bool_name(kPartial), WG, R);
  kernel<<<grid, C::kThreads, C::kSmem, stream>>>(a, maps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D, bool kPartial>
inline int launch_sm90(const FwdArgs& a, cudaStream_t stream) {
  return launch_tile<T, D, kPartial, Tile<T, D>::kWG, Tile<T, D>::kKeys>(
      a, stream);
}

// Launches B7 (kPartial false) or B8 on `stream`, on the kernel above at
// D 64 and 128 (`fwd_route` in ops/flash_attention.py), else on
// flash_attn_fwd.cuh's; returns an error code.
template <bool kPartial>
inline int launch(const FwdArgs& a, int D, int bf16, cudaStream_t stream) {
  if (a.Tq == 0 || a.B * a.H == 0) return 0;
  if (D != 64 && D != 128) return flash::launch_fwd<kPartial>(a, D, bf16, stream);
  using B = __nv_bfloat16;
  if (D == 64)
    return bf16 ? launch_sm90<B, 64, kPartial>(a, stream)
                : launch_sm90<float, 64, kPartial>(a, stream);
  return bf16 ? launch_sm90<B, 128, kPartial>(a, stream)
              : launch_sm90<float, 128, kPartial>(a, stream);
}

// An instance's tile, written to out: {1 on the wgmma route, else 0;
// consumer warpgroups (0 off it); query rows per block; keys per tile;
// shared-memory bytes}.
template <typename T, int D>
inline void config_sm90(int* out) {
  using C = Cfg<T, D, Tile<T, D>::kWG, Tile<T, D>::kKeys>;
  out[0] = 1;
  out[1] = C::kWG;
  out[2] = C::kRowsQ;
  out[3] = C::kKeys;
  out[4] = C::kSmem;
}

template <int D>
inline void config_old(int bf16, int* out) {
  out[0] = 0;
  out[1] = 0;
  out[2] = out[3] = bf16 ? flash::kBQ : flash::f32_tile<D>();
  out[4] = static_cast<int>(bf16 ? flash::fwd_bf16_smem<D>()
                                 : flash::fwd_f32_smem<D>());
}

inline int config(int D, int bf16, int* out) {
  using B = __nv_bfloat16;
  switch (D) {
    case 32: config_old<32>(bf16, out); return 0;
    case 64:
      bf16 ? config_sm90<B, 64>(out) : config_sm90<float, 64>(out);
      return 0;
    case 128:
      bf16 ? config_sm90<B, 128>(out) : config_sm90<float, 128>(out);
      return 0;
    case 256: config_old<256>(bf16, out); return 0;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace ffwd
}  // namespace zoo
