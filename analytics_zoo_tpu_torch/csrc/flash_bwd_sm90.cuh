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
// The pieces it shares with the forward (the trapping wait, the tensor
// maps, the tf32 split and three-pass step) are in flash_sm90.cuh.

#pragma once

#include <cuda.h>

#include <type_traits>

#include "flash_attn_bwd.cuh"
#include "flash_sm90.cuh"

namespace zoo {
namespace fbwd {

using flash::BwdArgs;
using flash::kNegInf;
using sm90::smem_u32;
using namespace fsm90;

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
