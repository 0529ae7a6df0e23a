// The 1x1 conv + BN forward in bf16 for Hopper (sm_90a), training (with
// the BN statistics) and eval with bf16 weights (with the BN fold): a
// GEMM on warpgroup MMA (wgmma) fed by a ring of asynchronous copies
// that runs on across the output tiles a block walks.
//
// Replaces the TPU's Pallas kernel `_kernel` of
// analytics_zoo_tpu/ops/conv_bn.py (driver `_matmul_bn_fwd_pallas`,
// public `matmul_bn`/`conv1x1_bn`; B1), and `_apply_kernel` (public
// `matmul_bn_apply`/`conv1x1_bn_apply`; B5) where x and the weights are
// bf16: the other B5 dtype pairs run matmul_bn_apply_sm90.cuh. The f32
// B1 keeps conv_bn_fwd.cuh's FMA template. For a tile of 128 rows m by BN
// columns n it computes
//     A[m, c] = relu_in?(affine_in?(x[pixel(m), c] s[c] + t[c])
//                        [+ in_res[m, c]])        (rounded to bf16)
//     acc[m, n] = sum_c A[m, c] W[c, n]            (f32)
// where pixel(m) is every stride-th pixel of the NHWC x, read in place,
// and ends in one of two epilogues:
//     kFold = false (B1): y = bf16(acc); per column sum(acc - sh) and
//       sum((acc - sh)^2) over the rows m < M of the tile, into row
//       (M tile) of the partials, which colsum.cuh adds in a fixed
//       order: a launch repeats bit for bit, no atomics;
//     kFold = true (B5, bf16 x and weights): y = relu_out?(acc os + ot
//       [+ res]) in bf16.
//
// What bounds it on the H100: 2 M K N FLOP against reading x (M, K) and
// writing y (M, N) once. At ResNet-50's train-step shapes (batch 128)
// the early ones (K 64-256, M 401,408) do 51-200 FLOP per byte, far
// below the bf16 ridge of about 295: bound by bytes, 1.303 ms per step
// in all at 3.35 TB/s; only the late 2048-wide ones reach the ridge.
// The design it replaces (mma.sync on 64 x 64 tiles, one synchronous
// 32-deep stage, W re-read per 64 rows, the affine read from device
// memory per element) took 8.335 ms per bf16 train step (NVIDIA H100
// 80GB HBM3, 700 W; chip_smoke.py), 4.7x cuBLAS.
//
// The design:
// - Tiles of 128 rows (two warpgroups of 64) by BN = 64, 128 or 256
//   columns, the widest dividing N (`fwd_tile` in ops/conv_bn.py): x is
//   read N / BN times (once up to N 256) and the W slice once per tile.
// - A ring of 64-deep slices (the x rows, the in_res rows where there
//   are any, the W slice), D slices ahead of the one in use. The slices
//   are numbered across every tile the block walks, so the next tile's
//   first slices are in flight while this tile's last ones multiply and
//   its epilogue stores y: at K 64 a tile is one slice, and its fill and
//   drain are most of its life. One wave of blocks (as many as fit on
//   the SMs; BN 64: two per SM) walks the tiles; one block per tile was
//   never faster (PERF.md).
// - The copies are bulk tensor copies (TMA), issued by one thread and
//   completing on the slot's transaction barrier (mbarrier): W always,
//   x where its rows are the tile's rows (bf16 at stride 1), in_res.
//   The 16-byte cp.async they replace could not keep enough bytes in
//   flight per SM (2.3 TB/s from L2 at the late shapes, where W alone
//   is read again for every 128 rows); TMA took B1 from 3.79 to 3.12 ms
//   per step (NVIDIA H100 80GB HBM3, 700 W; scripts/conv_bn_ab.py). A
//   strided x (every stride-th pixel: 128 output rows are no box) still
//   comes by cp.async.
// - Operands: each warp takes its 16 rows of the x slice by ldmatrix
//   into registers, applies the prologue there (s and t read through
//   L1), and wgmma m64nBNk16 multiplies them by the W slice in wgmma's
//   128-byte-swizzled MN-major layout (wgmma_sm90.cuh; TMA's 128-byte
//   swizzle writes the same). One wgmma group stays in flight while the
//   next slice's fragments form (two register sets alternate); the slot
//   being refilled is never the one it reads.
// - Epilogue from the f32 accumulators, staged in the two ring slots the
//   last slices left free: y in bf16 by stmatrix into the swizzled
//   layout a bulk tensor store (TMA) reads, and stored by it while the
//   block goes on to the next tile (its sources are read before a slot
//   is refilled; rows past M are clipped by the store); each column's
//   shifted sums by a recursive-halving reduction across the eight
//   lanes that share it, then across the eight warps in a fixed order
//   into the M tile's partial row. The fold stages f32 values, then
//   adds res, applies the ReLU and casts in 16-byte stores.
// - Why a sibling of conv3x3_bn_sm90.cuh's generic kernel and not its
//   one-tap instance: that kernel takes every operand by cp.async under
//   a tap mask and runs one block per tile; B1's time went to keeping
//   copies in flight across tiles (the persistent walk, TMA for x,
//   in_res and W, y by bulk stores), none of which the 3x3's masked,
//   per-tap gather can take over unchanged. The two share the helpers
//   of wgmma_sm90.cuh (ring, fragments, B tile, wgmma).
// - What still holds it back: at K 64 the epilogue is most of a tile's
//   time (the statistics' cross-lane reduction alone a quarter of it at
//   N 256), and the block runs it alone. Tried on the card and not kept
//   (PERF.md): the product transposed (channels as the wgmma's rows, so
//   the statistics are in-register sums; its shared-memory operands cost
//   more than its epilogue saved), tiles of one warpgroup two or three
//   per SM, a deeper ring whose slices' products are waited for, and y
//   stored by bulk copies from a staging area of its own (the ring lost
//   a slot).

#pragma once

#include <cuda.h>

#include "conv_bn_fwd.cuh"
#include "wgmma_sm90.cuh"

namespace zoo {
namespace mm_sm90 {

using sm90::smem_u32;

constexpr int kMaxSmem = 232448;   // a block's opt-in maximum on the H100

constexpr int kBM = 128;           // a tile's rows: two warpgroups
constexpr int kThreads = 256;

template <int BN, bool kFold>
struct Cfg {
  // ring slots and issue distance: one wgmma group stays in flight, so
  // the slot refilled at a step is two behind the one it issues, and at
  // a tile's end the two slots behind the copies in flight are free
  static constexpr int kStages = BN == 128 ? 6 : 4;
  static constexpr int kDist = kStages - 2;
  static constexpr int kABytes = kBM * 64 * 2;    // x slice
  static constexpr int kWBytes = 64 * BN * 2;             // W slice
  static constexpr int kPitch = BN + 8;    // staged y row, elements
  // one warpgroup's epilogue staging, in one of the two free slots:
  // its 64 rows of f32 values (fold), or of bf16 y (BN / 64 blocks of
  // 64 rows by 128 bytes, swizzled as the bulk tensor store reads them)
  // and its four warps' column sums
  static constexpr int kYBytes = kFold ? 64 * kPitch * 4 : 64 * BN * 2;
  static constexpr int kOutBytes = kYBytes + (kFold ? 0 : 4 * 2 * BN * 4);
  static_assert(kOutBytes <= kABytes + kWBytes,
                "a warpgroup's staging must fit a ring slot");
  // two blocks per SM where the shared memory holds two (BN 64)
  static constexpr int kMinBlocks =
      2 * (kStages * (kABytes + kWBytes) + 2048) <= kMaxSmem + 1024 ? 2
                                                                    : 1;
};

// Bytes of one ring slot: the x slice, the in_res slice (bf16, where
// there is one) and the W slice.
template <int BN, bool kFold>
__host__ __device__ constexpr int slot_bytes(bool has_r) {
  using C = Cfg<BN, kFold>;
  return C::kABytes * (has_r ? 2 : 1) + C::kWBytes;
}

// The ring, its slots' transaction barriers, alignment slack.
template <int BN, bool kFold>
inline int smem_bytes(bool has_r) {
  using C = Cfg<BN, kFold>;
  return C::kStages * slot_bytes<BN, kFold>(has_r) + 64 + 1024;
}

// A 2-D tensor map for bulk tensor copies (TMA) of a row-major (outer,
// inner) matrix of bf16 (esize 2) or f32 (4), in boxes of `cols`
// contiguous elements by `rows` rows; `swizzle`: 128-byte rows in the
// 128-byte swizzle wgmma and ldmatrix read. Boxes past the edge are
// filled with zeros. Returns 0, or an error where the driver refuses
// the map. The driver's encoding costs microseconds of host time, and a
// launch takes up to four maps, so each thread keeps the maps it
// encoded by shape; a map of a shape seen before is only moved to
// `base` (cuTensorMapReplaceAddress).
inline int tensor_map_2d(CUtensorMap* map, const void* base, int esize,
                         int inner, int outer, int cols, int rows,
                         bool swizzle = true) {
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
  struct Entry {
    CUtensorMap map;
    int key[6];
  };
  constexpr int kEntries = 64;
  thread_local Entry cache[kEntries];
  thread_local int used = 0;
  const int key[6] = {esize, inner, outer, cols, rows, swizzle ? 1 : 0};
  for (int i = 0; i < used; ++i) {
    bool same = true;
    for (int f = 0; f < 6; ++f) same = same && cache[i].key[f] == key[f];
    if (same) {
      *map = cache[i].map;
      return replace(map, const_cast<void*>(base)) == CUDA_SUCCESS ? 0 : bad;
    }
  }
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(inner) * esize};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(cols),
                             static_cast<cuuint32_t>(rows)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(
      map,
      esize == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      2, const_cast<void*>(base), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return bad;
  // a full cache keeps its maps: the shapes a model runs are few
  if (used < kEntries) {
    cache[used].map = *map;
    for (int f = 0; f < 6; ++f) cache[used].key[f] = key[f];
    ++used;
  }
  return 0;
}

// The kernels' tensor maps: x as (pixels, Cin) where a stride-1 x is
// read by TMA, r (B1's in_res (M, Cin); the fold's res (M, N)) where
// there is one, W (K, N), and y (M, N), written by bulk tensor stores.
struct Maps {
  CUtensorMap x, r, w, y;
};

// The input pixel (NHWC flat index) of output row m of a 1x1 at
// a.stride: every stride-th pixel, in place.
__device__ __forceinline__ int64_t src_pixel(const ConvBnArgs& a, int m) {
  const int hw = a.Ho * a.Wo;
  const int b = m / hw;
  const int rem = m - b * hw;
  const int oy = rem / a.Wo;
  const int ox = rem - oy * a.Wo;
  return (static_cast<int64_t>(b) * a.H + oy * a.stride) * a.W +
         ox * a.stride;
}

// Half of row `row` of a 64-channel slice (channels c0 ..) of `src`
// (`pitch` elements per row; src_row < 0: zeros) into `dst`: 128-byte
// swizzled rows, an f32 slice as two subtiles of 32 channels 128 rows
// apart. Thread half 0 or 1 copies chunks half * kPer .. + kPer - 1.
template <typename Tx>
__device__ __forceinline__ void copy_arow(uint32_t dst, const Tx* src,
                                          int64_t src_row, int pitch,
                                          int c0, int row, int half) {
  constexpr int kPer = 64 * sizeof(Tx) / 32;   // 4 chunks (bf16), 8 (f32)
  constexpr int kElems = 16 / sizeof(Tx);
  const Tx* p = src_row >= 0 ? src + src_row * pitch + c0 : src;
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const int j = half * kPer + e;
    sm90::cp_async16(
        dst + (j >> 3) * (kBM * 128) + sm90::row128_offset(row, j & 7),
        src_row >= 0 ? p + j * kElems : src, src_row >= 0 ? 16 : 0);
  }
}

// The prologue on one bf16 k16 fragment (channels c, c + 1 in registers
// 0 and 1, c + 8, c + 9 in 2 and 3; rf: the in_res fragment or null).
__device__ __forceinline__ void prologue_bf16(uint32_t (&v)[4],
                                              const uint32_t* rf,
                                              const ConvBnArgs& a, int c) {
  float2 s[2] = {make_float2(1.f, 1.f), make_float2(1.f, 1.f)};
  float2 t[2] = {make_float2(0.f, 0.f), make_float2(0.f, 0.f)};
  if (a.affine_in) {
    s[0] = __ldg(reinterpret_cast<const float2*>(a.in_scale + c));
    s[1] = __ldg(reinterpret_cast<const float2*>(a.in_scale + c + 8));
    t[0] = __ldg(reinterpret_cast<const float2*>(a.in_shift + c));
    t[1] = __ldg(reinterpret_cast<const float2*>(a.in_shift + c + 8));
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    float2 f = sm90::unpack_bf16x2(v[e]);
    f.x = fmaf(f.x, s[e >> 1].x, t[e >> 1].x);
    f.y = fmaf(f.y, s[e >> 1].y, t[e >> 1].y);
    if (rf != nullptr) {
      const float2 r = sm90::unpack_bf16x2(rf[e]);
      f.x += r.x;
      f.y += r.y;
    }
    if (a.relu_in) {
      f.x = fmaxf(f.x, 0.f);
      f.y = fmaxf(f.y, 0.f);
    }
    v[e] = sm90::pack_bf16x2(f.x, f.y);
  }
}

// The prologue on f32 values of channel c (matmul_bn_apply_sm90.cuh).
__device__ __forceinline__ float prologue_f32(float v, const ConvBnArgs& a,
                                              int c) {
  if (a.affine_in) v = fmaf(v, __ldg(a.in_scale + c), __ldg(a.in_shift + c));
  return a.relu_in ? fmaxf(v, 0.f) : v;
}

// The four k16 A fragments of a slice at `aslot` (and of the in_res
// slice at `rslot`, where there is one), the prologue applied, rounded
// to bf16. `row` is this lane's ldmatrix row, c0 the slice's first
// channel.
__device__ __forceinline__ void a_fragments(uint32_t (&af)[4][4],
                                            const ConvBnArgs& a,
                                            uint32_t aslot, uint32_t rslot,
                                            int row, int lane, int c0,
                                            bool pro) {
  sm90::load_fragments(af, aslot, row, lane, true, true);
  if (!pro) return;
  const int t4 = lane & 3;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t rf[4];
    if (rslot != 0u) {
      const int chunk = kk * 2 + (lane >> 4);
      sm90::ldsm_x4(rslot + row * 128 + ((chunk ^ (row & 7)) << 4), rf);
    }
    prologue_bf16(af[kk], rslot != 0u ? rf : nullptr, a,
                  c0 + kk * 16 + 2 * t4);
  }
}

// Sums of v across the eight lanes that share t4 (lane = 4 g + t4) by
// recursive halving: each of three rounds (lane bits 4, 3, 2) trades half
// of the values still held with the partner lane and adds the other
// half, so lane g ends with the V / 8 sums of v[g V / 8 ..] in v[0 ..]:
// 7 V / 8 shuffles where a butterfly per value takes 3 V.
template <int W, int V>
__device__ __forceinline__ void halving_round(float (&v)[V], int lane,
                                              int off) {
  const bool upper = (lane & off) != 0;
#pragma unroll
  for (int j = 0; j < W / 2; ++j) {
    const float lo = v[j];
    const float hi = v[j + W / 2];
    const float got = __shfl_xor_sync(0xffffffffu, upper ? lo : hi, off);
    v[j] = (upper ? hi : lo) + got;
  }
}
template <int V>
__device__ __forceinline__ void halving_sum(float (&v)[V], int lane) {
  halving_round<V>(v, lane, 16);
  halving_round<V / 2>(v, lane, 8);
  halving_round<V / 4>(v, lane, 4);
}

// B1's epilogue: y = bf16(acc) staged by stmatrix and written by bulk
// tensor stores that run on while the block goes on to its next tile
// (thread 0, which issues them, waits for their sources to be read
// before any copy refills the slots), and each column's shifted sums
// over the valid rows into partial row `mt`. Warpgroup w stages its 64
// rows at out[w]: y in 64-column blocks of 64 rows by 128 bytes
// (swizzled), then its four warps' column sums.
template <int BN>
__device__ __forceinline__ void store_stats(const ConvBnArgs& a,
                                            const Maps& maps,
                                            const float (&acc)[BN / 2],
                                            uint8_t* const (&out)[2],
                                            int mt, int n0, int M, int fr,
                                            int tid) {
  constexpr int kYBytes = 64 * BN * 2;
  const int m0 = mt * kBM;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t4 = tid & 3;
  const int lr = fr & 63;   // the fragment row within the warpgroup
  const bool ok0 = m0 + fr < M;
  const bool ok1 = m0 + fr + 8 < M;
  // y: the 8 x 8 matrices (i, h) (rows lr - g + 8 h .., columns 8 i ..),
  // four per stmatrix: (i, 0), (i, 1), (i + 1, 0), (i + 1, 1)
  const int mj = lane >> 3;
  const int srow = lr - g + 8 * (mj & 1) + (lane & 7);
  const uint32_t ybase = smem_u32(out[warp >> 2]) + srow * 128;
#pragma unroll
  for (int i = 0; i < BN / 8; i += 2) {
    const int chunk = i + (mj >> 1);   // 8-column chunk of the tile
    sm90::stsm_x4(ybase + (chunk >> 3) * sm90::kColBlockBytes +
                      (((chunk & 7) ^ (srow & 7)) << 4),
                  sm90::pack_bf16x2(acc[4 * i], acc[4 * i + 1]),
                  sm90::pack_bf16x2(acc[4 * i + 2], acc[4 * i + 3]),
                  sm90::pack_bf16x2(acc[4 * i + 4], acc[4 * i + 5]),
                  sm90::pack_bf16x2(acc[4 * i + 6], acc[4 * i + 7]));
  }
  sm90::fence_proxy_async();   // the staged y, for the bulk stores
  float v[BN / 2];   // per column pair i: sum e = 0, 1, then squares
#pragma unroll
  for (int i = 0; i < BN / 8; ++i) {
    const int col = 8 * i + 2 * t4;
    const float2 sh = __ldg(reinterpret_cast<const float2*>(a.sh + n0 +
                                                            col));
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float she = e ? sh.y : sh.x;
      const float d0 = acc[4 * i + e] - she;
      const float d1 = acc[4 * i + 2 + e] - she;
      v[4 * i + e] = (ok0 ? d0 : 0.f) + (ok1 ? d1 : 0.f);
      v[4 * i + 2 + e] = (ok0 ? d0 * d0 : 0.f) + (ok1 ? d1 * d1 : 0.f);
    }
  }
  halving_sum(v, lane);
  float* red = reinterpret_cast<float*>(out[warp >> 2] + kYBytes) +
               (warp & 3) * 2 * BN;
#pragma unroll
  for (int j = 0; j < BN / 16; ++j) {
    const int idx = g * (BN / 16) + j;
    const int col = 8 * (idx >> 2) + 2 * t4 + (idx & 1);
    red[((idx >> 1) & 1) * BN + col] = v[j];
  }
  __syncthreads();
  if (tid == 0) {
#pragma unroll
    for (int w = 0; w < 2; ++w) {
      if (m0 + 64 * w >= M) continue;
#pragma unroll
      for (int cb = 0; cb < BN / 64; ++cb)
        sm90::tma_store_2d(&maps.y,
                           smem_u32(out[w]) + cb * sm90::kColBlockBytes,
                           n0 + 64 * cb, m0 + 64 * w);
    }
    sm90::bulk_commit();
  }
  if (tid < BN) {
    float s = 0.f, sq = 0.f;
#pragma unroll
    for (int wi = 0; wi < kThreads / 32; ++wi) {
      const float* rw = reinterpret_cast<const float*>(out[wi >> 2] +
                                                       kYBytes) +
                        (wi & 3) * 2 * BN;
      s += rw[tid];
      sq += rw[BN + tid];
    }
    float* p = a.partial + static_cast<int64_t>(mt) * 2 * a.N;
    p[n0 + tid] = s;
    p[a.N + n0 + tid] = sq;
  }
}

// The fold's epilogue (B5, bf16 x and weights): v = acc os + ot staged
// in f32, then y = relu_out?(v [+ res]) in bf16, 16-byte loads of res
// and stores of y.
template <int BN>
__device__ __forceinline__ void store_fold(const ConvBnArgs& a,
                                           const float (&acc)[BN / 2],
                                           uint8_t* const (&out)[2],
                                           int m0, int n0, int M, int fr,
                                           int tid) {
  constexpr int kPitch = BN + 8;
  const int t4 = tid & 3;
  float* vs = reinterpret_cast<float*>(out[tid >> 7]);
  const int lr = fr & 63;   // the fragment row within the warpgroup
#pragma unroll
  for (int i = 0; i < BN / 8; ++i) {
    const int col = 8 * i + 2 * t4;
    const float2 os = __ldg(reinterpret_cast<const float2*>(a.out_scale +
                                                            n0 + col));
    const float2 ot = __ldg(reinterpret_cast<const float2*>(a.out_shift +
                                                            n0 + col));
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(&vs[(lr + 8 * h) * kPitch + col]) =
          make_float2(fmaf(acc[4 * i + 2 * h], os.x, ot.x),
                      fmaf(acc[4 * i + 2 * h + 1], os.y, ot.y));
  }
  __syncthreads();
  using Tx = __nv_bfloat16;
  constexpr int kE = 8;   // elements per 16-byte chunk
  constexpr int kRowChunks = BN / kE;
  Tx* y = static_cast<Tx*>(a.y);
  const Tx* res = static_cast<const Tx*>(a.res);
  for (int c = tid; c < kBM * kRowChunks; c += kThreads) {
    const int r = c / kRowChunks;
    const int j = c - r * kRowChunks;
    if (m0 + r >= M) continue;
    const int64_t off = static_cast<int64_t>(m0 + r) * a.N + n0 + j * kE;
    const float* vr = reinterpret_cast<const float*>(out[r >> 6]) +
                      (r & 63) * kPitch + j * kE;
    float v[kE];
#pragma unroll
    for (int e = 0; e < kE; e += 4) {
      const float4 f = *reinterpret_cast<const float4*>(vr + e);
      v[e] = f.x;
      v[e + 1] = f.y;
      v[e + 2] = f.z;
      v[e + 3] = f.w;
    }
    if (res != nullptr) {
      float rv[kE];
      load_vec<Tx, kE>(res + off, rv);
#pragma unroll
      for (int e = 0; e < kE; ++e) v[e] += rv[e];
    }
    __align__(16) Tx o[kE];
#pragma unroll
    for (int e = 0; e < kE; ++e)
      o[e] = __float2bfloat16(a.relu_out ? fmaxf(v[e], 0.f) : v[e]);
    *reinterpret_cast<uint4*>(y + off) = *reinterpret_cast<const uint4*>(o);
  }
}

template <int BN, bool kFold>
__global__ void __launch_bounds__(kThreads, (Cfg<BN, kFold>::kMinBlocks))
    matmul_bn_sm90_kernel(ConvBnArgs a, int slot, int tma_x,
                          const __grid_constant__ Maps maps) {
  using C = Cfg<BN, kFold>;
  constexpr int S = C::kStages;
  constexpr int D = C::kDist;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t sbase = smem_u32(smem);
  const uint32_t bars = sbase + S * slot;   // a transaction barrier per slot

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int M = a.B * a.Ho * a.Wo;
  const int cin = a.Cin;
  const int ns = cin / 64;                  // slices per tile
  const int ntn = a.N / BN;
  const int ntiles = (M + kBM - 1) / kBM * ntn;
  // this block's tiles: blockIdx.x, + gridDim.x, ... (tile t: M tile
  // t / ntn, N tile t % ntn, so the N tiles of one M tile run side by
  // side and share its x rows in L2)
  const int mine = (ntiles - 1 - static_cast<int>(blockIdx.x)) /
                       static_cast<int>(gridDim.x) + 1;
  const int nitems = mine * ns;
  const bool has_r = !kFold && a.in_res != nullptr;
  const bool pro = a.affine_in || a.relu_in || has_r;
  const uint32_t rofs = has_r ? C::kABytes : 0;
  const uint32_t wofs = C::kABytes + rofs;
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(a.x);

  // copy role: half (tid & 1) of row tid >> 1 of the x (and in_res)
  // slice
  const int cr = tid >> 1;
  const int chalf = tid & 1;
  // fragment rows fr and fr + 8 of the tile; lrow this lane's ldmatrix
  // row
  const int fr = (warp >> 2) * 64 + (warp & 3) * 16 + (lane >> 2);
  const int lrow = fr - (lane >> 2) + (lane & 15);
  // what the slot's barrier waits for: the bulk tensor copies' bytes
  const int tma_bytes = (tma_x ? C::kABytes : 0) + (has_r ? C::kABytes : 0) +
                        C::kWBytes;

  if (tid == 0) {
    for (int b = 0; b < S; ++b) sm90::mbar_init(bars + 8 * b);
    sm90::mbar_init_fence();
  }
  __syncthreads();

  // item q's copies into slot q % S: bulk tensor copies issued by
  // thread 0 (x at stride 1, in_res, W), cp.async by every thread (a
  // strided x)
  auto issue = [&](int q) {
    if (q >= nitems) return;
    const int i = q / ns;
    const int sl = q - i * ns;
    const int t = static_cast<int>(blockIdx.x) + i * static_cast<int>(
                                                         gridDim.x);
    const int mt = t / ntn;
    const int n0 = (t - mt * ntn) * BN;
    const uint32_t s0 = sbase + (q % S) * slot;
    const uint32_t bar = bars + 8 * (q % S);
    if (tid == 0) {
      sm90::mbar_expect(bar, tma_bytes);
      if (tma_x) sm90::tma_load_2d(s0, &maps.x, sl * 64, mt * kBM, bar);
      if (has_r)
        sm90::tma_load_2d(s0 + rofs, &maps.r, sl * 64, mt * kBM, bar);
#pragma unroll
      for (int b = 0; b < BN / 64; ++b)
        sm90::tma_load_2d(s0 + wofs + b * sm90::kColBlockBytes, &maps.w,
                          n0 + 64 * b, sl * 64, bar);
    }
    if (!tma_x) {
      const int m = mt * kBM + cr;
      copy_arow(s0, x, m < M ? src_pixel(a, m) : -1, cin, sl * 64, cr,
                chalf);
    }
  };

#pragma unroll
  for (int q = 0; q < D; ++q) {
    issue(q);
    sm90::cp_async_commit();
  }

  float acc[BN / 2];   // each tile's first product overwrites it

  // One slice: its copies landed, the copies of item q + D start (the
  // next tile's once this one's run out), its A fragments are formed and
  // its products issued; the products of the slice before run on
  // meanwhile (one wgmma group in flight, so the A registers alternate
  // between two sets).
  auto step = [&](int q, int sl, uint32_t (&af)[4][4]) {
    sm90::cp_async_wait<D - 1>();
    sm90::mbar_wait(bars + 8 * (q % S), (q / S) & 1);
    // a slot may hold the staging of y's bulk stores (issued by thread
    // 0): their sources are read before the barrier, after which the
    // slot may be refilled
    if (!kFold && tid == 0) sm90::bulk_wait_read();
    sm90::fence_proxy_async();
    __syncthreads();
    issue(q + D);
    sm90::cp_async_commit();
    const uint32_t s0 = sbase + (q % S) * slot;
    a_fragments(af, a, s0, has_r ? s0 + rofs : 0u, lrow, lane, sl * 64,
                pro);
    sm90::fence_regs(af);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      sm90::wgmma_tile<BN>(acc, af[kk], sm90::btile_desc(s0 + wofs, kk),
                           sl + kk > 0);
    sm90::wgmma_commit();
    sm90::wgmma_wait<1>();
  };

  uint32_t af0[4][4], af1[4][4];
  int q = 0;
  for (int i = 0; i < mine; ++i) {
    for (int sl = 0; sl < ns; sl += 2) {
      step(q++, sl, af0);
      if (sl + 1 < ns) step(q++, sl + 1, af1);
    }
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
    const int t = static_cast<int>(blockIdx.x) + i * static_cast<int>(
                                                         gridDim.x);
    const int mt = t / ntn;
    const int n0 = (t - mt * ntn) * BN;
    // the staging goes into the slots of the last two slices, free once
    // every warpgroup's products are done (the next D are in flight)
    uint8_t* const out[2] = {smem + ((q - 1) % S) * slot,
                             smem + ((q + S - 2) % S) * slot};
    __syncthreads();
    if constexpr (kFold)
      store_fold<BN>(a, acc, out, mt * kBM, n0, M, fr, tid);
    else
      store_stats<BN>(a, maps, acc, out, mt, n0, M, fr, tid);
  }
  sm90::cp_async_wait<0>();
  if (!kFold && tid == 0) sm90::bulk_wait_read();
}

// Launches one instance, one wave of blocks (as many as the SMs hold
// at once, found once per device) walking the tiles. Returns
// cudaGetLastError(), or cudaErrorInvalidValue where the ring does not
// fit.
template <int BN, bool kFold>
inline int launch_tile(const ConvBnArgs& a, cudaStream_t stream) {
  const bool has_r = !kFold && a.in_res != nullptr;
  const int bytes = smem_bytes<BN, kFold>(has_r);
  if (bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const int M = a.B * a.Ho * a.Wo;
  const int K = a.Cin;
  // x by TMA where its rows are the tile's rows: at stride 1
  const int tma_x = a.stride == 1;
  Maps maps = {};
  int err = tensor_map_2d(&maps.w, a.w, 2, a.N, K, 64, 64);
  if (tma_x) err |= tensor_map_2d(&maps.x, a.x, 2, K, M, 64, kBM);
  if (has_r) err |= tensor_map_2d(&maps.r, a.in_res, 2, K, M, 64, kBM);
  if (!kFold) err |= tensor_map_2d(&maps.y, a.y, 2, a.N, M, 64, 64);
  if (err != 0) return err;
  auto kernel = matmul_bn_sm90_kernel<BN, kFold>;
  static int allowed = 0;   // the shared memory this instance allows
  if (bytes > allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    allowed = bytes;
  }
  // one wave: the blocks of this instance the SMs hold at once with
  // this ring, found once per device
  static int waves[16][2] = {};
  int dev = 0, fresh = 0;
  cudaGetDevice(&dev);
  int& wave = dev < 16 ? waves[dev][has_r] : fresh;
  if (wave == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                  kThreads, bytes);
    wave = (per_sm > 0 ? per_sm : 1) * (sms > 0 ? sms : 1);
  }
  const int tiles = (M + kBM - 1) / kBM * (a.N / BN);
  note_launch("matmul_bn_sm90_kernel<%d, %s>", BN, bool_name(kFold));
  kernel<<<tiles < wave ? tiles : wave, kThreads, bytes, stream>>>(
      a, slot_bytes<BN, kFold>(has_r), tma_x, maps);
  return static_cast<int>(cudaGetLastError());
}

// Rows of B1's statistics partials: one per 128-row M tile.
inline int partial_rows(int M) { return (M + kBM - 1) / kBM; }

// B1 in bf16 (x, w, in_res and y bf16; a.partial holds partial_rows
// rows of 2N) on 128 x bn tiles (bn 64, 128 or 256 dividing N, as
// `fwd_tile` in ops/conv_bn.py picks it); in_res takes bn 64.
inline int launch_stats(const ConvBnArgs& a, int bn, cudaStream_t stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (a.N % bn || (a.in_res != nullptr && bn != 64)) return bad;
  if (bn == 256) return launch_tile<256, false>(a, stream);
  if (bn == 128) return launch_tile<128, false>(a, stream);
  if (bn == 64) return launch_tile<64, false>(a, stream);
  return bad;
}

// B5 with bf16 x and weights: the fold epilogue on 128 x 64 tiles.
inline int launch_fold(const ConvBnArgs& a, cudaStream_t stream) {
  return launch_tile<64, true>(a, stream);
}

}  // namespace mm_sm90
}  // namespace zoo
