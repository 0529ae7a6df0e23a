// Flash-attention forward for Hopper (sm_90a): one online-softmax body
// shared by the two forward kernels, as `_attn_body` is shared on the TPU.
// These kernels run at head dims 32 and 256; 64 and 128 (BERT, GPT) run
// the wgmma template of flash_fwd_sm90.cuh, whose contract is this one
// (`fwd_route` in ops/flash_attention.py names the route). The helpers
// here also serve the backward (flash_attn_bwd.cuh, flash_bwd_sm90.cuh).
//
// - `flash_fwd` (B7) writes the normalised output
//     o[b, i, h, :] = sum_j p[i, j] v[b, j, h, :] / sum_j p[i, j]
//   in q's type;
// - `flash_block` (B8) writes the unnormalised f32 accumulator
//   acc[b, i, h, :] (the numerator above) and the f32 row statistics
//   m[b, h, i] (running max of the scaled logits) and l[b, h, i] (the
//   denominator, with base m), for callers that merge partials or build
//   the backward's row statistics.
// where s[i, j] = (q[b, i, h, :] . k[b, j, h, :]) * scale, masked to
// -1e30 where key j is padding (kmask[b, j] <= 0) or causally invisible
// (i + off < j), and p[i, j] = exp(s[i, j] - m[i]) except that a causally
// invisible entry contributes p = 0.
//
// Replaces the TPU's Pallas kernels of analytics_zoo_tpu/ops/
// flash_attention.py: `_fwd_kernel[_masked]` (called from `_flash_fwd`) and
// `_block_kernel[_masked]` (called from `_block_partials`).
//
// Semantics kept from the reference: masked logits are -1e30, never -inf,
// and m starts at -1e30, so a row whose keys are all padding averages
// its keys uniformly (exp(0) = 1 each), as the dense path does, and
// never gives NaN. Causal alignment is bottom-right: off = Tk - Tq for
// `flash_fwd`, and any runtime int (negative or past Tk) for
// `flash_block`. One deliberate difference: a row that sees no key at
// all under causal masking (i + off < 0) outputs 0 with m = -1e30 and
// l = 0, whatever the tiling, where the reference's value depends on its
// block size (it skips whole blocks). Causally invisible entries give
// p = 0 rather than exp(-1e30 - m), which is the same number for every
// row that sees a key.
//
// Layout: q, k, v are read in place in the public (B, T, H, D) layout
// through their batch and time strides (the head stride is D and the
// last axis is contiguous), which saves the reference's three
// transposes; a q, k or v that is a column slice of a fused qkv
// projection is read as it lies. Outputs are contiguous (B, Tq, H, D);
// m and l are (B, H, Tq).
//
// What bounds it on the H100: 4*B*H*Tq*Tk*D operations against
// 2*(B*(Tq+2Tk)*H*D) bytes of bf16 in and out; at BERT-base (T = 512,
// D = 64) that is 64 operations per byte per key tile re-read from L2,
// but ~2000 per byte of device memory, so by operations (the tensor
// cores' ridge is ~295 operations per byte). In f32 the products run as
// plain FMA (no TF32, which would not match the reference's full-f32
// products), bound by operations at 67 TFLOP/s. The design keeps the
// (Tq, Tk) logits out of device memory: each block owns 64 query rows,
// keeps their running max, denominator and output accumulator in
// registers (bf16) or shared memory (f32), and streams K and V through
// shared memory in tiles of 64 keys, skipping tiles that causal masking
// hides entirely. It is a first, simple kernel: mma.sync m16n8k16 bf16
// with f32 accumulators (reusing the fragment helpers of
// conv_bn_fwd.cuh), one warp per 16 query rows, no double buffering, no
// wgmma or TMA.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_bn_fwd.cuh"

namespace zoo {
namespace flash {

constexpr float kNegInf = -1e30f;

struct FwdArgs {
  const void* q;          // (B, Tq, H, D), strides q_sb, q_st
  const void* k;          // (B, Tk, H, D)
  const void* v;          // (B, Tk, H, D)
  const float* kmask;     // (B, Tk) key validity, or null
  void* o;                // (B, Tq, H, D): out (T) or acc (f32)
  float* m;               // (B, H, Tq), partials only
  float* l;               // (B, H, Tq), partials only
  int B, H, Tq, Tk;
  long long q_sb, q_st, k_sb, k_st, v_sb, v_st;
  int causal, off;
  float scale;
};

// One past the last key row q0 .. q0 + rows - 1 can see, in [0, Tk]
// (Args: FwdArgs or BwdArgs).
template <typename Args>
__device__ __forceinline__ int key_end(const Args& a, int q0, int rows) {
  if (!a.causal) return a.Tk;
  const long long last = static_cast<long long>(q0) + rows - 1 + a.off;
  return last < 0 ? 0
                  : (last + 1 < a.Tk ? static_cast<int>(last + 1) : a.Tk);
}

// Where row `row`'s statistics sit in a (B, H, Tq) array.
template <typename Args>
__device__ __forceinline__ long long stat_idx(const Args& a, int b, int h,
                                              int row) {
  return (static_cast<long long>(b) * a.H + h) * a.Tq + row;
}

// Where row `row` of head h, batch b starts in a contiguous (B, T, H, D)
// output.
__device__ __forceinline__ long long out_idx(int b, int T, int H, int row,
                                             int h, int D) {
  return ((static_cast<long long>(b) * T + row) * H + h) * D;
}

// Where row r of head h, batch b starts in a strided (B, T, H, D) tensor.
__device__ __forceinline__ long long row_off(long long sb, long long st,
                                             int b, int r, int h, int D) {
  return sb * b + st * r + static_cast<long long>(h) * D;
}

// Copy `rows` rows of D values (global, strided) into shared memory rows
// of pitch LDS (elements of T). Every thread of the block takes part.
template <typename T, int D, int LDS>
__device__ __forceinline__ void load_rows(T* dst, const T* src,
                                          long long st, int rows,
                                          int nthreads) {
  constexpr int kPer = 16 / sizeof(T);
  constexpr int kVecs = D / kPer;
  for (int i = threadIdx.x; i < rows * kVecs; i += nthreads) {
    const int r = i / kVecs;
    const int c = (i - r * kVecs) * kPer;
    *reinterpret_cast<uint4*>(dst + r * LDS + c) =
        *reinterpret_cast<const uint4*>(src + st * r + c);
  }
}

// f32 smem rows have an odd pitch (bank spread), so they are filled one
// float at a time.
template <int D, int LDS>
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src,
                                              long long st, int rows,
                                              int nthreads) {
  for (int i = threadIdx.x; i < rows * D; i += nthreads) {
    const int r = i / D;
    const int c = i - r * D;
    dst[r * LDS + c] = src[st * r + c];
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two bf16 values of a row-major [k][n] shared tile, rows k and k + 1 at
// column n, packed as one B-fragment register (low half = row k).
__device__ __forceinline__ uint32_t pack_col(const __nv_bfloat16* p,
                                             int lds) {
  __nv_bfloat162 v;
  v.x = p[0];
  v.y = p[lds];
  return *reinterpret_cast<uint32_t*>(&v);
}

// C fragment element e of an m16n8 tile sits at row g + 8 * (e >> 1),
// column 2 * t4 + (e & 1).
__device__ __forceinline__ int frag_col(int t4, int e) {
  return 2 * t4 + (e & 1);
}

// ---------------------------------------------------------------------------
// bf16: tensor cores. 128 threads; warp w owns query rows w*16 .. +15 of
// the block's 64.
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;
constexpr int kBK = 64;

// shared row pitch in bf16: 16-byte rows whose fragment loads spread
// over the banks
template <int D>
__host__ __device__ constexpr int bf16_lds() { return D + 8; }

template <int D>
constexpr size_t fwd_bf16_smem() {
  return 3 * kBQ * bf16_lds<D>() * sizeof(__nv_bfloat16) +
         kBK * sizeof(float);
}

// acc (16 x D, this warp's rows) += A (16 x 64, as m16n8 C fragments
// `f`, rounded to bf16) times the row-major [64][D] shared tile `Bs`.
template <int D, int LDS>
__device__ __forceinline__ void frag_times_rows(float (&acc)[D / 8][4],
                                                const float (&f)[8][4],
                                                const __nv_bfloat16* Bs,
                                                int g, int t4) {
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    uint32_t af[4];
    af[0] = pack_bf16(f[2 * kc][0], f[2 * kc][1]);
    af[1] = pack_bf16(f[2 * kc][2], f[2 * kc][3]);
    af[2] = pack_bf16(f[2 * kc + 1][0], f[2 * kc + 1][1]);
    af[3] = pack_bf16(f[2 * kc + 1][2], f[2 * kc + 1][3]);
    const int kr = kc * 16 + 2 * t4;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      uint32_t bf[2];
      const __nv_bfloat16* p = &Bs[kr * LDS + n * 8 + g];
      bf[0] = pack_col(p, LDS);
      bf[1] = pack_col(p + 8 * LDS, LDS);
      mma_bf16(acc[n], af, bf);
    }
  }
}

// out (16 x 64) = rows arow0 .. +15 of shared A [.][D] times the 64 rows
// of shared B [64][D], transposed (sum over d).
template <int D, int LDS>
__device__ __forceinline__ void rows_times_rows_t(float (&out)[8][4],
                                                  const __nv_bfloat16* As,
                                                  int arow0,
                                                  const __nv_bfloat16* Bs,
                                                  int g, int t4) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) out[n][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < D; ks += 16) {
    uint32_t af[4];
    const int r = arow0 + g;
    af[0] = lds32(&As[r * LDS + ks + 2 * t4]);
    af[1] = lds32(&As[(r + 8) * LDS + ks + 2 * t4]);
    af[2] = lds32(&As[r * LDS + ks + 2 * t4 + 8]);
    af[3] = lds32(&As[(r + 8) * LDS + ks + 2 * t4 + 8]);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      uint32_t bf[2];
      const int c = n * 8 + g;
      bf[0] = lds32(&Bs[c * LDS + ks + 2 * t4]);
      bf[1] = lds32(&Bs[c * LDS + ks + 2 * t4 + 8]);
      mma_bf16(out[n], af, bf);
    }
  }
}

template <int D, bool kPartial>
__global__ void __launch_bounds__(128) flash_fwd_bf16_kernel(FwdArgs a) {
  constexpr int LDS = bf16_lds<D>();
  constexpr int NT = kBK / 8;   // key n-tiles of S
  constexpr int ND = D / 8;     // d n-tiles of O
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + kBQ * LDS;
  __nv_bfloat16* Vs = Ks + kBK * LDS;
  float* km = reinterpret_cast<float*>(Vs + kBK * LDS);

  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int q0 = blockIdx.x * kBQ;
  const int b = blockIdx.y / a.H;
  const int h = blockIdx.y - b * a.H;
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q);
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(a.k);
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(a.v);

  load_rows<__nv_bfloat16, D, LDS>(
      Qs, q + row_off(a.q_sb, a.q_st, b, q0, h, D), a.q_st, kBQ, 128);

  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.f, 0.f};
  const int r_lo = q0 + w * 16 + g;  // this thread's rows: r_lo, r_lo + 8

  // causal: key tiles past the block's last visible key are skipped
  int k_end = a.Tk;
  if (a.causal) {
    const long long last = static_cast<long long>(q0) + kBQ - 1 + a.off;
    k_end = last < 0 ? 0 : (last + 1 < a.Tk ? static_cast<int>(last + 1)
                                             : a.Tk);
  }
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();
    load_rows<__nv_bfloat16, D, LDS>(
        Ks, k + row_off(a.k_sb, a.k_st, b, k0, h, D), a.k_st, kBK, 128);
    load_rows<__nv_bfloat16, D, LDS>(
        Vs, v + row_off(a.v_sb, a.v_st, b, k0, h, D), a.v_st, kBK, 128);
    if (threadIdx.x < kBK)
      km[threadIdx.x] = a.kmask == nullptr
                            ? 1.f
                            : a.kmask[static_cast<long long>(b) * a.Tk +
                                      k0 + threadIdx.x];
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[NT][4];
    rows_times_rows_t<D, LDS>(s, Qs, w * 16, Ks, g, t4);

    // scale and mask; row max over this thread's columns
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r_lo + 8 * (e >> 1);
        const int col = n * 8 + frag_col(t4, e);
        float x = s[n][e] * a.scale;
        const bool vis = !a.causal || row + a.off >= k0 + col;
        if (!vis || !(km[col] > 0.f)) x = kNegInf;
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      const float m_new = fmaxf(m_run[hh], mx[hh]);
      alpha[hh] = expf(m_run[hh] - m_new);
      m_run[hh] = m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r_lo + 8 * (e >> 1);
        const int col = k0 + n * 8 + frag_col(t4, e);
        const bool vis = !a.causal || row + a.off >= col;
        const float p = vis ? expf(s[n][e] - m_run[e >> 1]) : 0.f;
        s[n][e] = p;
        sum[e >> 1] += p;
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      sum[hh] += __shfl_xor_sync(0xffffffffu, sum[hh], 1);
      sum[hh] += __shfl_xor_sync(0xffffffffu, sum[hh], 2);
      l_run[hh] = l_run[hh] * alpha[hh] + sum[hh];
    }
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] *= alpha[e >> 1];

    // O += P V: P (bf16-rounded, as the reference's p.astype(v.dtype))
    // straight from the S fragments, V as row-major [key][d]
    frag_times_rows<D, LDS>(o, s, Vs, g, t4);
  }

  // epilogue
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = r_lo + 8 * hh;
    const long long obase =
        ((static_cast<long long>(b) * a.Tq + row) * a.H + h) * D;
    if constexpr (kPartial) {
      float* acc = static_cast<float*>(a.o);
#pragma unroll
      for (int n = 0; n < ND; ++n)
        store2(acc + obase + n * 8 + 2 * t4, o[n][2 * hh],
               o[n][2 * hh + 1]);
      if (t4 == 0) {
        const long long si =
            (static_cast<long long>(b) * a.H + h) * a.Tq + row;
        a.m[si] = m_run[hh];
        a.l[si] = l_run[hh];
      }
    } else {
      __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.o);
      const float inv = 1.f / fmaxf(l_run[hh], 1e-30f);
#pragma unroll
      for (int n = 0; n < ND; ++n)
        store2(out + obase + n * 8 + 2 * t4, o[n][2 * hh] * inv,
               o[n][2 * hh + 1] * inv);
    }
  }
}

// ---------------------------------------------------------------------------
// f32: plain FMA. 256 threads; TILE query rows x TILE keys per step
// (64 for D <= 64, else 32, to fit shared memory). Thread (ty, tx) owns
// the rows ty + 16 i and columns tx + 16 j of every product tile.
// ---------------------------------------------------------------------------

template <int D>
__host__ __device__ constexpr int f32_tile() {
  return D <= 64 ? 64 : 32;
}

template <int D>
constexpr size_t fwd_f32_smem() {
  constexpr int T = f32_tile<D>();
  return (3 * T * (D + 1) + T * (T + 1) + 4 * T) * sizeof(float);
}

template <int D, bool kPartial>
__global__ void __launch_bounds__(256) flash_fwd_f32_kernel(FwdArgs a) {
  constexpr int T = f32_tile<D>();
  constexpr int LD = D + 1;
  constexpr int LS = T + 1;
  constexpr int RI = T / 16;  // rows per thread
  constexpr int CD = D / 16;  // output columns per thread
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = Qs + T * LD;
  float* Vs = Ks + T * LD;
  float* Ss = Vs + T * LD;
  float* m_s = Ss + T * LS;
  float* l_s = m_s + T;
  float* al_s = l_s + T;
  float* km = al_s + T;

  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = blockIdx.x * T;
  const int b = blockIdx.y / a.H;
  const int h = blockIdx.y - b * a.H;
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);

  load_rows_f32<D, LD>(Qs, q + row_off(a.q_sb, a.q_st, b, q0, h, D),
                       a.q_st, T, 256);
  if (tid < T) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float o[RI][CD];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < CD; ++j) o[i][j] = 0.f;

  int k_end = a.Tk;
  if (a.causal) {
    const long long last = static_cast<long long>(q0) + T - 1 + a.off;
    k_end = last < 0 ? 0 : (last + 1 < a.Tk ? static_cast<int>(last + 1)
                                             : a.Tk);
  }
  for (int k0 = 0; k0 < k_end; k0 += T) {
    __syncthreads();
    load_rows_f32<D, LD>(Ks, k + row_off(a.k_sb, a.k_st, b, k0, h, D),
                         a.k_st, T, 256);
    load_rows_f32<D, LD>(Vs, v + row_off(a.v_sb, a.v_st, b, k0, h, D),
                         a.v_st, T, 256);
    if (tid < T)
      km[tid] = a.kmask == nullptr
                    ? 1.f
                    : a.kmask[static_cast<long long>(b) * a.Tk + k0 + tid];
    __syncthreads();

    // S = Q K^T, scaled and masked, into shared memory
    {
      float s[RI][RI];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < RI; ++j) s[i][j] = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        float qa[RI], kb[RI];
#pragma unroll
        for (int i = 0; i < RI; ++i) qa[i] = Qs[(ty + 16 * i) * LD + d];
#pragma unroll
        for (int j = 0; j < RI; ++j) kb[j] = Ks[(tx + 16 * j) * LD + d];
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int j = 0; j < RI; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
      }
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const int r = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < RI; ++j) {
          const int c = tx + 16 * j;
          float x = s[i][j] * a.scale;
          const bool vis = !a.causal || q0 + r + a.off >= k0 + c;
          if (!vis || !(km[c] > 0.f)) x = kNegInf;
          Ss[r * LS + c] = x;
        }
      }
    }
    __syncthreads();

    // online softmax, one warp per row at a time
    for (int r = warp; r < T; r += 8) {
      float mx = kNegInf;
      for (int c = lane; c < T; c += 32) mx = fmaxf(mx, Ss[r * LS + c]);
#pragma unroll
      for (int o2 = 16; o2 > 0; o2 >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o2));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = lane; c < T; c += 32) {
        const bool vis = !a.causal || q0 + r + a.off >= k0 + c;
        const float p = vis ? expf(Ss[r * LS + c] - m_new) : 0.f;
        Ss[r * LS + c] = p;
        sum += p;
      }
#pragma unroll
      for (int o2 = 16; o2 > 0; o2 >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o2);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        al_s[r] = alpha;
        m_s[r] = m_new;
        l_s[r] = l_s[r] * alpha + sum;
      }
    }
    __syncthreads();

    // O = O * alpha + P V
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const float alpha = al_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < CD; ++j) o[i][j] *= alpha;
    }
#pragma unroll 4
    for (int c = 0; c < T; ++c) {
      float pa[RI], vb[CD];
#pragma unroll
      for (int i = 0; i < RI; ++i) pa[i] = Ss[(ty + 16 * i) * LS + c];
#pragma unroll
      for (int j = 0; j < CD; ++j) vb[j] = Vs[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CD; ++j) o[i][j] = fmaf(pa[i], vb[j], o[i][j]);
    }
  }
  __syncthreads();

  float* out = static_cast<float*>(a.o);
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = ty + 16 * i;
    const int row = q0 + r;
    const long long obase =
        ((static_cast<long long>(b) * a.Tq + row) * a.H + h) * D;
    const float inv = kPartial ? 1.f : 1.f / fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < CD; ++j) out[obase + tx + 16 * j] = o[i][j] * inv;
    if (kPartial && tx == 0) {
      const long long si = (static_cast<long long>(b) * a.H + h) * a.Tq + row;
      a.m[si] = m_s[r];
      a.l[si] = l_s[r];
    }
  }
}

template <typename K>
inline cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int D, bool kPartial>
inline int launch_fwd_d(const FwdArgs& a, int bf16, cudaStream_t stream) {
  if (bf16) {
    constexpr size_t smem = fwd_bf16_smem<D>();
    auto kernel = flash_fwd_bf16_kernel<D, kPartial>;
    cudaError_t err = set_smem(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(a.Tq / kBQ, a.B * a.H);
    note_launch("flash_fwd_bf16_kernel<%d, %s>", D, bool_name(kPartial));
    kernel<<<grid, 128, smem, stream>>>(a);
  } else {
    constexpr size_t smem = fwd_f32_smem<D>();
    auto kernel = flash_fwd_f32_kernel<D, kPartial>;
    cudaError_t err = set_smem(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(a.Tq / f32_tile<D>(), a.B * a.H);
    note_launch("flash_fwd_f32_kernel<%d, %s>", D, bool_name(kPartial));
    kernel<<<grid, 256, smem, stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launches the forward at D 32 or 256 (D 64 and 128 run
// flash_fwd_sm90.cuh's kernels) on `stream`; returns cudaGetLastError()
// so the caller can raise on a refused launch (or an unsupported D, as
// cudaErrorInvalidValue). Allocates nothing.
template <bool kPartial>
inline int launch_fwd(const FwdArgs& a, int D, int bf16,
                      cudaStream_t stream) {
  if (a.Tq == 0 || a.B * a.H == 0) return 0;
  switch (D) {
    case 32: return launch_fwd_d<32, kPartial>(a, bf16, stream);
    case 256: return launch_fwd_d<256, kPartial>(a, bf16, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

inline FwdArgs make_fwd_args(const void* q, const void* k, const void* v,
                             const void* kmask, void* o, void* m, void* l,
                             int B, int H, int Tq, int Tk, long long q_sb,
                             long long q_st, long long k_sb, long long k_st,
                             long long v_sb, long long v_st, int causal,
                             int off, float scale) {
  FwdArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.kmask = static_cast<const float*>(kmask);
  a.o = o;
  a.m = static_cast<float*>(m);
  a.l = static_cast<float*>(l);
  a.B = B;
  a.H = H;
  a.Tq = Tq;
  a.Tk = Tk;
  a.q_sb = q_sb;
  a.q_st = q_st;
  a.k_sb = k_sb;
  a.k_st = k_st;
  a.v_sb = v_sb;
  a.v_st = v_st;
  a.causal = causal;
  a.off = off;
  a.scale = scale;
  return a;
}

}  // namespace flash
}  // namespace zoo
