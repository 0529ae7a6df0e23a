// Flash-attention backward for Hopper (sm_90a), FlashAttention-2 style,
// at head dims 32 and 256 (64 and 128 run flash_bwd_sm90.cuh's wgmma
// kernels, which take BwdArgs and the helpers below):
//
// - `flash_bwd_dkdv` (B9): one block per tile of 64 keys (32 in f32 for
//   D >= 128), looping over the query tiles that can see them:
//     dV[j] = sum_i p[i, j] dO[i]
//     dK[j] = sum_i ds[i, j] q[i]
// - `flash_bwd_dq` (B10): one block per tile of query rows, looping over
//   the key tiles they can see:
//     dQ[i] = sum_j ds[i, j] k[j]
// where, recomputed from the forward's saved row statistics,
//   p[i, j]  = exp(s[i, j] - m[i]) / max(l[i], 1e-30)   (0 if causally
//              invisible)
//   ds[i, j] = p[i, j] (dO[i] . v[j] - delta[i]) * scale  (0 wherever s
//              is masked)
//   delta[i] = dO[i] . o[i]                     (computed by the caller)
// Each block owns its output tile, so neither kernel needs a sum across
// blocks: no atomics, the same bits every run.
//
// Replaces the TPU's Pallas kernels of analytics_zoo_tpu/ops/
// flash_attention.py: `_bwd_dkdv_kernel[_masked]` and
// `_bwd_dq_kernel[_masked]` (called from `_flash_vjp_bwd`).
//
// As in the reference (`_recompute_p`), p is exp(s - m) / l and not
// exp(s - lse): with m = -1e30 (a row whose keys are all padding) the
// fused log-sum-exp would absorb log(l) and give p = 1 instead of the
// forward's 1/l. A row of all-padding keys has a uniform p that feeds dV
// but, its ds being masked, not dQ or dK (`_mask_ds`). A row that sees no
// key under causal masking has p = 0 everywhere and gets no gradient.
// bf16 rounding follows the reference: p and ds are rounded to the
// operand type before their products, which accumulate in f32; dQ, dK
// and dV come back in q's, k's and v's type.
//
// What bounds it on the H100: the pair does 2.5x the forward's
// 4*B*H*Tq*Tk*D operations (five products to the forward's two, with S
// and dO.V^T computed by both kernels), on tensor cores (bf16) or plain
// FMA (f32), so by operations. Products are mma.sync m16n8k16 with f32
// accumulators; each warp owns 16 keys (B9) or 16 query rows (B10) and
// keeps its S, dP and output accumulators in registers, converting the
// S/dS fragments to A operands in place. First, simple kernels: no
// double buffering, no wgmma or TMA; the B operands read from row-major
// tiles are gathered two bf16 at a time.

#pragma once

#include "flash_attn_fwd.cuh"

namespace zoo {
namespace flash {

struct BwdArgs {
  const void* q;          // (B, Tq, H, D), strides q_sb, q_st
  const void* k;          // (B, Tk, H, D)
  const void* v;          // (B, Tk, H, D)
  const void* dout;       // (B, Tq, H, D), strides do_sb, do_st
  const float* kmask;     // (B, Tk) or null
  const float* m;         // (B, H, Tq)
  const float* l;         // (B, H, Tq)
  const float* delta;     // (B, H, Tq)
  void* dq;               // (B, Tq, H, D) contiguous, q's type
  void* dk;               // (B, Tk, H, D) contiguous, k's type
  void* dv;               // (B, Tk, H, D) contiguous, v's type
  int B, H, Tq, Tk;
  long long q_sb, q_st, k_sb, k_st, v_sb, v_st, do_sb, do_st;
  int causal, off;
  float scale;
};

// First query row that can see key k0 (causal), clamped to [0, Tq].
__device__ __forceinline__ int first_q(const BwdArgs& a, int k0) {
  if (!a.causal) return 0;
  const long long r = static_cast<long long>(k0) - a.off;
  return r <= 0 ? 0 : (r >= a.Tq ? a.Tq : static_cast<int>(r));
}

// ---------------------------------------------------------------------------
// bf16, tensor cores: 128 threads, 64-row tiles
// ---------------------------------------------------------------------------

template <int D>
constexpr size_t bwd_bf16_smem() {
  return 4 * 64 * bf16_lds<D>() * sizeof(__nv_bfloat16) +
         4 * 64 * sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(128) flash_dkdv_bf16_kernel(BwdArgs a) {
  constexpr int LDS = bf16_lds<D>();
  constexpr int ND = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Vs = Ks + 64 * LDS;
  __nv_bfloat16* Qs = Vs + 64 * LDS;
  __nv_bfloat16* Os = Qs + 64 * LDS;  // dO
  float* m_s = reinterpret_cast<float*>(Os + 64 * LDS);
  float* l_s = m_s + 64;
  float* d_s = l_s + 64;
  float* km = d_s + 64;

  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int k0 = blockIdx.x * 64;
  const int b = blockIdx.y / a.H;
  const int h = blockIdx.y - b * a.H;
  using bf = __nv_bfloat16;

  load_rows<bf, D, LDS>(Ks, static_cast<const bf*>(a.k) +
                                row_off(a.k_sb, a.k_st, b, k0, h, D),
                        a.k_st, 64, 128);
  load_rows<bf, D, LDS>(Vs, static_cast<const bf*>(a.v) +
                                row_off(a.v_sb, a.v_st, b, k0, h, D),
                        a.v_st, 64, 128);
  if (threadIdx.x < 64)
    km[threadIdx.x] = a.kmask == nullptr
                          ? 1.f
                          : a.kmask[static_cast<long long>(b) * a.Tk + k0 +
                                    threadIdx.x];

  float dk[ND][4], dv[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  const int kr_lo = w * 16 + g;  // this thread's key rows: +0, +8 (local)

  for (int q0 = first_q(a, k0) / 64 * 64; q0 < a.Tq; q0 += 64) {
    __syncthreads();
    load_rows<bf, D, LDS>(Qs, static_cast<const bf*>(a.q) +
                                  row_off(a.q_sb, a.q_st, b, q0, h, D),
                          a.q_st, 64, 128);
    load_rows<bf, D, LDS>(Os, static_cast<const bf*>(a.dout) +
                                  row_off(a.do_sb, a.do_st, b, q0, h, D),
                          a.do_st, 64, 128);
    if (threadIdx.x < 64) {
      const long long si = stat_idx(a, b, h, q0 + threadIdx.x);
      m_s[threadIdx.x] = a.m[si];
      l_s[threadIdx.x] = a.l[si];
      d_s[threadIdx.x] = a.delta[si];
    }
    __syncthreads();

    // S^T (16 keys x 64 queries) = K Q^T, then P^T
    float p[8][4];
    rows_times_rows_t<D, LDS>(p, Ks, w * 16, Qs, g, t4);
    bool live[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kl = kr_lo + 8 * (e >> 1);
        const int ql = n * 8 + frag_col(t4, e);
        const bool vis = !a.causal || q0 + ql + a.off >= k0 + kl;
        const bool ok = vis && km[kl] > 0.f;
        const float s = ok ? p[n][e] * a.scale : kNegInf;
        live[n][e] = ok;
        p[n][e] = vis ? expf(s - m_s[ql]) / fmaxf(l_s[ql], 1e-30f) : 0.f;
      }
    }
    // dV += P^T dO
    frag_times_rows<D, LDS>(dv, p, Os, g, t4);
    // dP^T = V dO^T; dS^T = P^T (dP^T - delta) scale, zero where masked
    float ds[8][4];
    rows_times_rows_t<D, LDS>(ds, Vs, w * 16, Os, g, t4);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = n * 8 + frag_col(t4, e);
        ds[n][e] = live[n][e]
                       ? p[n][e] * (ds[n][e] - d_s[ql]) * a.scale
                       : 0.f;
      }
    }
    // dK += dS^T Q
    frag_times_rows<D, LDS>(dk, ds, Qs, g, t4);
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = k0 + kr_lo + 8 * hh;
    const long long base = out_idx(b, a.Tk, a.H, row, h, D);
    bf* dkp = static_cast<bf*>(a.dk) + base;
    bf* dvp = static_cast<bf*>(a.dv) + base;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      store2(dkp + n * 8 + 2 * t4, dk[n][2 * hh], dk[n][2 * hh + 1]);
      store2(dvp + n * 8 + 2 * t4, dv[n][2 * hh], dv[n][2 * hh + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(128) flash_dq_bf16_kernel(BwdArgs a) {
  constexpr int LDS = bf16_lds<D>();
  constexpr int ND = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Os = Qs + 64 * LDS;  // dO
  __nv_bfloat16* Ks = Os + 64 * LDS;
  __nv_bfloat16* Vs = Ks + 64 * LDS;
  float* km = reinterpret_cast<float*>(Vs + 64 * LDS);

  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int q0 = blockIdx.x * 64;
  const int b = blockIdx.y / a.H;
  const int h = blockIdx.y - b * a.H;
  using bf = __nv_bfloat16;

  load_rows<bf, D, LDS>(Qs, static_cast<const bf*>(a.q) +
                                row_off(a.q_sb, a.q_st, b, q0, h, D),
                        a.q_st, 64, 128);
  load_rows<bf, D, LDS>(Os, static_cast<const bf*>(a.dout) +
                                row_off(a.do_sb, a.do_st, b, q0, h, D),
                        a.do_st, 64, 128);
  const int r_lo = w * 16 + g;  // local rows r_lo, r_lo + 8
  float m_r[2], l_r[2], d_r[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const long long si = stat_idx(a, b, h, q0 + r_lo + 8 * hh);
    m_r[hh] = a.m[si];
    l_r[hh] = fmaxf(a.l[si], 1e-30f);
    d_r[hh] = a.delta[si];
  }
  float dq[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;

  const int k_end = key_end(a, q0, 64);
  for (int k0 = 0; k0 < k_end; k0 += 64) {
    __syncthreads();
    load_rows<bf, D, LDS>(Ks, static_cast<const bf*>(a.k) +
                                  row_off(a.k_sb, a.k_st, b, k0, h, D),
                          a.k_st, 64, 128);
    load_rows<bf, D, LDS>(Vs, static_cast<const bf*>(a.v) +
                                  row_off(a.v_sb, a.v_st, b, k0, h, D),
                          a.v_st, 64, 128);
    if (threadIdx.x < 64)
      km[threadIdx.x] = a.kmask == nullptr
                            ? 1.f
                            : a.kmask[static_cast<long long>(b) * a.Tk +
                                      k0 + threadIdx.x];
    __syncthreads();

    float p[8][4];
    rows_times_rows_t<D, LDS>(p, Qs, w * 16, Ks, g, t4);
    bool live[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hh = e >> 1;
        const int ql = r_lo + 8 * hh;
        const int kl = n * 8 + frag_col(t4, e);
        const bool vis = !a.causal || q0 + ql + a.off >= k0 + kl;
        const bool ok = vis && km[kl] > 0.f;
        const float s = ok ? p[n][e] * a.scale : kNegInf;
        live[n][e] = ok;
        p[n][e] = vis ? expf(s - m_r[hh]) / l_r[hh] : 0.f;
      }
    }
    float ds[8][4];
    rows_times_rows_t<D, LDS>(ds, Os, w * 16, Vs, g, t4);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ds[n][e] = live[n][e]
                       ? p[n][e] * (ds[n][e] - d_r[e >> 1]) * a.scale
                       : 0.f;
    // dQ += dS K
    frag_times_rows<D, LDS>(dq, ds, Ks, g, t4);
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = q0 + r_lo + 8 * hh;
    bf* dqp = static_cast<bf*>(a.dq) + out_idx(b, a.Tq, a.H, row, h, D);
#pragma unroll
    for (int n = 0; n < ND; ++n)
      store2(dqp + n * 8 + 2 * t4, dq[n][2 * hh], dq[n][2 * hh + 1]);
  }
}

// ---------------------------------------------------------------------------
// f32, plain FMA: 256 threads, TILE = f32_tile<D>() rows per tile.
// Thread (ty, tx) owns rows ty + 16 i and columns tx + 16 j.
// ---------------------------------------------------------------------------

template <int D>
constexpr size_t bwd_f32_smem() {
  constexpr int T = f32_tile<D>();
  return (4 * T * (D + 1) + 2 * T * (T + 1) + 4 * T) * sizeof(float);
}

// P and dS of one (TILE query rows) x (TILE keys) pair of tiles into
// shared memory, P[qi][kj] and dS[qi][kj]; Qs/Os rows are queries, Ks/Vs
// rows keys. m, l, delta are per local query row.
template <int D>
__device__ __forceinline__ void f32_p_ds(const BwdArgs& a, const float* Qs,
                                         const float* Os, const float* Ks,
                                         const float* Vs, const float* m,
                                         const float* l, const float* dl,
                                         const float* km, float* Ps,
                                         float* Ds, int q0, int k0, int ty,
                                         int tx) {
  constexpr int T = f32_tile<D>();
  constexpr int LD = D + 1;
  constexpr int LS = T + 1;
  constexpr int RI = T / 16;
  float s[RI][RI], dp[RI][RI];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < RI; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qa[RI], oa[RI], kb[RI], vb[RI];
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      qa[i] = Qs[(ty + 16 * i) * LD + d];
      oa[i] = Os[(ty + 16 * i) * LD + d];
    }
#pragma unroll
    for (int j = 0; j < RI; ++j) {
      kb[j] = Ks[(tx + 16 * j) * LD + d];
      vb[j] = Vs[(tx + 16 * j) * LD + d];
    }
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < RI; ++j) {
        s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
        dp[i][j] = fmaf(oa[i], vb[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < RI; ++j) {
      const int c = tx + 16 * j;
      const bool vis = !a.causal || q0 + r + a.off >= k0 + c;
      const bool ok = vis && km[c] > 0.f;
      const float x = ok ? s[i][j] * a.scale : kNegInf;
      const float p = vis ? expf(x - m[r]) / fmaxf(l[r], 1e-30f) : 0.f;
      Ps[r * LS + c] = p;
      Ds[r * LS + c] = ok ? p * (dp[i][j] - dl[r]) * a.scale : 0.f;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(256) flash_dkdv_f32_kernel(BwdArgs a) {
  constexpr int T = f32_tile<D>();
  constexpr int LD = D + 1;
  constexpr int LS = T + 1;
  constexpr int RI = T / 16;
  constexpr int CD = D / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem);
  float* Vs = Ks + T * LD;
  float* Qs = Vs + T * LD;
  float* Os = Qs + T * LD;
  float* Ps = Os + T * LD;
  float* Ds = Ps + T * LS;
  float* m_s = Ds + T * LS;
  float* l_s = m_s + T;
  float* d_s = l_s + T;
  float* km = d_s + T;

  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int k0 = blockIdx.x * T;
  const int b = blockIdx.y / a.H;
  const int h = blockIdx.y - b * a.H;

  load_rows_f32<D, LD>(Ks, static_cast<const float*>(a.k) +
                               row_off(a.k_sb, a.k_st, b, k0, h, D),
                       a.k_st, T, 256);
  load_rows_f32<D, LD>(Vs, static_cast<const float*>(a.v) +
                               row_off(a.v_sb, a.v_st, b, k0, h, D),
                       a.v_st, T, 256);
  if (tid < T)
    km[tid] = a.kmask == nullptr
                  ? 1.f
                  : a.kmask[static_cast<long long>(b) * a.Tk + k0 + tid];
  float dk[RI][CD], dv[RI][CD];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < CD; ++j) dk[i][j] = dv[i][j] = 0.f;

  for (int q0 = first_q(a, k0) / T * T; q0 < a.Tq; q0 += T) {
    __syncthreads();
    load_rows_f32<D, LD>(Qs, static_cast<const float*>(a.q) +
                                 row_off(a.q_sb, a.q_st, b, q0, h, D),
                         a.q_st, T, 256);
    load_rows_f32<D, LD>(Os, static_cast<const float*>(a.dout) +
                                 row_off(a.do_sb, a.do_st, b, q0, h, D),
                         a.do_st, T, 256);
    if (tid < T) {
      const long long si = stat_idx(a, b, h, q0 + tid);
      m_s[tid] = a.m[si];
      l_s[tid] = a.l[si];
      d_s[tid] = a.delta[si];
    }
    __syncthreads();
    f32_p_ds<D>(a, Qs, Os, Ks, Vs, m_s, l_s, d_s, km, Ps, Ds, q0, k0, ty,
                tx);
    __syncthreads();
    // dV[key][d] += sum_q P[q][key] dO[q][d]; dK likewise with dS and Q
#pragma unroll 4
    for (int qi = 0; qi < T; ++qi) {
      float pa[RI], da[RI], ob[CD], qb[CD];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        pa[i] = Ps[qi * LS + ty + 16 * i];
        da[i] = Ds[qi * LS + ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < CD; ++j) {
        ob[j] = Os[qi * LD + tx + 16 * j];
        qb[j] = Qs[qi * LD + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CD; ++j) {
          dv[i][j] = fmaf(pa[i], ob[j], dv[i][j]);
          dk[i][j] = fmaf(da[i], qb[j], dk[i][j]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const long long base = out_idx(b, a.Tk, a.H, k0 + ty + 16 * i, h, D);
#pragma unroll
    for (int j = 0; j < CD; ++j) {
      static_cast<float*>(a.dk)[base + tx + 16 * j] = dk[i][j];
      static_cast<float*>(a.dv)[base + tx + 16 * j] = dv[i][j];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(256) flash_dq_f32_kernel(BwdArgs a) {
  constexpr int T = f32_tile<D>();
  constexpr int LD = D + 1;
  constexpr int LS = T + 1;
  constexpr int RI = T / 16;
  constexpr int CD = D / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Os = Qs + T * LD;
  float* Ks = Os + T * LD;
  float* Vs = Ks + T * LD;
  float* Ps = Vs + T * LD;
  float* Ds = Ps + T * LS;
  float* m_s = Ds + T * LS;
  float* l_s = m_s + T;
  float* d_s = l_s + T;
  float* km = d_s + T;

  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int q0 = blockIdx.x * T;
  const int b = blockIdx.y / a.H;
  const int h = blockIdx.y - b * a.H;

  load_rows_f32<D, LD>(Qs, static_cast<const float*>(a.q) +
                               row_off(a.q_sb, a.q_st, b, q0, h, D),
                       a.q_st, T, 256);
  load_rows_f32<D, LD>(Os, static_cast<const float*>(a.dout) +
                               row_off(a.do_sb, a.do_st, b, q0, h, D),
                       a.do_st, T, 256);
  if (tid < T) {
    const long long si = stat_idx(a, b, h, q0 + tid);
    m_s[tid] = a.m[si];
    l_s[tid] = a.l[si];
    d_s[tid] = a.delta[si];
  }
  float dq[RI][CD];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < CD; ++j) dq[i][j] = 0.f;

  const int k_end = key_end(a, q0, T);
  for (int k0 = 0; k0 < k_end; k0 += T) {
    __syncthreads();
    load_rows_f32<D, LD>(Ks, static_cast<const float*>(a.k) +
                                 row_off(a.k_sb, a.k_st, b, k0, h, D),
                         a.k_st, T, 256);
    load_rows_f32<D, LD>(Vs, static_cast<const float*>(a.v) +
                                 row_off(a.v_sb, a.v_st, b, k0, h, D),
                         a.v_st, T, 256);
    if (tid < T)
      km[tid] = a.kmask == nullptr
                    ? 1.f
                    : a.kmask[static_cast<long long>(b) * a.Tk + k0 + tid];
    __syncthreads();
    f32_p_ds<D>(a, Qs, Os, Ks, Vs, m_s, l_s, d_s, km, Ps, Ds, q0, k0, ty,
                tx);
    __syncthreads();
    // dQ[q][d] += sum_key dS[q][key] K[key][d]
#pragma unroll 4
    for (int c = 0; c < T; ++c) {
      float da[RI], kb[CD];
#pragma unroll
      for (int i = 0; i < RI; ++i) da[i] = Ds[(ty + 16 * i) * LS + c];
#pragma unroll
      for (int j = 0; j < CD; ++j) kb[j] = Ks[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CD; ++j) dq[i][j] = fmaf(da[i], kb[j], dq[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const long long base = out_idx(b, a.Tq, a.H, q0 + ty + 16 * i, h, D);
#pragma unroll
    for (int j = 0; j < CD; ++j)
      static_cast<float*>(a.dq)[base + tx + 16 * j] = dq[i][j];
  }
}

template <int D, bool kDkDv>
inline int launch_bwd_d(const BwdArgs& a, int bf16, cudaStream_t stream) {
  const int rows = kDkDv ? a.Tk : a.Tq;
  if (bf16) {
    constexpr size_t smem = bwd_bf16_smem<D>();
    void (*kernel)(BwdArgs);
    if constexpr (kDkDv)
      kernel = flash_dkdv_bf16_kernel<D>;
    else
      kernel = flash_dq_bf16_kernel<D>;
    cudaError_t err = set_smem(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<dim3(rows / 64, a.B * a.H), 128, smem, stream>>>(a);
  } else {
    constexpr size_t smem = bwd_f32_smem<D>();
    void (*kernel)(BwdArgs);
    if constexpr (kDkDv)
      kernel = flash_dkdv_f32_kernel<D>;
    else
      kernel = flash_dq_f32_kernel<D>;
    cudaError_t err = set_smem(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<dim3(rows / f32_tile<D>(), a.B * a.H), 256, smem, stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launches B9 (kDkDv) or B10 at D 32 or 256 (D 64 and 128 run
// flash_bwd_sm90.cuh's kernels) on `stream`; returns cudaGetLastError().
template <bool kDkDv>
inline int launch_bwd(const BwdArgs& a, int D, int bf16,
                      cudaStream_t stream) {
  if ((kDkDv ? a.Tk : a.Tq) == 0 || a.B * a.H == 0) return 0;
  switch (D) {
    case 32: return launch_bwd_d<32, kDkDv>(a, bf16, stream);
    case 256: return launch_bwd_d<256, kDkDv>(a, bf16, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

inline BwdArgs make_bwd_args(const void* q, const void* k, const void* v,
                             const void* dout, const void* kmask,
                             const void* m, const void* l, const void* delta,
                             void* dq, void* dk, void* dv, int B, int H,
                             int Tq, int Tk, long long q_sb, long long q_st,
                             long long k_sb, long long k_st, long long v_sb,
                             long long v_st, long long do_sb,
                             long long do_st, int causal, int off,
                             float scale) {
  BwdArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.kmask = static_cast<const float*>(kmask);
  a.m = static_cast<const float*>(m);
  a.l = static_cast<const float*>(l);
  a.delta = static_cast<const float*>(delta);
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
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
  a.do_sb = do_sb;
  a.do_st = do_st;
  a.causal = causal;
  a.off = off;
  a.scale = scale;
  return a;
}

}  // namespace flash
}  // namespace zoo
