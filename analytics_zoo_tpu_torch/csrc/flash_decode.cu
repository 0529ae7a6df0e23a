// Single-query decode attention over a gathered paged KV cache
// (`flash_decode` in analytics_zoo_tpu_torch/ops/flash_attention.py, B11).
//
// For every slot s and head h:
//   o[s, h, :] = sum_j p[j] v[s, j, h, :] / sum_j p[j],
//   p[j] = exp(c[j] - max_j c[j]),
//   c[j] = (q[s, h, :] . k[s, j, h, :]) * scale, or -1e30 where
//          kmask[s, j] <= 0,
// with the softmax in f32 whatever the operand type, and o in q's type.
//
// Replaces the TPU's Pallas kernel of analytics_zoo_tpu/ops/
// flash_attention.py: `flash_decode_attention` (`_fwd_kernel_masked` on
// grid (S, H, 1, T/bk), with the one query row copied into an (8, D)
// tile because a TPU sublane holds 8 rows). Here one query row is one
// row: no copies.
//
// Semantics kept from the reference: masked logits are -1e30, never
// -inf, so a slot with no valid key averages all T keys uniformly, as
// the dense path does. Int8 caches are dequantized by the caller before
// the kernel, as the reference does.
//
// What bounds it on the H100: bytes. A slot reads its valid keys' K and
// V rows once (2 * len * H * D * size bytes) for 4 * len * H * D
// operations: one operation per byte in f32, two in bf16, far below the
// card's ~20 (FMA) and ~295 (tensor cores) operations per byte. So the
// design only has to keep enough loads in flight and read no byte it
// does not need:
// - one block per (slot, head), 8 warps. A warp splits into key groups
//   of G lanes, G * 16 bytes covering one K (or V) row (G <= 32), so a
//   group reads a row as one coalesced burst of 16-byte loads, and the
//   block keeps 4 keys per group (up to 256 keys) in flight;
// - each group runs its own online softmax (running max m, sum l and
//   its slice of the output accumulator in registers), reducing q . k
//   over its G lanes by shuffles; the groups merge once at the end in
//   shared memory, in a fixed order (the same bits every run);
// - a key whose mask is 0 is never read when the slot has any valid key
//   (its p would be exactly 0), so a launch reads only the valid rows:
//   its bytes follow the slots' lengths, not the cache's capacity T. A
//   slot with no valid key reads every row, for the uniform average.
// bf16 rows multiply in f32, p rounded to bf16 before p * v as the flash
// forward does. Left for later: splitting T over blocks (flash-decoding)
// when slots * heads is below the SM count, and reading the pages in
// place through the page table instead of the gathered view.
//
// Layout: q (S, H, D) with slot stride q_ss (a column slice of the fused
// qkv projection is read in place); k, v (S, T, H, D) with slot and time
// strides; heads at stride D, the last axis contiguous, rows 16-byte
// aligned (the wrapper checks). kmask (S, T) f32. o (S, H, D)
// contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 4;   // keys per group in flight

template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;   // elements per 16-byte load
  __device__ static void load(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  }
  __device__ static float round_p(float p) { return p; }
  __device__ static void store(float* p, float v) { *p = v; }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const __nv_bfloat16* p, float* out) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  __device__ static float round_p(float p) {
    return __bfloat162float(__float2bfloat16(p));
  }
  __device__ static void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16(v);
  }
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ kmask,
                    T* __restrict__ o, int H, int Tk, long long q_ss,
                    long long k_ss, long long k_st, long long v_ss,
                    long long v_st, float scale) {
  constexpr int VEC = Vec<T>::N;
  constexpr int G = (D / VEC < 32) ? D / VEC : 32;   // lanes per key
  constexpr int NV = D / (G * VEC);                   // loads per lane
  constexpr int PER = NV * VEC;                       // elements per lane
  constexpr int KPW = 32 / G;                         // keys per warp
  constexpr int NG = kWarps * KPW;                    // key groups
  static_assert(NG * D <= 2048, "merge buffer exceeds 8 KB");
  __shared__ float s_acc[NG][D];
  __shared__ float s_m[NG];
  __shared__ float s_l[NG];

  const int h = blockIdx.x;
  const int s = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int sub = lane % G;
  const int grp = (threadIdx.x >> 5) * KPW + lane / G;
  const float* mrow = kmask + static_cast<long long>(s) * Tk;

  // does the slot have a valid key? (else every key counts, uniformly)
  int any = 0;
  for (int j = threadIdx.x; j < Tk; j += kThreads) any |= mrow[j] > 0.f;
  const bool any_valid = __syncthreads_or(any) != 0;

  // this lane's elements: load n covers [(n * G + sub) * VEC, + VEC)
  float qf[PER];
  const T* qrow = q + s * q_ss + static_cast<long long>(h) * D;
#pragma unroll
  for (int n = 0; n < NV; ++n)
    Vec<T>::load(qrow + (n * G + sub) * VEC, qf + n * VEC);
  const T* kb = k + s * k_ss + static_cast<long long>(h) * D;
  const T* vb = v + s * v_ss + static_cast<long long>(h) * D;

  float acc[PER];
#pragma unroll
  for (int e = 0; e < PER; ++e) acc[e] = 0.f;
  float m = kNegInf;
  float l = 0.f;

  for (int base = 0; base < Tk; base += NG * kUnroll) {
    float kf[kUnroll][PER];
    float vf[kUnroll][PER];
    bool use[kUnroll];
    bool live[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = base + u * NG + grp;
      live[u] = j < Tk && mrow[j] > 0.f;
      use[u] = j < Tk && (live[u] || !any_valid);
      if (use[u]) {
#pragma unroll
        for (int n = 0; n < NV; ++n) {
          const int off = (n * G + sub) * VEC;
          Vec<T>::load(kb + j * k_st + off, kf[u] + n * VEC);
          Vec<T>::load(vb + j * v_st + off, vf[u] + n * VEC);
        }
      } else {
#pragma unroll
        for (int e = 0; e < PER; ++e) kf[u][e] = vf[u][e] = 0.f;
      }
    }
    float c[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float d = 0.f;
#pragma unroll
      for (int e = 0; e < PER; ++e) d = fmaf(qf[e], kf[u][e], d);
      // every lane shuffles: the group's G lanes hold the same key
#pragma unroll
      for (int w = G / 2; w > 0; w >>= 1)
        d += __shfl_xor_sync(0xffffffffu, d, w);
      c[u] = live[u] ? d * scale : kNegInf;
    }
    float mx = m;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (use[u]) mx = fmaxf(mx, c[u]);
    const float alpha = __expf(m - mx);
    l *= alpha;
#pragma unroll
    for (int e = 0; e < PER; ++e) acc[e] *= alpha;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (!use[u]) continue;
      const float p = __expf(c[u] - mx);
      l += p;
      const float pr = Vec<T>::round_p(p);
#pragma unroll
      for (int e = 0; e < PER; ++e) acc[e] = fmaf(pr, vf[u][e], acc[e]);
    }
    m = mx;
  }

  // merge the groups: rescale each to the block's max, sum in group order
  if (sub == 0) {
    s_m[grp] = m;
    s_l[grp] = l;
  }
  __syncthreads();
  float mb = kNegInf;
#pragma unroll
  for (int g = 0; g < NG; ++g) mb = fmaxf(mb, s_m[g]);
  const float w = __expf(m - mb);
#pragma unroll
  for (int n = 0; n < NV; ++n)
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      s_acc[grp][(n * G + sub) * VEC + i] = acc[n * VEC + i] * w;
  __syncthreads();
  float lb = 0.f;
#pragma unroll
  for (int g = 0; g < NG; ++g) lb += s_l[g] * __expf(s_m[g] - mb);
  const float inv = 1.f / fmaxf(lb, 1e-30f);
  T* orow = o + (static_cast<long long>(s) * H + h) * D;
  for (int e = threadIdx.x; e < D; e += kThreads) {
    float sum = 0.f;
#pragma unroll
    for (int g = 0; g < NG; ++g) sum += s_acc[g][e];
    Vec<T>::store(orow + e, sum * inv);
  }
}

template <typename T>
cudaError_t launch_typed(const void* q, const void* k, const void* v,
                         const float* kmask, void* o, int S, int H, int Tk,
                         int D, long long q_ss, long long k_ss,
                         long long k_st, long long v_ss, long long v_st,
                         float scale, cudaStream_t stream) {
  const dim3 grid(H, S);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(o);
  switch (D) {
    case 32:
      flash_decode_kernel<T, 32><<<grid, kThreads, 0, stream>>>(
          qt, kt, vt, kmask, ot, H, Tk, q_ss, k_ss, k_st, v_ss, v_st, scale);
      break;
    case 64:
      flash_decode_kernel<T, 64><<<grid, kThreads, 0, stream>>>(
          qt, kt, vt, kmask, ot, H, Tk, q_ss, k_ss, k_st, v_ss, v_st, scale);
      break;
    case 128:
      flash_decode_kernel<T, 128><<<grid, kThreads, 0, stream>>>(
          qt, kt, vt, kmask, ot, H, Tk, q_ss, k_ss, k_st, v_ss, v_st, scale);
      break;
    case 256:
      flash_decode_kernel<T, 256><<<grid, kThreads, 0, stream>>>(
          qt, kt, vt, kmask, ot, H, Tk, q_ss, k_ss, k_st, v_ss, v_st, scale);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int flash_decode_launch(
    const void* q, const void* k, const void* v, const void* kmask, void* o,
    int S, int H, int Tk, int D, long long q_ss, long long k_ss,
    long long k_st, long long v_ss, long long v_st, float scale, int bf16,
    void* stream) {
  const float* km = static_cast<const float*>(kmask);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? launch_typed<__nv_bfloat16>(q, k, v, km, o, S, H, Tk, D, q_ss,
                                          k_ss, k_st, v_ss, v_st, scale, st)
           : launch_typed<float>(q, k, v, km, o, S, H, Tk, D, q_ss, k_ss,
                                 k_st, v_ss, v_st, scale, st);
  return static_cast<int>(err);
}
