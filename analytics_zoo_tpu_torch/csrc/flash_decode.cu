// Single-query decode attention over a paged KV cache (B11: `flash_decode`
// in analytics_zoo_tpu_torch/ops/flash_attention.py).
//
// For every slot s and head h:
//   o[s, h, :] = sum_j p[j] v[s, j, h, :] / sum_j p[j],
//   p[j] = exp(c[j] - max_j c[j]),
//   c[j] = (q[s, h, :] . k[s, j, h, :]) * scale, or -1e30 where key j of
//          slot s is not valid,
// with the softmax in f32 whatever the operand type, and o in q's type.
// Key j of slot s lives in row j % P of page table[s, j / P] of the pool
// (page ids clamped into the pool, the reference's gather `mode="clip"`);
// the dense view (S, T, H, D) is the same thing with one page of T rows
// per slot and no table.
//
// Replaces the TPU's Pallas kernel of analytics_zoo_tpu/ops/
// flash_attention.py: `flash_decode_attention` (`_fwd_kernel_masked` on
// grid (S, H, 1, T/bk) over the dense page-table gather, the one query
// row copied into an (8, D) tile because a TPU sublane holds 8 rows, int8
// views dequantized before the call). Here one query row is one row.
//
// Semantics kept from the reference: masked logits are -1e30, never -inf,
// so a slot with no valid key averages all T keys uniformly, as the dense
// path does (it reads every row through the clamped page ids). Int8 values
// are formed as the reference's dequantization forms them, float(int8) *
// scale rounded to q's type; a float pool of another type than q is
// converted on load (rounded to q's type), as `.to(q.dtype)` does.
//
// What bounds it on the H100: bytes. A slot reads its valid keys' K and V
// rows once (2 * len * H * D * size bytes) for 4 * len * H * D operations:
// half an operation per byte in f32, one in bf16, two in int8, far below
// the card's ~20 (f32 FMA) operations per byte. So the design has to keep
// enough loads in flight on every SM and read no byte it does not need:
// - split the context (flash-decoding): the grid is (chunk, head, slot),
//   each block runs the online softmax over one chunk of keys and writes
//   its unnormalised partial (acc, m, l) to a workspace. The wrapper plans
//   the chunk from the shapes alone (`decode_plan`), never from the
//   lengths, so that the host never waits on the card; a block whose chunk
//   lies past its slot's length writes an empty partial and leaves at once
//   (on the dense entry's mask it reads only the mask), so a launch reads
//   only the valid rows. The last block of a (slot, head) to arrive (an
//   atomic ticket, reset by that block for the next launch) merges the
//   partials in chunk order, never in arrival order: the same bits every
//   run;
// - read the pages in place through the page table: no dense gather of
//   the whole pool (a write and a read of its full capacity) before the
//   launch;
// - dequantize int8 in the kernel: the rows are read as int8 (a quarter of
//   f32's bytes) with their f32 scale per (row, head).
// Inside a block, 8 warps split into key groups of G lanes, G * 16 bytes
// covering one K (or V) row of the pool's type (G <= 32), so a group reads
// a row as one burst of 16-byte loads; each group keeps 2 keys in flight
// and runs its own online softmax, the groups of a warp merge by shuffles,
// the warps in shared memory in a fixed order. Four blocks share an SM (64
// registers a thread): on the H100 that beat two blocks with 4 keys per
// group in flight, and a second register stage of keys loaded under the
// maths of the first (which spilled), at the generation path's shapes
// (PERF.md).
// bf16 rows multiply in f32, p rounded to bf16 before p * v as the flash
// forward does.
//
// Layout: q (S, H, D) with slot stride q_ss (a column slice of the fused
// qkv projection is read in place); k, v (pages, rows, H, D) with page and
// row strides, heads at stride D, the last axis contiguous, rows 16-byte
// aligned (the wrapper checks); int8 scales (pages, rows, H) with page and
// row strides. Validity: lens (S,) int32 (key j valid iff j < lens[s]) or
// kmask (S, T) bool (valid iff true). o (S, H, D)
// contiguous; work_acc (S, H, chunks, D) and work_ml (S, H, chunks, 2)
// f32; tickets (S, H) int32, zero before the launch and after it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 2;   // keys per group in flight
constexpr int kMinBlocks = 4;   // per SM: at most 64 registers a thread
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* ks;      // int8 scales, else null
  const float* vs;
  const int* table;     // (S, pps) page ids, or null: page s, rows T
  const int* lens;      // (S,), or null: kmask
  const uint8_t* kmask;   // (S, T) bool, or null: lens
  void* o;
  float* work_acc;
  float* work_ml;
  int* tickets;
  int H, T, page, n_pages, pps, chunk, n_chunks;
  long long q_ss, k_ps, k_rs, v_ps, v_rs, ks_ps, ks_rs, vs_ps, vs_rs;
  float scale;
};

// A 16-byte load of the pool: N elements of type T, element i as f32.
template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static constexpr int N = 4;
  __device__ static float get(const uint4& r, int i) {
    return __uint_as_float((&r.x)[i]);
  }
};

template <>
struct Elem<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static float get(const uint4& r, int i) {
    const unsigned w = (&r.x)[i >> 1];
    return __uint_as_float((i & 1) ? (w & 0xffff0000u) : (w << 16));
  }
};

template <>
struct Elem<int8_t> {
  static constexpr int N = 16;
  __device__ static float get(const uint4& r, int i) {
    const unsigned w = (&r.x)[i >> 2];
    return static_cast<float>(static_cast<int8_t>(w >> (8 * (i & 3))));
  }
};

// q's type: how a value rounds to it, how one element loads and stores
template <typename T>
struct Qt;

template <>
struct Qt<float> {
  __device__ static float round(float x) { return x; }
  __device__ static float load(const float* p) { return *p; }
  __device__ static void store(float* p, float x) { *p = x; }
};

template <>
struct Qt<__nv_bfloat16> {
  __device__ static float round(float x) {
    return __bfloat162float(__float2bfloat16(x));
  }
  __device__ static float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  __device__ static void store(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16(x);
  }
};

template <typename A, typename B>
struct Same {
  static constexpr bool value = false;
};
template <typename A>
struct Same<A, A> {
  static constexpr bool value = true;
};

// element i of a loaded row as the attention reads it: dequantized
// (float(int8) * scale) or converted, then rounded to q's type
template <typename Tq, typename Tkv>
__device__ __forceinline__ float kv_value(const uint4& r, int i, float sc) {
  float x = Elem<Tkv>::get(r, i);
  if (Same<Tkv, int8_t>::value) x *= sc;
  if (!Same<Tkv, Tq>::value) x = Qt<Tq>::round(x);
  return x;
}

// lanes per key and keys per iteration of a block (`decode_lanes` and
// `decode_plan` in ops/flash_attention.py mirror them)
template <typename Tkv, int D>
struct Geo {
  static constexpr int VEC = Elem<Tkv>::N;
  static constexpr int G = (D / VEC < 32) ? D / VEC : 32;
  static constexpr int NV = D / (G * VEC);
  static constexpr int KPW = 32 / G;
  static constexpr int NG = kWarps * KPW;
  static constexpr int KI = NG * kUnroll;
};

template <typename Tq, typename Tkv, int D>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
flash_decode_kernel(const Params p) {
  using Gm = Geo<Tkv, D>;
  constexpr int VEC = Gm::VEC;
  constexpr int G = Gm::G;
  constexpr int NV = Gm::NV;
  constexpr int PER = NV * VEC;   // elements per lane
  constexpr int NG = Gm::NG;
  constexpr int KI = Gm::KI;
  constexpr bool kInt8 = Same<Tkv, int8_t>::value;
  static_assert(G * NV * VEC == D, "a key's lanes must cover D");
  __shared__ float s_acc[kWarps][D];
  __shared__ float s_m[kWarps];
  __shared__ float s_l[kWarps];
  __shared__ int s_last;

  const int c = blockIdx.x;
  const int h = blockIdx.y;
  const int s = blockIdx.z;
  const int pair = s * p.H + h;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int sub = lane % G;
  const int grp = warp * Gm::KPW + lane / G;
  const int c0 = c * p.chunk;
  const int c1 = min(c0 + p.chunk, p.T);
  const long long mrow0 = static_cast<long long>(s) * p.T;
  // is key j of the mask route valid?
  auto valid = [&](int j) { return p.kmask[mrow0 + j] != 0; };

  // does the slot have a valid key anywhere? (else every key counts,
  // uniformly, in every chunk)
  int len = p.T;
  bool any_valid;
  if (p.lens) {
    len = min(max(p.lens[s], 0), p.T);
    any_valid = len > 0;
  } else {
    int found = 0;
    for (int base = 0; base < p.T && !found; base += kThreads) {
      const int j = base + threadIdx.x;
      found = __syncthreads_or(j < p.T && valid(j));
    }
    any_valid = found != 0;
  }
  const int hi = any_valid ? min(c1, len) : c1;   // keys [c0, hi) to read
  float* ml = p.work_ml + (static_cast<long long>(pair) * p.n_chunks + c) * 2;
  float* wacc =
      p.work_acc + (static_cast<long long>(pair) * p.n_chunks + c) * D;

  if (c0 < hi) {
    // this lane's elements: load n covers [(n * G + sub) * VEC, + VEC)
    float qf[PER];
    const Tq* qrow = static_cast<const Tq*>(p.q) + s * p.q_ss +
                     static_cast<long long>(h) * D;
#pragma unroll
    for (int n = 0; n < NV; ++n)
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        qf[n * VEC + i] = Qt<Tq>::load(qrow + (n * G + sub) * VEC + i);
    const int* trow =
        p.table ? p.table + static_cast<long long>(s) * p.pps : nullptr;
    const Tkv* kbase = static_cast<const Tkv*>(p.k) +
                       static_cast<long long>(h) * D;
    const Tkv* vbase = static_cast<const Tkv*>(p.v) +
                       static_cast<long long>(h) * D;

    float acc[PER];
#pragma unroll
    for (int e = 0; e < PER; ++e) acc[e] = 0.f;
    float m = kNegInf;
    float l = 0.f;

    // one iteration's keys of this lane's group: K and V in flight
    struct Keys {
      uint4 k[kUnroll][NV];
      uint4 v[kUnroll][NV];
      float ks[kUnroll];
      float vs[kUnroll];
      bool use[kUnroll];
      bool live[kUnroll];
    };
    auto fetch = [&](Keys& x, int base) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = base + u * NG + grp;
        x.live[u] = j < hi && (p.kmask ? valid(j) : j < len);
        x.use[u] = j < hi && (x.live[u] || !any_valid);
        x.ks[u] = x.vs[u] = 0.f;
        if (x.use[u]) {
          long long pg = s;
          int row = j;
          if (trow) {
            pg = min(max(trow[j / p.page], 0), p.n_pages - 1);
            row = j % p.page;
          }
          const Tkv* kp = kbase + pg * p.k_ps + row * p.k_rs;
          const Tkv* vp = vbase + pg * p.v_ps + row * p.v_rs;
#pragma unroll
          for (int n = 0; n < NV; ++n) {
            const int off = (n * G + sub) * VEC;
            x.k[u][n] = __ldg(reinterpret_cast<const uint4*>(kp + off));
            x.v[u][n] = __ldg(reinterpret_cast<const uint4*>(vp + off));
          }
          if (kInt8) {
            x.ks[u] = __ldg(p.ks + pg * p.ks_ps + row * p.ks_rs + h);
            x.vs[u] = __ldg(p.vs + pg * p.vs_ps + row * p.vs_rs + h);
          }
        } else {
#pragma unroll
          for (int n = 0; n < NV; ++n)
            x.k[u][n] = x.v[u][n] = make_uint4(0, 0, 0, 0);
        }
      }
    };
    // the online softmax over one iteration's keys
    auto consume = [&](const Keys& x) {
      float cl[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float d = 0.f;
#pragma unroll
        for (int n = 0; n < NV; ++n)
#pragma unroll
          for (int i = 0; i < VEC; ++i)
            d = fmaf(qf[n * VEC + i], kv_value<Tq, Tkv>(x.k[u][n], i, x.ks[u]),
                     d);
        // every lane shuffles: the group's G lanes hold the same key
#pragma unroll
        for (int w = G / 2; w > 0; w >>= 1) d += __shfl_xor_sync(kFull, d, w);
        cl[u] = x.live[u] ? d * p.scale : kNegInf;
      }
      float mx = m;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (x.use[u]) mx = fmaxf(mx, cl[u]);
      const float alpha = __expf(m - mx);
      l *= alpha;
#pragma unroll
      for (int e = 0; e < PER; ++e) acc[e] *= alpha;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (!x.use[u]) continue;
        const float pe = __expf(cl[u] - mx);
        l += pe;
        const float pr = Qt<Tq>::round(pe);
#pragma unroll
        for (int n = 0; n < NV; ++n)
#pragma unroll
          for (int i = 0; i < VEC; ++i)
            acc[n * VEC + i] = fmaf(
                pr, kv_value<Tq, Tkv>(x.v[u][n], i, x.vs[u]), acc[n * VEC + i]);
      }
      m = mx;
    };
    for (int base = c0; base < hi; base += KI) {
      Keys a;
      fetch(a, base);
      consume(a);
    }

    // the groups of a warp merge by shuffles (lanes of one sub position)
#pragma unroll
    for (int off = G; off < 32; off <<= 1) {
      const float mo = __shfl_xor_sync(kFull, m, off);
      const float lo = __shfl_xor_sync(kFull, l, off);
      const float mn = fmaxf(m, mo);
      const float a = __expf(m - mn);
      const float b = __expf(mo - mn);
      l = l * a + lo * b;
#pragma unroll
      for (int e = 0; e < PER; ++e) {
        const float ao = __shfl_xor_sync(kFull, acc[e], off);
        acc[e] = acc[e] * a + ao * b;
      }
      m = mn;
    }
    if (lane < G) {
#pragma unroll
      for (int n = 0; n < NV; ++n)
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          s_acc[warp][(n * G + sub) * VEC + i] = acc[n * VEC + i];
      if (lane == 0) {
        s_m[warp] = m;
        s_l[warp] = l;
      }
    }
    __syncthreads();
    // the warps merge in warp order: the chunk's partial
    float mb = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mb = fmaxf(mb, s_m[w]);
    for (int e = threadIdx.x; e < D; e += kThreads) {
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        sum += s_acc[w][e] * __expf(s_m[w] - mb);
      wacc[e] = sum;
    }
    if (threadIdx.x == 0) {
      float lb = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) lb += s_l[w] * __expf(s_m[w] - mb);
      ml[0] = mb;
      ml[1] = lb;
    }
  } else if (threadIdx.x == 0) {
    ml[0] = kNegInf;   // no valid key in this chunk: an empty partial
    ml[1] = 0.f;
  }

  // the last block of this (slot, head) to arrive merges the partials
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const int ticket = atomicAdd(p.tickets + pair, 1);
    s_last = ticket == p.n_chunks - 1;
    if (s_last) p.tickets[pair] = 0;   // ready for the next launch
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const float* pml = p.work_ml + static_cast<long long>(pair) * p.n_chunks * 2;
  const float* pacc =
      p.work_acc + static_cast<long long>(pair) * p.n_chunks * D;
  float mg = kNegInf;
  for (int k = 0; k < p.n_chunks; ++k)
    if (__ldcg(pml + 2 * k + 1) > 0.f) mg = fmaxf(mg, __ldcg(pml + 2 * k));
  Tq* orow = static_cast<Tq*>(p.o) + static_cast<long long>(pair) * D;
  for (int e = threadIdx.x; e < D; e += kThreads) {
    float lg = 0.f;
    float sum = 0.f;
    for (int k = 0; k < p.n_chunks; ++k) {   // chunk order
      const float lk = __ldcg(pml + 2 * k + 1);
      if (lk > 0.f) {
        const float w = __expf(__ldcg(pml + 2 * k) - mg);
        lg += lk * w;
        sum += __ldcg(pacc + static_cast<long long>(k) * D + e) * w;
      }
    }
    Qt<Tq>::store(orow + e, sum / fmaxf(lg, 1e-30f));
  }
}

template <typename Tq, typename Tkv>
cudaError_t launch_kv(const Params& p, int S, int D, cudaStream_t stream) {
  const dim3 grid(p.n_chunks, p.H, S);
  switch (D) {
    case 32:
      flash_decode_kernel<Tq, Tkv, 32><<<grid, kThreads, 0, stream>>>(p);
      break;
    case 64:
      flash_decode_kernel<Tq, Tkv, 64><<<grid, kThreads, 0, stream>>>(p);
      break;
    case 128:
      flash_decode_kernel<Tq, Tkv, 128><<<grid, kThreads, 0, stream>>>(p);
      break;
    case 256:
      flash_decode_kernel<Tq, Tkv, 256><<<grid, kThreads, 0, stream>>>(p);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename Tq>
cudaError_t launch_q(const Params& p, int S, int D, int kv,
                     cudaStream_t stream) {
  switch (kv) {
    case 0:
      return launch_kv<Tq, float>(p, S, D, stream);
    case 1:
      return launch_kv<Tq, __nv_bfloat16>(p, S, D, stream);
    case 2:
      return launch_kv<Tq, int8_t>(p, S, D, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename Tkv>
int geo_of(int D, int* out) {
  switch (D) {
#define ZOO_GEO(DD)                  \
  case DD:                           \
    out[0] = Geo<Tkv, DD>::G;        \
    out[1] = Geo<Tkv, DD>::KI;       \
    return 0;
    ZOO_GEO(32)
    ZOO_GEO(64)
    ZOO_GEO(128)
    ZOO_GEO(256)
#undef ZOO_GEO
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// kv: the pool's type, 0 f32, 1 bf16, 2 int8 (with scales); table null:
// page s of `page` (= T) rows per slot; lens or kmask null, not both.
extern "C" int flash_decode_launch(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* table, const void* lens, const void* kmask,
    void* o, void* work_acc, void* work_ml, void* tickets, int S, int H,
    int T, int D, int page, int n_pages, int pps, int chunk, int n_chunks,
    long long q_ss, long long k_ps, long long k_rs, long long v_ps,
    long long v_rs, long long ks_ps, long long ks_rs, long long vs_ps,
    long long vs_rs, float scale, int q_bf16, int kv, void* stream) {
  if (chunk <= 0 || n_chunks <= 0 || (long long)chunk * n_chunks < T ||
      (lens == nullptr) == (kmask == nullptr) || (kv == 2 && !(ks && vs)))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.ks = static_cast<const float*>(ks);
  p.vs = static_cast<const float*>(vs);
  p.table = static_cast<const int*>(table);
  p.lens = static_cast<const int*>(lens);
  p.kmask = static_cast<const uint8_t*>(kmask);
  p.o = o;
  p.work_acc = static_cast<float*>(work_acc);
  p.work_ml = static_cast<float*>(work_ml);
  p.tickets = static_cast<int*>(tickets);
  p.H = H;
  p.T = T;
  p.page = page;
  p.n_pages = n_pages;
  p.pps = pps;
  p.chunk = chunk;
  p.n_chunks = n_chunks;
  p.q_ss = q_ss;
  p.k_ps = k_ps;
  p.k_rs = k_rs;
  p.v_ps = v_ps;
  p.v_rs = v_rs;
  p.ks_ps = ks_ps;
  p.ks_rs = ks_rs;
  p.vs_ps = vs_ps;
  p.vs_rs = vs_rs;
  p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = q_bf16 ? launch_q<__nv_bfloat16>(p, S, D, kv, st)
                                 : launch_q<float>(p, S, D, kv, st);
  return static_cast<int>(err);
}

// (lanes per key, keys per block iteration) for head dim D and pool type
// kv, for the tests to hold `decode_lanes` and `decode_plan` to
extern "C" int flash_decode_config(int D, int kv, int* out) {
  switch (kv) {
    case 0:
      return geo_of<float>(D, out);
    case 1:
      return geo_of<__nv_bfloat16>(D, out);
    case 2:
      return geo_of<int8_t>(D, out);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
