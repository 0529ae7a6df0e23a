// Hopper (sm_90a) building blocks of the redesigned kernels
// (conv3x3_bn_sm90.cuh, matmul_bn_sm90.cuh, matmul_bn_dw_sm90.cuh,
// matmul_bn_dx_sm90.cuh, the tf32 product of matmul_bn_apply_sm90.cuh,
// and the flash-attention kernels of flash_fwd_sm90.cuh and
// flash_bwd_sm90.cuh):
// asynchronous copies into a ring of shared-memory stages, ldmatrix
// fragment loads, warpgroup MMA (wgmma) with A in registers and B in
// shared memory, MN-major or K-major, and the augmented cotangent g of
// the BN-statistics backward.
//
// The B operand layout. Every B tile is 64 reduction rows by BN (64,
// 128 or 256) columns of bf16, stored MN-major (columns contiguous) in
// the canonical 128-byte-swizzled form that wgmma reads: column block
// nb = n / 64 holds 64 rows of 128 bytes (8 KB), and the 16-byte chunk
// j of row r sits at chunk j ^ (r % 8) of its row. The tile base is
// 1024-byte aligned, so the swizzle is the hardware's address swizzle.
// Its descriptor: 8-row groups 1024 bytes apart (stride byte offset),
// 64-column blocks 8192 bytes apart (leading byte offset), and the
// transpose flag set because B is MN-major. A B operand whose reduction
// index is the contiguous one is K-major instead (kmajor_desc below).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace zoo {
namespace sm90 {

constexpr int kSliceRows = 64;               // reduction depth of a slice
constexpr int kColBlockBytes = kSliceRows * 128;  // one 64-column block

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; src_bytes 0 fills zeros
// (the source address is then not read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// orders this thread's generic-proxy shared writes (st.shared and
// completed cp.async) before later async-proxy reads (wgmma)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A transaction barrier in shared memory (mbarrier) that one arrival
// and the bytes of bulk tensor copies (TMA) complete, one phase per use.
__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
               : "memory");
}
// a barrier whose phase completes after `count` arrivals (and their
// transaction bytes)
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// the arrival, announcing the bytes the phase's copies will bring
__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}
// The box at (c0 inner, c1 outer) of a 2-D tensor map into shared
// memory at dst, completing on bar.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const void* map,
                                            int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// The box at (c0, c1, c2), innermost first, of a 3-D tensor map into
// shared memory at dst, completing on bar.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const void* map,
                                            int c0, int c1, int c2,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(bar)
      : "memory");
}
// `bytes` (a multiple of 16) contiguous bytes from src (16-byte aligned)
// into shared memory at dst by one bulk copy, completing on bar.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
// the arrival alone, for a phase that brings no bytes
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// The box at (c0 inner, c1 outer) of a 2-D tensor map from shared memory
// at src (a bulk tensor store; the part past the tensor's edge is not
// written), in this thread's bulk group; commit, then wait until the
// group's sources have been read (the shared memory may be written
// again, or the block exit; the writes complete with the kernel).
__device__ __forceinline__ void tma_store_2d(const void* map, uint32_t src,
                                             int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%1, "
      "%2}], [%3];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(c0), "r"(c1), "r"(src)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr,
                                              uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ float2 unpack_bf16x2(uint32_t v) {
  __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&v);
  return __bfloat1622float2(h);
}
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// Byte offset of chunk j (columns 8j .. 8j + 7) of reduction row r in a
// B tile (see the note at the top).
__device__ __forceinline__ uint32_t btile_offset(int r, int j) {
  return (j >> 3) * kColBlockBytes + r * 128 + (((j & 7) ^ (r & 7)) << 4);
}

// wgmma descriptor of the B tile's rows 16 kk .. 16 kk + 15 (kk = the
// k16 step) at shared address `tile`; a tile of other than 64 reduction
// rows has its 64-column blocks `col_block` bytes apart.
__device__ __forceinline__ uint64_t btile_desc(
    uint32_t tile, int kk, uint32_t col_block = kColBlockBytes) {
  const uint32_t start = tile + kk * 16 * 128;
  uint64_t d = static_cast<uint64_t>((start & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>(col_block >> 4) << 16;       // leading: MN
  d |= static_cast<uint64_t>(1024 >> 4) << 32;            // stride: 8 rows
  d |= 1ull << 62;                                        // 128B swizzle
  return d;
}

// The K-major form, for a B operand whose reduction index is the
// contiguous one (B3's W^T: W is (K, N) with n, the reduction, along
// rows). The tile is R rows of 64 reduction elements, 128 bytes each,
// chunk j of row r at chunk j ^ (r % 8) (the same swizzle as the A
// slices that ldmatrix reads), 1024-byte aligned. Its descriptor: 8-row
// groups 1024 bytes apart (stride byte offset), the leading byte offset
// unused (one k16 step never leaves a 128-byte row), the transpose flag
// clear (wgmma_tile<BN, 0>); step kk starts 32 bytes further along the
// rows, and the hardware applies the swizzle to the absolute address.
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int kk) {
  const uint32_t start = tile + kk * 32;
  uint64_t d = static_cast<uint64_t>((start & 0x3FFFF) >> 4);
  d |= 1ull << 16;                                        // leading: unused
  d |= static_cast<uint64_t>(1024 >> 4) << 32;            // stride: 8 rows
  d |= 1ull << 62;                                        // 128B swizzle
  return d;
}

// Byte offset of chunk j (elements 8j .. 8j + 7) of row r in a tile of
// 128-byte rows swizzled as above (the K-major B tile, the A slices).
__device__ __forceinline__ uint32_t row128_offset(int r, int j) {
  return r * 128 + ((j ^ (r & 7)) << 4);
}

// Four k16 A fragments of a 64-element slice stored as 128-byte swizzled
// rows at `base`; `row` is this lane's ldmatrix row (warp q of a
// warpgroup: its row 16 q + lane % 16). The rows whose tap is invalid
// are zeroed: v0 for rows g, v1 for rows g + 8.
__device__ __forceinline__ void load_fragments(uint32_t (&af)[4][4],
                                               uint32_t base, int row,
                                               int lane, bool v0, bool v1) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int chunk = kk * 2 + (lane >> 4);
    ldsm_x4(base + row * 128 + ((chunk ^ (row & 7)) << 4), af[kk]);
    af[kk][0] = v0 ? af[kk][0] : 0u;
    af[kk][1] = v1 ? af[kk][1] : 0u;
    af[kk][2] = v0 ? af[kk][2] : 0u;
    af[kk][3] = v1 ? af[kk][3] : 0u;
  }
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// scale_d 0 makes a product overwrite d instead of adding to it: the
// first product of a tile starts the sums, so no instruction other than
// wgmma defines the accumulators (ptxas serialises every wgmma of a
// function where one does while a wgmma may be pending).
//
// Accumulator layout of m64nNk16 (per thread of a warpgroup, warp q of
// its 4, lane = 4 g + t4): d[4i + e] sits at row 16 q + g + 8 (e / 2),
// column 8 i + 2 t4 + e % 2. A fragment (4 registers of 2 bf16): a[0]
// row 16 q + g, columns 2 t4, +1; a[1] row + 8; a[2] columns + 8;
// a[3] both; the m16n8k16 layout, one warp per 16 rows.
// D (64 x 64, f32) += A (64 x 16, bf16 registers) * B (16 x 64, bf16,
// MN-major in shared memory: desc_b)
template <int TB = 1>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t desc_b,
                                                int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d), "n"(TB));
}

// D (64 x 128, f32) += A (64 x 16, bf16 registers) * B (16 x 128, bf16,
// MN-major in shared memory: desc_b)
template <int TB = 1>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64],
                                                 const uint32_t (&a)[4],
                                                 uint64_t desc_b,
                                                 int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d), "n"(TB));
}

// D (64 x 256, f32) += A (64 x 16, bf16 registers) * B (16 x 256, bf16,
// MN-major in shared memory: desc_b)
template <int TB = 1>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128],
                                                 const uint32_t (&a)[4],
                                                 uint64_t desc_b,
                                                 int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, %134;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d), "n"(TB));
}

// The tf32 path (B5's three-pass product, matmul_bn_apply_sm90.cuh).
// cvt.rna rounds an f32 to tf32 (10 mantissa bits, the low 13 bits of
// the word cleared), so the tensor cores read it exactly.
__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}
// v = hi + lo to within 2^-22 |v|: hi = tf32(v), lo = tf32(v - hi).
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(v);
  lo = to_tf32(v - __uint_as_float(hi));
}

// D (64 x 64, f32) += A (64 x 8, tf32 registers) * B (8 x 64, tf32,
// K-major in shared memory: kmajor_desc over 128-byte rows of 32 tf32,
// a k8 step 32 bytes along them). tf32 takes no transpose flags. A
// fragment (4 registers, warp q of the warpgroup, lane = 4 g + t4):
// a[0] row 16 q + g, column t4; a[1] row + 8; a[2] column t4 + 4; a[3]
// both: the m16n8k8 tf32 layout. D as m64nNk16's.
__device__ __forceinline__ void wgmma_m64n64k8_tf32(float (&d)[32],
                                                    const uint32_t (&a)[4],
                                                    uint64_t desc_b,
                                                    int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

// D (64 x 32, f32) += A (64 x 8, tf32 registers) * B (8 x 32, tf32,
// K-major in shared memory), as wgmma_m64n64k8_tf32.
__device__ __forceinline__ void wgmma_m64n32k8_tf32(float (&d)[16],
                                                    const uint32_t (&a)[4],
                                                    uint64_t desc_b,
                                                    int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

// Stores four 8 x 8 bf16 matrices: register j holds this lane's pair
// (row g, columns 2 t4, 2 t4 + 1) of matrix j, and lane l gives the
// shared address of row l % 8 of matrix l / 8 (16 bytes).
__device__ __forceinline__ void stsm_x4(uint32_t addr, uint32_t r0,
                                        uint32_t r1, uint32_t r2,
                                        uint32_t r3) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n"
      ::"r"(addr), "r"(r0), "r"(r1), "r"(r2), "r"(r3)
      : "memory");
}

// Pins registers in place: the compiler may not move their reads or
// writes across this point. On the accumulators only once no wgmma is
// in flight (after wgmma_wait<0>): ptxas serialises every wgmma of a
// function that defines an accumulator while one is pending. On the A
// fragments just before wgmma_fence, so that their last writes are not
// sunk past it into the pipeline stage (which serialises them too).
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
    asm volatile("" : "+r"(a[i][0]), "+r"(a[i][1]), "+r"(a[i][2]),
                 "+r"(a[i][3])::"memory");
}

// TB = 1: B is MN-major (btile_desc); TB = 0: B is K-major
// (kmajor_desc).
template <int BN, int TB = 1>
__device__ __forceinline__ void wgmma_tile(float (&d)[BN / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t desc_b,
                                           int scale_d = 1) {
  static_assert(BN == 64 || BN == 128 || BN == 256,
                "B tiles are 64, 128 or 256 wide");
  if constexpr (BN == 64)
    wgmma_m64n64k16<TB>(d, a, desc_b, scale_d);
  else if constexpr (BN == 128)
    wgmma_m64n128k16<TB>(d, a, desc_b, scale_d);
  else
    wgmma_m64n256k16<TB>(d, a, desc_b, scale_d);
}

// The augmented cotangent of the BN-statistics backward for 8
// consecutive columns: g = (dy + dsum) + 2 (y - sh) dsq, the sums of y
// and (y - sh)^2 folded into y's cotangent, rounded to bf16 (the
// reference rounds g to the compute type before its products). The
// column constants stay in registers for a block's whole loop; dsq is
// kept doubled (2 (y - sh) dsq = (y - sh) (2 dsq) exactly), so g is one
// add, one subtract and one fused multiply-add.
struct GCols {
  float dsum[8], sh[8], dsq2[8];

  __device__ __forceinline__ void load(const float* dsum_, const float* sh_,
                                       const float* dsq_, int n) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      dsum[j] = dsum_[n + j];
      sh[j] = sh_[n + j];
      dsq2[j] = 2.f * dsq_[n + j];
    }
  }

  // raw dy and y chunks -> the g chunk (zeros where !valid)
  __device__ __forceinline__ uint4 g(uint4 dy, uint4 y, bool valid) const {
    const uint32_t* dv = reinterpret_cast<const uint32_t*>(&dy);
    const uint32_t* yv = reinterpret_cast<const uint32_t*>(&y);
    uint4 out;
    uint32_t* o = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const float2 d2 = unpack_bf16x2(dv[p]);
      const float2 y2 = unpack_bf16x2(yv[p]);
      const int j = 2 * p;
      const float g0 = fmaf(y2.x - sh[j], dsq2[j], d2.x + dsum[j]);
      const float g1 =
          fmaf(y2.y - sh[j + 1], dsq2[j + 1], d2.y + dsum[j + 1]);
      o[p] = valid ? pack_bf16x2(g0, g1) : 0u;
    }
    return out;
  }
};

}  // namespace sm90
}  // namespace zoo
