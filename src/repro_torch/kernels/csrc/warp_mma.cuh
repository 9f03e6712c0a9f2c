// Building blocks shared by the kernels that multiply on the tensor cores
// (moe_gmm.cu's grouped matmuls, ssd_scan.cu's chunk products,
// prefill_attention.cu's attention tiles): 16-byte cp.async copies into
// shared memory, ldmatrix fragment loads, the bf16 m16n8k16 product with
// fp32 accumulators, the split of an fp32 value into two bf16 (hi + lo) for
// products that need more than bf16's 8 bits of one operand, and a
// warpgroup's asynchronous m64n64k16 product (wgmma).
//
// Fragment layout of mma.sync.m16n8k16 (lane = 4 * gid + tig): A (16 x 16,
// row-major) a0 = (gid, 2tig..2tig+1), a1 = (gid+8, ..), a2 = (gid,
// 2tig+8..), a3 = (gid+8, 2tig+8..); B (16 x 8) b0 = (k 2tig..2tig+1, n
// gid), b1 = (k 2tig+8.., n gid); C (16 x 8) c0,c1 = (gid, 2tig..2tig+1),
// c2,c3 = (gid+8, ..).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace wmma_sync {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from device to shared memory, zero-filled past src_bytes (0
// skips the read: the ragged edge of a tile).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Four 8x8 bf16 matrices; lane l gives the address of row l % 8 of
// matrix l / 8, and receives its share of each.
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const uint16_t* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)) : "memory");
}

// The same, each matrix delivered transposed.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const uint16_t* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)) : "memory");
}

// c += a b: m16n8k16, bf16 in, fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}

__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// lo in the low 16 bits, hi in the high: one cvt.rn.bf16x2.f32.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// v0, v1 as bf16 pairs hi = bf16(v) and lo = bf16(v - hi): hi + lo is v
// within 2^-17 of |v| (the lo term's own rounding), so a product of hi and
// lo against an exact bf16 operand, summed in fp32, is an fp32 product.
__device__ __forceinline__ void split_bf16(float v0, float v1, uint32_t& hi,
                                           uint32_t& lo) {
  hi = pack_bf16(v0, v1);
  lo = pack_bf16(v0 - bf16_lo(hi), v1 - bf16_hi(hi));
}

// -- wgmma: a warpgroup's m64n64k16 product into fp32 accumulators in
// mma.sync's C layout (warp i of the group holds rows 16 i .. 16 i + 15,
// one [4] per n8 tile). wgmma_rs: A (64 x 16) from registers in mma.sync's
// A layout, B (16 x 64) read by the tensor cores from shared memory, a
// [k][64] bf16 tile stored N-major ("transposed"). wgmma_ss: A (64 x 16)
// and B (16 x 64) both from shared memory, K-major: [64 rows][k] tiles, a
// k-step 32 bytes on along the row. Every tile has rows of 128 bytes in the
// 128-byte swizzle (16-byte piece v of row r at piece v ^ (r % 8)), 8-row
// groups 1024 bytes apart: what a TMA box of 64 bf16 columns writes.
// ---------------------------------------------------------------------

__device__ __forceinline__ uint64_t desc_n128(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((1024ull >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Orders the compiler's accesses to the accumulators against the async
// products (they are not to be read or written while a group is in flight).
__device__ __forceinline__ void wg_hold(float (&d)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e]) :: "memory");
}

// The same for A fragments: computed before the fence that precedes their
// product.
__device__ __forceinline__ void wg_hold(uint32_t (&a)[4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(a[r]) :: "memory");
}

// Makes this thread's writes to shared memory (stores or cp.async) visible
// to the tensor cores' (async-proxy) reads.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_rs(float (&d)[8][4],
                                         const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(1));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[8][4], uint64_t a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(a), "l"(b), "n"(1));
}

}  // namespace wmma_sync
