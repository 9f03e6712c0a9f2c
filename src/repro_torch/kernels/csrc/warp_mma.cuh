// Warp-level building blocks shared by the kernels that multiply on the
// tensor cores with mma.sync (moe_gmm.cu's grouped matmuls, ssd_scan.cu's
// chunk products): 16-byte cp.async copies into shared memory, ldmatrix
// fragment loads, the bf16 m16n8k16 product with fp32 accumulators, and the
// split of an fp32 value into two bf16 (hi + lo) for products that need
// more than bf16's 8 bits of one operand.
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

}  // namespace wmma_sync
