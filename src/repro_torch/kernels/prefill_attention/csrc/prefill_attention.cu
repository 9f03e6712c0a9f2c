// Chunked-prefill attention for Hopper: a C-token prompt segment per batch
// row against the paged KV pool (the segment's own KV already written).
//
// Replaces the JAX package's Pallas TPU kernel
//   paged_flash_prefill_bf16 <- prefill_attention/paged.py:
//                               paged_flash_prefill (_prefill_kernel,
//                               _kv_page_map)
// q [B, C, H, hd]; k/v [num_pages, page_size, Hk, hd]; CSR page table
// page_indptr [B+1], page_indices, last_page_len [B] (may be <= 0: the
// engine passes full-width rows whose last key is write_max - 1); pos0 [B].
// Query row r = c * group + g of kv head h is query head h * group + g of
// token c and sees key j iff j <= pos0[b] + c, j <= last and j lies in the
// row's pages (and j > pos0[b] + c - window when window > 0). out
// [B, C, H, hd]. bf16 in and out; fp32 scores, softmax state and PV, one
// rounding to bf16.
//
// What bounds it on an H100: K and V are read once (at B = 1, 32768 keys,
// Hk = 8, hd = 128: 134 MB, 0.040 ms at 3.35 TB/s); the products are
// 4 * C * H * keys * hd flops (17.2 GFLOP at C = 32, H = 32: 0.017 ms on the
// bf16 tensor cores). This kernel does them on the fp32 CUDA cores
// (67 TFLOP/s: ~0.26 ms), so the operations bound it in practice.
//
// What the design does about it (flash_tile.cuh has the pass itself):
//   * the TPU keeps the whole [C * group, hd] online state of a (row, kv
//     head) in VMEM. Here C * group = 128 rows of fp32 accumulators x 128
//     dims would be 64 KB per block, so the rows are split into tiles of 16:
//     one block per (row, kv head, row tile), each with its own state in
//     registers and shared memory;
//   * the blocks of one (row, kv head) read the same pages, close together
//     in time, so the re-reads come mostly from L2;
//   * each block reads its page ids itself and stops at the last key its
//     rows can see: the engine's full-width rows are padded with pages past
//     the prompt, and those are never read.
// Not yet used: wgmma for the two products (later work).
//
// The entry launches on the given stream, allocates nothing and returns 0,
// a CUDA error code, or -1 for an unsupported head dimension.
#include "flash_tile.cuh"

extern "C" int paged_flash_prefill_bf16(const void* q, const void* k_pages,
                                        const void* v_pages,
                                        const int* page_indptr,
                                        const int* page_indices,
                                        const int* last_page_len,
                                        const int* pos0, void* out, int B,
                                        int C, int num_pages, int page_size,
                                        int H, int Hk, int hd, int window,
                                        float scale, void* stream) {
  flash_tile::Args a{};
  a.q = (const uint16_t*)q;
  a.k = (const uint16_t*)k_pages;
  a.v = (const uint16_t*)v_pages;
  a.out = (uint16_t*)out;
  a.pos = pos0;
  a.indptr = page_indptr;
  a.indices = page_indices;
  a.lastlen = last_page_len;
  a.C = C;
  a.H = H;
  a.Hk = Hk;
  a.group = H / Hk;
  a.num_pages = num_pages;
  a.page_size = page_size;
  a.window = window;
  a.scale = scale;
  return flash_tile::launch<true>(a, B, hd, stream);
}
