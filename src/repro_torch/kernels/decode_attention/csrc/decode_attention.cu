// Flash-decode attention for Hopper: one query token per batch row against
// a dense KV cache or the paged KV pool.
//
// Replaces the JAX package's Pallas TPU kernels
//   flash_decode_bf16       <- decode_attention/decode_attention.py:
//                              flash_decode (_decode_kernel)
//   paged_flash_decode_bf16 <- decode_attention/paged.py:
//                              paged_flash_decode (_paged_kernel, _kv_page_map)
// q [B, H, hd]; dense k/v [B, S, Hk, hd] with pos [B] (row b sees keys
// j <= pos[b], and j > pos[b] - window when window > 0); paged k/v
// [num_pages, page_size, Hk, hd] through the CSR page table (page_indptr
// [B+1], page_indices, last_page_len [B]; row b's last key sits at
// (n_pages_b - 1) * page_size + last_page_len_b - 1). out [B, H, hd]. All
// bf16 and contiguous; fp32 scores, softmax state and PV, one rounding.
//
// What bounds them on an H100: each K and V element is read once and meets
// `group` (= 4 for Mixtral) query heads, two flops each way: ~4 flop per
// byte, far below the ~295 where the tensor cores bind. The bound is bytes:
// K and V up to each row's position, over 3.35 TB/s (at B = 4, S = 32768,
// Hk = 8, hd = 128: 537 MB, 0.160 ms).
//
// What the design does about it (flash_tile.cuh has the pass itself):
//   * one block per (row, kv head) reads each K/V element once for all the
//     group's query heads (GQA: query head h belongs to kv head h / group);
//   * the TPU's sequential S grid axis is a loop over 64-key tiles inside
//     the block, 16-byte loads, all of a tile's loads in flight together;
//   * the loop stops at the row's position and starts at its window, so a
//     short row in a long cache reads only its own keys; S need not divide
//     by the tile (the ragged tail is masked);
//   * a paged block reads its page ids itself and walks only its own
//     n_pages pages: no gathered copy of the row's KV is made.
// Not yet done: at the decode shape one block per (row, kv head) fills 32
// of 132 SMs; splitting S across blocks with a combine pass is later work.
//
// Each entry launches on the given stream, allocates nothing and returns 0,
// a CUDA error code, or -1 for an unsupported head dimension.
#include "flash_tile.cuh"

extern "C" int flash_decode_bf16(const void* q, const void* k, const void* v,
                                 const int* pos, void* out, int B, int S,
                                 int H, int Hk, int hd, int window,
                                 float scale, void* stream) {
  flash_tile::Args a{};
  a.q = (const uint16_t*)q;
  a.k = (const uint16_t*)k;
  a.v = (const uint16_t*)v;
  a.out = (uint16_t*)out;
  a.pos = pos;
  a.C = 1;
  a.H = H;
  a.Hk = Hk;
  a.group = H / Hk;
  a.S = S;
  a.window = window;
  a.scale = scale;
  return flash_tile::launch<false>(a, B, hd, stream);
}

extern "C" int paged_flash_decode_bf16(const void* q, const void* k_pages,
                                       const void* v_pages,
                                       const int* page_indptr,
                                       const int* page_indices,
                                       const int* last_page_len, void* out,
                                       int B, int num_pages, int page_size,
                                       int H, int Hk, int hd, int window,
                                       float scale, void* stream) {
  flash_tile::Args a{};
  a.q = (const uint16_t*)q;
  a.k = (const uint16_t*)k_pages;
  a.v = (const uint16_t*)v_pages;
  a.out = (uint16_t*)out;
  a.pos = nullptr;                     // the query sits at the row's last key
  a.indptr = page_indptr;
  a.indices = page_indices;
  a.lastlen = last_page_len;
  a.C = 1;
  a.H = H;
  a.Hk = Hk;
  a.group = H / Hk;
  a.num_pages = num_pages;
  a.page_size = page_size;
  a.window = window;
  a.scale = scale;
  return flash_tile::launch<true>(a, B, hd, stream);
}
