// Split-S attention over a dense KV cache or the paged KV pool, the parts
// shared by the decode and prefill attention kernels (decode_attention.cu,
// prefill_attention.cu): the ring of K/V tiles in shared memory and the
// producer warp that fills it by TMA, the tile layout the consumers read,
// and the pass that combines the splits' partials.
//
// A block owns one split of one row's key axis and walks it in 64-key
// tiles. The producer warp keeps a ring of STAGES (K, V) tiles full: for
// each tile it waits until the consumers have released the stage, counts
// the tile's bytes on the stage's `full` mbarrier and asks for the tile as
// boxes of a 3-D tensor map [keys][Hk][HD] (one head, 64 dims, 128-byte
// swizzled; head dim 32: one dense box of 32 dims):
//   * dense cache [B, S, Hk, HD]: one box of 64 keys at key b * S + j;
//   * paged pool [N, ps, Hk, HD]: the map views the pool as [N * ps keys],
//     and a page's rows for one kv head are strided by Hk * HD exactly like
//     the dense cache's. A tile is cut into boxes of kb = gcd(ps, 64) keys,
//     so a box never crosses a page for any page size (ps 16: 4 boxes of 16
//     keys a 64-dim column; ps >= 64: one box). The warp reads the row's
//     page ids itself, 32 at a time, one a lane, and hands each box its id
//     by a shuffle: no scalar prefetch, no per-load lookup. Slots past the
//     page that holds the row's last visible key clamp to that page (the
//     reference's _kv_page_map clamps to the row's last page), so every tile
//     carries the same byte count and the consumers' key mask drops the
//     re-fetched keys; pages past the row's last key are never read.
// Boxes land one after another, so key j of a tile sits in row j of a
// 64-row column: with the 128-byte swizzle (a function of the shared-memory
// address, the tile 1024-byte aligned) chunk c of key j is at chunk
// c ^ (j % 8) whatever the box size.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma.cuh"

namespace split_kv {

constexpr int kKT = 64;               // keys per tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ void unpack8(const uint4& r, float* f) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Head dims in 64-wide swizzled boxes (64, 128) or one dense box (32).
template <int HD>
__host__ __device__ constexpr bool swizzle() { return HD % tma::kBoxCols == 0; }

// Columns of one box, and boxes a key row spans.
template <int HD>
__host__ __device__ constexpr int box_cols() {
  return swizzle<HD>() ? tma::kBoxCols : HD;
}

template <int HD>
__host__ __device__ constexpr int col_boxes() { return HD / box_cols<HD>(); }

// Element offset of 16-byte chunk c of key j in a K or V tile.
template <int HD>
__device__ __forceinline__ int kv_off(int j, int c) {
  if (swizzle<HD>())                   // column c / 8 of [kKT keys x 64 dims]
    return (c >> 3) * (kKT * tma::kBoxCols) + tma::swizzled(j, c & 7);
  return j * HD + c * 8;
}

// Where a row's keys live. Dense: key j at map row key0 + j. Paged: key j
// in slot j / ps of the row's page ids `pages`, clamped to `last_slot`.
struct KeySource {
  const int* pages;                   // the row's page ids, or null (dense)
  int key0;                           // dense: the row's first map row
  int ps, kb, last_slot;              // paged: page size, box keys, clamp
};

// The producer warp: n_tiles tiles from key j_begin into the ring. All 32
// lanes run it (the page ids are read one a lane); lane 0 waits, counts and
// issues the copies.
template <int HD, int STAGES>
__device__ __forceinline__ void produce(
    const KeySource& src, int lane, int h, int j_begin, int n_tiles,
    uint16_t* ks, uint16_t* vs, uint64_t* full, uint64_t* empty,
    const CUtensorMap* kmap, const CUtensorMap* vmap) {
  constexpr int kW = box_cols<HD>();
  int base = -(1 << 30), pid = 0;     // page ids of slots [base, base + 32)
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % STAGES;
    if (lane == 0) {
      if (t >= STAGES) tma::mbar_wait(&empty[st], (t / STAGES - 1) & 1);
      tma::mbar_expect_tx(&full[st], 2 * kKT * HD * 2);
    }
    const int j0 = j_begin + t * kKT;
    uint16_t* kt = ks + st * kKT * HD;
    uint16_t* vt = vs + st * kKT * HD;
    if (src.pages == nullptr) {
      if (lane == 0) {
#pragma unroll
        for (int bx = 0; bx < col_boxes<HD>(); ++bx) {
          const int off = bx * kKT * kW;
          tma::load_3d(kt + off, kmap, bx * kW, h, src.key0 + j0, &full[st]);
          tma::load_3d(vt + off, vmap, bx * kW, h, src.key0 + j0, &full[st]);
        }
      }
    } else {
      for (int i = 0; i < kKT; i += src.kb) {
        const int j = j0 + i;
        const int slot = min(j / src.ps, src.last_slot);
        if (slot < base || slot >= base + 32) {          // warp-uniform
          base = slot;
          pid = base + lane <= src.last_slot ? src.pages[base + lane] : 0;
        }
        const int page = __shfl_sync(0xffffffffu, pid, slot - base);
        if (lane == 0) {
          const int key = page * src.ps + j % src.ps;
#pragma unroll
          for (int bx = 0; bx < col_boxes<HD>(); ++bx) {
            const int off = bx * kKT * kW + i * kW;
            tma::load_3d(kt + off, kmap, bx * kW, h, key, &full[st]);
            tma::load_3d(vt + off, vmap, bx * kW, h, key, &full[st]);
          }
        }
      }
    }
    __syncwarp();
  }
}

// Keys a box of the paged producer: gcd(page_size, kKT), so a box never
// crosses a page and a tile is whole boxes.
inline int page_box_keys(int page_size) {
  int a = page_size, b = kKT;
  while (b != 0) {
    const int r = a % b;
    a = b;
    b = r;
  }
  return a;
}

// The K and V maps over `keys` rows of [Hk][hd] bf16, boxes of box_keys
// keys x 1 head x box_cols dims, 128-byte swizzled (box_cols 64; a box
// wider than hd zero-fills the columns past it) or dense (box_cols = hd).
// Returns 0 or a CUDA error code.
inline int encode_kv_maps(const void* k, const void* v, int hd, int Hk,
                          long long keys, int box_cols, int box_keys,
                          bool swizzled, CUtensorMap* kmap,
                          CUtensorMap* vmap) {
  const cuuint64_t dims[3] = {(cuuint64_t)hd, (cuuint64_t)Hk,
                              (cuuint64_t)keys};
  const cuuint64_t strides[2] = {(cuuint64_t)hd * 2, (cuuint64_t)Hk * hd * 2};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, 1, (cuuint32_t)box_keys};
  const int err = tma::encode_bf16(kmap, k, 3, dims, strides, box, swizzled);
  return err != 0 ? err
                  : tma::encode_bf16(vmap, v, 3, dims, strides, box,
                                     swizzled);
}

// Merges the splits' partials of one output row (a query head of a token),
// in split order: out = sum_s e^(m_s - m) acc_s / sum_s e^(m_s - m) l_s,
// m = max_s m_s. Grid (rows a batch row, B); ws_acc [B * rows, splits, HD],
// ws_ml [B * rows, splits, 2].
template <int HD>
__global__ void __launch_bounds__(HD)
combine_kernel(const float* __restrict__ ws_acc,
               const float* __restrict__ ws_ml, uint16_t* __restrict__ out,
               int rows, int splits) {
  const size_t row = (size_t)blockIdx.y * rows + blockIdx.x;
  const int d = threadIdx.x;
  const float* ml = ws_ml + row * splits * 2;
  const float* acc = ws_acc + row * splits * HD + d;
  float m = kNegInf;
  for (int s = 0; s < splits; ++s) m = fmaxf(m, ml[2 * s]);
  float l = 0.f, o = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float w = expf(ml[2 * s] - m);
    l += w * ml[2 * s + 1];
    o += w * acc[(size_t)s * HD];
  }
  out[row * HD + d] = __bfloat16_as_ushort(__float2bfloat16_rn(
      o / fmaxf(l, 1e-30f)));
}

}  // namespace split_kv
