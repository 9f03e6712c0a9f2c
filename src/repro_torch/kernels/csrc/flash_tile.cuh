// One online-softmax attention pass for Hopper, shared by the decode and
// prefill attention kernels (decode_attention/csrc, prefill_attention/csrc).
//
// A block owns one (batch row b, kv head h, tile of ROWS query rows). The
// query rows of a kv head are its GQA group flattened with the segment's
// tokens: row r = c * group + g is query head h * group + g of segment token
// c, at absolute position qpos = pos0[b] + c (decode: C = 1, qpos = pos[b]).
// Query row r sees key j iff
//     j < kv_len  and  j <= qpos  and  j <= last  and
//     (window <= 0  or  j > qpos - window),
// the masks of the reference's Pallas kernels (decode_attention.py:30,
// paged.py:36, prefill_attention/paged.py:39). kv_len is S for a dense
// cache and n_pages * page_size for a paged row; last is the row's last
// valid key, (n_pages - 1) * page_size + last_page_len - 1 for a paged row
// (a signed int: last_page_len may be <= 0 on the engine's full-width rows)
// and unbounded for a dense cache.
//
// The TPU kernels walk the key axis as a sequential grid dimension with the
// softmax state in VMEM; here the walk is a loop inside the block, over
// tiles of KT keys, with the state in shared memory and registers:
//   1. the tile's K and V rows are loaded with 16-byte loads (a paged row
//      looks up each key's physical page itself: no scalar prefetch here),
//      all of a thread's loads issued before any is used;
//   2. scores: one thread per (key, row subset), q rows in shared memory as
//      fp32 already scaled by hd^-0.5 (the reference scales q before the
//      dot), K rows read as 16-byte vectors from a padded tile (no bank
//      conflicts); masked scores become NEG_INF = -1e30, finite, so a tile
//      whose entries are all masked yields alpha = exp(m_prev - m_new) = 0
//      once a real score arrives instead of inf - inf;
//   3. one warp per row updates (m, l) and turns scores into p;
//   4. PV: each thread owns one head dimension of a few rows; acc * alpha
//      + p @ V in fp32 registers.
// The output is acc / max(l, 1e-30), rounded to bf16 once.
//
// The loop visits only the tiles that hold a visible key for some row of the
// block: from the window's start to min(kv_len, max over rows of
// min(qpos, last) + 1). Tiles outside add exactly zero to a row that has a
// visible key. `last` only clips the loop from above; it never grows it past
// kv_len. A row that sees no key at all is outside the contract (its output
// is finite and unspecified).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash_tile {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kKT = 64;               // keys per tile
constexpr int kPad = 8;               // bf16 pad per K/V row in shared memory
constexpr float kNegInf = -1e30f;

struct Args {
  const uint16_t* q;                  // [B, C, H, HD]
  const uint16_t* k;                  // dense [B, S, Hk, HD] | pool [N, ps, Hk, HD]
  const uint16_t* v;
  uint16_t* out;                      // [B, C, H, HD]
  const int* pos;                     // [B]: query position of token 0, or null
  const int* indptr;                  // [B + 1] (paged)
  const int* indices;                 // [indptr[B]] physical page ids (paged)
  const int* lastlen;                 // [B] (paged)
  int C, H, Hk, group;
  int S;                              // dense: keys per row
  int num_pages, page_size;           // paged
  int window;
  float scale;
};

__device__ __forceinline__ void unpack8(const uint4& r, float* f) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

template <int HD, int ROWS, bool PAGED>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const Args a) {
  static_assert(HD % 8 == 0 && ROWS % kWarps == 0, "tile shape");
  static_assert(ROWS * kKT % kThreads == 0 && ROWS * HD % kThreads == 0,
                "thread mapping");
  constexpr int kPitch = HD + kPad;
  constexpr int kChunks = kKT * HD / 8;          // 16-byte loads per tile
  constexpr int kLoads = kChunks / kThreads;
  constexpr int kDotRows = ROWS * kKT / kThreads;
  constexpr int kPvRows = ROWS * HD / kThreads;
  static_assert(kChunks % kThreads == 0, "loads per thread");

  __shared__ __align__(16) uint16_t ks[kKT][kPitch];
  __shared__ __align__(16) uint16_t vs[kKT][kPitch];
  __shared__ __align__(16) float qs[ROWS][HD];
  __shared__ float ps[ROWS][kKT];
  __shared__ float m_s[ROWS], l_s[ROWS], alpha_s[ROWS];
  __shared__ int qpos_s[ROWS];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.z, h = blockIdx.y, row0 = blockIdx.x * ROWS;
  const int rows = min(ROWS, a.C * a.group - row0);

  // -- the row's keys: count, last valid key, page run --------------------
  int kv_len, last, page0 = 0;
  if (PAGED) {
    page0 = a.indptr[b];
    const int n_pages = a.indptr[b + 1] - page0;
    kv_len = n_pages * a.page_size;
    last = (n_pages - 1) * a.page_size + a.lastlen[b] - 1;
  } else {
    kv_len = a.S;
    last = 0x7fffffff;
  }
  const int base = a.pos != nullptr ? a.pos[b] : last;

  // -- q rows (scaled, fp32) and per-row state ----------------------------
  for (int i = tid; i < ROWS * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    float x = 0.f;
    if (r < rows) {
      const int rf = row0 + r, c = rf / a.group, g = rf % a.group;
      const size_t off = ((size_t)(b * a.C + c) * a.H + h * a.group + g) * HD;
      x = __uint_as_float((uint32_t)a.q[off + d] << 16) * a.scale;
    }
    qs[r][d] = x;
  }
  if (tid < ROWS) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
    qpos_s[tid] = base + (row0 + min(tid, rows - 1)) / a.group;
  }
  __syncthreads();

  // -- the key range any row of the block can see -------------------------
  const int qlo = base + row0 / a.group;
  const int qhi = base + (row0 + rows - 1) / a.group;
  const int j_end = max(0, min(kv_len, min(qhi, last) + 1));
  int j_begin = 0;
  if (a.window > 0) j_begin = max(0, qlo - a.window + 1);
  j_begin = min(j_begin, j_end) / kKT * kKT;

  float acc[kPvRows];
#pragma unroll
  for (int i = 0; i < kPvRows; ++i) acc[i] = 0.f;
  const int pv_d = tid % HD, pv_r0 = tid / HD;
  const int dot_j = tid % kKT, dot_r0 = tid / kKT;
  const size_t row_stride = (size_t)a.Hk * HD;    // elements between keys

  for (int j0 = j_begin; j0 < j_end; j0 += kKT) {
    // 1. K and V tiles: issue every load, then store
    uint4 kr[kLoads], vr[kLoads];
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int c = tid + i * kThreads, jj = c / (HD / 8), part = c % (HD / 8);
      const int j = j0 + jj;
      kr[i] = vr[i] = make_uint4(0u, 0u, 0u, 0u);
      if (j < j_end) {
        size_t key;
        bool ok = true;
        if (PAGED) {
          const int page = a.indices[page0 + j / a.page_size];
          ok = page >= 0 && page < a.num_pages;
          key = (size_t)page * a.page_size + j % a.page_size;
        } else {
          key = (size_t)b * a.S + j;
        }
        if (ok) {
          const size_t off = key * row_stride + (size_t)h * HD + part * 8;
          kr[i] = __ldg(reinterpret_cast<const uint4*>(a.k + off));
          vr[i] = __ldg(reinterpret_cast<const uint4*>(a.v + off));
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int c = tid + i * kThreads, jj = c / (HD / 8), part = c % (HD / 8);
      *reinterpret_cast<uint4*>(&ks[jj][part * 8]) = kr[i];
      *reinterpret_cast<uint4*>(&vs[jj][part * 8]) = vr[i];
    }
    __syncthreads();

    // 2. scores
    {
      float s[kDotRows];
#pragma unroll
      for (int i = 0; i < kDotRows; ++i) s[i] = 0.f;
#pragma unroll 4
      for (int d = 0; d < HD; d += 8) {
        float kf[8];
        unpack8(*reinterpret_cast<const uint4*>(&ks[dot_j][d]), kf);
#pragma unroll
        for (int i = 0; i < kDotRows; ++i) {
          const float* qr = &qs[dot_r0 + i * (kThreads / kKT)][d];
#pragma unroll
          for (int e = 0; e < 8; ++e) s[i] = fmaf(qr[e], kf[e], s[i]);
        }
      }
      const int j = j0 + dot_j;
#pragma unroll
      for (int i = 0; i < kDotRows; ++i) {
        const int r = dot_r0 + i * (kThreads / kKT);
        const int qp = qpos_s[r];
        bool ok = r < rows && j < kv_len && j <= qp && j <= last;
        if (a.window > 0) ok = ok && j > qp - a.window;
        ps[r][dot_j] = ok ? s[i] : kNegInf;
      }
    }
    __syncthreads();

    // 3. online softmax state, one warp per row
    for (int r = warp; r < ROWS; r += kWarps) {
      float x[kKT / 32];
      float mx = kNegInf;
#pragma unroll
      for (int i = 0; i < kKT / 32; ++i) {
        x[i] = ps[r][lane + 32 * i];
        mx = fmaxf(mx, x[i]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < kKT / 32; ++i) {
        const float p = expf(x[i] - m_new);
        ps[r][lane + 32 * i] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        alpha_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // 4. acc = acc * alpha + p @ V
#pragma unroll
    for (int i = 0; i < kPvRows; ++i)
      acc[i] *= alpha_s[pv_r0 + i * (kThreads / HD)];
#pragma unroll 8
    for (int jj = 0; jj < kKT; ++jj) {
      const float vf = __uint_as_float((uint32_t)vs[jj][pv_d] << 16);
#pragma unroll
      for (int i = 0; i < kPvRows; ++i)
        acc[i] = fmaf(ps[pv_r0 + i * (kThreads / HD)][jj], vf, acc[i]);
    }
    __syncthreads();                   // the next tile overwrites ks, vs, ps
  }

#pragma unroll
  for (int i = 0; i < kPvRows; ++i) {
    const int r = pv_r0 + i * (kThreads / HD);
    if (r >= rows) continue;
    const int rf = row0 + r, c = rf / a.group, g = rf % a.group;
    const float o = acc[i] / fmaxf(l_s[r], 1e-30f);
    const size_t off = ((size_t)(b * a.C + c) * a.H + h * a.group + g) * HD;
    a.out[off + pv_d] = __bfloat16_as_ushort(__float2bfloat16_rn(o));
  }
}

template <int HD, bool PAGED>
int launch_rows(const Args& a, int B, int rows_total, int rows_per_block,
                cudaStream_t stream) {
  const dim3 grid((rows_total + rows_per_block - 1) / rows_per_block, a.Hk, B);
  switch (rows_per_block) {
    case 4: flash_kernel<HD, 4, PAGED><<<grid, kThreads, 0, stream>>>(a); break;
    case 8: flash_kernel<HD, 8, PAGED><<<grid, kThreads, 0, stream>>>(a); break;
    case 16: flash_kernel<HD, 16, PAGED><<<grid, kThreads, 0, stream>>>(a); break;
    default: return -1;
  }
  return (int)cudaGetLastError();
}

// Launches the pass for B rows of C query tokens each. Rows per block: the
// smallest of 4, 8, 16 that holds a decode step's GQA group, 16 otherwise.
// Returns 0 when launched, a CUDA error code, or -1 for an unsupported head
// dimension (32, 64 and 128 are built).
template <bool PAGED>
int launch(const Args& a, int B, int HD, void* stream) {
  const int rows_total = a.C * a.group;
  const int rows = rows_total <= 4 ? 4 : rows_total <= 8 ? 8 : 16;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (HD) {
    case 32: return launch_rows<32, PAGED>(a, B, rows_total, rows, s);
    case 64: return launch_rows<64, PAGED>(a, B, rows_total, rows, s);
    case 128: return launch_rows<128, PAGED>(a, B, rows_total, rows, s);
    default: return -1;
  }
}

}  // namespace flash_tile
