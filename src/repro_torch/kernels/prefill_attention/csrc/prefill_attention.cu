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
// token c and sees key j iff j <= pos0[b] + c, j <= last (the row's last
// key, (n_pages - 1) * page_size + last_page_len - 1) and, when window > 0,
// j > pos0[b] + c - window. out [B, C, H, hd], bf16.
//
// What bounds it on an H100: K and V are read once (at B = 1, 32768 keys,
// Hk = 8, hd = 128: 134 MB, 0.040 ms at 3.35 TB/s); the products are
// 4 * C * H * keys * hd flops (17.2 GFLOP at C = 32, H = 32: 0.017 ms at
// the bf16 tensor-core peak). Bytes bound it; the products have to run on
// the tensor cores to stay near that (on the fp32 CUDA cores alone they
// take ~0.26 ms).
//
// prefill_split_kernel<HD>: the segment's query rows of a (row, kv head)
// as real matrix products on wgmma, split over keys.
//   * one block per (row, kv head, tile of 128 query rows, split of the key
//     axis): a Mixtral segment (C = 32 x group 4) is one row tile, so K and
//     V are read once per (row, kv head, split); fewer rows are padded and
//     masked, more take more row tiles. Splits (ops.py: prefill_splits,
//     from max_pages * page_size): as many as put one block on every SM (at
//     the long shape 16 splits of 2048 keys: 128 blocks);
//   * the producer warp is decode's paged TMA producer (split_kv.cuh): a
//     4-stage ring of 64-key K/V tiles, boxes of gcd(page_size, 64) keys
//     through the row's page ids, tiles past the row's last visible key
//     clamped to its page;
//   * 2 consumer warpgroups own 64 query rows each. The q tile sits in
//     shared memory in the 128-byte swizzle, written once. Per K/V tile:
//     S = Q K^T as wgmma m64n64k16 with both operands read by the tensor
//     cores from shared memory (K straight from the TMA tile, no copy to
//     registers), fp32 sums; the hd^-0.5 scale on the fp32 scores; the
//     causal, last-key and window masks only on tiles that need them (one
//     or two on the segment's diagonal); the online softmax (m, l) in
//     registers, in base-2 exponents (exp2f, the scale and log2(e) folded
//     into one multiply), a row's state across the 4 lanes
//     that hold it; P rounded
//     to bf16 in registers as the A operand of O += P V (wgmma, V N-major
//     from the tile), fp32 accumulators. Tiles a warpgroup's rows cannot see
//     are skipped. A head dim of 32 runs as 64 with zero columns;
//   * rounding points: the reference scales q in fp32 before its fp32
//     products and keeps P in fp32. Here the products of the bf16 inputs
//     are exact and summed in fp32, then scaled; P is rounded to bf16
//     (2^-9 relative) before PV, l sums the fp32 P. The plain mirror
//     paged_flash_prefill_split_plain (ops.py) carries both and the split
//     and combine order, and meets the reference's one-rounding tolerance
//     on the CPU (tests/test_torch_paged_split_kernels.py);
//   * with one split (the served segment: 8 pages) the block normalises
//     and writes bf16; with more, fp32 partials (m, l, unnormalised acc)
//     per (token, head, split) go to a workspace and split_kv::
//     combine_kernel merges them in split order (no atomics: bitwise equal
//     from run to run).
// An mma.sync version of this tile (8 warps of 16 rows, q in registers, K
// and V by ldmatrix) took 0.124 ms device at the long shape (PERF.md,
// section 6): every warp read the whole K and V tile, and it spilled at the
// 168 registers nine warps leave a thread.
//
// The entry launches on the given stream, allocates nothing and returns 0,
// a CUDA error code, -1 for an unsupported head dimension, -2 for a split
// that does not cover max_pages * page_size keys, or -3 for a page size
// below 1.
#include "split_kv.cuh"
#include "tma.cuh"
#include "warp_mma.cuh"

namespace split_prefill {

using split_kv::kKT;
using split_kv::kNegInf;
using namespace wmma_sync;

constexpr int kWarps = 8;                     // consumer warps: 2 warpgroups
constexpr int kRows = 16 * kWarps;            // query rows a block
constexpr int kThreads = 32 * (kWarps + 1);   // + one producer warp
constexpr int kStages = 4;                    // K/V tiles in the ring

struct Args {
  const uint16_t* q;                  // [B, C, H, HD]
  const uint16_t* k;                  // [N, ps, Hk, HD]
  const uint16_t* v;
  const int* indptr;                  // [B + 1]
  const int* indices;                 // [indptr[B]] page ids
  const int* lastlen;                 // [B]
  const int* pos0;                    // [B]
  uint16_t* out;                      // [B, C, H, HD]
  float* ws_acc;                      // [B, C, H, splits, HD], or null
  float* ws_ml;                       // [B, C, H, splits, 2] (m, l), or null
  int C, H, Hk, group, ps, kb, window, splits, split_len;
  float scale;
};

// Head dims in the tiles: whole 64-column swizzled boxes (32 is padded to
// 64: the TMA box zero-fills the columns past the head, q's are zeroed).
template <int HD>
__host__ __device__ constexpr int padded() { return HD < 64 ? 64 : HD; }

template <int HD>
constexpr int smem_bytes() {
  return 1024                                       // alignment of the boxes
         + kRows * padded<HD>() * 2                 // q tile
         + 2 * kStages * kKT * padded<HD>() * 2     // K, V tiles
         + 2 * kStages * 8;                         // full, empty mbarriers
}

// One block per (tile of 128 query rows, split of the key axis, kv head,
// batch row). Warpgroup w (warps 4 w .. 4 w + 3) owns query rows
// [64 w, 64 w + 64) of the tile; the last warp fills the ring.
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
prefill_split_kernel(const Args a, const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap) {
  constexpr int HP = padded<HD>();
  constexpr int kBX = HP / 64;                   // 64-column boxes a row
  constexpr int kKS = HP / 16;                   // k-steps of Q K^T

  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (tma::smem_u32(smem_raw) & 1023)) & 1023);
  uint16_t* qs = reinterpret_cast<uint16_t*>(smem);      // [kBX][kRows][64]
  uint16_t* ks = qs + kRows * HP;                        // [kStages][kKT*HP]
  uint16_t* vs = ks + kStages * kKT * HP;
  uint64_t* full = reinterpret_cast<uint64_t*>(vs + kStages * kKT * HP);
  uint64_t* empty = full + kStages;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = blockIdx.y, b = blockIdx.z;
  const int sp = blockIdx.x % a.splits, row0 = blockIdx.x / a.splits * kRows;
  const int R = a.C * a.group;                   // query rows of (b, h)
  const int rows = min(kRows, R - row0);

  // -- the row's keys, and the range any query row of the block sees -----
  const int p0 = a.indptr[b], n_pages = a.indptr[b + 1] - p0;
  const int last = min((n_pages - 1) * a.ps + a.lastlen[b] - 1,
                       n_pages * a.ps - 1);
  const int pos0 = a.pos0[b];
  const int qlo = pos0 + row0 / a.group;
  const int vis = min(pos0 + (row0 + rows - 1) / a.group, last);
  const int lo = a.window > 0 ? max(0, qlo - a.window + 1) : 0;
  const int s0 = sp * a.split_len;
  const int j_end = min(s0 + a.split_len, vis + 1);
  const int first = max(s0, lo);
  const int j_begin = s0 + (first - s0) / kKT * kKT;
  const int n_tiles = first < j_end ? (j_end - j_begin + kKT - 1) / kKT : 0;

  // -- the q tile, swizzled as wgmma reads it (rows past R repeat row R - 1
  // and are not written) ---------------------------------------------------
  for (int i = tid; i < kRows * HP / 8; i += kThreads) {
    const int r = i / (HP / 8), c = i % (HP / 8);
    const int rr = min(row0 + r, R - 1), t = rr / a.group, g = rr % a.group;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (c * 8 < HD)
      x = *reinterpret_cast<const uint4*>(
          a.q + (((size_t)b * a.C + t) * a.H + h * a.group + g) * HD + c * 8);
    *reinterpret_cast<uint4*>(qs + (c >> 3) * kRows * 64 +
                              tma::swizzled(r, c & 7)) = x;
  }
  fence_async_smem();
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      tma::mbar_init(&full[i], 1);
      tma::mbar_init(&empty[i], kWarps);
    }
    tma::mbar_init_fence();
  }
  __syncthreads();

  if (warp == kWarps) {
    const split_kv::KeySource src{a.indices + p0, 0, a.ps, a.kb,
                                  min(max(vis, 0) / a.ps, n_pages - 1)};
    split_kv::produce<HP, kStages>(src, lane, h, j_begin, n_tiles, ks, vs,
                                   full, empty, &kmap, &vmap);
    return;
  }

  // -- consumers: a lane holds rows gid and gid + 8 of its warp's 16 ------
  const int gid = lane >> 2, tig = lane & 3, wg = warp >> 2;
  const int wr0 = row0 + warp * 16;              // the warp's first row
  const int gr0 = row0 + wg * 64;                // the warpgroup's
  const bool active = gr0 < R;                   // uniform in the group
  int qp[2], vk[2];                    // each row's position, last key seen
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    qp[i] = pos0 + min(wr0 + gid + 8 * i, R - 1) / a.group;
    vk[i] = min(qp[i], last);
  }
  // the group's first and last rows: keys all of its rows see, and keys
  // some of them see
  const int q_first = pos0 + min(gr0, R - 1) / a.group;
  const int q_last = pos0 + min(gr0 + 63, R - 1) / a.group;
  const int all_hi = min(q_first, last), any_hi = min(q_last, last);
  const int all_lo = a.window > 0 ? q_last - a.window + 1 : 0;
  const int any_lo = a.window > 0 ? q_first - a.window + 1 : 0;
  const uint16_t* qg = qs + wg * 64 * 64;        // the group's q rows
  // scores and m in base-2 exponents: s hd^-0.5 log2(e); the partials' m
  // goes out in natural units (m ln 2), as the combine takes it
  const float scale2 = a.scale * 1.4426950408889634f;

  float o[kBX][8][4], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int x = 0; x < kBX; ++x)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[x][n][e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % kStages;
    const int j0 = j_begin + t * kKT;
    tma::mbar_wait(&full[st], (t / kStages) & 1);
    if (active && j0 <= any_hi && j0 + kKT - 1 >= any_lo) {
      const uint16_t* kt = ks + st * kKT * HP;
      const uint16_t* vt = vs + st * kKT * HP;
      // 1. S = Q K^T, 64 rows x 64 keys a warpgroup, fp32 (both operands
      //    K-major in shared memory; a k-step is 32 bytes on in the row)
      float s[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
      wg_hold(s);
      wg_fence();
#pragma unroll
      for (int k = 0; k < kKS; ++k) {
        wgmma_ss(s, desc_n128(qg + (k >> 2) * kRows * 64 + (k & 3) * 16),
                 desc_n128(kt + (k >> 2) * kKT * 64 + (k & 3) * 16));
      }
      wg_commit();
      wg_wait<0>();
      wg_hold(s);
      // 2. scale (into base-2 exponents), mask (only where some key is
      //    hidden from some row)
      const bool masked = j0 + kKT - 1 > all_hi || j0 < all_lo;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[n][e] * scale2;
          if (masked) {
            const int i = e >> 1, j = j0 + n * 8 + 2 * tig + (e & 1);
            const bool ok = j <= vk[i] &&
                            (a.window <= 0 || j > qp[i] - a.window);
            x = ok ? x : kNegInf;
          }
          s[n][e] = x;
        }
      // 3. online softmax: a row's state on the 4 lanes of its quad
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = kNegInf;
#pragma unroll
        for (int n = 0; n < 8; ++n)
          mx = fmaxf(mx, fmaxf(s[n][2 * i], s[n][2 * i + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[i], mx);
        alpha[i] = exp2f(m[i] - m_new);
        m[i] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 2 * i; e < 2 * i + 2; ++e) {
            const float p = s[n][e] > kNegInf ? exp2f(s[n][e] - m_new) : 0.f;
            s[n][e] = p;
            sum += p;
          }
        l[i] = l[i] * alpha[i] + sum;
      }
      // 4. O = O alpha + P V: P as bf16 A fragments (16 keys a k-step), V
      //    N-major from shared memory
      uint32_t pf[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        pf[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
        pf[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
        pf[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        pf[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
        wg_hold(pf[kk]);
      }
#pragma unroll
      for (int x = 0; x < kBX; ++x) {
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          o[x][n][0] *= alpha[0];
          o[x][n][1] *= alpha[0];
          o[x][n][2] *= alpha[1];
          o[x][n][3] *= alpha[1];
        }
        wg_hold(o[x]);
      }
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int x = 0; x < kBX; ++x)
          wgmma_rs(o[x], pf[kk], desc_n128(vt + x * kKT * 64 + kk * 16 * 64));
      wg_commit();
      wg_wait<0>();
#pragma unroll
      for (int x = 0; x < kBX; ++x) wg_hold(o[x]);
    }
    __syncwarp();
    if (lane == 0) tma::mbar_arrive(&empty[st]);
  }
  if (!active) return;

  // -- this warp's rows out: bf16 (one split) or fp32 partials -----------
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int r = wr0 + gid + 8 * i;
    if (r >= R) continue;
    const size_t orow = ((size_t)b * a.C + r / a.group) * a.H +
                        h * a.group + r % a.group;
    if (a.ws_acc == nullptr) {
      const float inv = 1.f / fmaxf(l[i], 1e-30f);
      uint32_t* dst = reinterpret_cast<uint32_t*>(a.out + orow * HD + 2 * tig);
#pragma unroll
      for (int x = 0; x < kBX; ++x)
#pragma unroll
        for (int n = 0; n < 8; ++n)
          if (x * 64 + n * 8 < HD)
            dst[x * 32 + n * 4] = pack_bf16(o[x][n][2 * i] * inv,
                                            o[x][n][2 * i + 1] * inv);
    } else {
      const size_t w = orow * a.splits + sp;
      float2* dst = reinterpret_cast<float2*>(a.ws_acc + w * HD + 2 * tig);
#pragma unroll
      for (int x = 0; x < kBX; ++x)
#pragma unroll
        for (int n = 0; n < 8; ++n)
          if (x * 64 + n * 8 < HD)
            dst[x * 32 + n * 4] = make_float2(o[x][n][2 * i],
                                              o[x][n][2 * i + 1]);
      if (tig == 0) {
        a.ws_ml[2 * w] = m[i] > kNegInf ? m[i] * 0.6931471805599453f : m[i];
        a.ws_ml[2 * w + 1] = l[i];
      }
    }
  }
}

template <int HD>
bool smem_raised = false;

template <int HD>
int launch(const Args& a, int B, long long keys, int row_tiles,
           cudaStream_t stream) {
  constexpr int smem = smem_bytes<HD>();
  CUtensorMap kmap, vmap;
  int err = split_kv::encode_kv_maps(a.k, a.v, HD, a.Hk, keys, 64, a.kb,
                                     true, &kmap, &vmap);
  if (err == 0 && !smem_raised<HD>) {
    err = (int)cudaFuncSetAttribute(
        prefill_split_kernel<HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    smem_raised<HD> = err == 0;
  }
  if (err != 0) return err;
  const dim3 grid(row_tiles * a.splits, a.Hk, B);
  prefill_split_kernel<HD><<<grid, kThreads, smem, stream>>>(a, kmap, vmap);
  const int launched = (int)cudaGetLastError();
  if (launched != 0 || a.splits == 1) return launched;
  split_kv::combine_kernel<HD><<<dim3(a.C * a.H, B), HD, 0, stream>>>(
      a.ws_acc, a.ws_ml, a.out, a.C * a.H, a.splits);
  return (int)cudaGetLastError();
}

}  // namespace split_prefill

// splits blocks per (row, kv head, 128-row tile), each over split_len keys
// (a multiple of 64, covering max_pages * page_size); with splits > 1 the
// partials go to ws_acc [B, C, H, splits, hd] and ws_ml [B, C, H, splits,
// 2] and a second kernel combines them into out.
extern "C" int paged_flash_prefill_bf16(const void* q, const void* k_pages,
                                        const void* v_pages,
                                        const int* page_indptr,
                                        const int* page_indices,
                                        const int* last_page_len,
                                        const int* pos0, void* out,
                                        void* ws_acc, void* ws_ml, int B,
                                        int C, int num_pages, int page_size,
                                        int max_pages, int H, int Hk, int hd,
                                        int window, float scale, int splits,
                                        int split_len, void* stream) {
  if (page_size < 1) return -3;
  const long long S = (long long)max_pages * page_size;
  if (splits < 1 || split_len % split_prefill::kKT != 0 ||
      (long long)splits * split_len < S ||
      (long long)(splits - 1) * split_len >= S ||
      (splits > 1 && (ws_acc == nullptr || ws_ml == nullptr)))
    return -2;
  split_prefill::Args a{};
  a.q = (const uint16_t*)q;
  a.k = (const uint16_t*)k_pages;
  a.v = (const uint16_t*)v_pages;
  a.indptr = page_indptr;
  a.indices = page_indices;
  a.lastlen = last_page_len;
  a.pos0 = pos0;
  a.out = (uint16_t*)out;
  a.ws_acc = splits > 1 ? (float*)ws_acc : nullptr;
  a.ws_ml = splits > 1 ? (float*)ws_ml : nullptr;
  a.C = C;
  a.H = H;
  a.Hk = Hk;
  a.group = H / Hk;
  a.ps = page_size;
  a.kb = split_kv::page_box_keys(page_size);
  a.window = window;
  a.splits = splits;
  a.split_len = split_len;
  a.scale = scale;
  const int row_tiles =
      (C * a.group + split_prefill::kRows - 1) / split_prefill::kRows;
  const long long keys = (long long)num_pages * page_size;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (hd) {
    case 32: return split_prefill::launch<32>(a, B, keys, row_tiles, s);
    case 64: return split_prefill::launch<64>(a, B, keys, row_tiles, s);
    case 128: return split_prefill::launch<128>(a, B, keys, row_tiles, s);
    default: return -1;
  }
}
