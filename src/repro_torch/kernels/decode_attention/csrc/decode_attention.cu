// Flash-decode attention for Hopper: one query token per batch row against
// a dense KV cache or the paged KV pool, one kernel for both.
//
// Replaces the JAX package's Pallas TPU kernels
//   flash_decode_bf16       <- decode_attention/decode_attention.py:
//                              flash_decode (_decode_kernel)
//   paged_flash_decode_bf16 <- decode_attention/paged.py:
//                              paged_flash_decode (_paged_kernel, _kv_page_map)
// q [B, H, hd]; dense k/v [B, S, Hk, hd] with pos [B] (row b sees keys
// j <= pos[b], and j > pos[b] - window when window > 0); paged k/v
// [num_pages, page_size, Hk, hd] through the CSR page table (page_indptr
// [B+1], page_indices, last_page_len [B]); row b's query sits at its last
// key (n_pages_b - 1) * page_size + last_page_len_b - 1, a signed value:
// the engine's full-width rows pass last_page_len <= 0. out [B, H, hd].
// All bf16 and contiguous; fp32 scores, softmax state and PV, one rounding.
//
// What bounds them on an H100: each K and V element is read once and meets
// `group` (= 4 for Mixtral) query heads, two flops each way: ~4 flop per
// byte, far below the ~295 where the tensor cores bind, and at the long
// shape (B = 4, S = 32768, Hk = 8, hd = 128) 2.1 GFLOP, which the fp32 CUDA
// cores do in ~0.03 ms. The bound is bytes: K and V up to each row's
// position, over 3.35 TB/s (537 MB at the long shape, 0.160 ms), the same
// for the dense cache and the pool. So the products stay on the fp32 CUDA
// cores; what matters is keeping HBM busy.
//
// decode_split_kernel<HD, ROWS, PAGED>: split S across blocks, then combine.
//   * grid (row tiles x splits, Hk, B): one block per (row, kv head, split
//     of the key axis), where one block per (row, kv head) over all keys
//     would put 32 blocks on 132 SMs at the long shape. The host picks the
//     splits from the shapes and the SM count (ops.py: decode_splits, from
//     S or, paged, max_pages * page_size; the tables stay on the card): as
//     many as fill 2 blocks on every SM in one wave (at the long shape 8
//     splits of 4096 keys: 256 blocks);
//   * each split intersects its keys with the row's visible range
//     [max(0, q - window + 1), q], q = pos[b] or the row's last key, and
//     walks it in 64-key tiles;
//   * a ring of K/V tiles in shared memory, filled by TMA (split_kv.cuh):
//     one producer warp asks for each tile as 3-D boxes (1 head x 64 dims,
//     128-byte swizzled) and counts them on the stage's mbarrier; it
//     refills a stage as soon as the consumers release it, so the next tile
//     is in flight while this one is scored. Dense: one box of 64 keys a
//     column. Paged: the only change; the producer reads the row's page ids
//     itself and cuts a tile into boxes of gcd(page_size, 64) keys, which
//     never cross a page; tiles past the row's last page clamp to it and the
//     mask drops their keys;
//   * 8 consumer warps own 8 keys of every tile each and keep their own
//     online softmax (m, l, acc) in registers: scores by a key a lane over
//     a quarter of the head dims (q in shared memory as fp32, already
//     scaled), PV with a lane owning hd / 32 dims; no block barrier inside
//     the loop. The warps' states merge in warp order at the end;
//   * with one split (the served shapes: S = 49 dense, 8 pages of 16
//     paged) the block normalises and writes bf16 directly: no workspace,
//     no second launch. With more, it writes an fp32 partial (m, l,
//     unnormalised acc) per (row, head, split) to a workspace the wrapper
//     allocates (a split that sees no key writes m = -1e30, l = 0, acc = 0),
//     and split_kv::combine_kernel merges the partials in split order and
//     rounds to bf16 once. No atomics: results are bitwise equal from run
//     to run.
// More splits (12, 16, 32: 3 or more blocks on some SMs), a third ring
// stage and 4 consumer warps were measured on the dense cache and ran no
// faster (PERF.md, section 6); PERF.md also gives the times and what still
// holds the kernel back.
//
// Each entry launches on the given stream, allocates nothing and returns 0,
// a CUDA error code, -1 for an unsupported head dimension, -2 for a split
// that does not cover S, or -3 for a page size below 1.
#include "split_kv.cuh"
#include "tma.cuh"

namespace split_decode {

using split_kv::kKT;
using split_kv::kNegInf;
using split_kv::kv_off;

constexpr int kWarps = 8;             // consumer warps
constexpr int kThreads = 32 * (kWarps + 1);   // + one producer warp
constexpr int kKW = kKT / kWarps;     // keys per consumer warp
constexpr int kStages = 2;            // K/V tiles in the ring

struct Args {
  const uint16_t* q;                  // [B, H, HD]
  const uint16_t* k;                  // [B, S, Hk, HD] | [N, ps, Hk, HD]
  const uint16_t* v;
  const int* pos;                     // dense: [B]
  const int* indptr;                  // paged: [B + 1]
  const int* indices;                 // paged: [indptr[B]] page ids
  const int* lastlen;                 // paged: [B]
  uint16_t* out;                      // [B, H, HD]
  float* ws_acc;                      // [B, H, splits, HD], or null
  float* ws_ml;                       // [B, H, splits, 2] (m, l), or null
  int S;                              // keys a row (paged: max_pages * ps)
  int ps;                             // paged: page size
  int kb;                             // keys a TMA box (dense: kKT)
  int H, Hk, group, window, splits, split_len;
  float scale;
};

constexpr int kParts = 32 / kKW;      // lanes a key: each a part of the dims

template <int HD>
__host__ __device__ constexpr int q_pitch() { return HD + 4 * kParts; }

template <int HD, int ROWS>
constexpr int smem_bytes() {
  return 1024                                   // alignment of the boxes
         + 2 * kStages * kKT * HD * 2           // K, V tiles
         + (ROWS * q_pitch<HD>() + kWarps * ROWS * kKW   // q, p
            + 2 * kWarps * ROWS) * 4            // each warp's m, l
         + 2 * kStages * 8;                     // full, empty mbarriers
}

// One block per (tile of ROWS query rows of a kv head, kv head, batch row)
// and split of the key axis. The last warp fills the ring (TMA, from the
// dense cache or through the row's page table: split_kv.cuh); the kWarps
// consumer warps each own kKW keys of every tile and keep their own
// online-softmax state, so they never wait on one another inside the loop;
// their states are merged, in warp order, at the end.
template <int HD, int ROWS, bool PAGED>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const Args a, const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap) {
  constexpr int kCh = HD / 8;                    // 16-byte chunks a row
  constexpr int kDPL = HD / 32;                  // PV: head dims a lane
  constexpr int kQP = q_pitch<HD>();
  constexpr int kPC = kCh / kParts;              // chunks of a lane's part
  static_assert(kKT == 64 && kKW * kWarps == kKT && kPC >= 1 &&
                HD % 32 == 0, "tile shape");
  static_assert(kWarps * ROWS * HD * 4 <= 2 * kStages * kKT * HD * 2,
                "the merge buffer reuses the K and V tiles");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (tma::smem_u32(smem_raw) & 1023)) & 1023);
  uint16_t* ks = reinterpret_cast<uint16_t*>(smem);      // [kStages][kKT*HD]
  uint16_t* vs = ks + kStages * kKT * HD;
  float* qs = reinterpret_cast<float*>(vs + kStages * kKT * HD);
  float* ps = qs + ROWS * kQP;                   // [kWarps][ROWS][kKW]
  float* ml_s = ps + kWarps * ROWS * kKW;        // [kWarps][ROWS][2]
  uint64_t* full = reinterpret_cast<uint64_t*>(ml_s + 2 * kWarps * ROWS);
  uint64_t* empty = full + kStages;
  float* red = reinterpret_cast<float*>(smem);   // [kWarps][ROWS][HD], after

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = blockIdx.y, b = blockIdx.z;
  const int sp = blockIdx.x % a.splits, row0 = blockIdx.x / a.splits * ROWS;
  const int rows = min(ROWS, a.group - row0);

  // -- the row's keys: dense, the query at pos[b]; paged, the query at the
  // row's last key (n_pages - 1) * ps + last_page_len - 1, signed: the
  // engine's full-width rows pass last_page_len <= 0 --------------------
  int qpos, kv_len;
  split_kv::KeySource src{nullptr, 0, 0, 0, 0};
  if (PAGED) {
    const int p0 = a.indptr[b], n_pages = a.indptr[b + 1] - p0;
    kv_len = n_pages * a.ps;
    qpos = (n_pages - 1) * a.ps + a.lastlen[b] - 1;
    src = {a.indices + p0, 0, a.ps, a.kb,
           min(max(qpos, 0) / a.ps, n_pages - 1)};
  } else {
    kv_len = a.S;
    qpos = a.pos[b];
    src.key0 = b * a.S;
  }

  // -- the keys this split sees: its range within the visible one --------
  const int lo = a.window > 0 ? max(0, qpos - a.window + 1) : 0;
  const int s0 = sp * a.split_len;
  const int j_end = min(min(kv_len, s0 + a.split_len), qpos + 1);
  const int first = max(s0, lo);
  const int j_begin = s0 + (first - s0) / kKT * kKT;
  const int n_tiles = first < j_end ? (j_end - j_begin + kKT - 1) / kKT : 0;

  // q rows as fp32, scaled; part p of each row 16 p bytes on, so the parts'
  // broadcasts fall in distinct banks
  for (int i = tid; i < ROWS * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    float x = 0.f;
    if (r < rows) {
      const size_t off = ((size_t)b * a.H + h * a.group + row0 + r) * HD + d;
      x = __uint_as_float((uint32_t)a.q[off] << 16) * a.scale;
    }
    qs[r * kQP + d + d / (HD / kParts) * 4] = x;
  }
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      tma::mbar_init(&full[i], 1);
      tma::mbar_init(&empty[i], kWarps);
    }
    tma::mbar_init_fence();
  }
  __syncthreads();

  float m[ROWS], l[ROWS], acc[ROWS][kDPL];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < kDPL; ++e) acc[r][e] = 0.f;
  }

  if (warp == kWarps) {
    split_kv::produce<HD, kStages>(src, lane, h, j_begin, n_tiles, ks, vs,
                                   full, empty, &kmap, &vmap);
  } else {
    // -- consumers: warp w takes keys [kKW w, kKW w + kKW) of every tile ----
    const int kk = lane % kKW, part = lane / kKW;  // a key, a part of dims
    float* pw = ps + warp * ROWS * kKW;
    for (int t = 0; t < n_tiles; ++t) {
      const int st = t % kStages;
      tma::mbar_wait(&full[st], (t / kStages) & 1);
      const uint16_t* kt = ks + st * kKT * HD;
      const uint16_t* vt = vs + st * kKT * HD;
      const int k0 = warp * kKW, jw = j_begin + t * kKT + k0;
      // 1. scores of this lane's key over its part of the head dims
      float s[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) s[r] = 0.f;
#pragma unroll
      for (int i = 0; i < kPC; ++i) {
        const int c = part * kPC + i;
        float kf[8];
        split_kv::unpack8(*reinterpret_cast<const uint4*>(
                                kt + kv_off<HD>(k0 + kk, c)), kf);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const float* qr = qs + r * kQP + c * 8 + part * 4;
          const float4 q0 = *reinterpret_cast<const float4*>(qr);
          const float4 q1 = *reinterpret_cast<const float4*>(qr + 4);
          s[r] = fmaf(q0.x, kf[0], s[r]);
          s[r] = fmaf(q0.y, kf[1], s[r]);
          s[r] = fmaf(q0.z, kf[2], s[r]);
          s[r] = fmaf(q0.w, kf[3], s[r]);
          s[r] = fmaf(q1.x, kf[4], s[r]);
          s[r] = fmaf(q1.y, kf[5], s[r]);
          s[r] = fmaf(q1.z, kf[6], s[r]);
          s[r] = fmaf(q1.w, kf[7], s[r]);
        }
      }
      // 2. this warp's online softmax over its kKW keys
      const int jk = jw + kk;
      const bool ok = jk < j_end && jk >= lo;
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
#pragma unroll
        for (int o = kKW; o < 32; o <<= 1)
          s[r] += __shfl_xor_sync(0xffffffffu, s[r], o);
        const float x = (ok && r < rows) ? s[r] : kNegInf;
        float mx = x;
#pragma unroll
        for (int o = kKW / 2; o > 0; o >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_new = fmaxf(m[r], mx);
        const float alpha = expf(m[r] - m_new);
        const float p = (ok && r < rows) ? expf(x - m_new) : 0.f;
        l[r] = l[r] * alpha + (part == 0 ? p : 0.f);
        m[r] = m_new;
#pragma unroll
        for (int e = 0; e < kDPL; ++e) acc[r][e] *= alpha;
        if (part == 0) pw[r * kKW + kk] = p;
      }
      __syncwarp();
      // 3. acc += p @ V over the warp's keys that are visible; the lane
      //    owns head dims [kDPL lane, kDPL lane + kDPL)
      const int c = lane * kDPL / 8, sub = lane * kDPL % 8;
      for (int j = 0; j < kKW; ++j) {
        if (jw + j >= j_end || jw + j < lo) continue;   // warp-uniform
        const uint16_t* vr = vt + kv_off<HD>(k0 + j, c) + sub;
        float vf[kDPL];
        if constexpr (kDPL == 4) {
          const uint2 raw = *reinterpret_cast<const uint2*>(vr);
          vf[0] = __uint_as_float(raw.x << 16);
          vf[1] = __uint_as_float(raw.x & 0xffff0000u);
          vf[2] = __uint_as_float(raw.y << 16);
          vf[3] = __uint_as_float(raw.y & 0xffff0000u);
        } else if constexpr (kDPL == 2) {
          const uint32_t raw = *reinterpret_cast<const uint32_t*>(vr);
          vf[0] = __uint_as_float(raw << 16);
          vf[1] = __uint_as_float(raw & 0xffff0000u);
        } else {
          vf[0] = __uint_as_float((uint32_t)vr[0] << 16);
        }
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const float p = pw[r * kKW + j];
#pragma unroll
          for (int e = 0; e < kDPL; ++e) acc[r][e] = fmaf(p, vf[e], acc[r][e]);
        }
      }
      __syncwarp();
      if (lane == 0) tma::mbar_arrive(&empty[st]);
    }
  }
  __syncthreads();                     // every tile consumed: K tiles -> red

  // -- merge the consumer warps' states, in warp order -----------------
  if (warp < kWarps) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
#pragma unroll
      for (int e = 0; e < kDPL; ++e)
        red[(warp * ROWS + r) * HD + lane * kDPL + e] = acc[r][e];
      float lt = l[r];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) lt += __shfl_xor_sync(0xffffffffu, lt, o);
      if (lane == 0) {
        ml_s[(warp * ROWS + r) * 2] = m[r];
        ml_s[(warp * ROWS + r) * 2 + 1] = lt;
      }
    }
  }
  __syncthreads();

  const size_t row_base = (size_t)b * a.H + h * a.group + row0;
  for (int i = tid; i < rows * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    float mm = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, ml_s[(w * ROWS + r) * 2]);
    float o = 0.f, ll = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = expf(ml_s[(w * ROWS + r) * 2] - mm);
      o += wt * red[(w * ROWS + r) * HD + d];
      ll += wt * ml_s[(w * ROWS + r) * 2 + 1];
    }
    if (a.ws_acc == nullptr) {
      a.out[(row_base + r) * HD + d] = __bfloat16_as_ushort(
          __float2bfloat16_rn(o / fmaxf(ll, 1e-30f)));
    } else {
      a.ws_acc[((row_base + r) * a.splits + sp) * HD + d] = o;
      if (d == 0) {
        float* ml = a.ws_ml + ((row_base + r) * a.splits + sp) * 2;
        ml[0] = mm;
        ml[1] = ll;
      }
    }
  }
}

// Whether a kernel's shared-memory limit has been raised.
template <int HD, int ROWS, bool PAGED>
bool smem_raised = false;

// Raises the kernel's dynamic shared-memory limit once (0 or an error).
template <int HD, int ROWS, bool PAGED>
int raise_smem() {
  if (smem_raised<HD, ROWS, PAGED>) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      decode_split_kernel<HD, ROWS, PAGED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<HD, ROWS>());
  if (e != cudaSuccess) return (int)e;
  smem_raised<HD, ROWS, PAGED> = true;
  return 0;
}

// keys: rows of the K/V maps (dense B * S, paged N * ps).
template <int HD, int ROWS, bool PAGED>
int launch(const Args& a, int B, long long keys, int row_tiles,
           cudaStream_t stream) {
  constexpr int smem = smem_bytes<HD, ROWS>();
  CUtensorMap kmap, vmap;
  int err = split_kv::encode_kv_maps(
      a.k, a.v, HD, a.Hk, keys, split_kv::box_cols<HD>(), a.kb,
      split_kv::swizzle<HD>(), &kmap, &vmap);
  if (err == 0) err = raise_smem<HD, ROWS, PAGED>();
  if (err != 0) return err;
  const dim3 grid(row_tiles * a.splits, a.Hk, B);
  decode_split_kernel<HD, ROWS, PAGED><<<grid, kThreads, smem, stream>>>(
      a, kmap, vmap);
  const int launched = (int)cudaGetLastError();
  if (launched != 0 || a.splits == 1) return launched;
  split_kv::combine_kernel<HD><<<dim3(a.H, B), HD, 0, stream>>>(
      a.ws_acc, a.ws_ml, a.out, a.H, a.splits);
  return (int)cudaGetLastError();
}

template <int HD, bool PAGED>
int launch_rows(const Args& a, int B, long long keys, cudaStream_t stream) {
  if (a.group <= 4) return launch<HD, 4, PAGED>(a, B, keys, 1, stream);
  if (a.group <= 8) return launch<HD, 8, PAGED>(a, B, keys, 1, stream);
  return launch<HD, 16, PAGED>(a, B, keys, (a.group + 15) / 16, stream);
}

// The arguments both entries share; -2 where the splits do not cover the
// S keys a row may hold (paged: max_pages * page_size) in whole tiles.
int fill(Args* a, const void* q, const void* k, const void* v, void* out,
         void* ws_acc, void* ws_ml, int S, int H, int Hk, int window,
         float scale, int splits, int split_len) {
  if (splits < 1 || split_len % kKT != 0 ||
      (long long)splits * split_len < S ||
      (long long)(splits - 1) * split_len >= S ||
      (splits > 1 && (ws_acc == nullptr || ws_ml == nullptr)))
    return -2;
  a->q = (const uint16_t*)q;
  a->k = (const uint16_t*)k;
  a->v = (const uint16_t*)v;
  a->out = (uint16_t*)out;
  a->ws_acc = splits > 1 ? (float*)ws_acc : nullptr;
  a->ws_ml = splits > 1 ? (float*)ws_ml : nullptr;
  a->S = S;
  a->H = H;
  a->Hk = Hk;
  a->group = H / Hk;
  a->window = window;
  a->splits = splits;
  a->split_len = split_len;
  a->scale = scale;
  a->kb = kKT;
  return 0;
}

template <bool PAGED>
int launch_hd(const Args& a, int B, int hd, long long keys, cudaStream_t s) {
  switch (hd) {
    case 32: return launch_rows<32, PAGED>(a, B, keys, s);
    case 64: return launch_rows<64, PAGED>(a, B, keys, s);
    case 128: return launch_rows<128, PAGED>(a, B, keys, s);
    default: return -1;
  }
}

}  // namespace split_decode

// splits blocks per (row, kv head), each over split_len keys (a multiple of
// 64, splits * split_len >= S); with splits > 1 the partials go to ws_acc
// [B, H, splits, hd] and ws_ml [B, H, splits, 2] and a second kernel
// combines them into out.
extern "C" int flash_decode_bf16(const void* q, const void* k, const void* v,
                                 const int* pos, void* out, void* ws_acc,
                                 void* ws_ml, int B, int S, int H, int Hk,
                                 int hd, int window, float scale, int splits,
                                 int split_len, void* stream) {
  split_decode::Args a{};
  const int err = split_decode::fill(&a, q, k, v, out, ws_acc, ws_ml, S, H,
                                     Hk, window, scale, splits, split_len);
  if (err != 0) return err;
  a.pos = pos;
  return split_decode::launch_hd<false>(a, B, hd, (long long)B * S,
                                        (cudaStream_t)stream);
}

// The same over the paged pool [num_pages, page_size, Hk, hd]; the splits
// cover max_pages * page_size keys.
extern "C" int paged_flash_decode_bf16(const void* q, const void* k_pages,
                                       const void* v_pages,
                                       const int* page_indptr,
                                       const int* page_indices,
                                       const int* last_page_len, void* out,
                                       void* ws_acc, void* ws_ml, int B,
                                       int num_pages, int page_size,
                                       int max_pages, int H, int Hk, int hd,
                                       int window, float scale, int splits,
                                       int split_len, void* stream) {
  if (page_size < 1) return -3;
  split_decode::Args a{};
  const int err = split_decode::fill(
      &a, q, k_pages, v_pages, out, ws_acc, ws_ml, max_pages * page_size, H,
      Hk, window, scale, splits, split_len);
  if (err != 0) return err;
  a.indptr = page_indptr;
  a.indices = page_indices;
  a.lastlen = last_page_len;
  a.ps = page_size;
  a.kb = split_kv::page_box_keys(page_size);
  return split_decode::launch_hd<true>(a, B, hd,
                                       (long long)num_pages * page_size,
                                       (cudaStream_t)stream);
}
