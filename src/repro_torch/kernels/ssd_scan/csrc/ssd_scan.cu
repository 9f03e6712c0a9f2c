// Mamba2 SSD chunked scan (state-space duality), written for Hopper.
//
// Replaces the JAX package's Pallas TPU kernel
// src/repro/kernels/ssd_scan/ssd_scan.py:66 (ssd_scan, body _ssd_kernel
// :30), in the model layout of src/repro/models/ssm.py::ssd_chunked:
//   ssd_scan_bf16(x [B,S,nh,HP] bf16, dt [B,S,nh] f32, A_log [nh] f32,
//                 Bm [B,S,DS] bf16, Cm [B,S,DS] bf16, h0 [B,nh,DS,HP] f32
//                 or null, workspace) -> y [B,S,nh,HP] bf16, h [B,nh,DS,HP]
// Per (row b, head) and chunk c of Q steps, with a = -exp(A_log) * dt, acs
// the chunk's cumulative sum of a and h_c the state after chunk c:
//   y[q] = sum_{k<=q} (C_q . B_k) exp(acs_q - acs_k) dt_k x_k
//          + exp(acs_q) C_q h_{c-1}
//   h_c  = exp(acs_end) h_{c-1} + s_c,
//   s_c  = sum_k B_k exp(acs_end - acs_k) dt_k x_k^T
// y is rounded once to bf16, h stays fp32. The ragged tail (S not a
// multiple of Q) is masked; it gives the state the reference's dt = 0
// padding gives.
//
// What bounds it on an H100. At the served shape (B = 4, S = 2048, 32 heads
// of 64, DS = 128, Q = 256) the call's inputs and outputs are ~76 MB (x and
// y dominate: B and C are shared by all heads and count once per row):
// ~0.023 ms at 3.35 TB/s, against ~0.013 ms of its operations at the bf16
// tensor-core peak. The TPU kernel's sequential grid axis over chunks
// cannot become a loop of one block per (row, head): 128 blocks, 32 at
// B = 1, reached 2% of the bound. The work has to spread over the whole
// card.
//
// The design: chunk-parallel, three kernels on the caller's stream.
//   1. chunk_state_kernel, grid (chunk, head pair, row): the chunk's acs
//      (a per-chunk warp scan, never a prefix over S: at S = 65536
//      differences of large sums would lose digits), its decay
//      exp(acs_end) and its own state s_c = (B o w)^T x, w_k = exp(acs_end
//      - acs_k) dt_k, into an fp32 workspace [B, chunks, nh, DS, HP];
//   2. state_pass_kernel, grid (cells, head, row): h_c = exp(acs_end,c)
//      h_{c-1} + s_c in chunk order, elementwise per state cell (sequential
//      only over chunks), overwriting s_c with the chunk's incoming state
//      h_{c-1}, split into bf16 hi and lo for the tensor cores, and writing
//      the final h;
//   3. chunk_output_kernel, grid (128-query tile x chunk, head pair, row):
//      y of its queries, (C B^T o L o dt) x over the keys up to its tile's
//      diagonal, plus exp(acs_q) C h_{c-1}; C B^T is formed once for both
//      heads of the pair. Below the diagonal exp(acs_q - acs_k) is taken
//      as exp(acs_q - acs_m) w_k against the end m of k's 16-key block
//      (both exponents <= 0), so a 16 x 16 block needs 2 exps a row, not
//      16. Rounded once to bf16.
// The chunk states add 4 B*chunks*nh*DS*HP bytes per pass over them (33.5
// MB at the served shape, 268 MB at S = 65536), four passes: written by 1,
// read and rewritten by 2, read by 3.
// Products run on the tensor cores, fp32 accumulators. C B^T has two exact
// bf16 operands (mma.sync m16n8k16). The other three products have one
// fp32 operand (B o w, C B^T o L o dt, h_{c-1}) and one exact bf16 operand
// (x, x, C): the fp32 one is split into bf16 hi + lo and both are
// multiplied, so each product is an fp32 product to about 2^-17 of the
// operand. Those run as wgmma m64n64k16 with the split operand in
// registers and the bf16 one (x, or the state's planes) read by the tensor
// cores from a 128-byte-swizzled tile. Tiles reach the shared memory by
// cp.async, double-buffered over 64-key tiles. Every sum runs in a fixed
// order and nothing is atomic: the output is bitwise equal from launch to
// launch.
// The split doubles three of the four products: ~33 GFLOP at the served
// shape, so the products, not the bytes, set the pace (PERF.md, section 6).
// Measured and dropped there: the state kernel on mma.sync (0.054 ms
// served, 0.040 on wgmma); 64-query tiles of 4 warps for the output kernel
// (0.167-0.172 ms, 0.149-0.155 at 128 queries and 8 warps); one output
// block an SM with all the registers it asks for (0.197); the key tiles and
// the state prefetched to L2 ahead of their copies (slower: 0.047 and
// 0.156); double-buffered wgmma operands, the state's copy overlapped
// with the last key tile, and C h first into y's accumulators (no change).
//
// The entry launches on the given stream, allocates nothing and returns
// cudaGetLastError() (0 = launched), or -1 for widths it is not built for.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_mma.cuh"

namespace {

using namespace wmma_sync;

constexpr int kThreads = 128;        // the state pass's block
constexpr int kT = 64;               // key tile, in steps
constexpr int kQT = 128;             // query tile of the output kernel
constexpr int kOutWarps = kQT / 16;  // one warp per 16 queries
constexpr int kMaxQ = 256;           // longest chunk the kernels take
constexpr int kHG = 2;               // heads a block (C B^T shared by them)

// Warps of the chunk-state kernel: a warpgroup (4 warps, 64 state rows)
// per 64 rows of DS.
__host__ __device__ constexpr int state_warps(int DS) {
  return 4 * ((DS + 63) / 64);
}

constexpr int kXW = 64;              // bf16 columns of a swizzled tile

// The dynamic shared memory from its first 1024-byte boundary (the
// swizzle's period), by pointer arithmetic so that the compiler keeps
// seeing shared memory.
__device__ __forceinline__ unsigned char* smem_align(unsigned char* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

// cp.async of rows [t_lo, t_lo + 64) of x (HP <= 64 bf16 a row, row stride
// `stride`) into a swizzled [64][64] tile; columns past HP and rows at or
// past nv zero-filled.
template <int HP, int NTH>
__device__ __forceinline__ void load_x_swz(uint16_t* dst, const uint16_t* src,
                                           size_t stride, int t_lo, int nv) {
  for (int i = threadIdx.x; i < kT * 8; i += NTH) {
    const int r = i >> 3, v = i & 7, t = t_lo + r;
    const bool ok = t < nv && v < HP / 8;
    cp_async16(dst + r * kXW + ((v ^ (r & 7)) << 3),
               ok ? src + (size_t)t * stride + v * 8 : src, ok ? 16 : 0);
  }
}

struct Args {
  const uint16_t* x;
  const float* dt;
  const float* A_log;
  const uint16_t* Bm;
  const uint16_t* Cm;
  const float* h0;
  uint16_t* y;
  float* h;
  float* states;                     // [B, nc, nh, DS, HP]
  float* decay;                      // [B, nc, nh]
  int S, nh, Q, nc;
};

// The shared tiles of both chunk kernels. A ring stage holds a 64-step
// tile of B rows, padded by 16 bytes a row (conflict-free ldmatrix), then
// one swizzled [64][64] x tile a head (wgmma's B operand); the output
// kernel reuses the ring for the incoming state's hi and lo planes. Every
// size is a multiple of 1024 bytes, so every tile stays aligned for the
// swizzle.
template <int HP, int DS>
struct Tiles {
  static_assert(HP <= kXW && DS % 16 == 0, "widths");
  static constexpr int BP = DS + 8;          // bf16 per B / C row
  static constexpr int kB = kT * BP;         // elements of a B tile
  static constexpr int kXS = kT * kXW;       // elements of a swizzled x tile
  static constexpr int kSStage = kB + kHG * kXS;
  static_assert(BP * 2 % 16 == 0, "B / C rows on 16-byte boundaries");
  static_assert(kB * 2 % 1024 == 0, "B tile keeps the x tiles aligned");
  static_assert(2 * DS * kXW <= kSStage, "a head's state planes fit a stage");
  // per head: dt, acs and the keys' weights w of the chunk
  static constexpr int kScalars = 3 * kHG * kMaxQ * 4;
};

// One head's chunk: dt_s[t] (0 past nv) and acs_s[t], the inclusive
// cumulative sum of a = A dt over t < Qp, by one warp: lane-local sums of
// Qp / 32 steps, then a warp scan. The same instructions in both kernels
// that read acs, so they agree bit for bit.
__device__ __forceinline__ void chunk_scan(const float* dt, int nh, int nv,
                                           float A, int Qp, float* dt_s,
                                           float* acs_s, int lane) {
  constexpr int kPer = kMaxQ / 32;
  const int per = Qp / 32, base = lane * per;
  float dv[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j)           // the loads first, all in flight
    dv[j] = j < per && base + j < nv ? dt[(size_t)(base + j) * nh] : 0.f;
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    if (j < per) {
      dt_s[base + j] = dv[j];
      s = __fadd_rn(s, __fmul_rn(A, dv[j]));
      acs_s[base + j] = s;
    }
  }
  float incl = s;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl = __fadd_rn(incl, o);
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.f;
#pragma unroll
  for (int j = 0; j < kPer; ++j)
    if (j < per) acs_s[base + j] = __fadd_rn(acs_s[base + j], excl);
}

// cp.async of rows [t_lo, t_lo + ROWS) of a [.., W] bf16 matrix (row
// stride `stride` elements, `src` at the chunk's first row) into a padded
// tile, by the block's NTH threads; rows at or past nv zero-filled.
template <int W, int NTH, int ROWS = kT>
__device__ __forceinline__ void load_tile(uint16_t* dst, const uint16_t* src,
                                          size_t stride, int t_lo, int nv) {
  constexpr int V = W / 8;                 // 16-byte pieces a row
  for (int i = threadIdx.x; i < ROWS * V; i += NTH) {
    const int r = i / V, v = i % V, t = t_lo + r;
    const bool ok = t < nv;
    cp_async16(dst + r * (W + 8) + v * 8,
               ok ? src + (size_t)t * stride + v * 8 : src, ok ? 16 : 0);
  }
}

// ---------------------------------------------------------------------------
// 1. The chunk's own state s_c [DS, HP] per head, and its decay.

template <int HP, int DS>
__global__ void __launch_bounds__(32 * state_warps(DS), 2)
chunk_state_kernel(Args a) {
  using L = Tiles<HP, DS>;
  constexpr int BP = L::BP, NTH = 32 * state_warps(DS);
  extern __shared__ unsigned char smem_raw[];
  uint16_t* ring = reinterpret_cast<uint16_t*>(smem_align(smem_raw));
  float* dt_s = reinterpret_cast<float*>(ring + 2 * L::kSStage);
  float* acs_s = dt_s + kHG * kMaxQ;                  // [kHG][kMaxQ] each
  float* w_s = acs_s + kHG * kMaxQ;

  const int c = blockIdx.x, hg0 = blockIdx.y * kHG, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int nh = a.nh, t0 = c * a.Q, nv = min(a.Q, a.S - t0);
  const int Qp = (a.Q + kT - 1) / kT * kT, nkt = (nv + kT - 1) / kT;
  const size_t row0 = (size_t)b * a.S + t0;
  const int heads = min(kHG, nh - hg0);

  auto load = [&](int kt) {
    uint16_t* st = ring + (kt & 1) * L::kSStage;
    load_tile<DS, NTH>(st, a.Bm + row0 * DS, DS, kt * kT, nv);
    for (int h = 0; h < heads; ++h)
      load_x_swz<HP, NTH>(st + L::kB + h * L::kXS,
                          a.x + (row0 * nh + hg0 + h) * HP, (size_t)nh * HP,
                          kt * kT, nv);
    cp_async_commit();
  };
  load(0);

  if (warp < heads) {
    const int head = hg0 + warp;
    chunk_scan(a.dt + row0 * nh + head, nh, nv, -expf(a.A_log[head]), Qp,
               dt_s + warp * kMaxQ, acs_s + warp * kMaxQ, lane);
    __syncwarp();
    const float end = acs_s[warp * kMaxQ + nv - 1];
    for (int t = lane; t < Qp; t += 32)
      w_s[warp * kMaxQ + t] =
          expf(end - acs_s[warp * kMaxQ + t]) * dt_s[warp * kMaxQ + t];
    if (lane == 0)
      a.decay[((size_t)b * a.nc + c) * nh + head] = expf(end);
  }

  // warp w: state rows [16 w, 16 w + 16) (rows past DS multiply zeros),
  // all 64 columns (columns past HP meet x's zero-filled columns)
  float acc[kHG][8][4];
#pragma unroll
  for (int h = 0; h < kHG; ++h)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[h][j][e] = 0.f;
  const bool rows_in = warp * 16 < DS;
  // this lane's ldmatrix.trans row of the A operand B^T ([key][ds] tile)
  const int a_row = (lane >> 4) * 8 + (lane & 7);
  const int a_col = warp * 16 + ((lane >> 3) & 1) * 8;
  uint32_t ahi[2][kHG][4], alo[2][kHG][4];   // two k16 steps' A in flight
  for (int kt = 0; kt < nkt; ++kt) {
    if (kt + 1 < nkt) {
      load(kt + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_async_smem();
    __syncthreads();                       // tile kt and the scalars ready
    const uint16_t* bt = ring + (kt & 1) * L::kSStage;
#pragma unroll
    for (int kk = 0; kk < kT; kk += 16) {
      const int buf = (kk / 16) & 1;
      uint32_t bf[4] = {0u, 0u, 0u, 0u};   // B^T, exact bf16
      if (rows_in) ldmatrix_x4_trans(bf, bt + (kk + a_row) * BP + a_col);
      const int k0 = kt * kT + kk + tig * 2;
#pragma unroll
      for (int h = 0; h < kHG; ++h) {
        const float* w = w_s + h * kMaxQ + k0;
        const float w0 = w[0], w1 = w[1], w8 = w[8], w9 = w[9];
#pragma unroll
        for (int r = 0; r < 4; ++r) {      // (B o w)^T as hi + lo
          const float wl = r < 2 ? w0 : w8, wh = r < 2 ? w1 : w9;
          split_bf16(bf16_lo(bf[r]) * wl, bf16_hi(bf[r]) * wh, ahi[buf][h][r],
                     alo[buf][h][r]);
        }
        wg_hold(ahi[buf][h]);
        wg_hold(alo[buf][h]);
      }
      wg_fence();
#pragma unroll
      for (int h = 0; h < kHG; ++h) {
        if (h >= heads) break;
        const uint64_t xd = desc_n128(bt + L::kB + h * L::kXS + kk * kXW);
        wgmma_rs(acc[h], ahi[buf][h], xd);
        wgmma_rs(acc[h], alo[buf][h], xd);
      }
      wg_commit();
      wg_wait<1>();                        // the step before is done
    }
    wg_wait<0>();
    __syncthreads();                       // stage kt & 1 is refilled next
  }
#pragma unroll
  for (int h = 0; h < kHG; ++h) wg_hold(acc[h]);

#pragma unroll
  for (int h = 0; h < kHG; ++h) {
    if (h >= heads || !rows_in) break;
    float* s = a.states +
               (((size_t)b * a.nc + c) * nh + hg0 + h) * (size_t)(DS * HP);
    const int n = warp * 16 + gid;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int p = j * 8 + tig * 2;
      if (p >= HP) break;
      *reinterpret_cast<float2*>(s + n * HP + p) =
          make_float2(acc[h][j][0], acc[h][j][1]);
      *reinterpret_cast<float2*>(s + (n + 8) * HP + p) =
          make_float2(acc[h][j][2], acc[h][j][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// 2. The state pass: per cell, h = decay_c h + s_c in chunk order. s_c is
// overwritten by the chunk's incoming state h_{c-1}, split for the output
// kernel's tensor cores: each thread's 8 cells (32 bytes) become 8 bf16 hi
// then 8 bf16 lo in the same 32 bytes.

constexpr int kBatch = 8;                  // chunks whose loads are in flight

template <int HP, int DS>
__global__ void __launch_bounds__(kThreads) state_pass_kernel(Args a) {
  constexpr int kCells8 = DS * HP / 8;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= kCells8) return;
  const int head = blockIdx.y, b = blockIdx.z, nh = a.nh, nc = a.nc;
  const size_t hoff = (((size_t)b * nh + head) * kCells8 + i) * 2;
  float4 h[2] = {make_float4(0.f, 0.f, 0.f, 0.f),
                 make_float4(0.f, 0.f, 0.f, 0.f)};
  if (a.h0 != nullptr) {
    h[0] = reinterpret_cast<const float4*>(a.h0)[hoff];
    h[1] = reinterpret_cast<const float4*>(a.h0)[hoff + 1];
  }
  float4* s = reinterpret_cast<float4*>(a.states) +
              (((size_t)b * nc * nh + head) * kCells8 + i) * 2;
  const float* dec = a.decay + (size_t)b * nc * nh + head;
  const size_t step = (size_t)nh * kCells8 * 2;  // float4s, chunk to chunk
  for (int c0 = 0; c0 < nc; c0 += kBatch) {
    const int n = min(kBatch, nc - c0);
    float4 sv[kBatch][2];
    float dv[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      if (j < n) {
        sv[j][0] = s[(c0 + j) * step];
        sv[j][1] = s[(c0 + j) * step + 1];
        dv[j] = dec[(size_t)(c0 + j) * nh];
      }
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      if (j < n) {
        uint32_t hi[4], lo[4];
        split_bf16(h[0].x, h[0].y, hi[0], lo[0]);
        split_bf16(h[0].z, h[0].w, hi[1], lo[1]);
        split_bf16(h[1].x, h[1].y, hi[2], lo[2]);
        split_bf16(h[1].z, h[1].w, hi[3], lo[3]);
        uint4* p = reinterpret_cast<uint4*>(s + (c0 + j) * step);
        p[0] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
        p[1] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          h[u].x = dv[j] * h[u].x + sv[j][u].x;
          h[u].y = dv[j] * h[u].y + sv[j][u].y;
          h[u].z = dv[j] * h[u].z + sv[j][u].z;
          h[u].w = dv[j] * h[u].w + sv[j][u].w;
        }
      }
  }
  reinterpret_cast<float4*>(a.h)[hoff] = h[0];
  reinterpret_cast<float4*>(a.h)[hoff + 1] = h[1];
}

// ---------------------------------------------------------------------------
// 3. y of a 128-query tile of a chunk, for a pair of heads: two
// warpgroups, each 64 queries (warp w owns queries [16 w, 16 w + 16) of the
// tile); two blocks an SM.

template <int HP, int DS>
__global__ void __launch_bounds__(32 * kOutWarps, 2)
chunk_output_kernel(Args a) {
  using L = Tiles<HP, DS>;
  constexpr int BP = L::BP, NTH = 32 * kOutWarps, KD = DS / 16;
  constexpr int kPlane = DS * kXW;           // elements of one h plane
  extern __shared__ unsigned char smem_raw[];
  uint16_t* cs = reinterpret_cast<uint16_t*>(smem_align(smem_raw));
  uint16_t* ring = cs + kQT * BP;                          // 2 stages
  float* dt_s = reinterpret_cast<float*>(ring + 2 * L::kSStage);
  float* acs_s = dt_s + kHG * kMaxQ;
  float* w_s = acs_s + kHG * kMaxQ;

  const int Qp = (a.Q + kT - 1) / kT * kT, nqt = (a.Q + kQT - 1) / kQT;
  const int c = blockIdx.x / nqt, qt = blockIdx.x % nqt;
  const int hg0 = blockIdx.y * kHG, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3, m4 = lane >> 3, r8 = lane & 7;
  const int nh = a.nh, t0 = c * a.Q, nv = min(a.Q, a.S - t0);
  const int q0 = qt * kQT;
  if (q0 >= nv) return;                    // the tail chunk's empty tiles
  // key tiles up to the last valid query's; the warpgroup's diagonal one
  // (its 64 queries' own keys), and the warp's 16-key block on it
  const int nkt = (min(q0 + kQT, nv) + kT - 1) / kT;
  const int kdiag = (q0 + (warp / 4) * 64) / kT, jdiag = warp % 4;
  const size_t row0 = (size_t)b * a.S + t0;
  const int heads = min(kHG, nh - hg0);
  const bool state_in = c > 0 || a.h0 != nullptr;

  auto load = [&](int kt) {
    uint16_t* st = ring + (kt & 1) * L::kSStage;
    load_tile<DS, NTH>(st, a.Bm + row0 * DS, DS, kt * kT, nv);
    for (int h = 0; h < heads; ++h)
      load_x_swz<HP, NTH>(st + L::kB + h * L::kXS,
                          a.x + (row0 * nh + hg0 + h) * HP, (size_t)nh * HP,
                          kt * kT, nv);
    cp_async_commit();
  };
  load_tile<DS, NTH, kQT>(cs, a.Cm + row0 * DS, DS, q0, nv);
  load(0);

  if (warp < heads) {
    const int head = hg0 + warp;
    const float* acs = acs_s + warp * kMaxQ;
    chunk_scan(a.dt + row0 * nh + head, nh, nv, -expf(a.A_log[head]), Qp,
               dt_s + warp * kMaxQ, acs_s + warp * kMaxQ, lane);
    __syncwarp();
    // key k's weight against the end of its 16-key block: below the
    // diagonal, exp(acs_q - acs_k) dt_k = exp(acs_q - acs_m) w_k with m =
    // k | 15, both exponents <= 0 (acs falls along the chunk)
    for (int t = lane; t < Qp; t += 32)
      w_s[warp * kMaxQ + t] =
          expf(acs[t | 15] - acs[t]) * dt_s[warp * kMaxQ + t];
  }

  float y[kHG][8][4];                      // 64 columns; past HP unused
#pragma unroll
  for (int h = 0; h < kHG; ++h)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) y[h][j][e] = 0.f;

  const int qr = q0 + warp * 16 + gid;     // this lane's rows: qr, qr + 8
  // this lane's ldmatrix address in the C tile (the A operand)
  const uint16_t* c_lane = cs + (warp * 16 + (m4 & 1) * 8 + r8) * BP +
                           (m4 >> 1) * 8;
  uint32_t g[kHG][2][4];                   // a key block's G, hi and lo
  for (int kt = 0; kt < nkt; ++kt) {
    if (kt + 1 < nkt) {
      load(kt + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_async_smem();
    __syncthreads();
    if (kt <= kdiag) {                     // uniform in the warpgroup
      const uint16_t* bt = ring + (kt & 1) * L::kSStage;
#pragma unroll 1
      for (int jb = 0; jb < kT / 16; ++jb) {  // keys [16 jb, 16 jb + 16)
        const int k0 = kt * kT + jb * 16;     // chunk-local
        const int mode = kt < kdiag || jb < jdiag ? 0    // below the diagonal
                         : jb == jdiag ? 1 : 2;          // on it, above it
        float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        if (mode < 2) {                    // C B^T, both operands exact
#pragma unroll
          for (int kd = 0; kd < KD; ++kd) {
            uint32_t ca[4], bb[4];
            ldmatrix_x4(ca, c_lane + kd * 16);
            ldmatrix_x4(bb, bt + (jb * 16 + (m4 >> 1) * 8 + r8) * BP +
                                kd * 16 + (m4 & 1) * 8);
            mma_bf16(sc[0], ca, bb);
            mma_bf16(sc[1], ca, bb + 2);
          }
        }
#pragma unroll
        for (int h = 0; h < kHG; ++h) {
          const float* acs = acs_s + h * kMaxQ;
          const float* dts = dt_s + h * kMaxQ;
          const float aq[2] = {acs[qr], acs[qr + 8]};
          float v[4][2];                   // A register r: rows qr (+8 for r
                                           // odd), keys of n8 tile r / 2
          if (mode == 0) {
            const float f[2] = {expf(aq[0] - acs[k0 + 15]),
                                expf(aq[1] - acs[k0 + 15])};
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const int row = r & 1, nt = r >> 1;
              const float2 w2 = *reinterpret_cast<const float2*>(
                  w_s + h * kMaxQ + k0 + nt * 8 + tig * 2);
              v[r][0] = sc[nt][row * 2] * f[row] * w2.x;
              v[r][1] = sc[nt][row * 2 + 1] * f[row] * w2.y;
            }
          } else {
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const int row = r & 1, nt = r >> 1;
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int k = k0 + nt * 8 + tig * 2 + e;
                v[r][e] = mode == 2 || k > qr + row * 8
                              ? 0.f
                              : sc[nt][row * 2 + e] *
                                    expf(aq[row] - acs[k]) * dts[k];
              }
            }
          }
#pragma unroll
          for (int r = 0; r < 4; ++r)
            split_bf16(v[r][0], v[r][1], g[h][0][r], g[h][1][r]);
          wg_hold(g[h][0]);
          wg_hold(g[h][1]);
        }
        wg_fence();
#pragma unroll
        for (int h = 0; h < kHG; ++h) {
          if (h >= heads) break;
          const uint64_t xd =
              desc_n128(bt + L::kB + h * L::kXS + jb * 16 * kXW);
          wgmma_rs(y[h], g[h][0], xd);
          wgmma_rs(y[h], g[h][1], xd);
        }
        wg_commit();
        wg_wait<0>();                      // g is rewritten next
      }
    }
    __syncthreads();                       // stage kt & 1 is refilled next
  }

  // + exp(acs_q) C_q h_{c-1}: the chunk's incoming state, as the state pass
  // left it (each 8 cells: 8 bf16 hi, then 8 bf16 lo), into two swizzled
  // planes a head, in the ring
  if (state_in) {
    for (int h = 0; h < heads; ++h) {
      const uint16_t* src = reinterpret_cast<const uint16_t*>(
          a.states + (((size_t)b * a.nc + c) * nh + hg0 + h) *
                         (size_t)(DS * HP));
      uint16_t* dst = ring + h * L::kSStage;
      for (int i = tid; i < DS * 16; i += NTH) {
        const int r = i >> 4, v = (i >> 1) & 7, lo = i & 1;
        const bool ok = v < HP / 8;
        cp_async16(dst + lo * kPlane + r * kXW + ((v ^ (r & 7)) << 3),
                   ok ? src + (r * HP + v * 8) * 2 + lo * 8 : src,
                   ok ? 16 : 0);
      }
    }
    cp_async_commit();
    cp_async_wait<0>();
    fence_async_smem();
    __syncthreads();
#pragma unroll
    for (int h = 0; h < kHG; ++h) {
      if (h >= heads) break;
      const uint16_t* hp0 = ring + h * L::kSStage;
      float ch[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) ch[j][e] = 0.f;
      uint32_t ca[2][4];
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        ldmatrix_x4(ca[kd & 1], c_lane + kd * 16);
        wg_hold(ca[kd & 1]);
        wg_fence();
        const uint16_t* hp = hp0 + kd * 16 * kXW;
        wgmma_rs(ch, ca[kd & 1], desc_n128(hp));
        wgmma_rs(ch, ca[kd & 1], desc_n128(hp + kPlane));
        wg_commit();
        wg_wait<1>();
      }
      wg_wait<0>();
      wg_hold(ch);
      wg_hold(y[h]);
      const float* acs = acs_s + h * kMaxQ;
      const float e0 = expf(acs[qr]), e1 = expf(acs[qr + 8]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        y[h][j][0] += e0 * ch[j][0];
        y[h][j][1] += e0 * ch[j][1];
        y[h][j][2] += e1 * ch[j][2];
        y[h][j][3] += e1 * ch[j][3];
      }
    }
  }
#pragma unroll
  for (int h = 0; h < kHG; ++h) wg_hold(y[h]);

#pragma unroll
  for (int h = 0; h < kHG; ++h) {
    if (h >= heads) break;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int q = qr + half * 8;
      if (q >= nv) continue;
      uint16_t* yr = a.y + ((row0 + q) * nh + hg0 + h) * HP + tig * 2;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j * 8 >= HP) break;
        *reinterpret_cast<uint32_t*>(yr + j * 8) =
            pack_bf16(y[h][j][half * 2], y[h][j][half * 2 + 1]);
      }
    }
  }
}

template <int HP, int DS>
constexpr int state_smem() {
  return 1024 + 2 * Tiles<HP, DS>::kSStage * 2 + Tiles<HP, DS>::kScalars;
}

template <int HP, int DS>
constexpr int output_smem() {
  return state_smem<HP, DS>() + kQT * Tiles<HP, DS>::BP * 2;
}

template <int HP, int DS>
int launch(const Args& a, int B, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        chunk_state_kernel<HP, DS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, state_smem<HP, DS>());
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(chunk_output_kernel<HP, DS>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               output_smem<HP, DS>());
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const int groups = (a.nh + kHG - 1) / kHG;
  const int nqt = (a.Q + kQT - 1) / kQT;
  chunk_state_kernel<HP, DS><<<dim3(a.nc, groups, B),
                               32 * state_warps(DS),
                               state_smem<HP, DS>(), stream>>>(a);
  state_pass_kernel<HP, DS><<<dim3((DS * HP / 8 + kThreads - 1) / kThreads,
                                   a.nh, B), kThreads, 0, stream>>>(a);
  chunk_output_kernel<HP, DS><<<dim3(nqt * a.nc, groups, B),
                                32 * kOutWarps, output_smem<HP, DS>(),
                                stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// x, Bm, Cm 16-byte aligned and contiguous; 1 <= Q <= 256; h0 may be null;
// B, nh >= 1; workspace holds B * nc * nh * (ds * hp + 1) floats, nc =
// ceil(S / Q): the chunk states, then the chunk decays.
extern "C" int ssd_scan_bf16(const void* x, const float* dt,
                             const float* A_log, const void* Bm,
                             const void* Cm, const float* h0, void* y,
                             float* h, float* workspace, int B, int S,
                             int nh, int hp, int ds, int Q, void* stream) {
  if (Q < 1 || Q > kMaxQ) return -1;
  Args a{};
  a.x = (const uint16_t*)x;
  a.dt = dt;
  a.A_log = A_log;
  a.Bm = (const uint16_t*)Bm;
  a.Cm = (const uint16_t*)Cm;
  a.h0 = h0;
  a.y = (uint16_t*)y;
  a.h = h;
  a.S = S;
  a.nh = nh;
  a.Q = Q;
  a.nc = (S + Q - 1) / Q;
  a.states = workspace;
  a.decay = workspace + (size_t)B * a.nc * nh * ds * hp;
  const cudaStream_t s = (cudaStream_t)stream;
  // mamba2-370m's widths, its reduced config's, and jamba's (DS = 16: one
  // warp of the state kernel's warpgroup holds state rows, the other three
  // multiply zeros; B and C rows of 24 bf16, 48 bytes, keep every cp.async
  // and ldmatrix row on a 16-byte boundary)
  if (hp == 64 && ds == 128) return launch<64, 128>(a, B, s);
  if (hp == 32 && ds == 32) return launch<32, 32>(a, B, s);
  if (hp == 64 && ds == 16) return launch<64, 16>(a, B, s);
  return -1;
}
