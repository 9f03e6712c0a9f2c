// Mamba2 SSD chunked scan (state-space duality), written for Hopper.
//
// Replaces the JAX package's Pallas TPU kernel
// src/repro/kernels/ssd_scan/ssd_scan.py:66 (ssd_scan, body _ssd_kernel),
// in the model layout of src/repro/models/ssm.py::ssd_chunked:
//   ssd_scan_bf16(x [B,S,nh,HP] bf16, dt [B,S,nh] f32, A_log [nh] f32,
//                 Bm [B,S,DS] bf16, Cm [B,S,DS] bf16, h0 [B,nh,DS,HP] f32
//                 or null) -> y [B,S,nh,HP] bf16, h [B,nh,DS,HP] f32
// Per (row b, head) and per chunk of Q steps, with a = -exp(A_log) * dt and
// xd = x * dt formed in fp32 here, acs the chunk's cumulative sum of a:
//   y[q]  = sum_{k<=q} (C_q . B_k) exp(acs_q - acs_k) xd[k]
//           + exp(acs_q) C_q h                       (h: the chunk's input)
//   h'    = exp(acs_end) h + sum_k B_k exp(acs_end - acs_k) xd[k]^T
// Rounding points are the reference's: everything in fp32, y rounded once
// to bf16. The ragged tail (S not a multiple of Q) is masked; it gives the
// state the reference's dt = 0 padding gives.
//
// What bounds it on an H100. At the served shape (B = 4, S = 2048, 32 heads
// of 64, DS = 128, Q = 256) the call moves ~76 MB (x and y dominate: B and C
// are shared by all heads and count once per row) and needs ~13 GFLOP
// (C B^T once per row and chunk over the lower triangle, the intra-chunk
// product over the lower triangle, C h and the state update per head):
// bytes bound it, ~0.023 ms at 3.35 TB/s, against ~0.013 ms of operations
// at the bf16 tensor-core peak.
//
// What this first design does, and does not yet do, about it:
//   * one block per (row, head) walks the chunks in order; the TPU's
//     sequential chunk grid axis becomes that loop, and the state h
//     [DS, HP] fp32 (32 KB) stays in shared memory across chunks: it never
//     round-trips device memory;
//   * a chunk's xd (fp32) and B (bf16) sit in shared memory; C and the
//     [64, 64] score tile are staged per 64-step query tile, so the
//     [Q, Q] scores are never formed whole (256 KB at Q = 256); key tiles
//     above the diagonal are skipped, the mask is applied before the exp
//     (so exp never sees the positive differences above the diagonal);
//   * the C h term of every query tile reads the chunk's incoming h; the
//     state update is summed in registers and written only after every
//     query tile has used h;
//   * acs is a per-chunk scan (a warp scan of lane-local sums), never a
//     prefix over S: at S = 65536 differences of large sums lose digits;
//   * B and C are read once per (row, head) from device memory: the 32
//     heads of a row re-read the same rows, from L2. The reference adapter's
//     per-head broadcast of B/C (32x the bytes) is not materialised.
// The products run on fp32 CUDA cores, register-tiled 4 x 4 per thread. One
// block per (row, head) is 128 blocks at the served shape but only 32 at
// B = 1 (a quarter of the 132 SMs). Later work: a chunk-parallel two-pass
// design (intra-chunk terms and chunk states in parallel, then a short
// sequential pass over chunk states), and mma/wgmma for the three products.
//
// The entry launches on the given stream, allocates nothing and returns
// cudaGetLastError() (0 = launched), or -1 for widths it is not built for.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGrid = 16;            // threads as a 16 x 16 grid over a tile
constexpr int kT = 64;               // query / key tile, in steps
constexpr int kMaxQ = 256;           // longest chunk the kernel takes
constexpr int kRows = kT / kGrid;    // tile rows per thread (4)
static_assert(kGrid * kGrid == kThreads, "one thread per grid cell");

struct Args {
  const uint16_t* x;
  const float* dt;
  const float* A_log;
  const uint16_t* Bm;
  const uint16_t* Cm;
  const float* h0;
  uint16_t* y;
  float* h;
  int S, nh, Q;
};

__device__ __forceinline__ float lo_bf16(uint32_t w) {
  return __uint_as_float(w << 16);
}

__device__ __forceinline__ float hi_bf16(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// Shared memory of one block, in 4-byte words, for a chunk padded to Qp.
// B and C rows are DS bf16 packed two to a word, with an odd row stride W so
// that neighbouring rows fall in neighbouring banks.
template <int HP, int DS>
struct Layout {
  static constexpr int W = DS / 2 + 1;     // words per B / C row
  static constexpr int GW = kT + 1;        // words per score-tile row
  __host__ __device__ static int words(int Qp) {
    return DS * HP + Qp * HP + Qp * W + kT * W + kT * GW + 4 * Qp;
  }
};

// Rows [t_lo, t_lo + n) of a [.., DS] bf16 matrix into packed shared rows,
// rows at or past `valid` zero. `src` points at the chunk's first row.
template <int DS>
__device__ __forceinline__ void load_rows(uint32_t* dst, const uint16_t* src,
                                          int t_lo, int n, int valid) {
  constexpr int W = DS / 2 + 1;
  constexpr int V = DS / 8;               // 16-byte vectors per row
  for (int i = threadIdx.x; i < n * V; i += kThreads) {
    const int r = i / V, v = i % V, t = t_lo + r;
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (t < valid)
      u = __ldg(reinterpret_cast<const uint4*>(src + (size_t)t * DS) + v);
    uint32_t* d = dst + r * W + v * 4;
    d[0] = u.x;
    d[1] = u.y;
    d[2] = u.z;
    d[3] = u.w;
  }
}

template <int HP, int DS>
__global__ void __launch_bounds__(kThreads, 1) ssd_kernel(Args a) {
  using L = Layout<HP, DS>;
  constexpr int W = L::W, GW = L::GW;
  constexpr int PJ = HP / kGrid;          // channels per thread
  constexpr int NI = DS / kGrid;          // state rows per thread
  extern __shared__ float smem[];
  const int Q = a.Q, Qp = (Q + kT - 1) / kT * kT;
  float* h_s = smem;                                   // [DS][HP]
  float* xd_s = h_s + DS * HP;                         // [Qp][HP]
  uint32_t* B_s = reinterpret_cast<uint32_t*>(xd_s + Qp * HP);  // [Qp][W]
  uint32_t* C_s = B_s + Qp * W;                        // [kT][W]
  float* G_s = reinterpret_cast<float*>(C_s + kT * W); // [kT][GW]
  float* dt_s = G_s + kT * GW;                         // [Qp]
  float* acs_s = dt_s + Qp;                            // [Qp]
  float* eacs_s = acs_s + Qp;                          // exp(acs)
  float* dec_s = eacs_s + Qp;                          // exp(acs_end - acs)

  const int head = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int ty = tid / kGrid, tx = tid % kGrid;
  const int S = a.S, nh = a.nh;
  const float A = -expf(a.A_log[head]);
  const size_t hoff = ((size_t)b * nh + head) * DS * HP;

  for (int i = tid; i < DS * HP; i += kThreads)
    h_s[i] = a.h0 != nullptr ? a.h0[hoff + i] : 0.f;

  const int n_chunks = (S + Q - 1) / Q;
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * Q;
    const int nv = min(Q, S - t0);                     // valid steps
    const size_t row0 = (size_t)b * S + t0;            // first (b, t) row

    // 1. the chunk: dt, xd = x * dt (fp32), B; zero past the valid steps
    for (int t = tid; t < Qp; t += kThreads)
      dt_s[t] = t < nv ? a.dt[(row0 + t) * nh + head] : 0.f;
    load_rows<DS>(B_s, a.Bm + row0 * DS, 0, Qp, nv);
    __syncthreads();
    for (int i = tid; i < Qp * (HP / 8); i += kThreads) {
      const int t = i / (HP / 8), v = i % (HP / 8);
      float* d = xd_s + t * HP + v * 8;
      if (t < nv) {
        const uint4 u = __ldg(reinterpret_cast<const uint4*>(
            a.x + ((row0 + t) * nh + head) * HP) + v);
        const float s = dt_s[t];
        const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          d[2 * j] = lo_bf16(w[j]) * s;
          d[2 * j + 1] = hi_bf16(w[j]) * s;
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) d[j] = 0.f;
      }
    }
    // the chunk's cumulative log-decay: lane-local sums, then a warp scan
    if (tid < 32) {
      const int per = Qp / 32, base = tid * per;
      float s = 0.f;
      for (int j = 0; j < per; ++j) {
        s += A * dt_s[base + j];
        acs_s[base + j] = s;
      }
      float incl = s;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, incl, d);
        if (tid >= d) incl += o;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (tid == 0) excl = 0.f;
      for (int j = 0; j < per; ++j) acs_s[base + j] += excl;
    }
    __syncthreads();
    const float acs_end = acs_s[nv - 1];
    for (int t = tid; t < Qp; t += kThreads) {
      eacs_s[t] = expf(acs_s[t]);
      dec_s[t] = expf(acs_end - acs_s[t]);
    }
    __syncthreads();

    // 2. y, one 64-step query tile at a time
    for (int q0 = 0; q0 < nv; q0 += kT) {
      load_rows<DS>(C_s, a.Cm + row0 * DS, q0, kT, nv);
      __syncthreads();
      float yacc[kRows][PJ];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < PJ; ++j) yacc[i][j] = 0.f;

      for (int k0 = 0; k0 <= q0; k0 += kT) {
        // scores of the tile, masked, times the decay
        float g[kRows][kRows];
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int j = 0; j < kRows; ++j) g[i][j] = 0.f;
#pragma unroll 4
        for (int w = 0; w < DS / 2; ++w) {
          float c0[kRows], c1[kRows], b0[kRows], b1[kRows];
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            const uint32_t cw = C_s[(ty + kGrid * i) * W + w];
            const uint32_t bw = B_s[(k0 + tx + kGrid * i) * W + w];
            c0[i] = lo_bf16(cw);
            c1[i] = hi_bf16(cw);
            b0[i] = lo_bf16(bw);
            b1[i] = hi_bf16(bw);
          }
#pragma unroll
          for (int i = 0; i < kRows; ++i)
#pragma unroll
            for (int j = 0; j < kRows; ++j) {
              g[i][j] = fmaf(c0[i], b0[j], g[i][j]);
              g[i][j] = fmaf(c1[i], b1[j], g[i][j]);
            }
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const int q = q0 + ty + kGrid * i;
#pragma unroll
          for (int j = 0; j < kRows; ++j) {
            const int k = k0 + tx + kGrid * j;
            G_s[(ty + kGrid * i) * GW + tx + kGrid * j] =
                k <= q ? g[i][j] * expf(acs_s[q] - acs_s[k]) : 0.f;
          }
        }
        __syncthreads();
        // y += G xd over the tile's valid keys (xd is zero past them)
        const int kend = min(kT, nv - k0);
        for (int kk = 0; kk < kend; ++kk) {
          float gv[kRows], xv[PJ];
#pragma unroll
          for (int i = 0; i < kRows; ++i)
            gv[i] = G_s[(ty + kGrid * i) * GW + kk];
#pragma unroll
          for (int j = 0; j < PJ; ++j)
            xv[j] = xd_s[(k0 + kk) * HP + tx + kGrid * j];
#pragma unroll
          for (int i = 0; i < kRows; ++i)
#pragma unroll
            for (int j = 0; j < PJ; ++j)
              yacc[i][j] = fmaf(gv[i], xv[j], yacc[i][j]);
        }
        __syncthreads();
      }

      // + exp(acs_q) C_q h, with the chunk's incoming h
      float ch[kRows][PJ];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < PJ; ++j) ch[i][j] = 0.f;
#pragma unroll 2
      for (int w = 0; w < DS / 2; ++w) {
        float c0[kRows], c1[kRows], h0v[PJ], h1v[PJ];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const uint32_t cw = C_s[(ty + kGrid * i) * W + w];
          c0[i] = lo_bf16(cw);
          c1[i] = hi_bf16(cw);
        }
#pragma unroll
        for (int j = 0; j < PJ; ++j) {
          h0v[j] = h_s[(2 * w) * HP + tx + kGrid * j];
          h1v[j] = h_s[(2 * w + 1) * HP + tx + kGrid * j];
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int j = 0; j < PJ; ++j) {
            ch[i][j] = fmaf(c0[i], h0v[j], ch[i][j]);
            ch[i][j] = fmaf(c1[i], h1v[j], ch[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int q = q0 + ty + kGrid * i;
        if (q >= nv) continue;
        uint16_t* yrow = a.y + ((row0 + q) * nh + head) * HP;
        const float e = eacs_s[q];
#pragma unroll
        for (int j = 0; j < PJ; ++j)
          yrow[tx + kGrid * j] = __bfloat16_as_ushort(
              __float2bfloat16_rn(yacc[i][j] + e * ch[i][j]));
      }
      __syncthreads();              // C_s and G_s are rewritten next tile
    }

    // 3. h' = exp(acs_end) h + sum_k (B_k exp(acs_end - acs_k)) xd_k^T; every
    // query tile has read h (the barrier above), each thread owns its cells
    float acc[NI][PJ];
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int j = 0; j < PJ; ++j) acc[i][j] = 0.f;
    for (int k = 0; k < nv; ++k) {
      const float dk = dec_s[k];
      float bn[NI], xv[PJ];
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        const int n = ty + kGrid * i;
        const uint32_t bw = B_s[k * W + n / 2];
        bn[i] = ((n & 1) ? hi_bf16(bw) : lo_bf16(bw)) * dk;
      }
#pragma unroll
      for (int j = 0; j < PJ; ++j) xv[j] = xd_s[k * HP + tx + kGrid * j];
#pragma unroll
      for (int i = 0; i < NI; ++i)
#pragma unroll
        for (int j = 0; j < PJ; ++j) acc[i][j] = fmaf(bn[i], xv[j], acc[i][j]);
    }
    const float e_end = expf(acs_end);
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int j = 0; j < PJ; ++j) {
        float* cell = h_s + (ty + kGrid * i) * HP + tx + kGrid * j;
        *cell = e_end * *cell + acc[i][j];
      }
    __syncthreads();                // the next chunk overwrites the tiles
  }

  for (int i = tid; i < DS * HP; i += kThreads) a.h[hoff + i] = h_s[i];
}

template <int HP, int DS>
int launch(const Args& a, int B, cudaStream_t stream) {
  using L = Layout<HP, DS>;
  const int Qp = (a.Q + kT - 1) / kT * kT;
  const size_t bytes = (size_t)L::words(Qp) * 4;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_kernel<HP, DS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        L::words(kMaxQ) * 4);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const dim3 grid(a.nh, B);
  ssd_kernel<HP, DS><<<grid, kThreads, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// x, Bm, Cm 16-byte aligned and contiguous; 1 <= Q <= 256; h0 may be null;
// B, nh >= 1.
extern "C" int ssd_scan_bf16(const void* x, const float* dt,
                             const float* A_log, const void* Bm,
                             const void* Cm, const float* h0, void* y,
                             float* h, int B, int S, int nh, int hp, int ds,
                             int Q, void* stream) {
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
  const cudaStream_t s = (cudaStream_t)stream;
  // mamba2-370m's widths, and its reduced config's
  if (hp == 64 && ds == 128) return launch<64, 128>(a, B, s);
  if (hp == 32 && ds == 32) return launch<32, 32>(a, B, s);
  return -1;
}
