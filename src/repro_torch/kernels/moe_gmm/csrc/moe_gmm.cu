// Grouped expert matmuls for the collaborative MoE FFN, written for Hopper.
//
// Replaces the JAX package's Pallas TPU kernels in
// src/repro/kernels/moe_gmm/moe_gmm.py:
//   moe_swiglu_gmm_bf16 <- swiglu_gmm (_swiglu_kernel):
//       out[g] = silu(x[g] @ w1[g]) * (x[g] @ w3[g])
//   moe_gmm_bf16        <- gmm (_gmm_kernel):
//       out[g] = x[g] @ w[g]
// x [G, C, K], w [G, K, N], out [G, C, N], all bf16 and contiguous. Both
// keep the reference's rounding points: fp32 accumulators, silu applied to
// the fp32 gate accumulator, ONE rounding to bf16 at the end.
//
// What bounds them on an H100. On the decode path C = T*K assignments (8
// at 4 slots, top-2), so each weight element meets at most C rows: about
// 2*C = 16 flop per 2 bytes read, far below the ~295 flop/byte where the
// tensor cores become the limit. At the main path's shapes (G = 8, C = 8,
// K = 4096, N = 14336) swiglu reads 1.88 GB of w1+w3 and gmm 0.94 GB of w2
// for ~15 GFLOP, so the bound is bytes: ~0.56 ms and ~0.28 ms at 3.35 TB/s.
//
// swiglu_gmm (grouped_kernel<true>):
//   * every weight element is read exactly once per (group, C-tile of 8
//     rows), along N (the contiguous axis of [K, N]) with 16-byte loads,
//     neighbouring lanes on neighbouring addresses;
//   * each thread keeps kUnroll rows of loads in flight before it uses
//     them, so enough bytes are outstanding per SM to cover HBM latency;
//   * the group's x rows sit in shared memory (as fp32, a K chunk at a
//     time) and every accumulator lives in registers; swiglu keeps its two
//     accumulators side by side and reads the x tile once for both;
//   * the 8 warps of a block split K and reduce through shared memory in
//     a fixed order, so results are deterministic run to run;
//   * ragged C, K and N are masked in the kernel (no padding to a tile:
//     padding C = 8 to the TPU's 128 would multiply the work by 16). N not
//     a multiple of 8, or a misaligned pointer, takes a scalar-load path.
//   Not yet used there: tensor cores and an async ring (gmm has both).
//
// gmm (ring::gmm_tma_kernel): stream the weights through an async ring,
// multiply on tensor cores, one pass over K.
//   * grid (N tiles of 256, C tiles, G): at the down-projection (G = 8,
//     C = 8, K = 14336, N = 4096) 128 blocks of 256 threads, one an SM,
//     each walking all of K for its 256 columns;
//   * a 3-stage ring of [64 x 256] weight tiles in shared memory, filled
//     by TMA: one thread asks for each stage as four 2-D boxes of w seen as
//     [G*K, N] (64 rows x 64 columns, 128-byte swizzled, zero-filled past
//     the matrix) counted on the stage's mbarrier; two stages (64 KB) are
//     in flight per SM while one is multiplied, continuously rather than
//     in bursts of 16 KB an SM as swiglu_gmm's loads are. The [C x 64] x
//     tiles ride along by cp.async (16 B, zero-filled past K and C). Rows
//     of w past K meet those zeros;
//   * products on the tensor cores with mma.sync m16n8k16 (bf16 in, fp32
//     accumulators): the output columns are the MMA's M (the weight tile is
//     operand A, loaded with ldmatrix.trans from the [K, N] tile; the
//     swizzle puts the 8 rows of each 8x8 matrix in distinct banks), the x
//     rows its N (C = 8 is exactly n = 8; a larger C takes up to 8 n-tiles
//     in one block, so the weights are still read once). mma.sync and not
//     wgmma: with n = 8 the product is 16 flop per weight byte, the tensor
//     cores idle either way, and mma.sync needs no warpgroup descriptors.
//     They replace 3.8 G fp32 FMAs on the CUDA cores, with a bf16 unpack
//     and a shared load of x per 8 of them;
//   * the fp32 accumulators are rounded to bf16 once and written out (the
//     reference's rounding point). No atomics: bitwise equal run to run;
//   * ragged C, K and N are masked. N or K not a multiple of 8, or a
//     misaligned pointer, takes gmm_scalar_kernel, which loads each tile
//     with masked scalar loads (TMA needs 16-byte row strides).
// Split K over blocks (fp32 partials in a workspace, summed in order by a
// second pass) was built and measured: at the down-projection every split
// count from 2 to 5 ran slower than one split, with 128-column tiles in 4
// or 6 stages and with these 256-column tiles in 3 (PERF.md, section 6),
// so the kernel has none.

// Each entry launches on the given stream, allocates nothing and returns
// cudaGetLastError() (0 = launched).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;      // warps split the K axis
constexpr int kCols = 8;                   // bf16 columns per 16-byte load
constexpr int kBN = 32 * kCols;            // 256 output columns per block
constexpr int kBM = 8;                     // x rows (C) per block
constexpr int kKT = 512;                   // K chunk of x held in smem
constexpr int kUnroll = 4;                 // weight rows in flight per thread
static_assert(kWarps == kBM, "epilogue maps one warp to one output row");

__device__ __forceinline__ float bf16_bits_to_float(uint32_t bits) {
  return __uint_as_float(bits << 16);
}

__device__ __forceinline__ void unpack8(const uint4& r, float* f) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Eight consecutive bf16 of row k starting at column col, zero where masked.
__device__ __forceinline__ uint4 load_row(const uint16_t* __restrict__ w,
                                          int k, bool ok, int col, int N,
                                          bool vec) {
  uint4 r = make_uint4(0u, 0u, 0u, 0u);
  if (!ok || col >= N) return r;
  const uint16_t* p = w + (size_t)k * N + col;
  if (vec) {                       // N % 8 == 0, so col < N => col + 8 <= N
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  uint32_t h[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) h[j] = (col + j < N) ? p[j] : 0u;
  r.x = h[0] | (h[1] << 16);
  r.y = h[2] | (h[3] << 16);
  r.z = h[4] | (h[5] << 16);
  r.w = h[6] | (h[7] << 16);
  return r;
}

// Only grouped_kernel<true> (swiglu_gmm) is instantiated now: gmm moved to
// ring::gmm_tma_kernel, so the NMAT = 1 branches are unused until the
// swiglu_gmm redesign folds the template.
template <bool SWIGLU>
__global__ void __launch_bounds__(kThreads)
grouped_kernel(const uint16_t* __restrict__ x, const uint16_t* __restrict__ w1,
               const uint16_t* __restrict__ w3, uint16_t* __restrict__ out,
               int C, int K, int N, bool vec) {
  constexpr int NMAT = SWIGLU ? 2 : 1;
  __shared__ float xs[kBM][kKT];
  __shared__ float red[NMAT][kBM][kBN];

  const int g = blockIdx.z;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int col = n0 + lane * kCols;
  const int rows = min(kBM, C - m0);

  const uint16_t* xg = x + ((size_t)g * C + m0) * K;
  const uint16_t* wg[NMAT];
  wg[0] = w1 + (size_t)g * K * N;
  if (SWIGLU) wg[NMAT - 1] = w3 + (size_t)g * K * N;

  float acc[NMAT][kBM][kCols];
#pragma unroll
  for (int t = 0; t < NMAT; ++t)
#pragma unroll
    for (int m = 0; m < kBM; ++m)
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[t][m][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kKT) {
    const int kt = min(kKT, K - k0);
    __syncthreads();                         // previous chunk consumed
    for (int i = threadIdx.x; i < kBM * kKT; i += kThreads) {
      const int m = i / kKT, k = i % kKT;
      xs[m][k] = (m < rows && k < kt)
                     ? bf16_bits_to_float(xg[(size_t)m * K + k0 + k])
                     : 0.f;
    }
    __syncthreads();
    for (int kb = warp; kb < kt; kb += kWarps * kUnroll) {
      uint4 raw[kUnroll][NMAT];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int k = kb + u * kWarps;
#pragma unroll
        for (int t = 0; t < NMAT; ++t)
          raw[u][t] = load_row(wg[t], k0 + k, k < kt, col, N, vec);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int k = kb + u * kWarps;
        if (k < kt) {
#pragma unroll
          for (int t = 0; t < NMAT; ++t) {
            float wf[kCols];
            unpack8(raw[u][t], wf);
#pragma unroll
            for (int m = 0; m < kBM; ++m) {
              const float xv = xs[m][k];
#pragma unroll
              for (int j = 0; j < kCols; ++j)
                acc[t][m][j] = fmaf(xv, wf[j], acc[t][m][j]);
            }
          }
        }
      }
    }
  }

  // Fixed-order reduction of the warps' partial sums over K.
  for (int s = 0; s < kWarps; ++s) {
    if (warp == s) {
#pragma unroll
      for (int t = 0; t < NMAT; ++t)
#pragma unroll
        for (int m = 0; m < kBM; ++m)
#pragma unroll
          for (int j = 0; j < kCols; ++j) {
            float* r = &red[t][m][lane * kCols + j];
            *r = (s == 0) ? acc[t][m][j] : *r + acc[t][m][j];
          }
    }
    __syncthreads();
  }

  const int m = warp;
  if (m >= rows || col >= N) return;
  uint32_t h[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    const float a = red[0][m][lane * kCols + j];
    float o = a;
    if (SWIGLU) o = a * (1.f / (1.f + expf(-a))) * red[NMAT - 1][m][lane * kCols + j];
    h[j] = __bfloat16_as_ushort(__float2bfloat16_rn(o));
  }
  uint16_t* og = out + ((size_t)g * C + m0 + m) * N + col;
  if (vec) {
    *reinterpret_cast<uint4*>(og) = make_uint4(
        h[0] | (h[1] << 16), h[2] | (h[3] << 16), h[4] | (h[5] << 16),
        h[6] | (h[7] << 16));
  } else {
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      if (col + j < N) og[j] = (uint16_t)h[j];
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <bool SWIGLU>
int launch(const void* x, const void* w1, const void* w3, void* out, int G,
           int C, int K, int N, void* stream) {
  const bool vec = (N % kCols == 0) && aligned16(w1) && aligned16(out) &&
                   (!SWIGLU || aligned16(w3));
  const dim3 grid((N + kBN - 1) / kBN, (C + kBM - 1) / kBM, G);
  grouped_kernel<SWIGLU><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint16_t*)x, (const uint16_t*)w1, (const uint16_t*)w3,
      (uint16_t*)out, C, K, N, vec);
  return (int)cudaGetLastError();
}

}  // namespace

namespace ring {

constexpr int kBN = 256;                   // output columns per block
constexpr int kThreads = kBN;              // one warp per 32 columns
constexpr int kBK = 64;                    // K rows per ring stage
constexpr int kStages = 3;
constexpr int kWPitch = kBN + 8;           // bf16, scalar path: rows 16 B
                                           // off the banks
static_assert(kThreads % 32 == 0 && kBK % 16 == 0, "block shape");
constexpr int kXPitch = kBK + 8;           // bf16; 144-byte rows

// 16 bytes from device to shared memory, zero-filled past src_bytes (0
// skips the read: the ragged edge of a tile).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(tma::smem_u32(dst)), "l"(src), "r"(src_bytes)
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

// A: the four 8x8 blocks of a 16x16 bf16 tile stored k-major ([k][m]),
// delivered transposed, i.e. as the row-major (m, k) fragment of mma.sync.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const uint16_t* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a) : "memory");
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The products of one ring stage: wt is the stage's [kBK x kBN] weight
// tile, padded rows (SWZ false) or TMA's 128-byte-swizzled boxes of 64
// columns (SWZ true); xt its [8 NT x kBK] x tile. Warp w owns output
// columns [32 w, 32 w + 32): two m16 tiles, NT n8 tiles.
template <int NT, bool SWZ>
__device__ __forceinline__ void mma_stage(const uint16_t* wt,
                                          const uint16_t* xt,
                                          float (&acc)[2][NT][4], int lane,
                                          int warp) {
  // this lane's ldmatrix row: matrix q = lane / 8 holds k half q / 2 and
  // m half q % 2 of the 16x16 tile
  const int a_row = (lane >> 4) * 8 + (lane & 7);
  const int a_col = warp * 32 + ((lane >> 3) & 1) * 8;
  const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int kk = 0; kk < kBK; kk += 16) {
    uint32_t a[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int r = kk + a_row, n = a_col + mt * 16;
      const uint16_t* p;
      if (SWZ) {                      // box n / 64, chunk (n % 64) / 8
        p = wt + (n >> 6) * (kBK * tma::kBoxCols) +
            tma::swizzled(r, (n & 63) >> 3);
      } else {
        p = wt + r * kWPitch + n;
      }
      ldmatrix_x4_trans(a[mt], p);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const uint16_t* xr = xt + (nt * 8 + gid) * kXPitch + kk + tig * 2;
      uint32_t b[2];
      b[0] = *reinterpret_cast<const uint32_t*>(xr);
      b[1] = *reinterpret_cast<const uint32_t*>(xr + 8);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) mma_bf16(acc[mt][nt], a[mt], b);
    }
  }
}

// Accumulator e of (mt, nt): output column n0 + warp*32 + mt*16 + gid (+8
// for e >= 2), x row c0 + nt*8 + tig*2 (+1 for odd e), rounded once.
template <int NT>
__device__ __forceinline__ void store_acc(const float (&acc)[2][NT][4],
                                          uint16_t* out, int C, int N, int g,
                                          int c0, int n0, int lane,
                                          int warp) {
  const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = n0 + warp * 32 + mt * 16 + gid + (e >> 1) * 8;
        const int c = c0 + nt * 8 + tig * 2 + (e & 1);
        if (n >= N || c >= C) continue;
        out[((size_t)g * C + c) * N + n] =
            __bfloat16_as_ushort(__float2bfloat16_rn(acc[mt][nt][e]));
      }
}

// The path for shapes TMA does not take (N or K not a multiple of 8, or a
// misaligned pointer): one block per (output columns [n0, n0 + kBN), x
// rows [c0, c0 + 8 NT), group g), each [kBK x kBN] weight tile and its x
// tile loaded with plain masked loads, then multiplied as in the TMA
// kernel. Not on the serving path.
template <int NT>
__global__ void __launch_bounds__(kThreads)
gmm_scalar_kernel(const uint16_t* __restrict__ x,
                  const uint16_t* __restrict__ w, uint16_t* __restrict__ out,
                  int C, int K, int N) {
  constexpr int BC = 8 * NT;
  __shared__ __align__(16) uint16_t wt[kBK * kWPitch];
  __shared__ __align__(16) uint16_t xt[BC * kXPitch];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * kBN, c0 = blockIdx.y * BC, g = blockIdx.z;
  const uint16_t* xg = x + (size_t)g * C * K;
  const uint16_t* wg = w + (size_t)g * K * N;

  float acc[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int i = tid; i < kBK * kBN; i += kThreads) {
      const int r = i / kBN, cc = i % kBN;
      const int k = k0 + r, n = n0 + cc;
      wt[r * kWPitch + cc] =
          (k < K && n < N) ? wg[(size_t)k * N + n] : (uint16_t)0;
    }
    for (int i = tid; i < BC * kBK; i += kThreads) {
      const int r = i / kBK, cc = i % kBK;
      const int c = c0 + r, k = k0 + cc;
      xt[r * kXPitch + cc] =
          (c < C && k < K) ? xg[(size_t)c * K + k] : (uint16_t)0;
    }
    __syncthreads();
    mma_stage<NT, false>(wt, xt, acc, lane, warp);
    __syncthreads();
  }
  store_acc<NT>(acc, out, C, N, g, c0, n0, lane, warp);
}

// -- the TMA path: weight tiles as 2-D boxes with an mbarrier per stage -----

template <int NT>                          // NT n-tiles: 8 * NT x rows
constexpr int tma_smem_bytes() {
  return 1024 + kStages * (kBK * kBN + 8 * NT * kXPitch) * 2 + kStages * 8;
}

// The serving path: the weights as TMA boxes, w seen as [G*K, N] rows,
// boxes of [kBK rows x 64 columns], 128-byte swizzled (conflict-free
// ldmatrix without padding). Rows past K read the next group's rows of w,
// which meet x's zero-filled columns; rows and columns past the matrix are
// zero-filled by TMA. Needs N and K multiples of 8 and aligned pointers.
template <int NT>
__global__ void __launch_bounds__(kThreads)
gmm_tma_kernel(const __grid_constant__ CUtensorMap wmap,
               const uint16_t* __restrict__ x, uint16_t* __restrict__ out,
               int C, int K, int N) {
  constexpr int BC = 8 * NT;
  constexpr int kWStage = kBK * kBN;               // elements, dense
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* wsm = reinterpret_cast<uint16_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint16_t* xsm = wsm + kStages * kWStage;         // [kStages][BC][kXPitch]
  uint64_t* full = reinterpret_cast<uint64_t*>(xsm + kStages * BC * kXPitch);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * kBN, c0 = blockIdx.y * BC, g = blockIdx.z;
  const int steps = (K + kBK - 1) / kBK;
  const uint16_t* xg = x + (size_t)g * C * K;

  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) tma::mbar_init(&full[i], 1);
    tma::mbar_init_fence();
  }
  __syncthreads();

  auto load = [&](int step) {
    const int k0 = step * kBK, st = step % kStages;
    if (tid == 0) {
      tma::mbar_expect_tx(&full[st], kWStage * 2);
#pragma unroll
      for (int bx = 0; bx < kBN / tma::kBoxCols; ++bx)
        tma::load_2d(wsm + st * kWStage + bx * kBK * tma::kBoxCols, &wmap,
                     n0 + bx * tma::kBoxCols, g * K + k0, &full[st]);
    }
    uint16_t* xd = xsm + st * BC * kXPitch;
    for (int i = tid; i < BC * (kBK / 8); i += kThreads) {
      const int r = i / (kBK / 8), cc = i % (kBK / 8);
      const int c = c0 + r, k = k0 + cc * 8;
      const bool ok = c < C && k < K;
      cp_async16(xd + r * kXPitch + cc * 8,
                 ok ? xg + (size_t)c * K + k : xg, ok ? 16 : 0);
    }
  };

  float acc[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < steps) load(t);
    cp_async_commit();
  }
  for (int t = 0; t < steps; ++t) {
    cp_async_wait<kStages - 2>();            // x of stage t
    tma::mbar_wait(&full[t % kStages], (t / kStages) & 1);   // w of t
    __syncthreads();                         // everywhere; t-1 is free
    if (t + kStages - 1 < steps) load(t + kStages - 1);
    cp_async_commit();
    mma_stage<NT, true>(wsm + (t % kStages) * kWStage,
                        xsm + (t % kStages) * BC * kXPitch, acc, lane, warp);
  }
  cp_async_wait<0>();
  store_acc<NT>(acc, out, C, N, g, c0, n0, lane, warp);
}

// Whether the TMA kernel's shared-memory limit has been raised.
template <int NT>
bool smem_raised = false;

template <int NT>
int launch_tma(const void* x, const void* w, void* out, int G, int C, int K,
               int N, cudaStream_t stream) {
  CUtensorMap map;                     // w as [G*K rows, N columns]
  const cuuint64_t dims[2] = {(cuuint64_t)N, (cuuint64_t)G * K};
  const cuuint64_t strides[1] = {(cuuint64_t)N * 2};
  const cuuint32_t box[2] = {tma::kBoxCols, (cuuint32_t)kBK};
  const int err = tma::encode_bf16(&map, w, 2, dims, strides, box);
  if (err != 0) return err;
  constexpr int smem = tma_smem_bytes<NT>();
  if (!smem_raised<NT>) {
    const cudaError_t e = cudaFuncSetAttribute(
        gmm_tma_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
    smem_raised<NT> = true;
  }
  const dim3 grid((N + kBN - 1) / kBN, (C + 8 * NT - 1) / (8 * NT), G);
  gmm_tma_kernel<NT><<<grid, kThreads, smem, stream>>>(
      map, (const uint16_t*)x, (uint16_t*)out, C, K, N);
  return (int)cudaGetLastError();
}

template <int NT>
int launch_nt(bool vec, const void* x, const void* w, void* out, int G,
              int C, int K, int N, cudaStream_t stream) {
  if (vec) return launch_tma<NT>(x, w, out, G, C, K, N, stream);
  const dim3 grid((N + kBN - 1) / kBN, (C + 8 * NT - 1) / (8 * NT), G);
  gmm_scalar_kernel<NT><<<grid, kThreads, 0, stream>>>(
      (const uint16_t*)x, (const uint16_t*)w, (uint16_t*)out, C, K, N);
  return (int)cudaGetLastError();
}

}  // namespace ring

extern "C" int moe_swiglu_gmm_bf16(const void* x, const void* w1,
                                   const void* w3, void* out, int G, int C,
                                   int K, int N, void* stream) {
  return launch<true>(x, w1, w3, out, G, C, K, N, stream);
}

extern "C" int moe_gmm_bf16(const void* x, const void* w, void* out, int G,
                            int C, int K, int N, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const bool vec = N % 8 == 0 && K % 8 == 0 && aligned16(x) && aligned16(w) &&
                   aligned16(out);
  if (C <= 8) return ring::launch_nt<1>(vec, x, w, out, G, C, K, N, s);
  if (C <= 16) return ring::launch_nt<2>(vec, x, w, out, G, C, K, N, s);
  if (C <= 32) return ring::launch_nt<4>(vec, x, w, out, G, C, K, N, s);
  return ring::launch_nt<8>(vec, x, w, out, G, C, K, N, s);
}
