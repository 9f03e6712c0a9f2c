// Grouped expert matmuls for the collaborative MoE FFN, written for Hopper.
//
// Replaces the JAX package's Pallas TPU kernels in
// src/repro/kernels/moe_gmm/moe_gmm.py:
//   moe_swiglu_gmm_bf16 <- swiglu_gmm (:82, body _swiglu_kernel :63):
//       out[g] = silu(x[g] @ w1[g]) * (x[g] @ w3[g])
//   moe_gmm_bf16        <- gmm (:41, body _gmm_kernel :26):
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
// One kernel serves both (ring::gmm_tma_kernel<NT, SWIGLU, BN>): the
// weights stream through an async ring into tensor-core products, one pass
// over K (16-byte loads in bursts of 16 KB an SM into fp32 FMAs on the
// CUDA cores, K split over 8 warps, reached 47% of the bound).
//   * work items are (group, x-row tile, BN output columns); the grid is
//     at most one wave of resident blocks (the occupancy the shared memory
//     allows, read once from the device), each walking a static list of
//     items (blockIdx.x, then + gridDim.x, ...). Its ring runs on across
//     item boundaries, so the next item's first tiles are in flight while
//     one item's accumulators are written out. Items are 128 columns for
//     swiglu (two blocks an SM: at the served shape 896 items, the last
//     wave's imbalance is a 128-column item, not a 256-column one) and 256
//     for gmm (128 items, one wave of one item a block);
//   * a 3-stage ring of [64 x BN] weight tiles in shared memory (two of
//     them a stage for swiglu: w1 and w3, both counted on the stage's one
//     mbarrier), filled by TMA: one thread asks for each stage as 2-D boxes
//     of w seen as [G*K, N] (64 rows x 64 columns, 128-byte swizzled,
//     zero-filled past the matrix); two stages are in flight per block
//     while one is multiplied, a continuous stream rather than bursts. The
//     [C x 64] x tile rides along by cp.async (16 B, zero-filled past K and
//     C), once a stage, shared by swiglu's two products. Rows of w past K
//     meet those zeros;
//   * products on the tensor cores with mma.sync m16n8k16 (bf16 in, fp32
//     accumulators): the output columns are the MMA's M (the weight tile is
//     operand A, loaded with ldmatrix.trans from the [K, N] tile; the
//     swizzle puts the 8 rows of each 8x8 matrix in distinct banks), the x
//     rows its N (C = 8 is exactly n = 8; a larger C takes up to 8 n-tiles
//     in one block, so the weights are still read once). swiglu keeps two
//     accumulator sets, one per weight stream (NT = 8: 239 registers, no
//     spill). mma.sync and not wgmma: with n = 8 the product is 16 flop per
//     weight byte, the tensor cores idle either way, and mma.sync needs no
//     warpgroup descriptors;
//   * the fp32 accumulators are rounded to bf16 once (swiglu: silu(a1) *
//     a3 in fp32 first) and written out. No atomics: bitwise equal run to
//     run;
//   * ragged C, K and N are masked. N or K not a multiple of 8, or a
//     misaligned pointer, takes gmm_scalar_kernel, which loads each tile
//     with masked scalar loads (TMA needs 16-byte row strides).
// Measured and dropped (PERF.md, section 6): for gmm, split K over blocks
// (fp32 partials summed in order by a second pass) at every split count
// from 2 to 5; for swiglu at the served shape, 256-column items one a
// block (0.612-0.614 ms), 128-column items one a block (0.607-0.608) and a
// persistent grid of 256-column items (0.607-0.621), against 0.598-0.602
// for the persistent grid of 128-column items kept. gmm ran its fastest
// with 256-column items (0.287-0.296 ms, against 0.299 at 128).

// Each entry launches on the given stream, allocates nothing and returns
// cudaGetLastError() (0 = launched).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma.cuh"
#include "warp_mma.cuh"

namespace ring {

using namespace wmma_sync;

constexpr int kBK = 64;                    // K rows per ring stage
constexpr int kStages = 3;
constexpr int kScalarBN = 256;             // scalar path's columns a block
constexpr int kWPitch = kScalarBN + 8;     // bf16, scalar path: rows 16 B
                                           // off the banks
constexpr int kXPitch = kBK + 8;           // bf16; 144-byte rows
static_assert(kBK % 16 == 0, "block shape");

// The products of one ring stage: wt is the stage's [kBK x BN] weight
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

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[2][NT][4]) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
}

// Accumulator e of (mt, nt): output column n0 + warp*32 + mt*16 + gid (+8
// for e >= 2), x row c0 + nt*8 + tig*2 (+1 for odd e), rounded once: a1,
// or silu(a1) * a3 for swiglu.
template <int NT, bool SWIGLU>
__device__ __forceinline__ void store_acc(const float (&a1)[2][NT][4],
                                          const float (&a3)[2][NT][4],
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
        float v = a1[mt][nt][e];
        if (SWIGLU) v = v * (1.f / (1.f + expf(-v))) * a3[mt][nt][e];
        out[((size_t)g * C + c) * N + n] =
            __bfloat16_as_ushort(__float2bfloat16_rn(v));
      }
}

// The path for shapes TMA does not take (N or K not a multiple of 8, or a
// misaligned pointer): one block per (output columns [n0, n0 + 256), x
// rows [c0, c0 + 8 NT), group g), each [kBK x 256] weight tile and its x
// tile loaded with plain masked loads, then multiplied as in the TMA
// kernel; swiglu's two weight tiles take turns in one buffer. Not on the
// serving path.
template <int NT, bool SWIGLU>
__global__ void __launch_bounds__(kScalarBN)
gmm_scalar_kernel(const uint16_t* __restrict__ x,
                  const uint16_t* __restrict__ w1,
                  const uint16_t* __restrict__ w3, uint16_t* __restrict__ out,
                  int C, int K, int N) {
  constexpr int BC = 8 * NT, NMAT = SWIGLU ? 2 : 1;
  __shared__ __align__(16) uint16_t wt[kBK * kWPitch];
  __shared__ __align__(16) uint16_t xt[BC * kXPitch];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * kScalarBN, c0 = blockIdx.y * BC;
  const int g = blockIdx.z;
  const uint16_t* xg = x + (size_t)g * C * K;

  float acc1[2][NT][4], acc3[2][NT][4];
  zero(acc1);
  zero(acc3);
  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int i = tid; i < BC * kBK; i += kScalarBN) {
      const int r = i / kBK, cc = i % kBK;
      const int c = c0 + r, k = k0 + cc;
      xt[r * kXPitch + cc] =
          (c < C && k < K) ? xg[(size_t)c * K + k] : (uint16_t)0;
    }
#pragma unroll
    for (int m = 0; m < NMAT; ++m) {
      const uint16_t* wg = (m == 0 ? w1 : w3) + (size_t)g * K * N;
      for (int i = tid; i < kBK * kScalarBN; i += kScalarBN) {
        const int r = i / kScalarBN, cc = i % kScalarBN;
        const int k = k0 + r, n = n0 + cc;
        wt[r * kWPitch + cc] =
            (k < K && n < N) ? wg[(size_t)k * N + n] : (uint16_t)0;
      }
      __syncthreads();
      if (m == 0) mma_stage<NT, false>(wt, xt, acc1, lane, warp);
      else mma_stage<NT, false>(wt, xt, acc3, lane, warp);
      __syncthreads();
    }
  }
  store_acc<NT, SWIGLU>(acc1, acc3, out, C, N, g, c0, n0, lane, warp);
}

// -- the TMA path: weight tiles as 2-D boxes with an mbarrier per stage -----

template <int NT, bool SWIGLU, int BN>     // NT n-tiles: 8 * NT x rows
constexpr int tma_smem_bytes() {
  return 1024 + kStages * ((SWIGLU ? 2 : 1) * kBK * BN + 8 * NT * kXPitch) *
                    2 + kStages * 8;
}

// The serving path: the weights as TMA boxes, w seen as [G*K, N] rows,
// boxes of [kBK rows x 64 columns], 128-byte swizzled (conflict-free
// ldmatrix without padding). Rows past K read the next group's rows of w,
// which meet x's zero-filled columns; rows and columns past the matrix are
// zero-filled by TMA. Needs N and K multiples of 8 and aligned pointers.
// BN / 32 warps, each owning 32 output columns of an item.
template <int NT, bool SWIGLU, int BN>
__global__ void __launch_bounds__(BN)
gmm_tma_kernel(const __grid_constant__ CUtensorMap w1map,
               const __grid_constant__ CUtensorMap w3map,
               const uint16_t* __restrict__ x, uint16_t* __restrict__ out,
               int G, int C, int K, int N) {
  constexpr int BC = 8 * NT, NMAT = SWIGLU ? 2 : 1;
  constexpr int kWTile = kBK * BN;                 // elements, dense
  constexpr int kWStage = NMAT * kWTile;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* wsm = reinterpret_cast<uint16_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint16_t* xsm = wsm + kStages * kWStage;         // [kStages][BC][kXPitch]
  uint64_t* full = reinterpret_cast<uint64_t*>(xsm + kStages * BC * kXPitch);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ntiles = (N + BN - 1) / BN, ctiles = (C + BC - 1) / BC;
  const int items = G * ctiles * ntiles;
  const int ksteps = (K + kBK - 1) / kBK;
  const int mine = (int)blockIdx.x < items
                       ? (items - 1 - (int)blockIdx.x) / (int)gridDim.x + 1
                       : 0;
  const int total = mine * ksteps;                 // this block's steps

  // item j of this block: (group, x-row tile, column tile), columns fastest
  auto decode = [&](int j, int& g, int& c0, int& n0) {
    const int item = blockIdx.x + j * gridDim.x;
    const int nt = item % ntiles, rest = item / ntiles;
    n0 = nt * BN;
    c0 = (rest % ctiles) * BC;
    g = rest / ctiles;
  };

  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) tma::mbar_init(&full[i], 1);
    tma::mbar_init_fence();
  }
  __syncthreads();

  auto load = [&](int step) {
    const int j = step / ksteps, k0 = (step - j * ksteps) * kBK;
    const int st = step % kStages;
    int g, c0, n0;
    decode(j, g, c0, n0);
    uint16_t* wd = wsm + st * kWStage;
    if (tid == 0) {
      tma::mbar_expect_tx(&full[st], kWStage * 2);
#pragma unroll
      for (int bx = 0; bx < BN / tma::kBoxCols; ++bx) {
        tma::load_2d(wd + bx * kBK * tma::kBoxCols, &w1map,
                     n0 + bx * tma::kBoxCols, g * K + k0, &full[st]);
        if (SWIGLU)
          tma::load_2d(wd + kWTile + bx * kBK * tma::kBoxCols, &w3map,
                       n0 + bx * tma::kBoxCols, g * K + k0, &full[st]);
      }
    }
    const uint16_t* xg = x + (size_t)g * C * K;
    uint16_t* xd = xsm + st * BC * kXPitch;
    for (int i = tid; i < BC * (kBK / 8); i += BN) {
      const int r = i / (kBK / 8), cc = i % (kBK / 8);
      const int c = c0 + r, k = k0 + cc * 8;
      const bool ok = c < C && k < K;
      cp_async16(xd + r * kXPitch + cc * 8,
                 ok ? xg + (size_t)c * K + k : xg, ok ? 16 : 0);
    }
  };

  float acc1[2][NT][4], acc3[2][NT][4];
  zero(acc1);
  if (SWIGLU) zero(acc3);

#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < total) load(t);
    cp_async_commit();
  }
  for (int t = 0; t < total; ++t) {
    const int st = t % kStages;
    cp_async_wait<kStages - 2>();            // x of stage t
    tma::mbar_wait(&full[st], (t / kStages) & 1);   // w of t
    __syncthreads();                         // everywhere; t-1 is free
    if (t + kStages - 1 < total) load(t + kStages - 1);
    cp_async_commit();
    const uint16_t* xt = xsm + st * BC * kXPitch;
    mma_stage<NT, true>(wsm + st * kWStage, xt, acc1, lane, warp);
    if (SWIGLU)
      mma_stage<NT, true>(wsm + st * kWStage + kWTile, xt, acc3, lane, warp);
    if ((t + 1) % ksteps == 0) {             // the item's last K step
      int g, c0, n0;
      decode(t / ksteps, g, c0, n0);
      store_acc<NT, SWIGLU>(acc1, acc3, out, C, N, g, c0, n0, lane, warp);
      zero(acc1);
      if (SWIGLU) zero(acc3);
    }
  }
  cp_async_wait<0>();
}

// Blocks of the kernel that fit on the card at once (the shared memory
// decides: one or two an SM), found once; its shared-memory limit is
// raised on the way.
template <int NT, bool SWIGLU, int BN>
int resident_blocks() {
  static int blocks = 0;
  if (blocks == 0) {
    constexpr int smem = tma_smem_bytes<NT, SWIGLU, BN>();
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaFuncSetAttribute(
        gmm_tma_kernel<NT, SWIGLU, BN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, gmm_tma_kernel<NT, SWIGLU, BN>, BN, smem);
    if (e != cudaSuccess) return -(int)e;
    if (per_sm * sms <= 0) return -(int)cudaErrorInvalidConfiguration;
    blocks = per_sm * sms;
  }
  return blocks;
}

int encode(CUtensorMap* map, const void* w, int G, int K, int N) {
  const cuuint64_t dims[2] = {(cuuint64_t)N, (cuuint64_t)G * K};
  const cuuint64_t strides[1] = {(cuuint64_t)N * 2};
  const cuuint32_t box[2] = {tma::kBoxCols, (cuuint32_t)kBK};
  return tma::encode_bf16(map, w, 2, dims, strides, box);
}

// One wave of resident blocks, each walking every gridDim-th item (one
// item a block where there are fewer items than that).
template <int NT, bool SWIGLU, int BN>
int launch_tma(const void* x, const void* w1, const void* w3, void* out,
               int G, int C, int K, int N, cudaStream_t stream) {
  CUtensorMap map1, map3;                  // w as [G*K rows, N columns]
  int err = encode(&map1, w1, G, K, N);
  if (err == 0) err = encode(&map3, SWIGLU ? w3 : w1, G, K, N);
  if (err != 0) return err;
  const int resident = resident_blocks<NT, SWIGLU, BN>();
  if (resident <= 0) return -resident;
  const long items = (long)G * ((C + 8 * NT - 1) / (8 * NT)) *
                     ((N + BN - 1) / BN);
  const int grid = (int)(items < resident ? items : resident);
  gmm_tma_kernel<NT, SWIGLU, BN>
      <<<grid, BN, tma_smem_bytes<NT, SWIGLU, BN>(), stream>>>(
          map1, map3, (const uint16_t*)x, (uint16_t*)out, G, C, K, N);
  return (int)cudaGetLastError();
}

// Items of 128 columns for swiglu (two weight streams: the finer items
// balance the last wave), 256 for gmm (PERF.md, section 6).
template <int NT, bool SWIGLU>
int launch_nt(bool vec, const void* x, const void* w1, const void* w3,
              void* out, int G, int C, int K, int N, cudaStream_t stream) {
  if (vec)
    return launch_tma<NT, SWIGLU, SWIGLU ? 128 : 256>(x, w1, w3, out, G, C,
                                                      K, N, stream);
  const dim3 grid((N + kScalarBN - 1) / kScalarBN,
                  (C + 8 * NT - 1) / (8 * NT), G);
  gmm_scalar_kernel<NT, SWIGLU><<<grid, kScalarBN, 0, stream>>>(
      (const uint16_t*)x, (const uint16_t*)w1, (const uint16_t*)w3,
      (uint16_t*)out, C, K, N);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// NT = 1, 2, 4, 8 n-tiles of x rows by C, as few as hold C (the weights
// are read once for up to 64 rows).
template <bool SWIGLU>
int dispatch(const void* x, const void* w1, const void* w3, void* out, int G,
             int C, int K, int N, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const bool vec = N % 8 == 0 && K % 8 == 0 && aligned16(x) &&
                   aligned16(w1) && aligned16(w3) && aligned16(out);
  if (C <= 8) return launch_nt<1, SWIGLU>(vec, x, w1, w3, out, G, C, K, N, s);
  if (C <= 16) return launch_nt<2, SWIGLU>(vec, x, w1, w3, out, G, C, K, N, s);
  if (C <= 32) return launch_nt<4, SWIGLU>(vec, x, w1, w3, out, G, C, K, N, s);
  return launch_nt<8, SWIGLU>(vec, x, w1, w3, out, G, C, K, N, s);
}

}  // namespace ring

extern "C" int moe_swiglu_gmm_bf16(const void* x, const void* w1,
                                   const void* w3, void* out, int G, int C,
                                   int K, int N, void* stream) {
  return ring::dispatch<true>(x, w1, w3, out, G, C, K, N, stream);
}

extern "C" int moe_gmm_bf16(const void* x, const void* w, void* out, int G,
                            int C, int K, int N, void* stream) {
  return ring::dispatch<false>(x, w, w, out, G, C, K, N, stream);
}
