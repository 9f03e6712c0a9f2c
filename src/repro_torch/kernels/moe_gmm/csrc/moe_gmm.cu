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
// What the design does about it:
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
// Not yet used: wgmma, TMA, a producer/consumer ring (later work).
//
// Each entry launches on the given stream, allocates nothing and returns
// cudaGetLastError() (0 = launched).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

extern "C" int moe_swiglu_gmm_bf16(const void* x, const void* w1,
                                   const void* w3, void* out, int G, int C,
                                   int K, int N, void* stream) {
  return launch<true>(x, w1, w3, out, G, C, K, N, stream);
}

extern "C" int moe_gmm_bf16(const void* x, const void* w, void* out, int G,
                            int C, int K, int N, void* stream) {
  return launch<false>(x, w, nullptr, out, G, C, K, N, stream);
}
