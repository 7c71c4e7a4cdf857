// Fused-scan pass A for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas kernel `_make_kernel`, launched by `_pass_a`
// (kektordb_tpu/ops/scan.py). For every query b and every row tile of ST
// rows it computes
//     score[b, row] = biasA[row] - dot(q[b], v[row]) * biasB[row]
// and reduces the tile with a strided G-group min and argmin: with
// W = ST / G, group j of tile t covers rows t*ST + j + m*W for m in [0, G).
// Only gmin[b, t*W + j] and garg[b, t*W + j] = m reach device memory; the
// [B, N] score matrix never does. On a tie the LARGEST m wins, as in the
// TPU kernel. Rows >= N (a ragged last tile) score +inf.
//
// Precision forms (`form`), the TPU kernel's four plus a bf16 arena:
//   0 f32       q f32,  v f32   full f32 FMA            (TPU: HIGHEST)
//   1 f32 fast  q f32,  v f32   both rounded to bf16,   (TPU: DEFAULT, one
//                               f32 accumulation         bf16 pass)
//   2 bf16      q bf16, v bf16  f32 accumulation
//   3 int8      q int8, v int8  int32 accumulation (__dp4a)
//   4 asym      q f32,  v int8  codes cast to f32, full f32
//   5 asym fast q f32,  v int8  q rounded to bf16, f32 accumulation
//
// What bounds it on this card. At the serving shape (B = 4096 queries,
// N = 2^20 rows, D = 128) one batch is 1.1 TFLOP over a 512 MiB f32 arena:
// about 2,000 operations per byte read, far above the H100's ridge, so the
// product is compute-bound and the output ([B, N/G], 1/G of the scores) is
// what keeps it off the memory roof. This first version is a plain
// shared-memory tiled product on the CUDA cores: a block holds 64 queries
// x 64 groups, each thread a 4 x 4 register tile of (query, group) pairs,
// and it walks the G members of its groups in turn, folding each member's
// scores into a running min held in registers. So the group reduction
// costs no memory traffic at all. It does not use the tensor cores
// (wgmma), TMA or a per-tile top-k: those are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BQ = 64;   // queries per block
constexpr int BJ = 64;   // groups per block
constexpr int BK = 32;   // depth per stage: elements (float forms) or
                         // 4-byte words of four int8 values (int8 form)
constexpr int TM = 4;    // queries per thread
constexpr int TN = 4;    // groups per thread
constexpr int THREADS = (BQ / TM) * (BJ / TN);   // 256
constexpr int PAD = 4;   // keeps rows 16-byte aligned for vector reads

enum Form : int {
  kF32 = 0, kF32Fast = 1, kBF16 = 2, kInt8 = 3, kAsym = 4, kAsymFast = 5
};

__device__ __forceinline__ float as_float(float x) { return x; }
__device__ __forceinline__ float as_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float as_float(int8_t x) {
  return static_cast<float>(x);
}

template <typename T, bool ROUND>
__device__ __forceinline__ float load_float(const T* p, long i, bool ok) {
  if (!ok) return 0.f;
  const float x = as_float(p[i]);
  return ROUND ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

// Four int8 values k..k+3 of one row packed for __dp4a; bytes past D are 0.
__device__ __forceinline__ int load_word(const int8_t* row, int k, int D) {
  unsigned w = 0;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    if (k + t < D) w |= static_cast<unsigned>(static_cast<uint8_t>(row[k + t]))
                        << (8 * t);
  }
  return static_cast<int>(w);
}

template <typename TQ, typename TV, bool RQ, bool RV, bool INT>
__global__ void __launch_bounds__(THREADS)
pass_a_kernel(const TQ* __restrict__ q, const TV* __restrict__ v,
              const float* __restrict__ biasA,
              const float* __restrict__ biasB,
              float* __restrict__ gmin, int32_t* __restrict__ garg,
              int B, int N, int D, int ST, int G) {
  using S = typename std::conditional<INT, int, float>::type;
  using S4 = typename std::conditional<INT, int4, float4>::type;
  __shared__ __align__(16) S qs[BK][BQ + PAD];   // [depth][query]
  __shared__ __align__(16) S vs[BK][BJ + PAD];   // [depth][group]

  const int W = ST / G;
  const int jblocks = (W + BJ - 1) / BJ;
  const long tile = blockIdx.x / jblocks;
  const int j0 = (blockIdx.x % jblocks) * BJ;
  const int b0 = blockIdx.y * BQ;
  const int tx = threadIdx.x % (BJ / TN);
  const int ty = threadIdx.x / (BJ / TN);
  const int kstep = INT ? 4 * BK : BK;

  float best[TM][TN];
  int arg[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      best[i][j] = INFINITY;
      arg[i][j] = 0;
    }

  for (int m = 0; m < G; ++m) {
    // row of this block's group j0 + r at member m is row0 + r
    const long row0 = tile * ST + static_cast<long>(m) * W + j0;
    S acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0;

    for (int k0 = 0; k0 < D; k0 += kstep) {
      for (int e = threadIdx.x; e < BQ * BK; e += THREADS) {
        const int r = e / BK, c = e % BK;
        const int b = b0 + r;
        if constexpr (INT) {
          qs[c][r] = b < B ? load_word(reinterpret_cast<const int8_t*>(q) +
                                           static_cast<long>(b) * D,
                                       k0 + 4 * c, D)
                           : 0;
        } else {
          const int k = k0 + c;
          qs[c][r] = load_float<TQ, RQ>(q, static_cast<long>(b) * D + k,
                                        b < B && k < D);
        }
      }
      for (int e = threadIdx.x; e < BJ * BK; e += THREADS) {
        const int r = e / BK, c = e % BK;
        const long row = row0 + r;
        const bool in = j0 + r < W && row < N;
        if constexpr (INT) {
          vs[c][r] = in ? load_word(reinterpret_cast<const int8_t*>(v) +
                                        row * D,
                                    k0 + 4 * c, D)
                        : 0;
        } else {
          const int k = k0 + c;
          vs[c][r] = load_float<TV, RV>(v, row * D + k, in && k < D);
        }
      }
      __syncthreads();
#pragma unroll
      for (int c = 0; c < BK; ++c) {
        const S4 a4 = *reinterpret_cast<const S4*>(&qs[c][ty * TM]);
        const S4 w4 = *reinterpret_cast<const S4*>(&vs[c][tx * TN]);
        const S a[TM] = {a4.x, a4.y, a4.z, a4.w};
        const S w[TN] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            if constexpr (INT) {
              acc[i][j] = __dp4a(a[i], w[j], acc[i][j]);
            } else {
              acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
            }
          }
      }
      __syncthreads();
    }

    // fold member m into the running group min; `<=` makes a later
    // member win a tie, the TPU kernel's rule
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int jj = j0 + tx * TN + j;
      const long row = tile * ST + static_cast<long>(m) * W + jj;
      const bool in = jj < W && row < N;
      const float A = in ? biasA[row] : INFINITY;
      const float Bm = in ? biasB[row] : 0.f;
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        // separate multiply and subtract (no FMA contraction), as the
        // reference and the plain version round them
        const float s = in ? __fsub_rn(A, __fmul_rn(static_cast<float>(
                                                         acc[i][j]),
                                                     Bm))
                           : INFINITY;
        if (s <= best[i][j]) {
          best[i][j] = s;
          arg[i][j] = m;
        }
      }
    }
  }

  const long width = static_cast<long>((N + ST - 1) / ST) * W;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int b = b0 + ty * TM + i;
    if (b >= B) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int jj = j0 + tx * TN + j;
      if (jj >= W) continue;
      const long o = static_cast<long>(b) * width + tile * W + jj;
      gmin[o] = best[i][j];
      garg[o] = arg[i][j];
    }
  }
}

template <typename TQ, typename TV, bool RQ, bool RV, bool INT>
int launch(const void* q, const void* v, const void* biasA,
           const void* biasB, void* gmin, void* garg, int B, int N, int D,
           int ST, int G, cudaStream_t stream) {
  const int W = ST / G;
  const long jblocks = (W + BJ - 1) / BJ;
  const long ntiles = (static_cast<long>(N) + ST - 1) / ST;
  const long gx = ntiles * jblocks;
  const long gy = (static_cast<long>(B) + BQ - 1) / BQ;
  if (gx > 0x7fffffffL || gy > 65535) return cudaErrorInvalidConfiguration;
  dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
  pass_a_kernel<TQ, TV, RQ, RV, INT><<<grid, THREADS, 0, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TV*>(v),
      static_cast<const float*>(biasA), static_cast<const float*>(biasB),
      static_cast<float*>(gmin), static_cast<int32_t*>(garg), B, N, D, ST,
      G);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry point, bound with ctypes by kektordb_tpu_torch/ops/scan.py.
// q [B, D], v [N, D], biasA/biasB [N] f32, all contiguous on one card;
// gmin [B, ceil(N/ST) * ST/G] f32 and garg (same shape, int32) are written.
// Returns 0 or the CUDA error of the launch.
extern "C" int kektor_scan_pass_a(const void* q, const void* v,
                                  const void* biasA, const void* biasB,
                                  void* gmin, void* garg, int B, int N,
                                  int D, int ST, int G, int form,
                                  void* stream) {
  if (B <= 0 || N <= 0 || D <= 0 || G <= 0 || ST <= 0 || ST % G)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (form) {
    case kF32:
      return launch<float, float, false, false, false>(
          q, v, biasA, biasB, gmin, garg, B, N, D, ST, G, s);
    case kF32Fast:
      return launch<float, float, true, true, false>(
          q, v, biasA, biasB, gmin, garg, B, N, D, ST, G, s);
    case kBF16:
      return launch<__nv_bfloat16, __nv_bfloat16, false, false, false>(
          q, v, biasA, biasB, gmin, garg, B, N, D, ST, G, s);
    case kInt8:
      return launch<int8_t, int8_t, false, false, true>(
          q, v, biasA, biasB, gmin, garg, B, N, D, ST, G, s);
    case kAsym:
      return launch<float, int8_t, false, false, false>(
          q, v, biasA, biasB, gmin, garg, B, N, D, ST, G, s);
    case kAsymFast:
      return launch<float, int8_t, true, false, false>(
          q, v, biasA, biasB, gmin, garg, B, N, D, ST, G, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
