// Gather + distance for NVIDIA Hopper (sm_90a).
//
// Replaces the two Pallas kernels `pallas_gather_dist` of
// scripts/pallas_gather.py (kernel 4: ids [B*C], q, a bf16 arena -> L2) and
// scripts/pallas_gather2.py (kernel 5: the same with ids -1 -> +inf and no
// copy issued for them). Both were the TPU's attempt at the graph's hot
// step, the float branch of `distance.gathered`: for every query b and each
// of its C candidate rows ids[b, c]
//     L2     d = |q|^2 - 2 q.v + |v|^2    (|q|^2 of the unrounded f32 query,
//                                          |v|^2 of the stored row)
//     cosine d = 1 - q.v
// and d = +inf where ids[b, c] < 0; no arena row is read for such an id.
// For a bf16 arena the query is rounded to bf16 for the dot, as the
// reference's `compute_t` does; products and sums are in f32. The L2 sum is
// the reference's expansion, evaluated as (|q|^2 - 2 q.v) + |v|^2, so the
// kernel and its plain version round alike (not sum((q - v)^2)).
//
// What bounds it on this card. Each candidate costs one arena row read at a
// random address (512 B for D = 128 f32, 256 B for bf16) and 4 D flops, so
// the kernel is bound by random-row reads from device memory (or L2 for a
// hot arena), far below the card's flop rate. The design: a block owns up
// to ROWS_PER_BLOCK candidates of one query and holds that query in shared
// memory; each warp takes one candidate row at a time, its 32 lanes read
// the row's consecutive elements (coalesced) and reduce the dot and |v|^2
// with shuffles. A -1 id costs no read at all. No tensor cores and no
// prefetch of the next row: later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;               // warps per block
constexpr int THREADS = WARPS * 32;
constexpr int ROWS_PER_BLOCK = 64;     // candidates of one query per block

enum Metric : int { kL2 = 0, kCosine = 1 };

__device__ __forceinline__ float as_float(float x) { return x; }
__device__ __forceinline__ float as_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// grid (B, ceil(C / ROWS_PER_BLOCK)); dynamic shared memory 2 D floats: the
// query as given (for |q|^2) and as the dot reads it (bf16-rounded for a
// bf16 arena).
template <typename TV>
__global__ void __launch_bounds__(THREADS)
gather_dist_kernel(const int32_t* __restrict__ ids,
                   const float* __restrict__ q,
                   const TV* __restrict__ v, float* __restrict__ out,
                   int C, int D, long N, int metric) {
  extern __shared__ float smem[];
  float* qs = smem;          // [D] unrounded
  float* qd = smem + D;      // [D] as the dot reads it
  const int b = blockIdx.x;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  constexpr bool ROUND = sizeof(TV) == 2;

  for (int k = threadIdx.x; k < D; k += THREADS) {
    const float x = q[static_cast<long>(b) * D + k];
    qs[k] = x;
    qd[k] = ROUND ? __bfloat162float(__float2bfloat16_rn(x)) : x;
  }
  __syncthreads();

  float q2 = 0.f;
  if (metric == kL2) {
    for (int k = lane; k < D; k += 32) q2 = fmaf(qs[k], qs[k], q2);
    q2 = warp_sum(q2);
  }

  const int c_end = min(C, static_cast<int>(blockIdx.y + 1) * ROWS_PER_BLOCK);
  for (int c = blockIdx.y * ROWS_PER_BLOCK + warp; c < c_end; c += WARPS) {
    const long o = static_cast<long>(b) * C + c;
    const int id = ids[o];
    if (id < 0 || id >= N) {          // warp-uniform: no row read issued
      if (lane == 0) out[o] = INFINITY;
      continue;
    }
    const TV* row = v + static_cast<long>(id) * D;
    float dot = 0.f, v2 = 0.f;
    for (int k = lane; k < D; k += 32) {
      const float x = as_float(row[k]);
      dot = fmaf(qd[k], x, dot);
      v2 = fmaf(x, x, v2);
    }
    dot = warp_sum(dot);
    v2 = warp_sum(v2);
    if (lane == 0) {
      out[o] = metric == kCosine
                   ? __fsub_rn(1.f, dot)
                   : __fadd_rn(__fsub_rn(q2, __fmul_rn(2.f, dot)), v2);
    }
  }
}

template <typename TV>
int launch(const void* ids, const void* q, const void* v, void* out, int B,
           int C, int D, long N, int metric, cudaStream_t stream) {
  const long gy = (static_cast<long>(C) + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  if (gy > 65535) return cudaErrorInvalidConfiguration;
  const size_t smem = 2 * static_cast<size_t>(D) * sizeof(float);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  dim3 grid(static_cast<unsigned>(B), static_cast<unsigned>(gy));
  gather_dist_kernel<TV><<<grid, THREADS, smem, stream>>>(
      static_cast<const int32_t*>(ids), static_cast<const float*>(q),
      static_cast<const TV*>(v), static_cast<float*>(out), C, D, N, metric);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry point, bound with ctypes by kektordb_tpu_torch/ops/distance.py.
// ids [B, C] int32, q [B, D] f32, v [N, D] f32 (vdtype 0) or bf16
// (vdtype 1), all contiguous on one card; out [B, C] f32 is written.
// metric 0 = L2, 1 = cosine. Returns 0 or the CUDA error of the launch.
extern "C" int kektor_gather_dist(const void* ids, const void* q,
                                  const void* v, void* out, int B, int C,
                                  int D, long N, int vdtype, int metric,
                                  void* stream) {
  if (B <= 0 || C <= 0 || D <= 0 || N < 0 || (metric != kL2 &&
                                               metric != kCosine))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (vdtype) {
    case 0:
      return launch<float>(ids, q, v, out, B, C, D, N, metric, s);
    case 1:
      return launch<__nv_bfloat16>(ids, q, v, out, B, C, D, N, metric, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
