// Gather + distance for NVIDIA Hopper (sm_90a).
//
// Replaces the two Pallas kernels `pallas_gather_dist` of
// scripts/pallas_gather.py (kernel 4: ids [B*C], q, a bf16 arena -> L2) and
// scripts/pallas_gather2.py (kernel 5: the same with ids -1 -> +inf and no
// copy issued for them). Both were the TPU's attempt at the graph's hot
// step, the float branch of `distance.gathered`: for every query b and each
// of its C candidate rows ids[b, c]
//     L2     d = (|q|^2 - 2 q.v) + |v|^2  (|q|^2 of the query as given,
//                                          |v|^2 of the stored row)
//     cosine d = 1 - q.v
// and d = +inf where ids[b, c] < 0 or >= N; no arena row is read for such
// an id. For a bf16 arena the dot takes the query rounded to bf16, as the
// reference's `compute_t` does; products and sums are in f32, and the L2
// terms are combined with explicit rounding (__fmul_rn / __fsub_rn /
// __fadd_rn) so the kernel and its plain version round alike.
//
// What bounds it on this card. Each candidate costs one arena row read at a
// random address (512 B for D = 128 f32, 256 B for bf16) and 4 D flops, far
// below the tensor cores' line: the kernel is bound by the bytes of random
// row reads from device memory, so by how many are in flight (Little's
// law), and, at the graph's calls of ~20-40 MB, by what a call costs
// besides them: the launch, each warp's chain of round trips, and the
// instructions each task spends on ids, queries and sums. The design:
//  - The grid is sized to the card (SMs x resident blocks); each warp takes
//    a contiguous run of tasks of WC consecutive candidates of the flat
//    [B*C] list (WC = 64 where C is a multiple of 64, else 32, or less
//    where the call is too small to give every warp a task), so no warp
//    idles at C = 1 (`descend`) or C = 32 (the re-rank).
//  - A task's ids (int32 or int64, read in place, coalesced loads) and,
//    where it starts another query, that query are loaded while the task
//    before it runs. Invalid ids are dropped by warp ballots: they take no
//    lane slot and no load, and their +inf goes out with the task's
//    coalesced store of results. The valid rows of a 64-candidate task
//    fill its batches across the two ballots.
//  - Rows are read in chunks of 16 bytes per lane where the arena allows
//    (4 bytes where rows are only 4-byte aligned, as bf16 D = 100): a row is
//    LPR lanes (16 for bf16 D = 128, so one warp instruction reads two
//    rows; 32 for f32), and a lane issues the loads of all U rows of a
//    batch (32 registers of row data: 8 rows a warp for f32 D = 128, 16
//    for bf16) before the first FMA; `asm volatile` keeps them there.
//  - The warp keeps its query's slice in registers (rounded to bf16 by the
//    kernel for a bf16 arena, from an f32 or bf16 query read in place) and
//    |q|^2 while its tasks stay in that query; query indices come from a
//    multiply by a reciprocal of C, not a 64-bit division.
//  - A batch's U row sums are reduced together, halving the values a lane
//    holds at each shuffle step (U - 1 + log2(LPR / U) shuffles for U rows,
//    not U log2(LPR)).
//  - The common widths (D = 128 and 256, f32 and bf16) have the lanes per
//    row fixed at compile time, so their shuffles and bounds fold away.
//  - Rows that fit neither chunk (odd bf16 D, 2-byte aligned arenas) or
//    that are longer than 8 chunks a lane take the scalar route: the same
//    tasks and ballot, rows read element by element.
// One launch per call: no conversion of ids or queries runs beside it.
// Measured on an H100 80GB HBM3 at 700 W with cold rows (chip_smoke.py
// phase 6, PERF.md): 0.49-0.53 of the bound on bf16 arenas at the graph's
// D = 128 shapes, 0.65-0.69 on f32, 0.81-0.90 at the TPU scripts' shape
// (B = 4096, C = 256, bf16); a call's fixed cost (launch, the first ids,
// the batch phases) is about half of a bf16 graph call. A cp.async.bulk
// ring and a cp.async staged ring measured slower (the bulk copies are
// held by the copy engine's rate per 256-512-byte request).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int WARPS = 4;               // warps per block
constexpr int THREADS = WARPS * 32;
// registers of row data a lane has in flight, and the resident blocks per
// SM the register budget aims at (128 registers a thread): 16 or 64
// registers of rows and 6 or 8 blocks measured slower, 5 no faster
// (PERF.md, the gather-distance runs)
constexpr int SLOT_REGS = 32;
constexpr int MIN_BLOCKS = 4;
constexpr unsigned FULL = 0xffffffffu;
constexpr int SCALAR_U = 4;            // rows in flight per warp, scalar route
constexpr int MAX_DEVICES = 64;

enum Metric : int { kL2 = 0, kCosine = 1 };
enum DType : int { kF32 = 0, kBF16 = 1 };     // arena and query
enum IdType : int { kI32 = 0, kI64 = 1 };

struct Args {
  const void* ids;
  const void* q;
  const void* v;
  float* out;
  long long M;       // B * C candidates
  long long C;
  long long N;
  unsigned long long c_magic;   // f / C = c_div(f) (Granlund-Montgomery)
  int c_shift;                  // -1: C = 1
  int D;
  int metric;
  int q_bf16;
  int q_vec;         // the query's chunks are aligned for vector loads
  int ids64;
  int wc;            // candidates per task (power of two <= 64; <= 32 on
                     // the scalar route)
  int lpr;           // lanes per row (power of two <= 32), vector route
  int nch;           // chunks per row, vector route
};

// the query of flat candidate f: f / C by a multiply-high and shifts
__device__ __forceinline__ long long c_div(const Args& a, long long f) {
  if (a.c_shift < 0) return f;
  const unsigned long long n = static_cast<unsigned long long>(f);
  const unsigned long long t = __umul64hi(a.c_magic, n);
  return static_cast<long long>((t + ((n - t) >> 1)) >> a.c_shift);
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Sum over aligned groups of `width` lanes (a power of two <= MAXW, known
// at run time): fixed butterfly steps, those at or past `width` shuffling
// with offset 0 and adding nothing, so the code has no loop and no branch.
template <int MAXW = 32>
__device__ __forceinline__ float group_sum(float x, int width) {
#pragma unroll
  for (int o = MAXW / 2; o > 0; o >>= 1) {
    const float t = __shfl_xor_sync(FULL, x, o < width ? o : 0);
    x += o < width ? t : 0.f;
  }
  return x;
}

__device__ __forceinline__ float combine(const Args& a, float q2, float dot,
                                         float v2) {
  return a.metric == kCosine
             ? __fsub_rn(1.f, dot)
             : __fadd_rn(__fsub_rn(q2, __fmul_rn(2.f, dot)), v2);
}

// candidate f's id, or -1 where the lane has no candidate
__device__ __forceinline__ long long load_id(const Args& a, long long f,
                                             bool mine) {
  if (!mine) return -1;
  return a.ids64 ? __ldg(static_cast<const long long*>(a.ids) + f)
                 : static_cast<long long>(
                       __ldg(static_cast<const int*>(a.ids) + f));
}

// One chunk of a row: 16 or 4 bytes, loaded where it is written (`asm
// volatile`: the compiler neither sinks it to its use nor drops it) and not
// kept in L1 (random rows are read once).
template <int CB>
struct Chunk;

template <>
struct Chunk<16> {
  uint4 v;
  __device__ __forceinline__ void load(const char* p, bool on) {
    v = make_uint4(0, 0, 0, 0);
    asm volatile(
        "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %5, 0;\n\t"
        "@p ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n\t}"
        : "+r"(v.x), "+r"(v.y), "+r"(v.z), "+r"(v.w)
        : "l"(p), "r"(static_cast<int>(on)));
  }
  __device__ __forceinline__ uint32_t word(int i) const {
    return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
  }
};

template <>
struct Chunk<4> {
  uint32_t v;
  __device__ __forceinline__ void load(const char* p, bool on) {
    v = 0;
    asm volatile(
        "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %2, 0;\n\t"
        "@p ld.global.nc.L1::no_allocate.u32 %0, [%1];\n\t}"
        : "+r"(v)
        : "l"(p), "r"(static_cast<int>(on)));
  }
  __device__ __forceinline__ uint32_t word(int) const { return v; }
};

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// element e of a chunk, as f32
template <bool BF16, int CB>
__device__ __forceinline__ float elem(const Chunk<CB>& c, int e) {
  if (BF16) {
    const uint32_t w = c.word(e >> 1);
    return (e & 1) ? bf16_hi(w) : bf16_lo(w);
  }
  return __uint_as_float(c.word(e));
}

// A lane's slice of one query: elements j * EPC + e of the chunks
// j = sub + lpr * t it reads, loaded as bits (`issue`, no wait) and then
// unpacked (`finish`: as the dot reads it, and this lane's part of |q|^2 of
// the query as given). Aligned 16-byte-chunk queries load whole chunks
// (bf16 elements two to a word); the rest load element by element.
template <bool BF16, int CB, int TM>
struct QueryBits {
  static constexpr int EPC = CB / (BF16 ? 2 : 4);
  uint32_t w[TM][EPC];

  // lpr, nch: the route's lanes per row and chunks per row; full: every
  // chunk a lane's TM slots name exists (nch = lpr TM)
  __device__ __forceinline__ void issue(const Args& a, long long b, int sub,
                                        int lpr, int nch, bool full) {
    const long long row = b * a.D;
#pragma unroll
    for (int t = 0; t < TM; ++t) {
      const int j = sub + lpr * t;
      const bool in = full || j < nch;
      if constexpr (CB == 16) {
        if (a.q_vec) {
          vector_issue(a, row + j * EPC, in, w[t]);
          continue;
        }
      }
      if (a.q_bf16) {
        const unsigned short* q = static_cast<const unsigned short*>(a.q) + row;
#pragma unroll
        for (int e = 0; e < EPC; ++e)
          w[t][e] = in ? __ldg(q + j * EPC + e) : 0u;
      } else {
        const float* q = static_cast<const float*>(a.q) + row;
#pragma unroll
        for (int e = 0; e < EPC; ++e)
          w[t][e] = in ? __float_as_uint(__ldg(q + j * EPC + e)) : 0u;
      }
    }
  }

  // one chunk's elements by whole-chunk loads: a bf16 query two to a word
  // (16 or 8 bytes), an f32 query one to a word (1 or 2 x 16 bytes)
  __device__ __forceinline__ void vector_issue(const Args& a, long long o,
                                               bool in, uint32_t (&c)[EPC]) {
    if (a.q_bf16) {
      const unsigned short* q = static_cast<const unsigned short*>(a.q) + o;
      if constexpr (EPC == 8) {
        const uint4 h = in ? __ldg(reinterpret_cast<const uint4*>(q))
                           : make_uint4(0, 0, 0, 0);
        c[0] = h.x, c[1] = h.y, c[2] = h.z, c[3] = h.w;
      } else {
        const uint2 h = in ? __ldg(reinterpret_cast<const uint2*>(q))
                           : make_uint2(0, 0);
        c[0] = h.x, c[1] = h.y;
      }
    } else {
      const float4* q = reinterpret_cast<const float4*>(
          static_cast<const float*>(a.q) + o);
#pragma unroll
      for (int h = 0; h < EPC / 4; ++h) {
        const float4 f = in ? __ldg(q + h) : make_float4(0, 0, 0, 0);
        c[4 * h] = __float_as_uint(f.x);
        c[4 * h + 1] = __float_as_uint(f.y);
        c[4 * h + 2] = __float_as_uint(f.z);
        c[4 * h + 3] = __float_as_uint(f.w);
      }
    }
  }

  __device__ __forceinline__ float finish(const Args& a,
                                          float (&x)[TM][EPC]) const {
    const bool packed = CB == 16 && a.q_vec && a.q_bf16;
    float q2 = 0.f;
#pragma unroll
    for (int t = 0; t < TM; ++t) {
#pragma unroll
      for (int e = 0; e < EPC; ++e) {
        const float v =
            packed ? ((e & 1) ? bf16_hi(w[t][e >> 1]) : bf16_lo(w[t][e >> 1]))
            : a.q_bf16 ? bf16_lo(w[t][e])
                       : __uint_as_float(w[t][e]);
        q2 = fmaf(v, v, q2);
        x[t][e] = BF16 ? bf16_round(v) : v;
      }
    }
    return q2;
  }
};

// Sums each of the U values p[u] over a group of lpr >= U lanes: at each
// halving step a lane keeps half of its values and adds its partner's
// matching half, so after log2(U) steps it holds one value, p[u] for
// u = sub / (lpr / U) (returned in `u`), summed over the lanes that differ
// in the steps' bits; butterflies add the rest of the group.
template <int U>
__device__ __forceinline__ float transposed_sum(float (&p)[U], int lpr,
                                                int sub, int& u) {
  int o = lpr >> 1;
  u = 0;
#pragma unroll
  for (int h = U / 2; h >= 1; h >>= 1) {
    const bool up = (sub & o) != 0;
#pragma unroll
    for (int i = 0; i < h; ++i) {
      const float send = up ? p[i] : p[i + h];
      const float keep = up ? p[i + h] : p[i];
      p[i] = keep + __shfl_xor_sync(FULL, send, o);
    }
    u = 2 * u + (up ? 1 : 0);
    o >>= 1;
  }
  return group_sum<(32 / U > 1 ? 32 / U : 1)>(p[0], 2 * o);
}

// ---------------------------------------------------------------------------
// vector route: chunks of CB bytes read into registers; TM chunks a lane
// per row (compile-time bound of the runtime ceil(nch / lpr))
// ---------------------------------------------------------------------------

// L: the lanes per row fixed at compile time, with nch = L TM (the common
// widths, D = 128 and 256); 0: both read from the arguments
template <bool BF16, int CB, int TM, int L = 0>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
gather_dist_vec(const Args a) {
  using Q = QueryBits<BF16, CB, TM>;
  constexpr int EPC = Q::EPC;
  constexpr int REGS = CB / 4;                 // registers per chunk
  constexpr int U0 = SLOT_REGS / (TM * REGS);
  constexpr int U = U0 < 1 ? 1 : U0 > 8 ? 8 : U0;   // rows a lane group
  __shared__ long long s_id[WARPS][64];        // the k-th valid id
  __shared__ int s_lane[WARPS][64];            // ... and its place in the
  __shared__ float s_res[WARPS][64];           // task
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int lpr = L ? L : a.lpr;               // lanes per row
  const int nch = L ? L * TM : a.nch;          // chunks per row
  const bool full = L != 0;
  const int grp = lane / lpr;
  const int sub = lane & (lpr - 1);
  const int rpi = 32 / lpr;                    // rows per warp instruction
  const char* rows = static_cast<const char*>(a.v);
  const long long row_bytes = static_cast<long long>(nch) * CB;
  long long* ids = s_id[warp];
  int* lanes = s_lane[warp];
  float* res = s_res[warp];
  const bool l2 = a.metric == kL2;

  // this warp's run of tasks
  const long long ntasks = (a.M + a.wc - 1) / a.wc;
  const long long warps = static_cast<long long>(gridDim.x) * WARPS;
  const long long per = (ntasks + warps - 1) / warps;
  long long task = (static_cast<long long>(blockIdx.x) * WARPS + warp) * per;
  const long long end = task + per < ntasks ? task + per : ntasks;
  if (task >= end) return;

  // the first task's ids (a second 32 of them where WC is 64) and query;
  // each later task's are loaded while the task before it runs
  long long f0 = task * a.wc;
  long long nid = load_id(a, f0 + lane, lane < a.wc && f0 + lane < a.M);
  long long nid2 = load_id(a, f0 + 32 + lane,
                           32 + lane < a.wc && f0 + 32 + lane < a.M);
  long long b0 = c_div(a, f0);       // the task's first query
  Q bits;                            // loaded query bits, of query bits_b
  bits.issue(a, b0, sub, lpr, nch, full);
  long long bits_b = b0;
  float x[TM][EPC];                  // the query slice in use, of query xb
  float q2 = 0.f;
  long long xb = -1;
  for (; task < end; ++task, f0 += a.wc) {
    const long long id = nid, id2 = nid2;
    const long long b = b0;
    if (b != xb) {
      if (bits_b != b) {
        bits.issue(a, b, sub, lpr, nch, full);
        bits_b = b;
      }
      q2 = bits.finish(a, x);
      if (l2) q2 = group_sum(q2, lpr);
      xb = b;
    }
    const long long tail = (f0 + a.wc < a.M ? f0 + a.wc : a.M) - 1;
    const bool one_query = c_div(a, tail) == b;
    if (task + 1 < end) {
      const long long nf = f0 + a.wc;
      nid = load_id(a, nf + lane, lane < a.wc && nf + lane < a.M);
      nid2 = load_id(a, nf + 32 + lane,
                     32 + lane < a.wc && nf + 32 + lane < a.M);
      b0 = c_div(a, nf);
      if (b0 != b && b0 != bits_b) {
        bits.issue(a, b0, sub, lpr, nch, full);
        bits_b = b0;
      }
    }
    const bool mine = lane < a.wc && f0 + lane < a.M;
    const bool mine2 = 32 + lane < a.wc && f0 + 32 + lane < a.M;
    const unsigned valid = __ballot_sync(FULL, mine && id >= 0 && id < a.N);
    const unsigned valid2 =
        __ballot_sync(FULL, mine2 && id2 >= 0 && id2 < a.N);
    const unsigned below = (1u << lane) - 1u;
    const int n1 = __popc(valid);
    const int n = n1 + __popc(valid2);
    res[lane] = res[32 + lane] = INFINITY;
    if (valid >> lane & 1u) {
      const int k = __popc(valid & below);
      ids[k] = id;
      lanes[k] = lane;
    }
    if (valid2 >> lane & 1u) {
      const int k = n1 + __popc(valid2 & below);
      ids[k] = id2;
      lanes[k] = 32 + lane;
    }
    __syncwarp();

    for (int s = 0; s < n; s += U * rpi) {
      Chunk<CB> buf[U][TM];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int k = s + u * rpi + grp;
        const char* p = rows + ids[k < n ? k : 0] * row_bytes;
#pragma unroll
        for (int c = 0; c < TM; ++c) {
          const int j = sub + lpr * c;
          buf[u][c].load(p + static_cast<long long>(j) * CB,
                         k < n && (full || j < nch));
        }
      }
      if (one_query) {
        float dp[U], vp[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          dp[u] = vp[u] = 0.f;
#pragma unroll
          for (int c = 0; c < TM; ++c) {
#pragma unroll
            for (int e = 0; e < EPC; ++e) {
              const float v = elem<BF16>(buf[u][c], e);
              dp[u] = fmaf(x[c][e], v, dp[u]);
              vp[u] = fmaf(v, v, vp[u]);
            }
          }
        }
        if (lpr >= U) {
          int u, u2;
          const float d = transposed_sum<U>(dp, lpr, sub, u);
          const float w = l2 ? transposed_sum<U>(vp, lpr, sub, u2) : 0.f;
          const int k = s + u * rpi + grp;
          if ((sub & (lpr / U - 1)) == 0 && k < n)
            res[lanes[k]] = combine(a, q2, d, w);
        } else {              // rows of fewer lanes than U (tiny D)
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const float d = group_sum(dp[u], lpr);
            const float w = l2 ? group_sum(vp[u], lpr) : 0.f;
            const int k = s + u * rpi + grp;
            if (sub == 0 && k < n) res[lanes[k]] = combine(a, q2, d, w);
          }
        }
      } else {                // the task crosses into another query
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int k = s + u * rpi + grp;
          const long long qb = k < n ? c_div(a, f0 + lanes[k]) : xb;
          const bool moved = qb != xb;
          if (__any_sync(FULL, moved)) {
            float part = 0.f;
            if (moved) {
              Q fresh;
              fresh.issue(a, qb, sub, lpr, nch, full);
              part = fresh.finish(a, x);
              xb = qb;
            }
            const float sum = l2 ? group_sum(part, lpr) : 0.f;
            if (moved) q2 = sum;
          }
          float d = 0.f, w = 0.f;
#pragma unroll
          for (int c = 0; c < TM; ++c) {
#pragma unroll
            for (int e = 0; e < EPC; ++e) {
              const float v = elem<BF16>(buf[u][c], e);
              d = fmaf(x[c][e], v, d);
              w = fmaf(v, v, w);
            }
          }
          d = group_sum(d, lpr);
          if (l2) w = group_sum(w, lpr);
          if (sub == 0 && k < n) res[lanes[k]] = combine(a, q2, d, w);
        }
      }
    }
    __syncwarp();
    if (mine) a.out[f0 + lane] = res[lane];
    if (mine2) a.out[f0 + 32 + lane] = res[32 + lane];
    __syncwarp();            // ids / lanes / res are rewritten next task
    // after a task across queries, lane groups may hold different queries
    if (!one_query) xb = -1;
  }
}

// ---------------------------------------------------------------------------
// scalar route: any D, any alignment; a row is the whole warp, element by
// element, SCALAR_U rows in flight
// ---------------------------------------------------------------------------

template <bool BF16>
__device__ __forceinline__ float arena_elem(const Args& a, long long id,
                                            int k) {
  const long long o = id * a.D + k;
  if (BF16)
    return bf16_lo(__ldg(static_cast<const unsigned short*>(a.v) + o));
  return __ldg(static_cast<const float*>(a.v) + o);
}

__device__ __forceinline__ float query_elem(const Args& a, long long b,
                                            int k) {
  const long long o = b * a.D + k;
  if (a.q_bf16)
    return bf16_lo(__ldg(static_cast<const unsigned short*>(a.q) + o));
  return __ldg(static_cast<const float*>(a.q) + o);
}

template <bool BF16>
__global__ void __launch_bounds__(THREADS)
gather_dist_scalar(const Args a) {
  constexpr int U = SCALAR_U;
  __shared__ long long s_id[WARPS][32];
  __shared__ int s_lane[WARPS][32];
  __shared__ float s_res[WARPS][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long ntasks = (a.M + a.wc - 1) / a.wc;
  const long long stride = static_cast<long long>(gridDim.x) * WARPS;
  long long* ids = s_id[warp];
  int* lanes = s_lane[warp];
  float* res = s_res[warp];
  const bool l2 = a.metric == kL2;

  for (long long task = static_cast<long long>(blockIdx.x) * WARPS + warp;
       task < ntasks; task += stride) {
    const long long f0 = task * a.wc;
    const bool mine = lane < a.wc && f0 + lane < a.M;
    const long long id = load_id(a, f0 + lane, mine);
    const unsigned valid = __ballot_sync(FULL, mine && id >= 0 && id < a.N);
    const int n = __popc(valid);
    res[lane] = INFINITY;
    if (valid >> lane & 1u) {
      const int k = __popc(valid & ((1u << lane) - 1u));
      ids[k] = id;
      lanes[k] = lane;
    }
    __syncwarp();
    long long cur_b = -1;
    float q2 = 0.f;
    for (int s = 0; s < n; s += U) {
      long long r[U], b[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int k = s + u < n ? s + u : 0;
        r[u] = ids[k];
        b[u] = c_div(a, f0 + lanes[k]);
      }
      float dot[U], v2[U];
#pragma unroll
      for (int u = 0; u < U; ++u) dot[u] = v2[u] = 0.f;
      for (int k = lane; k < a.D; k += 32) {
        float x[U];
#pragma unroll
        for (int u = 0; u < U; ++u)
          x[u] = s + u < n ? arena_elem<BF16>(a, r[u], k) : 0.f;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const float qv = query_elem(a, b[u], k);
          dot[u] = fmaf(BF16 ? bf16_round(qv) : qv, x[u], dot[u]);
          v2[u] = fmaf(x[u], x[u], v2[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (s + u >= n) break;                 // warp-uniform
        if (l2 && b[u] != cur_b) {             // warp-uniform
          float part = 0.f;
          for (int k = lane; k < a.D; k += 32) {
            const float qv = query_elem(a, b[u], k);
            part = fmaf(qv, qv, part);
          }
          q2 = group_sum(part, 32);
          cur_b = b[u];
        }
        const float d = group_sum(dot[u], 32);
        const float w = l2 ? group_sum(v2[u], 32) : 0.f;
        if (lane == 0) res[lanes[s + u]] = combine(a, q2, d, w);
      }
    }
    __syncwarp();
    if (mine) a.out[f0 + lane] = res[lane];
    __syncwarp();
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

using Kernel = void (*)(Args);

// per arena dtype: 16-byte chunks at TM = 1, 2, 4, 8; 4-byte chunks at the
// same; the scalar route; then the fixed-width routes (FIXED)
constexpr int ROUTES_PER_DTYPE = 9;
struct Fixed {
  int bf16, tm, lpr;
};
constexpr Fixed FIXED[] = {{0, 1, 32}, {0, 2, 32}, {1, 1, 16}, {1, 1, 32}};
constexpr int N_FIXED = sizeof(FIXED) / sizeof(FIXED[0]);
constexpr int N_ROUTES = 2 * ROUTES_PER_DTYPE + N_FIXED;
const Kernel KERNELS[N_ROUTES] = {
    gather_dist_vec<false, 16, 1>, gather_dist_vec<false, 16, 2>,
    gather_dist_vec<false, 16, 4>, gather_dist_vec<false, 16, 8>,
    gather_dist_vec<false, 4, 1>,  gather_dist_vec<false, 4, 2>,
    gather_dist_vec<false, 4, 4>,  gather_dist_vec<false, 4, 8>,
    gather_dist_scalar<false>,
    gather_dist_vec<true, 16, 1>,  gather_dist_vec<true, 16, 2>,
    gather_dist_vec<true, 16, 4>,  gather_dist_vec<true, 16, 8>,
    gather_dist_vec<true, 4, 1>,   gather_dist_vec<true, 4, 2>,
    gather_dist_vec<true, 4, 4>,   gather_dist_vec<true, 4, 8>,
    gather_dist_scalar<true>,
    gather_dist_vec<false, 16, 1, 32>, gather_dist_vec<false, 16, 2, 32>,
    gather_dist_vec<true, 16, 1, 16>,  gather_dist_vec<true, 16, 1, 32>};

int g_sms[MAX_DEVICES];
int g_blocks[MAX_DEVICES][N_ROUTES];   // resident blocks per SM, 0: unknown

int next_pow2(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

struct Plan {
  int cb;            // chunk bytes (16 or 4); 0: the scalar route
  int tm;
  int lpr;
  int nch;
  int route;
  bool fixed;        // a fixed-width route
};

// The route of an arena of rows of D elements at address v: the widest
// chunk (16, then 4 bytes) that divides the rows and the address, with at
// most 8 chunks a lane; else the scalar route.
Plan plan(int D, int v_dtype, const void* v) {
  const long long row = static_cast<long long>(D) * (v_dtype == kBF16 ? 2 : 4);
  const int base = v_dtype == kBF16 ? ROUTES_PER_DTYPE : 0;
  for (int cb : {16, 4}) {
    if (row % cb || reinterpret_cast<uintptr_t>(v) % cb) continue;
    const long long nch = row / cb;
    const int lpr = nch < 32 ? next_pow2(static_cast<int>(nch)) : 32;
    const long long t = (nch + lpr - 1) / lpr;
    if (t > 8) continue;
    const int tm = next_pow2(static_cast<int>(t));
    const int k = tm == 1 ? 0 : tm == 2 ? 1 : tm == 4 ? 2 : 3;
    Plan p = {cb, tm, lpr, static_cast<int>(nch),
              base + (cb == 16 ? 0 : 4) + k, false};
    for (int f = 0; f < N_FIXED; ++f)
      if (cb == 16 && FIXED[f].bf16 == (v_dtype == kBF16) &&
          FIXED[f].tm == tm && FIXED[f].lpr == lpr && nch == lpr * tm) {
        p.route = 2 * ROUTES_PER_DTYPE + f;
        p.fixed = true;
      }
    return p;
  }
  return {0, 0, 32, 0, base + 8, false};
}

int grid_capacity(int route, int* blocks_out) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
  if (!g_sms[dev]) {
    int sms = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    g_sms[dev] = sms;
  }
  if (!g_blocks[dev][route]) {
    int per_sm = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, KERNELS[route], THREADS, 0);
    if (e != cudaSuccess) return static_cast<int>(e);
    g_blocks[dev][route] = per_sm > 0 ? per_sm : 1;
  }
  *blocks_out = g_sms[dev] * g_blocks[dev][route];
  return 0;
}

}  // namespace

// C entry points, bound with ctypes by kektordb_tpu_torch/native.py.
//
// kektor_gather_dist: ids [B, C] int32 (ids_dtype 0) or int64 (1), q [B, D]
// f32 (q_dtype 0) or bf16 (1), v [N, D] f32 (v_dtype 0) or bf16 (1), all
// contiguous on the current card and read in place; out [B, C] f32 is
// written. metric 0 = L2, 1 = cosine. One launch on `stream`; returns 0 or
// the CUDA error.
extern "C" int kektor_gather_dist(const void* ids, int ids_dtype,
                                  const void* q, int q_dtype, const void* v,
                                  int v_dtype, void* out, long long B,
                                  long long C, int D, long long N, int metric,
                                  void* stream) {
  if (B <= 0 || C <= 0 || D <= 0 || N < 0 ||
      (metric != kL2 && metric != kCosine) ||
      (ids_dtype != kI32 && ids_dtype != kI64) ||
      (q_dtype != kF32 && q_dtype != kBF16) ||
      (v_dtype != kF32 && v_dtype != kBF16))
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = plan(D, v_dtype, v);
  Args a;
  a.ids = ids;
  a.q = q;
  a.v = v;
  a.out = static_cast<float*>(out);
  a.M = B * C;
  a.C = C;
  a.N = N;
  // f / C = (t + ((f - t) >> 1)) >> (l - 1), t = mulhi(magic, f), for
  // l = ceil(log2 C) and magic = floor(2^64 (2^l - C) / C) + 1
  int l = 0;
  while ((1ULL << l) < static_cast<unsigned long long>(C)) ++l;
  a.c_shift = l - 1;
  a.c_magic = l ? static_cast<unsigned long long>(
                      (static_cast<unsigned __int128>((1ULL << l) - C) << 64) /
                      static_cast<unsigned long long>(C)) + 1
                : 0;
  a.D = D;
  a.metric = metric;
  a.q_bf16 = q_dtype == kBF16;
  // whole-chunk query loads: the chunk's bytes in the query (16 or 32 for
  // f32, 8 or 16 for bf16) and the address aligned to them
  const int q_chunk = p.cb == 16 ? 16 / (v_dtype == kBF16 ? 2 : 4) *
                                       (q_dtype == kBF16 ? 2 : 4)
                                 : 0;
  const int q_align = q_chunk > 16 ? 16 : q_chunk;
  a.q_vec = q_chunk && reinterpret_cast<uintptr_t>(q) % q_align == 0;
  a.ids64 = ids_dtype == kI64;
  a.lpr = p.lpr;
  a.nch = p.nch;
  int capacity = 0;
  const int err = grid_capacity(p.route, &capacity);
  if (err) return err;
  // the widest task that still gives every resident warp one: at most 32
  // candidates, or 64 on the vector route where no task then crosses into
  // another query (its batches fill across the two ballots)
  const int wc_max = p.cb && C % 64 == 0 ? 64 : 32;
  a.wc = 1;
  while (a.wc < wc_max && (a.M + a.wc - 1) / a.wc >
                              static_cast<long long>(capacity) * WARPS)
    a.wc <<= 1;
  const long long ntasks = (a.M + a.wc - 1) / a.wc;
  const long long blocks = (ntasks + WARPS - 1) / WARPS;
  const unsigned grid =
      static_cast<unsigned>(blocks < capacity ? blocks : capacity);
  void* params[] = {&a};
  const cudaError_t e = cudaLaunchKernel(
      reinterpret_cast<const void*>(KERNELS[p.route]), dim3(grid),
      dim3(THREADS), params, 0, static_cast<cudaStream_t>(stream));
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

// kektor_gather_dist_route: the route a call on this arena takes, as
// 10000 * the fixed lanes per row (0 where not fixed) + 100 * chunk bytes
// + TM for the vector route, 0 for the scalar route. For reports; the
// launch decides the same way.
extern "C" int kektor_gather_dist_route(int D, int v_dtype, const void* v) {
  const Plan p = plan(D, v_dtype, v);
  return p.cb ? (p.fixed ? 10000 * p.lpr : 0) + 100 * p.cb + p.tm : 0;
}
