// Fused-scan pass A on Hopper's tensor cores (sm_90a, wgmma).
//
// Replaces, for every form whose product is bf16 x bf16 with f32
// accumulation, three Pallas kernels:
//   * `_make_kernel`, launched by `_pass_a` (kektordb_tpu/ops/scan.py),
//     in its single-bf16-pass forms: f32 fast (q and v rounded to bf16 in
//     this kernel), bf16 arenas, asym fast (q rounded to bf16 x int8
//     codes; every code, |c| <= 127, is exact in bf16);
//   * `scan_reduce` (scripts/scan_pallas_proto.py, `make_kernel`): pass
//     A's bf16 form with biasB = 2;
//   * `scan_vT` (scripts/matmul_ceiling.py): the same over a TRANSPOSED
//     bf16 arena vT [D, N].
// The full-f32 forms and int8 x int8 stay on the CUDA-core kernel
// (scan_pass_a.cu): no tensor-core product is full f32, and TF32 would
// change the exact mode's numbers.
//
// Function (as scan_pass_a.cu): gmin[b, t*W + j] = min over m of
// biasA[r] - dot(q_b, v_r) * biasB[r], garg = that m (the LARGEST m on a
// tie), r = t*ST + m*W + j, W = ST / G; rows >= N score +inf; multiply and
// subtract rounded separately (__fmul_rn / __fsub_rn).
//
// What bounds it. At the serving shape (B = 4096, N = 2^20, D = 128,
// G = 16) the product is 1.1 TFLOP, 1.11 ms at the bf16 peak, and the
// output ([B, N/G] f32 + int32, 2.1 GB) 0.64 ms at the HBM rate: bound by
// operations. At the probes' G = 8 the output is 4.3 GB: bound by bytes.
// A block holds QB = 128 queries, so at B = 4096 every arena row is read
// by 32 blocks: 16 GiB of f32 arena reads against 1.1 TFLOP, which only
// the 50 MB L2 can serve (HBM alone would take ~5 ms). As measured (see
// PERF.md), what sets the pace is the producer's per-tile copy and
// conversion, not the tensor cores, the L2 or the output.
//
// Design.
//   * Queries are wgmma's M operand: two consumer warpgroups of 64
//     queries each. The block's 128-query slab is rounded to bf16 once and
//     stays in shared memory while the block walks its arena range (when
//     it does not fit beside the ring, at large D, it is streamed through
//     the ring with each depth chunk instead).
//   * The arena is the N operand. Each wgmma is m64 n128 k16: n covers two
//     members m, m+1 of the block's 64 groups (with the port's tiles,
//     W = 64, each member is 64 contiguous rows). In the accumulator
//     layout lane L holds columns 8i + 2(L%4) + {0,1}; as 64 is a multiple
//     of 8, a column's group is held by the same thread for every member,
//     so the group min / argmin is folded in registers, members in
//     ascending order with `<=` (the TPU's tie rule), and never touches
//     memory until the one store per (query, group).
//   * A producer warpgroup fills a ring of up to STAGES bf16 tiles guarded
//     by full / empty mbarriers, each 128 rows x 64 deep in the 128-byte
//     swizzled layout the wgmma descriptors read, plus the rows' biasA /
//     biasB for the fold. The serving form reads an f32 arena and no copy
//     engine rounds f32 to bf16, so the producer rounds: where the rows
//     are 16-byte-chunk aligned it copies each thread's runs with
//     cp.async into a raw staging ring RAW - 1 tiles ahead (the latency
//     of the arena reads is hidden without holding registers), then
//     converts its own runs into the stage. Any other stride (a row
//     length that breaks the alignment, a transposed arena) takes
//     synchronous loads, 16-byte ones where the address allows, so no
//     stride is refused. A transposed arena is transposed on the way
//     (neighbouring threads read neighbouring rows), so both arenas reach
//     the tensor cores K-major.
//   * Blocks are ordered query-slab fastest, and each walks up to
//     MAX_UNITS consecutive (tile, 64-group) units, so the slabs of one
//     arena range run together and the range is read from HBM about once,
//     then from L2; the query slab's load is paid once per range.
//   * Edges: the last query slab is masked (zero queries, no store); rows
//     past N, groups past W and members past G read nothing and score
//     +inf (members past G are not folded); the depth tail is zero-filled
//     to the next multiple of 64, the stage's depth (zeros add nothing).
// No TMA (a later step for 16-byte-aligned bf16 arenas), no clusters.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "scan_pass_a.cuh"

namespace {

constexpr int QB = 128;        // queries per block: two warpgroups of 64
constexpr int NB = 128;        // arena rows per wgmma: 2 members x 64 groups
constexpr int GB = 64;         // groups per block
constexpr int KC = 64;         // depth per stage: 64 bf16, one 128-B row
constexpr int THREADS = 384;   // warpgroups 0-1 consume, 2 produces
constexpr int TILE_BYTES = 128 * KC * 2;   // 128 rows x 128 B
constexpr int BIAS_BYTES = 2 * NB * 4;     // biasA, biasB of 128 rows
constexpr int STAGES = 4;                  // most bf16 stages in the ring
constexpr int RAW = 3;                     // cp.async staging slots
constexpr int SMEM_MAX = 232448;           // a block's opt-in maximum
constexpr int MAX_UNITS = 8;

struct Params {
  const void* q;
  const void* v;
  const float* biasA;
  const float* biasB;
  float* gmin;
  int32_t* garg;
  long width;                  // gmin's row length, ceil(N/ST) * W
  int B, N, D, ST, G, W;
  int nslabs;                  // ceil(B / QB)
  int jblocks;                 // ceil(W / GB)
  int units;                   // ceil(N / ST) * jblocks
  int units_per_block;
  int nch;                     // member pairs, ceil(G / 2)
  int nkc;                     // depth chunks, ceil(D / KC)
  int streamed;                // queries go through the ring
  int vec;                     // arena runs staged by cp.async
  int stages;                  // bf16 stages in the ring, 2..STAGES
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n"
      ".reg .b64 state;\n"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n"
      "}\n" ::"r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// shared-memory writes of this thread become visible to wgmma (the async
// proxy) once a barrier orders them
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma boundary
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// K-major operand tile of 128-byte rows in the 128-byte swizzle: 8-row
// atoms 1024 B apart (SBO); the leading offset is unused in this layout.
__device__ __forceinline__ uint64_t sw128_desc(const void* tile) {
  const uint32_t a = smem_u32(tile);
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

#define WG_D8(i)                                                       \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),          \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d[64] (+)= A[64 x 16] * B[128 x 16]^T, both bf16 K-major in shared
// memory; scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24), WG_D8(32), WG_D8(40),
        WG_D8(48), WG_D8(56)
      : "l"(da), "l"(db), "r"(scale_d));
}

#undef WG_D8

__device__ __forceinline__ uint32_t pack2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);   // a low
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ uint4 pack8(const float (&x)[8]) {
  return make_uint4(pack2(x[0], x[1]), pack2(x[2], x[3]), pack2(x[4], x[5]),
                    pack2(x[6], x[7]));
}

// Eight consecutive depth values k..k+7 of one row as bf16, `step`
// elements apart in memory (1: row-major; N: a transposed arena); the
// first n are read (n <= 0: none), the rest are 0. One vector load where
// step is 1, all 8 are in range and the address is aligned; scalar loads
// otherwise, so any stride is taken.
template <typename T>
struct Run;

template <>
struct Run<float> {
  __device__ __forceinline__ static uint4 load(const float* p, long step,
                                               int n) {
    float x[8];
    if (step == 1 && n >= 8 && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(p));
      const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
      x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
      x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) x[k] = k < n ? __ldg(p + k * step) : 0.f;
    }
    return pack8(x);
  }
};

template <>
struct Run<__nv_bfloat16> {
  __device__ __forceinline__ static uint4 load(const __nv_bfloat16* p,
                                               long step, int n) {
    if (step == 1 && n >= 8 && (reinterpret_cast<uintptr_t>(p) & 15) == 0)
      return __ldg(reinterpret_cast<const uint4*>(p));
    const unsigned short* s = reinterpret_cast<const unsigned short*>(p);
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t lo = 2 * k < n ? __ldg(s + 2 * k * step) : 0u;
      const uint32_t hi = 2 * k + 1 < n ? __ldg(s + (2 * k + 1) * step) : 0u;
      w[k] = lo | (hi << 16);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

template <>
struct Run<int8_t> {
  __device__ __forceinline__ static uint4 load(const int8_t* p, long step,
                                               int n) {
    float x[8];
    if (step == 1 && n >= 8 && (reinterpret_cast<uintptr_t>(p) & 7) == 0) {
      const uint2 a = __ldg(reinterpret_cast<const uint2*>(p));
#pragma unroll
      for (int k = 0; k < 8; ++k)
        x[k] = static_cast<float>(static_cast<int8_t>(
            ((k < 4 ? a.x : a.y) >> (8 * (k % 4))) & 0xff));
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k)
        x[k] = k < n ? static_cast<float>(__ldg(p + k * step)) : 0.f;
    }
    return pack8(x);   // |code| <= 127: exact in bf16
  }
};

// run u (depth 8u..8u+7) of row r of a swizzled 128-row tile
__device__ __forceinline__ void store_run(uint8_t* tile, int r, int u,
                                          uint4 x) {
  *reinterpret_cast<uint4*>(tile + r * 128 + ((u ^ (r & 7)) << 4)) = x;
}

template <typename TQ>
__device__ __forceinline__ uint4 query_run(const Params& p, int b, int k) {
  if (b >= p.B) return make_uint4(0, 0, 0, 0);
  return Run<TQ>::load(static_cast<const TQ*>(p.q) + static_cast<long>(b) *
                           p.D + k, 1, p.D - k);
}

// The raw staging of the arena: each thread copies one CH-byte chunk
// (CE values) of each of its rows with cp.async, laid out [j][thread] so a
// warp's accesses are contiguous, and convert() turns a chunk into CE
// bf16 (Out). A warp's copy request covers whole rows: 2 rows of 256 B
// (f32) or 4 of 128 B (bf16) or 4 of 64 B (int8).
template <typename T>
struct Raw;

template <>
struct Raw<float> {
  static constexpr int CH = 16, CE = 4;
  using Out = uint2;
  __device__ __forceinline__ static Out convert(const uint8_t* p) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    return make_uint2(pack2(a.x, a.y), pack2(a.z, a.w));
  }
};

template <>
struct Raw<__nv_bfloat16> {
  static constexpr int CH = 16, CE = 8;
  using Out = uint4;
  __device__ __forceinline__ static Out convert(const uint8_t* p) {
    return *reinterpret_cast<const uint4*>(p);
  }
};

template <>
struct Raw<int8_t> {
  static constexpr int CH = 8, CE = 8;
  using Out = uint4;
  __device__ __forceinline__ static Out convert(const uint8_t* p) {
    const uint2 a = *reinterpret_cast<const uint2*>(p);
    float x[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      x[k] = static_cast<float>(static_cast<int8_t>(
          ((k < 4 ? a.x : a.y) >> (8 * (k % 4))) & 0xff));
    return pack8(x);   // |code| <= 127: exact in bf16
  }
};

// bytes of one raw staging slot: 128 rows x 64 values, then the biases
template <typename T>
__host__ __device__ constexpr int raw_slot_bytes() {
  return 128 * KC * static_cast<int>(sizeof(T)) + BIAS_BYTES;
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src,
                                          int n) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
               "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int n) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Where a block is in its items: depth chunk kc of member pair c of the
// unit whose tile starts at row tbase and whose groups start at j0.
// Advanced one item at a time, so the producer's loop divides nothing.
struct Cursor {
  long tbase;
  int j0, c, kc;

  __device__ __forceinline__ Cursor(const Params& p, int unit)
      : tbase(static_cast<long>(unit / p.jblocks) * p.ST),
        j0((unit % p.jblocks) * GB), c(0), kc(0) {}

  __device__ __forceinline__ void next(const Params& p) {
    if (++kc < p.nkc) return;
    kc = 0;
    if (++c < p.nch) return;
    c = 0;
    j0 += GB;
    if (j0 < p.jblocks * GB) return;
    j0 = 0;
    tbase += p.ST;
  }

  // tile row r: member 2c + r/64, group j0 + r%64; its arena row, and
  // whether that row exists
  __device__ __forceinline__ long row(const Params& p, int r,
                                      bool& in) const {
    const int m = 2 * c + r / GB, g = j0 + r % GB;
    const long rw = tbase + static_cast<long>(m) * p.W + g;
    in = m < p.G && g < p.W && rw < p.N;
    return rw;
  }
};

template <typename TQ, typename TV, bool VT>
__global__ void __launch_bounds__(THREADS, 1)
    pass_a_wgmma_kernel(const Params p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int stage_bytes = TILE_BYTES * (p.streamed ? 2 : 1) + BIAS_BYTES;
  uint8_t* a_res = smem;                    // the resident query slab
  uint8_t* ring = smem + (p.streamed ? 0 : p.nkc * TILE_BYTES);
  uint8_t* raw_ring = ring + p.stages * stage_bytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(
      raw_ring + (p.vec ? RAW * raw_slot_bytes<TV>() : 0));
  uint64_t* empty = full + STAGES;

  const int slab = blockIdx.x % p.nslabs;
  const int unit0 = (blockIdx.x / p.nslabs) * p.units_per_block;
  const int nunits = min(p.units_per_block, p.units - unit0);
  const int b0 = slab * QB;
  const int nitems = nunits * p.nch * p.nkc;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&full[s], 128);      // the producer's threads
      mbar_init(&empty[s], 256);     // the consumers' threads
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (!p.streamed) {
    for (int e = tid; e < p.nkc * QB * 8; e += THREADS) {
      const int kc = e / (QB * 8), r = (e / 8) % QB, u = e % 8;
      store_run(a_res + kc * TILE_BYTES, r, u,
                query_run<TQ>(p, b0 + r, kc * KC + 8 * u));
    }
    fence_proxy_async();
  }
  __syncthreads();

  if (tid >= 256) {
    // ---- producer warpgroup ----
    // For the query chunk (streamed), thread t owns run u = t % 8 (depth
    // 8u..8u+7) of rows r0 + 16 i, i < 8, r0 = t / 8; every such row has
    // the same swizzled offset within its 128 bytes.
    const int t = tid - 256, r0 = t / 8, u = t % 8;
    const int at = r0 * 128 + ((u ^ (r0 & 7)) << 4);   // + i * 2048
    const TV* v = static_cast<const TV*>(p.v);
    // the tile's biases (row t), then (when streamed) the query chunk;
    // rows that do not exist score +inf
    auto finish = [&](const Cursor& I, uint8_t* st, const float* rawA,
                      const float* rawB) {
      bool in;
      const long row = I.row(p, t, in);
      float* bias = reinterpret_cast<float*>(st + stage_bytes - BIAS_BYTES);
      bias[t] = !in ? INFINITY : rawA ? rawA[t] : p.biasA[row];
      bias[NB + t] = !in ? 0.f : VT ? 2.f : rawB ? rawB[t] : p.biasB[row];
      if (p.streamed) {
        uint4 x[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          x[i] = query_run<TQ>(p, b0 + r0 + 16 * i, I.kc * KC + 8 * u);
#pragma unroll
        for (int i = 0; i < 8; ++i)
          *reinterpret_cast<uint4*>(st + TILE_BYTES + at + i * 2048) = x[i];
      }
    };
    int s = 0;
    uint32_t ph = 0;
    Cursor cur(p, unit0);
    if (p.vec) {
      // Row-major arena whose runs are chunk-aligned: cp.async copies each
      // thread's runs into a raw staging slot RAW - 1 items ahead, with no
      // registers held; the thread then converts its own runs (visible to
      // it after cp.async.wait_group) into the swizzled bf16 stage.
      // Thread t copies chunk q = t % CPR (depth q*CE ..) of the tile rows
      // rb + RPP j, j < CPR, rb = t / CPR: rows 0-63 are member 2c,
      // 64-127 member 2c + 1, and every such row puts the chunk's bf16 at
      // the same swizzled offset `out`.
      using R = Raw<TV>;
      constexpr int CPR = KC * static_cast<int>(sizeof(TV)) / R::CH;
      constexpr int RPP = 128 / CPR;           // rows per pass: 8 or 16
      constexpr int OUTB = 2 * R::CE;          // bf16 bytes per chunk
      const int q = t % CPR, rb = t / CPR;
      const int out = rb * 128 + ((((q * OUTB) >> 4) ^ (rb & 7)) << 4) +
                      ((q * OUTB) & 15);       // + j * RPP * 128
      const uint32_t raw0 = smem_u32(raw_ring);
      auto issue = [&](const Cursor& I, int slot_no) {
        const uint32_t slot = raw0 + slot_no * raw_slot_bytes<TV>();
        const long rowb =
            I.tbase + static_cast<long>(2 * I.c) * p.W + I.j0 + rb;
        const int k = I.kc * KC + q * R::CE;
#pragma unroll
        for (int j = 0; j < CPR; ++j) {
          constexpr int per = GB / RPP;        // passes per member
          const int g = RPP * (j % per);
          const long row = rowb + (j / per) * static_cast<long>(p.W) + g;
          const bool in = 2 * I.c + j / per < p.G &&
                          I.j0 + rb + g < p.W && row < p.N;
          const TV* src = v + row * p.D + k;
          const bool ok = in && k < p.D;   // whole chunk or none
          const uint32_t dst = slot + (j * 128 + t) * R::CH;
          if (R::CH == 16)
            cp_async16(dst, ok ? src : v, ok ? 16 : 0);
          else
            cp_async8(dst, ok ? src : v, ok ? 8 : 0);
        }
        bool in;
        const long row = I.row(p, t, in);
        const uint32_t bias = slot + 128 * KC * sizeof(TV);
        cp_async4(bias + 4 * t, in ? p.biasA + row : p.biasA, in ? 4 : 0);
        cp_async4(bias + 4 * (NB + t), in ? p.biasB + row : p.biasB,
                  in ? 4 : 0);
      };
      Cursor ahead = cur;
      for (int j = 0; j < RAW - 1; ++j) {
        if (j < nitems) {
          issue(ahead, j);
          ahead.next(p);
        }
        cp_async_commit();
      }
      int slot_in = RAW - 1, slot_out = 0;
      for (int it = 0; it < nitems; ++it) {
        if (it + RAW - 1 < nitems) {
          issue(ahead, slot_in);
          ahead.next(p);
        }
        cp_async_commit();
        if (++slot_in == RAW) slot_in = 0;
        cp_async_wait<RAW - 1>();          // item it's copies have landed
        const uint8_t* slot = raw_ring + slot_out * raw_slot_bytes<TV>();
        if (++slot_out == RAW) slot_out = 0;
        mbar_wait(&empty[s], ph ^ 1);
        uint8_t* st = ring + s * stage_bytes;
#pragma unroll
        for (int j = 0; j < CPR; ++j)
          *reinterpret_cast<typename R::Out*>(st + out + j * RPP * 128) =
              R::convert(slot + (j * 128 + t) * R::CH);
        const float* rawA =
            reinterpret_cast<const float*>(slot + 128 * KC * sizeof(TV));
        finish(cur, st, rawA, rawA + NB);
        cur.next(p);
        fence_proxy_async();
        mbar_arrive(&full[s]);
        if (++s == p.stages) {
          s = 0;
          ph ^= 1;
        }
      }
    } else {
      // Any other stride (a transposed arena, a row length that breaks the
      // chunk alignment): synchronous loads, vector ones where aligned.
      for (int it = 0; it < nitems; ++it) {
        mbar_wait(&empty[s], ph ^ 1);
        uint8_t* st = ring + s * stage_bytes;
        uint4 x[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          // row-major: 8 neighbouring threads read one row's 64 values;
          // transposed: neighbouring threads read neighbouring rows
          const int e = t + 128 * i;
          const int r = VT ? e % NB : e / 8, ru = VT ? e / NB : e % 8;
          bool in;
          const long row = cur.row(p, r, in);
          const int k = cur.kc * KC + 8 * ru;
          x[i] = make_uint4(0, 0, 0, 0);
          if (in) {
            x[i] = VT ? Run<TV>::load(v + static_cast<long>(k) * p.N + row,
                                      p.N, p.D - k)
                      : Run<TV>::load(v + row * p.D + k, 1, p.D - k);
          }
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int e = t + 128 * i;
          store_run(st, VT ? e % NB : e / 8, VT ? e / NB : e % 8, x[i]);
        }
        finish(cur, st, nullptr, nullptr);
        cur.next(p);
        fence_proxy_async();
        mbar_arrive(&full[s]);
        if (++s == p.stages) {
          s = 0;
          ph ^= 1;
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 queries each ----
    const int wg = tid / 128, t = tid % 128;
    const int qr = 16 * (t / 32) + (t % 32) / 4;   // and qr + 8
    const int cb = 2 * (t % 4);                     // column base
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    float best[2][16];
    int arg[2][16];
    int s = 0;
    uint32_t ph = 0;
    for (int un = unit0; un < unit0 + nunits; ++un) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          best[h][j] = INFINITY;
          arg[h][j] = 0;
        }
      for (int c = 0; c < p.nch; ++c) {
        // the member pair's depth chunks, back to back: one wgmma group
        // stays in flight, and each stage is released as soon as the group
        // that read it has completed
        int prev = 0;
        for (int kc = 0; kc < p.nkc; ++kc) {
          mbar_wait(&full[s], ph);
          const uint8_t* st = ring + s * stage_bytes;
          const uint8_t* a =
              p.streamed ? st + TILE_BYTES : a_res + kc * TILE_BYTES;
          const uint64_t da = sw128_desc(a + wg * 64 * 128);
          const uint64_t db = sw128_desc(st);
          if (kc == 0) fence_acc(acc);
          wgmma_fence();
          // the depth tail past D is zero in both tiles, so all four k16
          // steps run; +32 bytes along K inside the swizzled rows is +2 in
          // the descriptor's 16-byte units
          wgmma_m64n128k16(acc, da, db, kc > 0);
          wgmma_m64n128k16(acc, da + 2, db + 2, 1);
          wgmma_m64n128k16(acc, da + 4, db + 4, 1);
          wgmma_m64n128k16(acc, da + 6, db + 6, 1);
          wgmma_commit();
          if (kc > 0) {
            wgmma_wait1();
            mbar_arrive(&empty[prev]);
          }
          prev = s;
          if (++s == p.stages) {
            s = 0;
            ph ^= 1;
          }
        }
        wgmma_wait0();
        fence_acc(acc);
        // fold members 2c and 2c + 1 into the running group min, with the
        // biases the last stage carries
        const float* bias = reinterpret_cast<const float*>(
            ring + prev * stage_bytes + stage_bytes - BIAS_BYTES);
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const int m = 2 * c + i / 8;
          if (m >= p.G) continue;
          const int n = 8 * i + cb, j = 2 * (i % 8);
          const float2 bA = *reinterpret_cast<const float2*>(bias + n);
          const float2 bB = *reinterpret_cast<const float2*>(bias + NB + n);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            // separate multiply and subtract (no FMA contraction), as the
            // plain version rounds them; `<=`: a later member wins a tie
            const float s0 =
                __fsub_rn(bA.x, __fmul_rn(acc[4 * i + 2 * h], bB.x));
            const float s1 =
                __fsub_rn(bA.y, __fmul_rn(acc[4 * i + 2 * h + 1], bB.y));
            if (s0 <= best[h][j]) {
              best[h][j] = s0;
              arg[h][j] = m;
            }
            if (s1 <= best[h][j + 1]) {
              best[h][j + 1] = s1;
              arg[h][j + 1] = m;
            }
          }
        }
        mbar_arrive(&empty[prev]);
      }
      // one store per (query, group): a quad of lanes holds 8 consecutive
      // groups of one query
      const int tile = un / p.jblocks, j0 = (un % p.jblocks) * GB;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int b = b0 + wg * 64 + qr + 8 * h;
        if (b >= p.B) continue;
        const long obase =
            static_cast<long>(b) * p.width + static_cast<long>(tile) * p.W;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int jj = j0 + 8 * i + cb, j = 2 * i;
          if (jj >= p.W) continue;
          const long o = obase + jj;
          if (jj + 1 < p.W && (o & 1) == 0) {
            *reinterpret_cast<float2*>(p.gmin + o) =
                make_float2(best[h][j], best[h][j + 1]);
            *reinterpret_cast<int2*>(p.garg + o) =
                make_int2(arg[h][j], arg[h][j + 1]);
          } else {
            p.gmin[o] = best[h][j];
            p.garg[o] = arg[h][j];
            if (jj + 1 < p.W) {
              p.gmin[o + 1] = best[h][j + 1];
              p.garg[o + 1] = arg[h][j + 1];
            }
          }
        }
      }
    }
  }
}

template <typename TQ, typename TV, bool VT>
int launch(Params p, cudaStream_t stream) {
  const long ntiles = (static_cast<long>(p.N) + p.ST - 1) / p.ST;
  p.W = p.ST / p.G;
  p.width = ntiles * p.W;
  p.jblocks = (p.W + GB - 1) / GB;
  p.nslabs = (p.B + QB - 1) / QB;
  p.nch = (p.G + 1) / 2;
  p.nkc = (p.D + KC - 1) / KC;
  const long units = ntiles * p.jblocks;
  if (units > 0x7fffffffL) return cudaErrorInvalidConfiguration;
  p.units = static_cast<int>(units);
  // The shared-memory plan: cp.async staging where the rows are chunk-
  // aligned, the query slab resident where it fits, then the deepest ring;
  // each in that order of preference. `fixed`: slack for aligning the
  // base to 1024 B, and the barriers.
  const long fixed = 1024 + 2 * STAGES * 8;
  const bool can_vec =
      !VT && static_cast<long>(p.D) * sizeof(TV) % Raw<TV>::CH == 0 &&
      reinterpret_cast<uintptr_t>(p.v) % Raw<TV>::CH == 0;
  long smem = 0;
  for (int vec = can_vec; vec >= 0 && !smem; --vec)
    for (int streamed = 0; streamed <= 1 && !smem; ++streamed)
      for (int stages = STAGES; stages >= 2 && !smem; --stages) {
        const long total =
            fixed + (streamed ? 0 : static_cast<long>(p.nkc) * TILE_BYTES) +
            stages * (TILE_BYTES * (streamed ? 2 : 1) + BIAS_BYTES) +
            (vec ? RAW * raw_slot_bytes<TV>() : 0);
        if (total <= SMEM_MAX) {
          smem = total;
          p.vec = vec;
          p.streamed = streamed;
          p.stages = stages;
        }
      }
  if (!smem) return cudaErrorInvalidConfiguration;
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // several units per block amortise the query slab's load, as long as
  // about 8 blocks per SM remain to balance the card
  const long per = units * p.nslabs / (8L * sms);
  p.units_per_block =
      static_cast<int>(per < 1 ? 1 : per > MAX_UNITS ? MAX_UNITS : per);
  const long blocks =
      p.nslabs * ((units + p.units_per_block - 1) / p.units_per_block);
  if (blocks > 0x7fffffffL) return cudaErrorInvalidConfiguration;
  auto kernel = pass_a_wgmma_kernel<TQ, TV, VT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(blocks), THREADS, static_cast<size_t>(smem),
           stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

int pass_a_wgmma(const void* q, const void* v, const void* biasA,
                 const void* biasB, void* gmin, void* garg, int B, int N,
                 int D, int ST, int G, int form, bool transposed,
                 cudaStream_t stream) {
  Params p{};
  p.q = q;
  p.v = v;
  p.biasA = static_cast<const float*>(biasA);
  p.biasB = static_cast<const float*>(biasB);
  p.gmin = static_cast<float*>(gmin);
  p.garg = static_cast<int32_t*>(garg);
  p.B = B;
  p.N = N;
  p.D = D;
  p.ST = ST;
  p.G = G;
  if (transposed)
    return form == kBF16
               ? launch<__nv_bfloat16, __nv_bfloat16, true>(p, stream)
               : static_cast<int>(cudaErrorInvalidValue);
  switch (form) {
    case kF32Fast:
      return launch<float, float, false>(p, stream);
    case kBF16:
      return launch<__nv_bfloat16, __nv_bfloat16, false>(p, stream);
    case kAsymFast:
      return launch<float, int8_t, false>(p, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
