// Fused-scan pass A on Hopper's tensor cores (sm_90a, wgmma), every
// precision form, and the C entry points.
//
// Replaces three Pallas kernels:
//   * `_make_kernel`, launched by `_pass_a` (kektordb_tpu/ops/scan.py), in
//     all its forms;
//   * `scan_reduce` (scripts/scan_pallas_proto.py, `make_kernel`): pass
//     A's bf16 form with biasB = 2;
//   * `scan_vT` (scripts/matmul_ceiling.py): the same over a TRANSPOSED
//     bf16 arena vT [D, N].
//
// Function: gmin[b, t*W + j] = min over m of
// biasA[r] - dot(q_b, v_r) * biasB[r], garg = that m (the LARGEST m on a
// tie, the TPU kernel's rule), r = t*ST + m*W + j, W = ST / G; rows >= N
// score +inf; multiply and subtract rounded separately (__fmul_rn /
// __fsub_rn). Only [B, N/G] reaches device memory, never [B, N].
//
// Precision forms (`form`) and the product each runs:
//   0 f32       q f32,  v f32   3xTF32: x = big + small, big the f32 with
//                               its low 13 mantissa bits cleared, small
//                               = x - big rounded to tf32; big.big +
//                               big.small + small.big (m64n128k8 tf32)
//   1 f32 fast  q f32,  v f32   both rounded to bf16 (m64n128k16 bf16)
//   2 bf16      q bf16, v bf16  bf16 (m64n128k16)
//   3 int8      q int8, v int8  s8 x s8, exact s32 (m64n128k32 s8)
//   4 asym      q f32,  v int8  q split into three bf16 pieces
//                               q1 + q2 + q3 (all of its 24 bits); each
//                               code is exact in bf16, so each piece's
//                               product is exact: three bf16 products
//   5 asym fast q f32,  v int8  q rounded to bf16, one bf16 product
// Forms 0 and 4 (the exact mode) differ from a full-f32 sum only in the
// order of the f32 sum and, for form 0, the dropped small.small term and
// small's rounding (about 2^-20 of |q||v| a term). The tensor cores
// truncate as they accumulate, an error that grows with the products
// summed into one accumulator, so form 0 sums each depth chunk's products
// apart and adds them in registers, rounded to nearest. Form 3 is
// bit-equal to the plain version: the s32 sum is exact and
// __int2float_rn rounds it as torch's .float() does.
//
// What bounds it. At the serving shape (B = 4096, N = 2^20, D = 128,
// G = 16) the output ([B, N/G] f32 + int32, 2.1 GB) takes 0.64 ms at the
// HBM rate; the products 1.11 ms at the bf16 peak (forms 1, 2, 5), three
// times that for forms 0 (at the TF32 peak, half bf16's) and 4, 0.56 ms
// for int8. A block holds 128 queries (64 for form 0), so every arena row
// is read by B / 128 blocks, which only the 50 MB L2 can serve.
//
// Design.
//   * Queries are wgmma's M operand: consumer warpgroups of 64 queries
//     each, two a block (one for form 0, whose threads then have the
//     registers for its chunk sums). The block's query slab, in the
//     form's operand planes (one, or two tf32 planes big / small, or three
//     bf16 pieces), is built once and stays in shared memory while the
//     block walks its arena range (when it does not fit beside the ring
//     it is streamed through the ring with each depth chunk instead).
//   * The arena is the N operand. Each wgmma is m64 n128: n covers two
//     members m, m+1 of the block's 64 groups (with the port's tiles,
//     W = 64, each member is 64 contiguous rows). In the accumulator
//     layout lane L holds columns 8i + 2(L%4) + {0,1}; as 64 is a multiple
//     of 8, a column's group is held by the same thread for every member,
//     so the group min / argmin is folded in registers, members in
//     ascending order with `<=`, and never touches memory until the one
//     store per (query, group).
//   * A stage is one 128-byte row of depth for 128 arena rows in each of
//     the form's planes (64 bf16, 32 tf32 or 128 int8 deep), in the
//     128-byte swizzle the wgmma descriptors read, plus the rows' biasA /
//     biasB. Four 32-byte k-steps a stage; full / empty mbarriers guard a
//     ring of stages that a producer warpgroup fills.
//   * The producer. int8 x int8 needs no conversion, so where the rows are
//     16-byte aligned it copies 16-byte chunks with cp.async straight into
//     the swizzled stage, stages - 1 items ahead. The other forms convert
//     (f32 to bf16 or to tf32 big / small, codes to bf16): where the rows
//     are chunk-aligned each thread's runs are copied with cp.async into a
//     raw staging ring RAW - 1 items ahead and converted into the stage.
//     Any other stride (a row length that breaks the alignment, a
//     transposed arena) takes synchronous loads, 16-byte ones where the
//     address allows, so no stride is refused. A transposed arena is
//     transposed on the way (neighbouring threads read neighbouring rows),
//     so both operands reach the tensor cores K-major (tf32 and s8 have no
//     transposed form).
//   * Blocks are ordered query-slab fastest, and each walks up to
//     MAX_UNITS consecutive (tile, 64-group) units, so the slabs of one
//     arena range run together and the range is read from HBM about once,
//     then from L2; the query slab's load is paid once per range.
//   * Edges: the last query slab is masked (zero queries, no store); rows
//     past N, groups past W and members past G read nothing and score
//     +inf (members past G are not folded); the depth tail is zero-filled
//     to the stage's depth (zeros add nothing).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// pass-A precision forms: the `form` argument of kektor_scan_pass_a
enum PassAForm : int {
  kF32 = 0, kF32Fast = 1, kBF16 = 2, kInt8 = 3, kAsym = 4, kAsymFast = 5
};

constexpr int NB = 128;        // arena rows per wgmma: 2 members x 64 groups
constexpr int GB = 64;         // groups per block
constexpr int TILE_BYTES = 128 * 128;      // one plane: 128 rows x 128 B
constexpr int BIAS_BYTES = 2 * NB * 4;     // biasA, biasB of 128 rows
constexpr int STAGES_MAX = 8;              // most stages in any ring
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
  int nslabs;                  // ceil(B / queries per block)
  int jblocks;                 // ceil(W / GB)
  int units;                   // ceil(N / ST) * jblocks
  int units_per_block;
  int nch;                     // member pairs, ceil(G / 2)
  int nkc;                     // depth chunks, ceil(D / depth of a stage)
  int streamed;                // queries go through the ring
  int vec;                     // arena runs copied by cp.async
  int stages;                  // stages in the ring, 2..the form's most
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
__device__ __forceinline__ void fence_acc(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

__device__ __forceinline__ float acc_float(float x) { return x; }
// round to nearest even, as torch's .float() of the exact integer dot
__device__ __forceinline__ float acc_float(int x) { return __int2float_rn(x); }

// K-major operand tile of 128-byte rows in the 128-byte swizzle: 8-row
// atoms 1024 B apart (SBO); the leading offset is unused in this layout.
__device__ __forceinline__ uint64_t sw128_desc(const void* tile) {
  const uint32_t a = smem_u32(tile);
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

#define WG_OUTS                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, "                                  \
  "%8, %9, %10, %11, %12, %13, %14, %15, "                             \
  "%16, %17, %18, %19, %20, %21, %22, %23, "                           \
  "%24, %25, %26, %27, %28, %29, %30, %31, "                           \
  "%32, %33, %34, %35, %36, %37, %38, %39, "                           \
  "%40, %41, %42, %43, %44, %45, %46, %47, "                           \
  "%48, %49, %50, %51, %52, %53, %54, %55, "                           \
  "%56, %57, %58, %59, %60, %61, %62, %63}, "
#define WG_D8(c, i)                                                    \
  c(d[i]), c(d[i + 1]), c(d[i + 2]), c(d[i + 3]), c(d[i + 4]),         \
      c(d[i + 5]), c(d[i + 6]), c(d[i + 7])
#define WG_D64(c)                                                      \
  WG_D8(c, 0), WG_D8(c, 8), WG_D8(c, 16), WG_D8(c, 24), WG_D8(c, 32),  \
      WG_D8(c, 40), WG_D8(c, 48), WG_D8(c, 56)
#define F_ "+f"
#define R_ "+r"

// d[64] (+)= A[64 x 16] * B[128 x 16]^T, both bf16 K-major in shared
// memory; scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_bf16(float (&d)[64], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_OUTS
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : WG_D64(F_)
      : "l"(da), "l"(db), "r"(scale_d));
}

// the same over 8 deep in tf32 (32 bytes a row, as 16 bf16)
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " WG_OUTS
      "%64, %65, p, 1, 1;\n"
      "}\n"
      : WG_D64(F_)
      : "l"(da), "l"(db), "r"(scale_d));
}

// the same over 32 deep in s8, exact s32 accumulation
__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " WG_OUTS
      "%64, %65, p;\n"
      "}\n"
      : WG_D64(R_)
      : "l"(da), "l"(db), "r"(scale_d));
}

#undef WG_OUTS
#undef WG_D8
#undef WG_D64
#undef F_
#undef R_

__device__ __forceinline__ uint32_t pack2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);   // a low
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ uint4 pack8(const float (&x)[8]) {
  return make_uint4(pack2(x[0], x[1]), pack2(x[2], x[3]), pack2(x[4], x[5]),
                    pack2(x[6], x[7]));
}

// NV (4 or 8) consecutive f32 values, `step` elements apart in memory (1:
// row-major; N: a transposed arena); the first n are read (n <= 0: none),
// the rest are 0. Vector loads where step is 1, all NV are in range and
// the address is aligned; scalar loads otherwise, so any stride is taken.
template <int NV>
__device__ __forceinline__ void load_f32(const float* p, long step, int n,
                                         float (&x)[NV]) {
  if (step == 1 && n >= NV && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
#pragma unroll
    for (int i = 0; i < NV / 4; ++i) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(p) + i);
      x[4 * i] = a.x;
      x[4 * i + 1] = a.y;
      x[4 * i + 2] = a.z;
      x[4 * i + 3] = a.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < NV; ++k) x[k] = k < n ? __ldg(p + k * step) : 0.f;
  }
}

// Sixteen int8 values k..k+15 of one row-major row, the first n read.
__device__ __forceinline__ uint4 load_s8x16(const int8_t* p, int n) {
  if (n >= 16 && (reinterpret_cast<uintptr_t>(p) & 15) == 0)
    return __ldg(reinterpret_cast<const uint4*>(p));
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int k = 0; k < 16; ++k)
    if (k < n)
      w[k / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(__ldg(p + k)))
                  << (8 * (k % 4));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Eight consecutive depth values of one row as bf16 (see load_f32).
template <typename T>
struct Run;

template <>
struct Run<float> {
  __device__ __forceinline__ static uint4 load(const float* p, long step,
                                               int n) {
    float x[8];
    load_f32<8>(p, step, n, x);
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

// Three bf16 pieces of eight f32: x = p0 + p1 + p2 to within 2^-24 |x|
// (each remainder is exact in f32, each piece takes its next 8 bits).
__device__ __forceinline__ void split_bf16x3(const float (&x)[8],
                                             uint4 (&o)[3]) {
  float r[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) r[k] = x[k];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    float h[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      h[k] = __bfloat162float(__float2bfloat16_rn(r[k]));
      r[k] = __fsub_rn(r[k], h[k]);
    }
    o[j] = pack8(h);
  }
}

// tf32 pieces of four f32: big = x with its low 13 mantissa bits cleared
// (so what the tensor cores read is defined), small = x - big (exact in
// f32) rounded to tf32.
__device__ __forceinline__ void split_tf32(const float (&x)[4], uint4& big,
                                           uint4& small) {
  uint32_t b[4], s[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    b[k] = __float_as_uint(x[k]) & 0xffffe000u;
    const float rest = __fsub_rn(x[k], __uint_as_float(b[k]));
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(s[k]) : "f"(rest));
  }
  big = make_uint4(b[0], b[1], b[2], b[3]);
  small = make_uint4(s[0], s[1], s[2], s[3]);
}

// The raw staging of the arena: each thread copies CH-byte chunks (CE
// values) of its rows with cp.async, laid out [j][thread] so a warp's
// accesses are contiguous, and put() converts a chunk into its OUTB bytes
// in each of the form's planes of the stage (PLANE bytes apart).
template <typename T>
struct Raw;

template <>
struct Raw<float> {                  // f32 -> bf16
  static constexpr int CH = 16, CE = 4, OUTB = 8;
  __device__ __forceinline__ static void put(const uint8_t* p, uint8_t* o) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    *reinterpret_cast<uint2*>(o) =
        make_uint2(pack2(a.x, a.y), pack2(a.z, a.w));
  }
};

template <>
struct Raw<__nv_bfloat16> {
  static constexpr int CH = 16, CE = 8, OUTB = 16;
  __device__ __forceinline__ static void put(const uint8_t* p, uint8_t* o) {
    *reinterpret_cast<uint4*>(o) = *reinterpret_cast<const uint4*>(p);
  }
};

template <>
struct Raw<int8_t> {                 // codes -> bf16
  static constexpr int CH = 8, CE = 8, OUTB = 16;
  __device__ __forceinline__ static void put(const uint8_t* p, uint8_t* o) {
    const uint2 a = *reinterpret_cast<const uint2*>(p);
    float x[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      x[k] = static_cast<float>(static_cast<int8_t>(
          ((k < 4 ? a.x : a.y) >> (8 * (k % 4))) & 0xff));
    *reinterpret_cast<uint4*>(o) = pack8(x);   // |code| <= 127: exact
  }
};

struct RawTf32 {                     // f32 -> tf32 big, small
  static constexpr int CH = 16, CE = 4, OUTB = 16;
  __device__ __forceinline__ static void put(const uint8_t* p, uint8_t* o) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float x[4] = {a.x, a.y, a.z, a.w};
    uint4 big, small;
    split_tf32(x, big, small);
    *reinterpret_cast<uint4*>(o) = big;
    *reinterpret_cast<uint4*>(o + TILE_BYTES) = small;
  }
};

// ---- the forms: operand planes, loads and the product of one k-step ----
// KE: depth of a stage (one 128-byte plane row); QP / VP: query / arena
// planes; qrun / vrun: the 16-byte run of each plane at depth k.. of one
// row (n values left in the row); step: the products of one 32-byte
// k-step at descriptor offset `off`, overwriting d where scale_d is 0;
// MAXST: the deepest ring the planner tries; DIRECT: the arena is copied
// into the stage as it is (no raw staging, no conversion); CWG: consumer
// warpgroups of 64 queries a block; PARTIAL: each depth chunk's products
// are summed apart (see the consumers); NAN_PAST_G: members past G are
// padded with biasA NaN and the fold takes no branch (its loads and
// chains then interleave: form 3's fold is what holds it, the other forms
// are held by their producer and lose more to the padding's work).

template <typename Q, typename V>
struct Bf16Form {          // forms 1, 2, 5: one bf16 product
  using TQ = Q;
  using TV = V;
  using Acc = float;
  using R = Raw<V>;
  static constexpr int KE = 64, QP = 1, VP = 1, MAXST = 4, CH = R::CH;
  static constexpr int CWG = 2;
  static constexpr bool DIRECT = false, PARTIAL = false, NAN_PAST_G = false;
  __device__ __forceinline__ static void qrun(const TQ* p, int n,
                                              uint4 (&o)[QP]) {
    o[0] = Run<TQ>::load(p, 1, n);
  }
  __device__ __forceinline__ static void vrun(const TV* p, long step, int n,
                                              uint4 (&o)[VP]) {
    o[0] = Run<TV>::load(p, step, n);
  }
  __device__ __forceinline__ static void step(float (&d)[64],
                                              const uint64_t (&da)[QP],
                                              const uint64_t (&db)[VP],
                                              int off, int scale_d) {
    wgmma_bf16(d, da[0] + off, db[0] + off, scale_d);
  }
};

struct AsymForm {          // form 4: three bf16 pieces of q x codes
  using TQ = float;
  using TV = int8_t;
  using Acc = float;
  using R = Raw<int8_t>;
  static constexpr int KE = 64, QP = 3, VP = 1, MAXST = 4, CH = R::CH;
  static constexpr int CWG = 2;
  static constexpr bool DIRECT = false, PARTIAL = false, NAN_PAST_G = false;
  __device__ __forceinline__ static void qrun(const float* p, int n,
                                              uint4 (&o)[QP]) {
    float x[8];
    load_f32<8>(p, 1, n, x);
    split_bf16x3(x, o);
  }
  __device__ __forceinline__ static void vrun(const int8_t* p, long step,
                                              int n, uint4 (&o)[VP]) {
    o[0] = Run<int8_t>::load(p, step, n);
  }
  __device__ __forceinline__ static void step(float (&d)[64],
                                              const uint64_t (&da)[QP],
                                              const uint64_t (&db)[VP],
                                              int off, int scale_d) {
    // the smallest piece first
    wgmma_bf16(d, da[2] + off, db[0] + off, scale_d);
    wgmma_bf16(d, da[1] + off, db[0] + off, 1);
    wgmma_bf16(d, da[0] + off, db[0] + off, 1);
  }
};

struct F32Form {           // form 0: 3xTF32
  using TQ = float;
  using TV = float;
  using Acc = float;
  using R = RawTf32;
  static constexpr int KE = 32, QP = 2, VP = 2, MAXST = 4, CH = R::CH;
  static constexpr int CWG = 1;
  static constexpr bool DIRECT = false, PARTIAL = true, NAN_PAST_G = false;
  __device__ __forceinline__ static void qrun(const float* p, int n,
                                              uint4 (&o)[QP]) {
    float x[4];
    load_f32<4>(p, 1, n, x);
    split_tf32(x, o[0], o[1]);
  }
  __device__ __forceinline__ static void vrun(const float* p, long step,
                                              int n, uint4 (&o)[VP]) {
    float x[4];
    load_f32<4>(p, step, n, x);
    split_tf32(x, o[0], o[1]);
  }
  __device__ __forceinline__ static void step(float (&d)[64],
                                              const uint64_t (&da)[QP],
                                              const uint64_t (&db)[VP],
                                              int off, int scale_d) {
    // the small terms first: small.big, big.small, then big.big
    wgmma_tf32(d, da[1] + off, db[0] + off, scale_d);
    wgmma_tf32(d, da[0] + off, db[1] + off, 1);
    wgmma_tf32(d, da[0] + off, db[0] + off, 1);
  }
};

struct Int8Form {          // form 3: s8 x s8, exact
  using TQ = int8_t;
  using TV = int8_t;
  using Acc = int;
  static constexpr int KE = 128, QP = 1, VP = 1, MAXST = STAGES_MAX, CH = 16;
  static constexpr int CWG = 2;
  static constexpr bool DIRECT = true, PARTIAL = false, NAN_PAST_G = true;
  __device__ __forceinline__ static void qrun(const int8_t* p, int n,
                                              uint4 (&o)[QP]) {
    o[0] = load_s8x16(p, n);
  }
  __device__ __forceinline__ static void vrun(const int8_t* p, long, int n,
                                              uint4 (&o)[VP]) {
    o[0] = load_s8x16(p, n);
  }
  __device__ __forceinline__ static void step(int (&d)[64],
                                              const uint64_t (&da)[QP],
                                              const uint64_t (&db)[VP],
                                              int off, int scale_d) {
    wgmma_s8(d, da[0] + off, db[0] + off, scale_d);
  }
};

// run u (16 bytes at 16u) of row r of a swizzled 128-row plane
__device__ __forceinline__ void store_run(uint8_t* tile, int r, int u,
                                          uint4 x) {
  *reinterpret_cast<uint4*>(tile + r * 128 + ((u ^ (r & 7)) << 4)) = x;
}

// the query runs of every plane at depth k of query b (zeros past B)
template <class F>
__device__ __forceinline__ void query_run(const Params& p, int b, int k,
                                          uint4 (&o)[F::QP]) {
  if (b >= p.B) {
#pragma unroll
    for (int j = 0; j < F::QP; ++j) o[j] = make_uint4(0, 0, 0, 0);
    return;
  }
  F::qrun(static_cast<const typename F::TQ*>(p.q) +
              static_cast<long>(b) * p.D + k,
          p.D - k, o);
}

// bytes of one raw staging slot: 128 rows x one stage's depth, then the
// biases
template <class F>
__host__ __device__ constexpr int raw_slot_bytes() {
  return 128 * F::KE * static_cast<int>(sizeof(typename F::TV)) + BIAS_BYTES;
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
// wait until at most n groups are pending, n < STAGES_MAX - 1
__device__ __forceinline__ void cp_async_wait_n(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<7>(); break;
  }
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

  // biasA of tile row r where its row does not exist: +inf, or with
  // `nan_past_g` NaN for a member past G, which then never wins the
  // fold's `<=` (so the fold needs no branch)
  __device__ __forceinline__ float absent(const Params& p, int r,
                                          bool nan_past_g) const {
    return nan_past_g && 2 * c + r / GB >= p.G ? __int_as_float(0x7fffffff)
                                               : INFINITY;
  }
};

// a block's threads: the consumer warpgroups, then the producer
template <class F>
__host__ __device__ constexpr int threads() {
  return 128 * (F::CWG + 1);
}

template <class F, bool VT>
__global__ void __launch_bounds__(threads<F>(), 1)
    pass_a_wgmma_kernel(const Params p) {
  using TV = typename F::TV;
  using Acc = typename F::Acc;
  constexpr int RUN = F::KE / 8;            // values in a 16-byte run
  constexpr int QB = 64 * F::CWG;           // queries per block
  constexpr int QTILE = QB * 128;           // one query plane's bytes
  constexpr int CONSUMERS = 128 * F::CWG;   // consumer threads
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int stage_bytes = TILE_BYTES * F::VP +
                          (p.streamed ? QTILE * F::QP : 0) + BIAS_BYTES;
  uint8_t* a_res = smem;                    // the resident query slab
  uint8_t* ring = smem + (p.streamed ? 0 : p.nkc * F::QP * QTILE);
  uint8_t* raw_ring = ring + p.stages * stage_bytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(
      raw_ring + (p.vec && !F::DIRECT ? RAW * raw_slot_bytes<F>() : 0));
  uint64_t* empty = full + STAGES_MAX;

  const int slab = blockIdx.x % p.nslabs;
  const int unit0 = (blockIdx.x / p.nslabs) * p.units_per_block;
  const int nunits = min(p.units_per_block, p.units - unit0);
  const int b0 = slab * QB;
  const int nitems = nunits * p.nch * p.nkc;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&full[s], 128);      // the producer's threads
      mbar_init(&empty[s], CONSUMERS);   // the consumers' threads
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (!p.streamed) {
    for (int e = tid; e < p.nkc * QB * 8; e += threads<F>()) {
      const int kc = e / (QB * 8), r = (e / 8) % QB, u = e % 8;
      uint4 x[F::QP];
      query_run<F>(p, b0 + r, kc * F::KE + RUN * u, x);
#pragma unroll
      for (int j = 0; j < F::QP; ++j)
        store_run(a_res + (kc * F::QP + j) * QTILE, r, u, x[j]);
    }
    fence_proxy_async();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // ---- producer warpgroup ----
    // For the query chunk (streamed) and the direct copy, thread t owns
    // run u = t % 8 (16 bytes at 16u) of rows r0 + 16 i (i < 8 for the
    // arena's 128 rows, i < QB / 16 for the queries), r0 = t / 8; every
    // such row has the same swizzled offset within its 128 bytes.
    const int t = tid - CONSUMERS, r0 = t / 8, u = t % 8;
    const int at = r0 * 128 + ((u ^ (r0 & 7)) << 4);   // + i * 2048
    const TV* v = static_cast<const TV*>(p.v);
    // the tile's biases (row t), then (when streamed) the query chunk;
    // rows that do not exist score +inf
    auto finish = [&](const Cursor& I, uint8_t* st, const float* rawA,
                      const float* rawB) {
      bool in;
      const long row = I.row(p, t, in);
      float* bias = reinterpret_cast<float*>(st + stage_bytes - BIAS_BYTES);
      bias[t] = !in ? I.absent(p, t, F::NAN_PAST_G) : rawA ? rawA[t]
                                                           : p.biasA[row];
      bias[NB + t] = !in ? 0.f : VT ? 2.f : rawB ? rawB[t] : p.biasB[row];
      if (p.streamed) {
        uint4 x[QB / 16][F::QP];
#pragma unroll
        for (int i = 0; i < QB / 16; ++i)
          query_run<F>(p, b0 + r0 + 16 * i, I.kc * F::KE + RUN * u, x[i]);
#pragma unroll
        for (int i = 0; i < QB / 16; ++i)
#pragma unroll
          for (int j = 0; j < F::QP; ++j)
            *reinterpret_cast<uint4*>(st + F::VP * TILE_BYTES + j * QTILE +
                                      at + i * 2048) = x[i][j];
      }
    };
    int s = 0;
    uint32_t ph = 0;
    Cursor cur(p, unit0);
    if (p.vec) {
      if constexpr (F::DIRECT) {
        // Row-major arena of 16-byte-aligned rows whose values go to the
        // tensor cores as they are: cp.async copies each 16-byte run straight
        // into its swizzled place in the stage, stages - 2 items ahead (the
        // consumers hold up to two stages: a chunk's is released once the
        // next chunk's products are issued); once an item's copies have
        // landed, its rows that do not exist get biasA +inf, and the stage
        // is handed over.
        const int ahead_n = p.stages - 2;
        auto issue = [&](const Cursor& I, uint8_t* st) {
          const uint32_t dst = smem_u32(st) + at;
          const int k = I.kc * F::KE + RUN * u;
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            bool in;
            const long row = I.row(p, r0 + 16 * i, in);
            const bool ok = in && k < p.D;   // whole run or none
            cp_async16(dst + i * 2048, ok ? v + row * p.D + k : v,
                       ok ? 16 : 0);
          }
          bool in;
          const long row = I.row(p, t, in);
          const uint32_t bias = smem_u32(st + stage_bytes - BIAS_BYTES);
          cp_async4(bias + 4 * t, in ? p.biasA + row : p.biasA, in ? 4 : 0);
          cp_async4(bias + 4 * (NB + t), in ? p.biasB + row : p.biasB,
                    in ? 4 : 0);
        };
        Cursor ahead = cur;
        int s_in = 0;
        uint32_t ph_in = 0;
        for (int it = 0; it < nitems + ahead_n; ++it) {
          if (it < nitems) {
            mbar_wait(&empty[s_in], ph_in ^ 1);
            uint8_t* st = ring + s_in * stage_bytes;
            issue(ahead, st);
            if (p.streamed) {
              // the query chunk, loaded synchronously (large D only)
              uint4 x[QB / 16][F::QP];
#pragma unroll
              for (int i = 0; i < QB / 16; ++i)
                query_run<F>(p, b0 + r0 + 16 * i, ahead.kc * F::KE + RUN * u,
                             x[i]);
#pragma unroll
              for (int i = 0; i < QB / 16; ++i)
                *reinterpret_cast<uint4*>(st + F::VP * TILE_BYTES + at +
                                          i * 2048) = x[i][0];
            }
            ahead.next(p);
            if (++s_in == p.stages) {
              s_in = 0;
              ph_in ^= 1;
            }
          }
          cp_async_commit();
          if (it < ahead_n) continue;
          cp_async_wait_n(ahead_n);          // item it - ahead_n has landed
          bool in;
          cur.row(p, t, in);
          if (!in) {
            float* bias = reinterpret_cast<float*>(ring + s * stage_bytes +
                                                   stage_bytes - BIAS_BYTES);
            bias[t] = cur.absent(p, t, F::NAN_PAST_G);
          }
          cur.next(p);
          fence_proxy_async();
          mbar_arrive(&full[s]);
          if (++s == p.stages) {
            s = 0;
            ph ^= 1;
          }
        }
      } else {
        // Row-major arena whose runs are chunk-aligned: cp.async copies each
        // thread's runs into a raw staging slot RAW - 1 items ahead, with no
        // registers held; the thread then converts its own runs (visible to
        // it after cp.async.wait_group) into the swizzled stage's planes.
        // Thread t copies chunk q = t % CPR (depth q*CE ..) of the tile rows
        // rb + RPP j, j < CPR, rb = t / CPR: rows 0-63 are member 2c,
        // 64-127 member 2c + 1, and every such row puts the chunk's output
        // at the same swizzled offset `out`.
        using R = typename F::R;
        constexpr int CPR = F::KE * static_cast<int>(sizeof(TV)) / R::CH;
        constexpr int RPP = 128 / CPR;           // rows per pass: 8 or 16
        const int q = t % CPR, rb = t / CPR;
        const int out = rb * 128 + ((((q * R::OUTB) >> 4) ^ (rb & 7)) << 4) +
                        ((q * R::OUTB) & 15);    // + j * RPP * 128
        const uint32_t raw0 = smem_u32(raw_ring);
        auto issue = [&](const Cursor& I, int slot_no) {
          const uint32_t slot = raw0 + slot_no * raw_slot_bytes<F>();
          const long rowb =
              I.tbase + static_cast<long>(2 * I.c) * p.W + I.j0 + rb;
          const int k = I.kc * F::KE + q * R::CE;
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
          const uint32_t bias = slot + 128 * F::KE * sizeof(TV);
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
          const uint8_t* slot = raw_ring + slot_out * raw_slot_bytes<F>();
          if (++slot_out == RAW) slot_out = 0;
          mbar_wait(&empty[s], ph ^ 1);
          uint8_t* st = ring + s * stage_bytes;
#pragma unroll
          for (int j = 0; j < CPR; ++j)
            R::put(slot + (j * 128 + t) * R::CH, st + out + j * RPP * 128);
          const float* rawA =
              reinterpret_cast<const float*>(slot + 128 * F::KE * sizeof(TV));
          finish(cur, st, rawA, rawA + NB);
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
      // Any other stride (a transposed arena, a row length that breaks the
      // chunk alignment): synchronous loads, vector ones where aligned.
      for (int it = 0; it < nitems; ++it) {
        mbar_wait(&empty[s], ph ^ 1);
        uint8_t* st = ring + s * stage_bytes;
        uint4 x[8][F::VP];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          // row-major: 8 neighbouring threads read one row's 8 runs;
          // transposed: neighbouring threads read neighbouring rows
          const int e = t + 128 * i;
          const int r = VT ? e % NB : e / 8, ru = VT ? e / NB : e % 8;
          bool in;
          const long row = cur.row(p, r, in);
          const int k = cur.kc * F::KE + RUN * ru;
#pragma unroll
          for (int j = 0; j < F::VP; ++j) x[i][j] = make_uint4(0, 0, 0, 0);
          if (in) {
            if (VT)
              F::vrun(v + static_cast<long>(k) * p.N + row, p.N, p.D - k,
                      x[i]);
            else
              F::vrun(v + row * p.D + k, 1, p.D - k, x[i]);
          }
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int e = t + 128 * i;
#pragma unroll
          for (int j = 0; j < F::VP; ++j)
            store_run(st + j * TILE_BYTES, VT ? e % NB : e / 8,
                      VT ? e / NB : e % 8, x[i][j]);
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
    Acc acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0;
    // PARTIAL: each depth chunk's products go to a fresh accumulator and
    // are added to `sum` rounded to nearest: the tensor cores truncate as
    // they accumulate, an error that grows with the products summed into
    // one accumulator
    float sum[F::PARTIAL ? 64 : 1];
    auto dot = [&](int n) -> float {       // accumulator n as f32
      if constexpr (F::PARTIAL)
        return sum[n];
      else
        return acc_float(acc[n]);
    };
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
        // that read it has completed (PARTIAL: each chunk's group completes
        // before its sum is taken; the last chunk's stage, which carries
        // the biases, is released after the fold)
        int prev = 0;
        for (int kc = 0; kc < p.nkc; ++kc) {
          mbar_wait(&full[s], ph);
          const uint8_t* st = ring + s * stage_bytes;
          uint64_t da[F::QP], db[F::VP];
#pragma unroll
          for (int j = 0; j < F::QP; ++j)
            da[j] = sw128_desc(
                (p.streamed ? st + F::VP * TILE_BYTES + j * QTILE
                            : a_res + (kc * F::QP + j) * QTILE) +
                wg * 64 * 128);
#pragma unroll
          for (int j = 0; j < F::VP; ++j)
            db[j] = sw128_desc(st + j * TILE_BYTES);
          if (kc == 0 || F::PARTIAL) fence_acc(acc);
          wgmma_fence();
          // the depth tail past D is zero in both operands, so all four
          // 32-byte k-steps run; +32 bytes along K inside the swizzled
          // rows is +2 in the descriptor's 16-byte units
          F::step(acc, da, db, 0, kc > 0 && !F::PARTIAL);
          F::step(acc, da, db, 2, 1);
          F::step(acc, da, db, 4, 1);
          F::step(acc, da, db, 6, 1);
          wgmma_commit();
          if constexpr (F::PARTIAL) {
            wgmma_wait0();
            fence_acc(acc);
#pragma unroll
            for (int i = 0; i < 64; ++i)
              sum[i] = kc > 0 ? __fadd_rn(sum[i], acc[i]) : acc[i];
            if (kc + 1 < p.nkc) mbar_arrive(&empty[s]);
          } else if (kc > 0) {
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
          if (!F::NAN_PAST_G && m >= p.G) continue;
          const int n = 8 * i + cb, j = 2 * (i % 8);
          const float2 bA = *reinterpret_cast<const float2*>(bias + n);
          const float2 bB = *reinterpret_cast<const float2*>(bias + NB + n);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            // separate multiply and subtract (no FMA contraction), as the
            // plain version rounds them; `<=`: a later member wins a tie
            const float s0 =
                __fsub_rn(bA.x, __fmul_rn(dot(4 * i + 2 * h), bB.x));
            const float s1 =
                __fsub_rn(bA.y, __fmul_rn(dot(4 * i + 2 * h + 1), bB.y));
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

template <class F, bool VT>
int launch(Params p, cudaStream_t stream) {
  using TV = typename F::TV;
  constexpr long QB = 64 * F::CWG, QTILE = QB * 128;
  const long ntiles = (static_cast<long>(p.N) + p.ST - 1) / p.ST;
  p.W = p.ST / p.G;
  p.width = ntiles * p.W;
  p.jblocks = (p.W + GB - 1) / GB;
  p.nslabs = static_cast<int>((p.B + QB - 1) / QB);
  p.nch = (p.G + 1) / 2;
  p.nkc = (p.D + F::KE - 1) / F::KE;
  const long units = ntiles * p.jblocks;
  if (units > 0x7fffffffL) return cudaErrorInvalidConfiguration;
  p.units = static_cast<int>(units);
  // The shared-memory plan: cp.async copies where the rows are chunk-
  // aligned, the query slab resident where it fits, then the deepest ring;
  // each in that order of preference. `fixed`: slack for aligning the
  // base to 1024 B, and the barriers.
  const long fixed = 1024 + 2 * STAGES_MAX * 8;
  const bool can_vec =
      !VT && static_cast<long>(p.D) * sizeof(TV) % F::CH == 0 &&
      reinterpret_cast<uintptr_t>(p.v) % F::CH == 0;
  const long raw = F::DIRECT ? 0 : RAW * raw_slot_bytes<F>();
  long smem = 0;
  for (int vec = can_vec; vec >= 0 && !smem; --vec)
    for (int streamed = 0; streamed <= 1 && !smem; ++streamed)
      for (int stages = F::MAXST; stages >= 2 && !smem; --stages) {
        const long total =
            fixed +
            (streamed ? 0 : p.nkc * F::QP * QTILE) +
            stages * (TILE_BYTES * F::VP + (streamed ? F::QP * QTILE : 0) +
                      BIAS_BYTES) +
            (vec ? raw : 0);
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
  auto kernel = pass_a_wgmma_kernel<F, VT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(blocks), threads<F>(),
           static_cast<size_t>(smem), stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

int pass_a_wgmma(const void* q, const void* v, const void* biasA,
                 const void* biasB, void* gmin, void* garg, int B, int N,
                 int D, int ST, int G, int form, bool transposed,
                 cudaStream_t stream) {
  if (B <= 0 || N <= 0 || D <= 0 || G <= 0 || ST <= 0 || ST % G)
    return static_cast<int>(cudaErrorInvalidValue);
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
  using BF16 = Bf16Form<__nv_bfloat16, __nv_bfloat16>;
  if (transposed)
    return form == kBF16 ? launch<BF16, true>(p, stream)
                         : static_cast<int>(cudaErrorInvalidValue);
  switch (form) {
    case kF32:
      return launch<F32Form, false>(p, stream);
    case kF32Fast:
      return launch<Bf16Form<float, float>, false>(p, stream);
    case kBF16:
      return launch<BF16, false>(p, stream);
    case kInt8:
      return launch<Int8Form, false>(p, stream);
    case kAsym:
      return launch<AsymForm, false>(p, stream);
    case kAsymFast:
      return launch<Bf16Form<float, int8_t>, false>(p, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
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
  return pass_a_wgmma(q, v, biasA, biasB, gmin, garg, B, N, D, ST, G, form,
                      false, static_cast<cudaStream_t>(stream));
}

// C entry point of the transposed-arena probe (`scan_vT`), bound with
// ctypes by kektordb_tpu_torch/ops/scan_probe.py. q [B, D] bf16, vT [D, N]
// bf16, bias [N] f32, contiguous on one card; gmin / garg as above, with
// score = bias - 2 * dot. Returns 0 or the CUDA error of the launch.
extern "C" int kektor_scan_vt(const void* q, const void* vT,
                              const void* bias, void* gmin, void* garg,
                              int B, int N, int D, int ST, int G,
                              void* stream) {
  return pass_a_wgmma(q, vT, bias, nullptr, gmin, garg, B, N, D, ST, G, kBF16,
                      true, static_cast<cudaStream_t>(stream));
}
