// Shared declarations of the two pass-A kernels (scan_pass_a.cu, the
// CUDA-core kernel and the C entry points; scan_pass_a_wgmma.cu, the
// tensor-core kernel).

#pragma once

#include <cuda_runtime.h>

// pass-A precision forms: the `form` argument of kektor_scan_pass_a
enum PassAForm : int {
  kF32 = 0, kF32Fast = 1, kBF16 = 2, kInt8 = 3, kAsym = 4, kAsymFast = 5
};

// The tensor-core pass A for the forms whose product is bf16 x bf16 with
// f32 accumulation (kF32Fast, kBF16, kAsymFast), and for a transposed bf16
// arena vT [D, N] (`transposed`: form kBF16, biasB the constant 2, not
// read). Arguments as kektor_scan_pass_a's. Returns 0 or a CUDA error.
int pass_a_wgmma(const void* q, const void* v, const void* biasA,
                 const void* biasB, void* gmin, void* garg, int B, int N,
                 int D, int ST, int G, int form, bool transposed,
                 cudaStream_t stream);
