// df32_probe: does the compiled code keep the error-free transforms exact?
//
// Replaces: benchmarks/scratch/mosaic_eft_probe.py, the TPU probe P3. Its two
// Pallas kernels asked whether Mosaic keeps IEEE semantics for df32.h's
// sequences; these two ask nvcc the same about csrc/df32.cuh, compiled with
// the kernels' own flags (nvcc contracts a * b + c into FMA by default).
//
// df32_probe_pairs: elementwise two_sum and two_prod of a and b (the TPU
// probe's (8, 128) inputs). The caller checks s + e == a + b and
// p + pe == a * b in f64.
// df32_probe_chain: per column, the 64-term chain two_prod + acc_step, then
// compensated_epilogue(1, acc, comp): the caller checks that the result's
// error over f64 never exceeds the f32 representation floor of the exact
// dot product.
//
// What bounds them: nothing worth measuring; one thread per element or
// column, a few hundred nanoseconds of launch.

#include <cuda_runtime.h>

#include "df32.cuh"

namespace {

__global__ void pairs_kernel(const float* __restrict__ a, const float* __restrict__ b,
                             float* __restrict__ s, float* __restrict__ e,
                             float* __restrict__ p, float* __restrict__ pe, int count) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  sx_df32::two_sum(a[i], b[i], s[i], e[i]);
  sx_df32::two_prod(a[i], b[i], p[i], pe[i]);
}

__global__ void chain_kernel(const float* __restrict__ v, const float* __restrict__ b,
                             float* __restrict__ out, int terms, int width) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= width) return;
  float acc = 0.f, comp = 0.f;
  for (int j = 0; j < terms; ++j) {
    float p, pe;
    sx_df32::two_prod(v[(size_t)j * width + col], b[(size_t)j * width + col], p, pe);
    sx_df32::acc_step(acc, comp, p, pe);
  }
  out[col] = sx_df32::compensated_epilogue(1.f, acc, comp);
}

}  // namespace

extern "C" int df32_probe_pairs(const void* a, const void* b, void* s, void* e, void* p,
                                void* pe, int count, void* stream) {
  pairs_kernel<<<(count + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)b, (float*)s, (float*)e, (float*)p, (float*)pe, count);
  return cudaGetLastError();
}

extern "C" int df32_probe_chain(const void* v, const void* b, void* out, int terms,
                                int width, void* stream) {
  chain_kernel<<<(width + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
      (const float*)v, (const float*)b, (float*)out, terms, width);
  return cudaGetLastError();
}
