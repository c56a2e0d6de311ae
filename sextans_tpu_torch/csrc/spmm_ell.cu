// spmm_ell: out = alpha * A @ B + beta * C over the ELL gather pack
// (format/pack_ell.py), one group of `lanes` threads per padded row.
//
// Replaces: sextans_tpu/ops/spmm_ell_pallas.py, spmm_ell_gather_padded /
// _kernel (the Pallas TPU kernel K5). The TPU kernel fetched B rows as 4 KiB
// (8, 128) chunks by DMA, double-buffered with per-octet semaphores, and
// pulled each row out with a masked sublane reduction; that is why it
// needed N in {128, 256, 512, 1024} or a multiple of 1024. None of it
// carries over: here each row's group of threads gathers the B rows it
// needs straight from device memory, with 16-byte loads (VEC == 4) when N
// is a multiple of 4 and every operand 16-byte aligned, else 4-byte loads,
// and masks the ragged column edge. Any N works.
//
// Per padded row i (virtual hub rows and padding rows included) and column
// chunk [c0, c0 + VEC):
//   acc = 0; for r in 0 .. R-1, in order:
//     if vals[i, r] != 0: acc = fma(vals[i, r], B[cols[i, r], c0:], acc)
//   out[i, c0:] = fma(alpha, acc, beta * C[i, c0:])   (alpha * acc without C)
// Arithmetic: IEEE f32 FFMA (__fmaf_rn), no TF32; the plain version
// (ops/spmm_ell.py) takes the same roundings in the same order. A slot whose
// value is 0 is selected out, never
// multiplied, so padding is immune to a non-finite B, as the TPU kernel's
// masked extract is. The hub fold of the virtual rows into their real rows
// (out[fold_rows[j]] += out[m_base + j] - beta * C[m_base + j]) runs after
// this kernel, in PyTorch (ops/spmm_ell.py), as the JAX package runs it
// after its kernel.
//
// Precise mode (PRECISE = 1; SpmmConfig.precise 1 and 2 are one computation
// here, as the TPU kernel's one `precise` branch): a compensation `comp`
// beside each accumulator, and per slot whose value is not 0 the exact
// product two_prod(vals[i, r], B[cols[i, r], c]) and one Neumaier step
// (df32.cuh, the TPU kernel's spmm_ell_pallas.py:121-128); then the
// compensated epilogue with or without C (:134-142). A value-0 slot adds
// (0, 0) on the TPU, so selecting it out keeps the same sum. The hub fold
// then runs in f64 (ops/spmm_ell.py). Every level is an `if constexpr`, so
// the plain-mode code is what it was.
//
// Thread map: lanes = the power of two >= ceil(N / VEC), at most 32; a warp
// holds 32 / lanes rows, so a skinny N still fills the warp. Every thread
// reads its row's R (col, val) pairs (broadcast within the row's group, from
// L1) and writes its own output cells: no shared memory, no atomics.
//
// What bounds it on the H100: bytes. The least traffic is 8 * nnz +
// 4 * (K + 2M) * N bytes against 2 * nnz * N flops: at cant_like N = 512,
// 0.124 ms at 3.35 TB/s against 0.058 ms at 67 TFLOP/s. The kernel reads R B
// rows of N floats per padded row, from L2 when neighbouring rows share
// columns and from device memory otherwise; the design keeps those gathers
// wide (16-byte loads, a whole warp on one row at N >= 128) and many (no
// shared memory, one thread group per row, so every SM holds its full share
// of warps).

#include <cuda_runtime.h>

#include "df32.cuh"

namespace {

template <int VEC>
struct Vec;
template <>
struct Vec<1> {
  using T = float;
};
template <>
struct Vec<4> {
  using T = float4;
};

// v * x + a, rounded once
__device__ __forceinline__ float mul_add(float v, float x, float a) {
  return __fmaf_rn(v, x, a);
}
__device__ __forceinline__ float4 mul_add(float v, float4 x, float4 a) {
  return make_float4(mul_add(v, x.x, a.x), mul_add(v, x.y, a.y),
                     mul_add(v, x.z, a.z), mul_add(v, x.w, a.w));
}
__device__ __forceinline__ float epi(float a, float s, float alpha, float beta, bool with_c) {
  return with_c ? __fmaf_rn(alpha, a, __fmul_rn(beta, s)) : __fmul_rn(alpha, a);
}
__device__ __forceinline__ float4 epi(float4 a, float4 s, float alpha, float beta,
                                      bool with_c) {
  return make_float4(epi(a.x, s.x, alpha, beta, with_c), epi(a.y, s.y, alpha, beta, with_c),
                     epi(a.z, s.z, alpha, beta, with_c), epi(a.w, s.w, alpha, beta, with_c));
}

template <int VEC, int PRECISE>
__global__ void spmm_ell_kernel(
    const float* __restrict__ vals,   // (m_padded, R)
    const int* __restrict__ cols,     // (m_padded, R)
    const float* __restrict__ b,      // (k, n)
    const float* __restrict__ c,      // (m_padded, n) or null
    float* __restrict__ out,          // (m_padded, n)
    int m_padded, int r_slots, int n, int lanes_log2, float alpha, float beta,
    int with_c) {
  using T = typename Vec<VEC>::T;
  const size_t tid = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t row = tid >> lanes_log2;
  if (row >= (size_t)m_padded) return;
  const int lanes = 1 << lanes_log2;
  const int lane = (int)(tid & (lanes - 1));
  const float* vrow = vals + row * r_slots;
  const int* crow = cols + row * r_slots;
  const size_t nv = (size_t)n / VEC;  // row length in VEC units
  const T* bv = reinterpret_cast<const T*>(b);
  for (size_t cv = lane; cv < nv; cv += lanes) {
    T acc{}, comp{};  // zero
#pragma unroll 4
    for (int r = 0; r < r_slots; ++r) {
      const float v = __ldg(vrow + r);
      if (v != 0.f) {
        const T x = __ldg(bv + (size_t)__ldg(crow + r) * nv + cv);
        if constexpr (PRECISE) {
          sx_df32::mul_acc_step(v, x, acc, comp);
        } else {
          acc = mul_add(v, x, acc);
        }
      }
    }
    const size_t o = row * nv + cv;
    T s = acc;
    if (with_c) s = __ldg(reinterpret_cast<const T*>(c) + o);
    if constexpr (PRECISE) {
      reinterpret_cast<T*>(out)[o] = sx_df32::epilogue(acc, comp, s, alpha, beta, with_c);
    } else {
      reinterpret_cast<T*>(out)[o] = epi(acc, s, alpha, beta, with_c);
    }
  }
}

template <int VEC, int PRECISE>
cudaError_t launch(const float* vals, const int* cols, const float* b, const float* c,
                   float* out, int m_padded, int r_slots, int n, float alpha, float beta,
                   int with_c, cudaStream_t stream) {
  const int nv = n / VEC;
  int lanes_log2 = 0;
  while ((1 << lanes_log2) < nv && lanes_log2 < 5) ++lanes_log2;
  const int threads = 256;
  const size_t total = (size_t)m_padded << lanes_log2;
  const size_t blocks = (total + threads - 1) / threads;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  spmm_ell_kernel<VEC, PRECISE><<<(unsigned)blocks, threads, 0, stream>>>(
      vals, cols, b, c, out, m_padded, r_slots, n, lanes_log2, alpha, beta, with_c);
  return cudaGetLastError();
}

}  // namespace

extern "C" int spmm_ell_launch(
    const void* vals, const void* cols, const void* b, const void* c, void* out,
    int m_padded, int r_slots, int n, float alpha, float beta, int with_c,
    int precise, int vec, void* stream) {
#define SX_ARGS                                                          \
  (const float*)vals, (const int*)cols, (const float*)b, (const float*)c, \
      (float*)out, m_padded, r_slots, n, alpha, beta, with_c,            \
      (cudaStream_t)stream
  if (precise != 0 && precise != 1) return cudaErrorInvalidValue;
  switch (vec * 2 + precise) {
    case 2: return launch<1, 0>(SX_ARGS);
    case 3: return launch<1, 1>(SX_ARGS);
    case 8: return launch<4, 0>(SX_ARGS);
    case 9: return launch<4, 1>(SX_ARGS);
    default: return cudaErrorInvalidValue;
  }
#undef SX_ARGS
}
