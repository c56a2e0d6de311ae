// spmm_dia: out = alpha * A_dia @ B + beta * C over the diagonal part of a
// hybrid split (ops/hybrid.py): D diagonals, diagonal d holding
// dvals[d, i] = A[i, i + offsets[d]] for every row i.
//
// Replaces: sextans_tpu/ops/spmm_dia_pallas.py, spmm_dia_padded / _kernel
// (the Pallas TPU kernel K6, N > 32) and spmm_dia_ct_padded / _kernel_ct
// (K7, N <= 32). On the TPU the diagonals were grouped into offset clusters
// so that each grid step fetched a few statically indexed (tile_m, tile_n)
// B blocks into VMEM, a diagonal straddling two blocks split into two static
// slices, and K7 ran on B^T and C^T so that M rode the 128 lanes. The caller
// padded B with pad_lo = max(0, -min(offsets)) zero rows above and enough
// zero rows below for every read. None of that carries over: a thread reads
// B row i + off straight from device memory, and a row outside [0, k) reads
// as 0, which is what the zero padding held, so B needs no padded copy and
// no offset is trusted for an address. dvals is one (D, m) array for both
// kernels; B and C stay (k, n) and (m, n), row-major.
//
// Per output cell (i, j), for d = 0 .. D-1 in ascending offset order (the
// order the TPU kernel's clusters give):
//   acc = fma(dvals[d, i], B[i + offsets[d], j], acc)      from acc = 0
//   out[i, j] = fma(alpha, acc, beta * C[i, j])   (alpha * acc without C)
// Every diagonal entry is multiplied, stored zeros included, as on the TPU.
// Arithmetic: IEEE f32 FFMA (__fmaf_rn), no TF32; the plain versions
// (ops/spmm_dia.py) take the same roundings in the same order.
//
// Precise mode (PRECISE = 1; the TPU kernels' one `precise` branch, which
// SpmmConfig.precise 1 and 2 both reach): per diagonal, in the same order,
// the exact product two_prod(dvals[d, i], B[i + off, j]) and one Neumaier
// step into (acc, comp) (df32.cuh; spmm_dia_pallas.py:90-99 and 264-271).
// The TPU starts from (p, -pe) on the first diagonal, which is the step
// from (0, 0). Then the compensated epilogue (:103-110, :275-282). A row
// outside [0, k) reads 0, whose product is (0, 0). spmm_dia keeps a
// `comp` beside each of its RT rows of `acc` (for sm_90a, `ptxas -v`: 137
// registers a thread at VEC = 4 against 88 in plain mode, no spill). Every
// level is an `if constexpr`, so the plain-mode code is what it was.
//
// spmm_dia (N > 32): a block of up to 128 threads covers RT = 8 consecutive
// rows and 128 * VEC columns; a thread owns VEC columns (16-byte loads when
// N % 4 == 0 and the operands are 16-byte aligned) of its RT rows and keeps
// RT accumulators and an RT-row window of B in registers. Row i + off of B
// for the window's slot r is row i + 1 + (off - 1) for slot r - 1, so when
// the next offset is the last plus one (the bands of stencil and circuit
// matrices) the window shifts by one row and loads one new B row instead of
// RT. The offset is the same for the whole block, so the branch is uniform.
//
// spmm_dia_skinny (N <= 32): a row is at most 128 bytes, so consecutive
// threads walk the flattened (row, column) index of the row-major B and C:
// a warp covers 32 consecutive floats of C and, per diagonal, of B, shifted
// by off * n. This coalesces without the TPU's transposes.
//
// What bounds it on the H100: the least traffic is dvals once, B once and C
// in and out, 4 * (D * M + K * N + 2 * M * N) bytes, against 2 * D * M * N
// flops; at scircuit_like N = 512 (D = 121, M = 170,998) that is 0.34 ms at
// 3.35 TB/s against 0.32 ms at 67 TFLOP/s. Without a shared-memory window a
// B row is read once per diagonal that touches it, from L1 or L2 (121 times
// on scircuit_like, 350 MB of B at N = 512, 7x the L2), so the kernel is
// bound by that re-reading; the register window cuts it for consecutive
// offsets only.

#include <cuda_runtime.h>

#include "df32.cuh"

namespace {

constexpr int kRows = 8;  // RT: rows per thread of spmm_dia

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

// Row `row` of B, vector column `cv`; rows outside [0, k) read as zero.
template <typename T>
__device__ __forceinline__ T b_row(const T* __restrict__ bv, long long row, int k,
                                   size_t nv, int cv) {
  T x{};
  if (row >= 0 && row < k) x = __ldg(bv + (size_t)row * nv + cv);
  return x;
}

template <int VEC, int PRECISE>
__global__ void spmm_dia_kernel(
    const float* __restrict__ dvals,  // (D, m)
    const int* __restrict__ offsets,  // (D,), ascending
    const float* __restrict__ b,      // (k, n)
    const float* __restrict__ c,      // (m, n) or null
    float* __restrict__ out,          // (m, n)
    int m, int k, int n, int n_diags, float alpha, float beta, int with_c) {
  using T = typename Vec<VEC>::T;
  const size_t nv = (size_t)n / VEC;
  const int cv = blockIdx.y * blockDim.x + threadIdx.x;
  if ((size_t)cv >= nv) return;
  const long long row0 = (long long)blockIdx.x * kRows;
  const T* bv = reinterpret_cast<const T*>(b);

  T acc[kRows], comp[kRows], win[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = comp[r] = T{};
  int prev = 0;
  for (int d = 0; d < n_diags; ++d) {
    const int off = __ldg(offsets + d);
    if (d > 0 && off == prev + 1) {
#pragma unroll
      for (int r = 0; r < kRows - 1; ++r) win[r] = win[r + 1];
      win[kRows - 1] = b_row(bv, row0 + kRows - 1 + off, k, nv, cv);
    } else {
#pragma unroll
      for (int r = 0; r < kRows; ++r) win[r] = b_row(bv, row0 + r + off, k, nv, cv);
    }
    prev = off;
    const float* dv = dvals + (size_t)d * m;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (row0 + r >= m) continue;
      if constexpr (PRECISE) {
        sx_df32::mul_acc_step(__ldg(dv + row0 + r), win[r], acc[r], comp[r]);
      } else {
        acc[r] = mul_add(__ldg(dv + row0 + r), win[r], acc[r]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (row0 + r >= m) break;
    const size_t o = (size_t)(row0 + r) * nv + cv;
    T s = acc[r];
    if (with_c) s = __ldg(reinterpret_cast<const T*>(c) + o);
    if constexpr (PRECISE) {
      reinterpret_cast<T*>(out)[o] = sx_df32::epilogue(acc[r], comp[r], s, alpha, beta, with_c);
    } else {
      reinterpret_cast<T*>(out)[o] = epi(acc[r], s, alpha, beta, with_c);
    }
  }
}

template <int PRECISE>
__global__ void spmm_dia_skinny_kernel(
    const float* __restrict__ dvals,  // (D, m)
    const int* __restrict__ offsets,  // (D,), ascending
    const float* __restrict__ b,      // (k, n)
    const float* __restrict__ c,      // (m, n) or null
    float* __restrict__ out,          // (m, n)
    int m, int k, int n, int n_diags, float alpha, float beta, int with_c) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)m * n) return;
  const long long row = (long long)(idx / n);
  const int col = (int)(idx - (size_t)row * n);
  float acc = 0.f, comp = 0.f;
  for (int d = 0; d < n_diags; ++d) {
    const float x = b_row(b, row + __ldg(offsets + d), k, (size_t)n, col);
    if constexpr (PRECISE) {
      sx_df32::mul_acc_step(__ldg(dvals + (size_t)d * m + row), x, acc, comp);
    } else {
      acc = __fmaf_rn(__ldg(dvals + (size_t)d * m + row), x, acc);
    }
  }
  const float s = with_c ? __ldg(c + idx) : 0.f;
  if constexpr (PRECISE) {
    out[idx] = sx_df32::epilogue(acc, comp, s, alpha, beta, with_c);
  } else {
    out[idx] = epi(acc, s, alpha, beta, with_c);
  }
}

template <int VEC, int PRECISE>
cudaError_t launch_wide(const float* dvals, const int* offsets, const float* b, const float* c,
                        float* out, int m, int k, int n, int n_diags, float alpha, float beta,
                        int with_c, cudaStream_t stream) {
  const int nv = n / VEC;
  const int threads = nv >= 128 ? 128 : (nv + 31) / 32 * 32;
  const dim3 grid((m + kRows - 1) / kRows, (nv + threads - 1) / threads);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  spmm_dia_kernel<VEC, PRECISE><<<grid, threads, 0, stream>>>(
      dvals, offsets, b, c, out, m, k, n, n_diags, alpha, beta, with_c);
  return cudaGetLastError();
}

}  // namespace

#define SX_ARGS                                                                 \
  (const float*)dvals, (const int*)offsets, (const float*)b, (const float*)c, \
      (float*)out, m, k, n, n_diags, alpha, beta, with_c

extern "C" int spmm_dia_launch(
    const void* dvals, const void* offsets, const void* b, const void* c, void* out,
    int m, int k, int n, int n_diags, float alpha, float beta, int with_c, int precise,
    int vec, void* stream) {
  if (precise != 0 && precise != 1) return cudaErrorInvalidValue;
  switch (vec * 2 + precise) {
    case 2: return launch_wide<1, 0>(SX_ARGS, (cudaStream_t)stream);
    case 3: return launch_wide<1, 1>(SX_ARGS, (cudaStream_t)stream);
    case 8: return launch_wide<4, 0>(SX_ARGS, (cudaStream_t)stream);
    case 9: return launch_wide<4, 1>(SX_ARGS, (cudaStream_t)stream);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" int spmm_dia_skinny_launch(
    const void* dvals, const void* offsets, const void* b, const void* c, void* out,
    int m, int k, int n, int n_diags, float alpha, float beta, int with_c, int precise,
    void* stream) {
  if (precise != 0 && precise != 1) return cudaErrorInvalidValue;
  const int threads = 256;
  const size_t blocks = ((size_t)m * n + threads - 1) / threads;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  auto kernel = precise ? spmm_dia_skinny_kernel<1> : spmm_dia_skinny_kernel<0>;
  kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(SX_ARGS);
  return cudaGetLastError();
}

#undef SX_ARGS
