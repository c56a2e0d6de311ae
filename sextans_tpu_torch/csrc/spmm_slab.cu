// spmm_slab / spmm_slab_skinny: C = alpha * A @ B + beta * C over the
// block_k x 128 dense-slab pack (format/pack_mxu.py).
//
// Replaces: sextans_tpu/ops/spmm_mxu_pallas.py — spmm_mxu_padded / _kernel
// (K1) with spmm_slab_launch, and spmm_mxu_ct_padded / _kernel_ct (K2) with
// spmm_slab_skinny_launch. On the TPU one grid step contracted a block on the
// matrix unit into a (tile_m/128, 128, tile_n) VMEM accumulator carried
// across the M-tile's groups. Here one CUDA block owns one 128-row slab of
// one M-tile (and one N-chunk for K1): it walks the M-tile's group range from
// the host scan of group_mtile (tile_ptr / tile_groups) and takes only the
// blocks whose qm is its slab; the blocks it skips cost two index reads.
// A slab that gets no block still writes beta * C.
//
// Layout: vals[g, i*bk + kk, mm] = A[slab row mm, window col bcol + kk], so a
// block is a (bk, 128) row-major tile; the global B row of kk is
// group_kwin[g] * window_k + bcol[g, i] + kk. Pad slots hold zeros with
// qm = bcol = 0 and add 0 * B[window start]; they are not skipped.
//
// Accumulation order for both kernels: per block,
// contrib = sum_kk vals[kk, mm] * B[row kk, col] in kk order with IEEE f32
// FFMA (no TF32), then acc += contrib; blocks in pack order; epilogue
// alpha * acc + beta * C (C not read when with_c == 0).
//
// What bounds them on the H100: at the slab format's low fill (~5 % on a
// banded FEM matrix) most of the 2 * bk * 128 * n flops of a block multiply
// zeros, so K1 is bound by FFMA issue on padded work (SIMT f32 at best
// ~67 TFLOP/s, no tensor cores yet) and by staging each bk x 128 vals block
// through shared memory once per N-chunk. K2 (n <= 32) reads vals straight
// from global memory, coalesced along the 128 rows; it is bound by the vals
// stream, since each value feeds only n flops.

#include <cuda_runtime.h>

namespace {

constexpr int MSLAB = 128;
constexpr int SLAB_TN = 64;        // K1 columns per CUDA block
constexpr int SLAB_THREADS = 256;  // K1: 16 x 16 threads, 8 rows x 4 cols each

__global__ void __launch_bounds__(SLAB_THREADS) spmm_slab_kernel(
    const float* __restrict__ vals,        // (ng, G * bk, 128)
    const int* __restrict__ qm,            // (ng, G)
    const int* __restrict__ bcol,          // (ng, G)
    const int* __restrict__ group_kwin,    // (ng,)
    const int* __restrict__ tile_ptr,      // (n_mtiles + 1,)
    const int* __restrict__ tile_groups,   // (ng,)
    const float* __restrict__ b,           // (k_padded, n)
    const float* __restrict__ c,           // (m_padded, n) or null
    float* __restrict__ out,               // (m_padded, n)
    int n, int tile_m, int window_k, int block_k, int group_blocks,
    float alpha, float beta, int with_c) {
  extern __shared__ float4 smem4[];
  float* vs = reinterpret_cast<float*>(smem4);  // (bk, 128)
  float* bs = vs + block_k * MSLAB;             // (bk, 64)
  const int nslabs = tile_m / MSLAB;
  const int mt = blockIdx.x / nslabs;
  const int slab = blockIdx.x % nslabs;
  const int n0 = blockIdx.y * SLAB_TN;
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // columns tx*4 .. tx*4+3
  const int ty = tid / 16;  // rows ty*8 .. ty*8+7

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int G = group_blocks;
  const int p1 = tile_ptr[mt + 1];
  for (int p = tile_ptr[mt]; p < p1; ++p) {
    const int g = tile_groups[p];
    const size_t kwin0 = (size_t)group_kwin[g] * window_k;
    for (int i = 0; i < G; ++i) {
      if (qm[(size_t)g * G + i] != slab) continue;  // uniform over the block
      const float* bsrc = b + (kwin0 + bcol[(size_t)g * G + i]) * n;
      const float4* vsrc = reinterpret_cast<const float4*>(
          vals + ((size_t)g * G + i) * block_k * MSLAB);
      __syncthreads();  // the previous block's tiles are no longer read
      for (int e = tid; e < block_k * (MSLAB / 4); e += SLAB_THREADS)
        smem4[e] = vsrc[e];
      for (int e = tid; e < block_k * SLAB_TN; e += SLAB_THREADS) {
        const int kk = e / SLAB_TN, col = n0 + e % SLAB_TN;
        bs[e] = col < n ? bsrc[(size_t)kk * n + col] : 0.f;
      }
      __syncthreads();
      float cf[8][4];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) cf[r][j] = 0.f;
      for (int kk = 0; kk < block_k; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(vs + kk * MSLAB + ty * 8);
        const float4 a1 = *reinterpret_cast<const float4*>(vs + kk * MSLAB + ty * 8 + 4);
        const float4 bv = *reinterpret_cast<const float4*>(bs + kk * SLAB_TN + tx * 4);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bb[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int j = 0; j < 4; ++j) cf[r][j] = fmaf(a[r], bb[j], cf[r][j]);
      }
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[r][j] += cf[r][j];
    }
  }

  const size_t row0 = (size_t)mt * tile_m + slab * MSLAB + ty * 8;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col < n) {
        const size_t idx = (row0 + r) * n + col;
        out[idx] = with_c ? alpha * acc[r][j] + beta * c[idx] : alpha * acc[r][j];
      }
    }
  }
}

// K2: all n <= 32 columns in one CUDA block of 128 * ceil(n / 8) threads;
// thread (cg, mm) owns row mm of the slab and columns cg*8 .. cg*8+7. A warp
// shares cg, so its B loads are one broadcast address and its vals loads
// are 32 consecutive floats. C stays in the (M, N) layout: the TPU's
// transposed-C trick (lane waste at skinny N) has no counterpart here.
__global__ void spmm_slab_skinny_kernel(
    const float* __restrict__ vals, const int* __restrict__ qm,
    const int* __restrict__ bcol, const int* __restrict__ group_kwin,
    const int* __restrict__ tile_ptr, const int* __restrict__ tile_groups,
    const float* __restrict__ b, const float* __restrict__ c,
    float* __restrict__ out, int n, int tile_m, int window_k, int block_k,
    int group_blocks, float alpha, float beta, int with_c) {
  const int nslabs = tile_m / MSLAB;
  const int mt = blockIdx.x / nslabs;
  const int slab = blockIdx.x % nslabs;
  const int mm = threadIdx.x % MSLAB;
  const int c0 = (threadIdx.x / MSLAB) * 8;

  float acc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j] = 0.f;

  const int G = group_blocks;
  const int p1 = tile_ptr[mt + 1];
  for (int p = tile_ptr[mt]; p < p1; ++p) {
    const int g = tile_groups[p];
    const size_t kwin0 = (size_t)group_kwin[g] * window_k;
    for (int i = 0; i < G; ++i) {
      if (qm[(size_t)g * G + i] != slab) continue;
      const float* vp = vals + ((size_t)g * G + i) * block_k * MSLAB + mm;
      const float* bp = b + (kwin0 + bcol[(size_t)g * G + i]) * n + c0;
      float cf[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) cf[j] = 0.f;
      for (int kk = 0; kk < block_k; ++kk) {
        const float a = vp[(size_t)kk * MSLAB];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float bv = c0 + j < n ? bp[(size_t)kk * n + j] : 0.f;
          cf[j] = fmaf(a, bv, cf[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] += cf[j];
    }
  }

  const size_t row = (size_t)mt * tile_m + slab * MSLAB + mm;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (c0 + j < n) {
      const size_t idx = row * n + c0 + j;
      out[idx] = with_c ? alpha * acc[j] + beta * c[idx] : alpha * acc[j];
    }
  }
}

}  // namespace

extern "C" int spmm_slab_launch(
    const void* vals, const void* qm, const void* bcol, const void* group_kwin,
    const void* tile_ptr, const void* tile_groups, const void* b,
    const void* c, void* out, int n_mtiles, int n, int tile_m, int window_k,
    int block_k, int group_blocks, float alpha, float beta, int with_c,
    void* stream) {
  const size_t smem = (size_t)block_k * (MSLAB + SLAB_TN) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      spmm_slab_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(n_mtiles * (tile_m / MSLAB), (n + SLAB_TN - 1) / SLAB_TN);
  spmm_slab_kernel<<<grid, SLAB_THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)vals, (const int*)qm, (const int*)bcol,
      (const int*)group_kwin, (const int*)tile_ptr, (const int*)tile_groups,
      (const float*)b, (const float*)c, (float*)out, n, tile_m, window_k,
      block_k, group_blocks, alpha, beta, with_c);
  return cudaGetLastError();
}

extern "C" int spmm_slab_skinny_launch(
    const void* vals, const void* qm, const void* bcol, const void* group_kwin,
    const void* tile_ptr, const void* tile_groups, const void* b,
    const void* c, void* out, int n_mtiles, int n, int tile_m, int window_k,
    int block_k, int group_blocks, float alpha, float beta, int with_c,
    void* stream) {
  const int threads = MSLAB * ((n + 7) / 8);
  spmm_slab_skinny_kernel<<<n_mtiles * (tile_m / MSLAB), threads, 0,
                            (cudaStream_t)stream>>>(
      (const float*)vals, (const int*)qm, (const int*)bcol,
      (const int*)group_kwin, (const int*)tile_ptr, (const int*)tile_groups,
      (const float*)b, (const float*)c, (float*)out, n, tile_m, window_k,
      block_k, group_blocks, alpha, beta, with_c);
  return cudaGetLastError();
}
