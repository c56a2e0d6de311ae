// spmm_block.cuh: the block kernel, C = alpha * A @ B + beta * C over the
// 8 x block_k block pack (format/pack.py), one CUDA block per (M-tile,
// N-chunk). spmm_block.cu holds its C entry point and plain mode;
// spmm_block_precise1.cu and spmm_block_precise2.cu instantiate the two
// precise levels, so that the build compiles the three apart, in parallel.
//
// Replaces: sextans_tpu/ops/spmm_pallas.py, spmm_pallas_padded / _kernel
// (the Pallas TPU kernel K3). On the TPU the groups of an M-tile ran in order
// along a sequential grid axis and the accumulator lived in VMEM across grid
// steps; here one CUDA block walks its M-tile's group range [g0, g1) itself,
// taken from a host scan of group_mtile (tile_ptr / tile_groups, uploaded
// once with the plan), so empty and out-of-order M-tiles need no special
// case: a tile whose range is empty still writes beta * C.
//
// Thread map: 8 * tile_n threads; thread (r, c) owns accumulator rows
// q*8 + r of column c for every row stripe q of the tile. Every update of an
// accumulator cell comes from the one thread that owns it, so there are no
// races, atomics or barriers. The accumulator (tile_m x tile_n f32) is in
// dynamic shared memory: 128 KB at tile_m = 512, tile_n = 64.
//
// Accumulation order (the TPU's, spmm_pallas.py:113-136): for each block,
// contrib = sum_j v[r, j] * B[kw * window_k + bcol + j, col] in j order with
// IEEE f32 FFMA (no TF32 anywhere), then acc += contrib; blocks in pack
// order; epilogue alpha * acc + beta * C (C not read when with_c == 0).
//
// Precise levels (PRECISE, SpmmConfig.precise; spmm_pallas.py:99-134,
// 160-176), with the error-free transforms of df32.cuh: a second array
// comp beside acc in shared memory, and each block visit is a Neumaier step
// acc_step(acc, comp, contrib) instead of acc += contrib; the epilogue is
// compensated_epilogue, one final rounding. Level 1 keeps the FFMA contrib
// chain; level 2 runs the EFT inner chain (two_prod per term, two_sum per
// partial sum, the residuals summed into cerr, acc_step(acc, comp, contrib,
// cerr)). The TPU merged n_acc Kahan pairs in its epilogue; here there is
// one pair per cell. PRECISE == 0 compiles to the plain kernel above.
//
// What bounds it on the H100: the B-row gather. Each block reads block_k
// B rows of tile_n floats per 8-row stripe, and the 8 row threads of a
// column re-read the same B element (served from L1), for 2 * 8 * block_k
// flops per column; with one 128 KB block per SM it is latency-bound on
// those loads. n_acc and chunk_unroll of SpmmConfig are TPU scheduling
// hints and are ignored here. Precise mode needs 8 bytes of shared memory
// per cell, so the wrapper narrows tile_n (56 columns at tile_m = 512).

#pragma once

#include <cuda_runtime.h>

#include "df32.cuh"

namespace sx_block {

template <int BK, int PRECISE>
__global__ void spmm_block_kernel(
    const float* __restrict__ vals,        // (ng, 8, G * BK)
    const int* __restrict__ qrow,          // (ng, G)
    const int* __restrict__ bcol,          // (ng, G)
    const int* __restrict__ group_kwin,    // (ng,)
    const int* __restrict__ tile_ptr,      // (n_mtiles + 1,)
    const int* __restrict__ tile_groups,   // (ng,)
    const float* __restrict__ b,           // (k_padded, n)
    const float* __restrict__ c,           // (m_padded, n) or null
    float* __restrict__ out,               // (m_padded, n)
    int n, int tile_m, int window_k, int group_blocks, int tile_n,
    float alpha, float beta, int with_c) {
  extern __shared__ float acc[];  // (tile_m, tile_n), then comp if PRECISE
  float* comp = acc + (size_t)tile_m * tile_n;  // read only when PRECISE
  const int mt = blockIdx.x;
  const int cl = threadIdx.x % tile_n;
  const int r = threadIdx.x / tile_n;
  const int col = blockIdx.y * tile_n + cl;
  if (col >= n) return;  // ragged last chunk; the kernel has no barriers

  const int stripes = tile_m / 8;
  for (int s = 0; s < stripes; ++s) {
    acc[(s * 8 + r) * tile_n + cl] = 0.f;
    if constexpr (PRECISE != 0) comp[(s * 8 + r) * tile_n + cl] = 0.f;
  }

  const int G = group_blocks;
  const size_t row_len = (size_t)G * BK;
  const int p1 = tile_ptr[mt + 1];
  for (int p = tile_ptr[mt]; p < p1; ++p) {
    const int g = tile_groups[p];
    const float* vrow = vals + ((size_t)g * 8 + r) * row_len;
    const int* qg = qrow + (size_t)g * G;
    const int* bg = bcol + (size_t)g * G;
    const float* bwin = b + (size_t)group_kwin[g] * window_k * n + col;
#pragma unroll 4
    for (int i = 0; i < G; ++i) {
      const int q = qg[i];
      const float* bp = bwin + (size_t)bg[i] * n;
      const float* vp = vrow + (size_t)i * BK;
      if constexpr (PRECISE == 0) {
        float contrib = vp[0] * bp[0];
#pragma unroll
        for (int j = 1; j < BK; ++j) contrib = fmaf(vp[j], bp[(size_t)j * n], contrib);
        acc[(q * 8 + r) * tile_n + cl] += contrib;
      } else if constexpr (PRECISE == 1) {
        float contrib = vp[0] * bp[0];
#pragma unroll
        for (int j = 1; j < BK; ++j) contrib = fmaf(vp[j], bp[(size_t)j * n], contrib);
        const int cell = (q * 8 + r) * tile_n + cl;
        sx_df32::acc_step(acc[cell], comp[cell], contrib);
      } else {
        float contrib, cerr;
        sx_df32::two_prod(vp[0], bp[0], contrib, cerr);
#pragma unroll
        for (int j = 1; j < BK; ++j) {
          float p, pe, e;
          sx_df32::two_prod(vp[j], bp[(size_t)j * n], p, pe);
          sx_df32::two_sum(contrib, p, contrib, e);
          cerr = __fadd_rn(cerr, __fadd_rn(pe, e));
        }
        const int cell = (q * 8 + r) * tile_n + cl;
        sx_df32::acc_step(acc[cell], comp[cell], contrib, cerr);
      }
    }
  }

  const size_t row0 = (size_t)mt * tile_m;
  for (int s = 0; s < stripes; ++s) {
    const size_t idx = (row0 + s * 8 + r) * n + col;
    const float a = acc[(s * 8 + r) * tile_n + cl];
    if constexpr (PRECISE == 0) {
      out[idx] = with_c ? alpha * a + beta * c[idx] : alpha * a;
    } else {
      const float k = comp[(s * 8 + r) * tile_n + cl];
      out[idx] = with_c ? sx_df32::compensated_epilogue(alpha, a, k, beta, c[idx])
                        : sx_df32::compensated_epilogue(alpha, a, k);
    }
  }
}

// The operands of one launch, as the C entry point receives them.
struct Args {
  const float* vals;
  const int* qrow;
  const int* bcol;
  const int* group_kwin;
  const int* tile_ptr;
  const int* tile_groups;
  const float* b;
  const float* c;
  float* out;
  int n_mtiles, n, tile_m, window_k, group_blocks, tile_n;
  float alpha, beta;
  int with_c;
  cudaStream_t stream;
};

template <int BK, int PRECISE>
cudaError_t launch(const Args& a) {
  const size_t smem = (size_t)a.tile_m * a.tile_n * sizeof(float) * (PRECISE ? 2 : 1);
  cudaError_t e = cudaFuncSetAttribute(
      spmm_block_kernel<BK, PRECISE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(a.n_mtiles, (a.n + a.tile_n - 1) / a.tile_n);
  spmm_block_kernel<BK, PRECISE><<<grid, 8 * a.tile_n, smem, a.stream>>>(
      a.vals, a.qrow, a.bcol, a.group_kwin, a.tile_ptr, a.tile_groups, a.b, a.c,
      a.out, a.n, a.tile_m, a.window_k, a.group_blocks, a.tile_n, a.alpha, a.beta,
      a.with_c);
  return cudaGetLastError();
}

// Every block width of one precise level.
template <int PRECISE>
cudaError_t launch_level(int block_k, const Args& a) {
  switch (block_k) {
    case 1: return launch<1, PRECISE>(a);
    case 2: return launch<2, PRECISE>(a);
    case 4: return launch<4, PRECISE>(a);
    case 8: return launch<8, PRECISE>(a);
    case 16: return launch<16, PRECISE>(a);
    case 32: return launch<32, PRECISE>(a);
    case 64: return launch<64, PRECISE>(a);
    case 128: return launch<128, PRECISE>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace sx_block
