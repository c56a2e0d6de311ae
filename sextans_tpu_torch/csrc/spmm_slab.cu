// spmm_slab / spmm_slab_skinny: C = alpha * A @ B + beta * C over the
// block_k x 128 dense-slab pack (format/pack_mxu.py).
//
// Replaces: sextans_tpu/ops/spmm_mxu_pallas.py — spmm_mxu_padded / _kernel
// (K1) with spmm_slab_launch, and spmm_mxu_ct_padded / _kernel_ct (K2) with
// spmm_slab_skinny_launch. On the TPU one grid step contracted a block on the
// matrix unit into a (tile_m/128, 128, tile_n) VMEM accumulator carried
// across the M-tile's groups. Here K1 gives one CUDA block one 128-row slab
// of one M-tile and one N-chunk: it walks the M-tile's group range from the
// host scan of group_mtile (tile_ptr / tile_groups) and takes only the
// blocks whose qm is its slab; the blocks it skips cost two index reads.
// K2 gives one CUDA block half a slab and visits only the slab's own blocks
// (the host scan slab_visits), streamed through shared memory (below).
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
// through shared memory once per N-chunk. K2 (n <= 32): see its kernel.
//
// Precise mode (PRECISE, SpmmConfig.precise >= 1; spmm_mxu_pallas.py:89-98,
// 113-121 for K1, :339-344, :356-363 for K2): one compensation register
// beside each accumulator register (K1: 32 more per thread), a Neumaier step
// acc_step(acc, comp, contrib) in place of acc += contrib, and
// compensated_epilogue (df32.cuh), one final rounding. The TPU's matrix unit
// contracts a whole block at once and steps once per block visit; here the
// step comes after every 8 terms of a block's FFMA chain (bk / 8 steps a
// block), so only chains of 8 terms round uncompensated. One step per visit
// of a bk = 128 block left 1.56 ulp of max|C| on cant_like at N = 512 on an
// H100 (SXM, 700 W), against 1.64 in plain mode. The TPU slab kernels have
// no level-2 branch, so level 2 runs level 1.

#include <cuda_runtime.h>

#include "async_copy.cuh"
#include "df32.cuh"

namespace {

constexpr int MSLAB = 128;
constexpr int SLAB_TN = 64;        // K1 columns per CUDA block
constexpr int SLAB_THREADS = 256;  // K1: 16 x 16 threads, 8 rows x 4 cols each

template <bool PRECISE>
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

  float acc[8][4], comp[8][4];  // comp is read only when PRECISE
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = comp[i][j] = 0.f;

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
        if constexpr (PRECISE) {
          if ((kk & 7) == 7) {  // block_k % 8 == 0: every term is stepped in
#pragma unroll
            for (int r = 0; r < 8; ++r)
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                sx_df32::acc_step(acc[r][j], comp[r][j], cf[r][j]);
                cf[r][j] = 0.f;
              }
          }
        }
      }
      if constexpr (!PRECISE) {
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[r][j] += cf[r][j];
      }
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
        if constexpr (PRECISE)
          out[idx] = with_c
              ? sx_df32::compensated_epilogue(alpha, acc[r][j], comp[r][j], beta, c[idx])
              : sx_df32::compensated_epilogue(alpha, acc[r][j], comp[r][j]);
        else
          out[idx] = with_c ? alpha * acc[r][j] + beta * c[idx] : alpha * acc[r][j];
      }
    }
  }
}

// K2 (n <= 32): a CTA owns half a slab, kSlabRows = 64 rows, and all n
// columns; it visits only its slab's blocks, listed by the host scan
// slab_visits (slab_ptr / slab_blocks, ops/launch.py) in pack order, and
// streams them through a ring of kStages stages in dynamic shared memory:
// a stage holds one block's (bk, 64) values and its bk B rows (bk x np
// floats, np = n rounded up to 4). Thread t works on rows 2 rp, 2 rp + 1
// of the CTA's 64 (rp = t / nq, one float2 of a vals row) and columns
// 4 q .. 4 q + 3 (q = t % nq, one float4 of a B row), 32 * nq threads, nq
// = ceil(n / 4).
//
// The copies complete on one mbarrier a stage. A block's values are bk runs
// of 256 bytes (a row of the half slab), copied by every thread with 16-byte
// cp.async, each thread arriving on the mbarrier once its copies have
// landed (cp.async.mbarrier.arrive.noinc). Not TMA bulk copies: on an
// H100, one bulk copy a 256-byte run made the kernel slower than these
// 16-byte copies, the issue of 128 small copies a block, not their bytes,
// setting its pace. Its B rows are one contiguous run of bk * n floats (B is
// row-major and the rows are kwin0 + bcol + kk): one TMA bulk copy
// (cp.async.bulk), issued by one thread with expect_tx, when n % 4 == 0 and
// B is 16-byte aligned (b_bulk), which on an H100 made K2 3-4 % faster than
// 16-byte cp.async of the same run (tools/kernel_times.py, PERF.md);
// otherwise the run does not start on a 16-byte boundary for every block,
// and the threads copy it with 4-byte cp.async beside the values. After a block, one __syncthreads frees its
// stage, and the copy of the block kStages further on starts.
//
// What bounds it on the H100: each value feeds n flops, so the slab
// format's bytes (values at ~5 % fill) bound it where the slabs fill the
// card (cant_like: 299 MB of values, 0.09 ms at 3.35 TB/s); where few
// slabs hold blocks (synthetic4704: 22 of 40), the longest slab's FFMA
// chain: 12 blocks x 128 terms, each term 8 FFMA a thread from shared
// memory, the block's copy landing under the previous block's chain.
constexpr int kSlabRows = 64;  // rows a CTA: a slab takes two CTAs
constexpr int kStages = 2;     // blocks in flight a CTA

template <bool PRECISE>
__global__ void __launch_bounds__(256) spmm_slab_skinny_kernel(
    const float* __restrict__ vals,        // (ng, G * bk, 128)
    const int* __restrict__ bcol,          // (ng, G)
    const int* __restrict__ group_kwin,    // (ng,)
    const int* __restrict__ slab_ptr,      // (n_slabs + 1,)
    const int* __restrict__ slab_blocks,   // (ng * G,) flat block indices
    const float* __restrict__ b,           // (k_padded, n)
    const float* __restrict__ c,           // (m_padded, n) or null
    float* __restrict__ out,               // (m_padded, n)
    int n, int window_k, int block_k, int group_blocks, float alpha, float beta,
    int with_c, int b_bulk) {
  extern __shared__ float4 smem4[];
  const int np = (n + 3) & ~3;
  const int stage = block_k * (kSlabRows + np);  // floats a stage
  float* ring = reinterpret_cast<float*>(smem4);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * stage);
  const int slab = blockIdx.x / (MSLAB / kSlabRows);
  const int half = blockIdx.x % (MSLAB / kSlabRows);
  const int tid = threadIdx.x;
  const int nq = (n + 3) / 4;
  const int q = tid % nq, rp = tid / nq;
  const int p0 = slab_ptr[slab];
  const int nblk = slab_ptr[slab + 1] - p0;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) sx_async::mbar_init(&full[s], blockDim.x + b_bulk);
    sx_async::mbar_fence_init();
  }
  __syncthreads();

  // Block j of the slab into stage j % kStages; every thread calls it.
  auto issue = [&](int j) {
    const int st = j % kStages;
    float* vs = ring + st * stage;
    float* bs = vs + block_k * kSlabRows;
    const size_t blk = slab_blocks[p0 + j];
    const float* vsrc = vals + blk * block_k * MSLAB + half * kSlabRows;
    const float* bsrc =
        b + ((size_t)group_kwin[blk / group_blocks] * window_k + bcol[blk]) * n;
    if (b_bulk && tid == 0) {
      sx_async::mbar_arrive_expect_tx(&full[st], 4u * block_k * n);
      sx_async::bulk_copy(bs, bsrc, 4u * block_k * n, &full[st]);
    }
    for (int e = tid; e < block_k * (kSlabRows / 4); e += blockDim.x) {
      const int kk = e / (kSlabRows / 4), q4 = 4 * (e % (kSlabRows / 4));
      sx_async::cp_async16(vs + kk * kSlabRows + q4, vsrc + (size_t)kk * MSLAB + q4);
    }
    if (!b_bulk) {
      for (int e = tid; e < block_k * n; e += blockDim.x)
        sx_async::cp_async4(bs + (e / n) * np + e % n, bsrc + e);
    }
    sx_async::cp_async_arrive(&full[st]);
  };

  for (int j = 0; j < nblk && j < kStages; ++j) issue(j);

  float acc[2][4], comp[2][4];  // comp is read only when PRECISE
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) acc[r][jj] = comp[r][jj] = 0.f;

  // One group of 8 terms: its values and B rows are read from shared
  // memory first (loads are issued one group ahead, below), then the 64 FFMA.
  auto load = [&](float2 (&a)[8], float4 (&bv)[8], const float* vs, const float* bs, int kk0) {
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      a[u] = *reinterpret_cast<const float2*>(vs + (kk0 + u) * kSlabRows);
      bv[u] = *reinterpret_cast<const float4*>(bs + (kk0 + u) * np);
    }
  };
  auto terms = [&](float (&cf)[2][4], const float2 (&a)[8], const float4 (&bv)[8]) {
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const float av[2] = {a[u].x, a[u].y};
      const float bb[4] = {bv[u].x, bv[u].y, bv[u].z, bv[u].w};
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) cf[r][jj] = fmaf(av[r], bb[jj], cf[r][jj]);
    }
    if constexpr (PRECISE) {  // block_k % 8 == 0: every term is stepped in
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          sx_df32::acc_step(acc[r][jj], comp[r][jj], cf[r][jj]);
          cf[r][jj] = 0.f;
        }
    }
  };

  for (int j = 0; j < nblk; ++j) {
    const int st = j % kStages;
    sx_async::mbar_wait(&full[st], (j / kStages) & 1);
    const float* vs = ring + st * stage + 2 * rp;
    const float* bs = ring + st * stage + block_k * kSlabRows + 4 * q;
    float cf[2][4];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) cf[r][jj] = 0.f;
    float2 a0[8], a1[8];
    float4 b0[8], b1[8];
    load(a0, b0, vs, bs, 0);
    for (int kk0 = 0; kk0 < block_k; kk0 += 16) {  // kk0 and kk0 + 8, ping-pong
      if (kk0 + 8 < block_k) load(a1, b1, vs, bs, kk0 + 8);
      terms(cf, a0, b0);
      if (kk0 + 8 >= block_k) break;
      if (kk0 + 16 < block_k) load(a0, b0, vs, bs, kk0 + 16);
      terms(cf, a1, b1);
    }
    if constexpr (!PRECISE) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) acc[r][jj] += cf[r][jj];
    }
    __syncthreads();  // every thread is done with stage st
    if (j + kStages < nblk) issue(j + kStages);
  }

  const size_t row = (size_t)slab * MSLAB + half * kSlabRows + 2 * rp;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int col = 4 * q + jj;
      if (col < n) {
        const size_t idx = (row + r) * n + col;
        if constexpr (PRECISE)
          out[idx] = with_c
              ? sx_df32::compensated_epilogue(alpha, acc[r][jj], comp[r][jj], beta, c[idx])
              : sx_df32::compensated_epilogue(alpha, acc[r][jj], comp[r][jj]);
        else  // the contraction nvcc gave the parent kernel, written out
          out[idx] = with_c ? __fmaf_rn(alpha, acc[r][jj], __fmul_rn(beta, c[idx]))
                            : __fmul_rn(alpha, acc[r][jj]);
      }
    }
  }
}

}  // namespace

extern "C" int spmm_slab_launch(
    const void* vals, const void* qm, const void* bcol, const void* group_kwin,
    const void* tile_ptr, const void* tile_groups, const void* b,
    const void* c, void* out, int n_mtiles, int n, int tile_m, int window_k,
    int block_k, int group_blocks, float alpha, float beta, int with_c,
    int precise, void* stream) {
  if (precise < 0 || precise > 2) return cudaErrorInvalidValue;
  auto kernel = precise ? spmm_slab_kernel<true> : spmm_slab_kernel<false>;
  const size_t smem = (size_t)block_k * (MSLAB + SLAB_TN) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(n_mtiles * (tile_m / MSLAB), (n + SLAB_TN - 1) / SLAB_TN);
  kernel<<<grid, SLAB_THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)vals, (const int*)qm, (const int*)bcol,
      (const int*)group_kwin, (const int*)tile_ptr, (const int*)tile_groups,
      (const float*)b, (const float*)c, (float*)out, n, tile_m, window_k,
      block_k, group_blocks, alpha, beta, with_c);
  return cudaGetLastError();
}

extern "C" int spmm_slab_skinny_launch(
    const void* vals, const void* bcol, const void* group_kwin, const void* slab_ptr,
    const void* slab_blocks, const void* b, const void* c, void* out, int n_slabs, int n,
    int window_k, int block_k, int group_blocks, float alpha, float beta, int with_c,
    int precise, int b_bulk, int threads, int grid, int smem, void* stream) {
  if (precise < 0 || precise > 2) return cudaErrorInvalidValue;
  // the wrapper's map (ops/spmm_slab.py:slab_skinny_launch) must be this kernel's
  const int np = (n + 3) & ~3;
  const size_t need = (size_t)kStages * (4 * (size_t)block_k * (kSlabRows + np) + 8);
  if (n < 1 || n > 32 || threads != 32 * ((n + 3) / 4) ||
      grid != n_slabs * (MSLAB / kSlabRows) || (size_t)smem != need)
    return cudaErrorInvalidValue;
  auto kernel = precise ? spmm_slab_skinny_kernel<true> : spmm_slab_skinny_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const float*)vals, (const int*)bcol, (const int*)group_kwin, (const int*)slab_ptr,
      (const int*)slab_blocks, (const float*)b, (const float*)c, (float*)out, n, window_k,
      block_k, group_blocks, alpha, beta, with_c, b_bulk);
  return cudaGetLastError();
}
