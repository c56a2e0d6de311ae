// spmm_block.cuh: the block kernel, C = alpha * A @ B + beta * C over the
// 8 x block_k block pack (format/pack.py), stripe-parallel: each 8-row
// stripe of the output gets its own threads. spmm_block.cu holds its C entry
// point and plain mode; spmm_block_precise1.cu and spmm_block_precise2.cu
// instantiate the two precise levels, so that the build compiles the three
// apart, in parallel.
//
// Replaces: sextans_tpu/ops/spmm_pallas.py, spmm_pallas_padded / _kernel
// (the Pallas TPU kernel K3). On the TPU the groups of an M-tile ran in order
// along a sequential grid axis and the accumulator lived in VMEM across grid
// steps. That order matters only among the visits of one stripe, so here a
// host scan at upload (ops/launch.py:stripe_visits) lists each stripe's
// block visits (flat indices g * G + i) in pack order, and each stripe is
// summed by its own threads, in registers. The scan keeps one of the
// repeated all-zero visits (the pack's pad blocks) per stripe, K-window and
// bcol, which leaves every sum as it was to the bit (see its docstring). A
// stripe without visits still writes beta * C.
//
// Thread map (ops/spmm_block.py:block_launch): one CTA of 128 threads per
// (stripe, column chunk), in lane groups of LANES threads over CPT
// consecutive columns each: LANES = 16, CPT = 1 at N <= 16 (a 16-column
// chunk, 8 groups), LANES = 32, CPT = 4 above (128 columns, 16-byte B loads
// where N % 4 == 0, 4 groups). The stripe's visits go round by round: in a
// round each group takes the next visit and computes its 8 x COLS block
// sums (a thread: all 8 rows at its CPT columns, so each B element of a
// visit is loaded once per CTA; the block's values are the same for every
// lane of the group, one broadcast load), and writes them to shared
// memory; after one barrier, each thread adds the round's sums, in visit
// order, into the cells it owns (8 / GROUPS rows at its columns), whose
// accumulators stay in registers. So the round's GROUPS visits wait for
// device memory together, and the sum of each cell still runs in pack
// order. The sums are staged in two buffers, one round apart, so one
// barrier a round keeps a writer off a buffer still being read. Up to
// kStage visits (index and B row) are staged in shared memory at a time.
// Shared memory: 2 * GROUPS * 8 * COLS floats (twice that at level 2, the
// errors beside the sums) and the staged visits: 34.8 KB at N > 16 in plain
// mode and at level 1, 67.6 KB at level 2 (ops/spmm_block.py checks it
// against the limit before launch).
//
// Accumulation order (the TPU's, spmm_pallas.py:113-136): for each block,
// contrib = sum_j v[r, j] * B[kw * window_k + bcol + j, col] in j order with
// IEEE f32 FFMA (no TF32 anywhere), then acc += contrib; blocks in pack
// order; epilogue alpha * acc + beta * C (C not read when with_c == 0).
//
// Precise levels (PRECISE, SpmmConfig.precise; spmm_pallas.py:99-134,
// 160-176), with the error-free transforms of df32.cuh: a compensation comp
// beside each accumulator cell, and each block visit is a Neumaier step
// acc_step(acc, comp, contrib) instead of acc += contrib; the epilogue is
// compensated_epilogue, one final rounding. Level 1 keeps the FFMA contrib
// chain; level 2 runs the EFT inner chain (two_prod per term, two_sum per
// partial sum, the residuals summed into cerr, acc_step(acc, comp, contrib,
// cerr)). The TPU merged n_acc Kahan pairs in its epilogue; here there is
// one pair per cell. PRECISE == 0 compiles to the plain kernel above.
//
// What bounds it on the H100: the FFMAs over the padded blocks, and the
// latency of the stripes' visit chains. A visit costs 8 * block_k FFMAs a
// column whatever the block's fill (13.1 % on cant_like: 2 * 28.95 M slots
// * 512 / 67 TFLOP/s = 0.44 ms at N = 512, against a 0.124 ms byte bound).
// A stripe's rounds run one after another, so the stripe with the most
// visits sets the time at small N: one device-memory wait per round of
// GROUPS visits, and a barrier. n_acc and chunk_unroll of SpmmConfig are
// TPU scheduling hints and are ignored here.

#pragma once

#include <cuda_runtime.h>

#include "df32.cuh"

namespace sx_block {

// CPT consecutive columns of one B row; columns at or past n read as 0.
template <int CPT, bool VEC>
__device__ __forceinline__ void load_cols(const float* p, int col, int n, float (&x)[CPT]) {
  if constexpr (CPT == 4 && VEC) {
    const float4 v = col < n ? __ldg(reinterpret_cast<const float4*>(p))
                             : make_float4(0.f, 0.f, 0.f, 0.f);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  } else {
#pragma unroll
    for (int k = 0; k < CPT; ++k) x[k] = col + k < n ? __ldg(p + k) : 0.f;
  }
}

// JS consecutive values of one block row (16-, 8- or 4-byte aligned).
template <int JS>
__device__ __forceinline__ void load_vals(const float* p, float (&x)[JS]) {
  if constexpr (JS == 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  } else if constexpr (JS == 2) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(p));
    x[0] = v.x; x[1] = v.y;
  } else {
    x[0] = __ldg(p);
  }
}

// CPT consecutive floats of shared memory (16-byte aligned at CPT = 4).
template <int CPT>
__device__ __forceinline__ void store_cols(float* p, const float (&x)[CPT]) {
  if constexpr (CPT == 4) *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  else
#pragma unroll
    for (int k = 0; k < CPT; ++k) p[k] = x[k];
}

template <int CPT>
__device__ __forceinline__ void load_shared(const float* p, float (&x)[CPT]) {
  if constexpr (CPT == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  } else {
#pragma unroll
    for (int k = 0; k < CPT; ++k) x[k] = p[k];
  }
}

// Terms j0 .. j0 + JS - 1 of one visit's 8 x CPT sums (FIRST: j0 == 0).
template <int PRECISE, int CPT, bool VEC, int JS, bool FIRST>
__device__ __forceinline__ void visit_step(const float* vp, size_t row_len, const float* bp,
                                           int n, int col, int j0, float (&con)[8][CPT],
                                           float (&cer)[8][CPT]) {
  float v[8][JS];
  float x[JS][CPT];
#pragma unroll
  for (int r = 0; r < 8; ++r) load_vals<JS>(vp + r * row_len + j0, v[r]);
#pragma unroll
  for (int jj = 0; jj < JS; ++jj) load_cols<CPT, VEC>(bp + (size_t)(j0 + jj) * n, col, n, x[jj]);
#pragma unroll
  for (int jj = 0; jj < JS; ++jj)
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int k = 0; k < CPT; ++k) {
        if (FIRST && jj == 0) {
          if constexpr (PRECISE == 0) con[r][k] = v[r][0] * x[0][k];
          else if constexpr (PRECISE == 1) con[r][k] = __fmul_rn(v[r][0], x[0][k]);
          else sx_df32::two_prod(v[r][0], x[0][k], con[r][k], cer[r][k]);
        } else if constexpr (PRECISE <= 1) {
          con[r][k] = fmaf(v[r][jj], x[jj][k], con[r][k]);
        } else {
          float p, pe, e;
          sx_df32::two_prod(v[r][jj], x[jj][k], p, pe);
          sx_df32::two_sum(con[r][k], p, con[r][k], e);
          cer[r][k] = __fadd_rn(cer[r][k], __fadd_rn(pe, e));
        }
      }
}

constexpr int kThreads = 128;  // a CTA: one stripe at one column chunk
constexpr int kStage = 256;    // visits staged in shared memory at a time

// Floats of shared memory the sums of a round take, both buffers.
template <int PRECISE, int LANES, int CPT>
__host__ __device__ constexpr int part_floats() {
  return 2 * (kThreads / LANES) * 8 * LANES * CPT * (PRECISE == 2 ? 2 : 1);
}

template <int BK, int PRECISE, int LANES, int CPT, bool VEC>
__global__ void __launch_bounds__(kThreads) spmm_block_kernel(
    const float* __restrict__ vals,        // (ng, 8, G * BK)
    const int* __restrict__ bcol,          // (ng, G)
    const int* __restrict__ group_kwin,    // (ng,)
    const int* __restrict__ stripe_ptr,    // (n_stripes + 1,)
    const int* __restrict__ visits,        // (visits,)
    const float* __restrict__ b,           // (k_padded, n)
    const float* __restrict__ c,           // (m_padded, n) or null
    float* __restrict__ out,               // (m_padded, n)
    int n, int window_k, int group_blocks, float alpha, float beta, int with_c) {
  constexpr int COLS = LANES * CPT;          // columns of the CTA's chunk
  constexpr int GROUPS = kThreads / LANES;   // visits a round
  constexpr int OWN = 8 / GROUPS;            // rows a thread owns
  constexpr int PART = GROUPS * 8 * COLS;    // floats of one buffer of sums
  // block values per step: 16-byte loads, 8-byte at level 2 (registers)
  constexpr int JS = BK < (PRECISE == 2 ? 2 : 4) ? BK : (PRECISE == 2 ? 2 : 4);
  extern __shared__ float smem[];
  float* part = smem;                                  // [2][GROUPS][8][COLS]
  float* perr = smem + 2 * PART;                       // the same, level 2
  int2* staged = reinterpret_cast<int2*>(smem + part_floats<PRECISE, LANES, CPT>());

  const int s = blockIdx.x;
  const int grp = threadIdx.x / LANES;
  const int gl = threadIdx.x % LANES;
  const int col = blockIdx.y * COLS + gl * CPT;  // this thread's columns
  const int G = group_blocks;
  const size_t row_len = (size_t)G * BK;

  float acc[OWN][CPT], comp[OWN][CPT];
#pragma unroll
  for (int r = 0; r < OWN; ++r)
#pragma unroll
    for (int k = 0; k < CPT; ++k) acc[r][k] = comp[r][k] = 0.f;

  const int p1 = stripe_ptr[s + 1];
  int buf = 0;
  for (int p0 = stripe_ptr[s]; p0 < p1; p0 += kStage) {
    const int staged_n = min(kStage, p1 - p0);
    for (int i = threadIdx.x; i < staged_n; i += kThreads) {
      const int v = visits[p0 + i];
      staged[i] = make_int2(v, group_kwin[v / G] * window_k + bcol[v]);
    }
    __syncthreads();
    for (int r0 = 0; r0 < staged_n; r0 += GROUPS, buf ^= 1) {
      float* sums = part + buf * PART;
      if (r0 + grp < staged_n) {
        const int2 vis = staged[r0 + grp];
        const int g = vis.x / G;
        const float* vp = vals + (size_t)g * 8 * row_len + (size_t)(vis.x - g * G) * BK;
        const float* bp = b + (size_t)vis.y * n + col;
        float con[8][CPT], cer[8][CPT];
        visit_step<PRECISE, CPT, VEC, JS, true>(vp, row_len, bp, n, col, 0, con, cer);
#pragma unroll (BK <= 16 ? BK : 1)
        for (int j0 = JS; j0 < BK; j0 += JS)
          visit_step<PRECISE, CPT, VEC, JS, false>(vp, row_len, bp, n, col, j0, con, cer);
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const int at = (grp * 8 + r) * COLS + gl * CPT;
          store_cols<CPT>(sums + at, con[r]);
          if constexpr (PRECISE == 2) store_cols<CPT>(perr + buf * PART + at, cer[r]);
        }
      }
      __syncthreads();
      const int cnt = min(GROUPS, staged_n - r0);
      for (int v = 0; v < cnt; ++v)
#pragma unroll
        for (int r = 0; r < OWN; ++r) {
          const int at = (v * 8 + grp * OWN + r) * COLS + gl * CPT;
          float x[CPT], xe[CPT];
          load_shared<CPT>(sums + at, x);
          if constexpr (PRECISE == 2) load_shared<CPT>(perr + buf * PART + at, xe);
#pragma unroll
          for (int k = 0; k < CPT; ++k) {
            if constexpr (PRECISE == 0) acc[r][k] += x[k];
            else if constexpr (PRECISE == 1) sx_df32::acc_step(acc[r][k], comp[r][k], x[k]);
            else sx_df32::acc_step(acc[r][k], comp[r][k], x[k], xe[k]);
          }
        }
    }
    __syncthreads();  // the next stage overwrites the staged visits
  }

#pragma unroll
  for (int r = 0; r < OWN; ++r)
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      if (col + k >= n) continue;
      const size_t idx = ((size_t)s * 8 + grp * OWN + r) * n + col + k;
      const float a = acc[r][k];
      if constexpr (PRECISE == 0) {
        // one FMA, spelled out: left to nvcc's contraction, the rounding
        // of alpha * a + beta * C differs between the thread maps
        out[idx] = with_c ? __fmaf_rn(alpha, a, __fmul_rn(beta, c[idx])) : __fmul_rn(alpha, a);
      } else {
        out[idx] = with_c ? sx_df32::compensated_epilogue(alpha, a, comp[r][k], beta, c[idx])
                          : sx_df32::compensated_epilogue(alpha, a, comp[r][k]);
      }
    }
}

// The operands of one launch, as the C entry point receives them.
struct Args {
  const float* vals;
  const int* bcol;
  const int* group_kwin;
  const int* stripe_ptr;
  const int* visits;
  const float* b;
  const float* c;
  float* out;
  int n, window_k, group_blocks;
  float alpha, beta;
  int with_c, lanes, vec, threads, grid_x, grid_y, smem;
  cudaStream_t stream;
};

template <int BK, int PRECISE, int LANES, int CPT, bool VEC>
cudaError_t launch(const Args& a) {
  constexpr int smem = part_floats<PRECISE, LANES, CPT>() * 4 + kStage * 8;
  if (a.threads != kThreads || a.smem != smem) return cudaErrorInvalidValue;
  auto kernel = spmm_block_kernel<BK, PRECISE, LANES, CPT, VEC>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(a.grid_x, a.grid_y), kThreads, smem, a.stream>>>(
      a.vals, a.bcol, a.group_kwin, a.stripe_ptr, a.visits, a.b, a.c, a.out, a.n,
      a.window_k, a.group_blocks, a.alpha, a.beta, a.with_c);
  return cudaGetLastError();
}

// The thread maps of one block width: 16 lanes of 1 column, 32 of 4.
template <int BK, int PRECISE>
cudaError_t launch_map(const Args& a) {
  if (a.lanes == 16) return launch<BK, PRECISE, 16, 1, false>(a);
  return a.vec ? launch<BK, PRECISE, 32, 4, true>(a) : launch<BK, PRECISE, 32, 4, false>(a);
}

// Every block width of one precise level.
template <int PRECISE>
cudaError_t launch_level(int block_k, const Args& a) {
  switch (block_k) {
    case 1: return launch_map<1, PRECISE>(a);
    case 2: return launch_map<2, PRECISE>(a);
    case 4: return launch_map<4, PRECISE>(a);
    case 8: return launch_map<8, PRECISE>(a);
    case 16: return launch_map<16, PRECISE>(a);
    case 32: return launch_map<32, PRECISE>(a);
    case 64: return launch_map<64, PRECISE>(a);
    case 128: return launch_map<128, PRECISE>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace sx_block
