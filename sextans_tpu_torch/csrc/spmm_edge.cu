// spmm_edge: C = alpha * A @ B + beta * C over the edge-stream pack
// (format/pack_edge.py), row-parallel: each output row gets its own threads.
//
// Replaces: sextans_tpu/ops/spmm_edge_pallas.py, spmm_edge_padded / _kernel
// (the Pallas TPU kernel K4). On the TPU the chunks of an M-tile ran in order
// along a sequential grid axis and the accumulator lived in VMEM across grid
// steps. That order matters only among the runs that flush into one row, so
// here a host scan at upload (ops/spmm_edge.py:row_runs) lists each padded
// output row's runs in pack order, as slot ranges [start, stop] inside one
// chunk, and each row is summed by its own threads, in registers.
//
// Per edge of a run, decoded from its meta word w (pack_edge.py):
//   col = (w >> 2) & 0x7FFF, pad = w & 1;
//   reg = fma(v, B[kw * window_k + col, c], reg)
// and at the run's end (its row_end slot) acc += reg; then the epilogue
// fma(alpha, acc, beta * C), or alpha * acc without C. Arithmetic: IEEE f32
// FFMA (__fmaf_rn), one rounding per edge where the TPU kernel rounds its
// product and its sum apart; no TF32. The plain version (ops/spmm_edge.py)
// takes every rounding of this list in the same order. The edges are walked
// one by one in pack order, so edge_lanes (which only pads row runs to a
// multiple of L for the TPU's L registers) changes nothing: a pad adds
// 0 * B[window row 0] (MASKED == false, as the TPU does; NaN for non-finite
// B) or nothing at all (MASKED == true, edge_masked). A run that straddles a
// chunk boundary is two runs: the packer forces row_end on each chunk's last
// slot. Slots after a chunk's last row_end (the all-padding chunks of empty
// M-tiles) are in no run, as the TPU kernel drops their register.
//
// B, C and out: B as the caller's (K or more rows; a slot reads row
// kw * window_k + col, below K for every slot of a pack from pack_edge),
// or padded to whole K-windows; C and out at m_rows rows, the caller's M
// (SpmmPlan's call, ops/spmm_edge.py:edge_in_place) or m_padded. A row at
// or past m_rows holds no entry and is not computed.
//
// Thread map (ops/spmm_edge.py:edge_launch): a thread owns one row at four
// consecutive columns, reads B as 16-byte loads where N % 4 == 0 (VEC), and
// LANES threads share the row: 4 at N <= 16 (a warp covers 8 rows), 32
// above (a warp covers 128 columns of one row). The lanes of a row load a
// run's (meta, val) pairs coalesced, one batch of at least 16 ahead, and
// share them with __shfl_sync within the row's lane group; each lane then
// issues 16 B-row loads before their multiply-adds. The run register, the
// row accumulator and, at the precise levels, their compensations are
// registers: no zeroing pass, no read-modify-write of device memory, one
// store per cell.
//
// What bounds it on the H100: the B-row gather and its latency. The product
// needs 2 * nnz * N flops and at least 8 * nnz + 4 * (K + 2M) * N bytes of
// device-memory traffic: at cant_like N = 512 that is 0.124 ms at 3.35 TB/s
// against 0.058 ms of f32 work at 67 TFLOP/s. Each edge gathers a 16-byte
// piece of one B row per lane (512 bytes a warp at N = 512, 64 bytes a row
// at N = 16) from L2 or device memory; the rows of a warp differ in length,
// so a warp runs as long as its longest row.
//
// Precise levels (PRECISE, SpmmConfig.precise; spmm_edge_pallas.py:87-182),
// with the error-free transforms of df32.cuh. The register becomes a pair
// (reg, regc): per edge, the product p = fl(v * B) (level 2: two_prod, p and
// its error pe) goes in by acc_step(reg, regc, p[, pe]) in place of the FMA.
// At a run's end the register goes into the row's pair by acc_step(acc,
// comp, reg), then comp += regc. The epilogue is compensated_epilogue, one
// final rounding. A masked pad adds nothing, its error included; an unmasked
// pad adds 0 * B[window row] and its error, as on the TPU. The TPU's L lane
// pairs summed at the flush become one pair here (its edges one by one).
//
// Level 2 promises each element the f32 nearest to its exact value, which
// the pair alone does not give where the terms cancel or the sum lies near
// a rounding boundary (on the cant stand-in at N = 512, 46 elements of a
// product). So at level 2 the step sums its two errors first (comp -=
// fl(e + pe), df32.cuh:acc_step_bounded), a third register per column
// gathers a bound on the pair's error, and the epilogue
// (checked_epilogue) keeps its result wherever that bound shows it is the
// nearest f32. It lists each other element, and a second kernel
// (spmm_edge_nearest_kernel) sums those again from f64 in the same order
// (nearest_element), so that K4's threads carry only the pair and its
// bound.

#include <cuda_runtime.h>

#include "df32.cuh"

namespace {

constexpr int kColShift = 2;
constexpr unsigned kColMask = (1u << 15) - 1;
// B-row loads a lane issues before their FMAs. At level 2 8, not 16: with
// the bound's registers 16 took 141 registers, one CTA an SM, and 3.5 ms
// a product on the cant stand-in at N = 512 (a register cap of 128 that
// spilled, 2.6 ms); 8 take 88, and K4 the 1.88 ms it took without the
// bound.
constexpr int kSubPlain = 16;
constexpr int kSubPrecise2 = 8;

// The lane-group mask of a lane: LANES consecutive lanes share a row.
template <int LANES>
__device__ __forceinline__ unsigned group_mask(int lane) {
  if constexpr (LANES == 32) return 0xffffffffu;
  else return ((1u << LANES) - 1) << (lane & ~(LANES - 1));
}

// Four consecutive columns of one B row; columns at or past n read as 0.
template <bool VEC>
__device__ __forceinline__ float4 load4(const float* p, int col, int n) {
  if constexpr (VEC) {
    return col < n ? __ldg(reinterpret_cast<const float4*>(p)) : make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
    return make_float4(col < n ? __ldg(p) : 0.f, col + 1 < n ? __ldg(p + 1) : 0.f,
                       col + 2 < n ? __ldg(p + 2) : 0.f, col + 3 < n ? __ldg(p + 3) : 0.f);
  }
}

__device__ __forceinline__ float& at(float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// Level 2's sum of one output element over its row's runs again, from f64,
// by a whole warp: the lanes load 32 slots at a time (a pad adds nothing:
// the element is summed again only where its f32 sum was finite, and there
// a pad's 0 * B is 0) with each product v * B exact, and lane 0 adds them
// by two_sum into an f64 pair in pack order; then nearest_epilogue. `bcol`
// is B's column of the element. Returns the f32 in lane 0.
__device__ __forceinline__ float nearest_element(
    const float* __restrict__ vals, const int* __restrict__ meta,
    const int* __restrict__ chunk_kwin, const int* __restrict__ run_start,
    const int* __restrict__ run_stop, int q0, int q1, const float* __restrict__ bcol, int n,
    int window_k, int edge_chunk, float alpha, float beta, float cin, bool with_c) {
  const int lane = threadIdx.x & 31;
  double acc = 0.0, comp = 0.0;
  for (int q = q0; q < q1; ++q) {
    const int s0 = run_start[q], s1 = run_stop[q];
    const float* bwin = bcol + (size_t)chunk_kwin[s0 / edge_chunk] * window_k * n;
    for (int e0 = s0; e0 <= s1; e0 += 32) {
      const int e = e0 + lane;
      const unsigned w = e <= s1 ? (unsigned)__ldg(meta + e) : 1u;
      const double p = (w & 1u) ? 0.0
          : __dmul_rn((double)__ldg(vals + e),
                      (double)__ldg(bwin + (size_t)((w >> kColShift) & kColMask) * n));
      const unsigned real = __ballot_sync(0xffffffffu, !(w & 1u));
      for (int j = 0; j < 32; ++j) {
        const double pj = __shfl_sync(0xffffffffu, p, j);
        if (lane == 0 && ((real >> j) & 1u)) {
          double t, err;
          sx_df32::two_sum(acc, pj, t, err);
          acc = t;
          comp = __dsub_rn(comp, err);
        }
      }
    }
  }
  return sx_df32::nearest_epilogue(acc, comp, alpha, beta, cin, with_c);
}

// The plain kernel at N > 16 is held to 85 registers, so that three CTAs of
// 256 threads share an SM: more rows in flight beat more loads per row
// there (on cant_like at N = 512). The other maps keep what they use.
template <bool MASKED, int PRECISE, int LANES, bool VEC>
__global__ void __launch_bounds__(256, LANES == 32 && PRECISE == 0 ? 3 : 1) spmm_edge_kernel(
    const float* __restrict__ vals,        // (chunks, E)
    const int* __restrict__ meta,          // (chunks, E)
    const int* __restrict__ chunk_kwin,    // (chunks,)
    const int* __restrict__ row_ptr,       // (m_padded + 1,)
    const int* __restrict__ run_start,     // (runs,)
    const int* __restrict__ run_stop,      // (runs,)
    const float* __restrict__ b,           // (K or k_padded, n)
    const float* __restrict__ c,           // (m_rows, n) or null
    float* __restrict__ out,               // (m_rows, n)
    unsigned* __restrict__ unsure,         // level 2: a count, then the elements listed
    int m_rows, int n, int window_k, int edge_chunk, float alpha, float beta,
    int with_c) {
  // (meta, val) pairs a lane loads per batch, so that a batch holds at
  // least 16 slots
  constexpr int kSub = PRECISE == 2 ? kSubPrecise2 : kSubPlain;
  constexpr int kPairs = LANES >= 16 ? 1 : 16 / LANES;
  constexpr int kBatch = LANES * kPairs;
  const int lane = threadIdx.x & 31;
  const int gl = lane & (LANES - 1);
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / LANES;
  if (row >= m_rows) return;  // the row's whole lane group leaves
  const unsigned mask = group_mask<LANES>(lane);
  const int col = (blockIdx.y * LANES + gl) * 4;
  const bool live = col < n;

  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 comp = acc;
  float4 bound = acc;
  const int q1 = row_ptr[row + 1];
  for (int q = row_ptr[row]; q < q1; ++q) {
    const int s0 = run_start[q];
    const int s1 = run_stop[q] + 1;
    const float* bwin = b + (size_t)chunk_kwin[s0 / edge_chunk] * window_k * n + col;
    float4 reg = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 regc = reg;
    // the batch's (meta, val) pairs, loaded one batch ahead
    unsigned next_w[kPairs];
    float next_v[kPairs];
    auto load_pairs = [&](int e0) {
#pragma unroll
      for (int k = 0; k < kPairs; ++k) {
        const int e = e0 + k * LANES + gl;
        next_w[k] = e < s1 ? (unsigned)__ldg(meta + e) : 0u;
        next_v[k] = e < s1 ? __ldg(vals + e) : 0.f;
      }
    };
    load_pairs(s0);
    for (int e0 = s0; e0 < s1; e0 += kBatch) {
      const int cnt = min(kBatch, s1 - e0);
      unsigned my_w[kPairs];
      float my_v[kPairs];
#pragma unroll
      for (int k = 0; k < kPairs; ++k) {
        my_w[k] = next_w[k];
        my_v[k] = next_v[k];
      }
      if (e0 + kBatch < s1) load_pairs(e0 + kBatch);
#pragma unroll
      for (int j0 = 0; j0 < kBatch; j0 += kSub) {
        if (j0 >= cnt) break;
        unsigned w[kSub];
        float4 bv[kSub];
#pragma unroll
        for (int jj = 0; jj < kSub; ++jj) {
          const int j = j0 + jj;
          w[jj] = __shfl_sync(mask, my_w[j / LANES], j % LANES, LANES);
          bv[jj] = make_float4(0.f, 0.f, 0.f, 0.f);
          if (live && j < cnt && !(MASKED && (w[jj] & 1u)))
            bv[jj] = load4<VEC>(bwin + (size_t)((w[jj] >> kColShift) & kColMask) * n, col, n);
        }
#pragma unroll
        for (int jj = 0; jj < kSub; ++jj) {
          const int j = j0 + jj;
          const float v = __shfl_sync(mask, my_v[j / LANES], j % LANES, LANES);
          if (j >= cnt || (MASKED && (w[jj] & 1u))) continue;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float x = at(bv[jj], k);
            if constexpr (PRECISE == 0) {
              at(reg, k) = __fmaf_rn(v, x, at(reg, k));
            } else if constexpr (PRECISE == 1) {
              sx_df32::acc_step(at(reg, k), at(regc, k), __fmul_rn(v, x));
            } else {
              float p, pe;
              sx_df32::two_prod(v, x, p, pe);
              sx_df32::acc_step_bounded(at(reg, k), at(regc, k), at(bound, k), p, pe);
            }
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if constexpr (PRECISE == 0) {
        at(acc, k) = __fadd_rn(at(acc, k), at(reg, k));
      } else if constexpr (PRECISE == 1) {
        sx_df32::acc_step(at(acc, k), at(comp, k), at(reg, k));
        at(comp, k) = __fadd_rn(at(comp, k), at(regc, k));
      } else {
        sx_df32::flush_bounded(at(acc, k), at(comp, k), at(bound, k), at(reg, k), at(regc, k));
      }
    }
  }

  if (!live) return;
  const size_t base = (size_t)row * n + col;
  float4 cin = make_float4(0.f, 0.f, 0.f, 0.f);
  if (with_c) cin = load4<VEC>(c + base, col, n);
  float4 res;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float a = at(acc, k);
    if constexpr (PRECISE == 0) {
      at(res, k) = with_c ? __fmaf_rn(alpha, a, __fmul_rn(beta, at(cin, k))) : __fmul_rn(alpha, a);
    } else if constexpr (PRECISE == 1) {
      at(res, k) = sx_df32::epilogue(a, at(comp, k), at(cin, k), alpha, beta, with_c);
    } else {
      bool sure;
      at(res, k) = sx_df32::checked_epilogue(a, at(comp, k), at(bound, k), at(cin, k), alpha,
                                             beta, with_c, sure);
      if (!sure && col + k < n) unsure[1 + atomicAdd(unsure, 1u)] = (unsigned)(base + k);
    }
  }
  if constexpr (VEC) {
    *reinterpret_cast<float4*>(out + base) = res;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (col + k < n) out[base + k] = at(res, k);
  }
}

// Level 2's second pass, one wave of warps: spmm_edge_kernel listed the
// elements its check is not sure of (unsure[0] of them, in unsure[1..]), and
// the warps deal them out, one at a time a warp, each summed again by the
// whole warp (nearest_element) into out. They are few (about 1.6e-4 of the
// elements on the cant stand-in at N = 512, fewer than the warps), so this
// pass costs about one element's walk.
__global__ void __launch_bounds__(256) spmm_edge_nearest_kernel(
    const float* __restrict__ vals, const int* __restrict__ meta,
    const int* __restrict__ chunk_kwin, const int* __restrict__ row_ptr,
    const int* __restrict__ run_start, const int* __restrict__ run_stop,
    const float* __restrict__ b, const float* __restrict__ c, float* __restrict__ out,
    const unsigned* __restrict__ unsure, int n, int window_k, int edge_chunk, float alpha,
    float beta, int with_c) {
  const unsigned warps = gridDim.x * (blockDim.x / 32);
  const unsigned count = unsure[0];
  for (unsigned i = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32; i < count; i += warps) {
    const size_t e = unsure[1 + i];
    const int row = (int)(e / n), col = (int)(e % n);
    const float y = nearest_element(vals, meta, chunk_kwin, run_start, run_stop, row_ptr[row],
                                    row_ptr[row + 1], b + col, n, window_k, edge_chunk, alpha,
                                    beta, with_c ? c[e] : 0.f, with_c);
    if ((threadIdx.x & 31) == 0) out[e] = y;
  }
}

template <bool MASKED, int PRECISE, int LANES>
auto pick_vec(int vec) {
  return vec ? spmm_edge_kernel<MASKED, PRECISE, LANES, true>
             : spmm_edge_kernel<MASKED, PRECISE, LANES, false>;
}

template <bool MASKED, int PRECISE>
auto pick_lanes(int lanes, int vec) {
  return lanes == 4 ? pick_vec<MASKED, PRECISE, 4>(vec) : pick_vec<MASKED, PRECISE, 32>(vec);
}

template <bool MASKED>
auto pick(int precise, int lanes, int vec) {
  return precise == 0   ? pick_lanes<MASKED, 0>(lanes, vec)
         : precise == 1 ? pick_lanes<MASKED, 1>(lanes, vec)
                        : pick_lanes<MASKED, 2>(lanes, vec);
}

}  // namespace

extern "C" int spmm_edge_launch(
    const void* vals, const void* meta, const void* chunk_kwin,
    const void* row_ptr, const void* run_start, const void* run_stop,
    const void* b, const void* c, void* out, void* unsure, int m_rows, int n, int window_k,
    int edge_chunk, float alpha, float beta, int with_c, int masked,
    int precise, int lanes, int vec, int threads, int grid_x, int grid_y,
    int nearest_grid, void* stream) {
  if (precise < 0 || precise > 2 || (lanes != 4 && lanes != 32) || threads % 32 ||
      (long long)grid_x * (threads / lanes) < m_rows ||
      (long long)grid_y * lanes * 4 < n ||
      (precise == 2 && (!unsure || nearest_grid < 1 || (long long)m_rows * n >= (1ll << 32))))
    return cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (precise == 2) {  // the count of the list
    const cudaError_t err = cudaMemsetAsync(unsure, 0, sizeof(unsigned), st);
    if (err != cudaSuccess) return err;
  }
  auto kernel = masked ? pick<true>(precise, lanes, vec) : pick<false>(precise, lanes, vec);
  kernel<<<dim3(grid_x, grid_y), threads, 0, st>>>(
      (const float*)vals, (const int*)meta, (const int*)chunk_kwin,
      (const int*)row_ptr, (const int*)run_start, (const int*)run_stop,
      (const float*)b, (const float*)c, (float*)out, (unsigned*)unsure, m_rows, n,
      window_k, edge_chunk, alpha, beta, with_c);
  if (precise == 2) {
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    spmm_edge_nearest_kernel<<<nearest_grid, 256, 0, st>>>(
        (const float*)vals, (const int*)meta, (const int*)chunk_kwin,
        (const int*)row_ptr, (const int*)run_start, (const int*)run_stop,
        (const float*)b, (const float*)c, (float*)out, (const unsigned*)unsure, n, window_k,
        edge_chunk, alpha, beta, with_c);
  }
  return cudaGetLastError();
}
