// spmm_edge: C = alpha * A @ B + beta * C over the edge-stream pack
// (format/pack_edge.py), one warp per (M-tile, 32-column chunk).
//
// Replaces: sextans_tpu/ops/spmm_edge_pallas.py, spmm_edge_padded / _kernel
// (the Pallas TPU kernel K4). On the TPU the chunks of an M-tile ran in order
// along a sequential grid axis and the accumulator lived in VMEM across grid
// steps. Here each warp walks its M-tile's chunk range itself, taken from a
// host scan of chunk_mtile (tile_ptr / tile_chunks, uploaded once with the
// plan), so the padding-only chunks that the packer appends for empty M-tiles
// need no special case.
//
// Per edge, decoded from its meta word w (pack_edge.py):
//   row = w >> 17, col = (w >> 2) & 0x7FFF, row_end = w & 2, pad = w & 1;
//   reg = fma(v, B[kw * window_k + col, c], reg)
//   if row_end: acc[row, c] += reg; reg = 0
// then the epilogue fma(alpha, acc, beta * C), or alpha * acc without C.
// Arithmetic: IEEE f32 FFMA (__fmaf_rn), one rounding per edge where the TPU
// kernel rounds its product and its sum apart; no TF32. The plain version
// (ops/spmm_edge.py) takes every rounding of this list in the same order.
// The edges are walked one by one in pack order, so edge_lanes (which only
// pads row runs to a multiple of L for the TPU's L registers) changes
// nothing: a pad adds 0 * B[window row 0] (MASKED == false, as the TPU does;
// NaN for non-finite B) or nothing at all (MASKED == true, edge_masked). A
// run that straddles a chunk boundary flushes twice: the packer forces
// row_end on each chunk's last slot, and the flush adds, never stores.
//
// Thread map: lane l of a warp owns column blockIdx.y * blockDim.x + warp * 32
// + l of the M-tile for the whole kernel, so no two threads touch one cell
// and there are no atomics. Its accumulator column lives in the output
// itself (zeroed first, read-modify-written at each flush, overwritten by the
// epilogue): no shared memory, so up to 64 warps fit on an SM. The warp loads
// 32 (meta, val) pairs at a time, coalesced, and broadcasts them with
// __shfl_sync; it then issues the 32 B-row loads before the 32 multiply-adds,
// so that each lane has 32 independent loads in flight.
//
// What bounds it on the H100: bytes. The product needs 2 * nnz * N flops and
// at least 8 * nnz + 4 * (K + 2M) * N bytes of device memory traffic: at
// cant_like N = 512 that is 0.124 ms at 3.35 TB/s against 0.058 ms of f32
// work at 67 TFLOP/s. The kernel is far from that bound: each edge gathers
// one B row of the warp's 32 columns (128 bytes) from L1/L2, and each warp
// walks its M-tile's edges one after another, so the design's answer is
// latency hiding (32 loads in flight per lane, no shared memory so that many
// warps fit on an SM). With one warp per (M-tile, 32 columns), a skinny N
// leaves most SMs idle (synthetic4704 at N = 16: 10 warps for 132 SMs).
//
// Precise levels (PRECISE, SpmmConfig.precise; spmm_edge_pallas.py:87-182),
// with the error-free transforms of df32.cuh. The lane's register becomes a
// pair (reg, regc): per edge, the product p = fl(v * B) (level 2: two_prod,
// p and its error pe) goes in by acc_step(reg, regc, p[, pe]) in place of
// the FMA. At row_end the register goes into the persistent pair by
// acc_step(acc, comp, reg), then comp += regc, and both registers are reset
// by assignment. The epilogue is compensated_epilogue, one final rounding.
// comp is a second output-shaped buffer in device memory (the wrapper
// allocates it), owned cell by cell by the same lane as the accumulator. A
// masked pad adds nothing, its error included; an unmasked pad adds
// 0 * B[window row] and its error, as on the TPU. The TPU's L lane pairs
// summed at the flush become one pair here (its edges one by one).

#include <cuda_runtime.h>

#include "df32.cuh"

namespace {

constexpr int kRowShift = 17;
constexpr int kColShift = 2;
constexpr unsigned kColMask = (1u << (kRowShift - kColShift)) - 1;
constexpr unsigned kFull = 0xffffffffu;

template <bool MASKED, int PRECISE>
__global__ void spmm_edge_kernel(
    const float* __restrict__ vals,        // (chunks, E)
    const int* __restrict__ meta,          // (chunks, E)
    const int* __restrict__ chunk_kwin,    // (chunks,)
    const int* __restrict__ tile_ptr,      // (n_mtiles + 1,)
    const int* __restrict__ tile_chunks,   // (chunks,)
    const float* __restrict__ b,           // (k_padded, n)
    const float* __restrict__ c,           // (m_padded, n) or null
    float* __restrict__ out,               // (m_padded, n)
    float* __restrict__ comp,              // (m_padded, n) if PRECISE, else null
    int n, int tile_m, int window_k, int edge_chunk, float alpha, float beta,
    int with_c) {
  const int mt = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int col = blockIdx.y * blockDim.x + threadIdx.x;
  if (col - lane >= n) return;  // the whole warp is past the last column
  const bool live = col < n;    // ragged last warp: lanes still shuffle
  float* acc = out + (size_t)mt * tile_m * n + col;
  float* cmp = PRECISE ? comp + (size_t)mt * tile_m * n + col : nullptr;

  if (live)
    for (int r = 0; r < tile_m; ++r) {
      acc[(size_t)r * n] = 0.f;
      if constexpr (PRECISE != 0) cmp[(size_t)r * n] = 0.f;
    }

  const int p1 = tile_ptr[mt + 1];
  for (int p = tile_ptr[mt]; p < p1; ++p) {
    const int g = tile_chunks[p];
    const float* bwin = b + (size_t)chunk_kwin[g] * window_k * n + col;
    const int* mg = meta + (size_t)g * edge_chunk;
    const float* vg = vals + (size_t)g * edge_chunk;
    float reg = 0.f, regc = 0.f;
    for (int e0 = 0; e0 < edge_chunk; e0 += 32) {
      const int cnt = min(32, edge_chunk - e0);
      unsigned my_w = 0;
      float my_v = 0.f;
      if (lane < cnt) {
        my_w = (unsigned)__ldg(mg + e0 + lane);
        my_v = __ldg(vg + e0 + lane);
      }
      unsigned w[32];
      float bv[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        w[j] = __shfl_sync(kFull, my_w, j);
        bv[j] = 0.f;
        if (live && j < cnt && !(MASKED && (w[j] & 1u)))
          bv[j] = __ldg(bwin + (size_t)((w[j] >> kColShift) & kColMask) * n);
      }
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const float v = __shfl_sync(kFull, my_v, j);
        if (j < cnt) {
          if (!(MASKED && (w[j] & 1u))) {
            if constexpr (PRECISE == 0) {
              reg = __fmaf_rn(v, bv[j], reg);
            } else if constexpr (PRECISE == 1) {
              sx_df32::acc_step(reg, regc, __fmul_rn(v, bv[j]));
            } else {
              float p, pe;
              sx_df32::two_prod(v, bv[j], p, pe);
              sx_df32::acc_step(reg, regc, p, pe);
            }
          }
          if (w[j] & 2u) {
            if (live) {
              const size_t off = (size_t)(w[j] >> kRowShift) * n;
              if constexpr (PRECISE == 0) {
                acc[off] = __fadd_rn(acc[off], reg);
              } else {
                sx_df32::acc_step(acc[off], cmp[off], reg);
                cmp[off] = __fadd_rn(cmp[off], regc);
              }
            }
            reg = 0.f;
            regc = 0.f;
          }
        }
      }
    }
  }

  if (!live) return;
  const size_t row0 = (size_t)mt * tile_m;
  for (int r = 0; r < tile_m; ++r) {
    const size_t idx = (row0 + r) * n + col;
    const float a = out[idx];
    if constexpr (PRECISE == 0)
      out[idx] = with_c ? __fmaf_rn(alpha, a, __fmul_rn(beta, c[idx])) : __fmul_rn(alpha, a);
    else
      out[idx] = with_c ? sx_df32::compensated_epilogue(alpha, a, comp[idx], beta, c[idx])
                        : sx_df32::compensated_epilogue(alpha, a, comp[idx]);
  }
}

template <bool MASKED>
auto pick(int precise) {
  return precise == 0   ? spmm_edge_kernel<MASKED, 0>
         : precise == 1 ? spmm_edge_kernel<MASKED, 1>
                        : spmm_edge_kernel<MASKED, 2>;
}

}  // namespace

extern "C" int spmm_edge_launch(
    const void* vals, const void* meta, const void* chunk_kwin,
    const void* tile_ptr, const void* tile_chunks, const void* b,
    const void* c, void* out, void* comp, int n_mtiles, int n, int tile_m,
    int window_k, int edge_chunk, float alpha, float beta, int with_c,
    int masked, int precise, void* stream) {
  if (precise < 0 || precise > 2 || (precise && comp == nullptr))
    return cudaErrorInvalidValue;
  const int threads = n >= 128 ? 128 : (n + 31) / 32 * 32;
  const dim3 grid(n_mtiles, (n + threads - 1) / threads);
  auto kernel = masked ? pick<true>(precise) : pick<false>(precise);
  kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const float*)vals, (const int*)meta, (const int*)chunk_kwin,
      (const int*)tile_ptr, (const int*)tile_chunks, (const float*)b,
      (const float*)c, (float*)out, (float*)comp, n, tile_m, window_k,
      edge_chunk, alpha, beta, with_c);
  return cudaGetLastError();
}
