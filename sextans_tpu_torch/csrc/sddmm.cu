// sddmm: dvals[e] = G[rows[e]] . B[cols[e]] for every entry e of A, the
// sampled dense-dense product behind d/dvals of the differentiable SpMM
// (ops/autodiff.py multiplies it by alpha).
//
// Replaces no TPU kernel: the JAX package computes it with XLA ops
// (sextans_tpu/ops/autodiff.py:_sddmm, a gather of both operands' rows, a
// product and a sum), and the port did the same in PyTorch, 65,536 entries
// at a time, writing both gathered (entries, N) operands and their product to
// device memory and reading them back: ~60 GB a step at cant_like N = 512,
// ~18 ms at 3.35 TB/s, and ~500 launches.
//
// Here a CTA owns a tile of the host plan sddmm_tiles (ops/launch.py): a run
// of CSR-ordered entries (units of up to 4 rows with the same columns, as a
// finite-element node's dofs have, or a slice of a long row) whose distinct
// rows of A (G rows) and distinct columns (B rows) are the tile's slots. It
// walks N in chunks of W = VEC * LANES columns. Per chunk, cp.async copies
// each slot's W columns into one stage of a two-stage ring in shared memory,
// the next chunk's copies in flight while this one is read, columns past N
// filled with zeros; then each entry's LANES lanes multiply-add their VEC
// columns of its G slot and B slot into one f32 register of the entry, which
// it keeps across the chunks. Each B row is thus read from L2 once a chunk
// for all the tile's entries in its column, and a lane keeps the G columns of
// its run of one row's entries in registers. At the end a shuffle tree over
// the LANES lanes joins each entry's partial sums, and one lane writes
// dvals once, through the permutation to COO order where A's entries were
// not in CSR order.
//
// Arithmetic: IEEE f32 FMUL, FFMA and FADD, no tensor cores, so TF32 cannot
// touch it. Lane l of an entry, with x_v = G[r, c*W + l*VEC + v] and y_v =
// B[k, c*W + l*VEC + v] (zeros past N): acc = 0; for each chunk c,
//   p = x_0 * y_0; p = fma(x_v, y_v, p) for v = 1 .. VEC-1; acc = acc + p;
// then for off = LANES/2, .., 1: acc = acc + acc[l ^ off]; lane 0's acc is
// dvals[e]. A chunk's few products are summed apart before they join the
// lane's sum, which keeps each chain short: at cant_like N = 512 the kernel
// sits as near f64 as the plain version's sum does. ops/sddmm.py:
// sddmm_rows_walk takes the same roundings in the same order.
//
// What bounds it on the H100: bytes moved into and inside the SMs. The least
// work at cant_like N = 512 is 4.1 GFLOP (0.061 ms at 67 TFLOP/s) and G and B
// once, with the indices and dvals (~0.3 GB, 0.09 ms at 3.35 TB/s). The
// chunks of consecutive tiles read B rows of one band of A, which the 50 MB
// L2 holds, so device memory sees G and B about once; what the SMs pull from
// L2 is each tile's slots once a chunk, ~nnz / 3 B rows on cant_like (three
// dofs to a node), ~2.7 GB, against nnz B rows if each entry gathered its
// own; and shared memory serves each entry's B columns once and its G columns
// once per run of one row's entries.

#include <cstdint>

#include <cuda_runtime.h>

#include "async_copy.cuh"

namespace {

constexpr int kThreads = 128;      // ops/sddmm.py: SDDMM_THREADS
constexpr int kTileEntries = 256;  // ops/launch.py: SDDMM_TILE_ENTRIES
constexpr int kRingRows = 128;     // ops/launch.py: SDDMM_RING_ROWS

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

// A lane's part of one chunk: its VEC products, summed from the first by FFMA.
__device__ __forceinline__ float dot_part(float x, float y) { return __fmul_rn(x, y); }
__device__ __forceinline__ float dot_part(float4 x, float4 y) {
  float p = __fmul_rn(x.x, y.x);
  p = __fmaf_rn(x.y, y.y, p);
  p = __fmaf_rn(x.z, y.z, p);
  return __fmaf_rn(x.w, y.w, p);
}

// VEC floats of a row from `src`, or zeros where `live` is false (nothing
// is read then), into shared memory, asynchronously.
template <int VEC>
__device__ __forceinline__ void stage_copy(float* dst, const float* src, bool live) {
  if constexpr (VEC == 4) {
    sx_async::cp_async16_zfill(dst, src, live ? 16 : 0);
  } else {
    sx_async::cp_async4_zfill(dst, src, live ? 4 : 0);
  }
}

// One CTA a tile. Threads: kThreads / LANES groups of LANES lanes; a group
// takes a contiguous run of the tile's entries, at most PER of them.
template <int VEC, int LANES>
__global__ void __launch_bounds__(kThreads) sddmm_tile_kernel(
    const float* __restrict__ g,        // (m, n)
    const float* __restrict__ b,        // (k, n)
    const int* __restrict__ tile_ptr,   // (tiles + 1,) into the CSR-ordered entries
    const int* __restrict__ slot_ptr,   // (tiles + 1,) into slots
    const int* __restrict__ tile_rows,  // (tiles,) G rows among a tile's slots, first
    const int* __restrict__ slots,      // each tile's G rows, then its B rows
    const int* __restrict__ codes,      // (nnz,) G slot | B slot << 16
    const int* __restrict__ perm,       // (nnz,) the COO entry of each, or null
    float* __restrict__ out,            // (nnz,)
    int n, int ring_rows) {
  constexpr int W = VEC * LANES;
  constexpr int GROUPS = kThreads / LANES;
  constexpr int PER = (kTileEntries + GROUPS - 1) / GROUPS;
  using T = typename Vec<VEC>::T;
  extern __shared__ __align__(16) float ring[];  // [2][ring_rows][W]

  const int tile = blockIdx.x;
  const int e0 = tile_ptr[tile], e1 = tile_ptr[tile + 1];
  const int s0 = slot_ptr[tile], n_slots = slot_ptr[tile + 1] - s0;
  const int n_g = tile_rows[tile];
  const int group = threadIdx.x / LANES, lane = threadIdx.x % LANES;
  const int per = (e1 - e0 + GROUPS - 1) / GROUPS;
  const int first = e0 + group * per;
  const int cnt = max(0, min(per, e1 - first));

  int gs[PER], bs[PER];  // the entries' G and B slots, as offsets into a stage
  float acc[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int code = j < cnt ? __ldg(codes + first + j) : 0;
    gs[j] = (code & 0xffff) * W;
    bs[j] = (code >> 16) * W;
    acc[j] = 0.f;
  }

  const int stage_floats = ring_rows * W;
  const int chunks = (n + W - 1) / W;
  auto stage = [&](int c) {
    float* dst = ring + (c & 1) * stage_floats;
    for (int i = threadIdx.x; i < n_slots * LANES; i += kThreads) {
      const int s = i / LANES, part = i % LANES;
      const int col = c * W + part * VEC;
      const float* row = (s < n_g ? g : b) + (size_t)__ldg(slots + s0 + s) * n;
      const bool live = col < n;
      stage_copy<VEC>(dst + s * W + part * VEC, live ? row + col : row, live);
    }
    sx_async::cp_async_commit();
  };

  stage(0);
  for (int c = 0; c < chunks; ++c) {
    if (c + 1 < chunks) {
      stage(c + 1);  // its stage was last read before the previous chunk's barrier
      sx_async::cp_async_wait<1>();
    } else {
      sx_async::cp_async_wait<0>();
    }
    __syncthreads();
    const float* buf = ring + (c & 1) * stage_floats + lane * VEC;
    int held = -1;  // the G slot whose columns x holds
    T x{};
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      if (j < cnt) {
        if (gs[j] != held) {
          x = *reinterpret_cast<const T*>(buf + gs[j]);
          held = gs[j];
        }
        acc[j] = __fadd_rn(acc[j], dot_part(x, *reinterpret_cast<const T*>(buf + bs[j])));
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < PER; ++j) {
    float v = acc[j];
#pragma unroll
    for (int off = LANES / 2; off > 0; off >>= 1)
      v = v + __shfl_xor_sync(0xffffffffu, v, off, LANES);
    if (lane == 0 && j < cnt) out[perm ? __ldg(perm + first + j) : first + j] = v;
  }
}

template <int VEC, int LANES>
cudaError_t launch(const void* const* p, int n_tiles, int n, int ring_rows, cudaStream_t s) {
  const size_t smem = 2 * (size_t)ring_rows * VEC * LANES * sizeof(float);
  sddmm_tile_kernel<VEC, LANES><<<n_tiles, kThreads, smem, s>>>(
      (const float*)p[0], (const float*)p[1], (const int*)p[2], (const int*)p[3],
      (const int*)p[4], (const int*)p[5], (const int*)p[6], (const int*)p[7], (float*)p[8], n,
      ring_rows);
  return cudaGetLastError();
}

template <int VEC>
cudaError_t launch_lanes(int lanes, const void* const* p, int n_tiles, int n, int ring_rows,
                         cudaStream_t s) {
  switch (lanes) {
    case 1: return launch<VEC, 1>(p, n_tiles, n, ring_rows, s);
    case 2: return launch<VEC, 2>(p, n_tiles, n, ring_rows, s);
    case 4: return launch<VEC, 4>(p, n_tiles, n, ring_rows, s);
    case 8: return launch<VEC, 8>(p, n_tiles, n, ring_rows, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int sddmm_tile_launch(const void* g, const void* b, const void* tile_ptr,
                                 const void* slot_ptr, const void* tile_rows, const void* slots,
                                 const void* codes, const void* perm, void* out, int n_tiles,
                                 int n, int ring_rows, int vec, int lanes, void* stream) {
  const void* p[] = {g, b, tile_ptr, slot_ptr, tile_rows, slots, codes, perm, out};
  // the wrapper's map (ops/sddmm.py:sddmm_launch) must be this kernel's; the
  // ring of the largest lanes fits the 48 KB a launch gets without opting in
  if (n_tiles < 1 || n < 1 || ring_rows < 1 || ring_rows > kRingRows ||
      (vec != 1 && vec != 4) || (vec == 4 && n % 4))
    return cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return vec == 4 ? launch_lanes<4>(lanes, p, n_tiles, n, ring_rows, s)
                  : launch_lanes<1>(lanes, p, n_tiles, n, ring_rows, s);
}
