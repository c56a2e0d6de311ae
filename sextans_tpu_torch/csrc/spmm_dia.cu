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
// B row i + off from a window of B staged in shared memory, and a row
// outside [0, k) is staged as 0, which is what the zero padding held, so B
// needs no padded copy and no offset is trusted for an address (the run
// plan, which sizes both kernels' shared memory, is held to the offsets on
// the host where it is made: ops/spmm_dia.py, DiaRuns). dvals is one (D, m)
// array for both kernels; B and C stay (k, n) and (m, n), row-major.
//
// Per output cell (i, j), for d = 0 .. D-1 in ascending offset order (the
// order the TPU kernel's clusters give):
//   acc = fma(dvals[d, i], B[i + offsets[d], j], acc)      from acc = 0
//   out[i, j] = fma(alpha, acc, beta * C[i, j])   (alpha * acc without C)
// The dense walks (spmm_dia_kernel, spmm_dia_skinny_kernel) multiply every
// diagonal entry, stored zeros included, as on the TPU. spmm_dia's entry
// walk (spmm_dia_entry_kernel) skips the stored zeros where B is finite:
// there fma(0, x, acc) == acc, so the bits are the same (up to the sign of
// an exact zero, which compares equal); a window of B that holds an Inf or
// a NaN is walked densely, so that 0 x Inf and 0 x NaN give NaN as on the
// TPU. Arithmetic: IEEE f32 FFMA (__fmaf_rn), no TF32; the plain versions
// (ops/spmm_dia.py) take the same roundings in the same order.
//
// Precise mode (PRECISE = 1; the TPU kernels' one `precise` branch, which
// SpmmConfig.precise 1 and 2 both reach): per diagonal, in the same order,
// the exact product two_prod(dvals[d, i], B[i + off, j]) and one Neumaier
// step into (acc, comp) (df32.cuh; spmm_dia_pallas.py:90-99 and 264-271).
// The TPU starts from (p, -pe) on the first diagonal, which is the step
// from (0, 0). Then the compensated epilogue (:103-110, :275-282). A row
// outside [0, k) reads 0, whose product is (0, 0). spmm_dia keeps a
// `comp` beside each of its 8 rows of `acc`. Every level is an
// `if constexpr`, so the plain-mode code is what it was.
//
// spmm_dia (N > 32): a CTA owns a tile of kTileRows = 64 rows and TN =
// 16 * VEC columns (64 at VEC = 4: N % 4 == 0 and 16-byte aligned B and C;
// 16 at VEC = 1). The host cuts the ascending offsets into runs whose span
// (last offset minus first) is at most 64 (ops/spmm_dia.py: dia_runs and
// dia_plan). For each run in order the CTA stages, with
// cp.async (16-byte copies of B at VEC = 4, 4-byte otherwise and for
// dvals), the run's window of B, rows row0 + off_first .. row0 + 63 +
// off_last of its TN columns, the run's dvals tile (length x 64) and its
// offsets in shared memory; a row outside [0, k) is written as zeros, so
// the inner loop has no bounds test. Then each thread, over 8 consecutive
// rows and VEC columns of the tile (16 lanes across the columns, 8 row
// groups: 128 threads), steps x = 0 .. span over the window: its row r at
// step x is window row r0 + x + r, so a step needs one new row. Steps go in
// groups of 8 whose 8 new rows are read together into registers (15 rows
// of the window held, every index static once the group is unrolled), and
// a step whose offset is one of the run's diagonals (a uniform test) adds
// that diagonal: two float4 of dvals from shared memory, read one diagonal
// ahead, and 8 * VEC FFMA. A run of consecutive offsets (scircuit_like's
// -60..60, two runs) reads one B row a diagonal; a gapped one reads
// span + 1 rows for its diagonals. The accumulators stay in registers across runs, and
// each thread's C rows are prefetched into L2 at the start. The CTAs of one
// row tile are adjacent in the grid, so the dvals tile and the window's
// overlap with the next row tile come from L2.
// Shared memory a CTA: 4 * ((64 + span + 8) * TN + length * 65) bytes, span
// and length those of the plan's widest and longest run (a group reads up
// to 7 rows past a window): 51,716 at VEC = 4 and the run limit (span 64,
// length 65), so that four CTAs share an SM and some stage their windows
// while others compute. The CTAs of a wave stage, compute and write in
// step, so with two CTAs an SM those phases add up: on an H100 a run limit
// of 160 with two CTAs an SM, and a persistent CTA that stages its next job
// in a second stage while it computes (one CTA an SM), both measured slower
// on scircuit_like than this limit with four, though its two runs (-60..4,
// 5..60) stage 128 + 119 rows of B a tile where one run staged 184. A
// plan that needs more
// than a CTA may hold is refused before launch (SharedMemoryError).
//
// spmm_dia's entry walk (N > 32), where the hybrid plan finds that its
// slots hold at most 0.3 of the dense walk's steps in plain mode, and
// always in precise mode (ops/spmm_dia.py: entry_walk_slots, from both
// walks' times on an H100: PERF.md §6; a circuit split's diagonals are 4 %
// full, a 3-D stencil's 7 take 131 steps): the same tiles, threads and
// window of B, over an entry map made once a plan from the values it
// uploads (dia_entry_map), whose runs may span 128 offsets, since no dvals
// tile is staged (scircuit_like's -60..60: one run, 184 rows of B a tile
// where the dense walk's two runs stage 128 + 119). A tile's rows are taken
// in the map's order, the fullest first, so that the 8 rows of a thread
// hold about as many entries; per run and group of 8 rows the map lists
// slots of 8 (value, window row) pairs, one a row, in ascending offset
// order, a row with fewer padded with (0, row 0). Each run the CTA stages,
// with cp.async, the window and the tile's slots beside it (as many as
// leave four CTAs an SM; a tile with more reads its own from global
// memory); each thread then reads the window's values it copied, and one
// __syncthreads_or tells the CTA whether any is not finite: if so, it walks
// the run densely, dvals from global memory, else each thread adds its
// slots, a float4 of B and 4 FFMA a row and slot. The map is made from the
// values the kernel is given with it: a map of other values would skip
// their entries (ops/spmm_dia.py refuses one).
//
// spmm_dia_skinny (N <= 32) walks the same run plan as spmm_dia. A CTA owns
// a tile of `rows` rows by all n columns: 64 rows where those tiles fill the
// card four times over (laplace3d_64: 4,096 tiles), else 16 (synthetic4704:
// 294 tiles, where 64 would leave half the SMs idle); ops/spmm_dia.py:
// dia_skinny_launch. Its threads take the tile's row-major (row, column)
// cells t, t + threads, ...: one each in a 16-row tile, so that a small grid
// still holds enough warps to hide the latency of each diagonal's two
// shared-memory reads, and four each in a 64-row tile, whose CTAs are many;
// a warp reads 32 consecutive floats of a window row. For each run it stages, with cp.async (16-byte copies of B
// when n % 4 == 0 and B is 16-byte aligned, 4-byte otherwise and for
// dvals), the run's window of B, rows row0 + off_first .. row0 + rows - 1 +
// off_last, zeros outside [0, k), the run's dvals (length x rows) and its
// offsets, into one of four buffers (16-row tiles) or two (64-row tiles),
// one cp.async group a run: the next runs' copies land while this run's
// diagonals are added. A cell adds its
// diagonals in ascending order from its window, one FFMA (precise: two_prod
// and a Neumaier step) each, so every output equals the plain version's to
// the bit. Shared memory a CTA: its buffers, each of
// (rows + span) * n + (rows + 1) * length floats rounded to 16 bytes (4 x
// 9,552 bytes for synthetic4704's nine runs at N = 16).
//
// What bounds them on the H100: the least traffic is dvals once, B once and C
// in and out, 4 * (D * M + K * N + 2 * M * N) bytes, against 2 * D * M * N
// flops; at scircuit_like N = 512 (D = 121, M = 170,998) that is 0.34 ms at
// 3.35 TB/s against 0.32 ms at 67 TFLOP/s. K7 at N <= 32 does few flops a
// staged byte: a run's staging (its window, from L2, rows + span rows a
// tile) and the CTA's wait for it set its pace, which the ring hides
// behind the earlier runs' diagonals. K6 stages B (64 + span) / 64
// times a run from L2 (3.9 times on scircuit_like's two runs) and dvals
// once per column tile;
// from shared memory, a diagonal costs a thread one float4 of B and two of
// dvals for 32 FFMA (VEC = 4). `tools/kernel_times.py --pace` splits its
// time on an H100 (PERF.md): plans cut by hand into more runs give each
// run's staging, one diagonal alone the epilogue, and the rest is the
// steps, which run well below the FFMA peak; the CTAs of a wave stage,
// compute and write in step, so the phases add up where more CTAs an SM
// let them overlap. Gapped offsets (synthetic4704: 256 offsets in
// -288..300, nine runs) read 589 B rows for 256 diagonals and stage
// 64 + span rows a run. The entry walk does 4 % of the dense walk's FFMA
// on scircuit_like (838,244 entries, 116,368 slots of 8 rows), so what
// bounds it is what bounds any kernel of this product: B once, C in and
// the output out, 1.05 GB, 0.316 ms at 3.35 TB/s; its window staging from
// L2 (2.9 rows of B a row of output), the C read and the output's write run
// one after another within a CTA, and four CTAs an SM overlap them in part
// (PERF.md §6: 0.425 ms on an H100, the dense walk 1.14).

#include <cstdint>

#include <cuda_runtime.h>

#include "async_copy.cuh"
#include "df32.cuh"

namespace {

constexpr int kTileRows = 64;  // rows of a spmm_dia tile
constexpr int kRows = 8;       // rows a thread
constexpr int kLanes = 16;     // threads across a tile's columns: TN = kLanes * VEC
constexpr int kThreads = kLanes * kTileRows / kRows;  // 128

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

// Row `row` of a window of TN = kLanes * VEC columns, at this lane.
template <typename T>
__device__ __forceinline__ T win_at(const float* win, int row, int lane) {
  return reinterpret_cast<const T*>(win + row * kLanes * (int)(sizeof(T) / 4))[lane];
}

// Plain mode is held to 128 registers a thread, so that four CTAs share an
// SM; precise mode needs more (it would spill), and gets two.
template <int VEC, int PRECISE>
__global__ void __launch_bounds__(kThreads, PRECISE ? 2 : 4) spmm_dia_kernel(
    const float* __restrict__ dvals,  // (D, m)
    const int* __restrict__ offsets,  // (D,), ascending
    const int* __restrict__ run_ptr,  // (n_runs + 1,)
    const float* __restrict__ b,      // (k, n)
    const float* __restrict__ c,      // (m, n) or null
    float* __restrict__ out,          // (m, n)
    int m, int k, int n, int n_runs, int span, int length, float alpha, float beta,
    int with_c) {
  using T = typename Vec<VEC>::T;
  constexpr int TN = kLanes * VEC;
  extern __shared__ float4 smem4[];
  float* win = reinterpret_cast<float*>(smem4);    // (64 + span + 8, TN)
  float* dvs = win + (kTileRows + span + kRows) * TN;  // (length, 64)
  int* rels = reinterpret_cast<int*>(dvs + length * kTileRows);  // (length,)
  const int n_ctiles = (n + TN - 1) / TN;
  const long long row0 = (long long)(blockIdx.x / n_ctiles) * kTileRows;
  const int col0 = (blockIdx.x % n_ctiles) * TN;
  const int tid = threadIdx.x;
  const int lane = tid % kLanes;
  const int r0 = (tid / kLanes) * kRows;  // the thread's first row in the tile

  const size_t nv = (size_t)n / VEC;
  const int cv = col0 / VEC + lane;
  if (with_c && (size_t)cv < nv) {  // the epilogue's C, on its way to L2 meanwhile
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (row0 + r0 + r < m)
        asm volatile("prefetch.L2 [%0];" ::"l"(reinterpret_cast<const T*>(c) +
                                                       (size_t)(row0 + r0 + r) * nv + cv));
  }
  T acc[kRows], comp[kRows];  // comp is read only when PRECISE
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = comp[r] = T{};
  for (int run = 0; run < n_runs; ++run) {
    const int d0 = run_ptr[run], len = run_ptr[run + 1] - d0;
    const int off0 = __ldg(offsets + d0);
    const int last = __ldg(offsets + d0 + len - 1) - off0;  // the run's span
    __syncthreads();  // the previous run's window and dvals are no longer read
    if constexpr (VEC == 4) {
      for (int e = tid; e < (kTileRows + last) * kLanes; e += kThreads) {
        const int i = e / kLanes, col = col0 + (e % kLanes) * 4;
        const long long row = row0 + off0 + i;
        float* dst = win + i * TN + (e % kLanes) * 4;
        if (row >= 0 && row < k && col < n)
          sx_async::cp_async16(dst, b + row * n + col);
        else
          *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    } else {
      for (int e = tid; e < (kTileRows + last) * TN; e += kThreads) {
        const int i = e / TN, col = col0 + e % TN;
        const long long row = row0 + off0 + i;
        if (row >= 0 && row < k && col < n)
          sx_async::cp_async4(win + e, b + row * n + col);
        else
          win[e] = 0.f;
      }
    }
    for (int e = tid; e < len * kTileRows; e += kThreads) {
      const long long row = row0 + e % kTileRows;
      if (row < m)
        sx_async::cp_async4(dvs + e, dvals + (size_t)(d0 + e / kTileRows) * m + row);
      else
        dvs[e] = 0.f;
    }
    for (int e = tid; e < len; e += kThreads) rels[e] = __ldg(offsets + d0 + e) - off0;
    sx_async::cp_async_wait_all();
    __syncthreads();

    // Steps x = 0 .. last over the run's window: the thread's row r at step
    // x is window row r0 + x + r. Steps go in groups of 8; R[i] holds window
    // row r0 + x0 + i, i < 15: R[0..6] carried from the last group, R[7..14]
    // read together at the group's start, so every index is static once the
    // steps are unrolled. A step whose offset is a diagonal's (x ==
    // rels[dd], a uniform test) adds that diagonal; the next diagonal's
    // dvals and offset are read before its FFMA.
    T R[2 * kRows - 1];
#pragma unroll
    for (int i = 0; i < kRows - 1; ++i) R[i] = win_at<T>(win, r0 + i, lane);
    int dd = 0, next = 0;  // rels[0] == 0
    float4 v0 = reinterpret_cast<const float4*>(dvs + r0)[0];
    float4 v1 = reinterpret_cast<const float4*>(dvs + r0)[1];
    for (int x0 = 0; x0 <= last; x0 += kRows) {
#pragma unroll
      for (int u = 0; u < kRows; ++u) R[kRows - 1 + u] = win_at<T>(win, r0 + x0 + kRows - 1 + u, lane);
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        if (x0 + u != next) continue;  // also past the run's last step
        const float v[kRows] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
        if (++dd < len) {
          const float4* dv = reinterpret_cast<const float4*>(dvs + dd * kTileRows + r0);
          v0 = dv[0];
          v1 = dv[1];
          next = rels[dd];
        } else {
          next = -1;
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          if constexpr (PRECISE) {
            sx_df32::mul_acc_step(v[r], R[u + r], acc[r], comp[r]);
          } else {
            acc[r] = mul_add(v[r], R[u + r], acc[r]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kRows - 1; ++i) R[i] = R[kRows + i];
    }
  }
  if ((size_t)cv >= nv) return;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const long long row = row0 + r0 + r;
    if (row >= m) break;
    const size_t o = (size_t)row * nv + cv;
    T s = acc[r];
    if (with_c) s = __ldg(reinterpret_cast<const T*>(c) + o);
    if constexpr (PRECISE) {
      reinterpret_cast<T*>(out)[o] = sx_df32::epilogue(acc[r], comp[r], s, alpha, beta, with_c);
    } else {
      reinterpret_cast<T*>(out)[o] = epi(acc[r], s, alpha, beta, with_c);
    }
  }
}

__device__ __forceinline__ bool finite(float x) { return isfinite(x); }
__device__ __forceinline__ bool finite(float4 x) {
  return isfinite(x.x) && isfinite(x.y) && isfinite(x.z) && isfinite(x.w);
}

// The entry walk: K6's tile and thread map, over an entry map (see the head
// of this file) in place of the dense diagonals; a thread's 8 rows are the
// tile's rows order[8 * (tid / 16) ..], not 8 consecutive ones.
template <int VEC, int PRECISE>
__global__ void __launch_bounds__(kThreads, PRECISE ? 2 : 4) spmm_dia_entry_kernel(
    const float* __restrict__ dvals,     // (D, m), walked densely where B is not finite
    const int* __restrict__ offsets,     // (D,), ascending
    const int* __restrict__ run_ptr,     // (n_runs + 1,)
    const uint2* __restrict__ order,     // (groups,): each group's 8 rows in its tile
    const int* __restrict__ slot_ptr,    // (n_runs * groups + 1,)
    const int4* __restrict__ slots,      // (S, 4): 8 values' bits, then their window rows
    const float* __restrict__ b,         // (k, n)
    const float* __restrict__ c,         // (m, n) or null
    float* __restrict__ out,             // (m, n)
    int m, int k, int n, int n_runs, int span, int staged, float alpha, float beta,
    int with_c) {
  using T = typename Vec<VEC>::T;
  constexpr int TN = kLanes * VEC;
  extern __shared__ float4 smem4[];
  float* win = reinterpret_cast<float*>(smem4);  // (64 + span, TN)
  int4* stage = reinterpret_cast<int4*>(win + (kTileRows + span) * TN);  // (staged, 4)
  const int n_ctiles = (n + TN - 1) / TN;
  const long long row0 = (long long)(blockIdx.x / n_ctiles) * kTileRows;
  const int col0 = (blockIdx.x % n_ctiles) * TN;
  const int tid = threadIdx.x;
  const int lane = tid % kLanes;
  const int r0 = (tid / kLanes) * kRows;  // the thread's place in the tile's order
  const long long groups = (m + kTileRows - 1) / kTileRows * (kTileRows / kRows);
  const long long group = (row0 + r0) / kRows;  // the thread's 8 rows
  const long long group0 = row0 / kRows;        // the tile's first

  const size_t nv = (size_t)n / VEC;
  const int cv = col0 / VEC + lane;
  if (with_c && (size_t)cv < nv) {  // the tile's C, on its way to L2 meanwhile
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (row0 + r0 + r < m)
        asm volatile("prefetch.L2 [%0];" ::"l"(reinterpret_cast<const T*>(c) +
                                                       (size_t)(row0 + r0 + r) * nv + cv));
  }
  const uint2 rows8 = __ldg(order + group);
  int lr[kRows];  // the thread's rows in the tile
#pragma unroll
  for (int r = 0; r < kRows; ++r) lr[r] = ((r < 4 ? rows8.x : rows8.y) >> (8 * (r % 4))) & 0xff;
  T acc[kRows], comp[kRows];  // comp is read only when PRECISE
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = comp[r] = T{};
  for (int run = 0; run < n_runs; ++run) {
    const int d0 = run_ptr[run], len = run_ptr[run + 1] - d0;
    const int off0 = __ldg(offsets + d0);
    const int rows = kTileRows + __ldg(offsets + d0 + len - 1) - off0;  // the window's
    // the tile's slots in this run, and the thread's group's among them
    const int t0 = __ldg(slot_ptr + run * groups + group0);
    const int t1 = __ldg(slot_ptr + run * groups + group0 + kTileRows / kRows);
    const int s0 = __ldg(slot_ptr + run * groups + group);
    const int s1 = __ldg(slot_ptr + run * groups + group + 1);
    __syncthreads();  // the previous run's window and slots are no longer read
    if constexpr (VEC == 4) {
      for (int e = tid; e < rows * kLanes; e += kThreads) {
        const int i = e / kLanes, col = col0 + (e % kLanes) * 4;
        const long long row = row0 + off0 + i;
        float* dst = win + i * TN + (e % kLanes) * 4;
        if (row >= 0 && row < k && col < n)
          sx_async::cp_async16(dst, b + row * n + col);
        else
          *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    } else {
      for (int e = tid; e < rows * TN; e += kThreads) {
        const int i = e / TN, col = col0 + e % TN;
        const long long row = row0 + off0 + i;
        if (row >= 0 && row < k && col < n)
          sx_async::cp_async4(win + e, b + row * n + col);
        else
          win[e] = 0.f;
      }
    }
    // The tile's slots beside the window where they fit, else read from
    // global memory in the walk.
    const bool here = t1 - t0 <= staged;
    if (here)
      for (int e = tid; e < 4 * (t1 - t0); e += kThreads)
        sx_async::cp_async16(stage + e, slots + 4 * (size_t)t0 + e);
    sx_async::cp_async_wait_all();  // this thread's copies are visible to it
    bool bad = false;  // a value of B this thread staged is not finite
    if constexpr (VEC == 4) {
      for (int e = tid; e < rows * kLanes; e += kThreads)
        bad |= !finite(reinterpret_cast<const float4*>(win)[e]);
    } else {
      for (int e = tid; e < rows * TN; e += kThreads) bad |= !finite(win[e]);
    }
    if (__syncthreads_or(bad)) {
      // The dense walk: every diagonal of the run, stored zeros included,
      // its dvals from global memory, so that 0 x Inf and 0 x NaN give NaN.
      for (int dd = 0; dd < len; ++dd) {
        const int rel = __ldg(offsets + d0 + dd) - off0;
        const float* dv = dvals + (size_t)(d0 + dd) * m;
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float v = row0 + lr[r] < m ? __ldg(dv + row0 + lr[r]) : 0.f;
          const T x = win_at<T>(win, lr[r] + rel, lane);
          if constexpr (PRECISE) {
            sx_df32::mul_acc_step(v, x, acc[r], comp[r]);
          } else {
            acc[r] = mul_add(v, x, acc[r]);
          }
        }
      }
      continue;
    }
    // The group's slots, each 8 (value, window row) pairs, one a row, from
    // shared memory or global: the next slot is read while this one's are
    // added.
    const int4* q = here ? stage + 4 * (s0 - t0) : slots + 4 * (size_t)s0;
    int4 q0, q1, q2, q3;
    if (s0 < s1) {
      q0 = q[0];
      q1 = q[1];
      q2 = q[2];
      q3 = q[3];
    }
    for (int s = s0; s < s1; ++s) {
      const int vb[kRows] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
      const int at[kRows] = {q2.x, q2.y, q2.z, q2.w, q3.x, q3.y, q3.z, q3.w};
      q += 4;
      if (s + 1 < s1) {
        q0 = q[0];
        q1 = q[1];
        q2 = q[2];
        q3 = q[3];
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float v = __int_as_float(vb[r]);
        const T x = win_at<T>(win, at[r], lane);
        if constexpr (PRECISE) {
          sx_df32::mul_acc_step(v, x, acc[r], comp[r]);
        } else {
          acc[r] = mul_add(v, x, acc[r]);
        }
      }
    }
  }
  if ((size_t)cv >= nv) return;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const long long row = row0 + lr[r];
    if (row >= m) continue;
    const size_t o = (size_t)row * nv + cv;
    T s = acc[r];
    if (with_c) s = __ldg(reinterpret_cast<const T*>(c) + o);
    if constexpr (PRECISE) {
      reinterpret_cast<T*>(out)[o] = sx_df32::epilogue(acc[r], comp[r], s, alpha, beta, with_c);
    } else {
      reinterpret_cast<T*>(out)[o] = epi(acc[r], s, alpha, beta, with_c);
    }
  }
}

// K7's tile: `rows` rows by all n <= 32 columns, its threads each over up
// to kSkinnyCells cells (cells t, t + threads, ... of the tile's row-major
// (row, column) index): 16 rows, a thread a cell and STAGES = 4 buffers, or
// 64 rows, 4 cells a thread and 2 buffers; each buffer of skinny_buffer
// floats (the widest window, the longest run's dvals and offsets).
constexpr int kSkinnyCells = 4;

__host__ __device__ inline int skinny_threads(int rows, int n) {
  return rows == 16 ? (rows * n + 31) / 32 * 32 : 32 * ((rows * n + 127) / 128);
}

__host__ __device__ inline int skinny_buffer(int rows, int n, int span, int length) {
  return ((rows + span) * n + length * (rows + 1) + 3) / 4 * 4;
}

template <int PRECISE, int STAGES>
__global__ void __launch_bounds__(512) spmm_dia_skinny_kernel(
    const float* __restrict__ dvals,  // (D, m)
    const int* __restrict__ offsets,  // (D,), ascending
    const int* __restrict__ run_ptr,  // (n_runs + 1,)
    const float* __restrict__ b,      // (k, n)
    const float* __restrict__ c,      // (m, n) or null
    float* __restrict__ out,          // (m, n)
    int m, int k, int n, int n_runs, int span, int length, float alpha, float beta,
    int with_c, int vec, int rows) {
  extern __shared__ float4 smem4[];
  const int buf = skinny_buffer(rows, n, span, length);
  const long long row0 = (long long)blockIdx.x * rows;
  const int tid = threadIdx.x, threads = blockDim.x;
  const int cells = rows * n;

  // Run `run`'s window of B rows row0 + off0 .. row0 + rows - 1 + off0 +
  // last, zero outside [0, k), its dvals (len x rows, zero past m) and its
  // offsets less off0, into buffer run % STAGES, as one group of cp.async
  // copies.
  auto stage = [&](int run) {
    float* win = reinterpret_cast<float*>(smem4) + (run % STAGES) * buf;
    const int d0 = run_ptr[run], len = run_ptr[run + 1] - d0;
    const int off0 = __ldg(offsets + d0);
    const int last = __ldg(offsets + d0 + len - 1) - off0;  // the run's span
    float* dvs = win + (rows + last) * n;
    int* rels = reinterpret_cast<int*>(dvs + len * rows);
    if (vec) {
      const int nq = n / 4;
      for (int e = tid; e < (rows + last) * nq; e += threads) {
        const long long r = row0 + off0 + e / nq;
        float* dst = win + 4 * e;
        if (r >= 0 && r < k)
          sx_async::cp_async16(dst, b + r * n + 4 * (e % nq));
        else
          *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    } else {
      for (int e = tid; e < (rows + last) * n; e += threads) {
        const long long r = row0 + off0 + e / n;
        if (r >= 0 && r < k)
          sx_async::cp_async4(win + e, b + r * n + e % n);
        else
          win[e] = 0.f;
      }
    }
    for (int e = tid; e < len * rows; e += threads) {
      const long long r = row0 + e % rows;
      if (r < m)
        sx_async::cp_async4(dvs + e, dvals + (size_t)(d0 + e / rows) * m + r);
      else
        dvs[e] = 0.f;
    }
    for (int e = tid; e < len; e += threads) rels[e] = __ldg(offsets + d0 + e) - off0;
    sx_async::cp_async_commit();
  };

  int at[kSkinnyCells], rw[kSkinnyCells];  // the cell's row * n + col, and its row
  float acc[kSkinnyCells], comp[kSkinnyCells];  // comp is read only when PRECISE
  const int mine = (cells + threads - 1) / threads;  // cells a thread, <= kSkinnyCells
#pragma unroll
  for (int u = 0; u < kSkinnyCells; ++u) {
    at[u] = min(tid + u * threads, cells - 1);
    rw[u] = at[u] / n;
    acc[u] = comp[u] = 0.f;
  }
  for (int run = 0; run < n_runs && run < STAGES - 1; ++run) stage(run);
  for (int run = 0; run < n_runs; ++run) {
    // the next runs' copies land while this one's diagonals are added
    if (run + STAGES - 1 < n_runs) {
      stage(run + STAGES - 1);
      sx_async::cp_async_wait<STAGES - 1>();
    } else {
      sx_async::cp_async_wait<0>();
    }
    __syncthreads();  // the run's buffer is complete, zeros and offsets too
    const float* win = reinterpret_cast<const float*>(smem4) + (run % STAGES) * buf;
    const int d0 = run_ptr[run], len = run_ptr[run + 1] - d0;
    const int last = __ldg(offsets + d0 + len - 1) - __ldg(offsets + d0);
    const float* dvs = win + (rows + last) * n;
    const int* rels = reinterpret_cast<const int*>(dvs + len * rows);
    for (int dd = 0; dd < len; ++dd) {  // ascending offsets, as across runs
      const int shift = rels[dd] * n;
#pragma unroll
      for (int u = 0; u < kSkinnyCells; ++u) {
        if (u >= mine) break;
        const float v = dvs[dd * rows + rw[u]];
        const float x = win[at[u] + shift];
        if constexpr (PRECISE) {
          sx_df32::mul_acc_step(v, x, acc[u], comp[u]);
        } else {
          acc[u] = __fmaf_rn(v, x, acc[u]);
        }
      }
    }
    __syncthreads();  // every thread is done with the buffer before it is staged again
  }
#pragma unroll
  for (int u = 0; u < kSkinnyCells; ++u) {
    const int idx = tid + u * threads;
    const long long r = row0 + idx / n;
    if (idx >= cells || r >= m) continue;
    const size_t o = (size_t)r * n + idx % n;
    const float s = with_c ? __ldg(c + o) : 0.f;
    if constexpr (PRECISE) {
      out[o] = sx_df32::epilogue(acc[u], comp[u], s, alpha, beta, with_c);
    } else {
      out[o] = epi(acc[u], s, alpha, beta, with_c);
    }
  }
}

template <int VEC, int PRECISE>
cudaError_t launch_wide(const float* dvals, const int* offsets, const int* run_ptr,
                        const float* b, const float* c, float* out, int m, int k, int n,
                        int n_runs, int span, int length, float alpha, float beta, int with_c,
                        int threads, int grid, int smem, cudaStream_t stream) {
  // the wrapper's map (ops/spmm_dia.py:dia_launch) must be this kernel's
  constexpr int TN = kLanes * VEC;
  const long long tiles =
      (long long)((m + kTileRows - 1) / kTileRows) * ((n + TN - 1) / TN);
  if (threads != kThreads || tiles != grid || span < 0 || length < 0 ||
      (long long)smem !=
          4LL * ((kTileRows + span + kRows) * TN + (long long)length * (kTileRows + 1)))
    return cudaErrorInvalidValue;
  auto kernel = spmm_dia_kernel<VEC, PRECISE>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  kernel<<<grid, kThreads, smem, stream>>>(dvals, offsets, run_ptr, b, c, out, m, k, n, n_runs,
                                           span, length, alpha, beta, with_c);
  return cudaGetLastError();
}

template <int VEC, int PRECISE>
cudaError_t launch_entries(const float* dvals, const int* offsets, const int* run_ptr,
                           const void* order, const int* slot_ptr, const int* slots,
                           const float* b, const float* c, float* out, int m, int k, int n,
                           int n_runs, int span, int staged, float alpha, float beta,
                           int with_c, int threads, int grid, int smem, cudaStream_t stream) {
  // the wrapper's map (ops/spmm_dia.py:dia_entry_launch) must be this kernel's
  constexpr int TN = kLanes * VEC;
  const long long tiles =
      (long long)((m + kTileRows - 1) / kTileRows) * ((n + TN - 1) / TN);
  if (threads != kThreads || tiles != grid || span < 0 || staged < 0 ||
      (long long)smem != 4LL * (kTileRows + span) * TN + 64LL * staged ||
      reinterpret_cast<uintptr_t>(slots) % 16 || reinterpret_cast<uintptr_t>(order) % 8)
    return cudaErrorInvalidValue;
  auto kernel = spmm_dia_entry_kernel<VEC, PRECISE>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  kernel<<<grid, kThreads, smem, stream>>>(
      dvals, offsets, run_ptr, reinterpret_cast<const uint2*>(order), slot_ptr,
      reinterpret_cast<const int4*>(slots), b, c, out, m, k, n, n_runs, span, staged, alpha,
      beta, with_c);
  return cudaGetLastError();
}

}  // namespace

extern "C" int spmm_dia_entry_launch(
    const void* dvals, const void* offsets, const void* run_ptr, const void* order,
    const void* slot_ptr, const void* slots, const void* b, const void* c, void* out, int m,
    int k, int n,
    int n_runs, float alpha, float beta, int with_c, int precise, int vec, int span,
    int staged, int threads, int grid, int smem, void* stream) {
#define SX_ENTRY(V, P)                                                                      \
  launch_entries<V, P>((const float*)dvals, (const int*)offsets, (const int*)run_ptr, order, \
                       (const int*)slot_ptr, (const int*)slots, (const float*)b,             \
                       (const float*)c, (float*)out, m, k, n, n_runs, span, staged, alpha,   \
                       beta, with_c, threads, grid, smem, (cudaStream_t)stream)
  switch (vec * 2 + precise) {
    case 2: return SX_ENTRY(1, 0);
    case 3: return SX_ENTRY(1, 1);
    case 8: return SX_ENTRY(4, 0);
    case 9: return SX_ENTRY(4, 1);
    default: return cudaErrorInvalidValue;
  }
#undef SX_ENTRY
}

extern "C" int spmm_dia_launch(
    const void* dvals, const void* offsets, const void* run_ptr, const void* b, const void* c,
    void* out, int m, int k, int n, int n_runs, float alpha, float beta, int with_c,
    int precise, int vec, int span, int length, int threads, int grid, int smem,
    void* stream) {
  if (precise != 0 && precise != 1) return cudaErrorInvalidValue;
#define SX_WIDE(V, P)                                                                    \
  launch_wide<V, P>((const float*)dvals, (const int*)offsets, (const int*)run_ptr,        \
                    (const float*)b, (const float*)c, (float*)out, m, k, n, n_runs, span, \
                    length, alpha, beta, with_c, threads, grid, smem, (cudaStream_t)stream)
  switch (vec * 2 + precise) {
    case 2: return SX_WIDE(1, 0);
    case 3: return SX_WIDE(1, 1);
    case 8: return SX_WIDE(4, 0);
    case 9: return SX_WIDE(4, 1);
    default: return cudaErrorInvalidValue;
  }
#undef SX_WIDE
}

extern "C" int spmm_dia_skinny_launch(
    const void* dvals, const void* offsets, const void* run_ptr, const void* b, const void* c,
    void* out, int m, int k, int n, int n_runs, float alpha, float beta, int with_c,
    int precise, int vec, int span, int length, int rows, int threads, int grid, int smem,
    void* stream) {
  if (precise != 0 && precise != 1) return cudaErrorInvalidValue;
  // the wrapper's map (ops/spmm_dia.py:dia_skinny_launch) must be this kernel's
  const int stages = rows == 16 ? 4 : 2;
  if (n < 1 || n > 32 || span < 0 || length < 0 || (vec && n % 4) ||
      (rows != 16 && rows != 64) || threads != skinny_threads(rows, n) ||
      grid != (m + rows - 1) / rows ||
      (long long)smem != 4LL * stages * skinny_buffer(rows, n, span, length))
    return cudaErrorInvalidValue;
  auto kernel = precise ? (rows == 16 ? spmm_dia_skinny_kernel<1, 4> : spmm_dia_skinny_kernel<1, 2>)
                        : (rows == 16 ? spmm_dia_skinny_kernel<0, 4> : spmm_dia_skinny_kernel<0, 2>);
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const float*)dvals, (const int*)offsets, (const int*)run_ptr, (const float*)b,
      (const float*)c, (float*)out, m, k, n, n_runs, span, length, alpha, beta, with_c, vec,
      rows);
  return cudaGetLastError();
}
