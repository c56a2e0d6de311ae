// spmm_ell: out = alpha * A @ B + beta * C over the ELL gather pack
// (format/pack_ell.py), the virtual hub rows folded into their real rows in
// the same launch.
//
// Replaces: sextans_tpu/ops/spmm_ell_pallas.py, spmm_ell_gather_padded /
// _kernel (the Pallas TPU kernel K5) and the hub fold after it (:266-308).
// The TPU kernel fetched B rows as 4 KiB (8, 128) chunks by DMA,
// double-buffered with per-octet semaphores, and pulled each row out with a
// masked sublane reduction; XLA then folded the virtual rows by a
// scatter-add. None of it carries over. Here a group of `lanes` threads owns
// a tile of the host scan ell_tiles (ops/launch.py): one to three whole
// logical rows (a real row followed by its virtual rows in fold-table
// order) whose padded rows read the same B row slot by slot, as the dofs of
// a finite-element node do. The group reads each slot's B row once for all
// of them, keeps every sum and the fold in registers, and writes each
// output once.
//
// C and out hold `m_rows` rows: m, the real rows (SpmmPlan.__call__ hands
// the caller's C as it lies and a fresh (m, N) output), or up to m_padded
// (SpmmPlan.repeat, which carries the whole padded C). A padded row below
// m_rows reads its C and writes its out. A row past m_rows (a virtual or
// pad row of an (m, N) call) has no C; its o stays in registers, goes into
// its real row's sum and is never stored, except where a logical row
// outgrows a tile (below).
//
// Per padded row i (virtual hub rows and padding rows included) and column
// chunk [c0, c0 + VEC):
//   acc = 0; for r in 0 .. R-1, in order:
//     if vals[i, r] != 0: acc = fma(vals[i, r], B[cols[i, r], c0:], acc)
//   o[i] = fma(alpha, acc, beta * C[i, c0:])   (alpha * acc where i has no C)
// then, for a real row i and its virtual rows v_1 .. v_f in fold-table order,
//   out[i] = (..(o[i] + (o[v_1] - beta * C[v_1])) + ..) + (o[v_f] - beta * C[v_f])
// (the beta term only where v has a C; o[v] as it is otherwise, which is
// what a zero pad of C gave, up to the sign of a zero) with __fmul_rn,
// __fsub_rn, __fadd_rn in plain mode, and in f64 from the f32 o's, rounded
// once, in precise mode; a virtual row below m_rows also writes its own o
// to out. Arithmetic: IEEE f32 FFMA (__fmaf_rn), no TF32 (the chain has no
// block to contract); the plain version (ops/spmm_ell.py) takes the same
// roundings in the same order. A slot whose value is 0 is never added: its
// product is dropped by a select, so padding is immune to a non-finite B,
// as the TPU kernel's masked extract is.
//
// Precise mode (PRECISE; SpmmConfig.precise 1 and 2 are one computation
// here, as the TPU kernel's one `precise` branch): a compensation `comp`
// beside each accumulator, and per slot whose value is not 0 the exact
// product two_prod(vals[i, r], B[cols[i, r], c]) and one Neumaier step
// (df32.cuh, the TPU kernel's spmm_ell_pallas.py:121-128); then the
// compensated epilogue with or without C (:134-142), and the fold in f64.
//
// Thread map: `lanes` threads a tile (a power of two >= N / VEC, at most 32;
// each thread walks the column chunks lane, lane + lanes, ...), 256 threads
// a CTA. A thread takes the slots U at a time (8 where R is a multiple of 8,
// else 4): their columns and values, then the U B rows, then the
// multiply-adds, so that U loads are in flight where a branch per slot would
// wait for each. A logical row of more
// than ELL_LONG_ROWS padded rows (a power-law hub) is cut into tiles of one
// padded row, and spmm_ell_long_fold_kernel, launched after the tiles only
// when such rows exist, folds it. Such a row's virtual rows past m_rows are
// stored for that fold in `scratch`, at row `row - m_rows`; the wrapper
// allocates it, (m_padded - m_rows) rows, only where such rows exist.
//
// What bounds it on the H100: bytes, and where they come from. The least
// traffic is 8 * nnz + 4 * (K + 2M) * N bytes against 2 * nnz * N flops: at
// cant_like N = 512, 0.124 ms at 3.35 TB/s against 0.058 ms at 67 TFLOP/s.
// The parent kernel gathered each live slot's B row on its own, 7.74 GB at
// cant_like N = 512 (60 times B), from L2 and L1, one load in flight a
// thread; its fold was ten PyTorch launches after it, as long again on the
// device. Here a tile of G logical rows gathers each B row once for all G
// (G = 3 on cant_like: 2.6 GB), U at a time, and the fold reads nothing
// back. On an (m, N) call C and out move 4 * 2M * N bytes, the least; a
// padded call reads and writes every one of the m_padded rows (3x m on
// the cant stand-in, whose virtual rows are 66 % of them). A tile's B rows
// are not staged in shared memory: a CTA that staged
// its tiles' distinct rows there (two CTAs an SM at 112 KB each) was slower
// than these direct loads at every shape measured, its copies and syncs
// serialised at that occupancy (PERF.md). Where the logical rows do
// not repeat their columns (synthetic4704: a mean of 1.5 rows a group),
// ell_tiles keeps one a tile (group_max 1): wider groups there only add
// divergent work.

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
__device__ __forceinline__ float pick(bool p, float a, float b) { return p ? a : b; }
__device__ __forceinline__ float4 pick(bool p, float4 a, float4 b) {
  return make_float4(p ? a.x : b.x, p ? a.y : b.y, p ? a.z : b.z, p ? a.w : b.w);
}
__device__ __forceinline__ float lane_of(float x, int) { return x; }
__device__ __forceinline__ float lane_of(float4 x, int e) {
  return e == 0 ? x.x : e == 1 ? x.y : e == 2 ? x.z : x.w;
}
__device__ __forceinline__ void set_lane(float& x, int, float v) { x = v; }
__device__ __forceinline__ void set_lane(float4& x, int e, float v) {
  if (e == 0) x.x = v; else if (e == 1) x.y = v; else if (e == 2) x.z = v; else x.w = v;
}

// One fold step of a column: acc += o_v - beta * C[v] (the beta term only
// where v has a C), in f32 (plain mode, `facc`) or f64 (precise, `dacc`).
template <bool PRECISE>
__device__ __forceinline__ void fold_step(float& facc, double& dacc, float ov, float cv,
                                          float beta, bool has_c) {
  if constexpr (PRECISE) {
    const double add = has_c ? __dsub_rn((double)ov, __dmul_rn((double)cv, (double)beta))
                             : (double)ov;
    dacc = __dadd_rn(dacc, add);
  } else {
    facc = __fadd_rn(facc, has_c ? __fsub_rn(ov, __fmul_rn(beta, cv)) : ov);
  }
}

// A tile of g <= G logical rows, each of P padded rows at rows[pos0 + m * P
// + p] (p = 0 its real row); every member's padded row p reads the B rows of
// member 0's cols, slot by slot (ell_tiles makes them equal). U slots at a
// time. C and out hold m_rows rows.
template <int VEC, bool PRECISE, int G, int U>
__global__ void __launch_bounds__(256) spmm_ell_kernel(
    const float* __restrict__ vals,       // (m_padded, R)
    const int* __restrict__ cols,         // (m_padded, R)
    const int* __restrict__ tile_ptr,     // (tiles + 1,) into rows
    const int* __restrict__ rows,         // (m_padded,) padded rows in tile order
    const int* __restrict__ members,      // (tiles,) logical rows of each tile
    const float* __restrict__ b,          // (k, n), k >= 1
    const float* __restrict__ c,          // (m_rows, n) or null
    float* __restrict__ out,              // (m_rows, n)
    float* __restrict__ scratch,          // (m_padded - m_rows, n) or null
    int n_tiles, int r_slots, int n, int m_rows, int lanes_log2, float alpha, float beta,
    int with_c) {
  using T = typename Vec<VEC>::T;
  const size_t tid = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t tile = tid >> lanes_log2;
  if (tile >= (size_t)n_tiles) return;
  const int lanes = 1 << lanes_log2;
  const int lane = (int)(tid & (lanes - 1));
  const int pos0 = tile_ptr[tile], g = members[tile];
  const int P = (tile_ptr[tile + 1] - pos0) / g;
  const size_t nv = (size_t)n / VEC;
  const T* bv = reinterpret_cast<const T*>(b);
  const T* cv = reinterpret_cast<const T*>(c);
  T* ov = reinterpret_cast<T*>(out);
  T* sv = reinterpret_cast<T*>(scratch);

  for (size_t q = lane; q < nv; q += lanes) {  // column chunk q
    T fsum[G];            // plain mode: each member's real row and its folds so far
    double dsum[G][VEC];  // precise mode: the same in f64
    for (int p = 0; p < P; ++p) {
      int prow[G];
#pragma unroll
      for (int m = 0; m < G; ++m) prow[m] = rows[pos0 + (m < g ? m : 0) * P + p];
      T acc[G], comp[G];  // comp is read only when PRECISE
#pragma unroll
      for (int m = 0; m < G; ++m) acc[m] = comp[m] = T{};
      const int* crow = cols + (size_t)prow[0] * r_slots;
      for (int r0 = 0; r0 < r_slots; r0 += U) {
        int cx[U];
        float v[G][U];
        bool any[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const bool in = r0 + u < r_slots;
          cx[u] = in ? __ldg(crow + r0 + u) : 0;
          any[u] = false;
#pragma unroll
          for (int m = 0; m < G; ++m) {
            v[m][u] = in && m < g ? __ldg(vals + (size_t)prow[m] * r_slots + r0 + u) : 0.f;
            any[u] |= v[m][u] != 0.f;
          }
        }
        T x[U];
#pragma unroll
        for (int u = 0; u < U; ++u) x[u] = any[u] ? __ldg(bv + (size_t)cx[u] * nv + q) : T{};
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
          for (int m = 0; m < G; ++m) {
            const bool live = v[m][u] != 0.f;
            if constexpr (PRECISE) {
              T a = acc[m], e = comp[m];
              sx_df32::mul_acc_step(v[m][u], x[u], a, e);
              acc[m] = pick(live, a, acc[m]);
              comp[m] = pick(live, e, comp[m]);
            } else {
              acc[m] = pick(live, mul_add(v[m][u], x[u], acc[m]), acc[m]);
            }
          }
      }
      T s[G];
      bool kept[G];  // the row lies in C and out
#pragma unroll
      for (int m = 0; m < G; ++m) {
        kept[m] = prow[m] < m_rows;
        s[m] = with_c && kept[m] ? __ldg(cv + (size_t)prow[m] * nv + q) : T{};
      }
#pragma unroll
      for (int m = 0; m < G; ++m) {
        if (m >= g) continue;
        const bool has_c = with_c && kept[m];
        T o;
        if constexpr (PRECISE) {
          o = sx_df32::epilogue(acc[m], comp[m], s[m], alpha, beta, has_c);
        } else {
          o = epi(acc[m], s[m], alpha, beta, has_c);
        }
        if (p == 0) {
          fsum[m] = o;
#pragma unroll
          for (int e = 0; e < VEC; ++e) dsum[m][e] = (double)lane_of(o, e);
          continue;
        }
        if (kept[m]) ov[(size_t)prow[m] * nv + q] = o;  // a virtual row's own output
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          float f = lane_of(fsum[m], e);
          fold_step<PRECISE>(f, dsum[m][e], lane_of(o, e), lane_of(s[m], e), beta, has_c);
          set_lane(fsum[m], e, f);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < G; ++m) {
      if (m >= g) continue;
      T o = fsum[m];
      if constexpr (PRECISE) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) set_lane(o, e, __double2float_rn(dsum[m][e]));
      }
      const int row = rows[pos0 + m * P];
      if (row < m_rows) {
        ov[(size_t)row * nv + q] = o;
      } else if (sv != nullptr) {  // a long row's virtual row, kept for its fold
        sv[(size_t)(row - m_rows) * nv + q] = o;
      }
    }
  }
}

// The fold of the logical rows that outgrow a tile: their real rows' out
// (the tile kernel wrote their o) gets each virtual row's o - beta * C in
// fold-table order (o as it is where the row has no C), one thread a
// column. A virtual row's o is in out below m_rows, else in scratch at
// row v - m_rows.
template <bool PRECISE>
__global__ void spmm_ell_long_fold_kernel(
    const int* __restrict__ long_ptr, const int* __restrict__ long_rows,
    const int* __restrict__ long_virt, const float* __restrict__ c,
    float* __restrict__ out, const float* __restrict__ scratch, int n, int m_rows,
    float beta, int with_c) {
  const int col = blockIdx.y * blockDim.x + threadIdx.x;
  if (col >= n) return;
  const size_t o = (size_t)long_rows[blockIdx.x] * n + col;
  float facc = out[o];
  double dacc = (double)facc;
  for (int j = long_ptr[blockIdx.x]; j < long_ptr[blockIdx.x + 1]; ++j) {
    const int v = long_virt[j];
    const bool kept = v < m_rows;
    const size_t at = (size_t)v * n + col;
    const bool has_c = with_c && kept;
    fold_step<PRECISE>(facc, dacc, kept ? out[at] : scratch[(size_t)(v - m_rows) * n + col],
                       has_c ? c[at] : 0.f, beta, has_c);
  }
  out[o] = PRECISE ? __double2float_rn(dacc) : facc;
}

constexpr int kThreads = 256;

template <int VEC, bool PRECISE, int G, int U>
cudaError_t launch(const void* const* p, int n_tiles, int r_slots, int n, int n_long,
                   int m_rows, float alpha, float beta, int with_c, int lanes_log2,
                   cudaStream_t stream) {
  const size_t blocks = (((size_t)n_tiles << lanes_log2) + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  spmm_ell_kernel<VEC, PRECISE, G, U><<<(unsigned)blocks, kThreads, 0, stream>>>(
      (const float*)p[0], (const int*)p[1], (const int*)p[2], (const int*)p[3],
      (const int*)p[4], (const float*)p[8], (const float*)p[9], (float*)p[10],
      (float*)p[11], n_tiles, r_slots, n, m_rows, lanes_log2, alpha, beta, with_c);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || n_long == 0) return e;
  spmm_ell_long_fold_kernel<PRECISE><<<dim3(n_long, (n + 127) / 128), 128, 0, stream>>>(
      (const int*)p[5], (const int*)p[6], (const int*)p[7], (const float*)p[9],
      (float*)p[10], (const float*)p[11], n, m_rows, beta, with_c);
  return cudaGetLastError();
}

// The instance for the tiles' size and R: 8 slots at a time where R is a
// multiple of 8 (cant_like's 32), else 4 (synthetic4704's 12).
template <int VEC, bool PRECISE>
cudaError_t launch_g(int group_max, const void* const* p, int n_tiles, int r_slots, int n,
                     int n_long, int m_rows, float alpha, float beta, int with_c,
                     int lanes_log2, cudaStream_t s) {
#define SX_ARGS p, n_tiles, r_slots, n, n_long, m_rows, alpha, beta, with_c, lanes_log2, s
  const bool wide = r_slots % 8 == 0;
  switch (group_max) {
    case 1:
      return wide ? launch<VEC, PRECISE, 1, 8>(SX_ARGS) : launch<VEC, PRECISE, 1, 4>(SX_ARGS);
    case 2:
      return wide ? launch<VEC, PRECISE, 2, 8>(SX_ARGS) : launch<VEC, PRECISE, 2, 4>(SX_ARGS);
    case 3:
      return wide ? launch<VEC, PRECISE, 3, 8>(SX_ARGS) : launch<VEC, PRECISE, 3, 4>(SX_ARGS);
    default: return cudaErrorInvalidValue;
  }
#undef SX_ARGS
}

}  // namespace

extern "C" int spmm_ell_launch(
    const void* vals, const void* cols, const void* tile_ptr, const void* rows,
    const void* members, const void* long_ptr, const void* long_rows, const void* long_virt,
    const void* b, const void* c, void* out, void* scratch,
    int n_tiles, int r_slots, int n, int n_long, int m_rows, float alpha, float beta,
    int with_c, int precise, int vec, int lanes, int group_max, void* stream) {
  const void* p[] = {vals, cols, tile_ptr, rows, members, long_ptr, long_rows, long_virt,
                     b, c, out, scratch};
  int lanes_log2 = 0;
  while ((1 << lanes_log2) < lanes) ++lanes_log2;
  // the wrapper's map (ops/spmm_ell.py:ell_launch) must be this kernel's
  if ((1 << lanes_log2) != lanes || lanes > 32 || n_tiles < 1 || n < 1 || r_slots < 1 ||
      m_rows < 0 || (precise != 0 && precise != 1) || (vec != 1 && vec != 4) ||
      (vec == 4 && n % 4))
    return cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
#define SX_ARGS \
  group_max, p, n_tiles, r_slots, n, n_long, m_rows, alpha, beta, with_c, lanes_log2, s
  switch (vec * 2 + precise) {
    case 2: return launch_g<1, false>(SX_ARGS);
    case 3: return launch_g<1, true>(SX_ARGS);
    case 8: return launch_g<4, false>(SX_ARGS);
    case 9: return launch_g<4, true>(SX_ARGS);
    default: return cudaErrorInvalidValue;
  }
#undef SX_ARGS
}
