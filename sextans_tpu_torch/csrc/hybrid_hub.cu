// hybrid_hub: out[i] += alpha * (A_head[i] + A_hub[i]) @ B, in place, over
// the rows that hold an entry of a hybrid split's head columns or hub rows
// (ops/hybrid.py, ops/hybrid_hub.py).
//
// Replaces no TPU kernel. The JAX package multiplies the head columns and
// hub rows as dense planes, (M, H) @ B[head_cols] and (R, K) @ B, because
// the TPU's matrix unit wants dense tiles (sextans_tpu/ops/hybrid.py,
// _cost_based_degree prices a dense strip at MXU flops). On the H100 those
// are two f32 GEMMs whose planes are ~0.5 % full (scircuit_like: 120,794
// entries in 24,281,716 slots), and two (M, N) passes that add their
// outputs into the DIA kernel's; this pass takes their place on the
// "pallas" route: in the plain step it runs after K6 or K7 on the same
// stream and adds the entries into that kernel's output, touching no row
// without one (the precise step runs it at alpha = 1 into zeros, once for
// the head columns and once for the hub rows, and adds the parts itself).
//
// The lists (ops/hybrid_hub.py:hub_lists, made once at upload): job j is
// one output row rows[j], its entries cols[ptr[j]..ptr[j+1]) and vals
// beside them, the head part first (ptr[j]..mid[j], original column ids)
// and its hub-row part after (mid[j]..ptr[j+1]), each in ascending column.
// The first n_hub jobs are the hub rows; the rest hold head entries only.
//
// Per output cell (i, j) of job j's row, rounding as the plain version
// (ops/hybrid_hub.py:hybrid_hub_ref) does:
//   s = fma(v, B[col, j], s) over the head entries in order, from 0
//   t_w = the same over the hub entries at positions w, w + 8, w + 16, ...
//         of the part, for w = 0 .. 7, each from 0
//   t = ((t_0 + t_4) + (t_2 + t_6)) + ((t_1 + t_5) + (t_3 + t_7)), the tree
//       (t_w += t_{w+4}; t_w += t_{w+2}; t_0 += t_1)
//   out = fma(alpha, s, out) where the row has head entries, then
//   out = fma(alpha, t, out) where it has hub entries
// (K6's epilogue, then the head part, then the hub rows: the JAX package's
// order of the parts). IEEE f32 (__fmaf_rn, __fadd_rn), no TF32, no atomics.
//
// PRECISE (the precise step's pass, at alpha = 1 into zeros, once a part):
// the same sums in the same order as compensated pairs (df32.cuh,
// mul_acc_step: the exact product, then the Neumaier step), the tree adding
// pairs (pair_add), and each part's epilogue out = alpha * (s - c) + out,
// rounded once (compensated_epilogue with beta 1): a part to within about
// an ulp of itself, not a few ulp of its ~850 terms' sum.
//
// The grid is one launch: the hub rows' CTAs first, n_hub x ceil(n / TN),
// TN = 32 * VEC columns each, so that the long rows start early and do not
// set the tail; then the head jobs, 8 a CTA, a warp each. A hub CTA's 8
// warps each sum one of the 8 partial sums over the CTA's TN columns, 8
// entries' B loads in flight a warp, then add them in the fixed tree in
// shared memory, and warp 0 adds the row's head part and writes. A head warp
// covers its row in chunks of 4 x TN columns, the chunk's out loads issued
// together. VEC = 4 (16-byte loads and stores) where n % 4 == 0 and B and
// out are 16-byte aligned, else 1: any n, K7's n <= 32 too.
//
// What bounds it on the H100: the B rows the hub entries gather (one row of
// n floats an entry; the head entries' B rows are the head columns' few,
// which sit in the L2) and each touched row of out read and written once:
// on scircuit_like at N = 512, 60,374 hub entries x 2 KB = 124 MB and
// ~50,000 rows x 4 KB = 205 MB, ~0.1 ms at 3.35 TB/s, against 0.12 GFLOP.
// The design keeps every byte it moves to that: no dense plane, no (M, N)
// temporary, no row without an entry; enough loads in flight (8 B rows a
// hub warp, 4 out chunks a head warp) for the HBM's latency.

#include <cuda_runtime.h>

#include "df32.cuh"

namespace {

constexpr int kWarps = 8;               // partial sums a hub row; head jobs a CTA
constexpr int kThreads = 32 * kWarps;   // 256
constexpr int kChunks = 4;              // column chunks a head warp holds at once
constexpr int kUnroll = 8;              // hub entries a warp loads at once

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
  return make_float4(mul_add(v, x.x, a.x), mul_add(v, x.y, a.y), mul_add(v, x.z, a.z),
                     mul_add(v, x.w, a.w));
}
__device__ __forceinline__ float plus(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float4 plus(float4 a, float4 b) {
  return make_float4(plus(a.x, b.x), plus(a.y, b.y), plus(a.z, b.z), plus(a.w, b.w));
}

// (sa, ca) += (sb, cb), pairs whose values are s - c: ca' = (ca - e) + cb.
__device__ __forceinline__ void pair_add(float& sa, float& ca, float sb, float cb) {
  float t, e;
  sx_df32::two_sum(sa, sb, t, e);
  sa = t;
  ca = __fadd_rn(__fsub_rn(ca, e), cb);
}
__device__ __forceinline__ void pair_add(float4& sa, float4& ca, float4 sb, float4 cb) {
  pair_add(sa.x, ca.x, sb.x, cb.x);
  pair_add(sa.y, ca.y, sb.y, cb.y);
  pair_add(sa.z, ca.z, sb.z, cb.z);
  pair_add(sa.w, ca.w, sb.w, cb.w);
}
// out + alpha * (s - c), one rounding
__device__ __forceinline__ float pair_into(float alpha, float s, float c, float out) {
  return sx_df32::compensated_epilogue(alpha, s, c, 1.0f, out);
}
__device__ __forceinline__ float4 pair_into(float alpha, float4 s, float4 c, float4 out) {
  return make_float4(pair_into(alpha, s.x, c.x, out.x), pair_into(alpha, s.y, c.y, out.y),
                     pair_into(alpha, s.z, c.z, out.z), pair_into(alpha, s.w, c.w, out.w));
}

// A running sum: one f32 (c stays 0), or at PRECISE a compensated pair.
template <typename T, bool PRECISE>
struct Sum {
  T s, c;
  __device__ __forceinline__ void add(float v, T x) {
    if constexpr (PRECISE)
      sx_df32::mul_acc_step(v, x, s, c);
    else
      s = mul_add(v, x, s);
  }
  __device__ __forceinline__ void merge(T os, T oc) {
    if constexpr (PRECISE)
      pair_add(s, c, os, oc);
    else
      s = plus(s, os);
  }
  // out + alpha * the sum: fma(alpha, s, out), or one rounding at PRECISE
  __device__ __forceinline__ T into(float alpha, T out) const {
    if constexpr (PRECISE)
      return pair_into(alpha, s, c, out);
    else
      return mul_add(alpha, s, out);
  }
};

// Vector cv of B's row `col` (nv vectors a row).
template <typename T>
__device__ __forceinline__ T b_at(const float* b, int col, size_t nv, size_t cv) {
  return __ldg(reinterpret_cast<const T*>(b) + (size_t)col * nv + cv);
}

template <int VEC, bool PRECISE>
__global__ void __launch_bounds__(kThreads) hybrid_hub_kernel(
    const int* __restrict__ rows,    // (n_jobs,)
    const int* __restrict__ ptr,     // (n_jobs + 1,)
    const int* __restrict__ mid,     // (n_jobs,)
    const int* __restrict__ cols,    // (entries,)
    const float* __restrict__ vals,  // (entries,)
    const float* __restrict__ b,     // (k, n)
    float* __restrict__ out,         // (m, n), updated in place
    int n_jobs, int n_hub, int n, float alpha) {
  using T = typename Vec<VEC>::T;
  using S = Sum<T, PRECISE>;
  constexpr int TN = 32 * VEC;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t nv = (size_t)n / VEC;
  const int ctiles = (n + TN - 1) / TN;
  const long long hub_ctas = (long long)n_hub * ctiles;

  if ((long long)blockIdx.x < hub_ctas) {  // a hub row's TN columns
    __shared__ T parts[kWarps][32];
    __shared__ T comps[PRECISE ? kWarps : 1][32];
    const int j = blockIdx.x / ctiles;
    const size_t cv = (size_t)(blockIdx.x % ctiles) * 32 + lane;
    const bool live = cv < nv;
    const int q0 = __ldg(mid + j), q1 = __ldg(ptr + j + 1);
    S part{T{}, T{}};
    if (live) {
      int e = q0 + warp;
      for (; e + (kUnroll - 1) * kWarps < q1; e += kUnroll * kWarps) {
        int cc[kUnroll];
        float vv[kUnroll];
        T x[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          cc[u] = __ldg(cols + e + u * kWarps);
          vv[u] = __ldg(vals + e + u * kWarps);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) x[u] = b_at<T>(b, cc[u], nv, cv);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) part.add(vv[u], x[u]);
      }
      for (; e < q1; e += kWarps)
        part.add(__ldg(vals + e), b_at<T>(b, __ldg(cols + e), nv, cv));
    }
    parts[warp][lane] = part.s;
    if constexpr (PRECISE) comps[warp][lane] = part.c;
    __syncthreads();
#pragma unroll
    for (int h = kWarps / 2; h > 0; h /= 2) {
      if (warp < h) {
        if constexpr (PRECISE) {
          part.merge(parts[warp + h][lane], comps[warp + h][lane]);
          comps[warp][lane] = part.c;
        } else {
          part.merge(parts[warp + h][lane], T{});
        }
        parts[warp][lane] = part.s;
      }
      __syncthreads();
    }
    if (warp != 0 || !live) return;
    const int p0 = __ldg(ptr + j);
    T* at = reinterpret_cast<T*>(out) + (size_t)__ldg(rows + j) * nv + cv;
    T o = *at;
    if (p0 < q0) {  // the row's head part first
      S s{T{}, T{}};
      for (int e = p0; e < q0; ++e) s.add(__ldg(vals + e), b_at<T>(b, __ldg(cols + e), nv, cv));
      o = s.into(alpha, o);
    }
    if (q0 < q1) o = part.into(alpha, o);
    *at = o;
    return;
  }

  // a head job: a warp a row, its head entries only
  const long long jl = n_hub + ((long long)blockIdx.x - hub_ctas) * kWarps + warp;
  if (jl >= n_jobs) return;
  const int j = (int)jl;
  const int p0 = __ldg(ptr + j), p1 = __ldg(mid + j);
  T* row = reinterpret_cast<T*>(out) + (size_t)__ldg(rows + j) * nv;
  for (size_t c0 = lane; c0 < nv; c0 += 32 * kChunks) {
    T o[kChunks];
    S s[kChunks];
#pragma unroll
    for (int ch = 0; ch < kChunks; ++ch) {
      const size_t cv = c0 + 32 * ch;
      o[ch] = cv < nv ? row[cv] : T{};
      s[ch] = S{T{}, T{}};
    }
    for (int e = p0; e < p1; ++e) {
      const int col = __ldg(cols + e);
      const float v = __ldg(vals + e);
#pragma unroll
      for (int ch = 0; ch < kChunks; ++ch) {
        const size_t cv = c0 + 32 * ch;
        if (cv < nv) s[ch].add(v, b_at<T>(b, col, nv, cv));
      }
    }
#pragma unroll
    for (int ch = 0; ch < kChunks; ++ch) {
      const size_t cv = c0 + 32 * ch;
      if (cv < nv) row[cv] = s[ch].into(alpha, o[ch]);
    }
  }
}

template <int VEC, bool PRECISE>
cudaError_t launch(const int* rows, const int* ptr, const int* mid, const int* cols,
                   const float* vals, const float* b, float* out, int n_jobs, int n_hub, int n,
                   float alpha, int threads, int grid, cudaStream_t stream) {
  // the wrapper's map (ops/hybrid_hub.py:hub_launch) must be this kernel's
  constexpr int TN = 32 * VEC;
  const long long ctas = (long long)n_hub * ((n + TN - 1) / TN) +
                         ((long long)n_jobs - n_hub + kWarps - 1) / kWarps;
  if (threads != kThreads || ctas != grid || n < 1 || n_hub < 0 || n_hub > n_jobs ||
      (VEC == 4 && n % 4))
    return cudaErrorInvalidValue;
  hybrid_hub_kernel<VEC, PRECISE><<<grid, kThreads, 0, stream>>>(rows, ptr, mid, cols, vals, b, out,
                                                        n_jobs, n_hub, n, alpha);
  return cudaGetLastError();
}

}  // namespace

extern "C" int hybrid_hub_launch(const void* rows, const void* ptr, const void* mid,
                                 const void* cols, const void* vals, const void* b, void* out,
                                 int n_jobs, int n_hub, int n, float alpha, int vec,
                                 int precise, int threads, int grid, void* stream) {
#define SX_HUB(V, P)                                                                      \
  launch<V, P>((const int*)rows, (const int*)ptr, (const int*)mid, (const int*)cols,       \
               (const float*)vals, (const float*)b, (float*)out, n_jobs, n_hub, n, alpha,  \
               threads, grid, (cudaStream_t)stream)
  switch (vec * 2 + (precise != 0)) {
    case 2: return SX_HUB(1, false);
    case 3: return SX_HUB(1, true);
    case 8: return SX_HUB(4, false);
    case 9: return SX_HUB(4, true);
    default: return cudaErrorInvalidValue;
  }
#undef SX_HUB
}
