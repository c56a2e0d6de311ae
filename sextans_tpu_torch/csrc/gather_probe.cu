// gather_probe: the random-row gather out[i] = sum_r vals[i, r] * B[cols[i, r]]
// by two issue paths each, the rate that bounds the ELL engine K5.
//
// Replaces: the TPU probes P1 and P2.
//   P1, benchmarks/scratch/dma_gather_probe.py, gather_spmm_kernel /
//   gather_spmm: every slot multiplied. The TPU fetched, per 8-row group and
//   slot, the aligned (8, N) band of B holding each row by DMA,
//   double-buffered across groups, and pulled the row out with a one-hot
//   sublane mask. Here, dma_gather_launch, two staging modes:
//     direct (STAGING 0): K5's thread map (spmm_ell.cu). One group of `lanes`
//       threads per output row reads its R rows of B straight from device
//       memory, 16-byte __ldg loads when N % 4 == 0 and every pointer is
//       16-byte aligned (VEC 4), else 4-byte loads (VEC 1).
//     async (STAGING 1): each CTA owns `block` output rows (the TPU's
//       block, 256 or 1024) and walks them in groups of `group` rows. Every
//       thread of the CTA issues cp.async copies of 16 bytes for the group's
//       group * R rows of B into one stage of a two-stage ring in shared
//       memory, one commit group per row group; the next group's copies are
//       in flight while the current one is summed (cp.async.wait_group 1), as
//       the TPU kernel double-buffers its band DMAs. VEC 4 only: the caller
//       refuses another N or an unaligned pointer, and sizes `group` so that
//       both stages fit the shared memory of one CTA.
//   P2, benchmarks/scratch/ell_issue_probe.py, make_kernel / run_variant: the
//   same sum, except that a slot whose value is 0 adds exactly 0, whatever its
//   row of B holds. Its four TPU variants A-D differ in the issue path of
//   the chunk DMAs. Here, ell_issue_launch, two variants on K5's thread map:
//     skip (SELECT 0): a branch over each value-0 slot, which issues no load
//       (TPU variant A; K5 today).
//     select (SELECT 1): a value-0 slot loads row 0 unconditionally and its
//       product is selected out (v != 0 ? v * x : 0), never multiplied by 0
//       (TPU variants B-D, whose pads fetch chunk 0). The loads of both
//       variants are volatile, so the compiler cannot sink select's into a
//       branch.
//   The semaphore granularity of B-D (one wait per copy, per slot octet, per
//   group) has no counterpart on a direct-load path; its Hopper analogue is
//   single-row cp.async.bulk copies signalling one mbarrier each or one with
//   the summed expect_tx (ROADMAP.md).
//
// Arithmetic: acc = 0, then for r = 0 .. R-1 in order
// acc = __fadd_rn(acc, __fmul_rn(v, x)): the product and the sum rounded
// apart, as the TPU kernels round them (acc + w * row). No FFMA (the
// intrinsics cannot be contracted) and no TF32. Every mode and variant takes
// the same roundings in the same order, so each equals the plain PyTorch
// loop (probes/dma_gather.py, probes/ell_issue.py) to the bit; acc starts at
// +0, so it is never -0, and adding a selected-out +0 leaves it as skipping
// does.
//
// What bounds them on the H100: bytes. The least traffic is 8 * M * R +
// 4 * N * U + 4 * M * N bytes (U: distinct rows of B touched) against
// 2 * M * R * N flops; at the probes' sweep shape (K = 400,000, M = 262,144,
// R = 4, N = 512: B 819 MB, 16x the L2) ~0.39 ms at 3.35 TB/s against 0.016
// ms at 67 TFLOP/s. A gather of random rows misses the L2 and moves R rows of
// N floats per output row; what the probe measures is how close each issue
// path comes to that.

#include <cuda_runtime.h>

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

// acc + v * x, the product and the sum each rounded once
__device__ __forceinline__ float mul_add_apart(float v, float x, float acc) {
  return __fadd_rn(acc, __fmul_rn(v, x));
}
__device__ __forceinline__ float4 mul_add_apart(float v, float4 x, float4 acc) {
  return make_float4(mul_add_apart(v, x.x, acc.x), mul_add_apart(v, x.y, acc.y),
                     mul_add_apart(v, x.z, acc.z), mul_add_apart(v, x.w, acc.w));
}
// acc + (v != 0 ? v * x : 0), the product selected out, never multiplied by 0
__device__ __forceinline__ float add_selected(bool live, float v, float x, float acc) {
  return __fadd_rn(acc, live ? __fmul_rn(v, x) : 0.f);
}
__device__ __forceinline__ float4 add_selected(bool live, float v, float4 x, float4 acc) {
  return make_float4(add_selected(live, v, x.x, acc.x), add_selected(live, v, x.y, acc.y),
                     add_selected(live, v, x.z, acc.z), add_selected(live, v, x.w, acc.w));
}

// A read-only load that the compiler must issue where it stands.
__device__ __forceinline__ float load_issued(const float* p) {
  float x;
  asm volatile("ld.global.nc.f32 %0, [%1];" : "=f"(x) : "l"(p));
  return x;
}
__device__ __forceinline__ float4 load_issued(const float4* p) {
  float4 x;
  asm volatile("ld.global.nc.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(x.x), "=f"(x.y), "=f"(x.z), "=f"(x.w)
               : "l"(p));
  return x;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

// Lanes per row (log2): the power of two >= N / VEC, at most 32.
int lanes_log2_for(int nv) {
  int l = 0;
  while ((1 << l) < nv && l < 5) ++l;
  return l;
}

constexpr int kThreads = 256;

// P1, direct: one group of `lanes` threads per output row.
template <int VEC>
__global__ void gather_direct_kernel(const int* __restrict__ cols,    // (m, R)
                                     const float* __restrict__ vals,  // (m, R)
                                     const float* __restrict__ b,     // (k, n)
                                     float* __restrict__ out,         // (m, n)
                                     int m, int r_slots, int n, int lanes_log2) {
  using T = typename Vec<VEC>::T;
  const size_t tid = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t row = tid >> lanes_log2;
  if (row >= (size_t)m) return;
  const int lanes = 1 << lanes_log2;
  const int lane = (int)(tid & (lanes - 1));
  const int* crow = cols + row * r_slots;
  const float* vrow = vals + row * r_slots;
  const size_t nv = (size_t)n / VEC;
  const T* bv = reinterpret_cast<const T*>(b);
  for (size_t cv = lane; cv < nv; cv += lanes) {
    T acc{};
#pragma unroll 4
    for (int r = 0; r < r_slots; ++r) {
      const T x = __ldg(bv + (size_t)__ldg(crow + r) * nv + cv);
      acc = mul_add_apart(__ldg(vrow + r), x, acc);
    }
    reinterpret_cast<T*>(out)[row * nv + cv] = acc;
  }
}

// P1, async: `block` rows per CTA in groups of `group` rows, each group's
// rows of B staged by cp.async into a two-stage ring.
__global__ void gather_async_kernel(const int* __restrict__ cols, const float* __restrict__ vals,
                                    const float* __restrict__ b, float* __restrict__ out,
                                    int m, int r_slots, int n, int block, int group) {
  extern __shared__ float4 stage[];  // [2][group * R * nv]
  const int nv = n / 4;
  const size_t row0 = (size_t)blockIdx.x * block;
  const size_t left = (size_t)m - row0;
  const int rows = left < (size_t)block ? (int)left : block;
  const int n_groups = (rows + group - 1) / group;
  const size_t stage_len = (size_t)group * r_slots * nv;
  const float4* bv = reinterpret_cast<const float4*>(b);
  float4* ov = reinterpret_cast<float4*>(out);

  // copies of row group g: piece p is float4 cv of slot s = (row in group) * R + r
  auto issue = [&](int g) {
    float4* dst = stage + (size_t)(g & 1) * stage_len;
    const size_t grow0 = row0 + (size_t)g * group;
    const int pieces = min(group, rows - g * group) * r_slots * nv;
    const int* gcols = cols + grow0 * r_slots;
    for (int p = threadIdx.x; p < pieces; p += blockDim.x) {
      const int s = p / nv;
      const int cv = p - s * nv;
      cp_async16(dst + p, bv + (size_t)__ldg(gcols + s) * nv + cv);
    }
  };

  issue(0);
  cp_async_commit();
  for (int g = 0; g < n_groups; ++g) {
    if (g + 1 < n_groups) issue(g + 1);
    cp_async_commit();  // one group per iteration, empty at the last
    cp_async_wait_all_but_one();
    __syncthreads();  // row group g is in stage g & 1, for every thread
    const float4* src = stage + (size_t)(g & 1) * stage_len;
    const size_t grow0 = row0 + (size_t)g * group;
    const int items = min(group, rows - g * group) * nv;
    for (int q = threadIdx.x; q < items; q += blockDim.x) {
      const int gr = q / nv;
      const int cv = q - gr * nv;
      const float* vrow = vals + (grow0 + gr) * r_slots;
      float4 acc{};
      for (int r = 0; r < r_slots; ++r)
        acc = mul_add_apart(__ldg(vrow + r), src[(size_t)(gr * r_slots + r) * nv + cv], acc);
      ov[(grow0 + gr) * nv + cv] = acc;
    }
    __syncthreads();  // stage g & 1 is read out before group g + 2 refills it
  }
}

// P2: skip (SELECT false) or select (SELECT true) over value-0 slots.
template <int VEC, bool SELECT>
__global__ void ell_issue_kernel(const float* __restrict__ vals, const int* __restrict__ cols,
                                 const float* __restrict__ b, float* __restrict__ out, int m,
                                 int r_slots, int n, int lanes_log2) {
  using T = typename Vec<VEC>::T;
  const size_t tid = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t row = tid >> lanes_log2;
  if (row >= (size_t)m) return;
  const int lanes = 1 << lanes_log2;
  const int lane = (int)(tid & (lanes - 1));
  const int* crow = cols + row * r_slots;
  const float* vrow = vals + row * r_slots;
  const size_t nv = (size_t)n / VEC;
  const T* bv = reinterpret_cast<const T*>(b);
  for (size_t cv = lane; cv < nv; cv += lanes) {
    T acc{};
#pragma unroll 4
    for (int r = 0; r < r_slots; ++r) {
      const float v = __ldg(vrow + r);
      const bool live = v != 0.f;
      if constexpr (SELECT) {
        const int col = live ? __ldg(crow + r) : 0;
        acc = add_selected(live, v, load_issued(bv + (size_t)col * nv + cv), acc);
      } else if (live) {
        acc = mul_add_apart(v, load_issued(bv + (size_t)__ldg(crow + r) * nv + cv), acc);
      }
    }
    reinterpret_cast<T*>(out)[row * nv + cv] = acc;
  }
}

// Blocks of kThreads threads for m rows of 2^lanes_log2 threads each.
cudaError_t grid_for(int m, int lanes_log2, unsigned* blocks) {
  const size_t total = (size_t)m << lanes_log2;
  const size_t n_blocks = (total + kThreads - 1) / kThreads;
  if (n_blocks == 0 || n_blocks > 0x7fffffff) return cudaErrorInvalidValue;
  *blocks = (unsigned)n_blocks;
  return cudaSuccess;
}

template <int VEC>
cudaError_t launch_direct(const int* cols, const float* vals, const float* b, float* out, int m,
                          int r_slots, int n, cudaStream_t stream) {
  const int ll = lanes_log2_for(n / VEC);
  unsigned blocks;
  cudaError_t err = grid_for(m, ll, &blocks);
  if (err != cudaSuccess) return err;
  gather_direct_kernel<VEC><<<blocks, kThreads, 0, stream>>>(cols, vals, b, out, m, r_slots, n,
                                                             ll);
  return cudaGetLastError();
}

cudaError_t launch_async(const int* cols, const float* vals, const float* b, float* out, int m,
                         int r_slots, int n, int block, int group, cudaStream_t stream) {
  if (n % 4 || block < 1 || group < 1 || group > block) return cudaErrorInvalidValue;
  const size_t smem = 2 * (size_t)group * r_slots * n * sizeof(float);
  if (smem > 0x7fffffff) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      gather_async_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const unsigned blocks = (unsigned)(((size_t)m + block - 1) / block);
  gather_async_kernel<<<blocks, kThreads, smem, stream>>>(cols, vals, b, out, m, r_slots, n,
                                                          block, group);
  return cudaGetLastError();
}

template <int VEC, bool SELECT>
cudaError_t launch_issue(const float* vals, const int* cols, const float* b, float* out, int m,
                         int r_slots, int n, cudaStream_t stream) {
  const int ll = lanes_log2_for(n / VEC);
  unsigned blocks;
  cudaError_t err = grid_for(m, ll, &blocks);
  if (err != cudaSuccess) return err;
  ell_issue_kernel<VEC, SELECT><<<blocks, kThreads, 0, stream>>>(vals, cols, b, out, m,
                                                                 r_slots, n, ll);
  return cudaGetLastError();
}

}  // namespace

// staging 0 direct (vec 1 or 4), 1 async (vec 4; block rows per CTA in
// groups of `group` rows).
extern "C" int dma_gather_launch(const void* cols, const void* vals, const void* b, void* out,
                                 int m, int r_slots, int n, int staging, int vec, int block,
                                 int group, void* stream) {
#define SX_ARGS \
  (const int*)cols, (const float*)vals, (const float*)b, (float*)out, m, r_slots, n
  if (m < 1 || r_slots < 1 || n < 1) return cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (staging == 0 && vec == 1) return launch_direct<1>(SX_ARGS, s);
  if (staging == 0 && vec == 4) return launch_direct<4>(SX_ARGS, s);
  if (staging == 1 && vec == 4) return launch_async(SX_ARGS, block, group, s);
  return cudaErrorInvalidValue;
#undef SX_ARGS
}

// variant 0 skip, 1 select; vec 1 or 4.
extern "C" int ell_issue_launch(const void* vals, const void* cols, const void* b, void* out,
                                int m, int r_slots, int n, int variant, int vec, void* stream) {
#define SX_ARGS \
  (const float*)vals, (const int*)cols, (const float*)b, (float*)out, m, r_slots, n, \
      (cudaStream_t)stream
  if (m < 1 || r_slots < 1 || n < 1) return cudaErrorInvalidValue;
  switch (vec * 2 + variant) {
    case 2: return launch_issue<1, false>(SX_ARGS);
    case 3: return launch_issue<1, true>(SX_ARGS);
    case 8: return launch_issue<4, false>(SX_ARGS);
    case 9: return launch_issue<4, true>(SX_ARGS);
    default: return cudaErrorInvalidValue;
  }
#undef SX_ARGS
}
