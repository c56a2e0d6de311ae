// spmm_slab / spmm_slab_skinny: C = alpha * A @ B + beta * C over the
// block_k x 128 dense-slab pack (format/pack_mxu.py).
//
// Replaces: sextans_tpu/ops/spmm_mxu_pallas.py — spmm_mxu_padded / _kernel
// (K1) with spmm_slab_launch, and spmm_mxu_ct_padded / _kernel_ct (K2) with
// spmm_slab_skinny_launch. On the TPU one grid step contracted a block on the
// matrix unit into a (tile_m/128, 128, tile_n) VMEM accumulator carried
// across the M-tile's groups. Here both kernels visit only their slab's own
// blocks, in pack order (the host scan slab_visits: slab_ptr / slab_blocks,
// and slab_rows, the B row where each block's terms start), and stream them
// through a ring in shared memory, one mbarrier a stage. A slab that gets no
// block still writes beta * C.
//
// The ragged edges are the kernels' own: B holds k_rows rows and C and out
// m_rows rows (SpmmPlan's call hands them the caller's K and M,
// ops/spmm_slab.py:slab_in_place; a padded caller k_padded and m_padded). A
// B row at or past k_rows lands in shared memory as +0.0, by a cp.async that
// copies 0 bytes and fills the rest with zeros, which are the bits a padded
// B's zero rows gave; no row at or past m_rows is read from C or written, and
// a CTA whose rows all lie there returns at once. K1 on the tensor cores
// checks only in its edge slabs (ops/spmm_slab.py:slab_edges), whose CTAs are
// a grid of their own, spmm_slab_tc_kernel_edge, launched first; the other
// CTAs' grid, spmm_slab_tc_kernel, starts beside it (programmatic dependent
// launch) and runs the mainloop with no check. On an H100 the same checks in
// every CTA of one kernel, or a branch to them, made K1 3-14 % slower on the
// cant stand-in: ptxas schedules K1's mainloop at 252-255 registers, and any
// more code in the kernel moved it (PERF.md).
//
// Layout: vals[g, i*bk + kk, mm] = A[slab row mm, window col bcol + kk], so a
// block is a (bk, 128) row-major tile; the global B row of kk is
// group_kwin[g] * window_k + bcol[g, i] + kk. Pad slots hold zeros with
// qm = bcol = 0 and add 0 * B[window start]; they are not skipped.
//
// K1 in plain mode contracts on the tensor cores in 3xTF32 (wgmma
// m64n64k8 .tf32 from sm_90a; plain TF32 is not used): x = hi + lo with
// hi = tf32(x) and lo = tf32(x - hi) (cvt.rna: to nearest, ties away), and
// each 8-term step is hi.hi + hi.lo + lo.hi, the small products first, with
// f32 accumulation in the tensor cores (exact products; the sum of a step is
// not rounded to nearest). For .tf32 both operands in shared memory must be
// K-major, and neither the pack's values (M-major) nor B (N-major) is, so
// the roles turn: the wgmma's A operand is the chunk's B rows, read from
// shared memory into registers by each thread (the register fragment takes
// any layout) and split there, and its B operand is the values' hi and lo
// tiles, made K-major once at upload (ops/spmm_slab.py: slab_image) and
// copied by one TMA bulk copy a stage. The product is C^T's tile; the
// epilogue writes it into C's rows. Per block, each step's sum goes into
// fresh registers f, f into the block's sum cf (round to nearest), cf into
// acc after the block's last step; blocks in pack order; epilogue
// fma(alpha, acc, beta * C) (alpha * acc without C). Compared with the FFMA chain, a
// sum differs by the rounding of products and steps: on the shapes
// chip_smoke.py runs, within 4 ulp of max|C| of the plain version and
// closer to the f64 oracle than it; on rows of thousands of terms the two
// differ by more, each about as far from f64 (tests/test_torch_gpu.py).
//
// Its tiles: a stage holds 32 terms (a chunk) of a block, so that four fit
// beside each other; a CTA takes a whole slab by 128 columns (two
// warpgroups) where those CTAs still fill the card four times over, else
// half a slab by 64 columns (one warpgroup, two CTAs an SM), so that few
// busy slabs still spread over the card (ops/spmm_slab.py: slab_launch).
// The column tiles of a slab are adjacent in the grid, so the 2nd and later
// reads of a block's tiles come from L2.
//
// Its mainloop keeps the tensor cores busy. A group of wgmmas is one 8-term
// step on one half slab: its three products, into one of two sets of sum
// registers in turn (a whole-slab CTA's two half slabs take one set each).
// After issuing group u a warpgroup waits only for group u - 1
// (wgmma.wait_group 1) and adds its sums into cf while u runs; the next
// step's A fragment goes into the other of two fragment sets, as u may
// still read its own. A chunk's groups are unrolled (the kernel is
// instantiated by steps a chunk, 1, 2 or 4), so every set is named at
// compile time, and the last group is waited for at the chunk's end: ptxas
// serialises the wgmmas (its notes C7514, C7515) where a wgmma may still run
// across the loop's back edge or a branch while other instructions read or
// write sum registers. A stage is released without a CTA-wide barrier:
// each warpgroup, once its wgmmas on a chunk have completed, refills its
// own B rows of the stage and counts itself out on the stage's counter;
// the last warpgroup out copies the next chunk's tiles in. So one
// warpgroup's wait does not stall the other. (Adding each step straight
// into acc, with no block sum, would free the registers for a single
// m64n128k8 a step over a whole slab, but on rows of 2,600 terms it left
// 12.4 ulp of max|C| against f64 where the plain version leaves 4.1.)
//
// What bounds K1 on the H100: at the slab format's low fill (3.8 % on the
// cant stand-in of the benchmark, 6,480 blocks) most of a block's 2 * bk *
// 128 * n flops multiply zeros: 108.7 GFLOP at N = 512 there, three
// tensor-core products a term, 0.66 ms at 495 TFLOP/s (1.6 ms on FFMA at
// 67 TFLOP/s). Next to it, L2: the tiles (hi and lo, 8 bytes a value) and
// the B rows are read from L2 once per column tile, 48 KB a chunk for the
// 1,536 tensor-core cycles of a whole-slab CTA's chunk.
//
// Precise mode (SpmmConfig.precise >= 1; spmm_mxu_pallas.py:89-98, 113-121
// for K1, :339-344, :356-363 for K2) keeps the FFMA chain, for both K1 and
// K2: per block, contrib = sum_kk vals[kk, mm] * B[row kk, col] in kk order
// with IEEE f32 FFMA, a Neumaier step acc_step(acc, comp, contrib) after
// every 8 terms (bk / 8 steps a block), and compensated_epilogue (df32.cuh),
// one final rounding. The TPU's matrix unit contracts a whole block at once
// and steps once per block visit; one step per visit of a bk = 128 block
// left 1.56 ulp of max|C| on cant_like at N = 512 on an H100, against 1.64
// in plain mode. 3xTF32 steps into (acc, comp) missed the slab precise bar
// of 1.5 ulp (PERF.md). The TPU slab kernels have no level-2 branch, so
// level 2 runs level 1. K1's FFMA kernel takes half a slab by 64 columns.

#include <cuda_runtime.h>

#include "async_copy.cuh"
#include "df32.cuh"

namespace {

constexpr int MSLAB = 128;
constexpr int kSlabRows = 64;  // rows of a half slab; K2 takes one a CTA
constexpr int kStages = 2;     // K2: blocks in flight a CTA
constexpr int kChunk = 32;     // K1: terms of a block a stage (block_k if fewer)
constexpr int kStagesK1 = 4;   // K1: chunks in flight a CTA
constexpr int kTileN = 64;     // K1: columns a warpgroup
constexpr int kBPad = 8;       // K1: floats past a B row's columns in a stage
constexpr int kWarpgroup = 128;

// ---- K1: what both contractions share ----

// The B rows of a chunk (rows of n floats from bsrc) at columns n0 .. n0 +
// tn - 1 into a stage, row stride tn + kBPad; columns at or past n are not
// copied (their products land in columns that are not written).
__device__ __forceinline__ void copy_b_chunk(float* bs, const float* bsrc, int rows, int n,
                                             int n0, int tn, int b_vec, int tid, int threads) {
  const int stride = tn + kBPad;
  if (b_vec) {
    for (int e = tid; e < rows * (tn / 4); e += threads) {
      const int kk = e / (tn / 4), q4 = 4 * (e % (tn / 4));
      if (n0 + q4 < n) sx_async::cp_async16(bs + kk * stride + q4, bsrc + (size_t)kk * n + q4);
    }
  } else {
    for (int e = tid; e < rows * tn; e += threads) {
      const int kk = e / tn, col = e % tn;
      if (n0 + col < n) sx_async::cp_async4(bs + kk * stride + col, bsrc + (size_t)kk * n + col);
    }
  }
}

// The same, the rows at or past `valid` (B's end) as zeros, read from
// nowhere (b, B's start, only names an address).
__device__ __forceinline__ void copy_b_chunk_zfill(float* bs, const float* bsrc, const float* b,
                                                   int rows, int valid, int n, int n0, int tn,
                                                   int b_vec, int tid, int threads) {
  const int stride = tn + kBPad;
  if (b_vec) {
    for (int e = tid; e < rows * (tn / 4); e += threads) {
      const int kk = e / (tn / 4), q4 = 4 * (e % (tn / 4));
      const bool in = kk < valid;
      if (n0 + q4 < n)
        sx_async::cp_async16_zfill(bs + kk * stride + q4, in ? bsrc + (size_t)kk * n + q4 : b,
                                   in ? 16u : 0u);
    }
  } else {
    for (int e = tid; e < rows * tn; e += threads) {
      const int kk = e / tn, col = e % tn;
      const bool in = kk < valid;
      if (n0 + col < n)
        sx_async::cp_async4_zfill(bs + kk * stride + col, in ? bsrc + (size_t)kk * n + col : b,
                                  in ? 4u : 0u);
    }
  }
}

// The rows of B's `rows` from `row0` on that lie below k_rows.
__device__ __forceinline__ int rows_below(int k_rows, int row0, int rows) {
  return max(0, min(rows, k_rows - row0));
}

// ---- K1 on the tensor cores: wgmma m64n64k8 .tf32, 3xTF32 ----

__device__ __forceinline__ uint32_t to_tf32(float x) {  // round to nearest, ties away
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// The shared-memory descriptor of a K-major operand without swizzle: 8 x 16-byte
// core matrices, the two of a k8 step `lbo` bytes apart, the 8-row groups
// `sbo` bytes apart.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((sx_async::smem_addr(p) & 0x3FFFF) >> 4) |
         (uint64_t)((lbo >> 4) & 0x3FFF) << 16 | (uint64_t)((sbo >> 4) & 0x3FFF) << 32;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// Wait until at most N committed groups are still running.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// The threads of one warpgroup (named barrier 1 + wg; 0 is __syncthreads).
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, %1;" ::"r"(1 + wg), "n"(kWarpgroup) : "memory");
}

// d (+)= a . b: a the 64 x 8 tile in registers (its tf32 fragment), b the
// 8 x 64 tile behind `desc`; d is overwritten when scale_d is 0.
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], const uint32_t (&a)[4],
                                           uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// Ties the compiler's reads and writes of r to this point (as CUTLASS's
// warpgroup_fence_operand): sums read after a wait stay after it, and none
// moves past the next wgmma on r.
__device__ __forceinline__ void fence_regs(float (&r)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// H half slabs (64 H rows) by 64 W columns a CTA, W warpgroups (blockDim.x
// = 128 W), warpgroup wg on columns 64 wg ..; H is 1 or 2. A stage holds
// the chunk's hi and lo tiles for the CTA's half slabs as slab_image lays
// them out, then each warpgroup's B rows at its own columns, row stride
// kTileN + kBPad. EDGE (spmm_slab_tc_kernel_edge): the CTA copies B with
// zfill and checks each output row, and `cta` is its place in
// spmm_slab_tc_kernel's grid; without it (spmm_slab_tc_kernel) it does
// neither and is that grid's CTA blockIdx.x.
template <int H, int NKS, bool EDGE>
__device__ __forceinline__ void tc_cta(
    int cta, const float* __restrict__ image, const int* __restrict__ slab_ptr,
    const int* __restrict__ slab_blocks, const int* __restrict__ slab_rows,
    const float* __restrict__ b, const float* __restrict__ c, float* __restrict__ out, int n,
    int m_rows, int k_rows, int block_k, float alpha, float beta, int with_c, int b_vec) {
  extern __shared__ float4 smem4[];
  constexpr int kStep = 8 * kSlabRows;  // floats of a half slab's tile a step
  const int wgs = blockDim.x / kWarpgroup, tn = wgs * kTileN;
  const int ch = 8 * NKS, nch = block_k / ch;  // NKS = min(kChunk, block_k) / 8
  const int half_img = 2 * kSlabRows * ch;  // floats of a half slab's chunk, hi and lo
  const int b_rows = ch * (kTileN + kBPad);  // floats of a warpgroup's B rows
  const int stage = H * half_img + wgs * b_rows;  // floats a stage
  float* ring = reinterpret_cast<float*>(smem4);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStagesK1 * stage);
  int* freed = reinterpret_cast<int*>(full + kStagesK1);  // warpgroups out of a stage
  const int n_ctiles = (n + tn - 1) / tn;
  // the CTA's half slab (H = 1) or slab (H = 2)
  const int hs = (EDGE ? cta : blockIdx.x) / n_ctiles;
  const int slab = hs * H / 2, half0 = hs * H % 2;
  const int tid = threadIdx.x;
  const int wg = tid / kWarpgroup, w = (tid % kWarpgroup) / 32, g = (tid % 32) / 4,
            t = tid % 4;
  // the warpgroup's columns
  const int n0 = ((EDGE ? cta : blockIdx.x) % n_ctiles) * tn + kTileN * wg;
  const int p0 = slab_ptr[slab];
  const int nblk = slab_ptr[slab + 1] - p0;
  const int items = nblk * nch;  // (block, chunk) in pack order

  if (tid == 0) {
    for (int s = 0; s < kStagesK1; ++s) {
      sx_async::mbar_init(&full[s], blockDim.x + 1);
      freed[s] = 0;
    }
    sx_async::mbar_fence_init();
  }
  __syncthreads();

  // Chunk q's copies into its stage (every thread, q ascending): this
  // warpgroup's B rows, and with `tiles` the hi and lo tiles (one bulk
  // copy). The block of the chunk and the next block's are read a block
  // ahead.
  int cur = -1, blk = 0, row = 0;
  int nxt_blk = nblk ? slab_blocks[p0] : 0, nxt_row = nblk ? slab_rows[p0] : 0;
  auto issue = [&](int q, bool tiles) {
    if (q / nch != cur) {
      cur = q / nch;
      blk = nxt_blk;
      row = nxt_row;
      if (cur + 1 < nblk) {
        nxt_blk = slab_blocks[p0 + cur + 1];
        nxt_row = slab_rows[p0 + cur + 1];
      }
    }
    const int cidx = q % nch;
    float* img = ring + (q % kStagesK1) * stage;
    uint64_t* bar = &full[q % kStagesK1];
    if (tiles) {
      const uint32_t bytes = 4u * H * half_img;
      sx_async::mbar_arrive_expect_tx(bar, bytes);
      sx_async::bulk_copy(img, image + (((size_t)blk * nch + cidx) * 2 + half0) * half_img,
                          bytes, bar);
    }
    float* bs = img + H * half_img + wg * b_rows;
    const float* bsrc = b + ((size_t)row + (size_t)cidx * ch) * n + n0;
    if constexpr (EDGE)
      copy_b_chunk_zfill(bs, bsrc, b, ch, rows_below(k_rows, row + cidx * ch, ch), n, n0,
                         kTileN, b_vec, tid % kWarpgroup, kWarpgroup);
    else
      copy_b_chunk(bs, bsrc, ch, n, n0, kTileN, b_vec, tid % kWarpgroup, kWarpgroup);
    sx_async::cp_async_arrive(bar);
  };
  for (int q = 0; q < items && q < kStagesK1; ++q) issue(q, tid == 0);

  // This warpgroup is done with chunk q: refill its stage with chunk q +
  // kStagesK1, the tiles by the last warpgroup out.
  auto release = [&](int q) {
    if (q + kStagesK1 >= items) return;
    warpgroup_sync(wg);  // every warp's wgmmas and loads on the stage are done
    bool last = false;
    if (tid % kWarpgroup == 0) {
      __threadfence_block();
      last = atomicAdd(&freed[q % kStagesK1], 1) % wgs == wgs - 1;
      __threadfence_block();
    }
    issue(q + kStagesK1, last);
  };

  // Per half slab h: acc[h] the slab's sum, cf[h] the block's; f[0], f[1]
  // the two sets a group's products go into, and hi[0 or 1], lo[...] the
  // two sets of a step's A fragment.
  float acc[H][32], cf[H][32], f[2][32];
  uint32_t hi[2][4], lo[2][4];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
#pragma unroll
    for (int h = 0; h < H; ++h) acc[h][i] = cf[h][i] = 0.f;
    f[0][i] = f[1][i] = 0.f;
  }

  // A group is step ks of a chunk on half slab h: its three products into
  // fu, the small ones first, then hi . hi. The step's first group loads and
  // splits the step's A fragment: the chunk's B rows transposed, rows are
  // columns 16 w + g (+ 8) of the warpgroup's.
  auto mma = [&](float (&fu)[32], uint32_t (&hu)[4], uint32_t (&lu)[4], const float* img,
                 int ks, int h, bool first) {
    if (first) {
      const float* brow = img + H * half_img + wg * b_rows + (8 * ks + t) * (kTileN + kBPad) +
                          16 * w + g;
      const float x[4] = {brow[0], brow[8], brow[4 * (kTileN + kBPad)],
                          brow[4 * (kTileN + kBPad) + 8]};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        hu[i] = to_tf32(x[i]);
        lu[i] = to_tf32(__fsub_rn(x[i], __uint_as_float(hu[i])));
      }
    }
    const float* vh = img + h * half_img + ks * kStep;  // the half slab's hi tile
    const uint64_t dh = smem_desc(vh, 128, 256);
    const uint64_t dl = smem_desc(vh + NKS * kStep, 128, 256);
    fence_regs(fu);
    wgmma_fence();
    wgmma_tf32(fu, lu, dh, 0);
    wgmma_tf32(fu, hu, dl, 1);
    wgmma_tf32(fu, hu, dh, 1);
    wgmma_commit();
  };
  // A group's sums, complete in fu, go into its half's block sum, that into
  // acc after the block's last step.
  auto retire = [&](float (&fu)[32], float (&cfh)[32], float (&acch)[32], bool block_end) {
    fence_regs(fu);
#pragma unroll
    for (int i = 0; i < 32; ++i) cfh[i] += fu[i];
    if (block_end) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        acch[i] += cfh[i];
        cfh[i] = 0.f;
      }
    }
  };

  // A chunk's NKS * H groups in turn: issue group u, wait for group u - 1
  // only and add it up while u runs; every register set is named at
  // compile time, and no wgmma runs past the chunk's end.
  for (int q = 0; q < items; ++q) {
    const float* img = ring + (q % kStagesK1) * stage;
    sx_async::mbar_wait(&full[q % kStagesK1], (q / kStagesK1) & 1);
    const bool block_end = q % nch == nch - 1;
#pragma unroll
    for (int u = 0; u <= NKS * H; ++u) {
      if (u < NKS * H) mma(f[u % 2], hi[u / H % 2], lo[u / H % 2], img, u / H, u % H, u % H == 0);
      if (u > 0) {
        if (u < NKS * H)
          wgmma_wait<1>();
        else
          wgmma_wait<0>();
        retire(f[(u - 1) % 2], cf[(u - 1) % H], acc[(u - 1) % H],
               block_end && (u - 1) / H == NKS - 1);
      }
    }
    release(q);
  }

  // acc[h][4 i + e] is C[row, col]: row 8 i + 2 t + e % 2 of half slab
  // half0 + h, column 16 w + g + 8 (e / 2) of the warpgroup's
#pragma unroll
  for (int h = 0; h < H; ++h) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int col = n0 + 16 * w + g + 8 * ((i % 4) / 2);
      if (col < n) {
        const size_t r = (size_t)slab * MSLAB + (half0 + h) * kSlabRows + 8 * (i / 4) +
                         2 * t + i % 2;
        if (EDGE && r >= (size_t)m_rows) continue;
        const size_t idx = r * n + col;
        out[idx] = with_c ? __fmaf_rn(alpha, acc[h][i], __fmul_rn(beta, c[idx]))
                          : __fmul_rn(alpha, acc[h][i]);
      }
    }
  }
}

// Whether ascending list[0 .. count) holds x.
__device__ __forceinline__ bool listed(const int* __restrict__ list, int count, int x) {
  int lo = 0, hi = count;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (list[mid] < x)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo < count && list[lo] == x;
}

// Programmatic dependent launch (sm_90): let the grid launched after this
// one start, or wait until the grid launched before this one has completed
// and its writes are visible (at once where none was).
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}
__device__ __forceinline__ void wait_prerequisite() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// K1 over every slab but the edge slabs (`edges`, ascending, n_edges of
// them: slab_edges in ops/spmm_slab.py), which spmm_slab_tc_kernel_edge
// takes. That grid runs first and lets this one start at once; this one's
// last CTA waits for it, so that the product is whole when this grid is.
template <int H, int NKS>
__global__ void __launch_bounds__(2 * kWarpgroup, 1) spmm_slab_tc_kernel(
    const float* __restrict__ image,       // slab_image: (ng * G, chunks, 2, 2, ch / 8, 512)
    const int* __restrict__ slab_ptr,      // (n_slabs + 1,)
    const int* __restrict__ slab_blocks,   // (ng * G,) flat block indices
    const int* __restrict__ slab_rows,     // (ng * G,) each block's first B row
    const float* __restrict__ b,           // (k_rows, n)
    const float* __restrict__ c,           // (m_rows, n) or null
    float* __restrict__ out,               // (m_rows, n)
    int n, int m_rows, int k_rows, int block_k, float alpha, float beta, int with_c,
    int b_vec, const int* __restrict__ edges, int n_edges) {
  if (blockIdx.x == gridDim.x - 1) wait_prerequisite();
  const int tn = blockDim.x / kWarpgroup * kTileN;
  if (listed(edges, n_edges, blockIdx.x / ((n + tn - 1) / tn) * H / 2)) return;
  tc_cta<H, NKS, false>(blockIdx.x, image, slab_ptr, slab_blocks, slab_rows, b, c, out, n,
                        m_rows, k_rows, block_k, alpha, beta, with_c, b_vec);
}

// K1 over the CTAs of the edge slabs: those that hold a row at or past
// m_rows or a block whose rows pass k_rows. CTA i takes the (i % per)-th CTA
// of slab edges[i / per], per CTAs a slab as in spmm_slab_tc_kernel's grid.
template <int H, int NKS>
__global__ void __launch_bounds__(2 * kWarpgroup, 1) spmm_slab_tc_kernel_edge(
    const float* __restrict__ image, const int* __restrict__ slab_ptr,
    const int* __restrict__ slab_blocks, const int* __restrict__ slab_rows,
    const float* __restrict__ b, const float* __restrict__ c, float* __restrict__ out, int n,
    int m_rows, int k_rows, int block_k, float alpha, float beta, int with_c, int b_vec,
    const int* __restrict__ edges, int n_edges) {
  launch_dependents();
  const int tn = blockDim.x / kWarpgroup * kTileN, n_ctiles = (n + tn - 1) / tn;
  const int per = 2 / H * n_ctiles;
  const int cta = edges[blockIdx.x / per] * per + blockIdx.x % per;
  const int hs = cta / n_ctiles;  // the CTA's half slab (H = 1) or slab (H = 2)
  if ((long long)hs * H * kSlabRows >= m_rows) return;  // rows past C's
  tc_cta<H, NKS, true>(cta, image, slab_ptr, slab_blocks, slab_rows, b, c, out, n, m_rows,
                       k_rows, block_k, alpha, beta, with_c, b_vec);
}

// ---- K1 in precise mode, on FFMA: half a slab by 64 columns a CTA, each
// thread over 8 rows and 4 columns ----

__global__ void __launch_bounds__(kWarpgroup) spmm_slab_precise_kernel(
    const float* __restrict__ vals,        // (ng, G * bk, 128)
    const int* __restrict__ slab_ptr,      // (n_slabs + 1,)
    const int* __restrict__ slab_blocks,   // (ng * G,) flat block indices
    const int* __restrict__ slab_rows,     // (ng * G,) each block's first B row
    const float* __restrict__ b,           // (k_rows, n)
    const float* __restrict__ c,           // (m_rows, n) or null
    float* __restrict__ out,               // (m_rows, n)
    int n, int m_rows, int k_rows, int block_k, float alpha, float beta, int with_c,
    int b_vec) {
  extern __shared__ float4 smem4[];
  const int ch = min(kChunk, block_k), nch = block_k / ch;
  const int stage = ch * (kSlabRows + kTileN + kBPad);  // floats a stage
  float* ring = reinterpret_cast<float*>(smem4);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStagesK1 * stage);
  const int n_ctiles = (n + kTileN - 1) / kTileN;
  const int hs = blockIdx.x / n_ctiles;
  const int slab = hs / 2, half = hs % 2;
  if ((long long)slab * MSLAB + half * kSlabRows >= m_rows) return;  // rows past C's
  const int n0 = (blockIdx.x % n_ctiles) * kTileN;
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // columns tx*4 .. tx*4+3
  const int ty = tid / 16;  // rows ty*8 .. ty*8+7
  const int p0 = slab_ptr[slab];
  const int items = (slab_ptr[slab + 1] - p0) * nch;

  if (tid == 0) {
    for (int s = 0; s < kStagesK1; ++s) sx_async::mbar_init(&full[s], kWarpgroup);
    sx_async::mbar_fence_init();
  }
  __syncthreads();

  auto issue = [&](int q) {
    float* vs = ring + (q % kStagesK1) * stage;
    const size_t blk = slab_blocks[p0 + q / nch];
    const size_t row = slab_rows[p0 + q / nch];
    const int cidx = q % nch;
    const float* vsrc = vals + (blk * block_k + (size_t)cidx * ch) * MSLAB + half * kSlabRows;
    for (int e = tid; e < ch * (kSlabRows / 4); e += kWarpgroup) {
      const int kk = e / (kSlabRows / 4), q4 = 4 * (e % (kSlabRows / 4));
      sx_async::cp_async16(vs + kk * kSlabRows + q4, vsrc + (size_t)kk * MSLAB + q4);
    }
    copy_b_chunk_zfill(vs + ch * kSlabRows, b + (row + (size_t)cidx * ch) * n + n0, b, ch,
                       rows_below(k_rows, (int)row + cidx * ch, ch), n, n0, kTileN, b_vec, tid,
                       kWarpgroup);
    sx_async::cp_async_arrive(&full[q % kStagesK1]);
  };
  for (int q = 0; q < items && q < kStagesK1; ++q) issue(q);

  float acc[8][4], comp[8][4], cf[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) acc[i][jj] = comp[i][jj] = cf[i][jj] = 0.f;

  for (int q = 0; q < items; ++q) {
    sx_async::mbar_wait(&full[q % kStagesK1], (q / kStagesK1) & 1);
    const float* vs = ring + (q % kStagesK1) * stage;
    const float* bs = vs + ch * kSlabRows;
    for (int kk = 0; kk < ch; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(vs + kk * kSlabRows + ty * 8);
      const float4 a1 = *reinterpret_cast<const float4*>(vs + kk * kSlabRows + ty * 8 + 4);
      const float4 bv = *reinterpret_cast<const float4*>(bs + kk * (kTileN + kBPad) + tx * 4);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bb[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) cf[r][jj] = __fmaf_rn(a[r], bb[jj], cf[r][jj]);
      if ((kk & 7) == 7) {  // ch % 8 == 0: every term is stepped in
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            sx_df32::acc_step(acc[r][jj], comp[r][jj], cf[r][jj]);
            cf[r][jj] = 0.f;
          }
      }
    }
    __syncthreads();  // every thread is done with the stage
    if (q + kStagesK1 < items) issue(q + kStagesK1);
  }

  const size_t row0 = (size_t)slab * MSLAB + half * kSlabRows + ty * 8;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int col = n0 + tx * 4 + jj;
      if (col < n && row0 + r < (size_t)m_rows) {
        const size_t idx = (row0 + r) * n + col;
        out[idx] = with_c
            ? sx_df32::compensated_epilogue(alpha, acc[r][jj], comp[r][jj], beta, c[idx])
            : sx_df32::compensated_epilogue(alpha, acc[r][jj], comp[r][jj]);
      }
    }
  }
}

// K2 (n <= 32): a CTA owns half a slab, kSlabRows = 64 rows, and all n
// columns; it visits only its slab's blocks, listed by the host scan
// slab_visits (slab_ptr / slab_blocks / slab_rows, ops/spmm_slab.py) in pack
// order, and
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
// row-major and the rows are slab_rows[p] + kk): one TMA bulk copy
// (cp.async.bulk), issued by one thread with expect_tx, when n % 4 == 0 and
// B is 16-byte aligned (b_bulk), which on an H100 made K2 3-4 % faster than
// 16-byte cp.async of the same run (tools/kernel_times.py, PERF.md);
// otherwise the run does not start on a 16-byte boundary for every block,
// and the threads copy it with 4-byte cp.async beside the values. Where the
// run passes B's end (k_rows), the bulk copy stops there and the threads
// fill the rest with zeros (zfill cp.async). After a block, one
// __syncthreads frees its stage, and the copy of the block kStages further
// on starts.
//
// What bounds it on the H100: each value feeds n flops, so the slab
// format's bytes (values at ~5 % fill) bound it where the slabs fill the
// card (cant_like: 299 MB of values, 0.09 ms at 3.35 TB/s); where few
// slabs hold blocks (synthetic4704: 22 of 40), the longest slab's FFMA
// chain: 12 blocks x 128 terms, each term 8 FFMA a thread from shared
// memory, the block's copy landing under the previous block's chain.

template <bool PRECISE>
__global__ void __launch_bounds__(256) spmm_slab_skinny_kernel(
    const float* __restrict__ vals,        // (ng, G * bk, 128)
    const int* __restrict__ slab_ptr,      // (n_slabs + 1,)
    const int* __restrict__ slab_blocks,   // (ng * G,) flat block indices
    const int* __restrict__ slab_rows,     // (ng * G,) each block's first B row
    const float* __restrict__ b,           // (k_rows, n)
    const float* __restrict__ c,           // (m_rows, n) or null
    float* __restrict__ out,               // (m_rows, n)
    int n, int m_rows, int k_rows, int block_k, float alpha, float beta, int with_c,
    int b_bulk) {
  extern __shared__ float4 smem4[];
  const int np = (n + 3) & ~3;
  const int stage = block_k * (kSlabRows + np);  // floats a stage
  float* ring = reinterpret_cast<float*>(smem4);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * stage);
  const int slab = blockIdx.x / (MSLAB / kSlabRows);
  const int half = blockIdx.x % (MSLAB / kSlabRows);
  if ((long long)slab * MSLAB + half * kSlabRows >= m_rows) return;  // rows past C's
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
    const int row = slab_rows[p0 + j];
    const float* bsrc = b + (size_t)row * n;
    const int valid = rows_below(k_rows, row, block_k);  // the rows past B's are zeros
    if (b_bulk && tid == 0) {
      sx_async::mbar_arrive_expect_tx(&full[st], 4u * valid * n);
      if (valid) sx_async::bulk_copy(bs, bsrc, 4u * valid * n, &full[st]);
    }
    for (int e = tid; e < block_k * (kSlabRows / 4); e += blockDim.x) {
      const int kk = e / (kSlabRows / 4), q4 = 4 * (e % (kSlabRows / 4));
      sx_async::cp_async16(vs + kk * kSlabRows + q4, vsrc + (size_t)kk * MSLAB + q4);
    }
    if (b_bulk) {  // n % 4 == 0: the rows past B's by 16 bytes
      for (int e = valid * n + 4 * tid; e < block_k * n; e += 4 * blockDim.x)
        sx_async::cp_async16_zfill(bs + e, b, 0u);
    } else {
      for (int e = tid; e < block_k * n; e += blockDim.x) {
        const bool in = e / n < valid;
        sx_async::cp_async4_zfill(bs + (e / n) * np + e % n, in ? bsrc + e : b, in ? 4u : 0u);
      }
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
      if (col < n && row + r < (size_t)m_rows) {
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
    const void* vals, const void* image, const void* slab_ptr, const void* slab_blocks,
    const void* slab_rows, const void* edges, const void* b, const void* c, void* out,
    int n_slabs, int n_edges, int n, int m_rows, int k_rows, int block_k, float alpha,
    float beta, int with_c, int precise, int b_vec, int halves, int threads, int grid, int smem,
    void* stream) {
  // plain mode on the tensor cores over 1 or 2 half slabs, precise mode on FFMA
  if (precise < 0 || precise > 2 || halves < 0 || halves > 2 || !precise != !!halves)
    return cudaErrorInvalidValue;
  if (m_rows < 0 || (long long)m_rows > (long long)n_slabs * MSLAB || k_rows < 0 ||
      n_edges < 0 || n_edges > n_slabs)
    return cudaErrorInvalidValue;
  // the wrapper's map (ops/spmm_slab.py:slab_launch) must be this kernel's
  const int ch = block_k < kChunk ? block_k : kChunk;
  const int wgs = threads / kWarpgroup, tn = wgs * kTileN;
  const size_t per_stage = halves ? (size_t)ch * (halves * 2 * kSlabRows + wgs * (kTileN + kBPad))
                                  : (size_t)ch * (kSlabRows + kTileN + kBPad);
  // a stage beside its mbarrier; the tensor cores' ring also a counter a stage
  const size_t need = kStagesK1 * (4 * per_stage + 8 + (halves ? 4 : 0));
  const int per = (2 / (halves ? halves : 1)) * ((n + tn - 1) / tn);  // CTAs a slab
  if (n < 1 || block_k % 8 || threads % kWarpgroup || wgs < 1 || wgs > (halves ? 2 : 1) ||
      grid != (long long)n_slabs * per || (size_t)smem != need)
    return cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (!halves) {  // precise mode: one kernel, which checks every row itself
    cudaError_t e = cudaFuncSetAttribute(spmm_slab_precise_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    spmm_slab_precise_kernel<<<grid, threads, smem, st>>>(
        (const float*)vals, (const int*)slab_ptr, (const int*)slab_blocks, (const int*)slab_rows,
        (const float*)b, (const float*)c, (float*)out, n, m_rows, k_rows, block_k, alpha, beta,
        with_c, b_vec);
    return cudaGetLastError();
  }
  // the tensor cores' kernels by tile shape and steps a chunk: the edge
  // slabs' CTAs first, then every other CTA, launched to start at once
  using Tc = void (*)(const float*, const int*, const int*, const int*, const float*,
                      const float*, float*, int, int, int, int, float, float, int, int,
                      const int*, int);
  const Tc tc[2][3] = {
      {spmm_slab_tc_kernel<1, 1>, spmm_slab_tc_kernel<1, 2>, spmm_slab_tc_kernel<1, 4>},
      {spmm_slab_tc_kernel<2, 1>, spmm_slab_tc_kernel<2, 2>, spmm_slab_tc_kernel<2, 4>}};
  const Tc tc_edge[2][3] = {
      {spmm_slab_tc_kernel_edge<1, 1>, spmm_slab_tc_kernel_edge<1, 2>,
       spmm_slab_tc_kernel_edge<1, 4>},
      {spmm_slab_tc_kernel_edge<2, 1>, spmm_slab_tc_kernel_edge<2, 2>,
       spmm_slab_tc_kernel_edge<2, 4>}};
  const int which = ch == 8 ? 0 : ch == 16 ? 1 : 2;
  const float* img = (const float*)image;
  const int *ptr = (const int*)slab_ptr, *blocks = (const int*)slab_blocks,
            *rows = (const int*)slab_rows, *edge_list = (const int*)edges;
  cudaError_t e;
  if (n_edges) {
    const Tc k = tc_edge[halves - 1][which];
    e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    k<<<n_edges * per, threads, smem, st>>>(img, ptr, blocks, rows, (const float*)b,
                                            (const float*)c, (float*)out, n, m_rows, k_rows,
                                            block_k, alpha, beta, with_c, b_vec, edge_list,
                                            n_edges);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  const Tc k = tc[halves - 1][which];
  e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = n_edges ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, k, img, ptr, blocks, rows, (const float*)b, (const float*)c,
                         (float*)out, n, m_rows, k_rows, block_k, alpha, beta, with_c, b_vec,
                         edge_list, n_edges);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

extern "C" int spmm_slab_skinny_launch(
    const void* vals, const void* slab_ptr, const void* slab_blocks, const void* slab_rows,
    const void* b, const void* c, void* out, int n_slabs, int n, int m_rows, int k_rows,
    int block_k, float alpha, float beta, int with_c, int precise, int b_bulk, int threads,
    int grid, int smem, void* stream) {
  if (precise < 0 || precise > 2) return cudaErrorInvalidValue;
  if (m_rows < 0 || (long long)m_rows > (long long)n_slabs * MSLAB || k_rows < 0)
    return cudaErrorInvalidValue;
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
      (const float*)vals, (const int*)slab_ptr, (const int*)slab_blocks, (const int*)slab_rows,
      (const float*)b, (const float*)c, (float*)out, n, m_rows, k_rows, block_k, alpha, beta,
      with_c, b_bulk);
  return cudaGetLastError();
}
