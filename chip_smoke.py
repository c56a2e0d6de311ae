#!/usr/bin/env python3
"""Smoke run of sextans_tpu_torch on one NVIDIA GPU, and its kernel timings.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases (each prints its lines; any failure exits non-zero):

0. torch / CUDA versions and the card's name and power limit (nvidia-smi).
1. Build the CUDA kernels from ``sextans_tpu_torch/csrc`` (timed).
2. Each kernel against its plain PyTorch version on the card, at the shapes
   the main path gives it: the banded synthetic 4704 x 4704 matrix
   (104,756 nnz, the one ``bench.py`` uses without nasa4704); block kernel
   (K3) at N = 512 and 16 with the default config, slab kernel (K1) at
   N = 512 and skinny slab kernel (K2) at N = 16 with ``bench.py``'s slab
   config, edge kernel (K4) at N = 512 and, with ``edge_masked`` and
   ``edge_lanes=4``, at N = 16, ELL gather kernel (K5) at N = 512 and 16, and
   the DIA kernels over the diagonal part of its hybrid split (256
   diagonals): K6 at N = 512, K7 at N = 16; and the hub kernel
   (``csrc/hybrid_hub.cu``) over the split's head columns and hub rows at
   N = 512, on K6's output with C.
   Tolerance: K4, K6, K7 and the hub kernel to the bit; K3 within
   spacing(f32(max |plain|)) (its plain version contracts each block with a
   matmul); the others 4 * that (K1 contracts in 3xTF32 on the tensor
   cores in plain mode). K3's and K4's rows also print their thread map and
   grid; K2's its grid (two CTAs a slab), threads, stages and shared memory
   a CTA, and how many slabs hold blocks; K1's the same and its contraction
   and tile; K6's and K7's their run plan (runs of diagonals, their widest
   span), tiles, threads and shared memory a CTA. K1, K2, K4 and K5 run
   twice: on padded B, C and output, as ``SpmmPlan.repeat`` and serving
   give them, and on the (K, N) B and (M, N) C and output that
   ``SpmmPlan.__call__`` gives them, to the bit against the padded call's
   rows and against their plain version on the same shapes at their
   tolerance; their time is the latter's.
3. The main path end to end: write_mtx -> read_mtx -> the backend's packer
   -> plan(device="cuda") -> verify against golden_spmm, and max-abs against
   golden_spmm_exact in ulp of max|C| (bar: 4 ulp), for pallas, mxu, edge
   and ell_pallas at N = 512 and 16; alpha 0.85, beta -2.06, B and C from
   numpy seed 0.
4. The same at full size: cant_like (fem_like(62451, dofs=3, neighbors=21,
   seed=2), 3,781,404 nnz) at N = 512 through all four backends, and at N =
   16 through mxu (K2, on the N = 512 run's pack), and each kernel against
   its plain version there as in phase 2.
5. The hybrid path: split_structure(coo, n=N) -> HybridSpmmPlan(device=
   "cuda", residue on ``pallas``) -> verify, on synthetic4704 at N = 512
   (K6) and 16 (K7), both with head columns, hub rows and a residue; and at
   full size scircuit_like (circuit_like(170998, seed=9), 906,267 nnz, 121
   diagonals, 40 hub columns and rows, no residue) at N = 512 and
   laplace3d_64 (stencil_3d(64, seed=12), 1,826,686 nnz, 7 diagonals) at
   N = 16. Bar: 4 ulp of max|C|, 16 on scircuit_like, whose hub rows are
   dot products of ~850 terms in 170,998 columns; the worst element's row
   is printed, and whether it is a hub row. On those two, the DIA kernel is
   also held against its plain version and timed beside it and the library
   call on the diagonal part, as in phase 2; on scircuit_like the hub
   kernel too, to the bit against its plain version, its launches printed,
   timed beside its bound (B rows gathered for the hub-row entries, the
   touched rows of the output read and written) and beside the dense f32
   GEMMs and adds it replaces (the ``"xla"`` step's hub parts; the
   ``library_ms`` of its JSON row). Every plain (precise 0) hybrid run
   launches the hub kernel once a product where its split has head columns
   or hub rows. Each run at N > 32 prints K6's
   run plan (``dia_runs``: seconds, bytes, runs). Then scircuit_like at N =
   512 through ell_pallas (K5; the default pack's 40 hub rows outgrow a
   tile, so their virtual rows go through the kernel's scratch to its
   second launch, the long fold): the main path under the hub bar of 16,
   and the kernel to the bit against its plain version as in phase 2.
6. ``python -m sextans_tpu_torch <mtx> 16 --backend B`` for B in mxu, edge
   and ell_pallas, and ``--hybrid --backend pallas``, and with ``--precise``
   for B in pallas, mxu, edge and ell_pallas and with ``--hybrid --backend
   pallas``, run together; each must print Success!.
7. The EFT probe (the twin of the TPU probe P3,
   ``benchmarks/scratch/mosaic_eft_probe.py``): two_sum / two_prod over its
   (8, 128) inputs and its 64-term two_prod + acc_step chain, compiled by
   nvcc with the kernels' flags; 0 violations against f64, 0 elements of
   the chain above the f32 representation floor, and equal to its plain
   version on the card.
8. Precise levels (``SpmmConfig.precise``) on the main path: synthetic4704
   at N = 512 and 16 through pallas (K3), edge (K4, the masked pack at
   N = 16) and mxu (K1 at 512, K2 at 16) at levels 1 and 2; each kernel
   against its plain version on the card (K3 and K4 to the bit, K1 and K2
   within 4 ulp), and the path against golden_spmm_exact: pallas and edge
   within 1 ulp of max|C| at level 1 and 0.5001 (correctly rounded) at
   level 2, mxu within 1.5 and no worse than its plain mode. Then cant_like
   N = 512 through pallas and edge at level 2 and mxu at level 1, against
   phase 4's f64 oracle. Each run prints its ulp, the elements above their
   own f32 representation floor, and the kernel's time beside its plain
   mode's (same inputs, in turns; on cant_like phase 4's ``time_repeat``).
9. Precise ELL, DIA and hybrid (K5, K6 and K7 have one precise variant for
   levels 1 and 2): synthetic4704 at N = 512 and 16 through ell_pallas (K5
   to the bit against its plain version; bar 1.0 ulp of max|C|, the virtual
   hub rows round to f32 before the f64 fold) and ell (f64 throughout, bar
   0.5001) at levels 1 and 2; K6 (N = 512) and K7 (N = 16) precise to the
   bit against their plain version; ``HybridSpmmPlan(precise=1)`` with all
   four parts (bar 2.0 and plain mode's ulp on the same inputs). Then full
   width against the f64 oracles of phases 4 and 5: cant_like N = 512
   through ell_pallas at level 1 (bar 1.0), scircuit_like N = 512 (no worse
   than plain mode there, over all rows and outside the hub rows: the hub
   rows' dot products of ~850 terms, which neither package compensates, are
   summed by the hub kernel as in plain mode, one launch a part; 16 at
   most) and
   laplace3d_64 N = 16 (the DIA part alone, bar 1.0 and plain mode's ulp)
   through the precise hybrid plan; K5, K6 and K7 each again to the bit
   against their plain version at these shapes, timed beside the same
   kernel in plain mode; and each path beside phases 4-5's plain ulp and
   ``time_repeat``.
10. The gather probes (the twins of the TPU probes P1,
   ``benchmarks/scratch/dma_gather_probe.py``, and P2,
   ``benchmarks/scratch/ell_issue_probe.py``): P1 in its ``direct`` and
   ``async`` (256 rows per CTA) staging modes at its own inputs (seed 0, K =
   4096, N = 256, R = 4, M = 512) and P2 in its ``skip`` and ``select``
   variants at its own (K = 4096, N = 512, R = 4, M = 2048, 30 % value-0
   slots), each to the bit against its plain version, under the probe's
   bar of 1e-4 against einsum and within 4 ulp of max|out| of f64; P2 again
   with B[0] = NaN, every row whose nonzero slots avoid row 0 unchanged.
   Then each at K = 400,000, M = 262,144, N = 512, R = 4 (P2 with 30 %
   value-0 slots), made on the card: to the bit against its plain version,
   timed beside it and ``embedding_bag`` (timed only) in turns, with the
   bound max(2 * live slots * N / 67 TFLOP/s, (8 * M * R + 4 * N * U + 4 * M
   * N) / 3.35 TB/s), U the distinct rows of B the live slots touch. The
   sweeps run in their own processes (``python3 -m
   sextans_tpu_torch.probes.dma_gather``, ``... .ell_issue``).

11. Serving: ``SpmmServer`` on ``cuda`` with a ``PackCache`` in a temporary
   directory, for the formats vpu (K3), mxu (K1 at N = 512, K2 at N = 16),
   edge (K4) and ell (the plain ELL engine), on synthetic4704 (new
   buckets), on a second matrix of other seed, m, k and nnz (4690 x 4710,
   104,000 nnz) that lands in the same buckets, and on cant_like (new
   buckets; vpu, mxu and edge). Each served product, driven from host B and
   C with the launches counted from just before it to just after, is
   held against ``SpmmPlan`` on the unbucketed pack (to the bit; K1 in plain
   mode within 4 ulp of max|C|) and against verify and f64 (4 ulp); a
   precise (level 1) server on the cached synthetic4704 pack shares the
   plain one's upload and scan. Each prints its served call end to end
   (CUDA events: host B and C in, pad, kernel, slice) and the kernel on the
   bucketed pack beside the unbucketed one (the bucket's padding cost),
   with the card's name and power limit. A second ``PackCache`` on the same
   root serves cant_like's packs from disk (memory-mapped where above
   ``SEXTANS_PACK_RAW_BYTES``) to the same bits; ``HybridSpmmPlan`` with
   its residue through the cache equals the uncached plan on synthetic4704
   N = 512 (K6 and K3); ``build_kernels.cache_info()`` does not change.
12. Training (``spmm_value_op``, ``ops/autodiff.py``): (a) cant_like N =
   512 through K1, the op built from cant_like's pattern with every value 0
   (what a plan over values walks must be the structure, not the values it
   was built from), 5 Adam steps (lr 1e-3) on vals (from seed-1 normals)
   and B toward a target made with cant_like's own values, the loss
   falling at every step; (b) one step at synthetic4704 through K3 (N =
   512, and precise 1), K1 (N = 512), K2 (N = 16), K4 and K5 (N = 512),
   and through K3 and K2 built from values that are zero on rows 0-2351;
   (c) ``examples/train_sparse_torch.py`` on the card (loss < 1e-4). Each
   run of (a) and (b) holds step 1 against f64: A @ B and dB (on the CSR
   of A^T, by ``utils/device_verify.py``) within 4 ulp of max|.|, or no
   further than the plain versions' own f32 sums on the same inputs, and
   never a ulp past them; dvals (the SDDMM kernel, ``csrc/sddmm.cu``, one
   launch a step) within 4 ulp of max|dvals|; dC
   = beta G to the bit; dalpha and dbeta within 2^-20 of sum|G * AB|
   (sum|G * C|); the forward and A^T kernels against their plain versions
   on the card (K1 and K2 4 ulp, K3 1, K4, K5 and precise K3 0), and the
   SDDMM kernel against its plain version within 4 ulp of max|dvals|,
   beside its tiles' B-row reuse (``sddmm.entries / sddmm.b_rows``); and where
   the op's packs hold the matrix's values, its scatter gives them to the
   bit. Each prints its losses, its step by ``time_chained`` (forward,
   backward, Adam) and by CUDA events the scatter, ``slab_image``, the
   forward and A^T kernels and the SDDMM (kernel and plain version),
   beside the library's step
   (``torch.sparse.mm`` forward and A^T, ``sampled_addmm``, timed only),
   with the card's name and power limit; no build in the phase.

Timings. Beside each kernel of phases 2 and 4: its plain version's time, the
library call ``torch.sparse.addmm(C, A_csr, B, beta, alpha)`` on the same
matrix and N (timed only, never used by the package), and the bound
max(2 * nnz * N / 67 TFLOP/s, bytes / 3.35 TB/s), bytes = 8 per nonzero + B
+ C in + C out, each once; for the DIA kernels the dense DIA work,
max(2 * D * M * N / 67 TFLOP/s, (4 * D * M + B + C in + C out) / 3.35 TB/s),
with the library call on the diagonal part as CSR. The three are sampled
in turns plain, kernel, library, library, kernel, plain, ``ROUNDS`` (3)
times (2 on the full-size shapes and in phases 8 and 9, whose precise
kernels are also sampled in plain mode) by ``abba_ms``
(``sextans_tpu_torch/utils/timing.py``, which also times phase 10 and the
probes' sweeps); each sample is CUDA events over a few launches,
the plain version's over one; the median is printed. On the full-size
shapes and in phases 8 and 9 the plain version is timed once instead, on
the call that is compared with its kernel.
Each path of phases 3
and 4 prints its pack (seconds, bytes on the card, slots and the share that
holds a nonzero), the host scan its kernel walks (``stripe_visits`` for
pallas, ``row_runs`` for edge, ``slab_visits`` for mxu: seconds, bytes and
its longest list; ``ell_tiles`` for ell_pallas: seconds, bytes, tiles and
their logical rows), each path's one product checked to launch its kernel
once, K1's operand tiles on the mxu path at N > 32 in plain
mode (``slab_image``, made at upload: seconds on the card and bytes),
``time_repeat`` (median of 3) and GFLOPS = 2 * N * (nnz + M) / t, and a ``torch.profiler`` breakdown of 20 plan calls: device
time in the kernel, in every other device op, and the idle share of the
calls' host-clock time. Each hybrid run of phase 5 prints the same for its
split (seconds, bytes of every part on the card), with the DIA kernel and
the residue's kernel apart in the profile.

Every run of phases 3, 4, 5, 7, 8, 9, 10, 11 and 12 is one path: its launches are
counted from just before it to just after (the process's ``launch.<wrapper>``
counters, ``sextans_tpu_torch.counters()``), and its kernels must have
launched. Nothing failing is passed over: a kernel that does not build or
launch raises, and nothing falls back to a plain version or the CPU.
The last two lines are a JSON object with one entry per kernel (its phase-2
row at the first N; a precise variant's phase-8 or phase-9 row, named
``<kernel>_precise<level>``; the probes' kernels) and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import functools
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
ALPHA, BETA = 0.85, -2.06
ULP_BAR = 4.0
HUB_ULP_BAR = 16.0  # scircuit_like's hybrid path: long hub-row dot products
PRECISE_BAR = {1: 1.0, 2: 0.5001}  # block and edge paths (docs/ACCURACY.md)
SLAB_PRECISE_BAR = 1.5
ELL_PRECISE_BAR = 1.0  # ell_pallas: each virtual hub row rounds to f32 before the f64 fold
ELL_F64_BAR = 0.5001  # ell: f64 throughout, one rounding
DIA_PRECISE_BAR = 1.0  # hybrid with the DIA part alone (laplace3d_64)
HYBRID_PRECISE_BAR = 2.0  # hybrid with all four parts (synthetic4704), and <= plain mode
# the kernels with one precise variant for levels 1 and 2
PRECISE1 = ("spmm_ell_precise1", "spmm_dia_precise1", "spmm_dia_skinny_precise1")


def fail(msg: str):
    raise RuntimeError(f"chip_smoke FAILED: {msg}")


def launch_marks(wrappers: dict) -> dict:
    """Each kernel wrapper's launches so far (``utils/profiling.py:launches``,
    the process's ``launch.<wrapper>`` counters): marks to count from."""
    from sextans_tpu_torch.utils.profiling import launches

    return {name: launches(fn) for name, fn in wrappers.items()}


def launched_since(wrappers: dict, marks: dict) -> dict:
    """The launches of each wrapper since ``marks`` (:func:`launch_marks`),
    of those that launched."""
    now = launch_marks(wrappers)
    return {name: now[name] - marks[name] for name in wrappers if now[name] > marks[name]}


def bound(nnz: int, m: int, k: int, n: int):
    """Least milliseconds of C = alpha * A @ B + beta * C, and its limit."""
    from sextans_tpu_torch.utils.timing import PEAK_F32_FLOPS, PEAK_HBM_BYTES

    flop_ms = 2.0 * nnz * n / PEAK_F32_FLOPS * 1e3
    byte_ms = (8.0 * nnz + 4.0 * k * n + 8.0 * m * n) / PEAK_HBM_BYTES * 1e3
    return max(flop_ms, byte_ms), "operations" if flop_ms > byte_ms else "bytes"


def sddmm_bound(nnz: int, m: int, k: int, n: int):
    """Least milliseconds of the SDDMM ``G[rows[e]] . B[cols[e]]``: G and B
    once, 8 bytes of coordinates and 4 of output a nonzero; and its limit."""
    from sextans_tpu_torch.utils.timing import PEAK_F32_FLOPS, PEAK_HBM_BYTES

    flop_ms = 2.0 * nnz * n / PEAK_F32_FLOPS * 1e3
    byte_ms = (12.0 * nnz + 4.0 * (m + k) * n) / PEAK_HBM_BYTES * 1e3
    return max(flop_ms, byte_ms), "operations" if flop_ms > byte_ms else "bytes"


def dia_bound(n_diags: int, m: int, k: int, n: int):
    """Least milliseconds of the DIA kernels' dense work, and its limit."""
    from sextans_tpu_torch.utils.timing import PEAK_F32_FLOPS, PEAK_HBM_BYTES

    flop_ms = 2.0 * n_diags * m * n / PEAK_F32_FLOPS * 1e3
    byte_ms = (4.0 * n_diags * m + 4.0 * k * n + 8.0 * m * n) / PEAK_HBM_BYTES * 1e3
    return max(flop_ms, byte_ms), "operations" if flop_ms > byte_ms else "bytes"


def hub_bound(split, entries: int, rows: int, n: int):
    """Least milliseconds of the hub pass (``csrc/hybrid_hub.cu``) over
    ``split``'s head columns and hub rows: each distinct B row its entries
    name read once (a hub row's columns repeat across the hub rows, and the
    repeats may come from the L2), each of the ``rows`` touched rows of out
    read and written once and 8 bytes of list an entry, against 2 flops an
    entry and column; and its limit."""
    import numpy as np

    from sextans_tpu_torch.utils.timing import PEAK_F32_FLOPS, PEAK_HBM_BYTES

    b_rows = np.union1d(np.nonzero(split.head_rows_dense)[1], split.head_cols).size
    flop_ms = 2.0 * entries * n / PEAK_F32_FLOPS * 1e3
    byte_ms = (4.0 * n * (b_rows + 2 * rows) + 8.0 * entries) / PEAK_HBM_BYTES * 1e3
    return max(flop_ms, byte_ms), "operations" if flop_ms > byte_ms else "bytes"


def kernel_calls(pl, n, precise=None):
    """(name, kernel call, plain call) of ``pl``'s kernel, as ``fn(b_p, c_p)``,
    at the pack's precise level or at ``precise``."""
    from sextans_tpu_torch.ops.spmm_block import spmm_block_padded, spmm_block_padded_ref
    from sextans_tpu_torch.ops.spmm_edge import spmm_edge_padded, spmm_edge_padded_ref
    from sextans_tpu_torch.ops.spmm_ell import (
        spmm_ell_gather_padded,
        spmm_ell_gather_padded_ref,
    )
    from sextans_tpu_torch.ops.spmm_slab import (
        SKINNY_MAX_N,
        slab_image,
        spmm_slab_padded,
        spmm_slab_padded_ref,
        spmm_slab_skinny_padded,
    )

    packed, cfg = pl.packed, pl.packed.config
    extra = dict(ranges=pl.ranges)
    level = dict(precise=int(cfg.precise if precise is None else precise))
    if pl.backend == "mxu" or pl._in_place and pl.backend == "edge":
        extra.update(m=packed.m, k=packed.k)  # B and C may lie at K and M rows
    if pl.backend == "ell_pallas":
        name, kernel, plain = "spmm_ell", spmm_ell_gather_padded, spmm_ell_gather_padded_ref
        kw = dict(m_base=packed.m_base)
    elif pl.backend == "edge":
        name, kernel, plain = "spmm_edge", spmm_edge_padded, spmm_edge_padded_ref
        kw = dict(tile_m=cfg.tile_m, window_k=cfg.window_k,
                  edge_chunk=cfg.edge_chunk, masked=cfg.edge_masked)
    else:
        if pl.backend == "pallas":
            name, kernel, plain = "spmm_block", spmm_block_padded, spmm_block_padded_ref
        elif n <= SKINNY_MAX_N:
            name, kernel, plain = ("spmm_slab_skinny", spmm_slab_skinny_padded,
                                   spmm_slab_padded_ref)
        else:
            name, kernel, plain = "spmm_slab", spmm_slab_padded, spmm_slab_padded_ref
            # K1's operand tiles, made at upload for plain mode; made here to
            # run a precise plan's pack in plain mode too
            extra["image"] = (pl.image if pl.image is not None or level["precise"]
                              else slab_image(pl.arrays[0], cfg.block_k))
        kw = dict(tile_m=cfg.tile_m, window_k=cfg.window_k, block_k=cfg.block_k,
                  group_blocks=cfg.group_blocks)
    kw.update(level)
    return (name,
            lambda b_p, c_p: kernel(*pl.arrays, b_p, c_p, ALPHA, BETA, **kw, **extra),
            lambda b_p, c_p: plain(*pl.arrays, b_p, c_p, ALPHA, BETA, **kw))


def library_call(coo):
    """``torch.sparse.addmm`` on A as a CUDA CSR tensor, as ``fn(b, c)``:
    the yardstick, never used by the package."""
    import numpy as np
    import torch

    import sextans_tpu_torch as sx

    csr = sx.CSRMatrix.from_coo(coo)
    a = torch.sparse_csr_tensor(
        torch.as_tensor(csr.indptr.astype(np.int32), device="cuda"),
        torch.as_tensor(csr.indices.astype(np.int32), device="cuda"),
        torch.as_tensor(csr.vals, device="cuda"), size=coo.shape)
    return lambda b, c: torch.sparse.addmm(c, a, b, beta=BETA, alpha=ALPHA)


def profile(pl, b_dev, c_dev, kernel_names, calls: int = 20) -> str:
    """Device milliseconds per plan call in each of ``kernel_names`` (a
    device op counts for the longest name its key holds) and in every other
    device op, and the idle share of the calls' host-clock time."""
    import torch
    from torch.profiler import ProfilerActivity, profile as trace

    pl(b_dev, ALPHA, BETA, c_dev)
    torch.cuda.synchronize()
    with trace(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            pl(b_dev, ALPHA, BETA, c_dev)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    names = sorted(kernel_names, key=len, reverse=True)
    kernel_us = dict.fromkeys(names, 0.0)
    other_us = 0.0
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        name = next((k for k in names if k in evt.key), None)
        if name is None:
            other_us += us
        else:
            kernel_us[name] += us
    if min(kernel_us.values()) == 0.0:
        return "profile: the trace held no device time for a kernel (not measured)"
    idle = max(0.0, 1.0 - (sum(kernel_us.values()) + other_us) / 1e3 / wall_ms)
    kernels = ", ".join(f"{name} {us / 1e3 / calls:.4f} ms" for name, us in
                        sorted(kernel_us.items()))
    return (f"profile per call: kernel {kernels}, other device "
            f"{other_us / 1e3 / calls:.4f} ms, idle {100 * idle:.1f} %")


GATHER_PROBES = ("dma_gather_direct", "dma_gather_async", "ell_issue_skip", "ell_issue_select")
# phase 10's timing shape: the TPU probes' sweep (dma_gather_probe.py:148-153)
# at one N and R; P2 with its correctness share of value-0 slots
GATHER_K, GATHER_M, GATHER_N, GATHER_R, GATHER_ZEROS = 400_000, 262_144, 512, 4, 0.3


def gather_probes(kernels: dict, launches: dict) -> None:
    """Phase 10: P1's twin in both staging modes and P2's in both variants
    at the TPU probes' own inputs (seed 0), each run one path with its
    launches counted from just before it to just after; then each timed at one
    sweep shape beside its plain version, ``embedding_bag`` and the bound.
    Adds each kernel's row to ``kernels`` and its launches to ``launches``."""
    import numpy as np
    import torch

    from sextans_tpu_torch.probes import (
        dma_gather,
        ell_issue,
        gather_bound,
        library_gather,
        sweep_operands,
    )
    from sextans_tpu_torch.utils.timing import abba_ms, timed_once

    def run(name, cols, vals, b, checked=True):
        if name.startswith("dma_gather"):
            return dma_gather.gather_spmm(cols, vals, b, staging=name.rsplit("_", 1)[1],
                                          checked=checked)
        return ell_issue.ell_issue(vals, cols, b, variant=name.rsplit("_", 1)[1],
                                   checked=checked)

    def plain(name, cols, vals, b):
        if name.startswith("dma_gather"):
            return dma_gather.gather_spmm_ref(cols, vals, b)
        return ell_issue.ell_issue_ref(vals, cols, b)

    wrappers = {"dma_gather": dma_gather.gather_spmm, "ell_issue": ell_issue.ell_issue}
    inputs = {"dma_gather": dma_gather.probe_inputs(0), "ell_issue": ell_issue.probe_inputs(0)}
    errs = {}
    for name in GATHER_PROBES:
        probe = name.rsplit("_", 1)[0]
        b, cols, vals = inputs[probe]
        t_cols, t_vals, t_b = (torch.as_tensor(x, device="cuda") for x in (cols, vals, b))
        live = vals != 0
        rows = np.where(live[..., None], b[np.where(live, cols, 0)], 0)
        einsum = np.einsum("mr,mrn->mn", vals, rows)
        exact = np.einsum("mr,mrn->mn", vals.astype(np.float64), rows.astype(np.float64))
        mark = launch_marks(wrappers)
        got = run(name, t_cols, t_vals, t_b)
        if probe == "ell_issue":  # again with a NaN in the row that the pads load
            t_nan = t_b.clone()
            t_nan[0] = float("nan")
            got_nan = run(name, t_cols, t_vals, t_nan)
        torch.cuda.synchronize()
        count = launched_since(wrappers, mark).get(probe, 0)
        want = plain(name, t_cols, t_vals, t_b)
        out = got.cpu().numpy()
        err = (got - want).abs().max().item()
        err_einsum = float(np.abs(out - einsum).max())
        ulp = float(np.abs(out - exact).max()) / float(np.spacing(np.float32(np.abs(out).max())))
        ok = (count > 0 and torch.equal(got, want) and bool(np.isfinite(out).all())
              and err_einsum < 1e-4 and ulp <= ULP_BAR)
        note = ""
        if probe == "ell_issue":
            hit = torch.as_tensor((live & (cols == 0)).any(axis=1), device="cuda")
            kept = torch.equal(got_nan[~hit], got[~hit])
            ok = ok and kept
            note = (f"; B[0] = NaN: {int(hit.sum().item())} rows meet it in a nonzero slot, "
                    f"the other {int((~hit).sum().item())} finite and unchanged {kept}")
        print(f"phase 10: {name} at the probe's inputs (K={b.shape[0]} N={b.shape[1]} "
              f"R={cols.shape[1]} M={cols.shape[0]}, {100 * (~live).mean():.1f} % value-0 "
              f"slots): kernel - plain {err:.3e} (to the bit), vs einsum {err_einsum:.3e} "
              f"(bar 1e-4), vs f64 {ulp:.4f} ulp of max|out| (bar {ULP_BAR:g}){note}; "
              f"launches {count} {'ok' if ok else 'MISMATCH'}", flush=True)
        if not ok:
            fail(f"phase 10: {name} at the probe's inputs")
        launches[name] = count
        errs[name] = err

    gen = torch.Generator(device="cuda").manual_seed(0)
    b = torch.randn((GATHER_K, GATHER_N), generator=gen, device="cuda")
    operands = {"dma_gather": sweep_operands(gen, GATHER_K, GATHER_M, GATHER_R),
                "ell_issue": sweep_operands(gen, GATHER_K, GATHER_M, GATHER_R,
                                            zero_share=GATHER_ZEROS)}
    for name in GATHER_PROBES:
        probe = name.rsplit("_", 1)[0]
        cols, vals = operands[probe]
        got = run(name, cols, vals, b, checked=False)
        want, plain_ms = timed_once(lambda: plain(name, cols, vals, b))
        err = (got - want).abs().max().item()
        equal = torch.equal(got, want)
        del got, want
        if not equal:
            fail(f"phase 10: {name} differs from its plain version by {err:.3e}")
        # the columns were made in range above: time the kernel, not the scan
        ms = {"plain": plain_ms, **abba_ms(
            {"kernel": lambda: run(name, cols, vals, b, checked=False),
             "library": lambda: library_gather(cols, vals, b)}, iters=5)}
        bound_ms, bound_by = gather_bound(cols, GATHER_N,
                                          live=None if probe == "dma_gather" else vals != 0)
        kernels[name] = dict(max_abs_err=max(err, errs[name]), ms=ms["kernel"],
                             plain_ms=ms["plain"], bound_ms=bound_ms, bound_by=bound_by,
                             library_ms=ms["library"])
        slots = GATHER_M * GATHER_R
        print(f"phase 10: {name} K={GATHER_K} M={GATHER_M} N={GATHER_N} R={GATHER_R}"
              f"{'' if probe == 'dma_gather' else f' ({GATHER_ZEROS:g} value-0)'}: kernel - "
              f"plain 0 (to the bit); kernel {ms['kernel']:.4f} ms ({slots / ms['kernel'] / 1e3:.1f}"
              f" M rows/s, {4 * GATHER_N * slots / ms['kernel'] / 1e6:.1f} GB/s gathered) "
              f"plain {ms['plain']:.4f} ms embedding_bag {ms['library']:.4f} ms bound "
              f"{bound_ms:.5f} ms ({bound_by})", flush=True)
    del b, operands
    torch.cuda.empty_cache()


# phase 12's runs at synthetic4704: (format, N, precise level, built from
# values that are zero on rows 0-2351); the first run is cant_like's
TRAIN_CASES = (("vpu", 512, 0, False), ("vpu", 512, 0, True), ("vpu", 512, 1, False),
               ("mxu", 512, 0, False), ("mxu", 16, 0, False), ("mxu", 16, 0, True),
               ("edge", 512, 0, False), ("ell", 512, 0, False))
TRAIN_STEPS = 5  # Adam steps on cant_like
TRAIN_LR = 1e-3
SDDMM_CHUNK = 65536
# each reading of the f64 oracle (utils/device_verify.py) adds in the
# card's atomic order, which moves it by ~1e-9 ulp from one call to the next
ORACLE_SLACK = 1e-6


def value_kernel(fmt: str, n: int, precise: int) -> str:
    """The kernel a value op of ``fmt`` runs forward and on A^T at N = n."""
    from sextans_tpu_torch.ops.spmm_slab import SKINNY_MAX_N

    name = {"vpu": "spmm_block", "edge": "spmm_edge", "ell": "spmm_ell",
            "mxu": "spmm_slab" if n > SKINNY_MAX_N else "spmm_slab_skinny"}[fmt]
    return f"{name}_precise{precise}" if precise else name


def plain_product(plan, pv, x):
    """``A(pv) @ x`` (unscaled, no C) through the plain version of
    ``plan``'s kernel on the same device: the value op with the plain
    versions on the card."""
    from sextans_tpu_torch.ops.spmm_block import spmm_block_padded, spmm_block_padded_ref
    from sextans_tpu_torch.ops.spmm_edge import spmm_edge_padded, spmm_edge_padded_ref
    from sextans_tpu_torch.ops.spmm_ell import (
        spmm_ell_gather_padded,
        spmm_ell_gather_padded_ref,
    )
    from sextans_tpu_torch.ops.spmm_slab import (
        spmm_slab_padded,
        spmm_slab_padded_ref,
        spmm_slab_skinny_padded,
    )

    plain = {spmm_block_padded: spmm_block_padded_ref, spmm_edge_padded: spmm_edge_padded_ref,
             spmm_ell_gather_padded: spmm_ell_gather_padded_ref,
             spmm_slab_padded: spmm_slab_padded_ref,
             spmm_slab_skinny_padded: spmm_slab_padded_ref}[plan._run.func]
    kw = {k: v for k, v in plan._run.keywords.items() if k not in ("ranges", "image")}
    return plan.unpad(plain(pv, *plan.arrays[1:], plan.pad_b(x), plan.no_c(), 1.0, 0.0,
                            with_c=False, **kw))


def f64_sddmm(rows, cols, g, b):
    """``g[rows[e]] . b[cols[e]]`` in f64 on the device, in chunks."""
    import torch

    out = torch.empty(rows.numel(), dtype=torch.float64, device=g.device)
    for e0 in range(0, rows.numel(), SDDMM_CHUNK):
        e1 = min(rows.numel(), e0 + SDDMM_CHUNK)
        out[e0:e1] = (g[rows[e0:e1]].double() * b[cols[e0:e1]].double()).sum(dim=1)
    return out


def training(cant, synth, slab_cfg, block_cfg, operands, counted, launches, kernels,
             smi) -> None:
    """Phase 12: the differentiable SpMM (``spmm_value_op``) on the card.

    (a) cant_like N = 512 through K1: the op built from the pattern with
    every value 0, 5 Adam steps on vals and B toward a target made with
    cant_like's own values, the loss falling at every step; (b) one step at
    synthetic4704 through each of K1-K5 (``TRAIN_CASES``). Each run is one
    path (launches counted from just before it to just after) and holds step
    1's output and gradients against f64 and its kernels against their
    plain versions on the card; then times the step (``time_chained``), its
    parts and the library's. (c) ``examples/train_sparse_torch.py`` on the
    card. Adds each run's launches to ``launches`` and the SDDMM's row at
    cant_like to ``kernels``."""
    import importlib.util

    import numpy as np
    import torch

    import sextans_tpu_torch as sx
    from sextans_tpu_torch.ops.sddmm import sddmm_rows, sddmm_rows_ref
    from sextans_tpu_torch.ops.spmm_slab import slab_image
    from sextans_tpu_torch.utils.device_verify import device_full_check
    from sextans_tpu_torch.utils.profiling import launches as launches_of
    from sextans_tpu_torch.utils.timing import event_ms, time_chained

    def ulp_of(x) -> float:
        return float(np.spacing(np.float32(x)))

    def csr_tensor(coo, vals):
        csr = sx.CSRMatrix.from_coo(sx.COOMatrix(coo.shape, coo.rows, coo.cols, vals))
        t = torch.sparse_csr_tensor(
            torch.as_tensor(csr.indptr.astype(np.int32), device="cuda"),
            torch.as_tensor(csr.indices.astype(np.int32), device="cuda"),
            torch.as_tensor(csr.vals, device="cuda"), size=coo.shape)
        return csr, t

    def run(tag, coo, built, fmt, n, cfg, steps, iters):
        """One value op: built from ``built``'s values, trained from
        random values toward ``coo``'s."""
        m, k = coo.shape
        kernel = value_kernel(fmt, n, int(cfg.precise))
        t0 = time.perf_counter()
        op = sx.spmm_value_op(built, n, config=cfg, fmt=fmt, device="cuda")
        t_build = time.perf_counter() - t0
        b_np, c_np = operands(m, k, n)
        b0, c = (torch.as_tensor(x, device="cuda") for x in (b_np, c_np))
        true_vals = torch.as_tensor(coo.vals, device="cuda")
        v0 = torch.as_tensor(np.random.default_rng(1).standard_normal(coo.nnz)
                             .astype(np.float32), device="cuda")
        scatter_exact = ""
        if built is coo:  # the op's own packs hold coo's values: the scatter gives them
            same = all(torch.equal(sc(true_vals).cpu(), torch.as_tensor(pl.packed.vals))
                       for sc, pl in ((op.scatter, op.fwd_plan), (op.scatter_t, op.bwd_plan)))
            if not same:
                fail(f"{tag}: scattering the values does not give the packs' values")
            scatter_exact = "; scatter of A's values = its packs' values to the bit"
        with torch.no_grad():
            target = op(true_vals, b0, c, ALPHA, BETA)
        vals = v0.clone().requires_grad_()
        b = b0.clone().requires_grad_()
        c_leaf = c.clone().requires_grad_()
        al = torch.tensor(ALPHA, device="cuda", requires_grad=True)
        be = torch.tensor(BETA, device="cuda", requires_grad=True)
        opt = torch.optim.Adam([vals, b], lr=TRAIN_LR)

        def loss_of(out):
            return torch.mean((out - target) ** 2)

        marks = launch_marks(counted)
        sddmm_mark = launches_of(sddmm_rows)
        losses, first = [], {}
        for step in range(steps):
            opt.zero_grad()
            out = op(vals, b, c_leaf, al, be)
            if step == 0:
                out.register_hook(lambda g: first.setdefault("g", g.detach().clone()))
            loss = loss_of(out)
            loss.backward()
            if step == 0:
                first.update(out=out.detach().clone(), dvals=vals.grad.clone(),
                             db=b.grad.clone(), dc=c_leaf.grad.clone(),
                             dalpha=al.grad.clone(), dbeta=be.grad.clone())
            opt.step()
            losses.append(loss.item())
        with torch.no_grad():
            losses.append(loss_of(op(vals, b, c_leaf, al, be)).item())
        torch.cuda.synchronize()
        ran = launched_since(counted, marks)
        base = kernel.split("_precise")[0]
        if set(ran) != {base} or ran[base] < 2 * steps + 1:
            fail(f"{tag}: launches {ran}, expected {base} at least {2 * steps + 1} times")
        ran["sddmm"] = launches_of(sddmm_rows) - sddmm_mark
        if ran["sddmm"] != steps:
            fail(f"{tag}: {ran['sddmm']} SDDMM launches in {steps} steps, expected one a step")
        launches[kernel] = launches.get(kernel, 0) + ran[base]
        launches["sddmm"] = launches.get("sddmm", 0) + ran["sddmm"]
        if not all(l1 < l0 for l0, l1 in zip(losses, losses[1:])):
            fail(f"{tag}: the loss did not fall at every step: {losses}")

        # step 1 against f64 and the plain versions, at v0, b0 and its cotangent
        g = first["g"]
        with torch.no_grad():
            pv, pv_t = op.scatter(v0), op.scatter_t(v0)
            ab, atg = op.ab(v0, b0), op.atg(v0, g)
            ab_plain = plain_product(op.fwd_plan, pv, b0)
            atg_plain = plain_product(op.bwd_plan, pv_t, g)
        band = (0.0 if base in ("spmm_edge", "spmm_ell") or cfg.precise
                else 1.0 if base == "spmm_block" else ULP_BAR)
        diffs = [(x - y).abs().max().item() / ulp_of(y.abs().max().item())
                 for x, y in ((ab, ab_plain), (atg, atg_plain))]
        if not all(d <= band for d in diffs):
            fail(f"{tag}: kernel - plain {diffs} ulp, band {band:g}")
        csr, a_csr = csr_tensor(coo, v0.cpu().numpy())
        csr_t, a_t_csr = csr_tensor(coo.transpose(), v0.cpu().numpy())
        chk = {"AB": device_full_check(ab, csr, b0, 1.0, 0.0, None),
               "AB plain": device_full_check(ab_plain, csr, b0, 1.0, 0.0, None),
               "C": device_full_check(first["out"], csr, b0, ALPHA, BETA, c),
               "dB": device_full_check(first["db"], csr_t, g, ALPHA, 0.0, None),
               "dB plain": device_full_check(ALPHA * atg_plain, csr_t, g, ALPHA, 0.0, None)}
        ulps = {key: r["max_abs_vs_f64"] / ulp_of(r["c_max_abs"]) for key, r in chk.items()}
        # a product without C is held to ULP_BAR of its max, or where the
        # plain versions' own f32 sums reach further on these inputs, to
        # theirs; never more than a ulp past them
        near = all(ulps[key] <= max(ULP_BAR, ulps[f"{key} plain"] + ORACLE_SLACK)
                   and ulps[key] <= ulps[f"{key} plain"] + 1.0 for key in ("AB", "dB"))
        sd64 = f64_sddmm(op.rows, op.cols, g, b0)
        sd, sd_plain = op.sddmm(g, b0), sddmm_rows_ref(g, b0, op.rows, op.cols)
        sd_err = (sd - sd_plain).abs().max().item()
        diffs.append(sd_err / ulp_of(sd_plain.abs().max().item()))
        del sd, sd_plain
        tiles = op.sddmm_tiles
        reuse = tiles.codes.numel() / (tiles.slot_ptr[-1] - tiles.tile_rows.sum()).item()
        dvals64 = float(np.float32(ALPHA)) * sd64
        ulps["dvals"] = ((first["dvals"].double() - dvals64).abs().max().item()
                         / ulp_of(dvals64.abs().max().item()))
        g64 = g.double()
        dalpha64 = (v0.double() * sd64).sum().item()
        dbeta64 = (g64 * c.double()).sum().item()
        alpha_bar = 2.0**-20 * (g64 * ab.double()).abs().sum().item()
        beta_bar = 2.0**-20 * (g64 * c.double()).abs().sum().item()
        alpha_err = abs(first["dalpha"].item() - dalpha64)
        beta_err = abs(first["dbeta"].item() - dbeta64)
        dc_exact = torch.equal(first["dc"], be.detach() * g)
        ok = (near and ulps["dvals"] <= ULP_BAR and diffs[2] <= ULP_BAR and dc_exact
              and alpha_err <= alpha_bar and beta_err <= beta_bar
              and bool(torch.isfinite(first["db"]).all() and torch.isfinite(first["dvals"]).all()))

        # (d) the step and its parts on the card
        def step(_):
            opt.zero_grad()
            loss = loss_of(op(vals, b, c_leaf, al, be))
            loss.backward()
            opt.step()
            return loss.detach()

        t_step = time_chained(step, torch.zeros((), device="cuda"), rp_time=iters, warmup=1)
        fwd, bwd = op.fwd_plan, op.bwd_plan
        b_p, g_p = fwd.pad_b(b0), bwd.pad_b(g)
        image = {}
        if fwd._image:  # K1 on the tensor cores reads operand tiles
            image = {"image": slab_image(pv, cfg.block_k)}
            image_t = {"image": slab_image(pv_t, cfg.block_k)}
        else:
            image_t = {}
        ms = {"scatter": event_ms(lambda: op.scatter(v0), iters),
              "forward": event_ms(lambda: fwd._run(pv, *fwd.arrays[1:], b_p, fwd.no_c(), 1.0,
                                                   0.0, with_c=False, **image), iters),
              "A^T": event_ms(lambda: bwd._run(pv_t, *bwd.arrays[1:], g_p, bwd.no_c(), 1.0,
                                               0.0, with_c=False, **image_t), iters),
              "SDDMM": event_ms(lambda: op.sddmm(g, b0), iters),
              "SDDMM plain": event_ms(lambda: sddmm_rows_ref(g, b0, op.rows, op.cols), iters)}
        if image:
            ms["slab_image"] = event_ms(lambda: slab_image(pv, cfg.block_k), iters)
        b_t = b0.t().contiguous()
        lib = {"forward": event_ms(lambda: torch.sparse.mm(a_csr, b0), iters),
               "A^T": event_ms(lambda: torch.sparse.mm(a_t_csr, g), iters),
               "sampled_addmm": event_ms(lambda: torch.sparse.sampled_addmm(
                   a_csr, g, b_t, beta=0.0, alpha=ALPHA), iters)}
        del image, image_t
        if coo is cant:
            kernels["sddmm"] = dict(max_abs_err=sd_err, ms=ms["SDDMM"],
                                    plain_ms=ms["SDDMM plain"],
                                    **dict(zip(("bound_ms", "bound_by"),
                                               sddmm_bound(coo.nnz, m, k, n))),
                                    library_ms=lib["sampled_addmm"])
        print(f"{tag}: {fmt} ({fwd.backend}, precise={cfg.precise}) N={n} {m}x{k} "
              f"nnz={coo.nnz}{' built from zero blocks' if built is not coo else ''}; op "
              f"built in {t_build:.3f} s{scatter_exact}; losses "
              f"{' > '.join(f'{x:.6e}' for x in losses)}; step 1 vs f64: A @ B {ulps['AB']:.4f} "
              f"(plain versions {ulps['AB plain']:.4f}), dB {ulps['dB']:.4f} (plain versions "
              f"{ulps['dB plain']:.4f}), dvals "
              f"{ulps['dvals']:.4f} ulp of max (bar {ULP_BAR:g}), the op's C {ulps['C']:.4f} "
              f"(alpha AB + beta C rounded apart, as the JAX op rounds); dC "
              f"{'= beta G' if dc_exact else '!= beta G'}; dalpha {alpha_err:.3e} (bar {alpha_bar:.3e}), dbeta {beta_err:.3e} (bar "
              f"{beta_bar:.3e}); kernel - plain {diffs[0]:.4f} / {diffs[1]:.4f} ulp (band "
              f"{band:g}), SDDMM {diffs[2]:.4f} (bar {ULP_BAR:g}; {tiles.tile_rows.numel()} "
              f"tiles, B-row reuse {reuse:.3f}); [{smi}] step (time_chained: forward, "
              f"backward, Adam) {t_step * 1e3:.4f} ms; device ms: "
              + ", ".join(f"{key} {v:.4f}" for key, v in ms.items())
              + f"; library step {sum(lib.values()):.4f} ms ("
              + ", ".join(f"{key} {v:.4f}" for key, v in lib.items())
              + f"); launches {ran} {'ok' if ok else 'MISMATCH'}", flush=True)
        if not ok:
            fail(f"{tag}: {fmt} N={n}: step 1 against f64 {ulps}, kernel - plain {diffs}, "
                 f"dC {dc_exact}, dalpha "
                 f"{alpha_err:.3e} (bar {alpha_bar:.3e}), dbeta {beta_err:.3e} "
                 f"(bar {beta_bar:.3e})")

    # (a) cant_like's pattern with every value 0, through K1
    pattern = sx.COOMatrix(cant.shape, cant.rows, cant.cols, np.zeros(cant.nnz, np.float32))
    run("phase 12 cant_like", cant, pattern, "mxu", 512, slab_cfg, TRAIN_STEPS, 3)
    torch.cuda.empty_cache()
    # (b) every kernel at synthetic4704
    for fmt, n, level, zero in TRAIN_CASES:
        cfg = (slab_cfg if fmt == "mxu" else block_cfg).with_(precise=level)
        built = synth
        if zero:
            built = sx.COOMatrix(synth.shape, synth.rows, synth.cols,
                                 np.where(synth.rows < 2352, 0.0, synth.vals).astype(np.float32))
        run("phase 12 synthetic4704", synth, built, fmt, n, cfg, 1, 10)
    # (c) the example on the card
    spec = importlib.util.spec_from_file_location(
        "train_sparse_torch", ROOT / "examples" / "train_sparse_torch.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    marks = launch_marks(counted)
    t0 = time.perf_counter()
    final = example.main(["--device", "cuda"])
    torch.cuda.synchronize()
    ran = launched_since(counted, marks)
    if set(ran) != {"spmm_block"} or final >= 1e-4:
        fail(f"phase 12: the example reached loss {final:.3e}, launches {ran}")
    launches["spmm_block"] += ran["spmm_block"]
    print(f"phase 12: examples/train_sparse_torch.py on the card: 300 Adam steps, final loss "
          f"{final:.3e} (bar 1e-4) in {time.perf_counter() - t0:.2f} s; launches {ran}",
          flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing run",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    sys.path.insert(0, str(ROOT))
    import numpy as np

    import sextans_tpu_torch as sx
    from sextans_tpu_torch.ops import df32
    from sextans_tpu_torch.ops.hybrid_hub import hub_launch, hybrid_hub, hybrid_hub_ref
    from sextans_tpu_torch.ops.plan import BACKEND_FORMATS
    from sextans_tpu_torch.ops.spmm_block import block_launch, spmm_block_padded, stripe_visits
    from sextans_tpu_torch.ops.spmm_dia import (
        DIA_SPAN_MAX,
        dia_launch,
        dia_plan,
        dia_runs,
        dia_skinny_launch,
        spmm_dia,
        spmm_dia_ref,
        spmm_dia_skinny,
    )
    from sextans_tpu_torch.ops.spmm_edge import edge_launch, row_runs, spmm_edge_padded
    from sextans_tpu_torch.ops.spmm_ell import (
        ELL_VEC4_MIN_N,
        ell_launch,
        ell_tiles,
        spmm_ell_gather_padded,
    )
    from sextans_tpu_torch.ops.spmm_slab import (
        SKINNY_MAX_N,
        SKINNY_STAGES,
        SLAB_CHUNK,
        SLAB_STAGES,
        slab_image,
        slab_launch,
        slab_skinny_launch,
        slab_visits,
        spmm_slab_padded,
        spmm_slab_skinny_padded,
    )
    from sextans_tpu_torch.runtime.build import build_kernels
    from sextans_tpu_torch.utils.config import cdiv
    from sextans_tpu_torch.utils.matrices import circuit_like, fem_like, stencil_3d
    from sextans_tpu_torch.utils.profiling import launches as launches_of
    from sextans_tpu_torch.utils.timing import (
        PEAK_F32_FLOPS,
        PEAK_HBM_BYTES,
        ROUNDS,
        abba_ms,
        event_ms,
        time_repeat,
        timed_once,
    )

    def at() -> str:
        return f"(at {time.perf_counter() - t_start:.1f} s)"

    # ---- phase 0 ----
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"phase 0: python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    print(smi, flush=True)

    # ---- phase 1 ----
    t0 = time.perf_counter()
    build_kernels()
    print(f"phase 1: kernels built and loaded in {time.perf_counter() - t0:.1f} s",
          flush=True)

    block_cfg = sx.SpmmConfig()
    slab_cfg = sx.SpmmConfig(tile_m=1024, window_k=4096, block_k=128, group_blocks=8,
                             chunk_unroll=2)
    masked_cfg = sx.SpmmConfig(edge_masked=True, edge_lanes=4)
    synth = sx.COOMatrix.random(4704, 4704, 104756, seed=42, banded=True,
                                bandwidth=300)
    if synth.nnz != 104756:
        fail(f"synthetic matrix has {synth.nnz} nnz, expected 104756")

    @functools.cache  # B and C of a shape, made once (175 M normals on scircuit_like)
    def operands(m, k, n):
        rng = np.random.default_rng(0)
        b = rng.standard_normal((k, n)).astype(np.float32)
        c = rng.standard_normal((m, n)).astype(np.float32)
        return b, c

    def check_kernel(tag, coo, pl, b_dev, c_dev, iters, exact=False, rounds=ROUNDS,
                     slow_plain=False):
        """Hold ``pl``'s kernel against its plain version on the card (to
        the bit with ``exact``, and always for K4; K3 within 1 ulp) and
        time both beside the library call and the bound; at a precise
        level, also beside the same kernel in plain mode. A kernel that
        ``SpmmPlan.__call__`` hands B and C in place (K1, K2, K4, K5) runs on
        the padded shapes and on those, and is timed on the latter."""
        n = pl.n
        b_p, c_p = pl.pad_b(b_dev), pl.pad_c(c_dev)
        name, run_kernel, run_plain = kernel_calls(pl, n)
        got = run_kernel(b_p, c_p)
        want, plain_ms = timed_once(lambda: run_plain(b_p, c_p))
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        ulps = (0.0 if exact or name in ("spmm_edge", "spmm_ell") else 1.0
                if name == "spmm_block" else ULP_BAR)
        tol = ulps * float(np.spacing(np.float32(want.abs().max().item())))
        ok = bool(torch.isfinite(got).all().item()) and err <= tol
        # the kernel as SpmmPlan.__call__ launches it: the caller's (K, N) B
        # and (M, N) C and an (M, N) output, to the bit against the padded
        # call's real rows and against its plain version on the same shapes
        # at the same bar; timed as "kernel"
        b_m, c_m = pl.operands(b_dev, c_dev) if pl._in_place else (b_p, None)
        if c_m is not None:
            got_m, want_m = run_kernel(b_m, c_m), run_plain(b_m, c_m)
            ok = ok and (tuple(got_m.shape) == tuple(want_m.shape) == (pl.m, n)
                         and torch.equal(got_m, got[: pl.m])
                         and bool(torch.isfinite(got_m).all().item())
                         and (got_m - want_m).abs().max().item() <= tol)
            del got_m, want_m
        del got, want
        library = library_call(coo)
        fns = {"plain": lambda: run_plain(b_p, c_p), "kernel": lambda: run_kernel(b_p, c_p),
               "library": lambda: library(b_dev, c_dev)}
        if c_m is not None:
            fns["padded"] = fns["kernel"]
            fns["kernel"] = lambda: run_kernel(b_m, c_m)
        if slow_plain:  # timed once, above
            del fns["plain"]
        if pl.packed.config.precise:
            run_mode0 = kernel_calls(pl, n, precise=0)[1]
            fns["mode0"] = lambda: run_mode0(b_m, c_p if c_m is None else c_m)
        ms = {"plain": plain_ms, **abba_ms(fns, iters, rounds)}
        bound_ms, bound_by = bound(coo.nnz, *coo.shape, n)
        mode0 = (f" (plain mode {ms['mode0']:.4f} ms, x{ms['kernel'] / ms['mode0']:.2f})"
                 if "mode0" in ms else "")
        if "padded" in ms:
            mode0 += (f" on (K, N) B and (M, N) C and out, to the bit against the padded "
                      f"call and within the bar against its plain version (padded B, C and "
                      f"out {ms['padded']:.4f} ms)")
        grid = ""
        if name in ("spmm_block", "spmm_edge"):
            go = (block_launch(n, pl.packed.m_padded // 8) if name == "spmm_block"
                  else edge_launch(n, pl.packed.m_padded))
            grid = (f" [{go.lanes} lanes x {go.cols} columns an owner, {go.threads} threads "
                    f"a CTA, grid {go.grid[0]} x {go.grid[1]} = {go.grid[0] * go.grid[1]} CTAs]")
        elif name == "spmm_slab_skinny":
            go = slab_skinny_launch(n, pl.packed.m_padded // 128, pl.packed.config.block_k)
            blocks = np.diff(pl.ranges[0].cpu().numpy())
            grid = (f" [grid {go.grid[0]} CTAs (half a slab each; {int((blocks > 0).sum())} of "
                    f"{blocks.size} slabs hold blocks, at most {int(blocks.max(initial=0))}), "
                    f"{go.threads} threads a CTA, {SKINNY_STAGES} stages, {go.smem} bytes of "
                    f"shared memory a CTA]")
        elif name == "spmm_slab":
            cfg = pl.packed.config
            go = slab_launch(n, pl.packed.m_padded // 128, cfg.block_k, cfg.precise)
            blocks = np.diff(pl.ranges[0].cpu().numpy())
            grid = (f" [{'FFMA' if cfg.precise else '3xTF32 on the tensor cores'}: grid "
                    f"{go.grid[0]} CTAs of {go.lanes} rows x {go.cols} columns "
                    f"({int((blocks > 0).sum())} of {blocks.size} slabs hold blocks, at most "
                    f"{int(blocks.max(initial=0))}), {go.threads} threads a CTA, {SLAB_STAGES} "
                    f"stages of {min(SLAB_CHUNK, cfg.block_k)} terms, {go.smem} bytes of "
                    f"shared memory a CTA]")
        elif name == "spmm_ell":
            tiles = pl.ranges
            go = ell_launch(n, 4 if n >= ELL_VEC4_MIN_N and n % 4 == 0 else 1,
                            tiles.tile_ptr.numel() - 1)
            grid = (f" [{go.grid[0]} CTAs of {go.threads} threads, {go.lanes} lanes x "
                    f"{go.cols} columns a tile, {tiles.tile_ptr.numel() - 1} tiles of up to "
                    f"{tiles.group_max} logical rows, {tiles.long_rows.numel()} long rows]")
        print(f"{tag}: {name} ({pl.backend}, precise={pl.packed.config.precise}) N={n}{grid}: "
              f"max_abs_err vs plain {err:.3e} (tol {tol:.3e}) kernel {ms['kernel']:.4f} ms"
              f"{mode0} plain {ms['plain']:.4f} ms "
              f"torch.sparse.addmm {ms['library']:.4f} ms bound {bound_ms:.5f} ms "
              f"({bound_by}) {'ok' if ok else 'MISMATCH'} {at()}", flush=True)
        if not ok:
            fail(f"{tag}: {name} at N={n} disagrees with its plain version")
        return name, dict(max_abs_err=err, ms=ms["kernel"], plain_ms=ms["plain"],
                          bound_ms=bound_ms, bound_by=bound_by,
                          library_ms=ms["library"])

    # ---- phase 2: kernel vs plain version on the card ----
    kernels = {}
    packs = {"pallas": sx.pack(synth, block_cfg), "mxu": sx.pack_mxu(synth, slab_cfg),
             "edge": sx.pack_edge(synth, block_cfg),
             "edge_masked": sx.pack_edge(synth, masked_cfg),
             "ell_pallas": sx.pack_ell(synth, block_cfg)}
    cases = [("pallas", "pallas", 512), ("pallas", "pallas", 16), ("mxu", "mxu", 512),
             ("mxu", "mxu", 16), ("edge", "edge", 512), ("edge_masked", "edge", 16),
             ("ell_pallas", "ell_pallas", 512), ("ell_pallas", "ell_pallas", 16)]
    for pack_key, backend, n in cases:
        pl = sx.plan(packs[pack_key], n, backend, device="cuda")
        b, c = operands(*synth.shape, n)
        name, row = check_kernel(
            f"phase 2 ({pack_key})", synth, pl, torch.as_tensor(b, device="cuda"),
            torch.as_tensor(c, device="cuda"), iters=10)
        kernels.setdefault(name, row)  # the first (N = 512 where run there) row
    del packs

    def check_dia(tag, split, n, iters, rounds=ROUNDS, slow_plain=False, precise=0):
        """Hold the DIA kernel of N against its plain version on the card (to
        the bit, K6 and K7 in every mode) and time both beside
        the library call on the diagonal part and the bound of the DIA work;
        at a precise level, also beside the same kernel in plain mode."""
        wide = n > SKINNY_MAX_N
        name = "spmm_dia" if wide else "spmm_dia_skinny"
        m, k = split.m, split.k
        dv = torch.as_tensor(split.diag_vals, device="cuda")
        offs = torch.as_tensor(split.diag_offsets.astype(np.int32), device="cuda")
        b, c = (torch.as_tensor(x, device="cuda") for x in operands(m, k, n))
        # K6 and K7 walk their run plan, made once as HybridSpmmPlan makes it
        runs = dia_plan(split.diag_offsets, "cuda")
        offs = runs.offsets
        go = (dia_launch(n, m, runs, 4 if n % 4 == 0 else 1) if wide
              else dia_skinny_launch(n, m, runs))
        rows, cols = (64, go.lanes * go.cols) if wide else (go.lanes, n)
        grid = (f" [{runs.ptr.numel() - 1} runs (span <= {runs.span}, <= {runs.length} "
                f"diagonals), tiles of {rows} rows x {cols} columns: grid {go.grid[0]} CTAs "
                f"of {go.threads} threads, {go.smem} bytes of shared memory a CTA]")
        kernel = functools.partial(spmm_dia if wide else spmm_dia_skinny, runs=runs)
        got = kernel(dv, offs, b, c, ALPHA, BETA, precise=precise)
        want, plain_ms = timed_once(
            lambda: spmm_dia_ref(dv, offs, b, c, ALPHA, BETA, precise=precise))
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        tol = 0.0  # K6 and K7 take the plain version's roundings in its order
        ok = bool(torch.isfinite(got).all().item()) and err <= tol
        del got, want
        d_idx, rows = np.nonzero(split.diag_vals)
        diag_coo = sx.COOMatrix((m, k), rows, rows + split.diag_offsets[d_idx],
                                split.diag_vals[d_idx, rows])
        library = library_call(diag_coo)
        fns = {"kernel": lambda: kernel(dv, offs, b, c, ALPHA, BETA, precise=precise),
               "plain": lambda: spmm_dia_ref(dv, offs, b, c, ALPHA, BETA, precise=precise),
               "library": lambda: library(b, c)}
        if slow_plain:  # timed once, above
            del fns["plain"]
        if precise:
            fns["mode0"] = lambda: kernel(dv, offs, b, c, ALPHA, BETA)
        ms = {"plain": plain_ms, **abba_ms(fns, iters, rounds)}
        n_diags = split.diag_offsets.size
        bound_ms, bound_by = dia_bound(n_diags, m, k, n)
        mode0 = (f" (plain mode {ms['mode0']:.4f} ms, x{ms['kernel'] / ms['mode0']:.2f})"
                 if precise else "")
        print(f"{tag}: {name} precise={precise} N={n} D={n_diags} ({diag_coo.nnz} nnz on the "
              f"diagonals){grid}: max_abs_err vs plain {err:.3e} (tol {tol:.3e}) kernel "
              f"{ms['kernel']:.4f} ms{mode0} plain {ms['plain']:.4f} ms torch.sparse.addmm "
              f"{ms['library']:.4f} ms bound {bound_ms:.5f} ms ({bound_by}) "
              f"{'ok' if ok else 'MISMATCH'} {at()}", flush=True)
        if not ok:
            fail(f"{tag}: {name} precise={precise} at N={n} disagrees with its plain version")
        return name, dict(max_abs_err=err, ms=ms["kernel"], plain_ms=ms["plain"],
                          bound_ms=bound_ms, bound_by=bound_by, library_ms=ms["library"])

    def check_hub(tag, split, n, iters, rounds=ROUNDS):
        """Hold the hub kernel of the plain hybrid step (``csrc/hybrid_hub.cu``)
        against its plain version on the card, to the bit, on the DIA
        kernel's output with C, plain and compensated (the precise step's
        sums); time the plain one and its plain version beside its bound and
        the dense
        composition it replaces (the head-column and hub-row f32 GEMMs over
        the split's planes, B's gather, ``acc + alpha * head`` and
        ``index_add_``: the ``"xla"`` plan's own ``_add_hubs``)."""
        m, k = split.m, split.k
        b, c = (torch.as_tensor(x, device="cuda") for x in operands(m, k, n))
        pl = sx.HybridSpmmPlan(split, n, residue_config=block_cfg, backend="pallas",
                               device="cuda")
        lists = pl._hub
        acc = pl._dia(pl._dvals, pl._offsets, b, c, ALPHA, BETA, **pl._dia_kw)
        before = launches_of(hybrid_hub)
        got = hybrid_hub(acc.clone(), b, ALPHA, lists)
        want, plain_ms = timed_once(lambda: hybrid_hub_ref(acc.clone(), b, ALPHA, lists))
        torch.cuda.synchronize()
        ran = launches_of(hybrid_hub) - before
        err = (got - want).abs().max().item()
        ok = ran == 1 and bool(torch.isfinite(got).all().item()) and torch.equal(got, want)
        got = hybrid_hub(acc.clone(), b, ALPHA, lists, precise=1)
        want = hybrid_hub_ref(acc.clone(), b, ALPHA, lists, precise=1)
        err_precise = (got - want).abs().max().item()
        ok = ok and bool(torch.isfinite(got).all().item()) and torch.equal(got, want)
        del got, want
        xla = sx.HybridSpmmPlan(split, n, residue_config=block_cfg, backend="pallas",
                                dia_backend="xla", device="cuda")
        work = acc.clone()
        ms = {"plain": plain_ms, **abba_ms(
            {"kernel": lambda: hybrid_hub(work, b, ALPHA, lists),
             # a new (M, N) sum where the split has head columns, as here
             "dense": lambda: xla._add_hubs(acc, b, ALPHA)}, iters, rounds)}
        del xla
        hub_entries = split.head_row_nnz
        bound_ms, bound_by = hub_bound(split, lists.entries, lists.jobs, n)
        go = hub_launch(n, lists, 4 if n % 4 == 0 else 1)
        print(f"{tag}: hybrid_hub N={n}: {lists.entries} entries ({split.head_nnz} in "
              f"{split.head_cols.size} head columns, {hub_entries} in {lists.n_hub} hub rows) "
              f"over {lists.jobs} rows [grid {go.grid[0]} CTAs of {go.threads} threads, "
              f"{lists.n_hub} x {cdiv(n, 32 * go.cols)} hub CTAs first]: launches {ran}, "
              f"max_abs_err vs plain {err:.3e}, compensated {err_precise:.3e} (tol 0) "
              f"kernel {ms['kernel']:.4f} ms plain "
              f"{ms['plain']:.4f} ms the dense GEMMs and adds {ms['dense']:.4f} ms bound "
              f"{bound_ms:.5f} ms ({bound_by}) {'ok' if ok else 'MISMATCH'} {at()}", flush=True)
        if not ok:
            fail(f"{tag}: hybrid_hub at N={n} disagrees with its plain version "
                 f"(launches {ran})")
        return "hybrid_hub", dict(max_abs_err=err, ms=ms["kernel"], plain_ms=ms["plain"],
                                  bound_ms=bound_ms, bound_by=bound_by,
                                  library_ms=ms["dense"])

    for n in (512, 16):
        name, row = check_dia("phase 2 (dia)", sx.split_structure(synth, n=n), n, iters=10)
        kernels[name] = row
    name, row = check_hub("phase 2 (hub)", sx.split_structure(synth, n=512), 512, iters=10)
    kernels[name] = row
    print(f"phase 2: done (at {time.perf_counter() - t_start:.1f} s)", flush=True)

    # ---- phases 3 and 4: the main path ----
    counted = {"spmm_block": spmm_block_padded, "spmm_slab": spmm_slab_padded,
               "spmm_slab_skinny": spmm_slab_skinny_padded,
               "spmm_edge": spmm_edge_padded, "spmm_ell": spmm_ell_gather_padded,
               "spmm_dia": spmm_dia, "spmm_dia_skinny": spmm_dia_skinny,
               "hybrid_hub": hybrid_hub}
    launches = dict.fromkeys(counted, 0)
    goldens = {}

    def golden(tag, coo, n):
        if (tag, n) not in goldens:
            b, c = operands(*coo.shape, n)
            csr = sx.CSRMatrix.from_coo(coo)
            goldens[tag, n] = (b, c, sx.golden_spmm(csr, b, ALPHA, BETA, c),
                               sx.golden_spmm_exact(csr, b, ALPHA, BETA, c))
        return goldens[tag, n]

    runs = {}  # (matrix, backend, N, precise) -> (ulp, time_repeat s)
    dev_goldens = {}

    def accuracy(key, got_dev, hub_rows=None):
        """``got_dev`` against the f64 oracle of ``goldens[key]``, on the
        card (the oracle and its f32 floor are uploaded once): max-abs error,
        the same in ulp of max|C|, and outside ``hub_rows``; the elements
        above their own f32 floor (off the f32 nearest to their f64 value);
        whether all are finite; and the worst element's row."""
        if key not in dev_goldens:
            exact = torch.as_tensor(goldens[key][3], device="cuda")
            floor = (exact.float().double() - exact).abs()
            unit = float(np.spacing(np.float32(exact.abs().max().item())))
            dev_goldens[key] = exact, floor, unit
        exact, floor, unit = dev_goldens[key]
        err = (got_dev.double() - exact).abs()
        max_abs = err.max().item()
        out = dict(max_abs=max_abs, ulp=max_abs / unit,
                   above=int((err > floor).sum().item()),
                   finite=bool(torch.isfinite(got_dev).all().item()),
                   worst=int(err.argmax().item()) // err.shape[1])
        if hub_rows is not None and len(hub_rows):
            err[torch.as_tensor(hub_rows, dtype=torch.int64, device="cuda")] = 0.0
        out["rest"] = err.max().item() / unit
        return out

    def drive(tag, coo, backend, n, times, cfg=None, bar=ULP_BAR, tally=None, packed=None):
        b, c, ref, exact = golden(tag.split()[-1], coo, n)
        cfg = cfg or (slab_cfg if backend == "mxu" else block_cfg)
        tally = launches if tally is None else tally
        t0 = time.perf_counter()
        reused = packed is not None  # an earlier run's pack of the same matrix
        packed = packed if reused else BACKEND_FORMATS[backend][0](coo, cfg)
        t_pack = time.perf_counter() - t0
        marks = launch_marks(counted)
        t0 = time.perf_counter()
        pl = sx.plan(packed, n, backend, device="cuda")
        t_plan = time.perf_counter() - t0
        scan, scan_note = {"pallas": stripe_visits, "edge": row_runs,
                           "mxu": slab_visits}.get(backend), ""
        if pl.image is not None:  # K1's operand tiles, made once at upload, made again alone
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            image = slab_image(pl.arrays[0], cfg.block_k)
            torch.cuda.synchronize()
            scan_note += (f"; slab_image {time.perf_counter() - t0:.4f} s on the card, "
                          f"{image.nbytes / 1e6:.3f} MB")
            del image
        if scan is not None:  # the scan alone, again (the plan memoises its upload)
            t0 = time.perf_counter()
            lists = scan(packed)
            t_scan = time.perf_counter() - t0
            # the longest list: the most visits of one stripe, slots of one
            # row, blocks of one slab
            owner = np.repeat(np.arange(lists[0].size - 1), np.diff(lists[0]))
            work = lists[2] - lists[1] + 1.0 if backend == "edge" else np.ones(owner.size)
            longest = int(np.bincount(owner, weights=work).max(initial=0))
            unit, items = {"pallas": ("stripe", "visits"), "edge": ("row", "slots"),
                           "mxu": ("slab", "blocks")}[backend]
            scan_note = (f"{scan_note}; {scan.__name__} {t_scan:.4f} s, "
                         f"{sum(r.nbytes for r in pl.ranges) / 1e6:.3f} MB, longest "
                         f"{unit} {longest} {items}")
        if backend == "ell_pallas":  # K5's tiles, made at upload, made again alone
            t0 = time.perf_counter()
            tiles = ell_tiles(packed)
            t_scan = time.perf_counter() - t0
            size = np.diff(tiles.tile_ptr)
            scan_note = (f"; ell_tiles {t_scan:.4f} s, "
                         f"{sum(r.nbytes for r in pl.ranges[:-1]) / 1e6:.3f} MB, "
                         f"{size.size} tiles of {tiles.members.mean():.2f} logical rows on "
                         f"average (group_max {tiles.group_max}), largest {int(size.max())} "
                         f"padded rows, {tiles.long_rows.size} long rows")
        expected = None if backend == "ell" else kernel_calls(pl, n)[0]
        before = launched_since(counted, marks).get(expected, 0)
        got_dev = pl(b, ALPHA, BETA, c)
        one = launched_since(counted, marks).get(expected, 0) - before
        # K5 folds the logical rows that outgrow a tile in a second launch
        want_one = 1 + (backend == "ell_pallas" and pl.ranges.long_rows.numel() > 0)
        if expected and one != want_one:
            fail(f"{tag} {backend} N={n}: one product made {one} launches of {expected}, "
                 f"expected {want_one}")
        res = sx.verify(ref, got_dev.cpu().numpy())  # the host gate, before any timing
        b_dev = torch.as_tensor(b, device=pl.device)
        c_dev = torch.as_tensor(c, device=pl.device)
        t = statistics.median(time_repeat(pl, b_dev, ALPHA, BETA, c_dev, times=times)
                              for _ in range(3))
        # the ell engine is plain PyTorch by design: it launches no kernel
        traced = (profile(pl, b_dev, c_dev, (expected,)) if expected
                  else "no kernel (plain PyTorch engine)")
        torch.cuda.synchronize()
        ran = launched_since(counted, marks)
        if set(ran) != ({expected} if expected else set()):
            fail(f"{tag} {backend} N={n}: launches {ran}, expected {expected} only")
        for name, count in ran.items():
            tally[name] = tally.get(name, 0) + count
        acc = accuracy((tag.split()[-1], n), got_dev)
        max_abs, ulp, above = acc["max_abs"], acc["ulp"], acc["above"]
        runs[tag.split()[-1], backend, n, int(cfg.precise)] = (ulp, t)
        m = coo.shape[0]
        ok = res.passed and ulp <= bar and acc["finite"] and tuple(got_dev.shape) == (m, n)
        pack_mb = sum(a.nbytes for a in pl.arrays + tuple(pl.ranges or ())
                      + ((pl.image,) if pl.image is not None else ())
                      if isinstance(a, torch.Tensor)) / 1e6
        shape = (f"R={packed.slots_per_row}, {packed.n_virt} virtual rows"
                 if backend in ("ell", "ell_pallas") else f"{packed.stats.groups} groups")
        print(f"{tag}: {backend} precise={cfg.precise} N={n} {coo.shape[0]}x{coo.shape[1]} "
              f"nnz={coo.nnz} verify {'Success!' if res.passed else 'Failed.'} "
              f"({res.mismatch_percent:.2f}% mismatches) max_abs_vs_f64 "
              f"{max_abs:.3e} = {ulp:.4f} ulp of max|C| (bar {bar:g}), {above} of "
              f"{got_dev.numel()} elements above their f32 floor; kernel {t * 1e3:.4f} ms "
              f"GFLOPS {sx.gflops(coo.nnz, m, n, t):.1f}; pack "
              f"{'reused' if reused else f'{t_pack:.3f} s'} "
              f"{pack_mb:.2f} MB on the card, {packed.stats.slots} slots "
              f"({100 * packed.stats.block_fill:.1f} % filled, {shape}); plan with upload "
              f"{t_plan:.4f} s{scan_note}; {traced}; "
              f"launches {ran} {at()}", flush=True)
        if not ok:
            fail(f"{tag} {backend} precise={cfg.precise} N={n}: verify {res.passed}, "
                 f"{ulp:.4f} ulp (bar {bar:g})")
        return pl, b_dev, c_dev, ran

    with tempfile.TemporaryDirectory() as tmp:
        mtx = Path(tmp) / "synthetic4704.mtx"
        sx.write_mtx(mtx, synth)
        coo = sx.read_mtx(mtx)
        if coo.nnz != synth.nnz or coo.shape != synth.shape:
            fail("write_mtx/read_mtx round trip changed the matrix")
        for backend in ("pallas", "mxu", "edge", "ell_pallas"):
            for n in (512, 16):
                drive("phase 3 synthetic4704", coo, backend, n, times=10)

        t0 = time.perf_counter()
        cant = fem_like(62451, dofs=3, neighbors=21, seed=2)
        if cant.nnz != 3781404:
            fail(f"cant_like has {cant.nnz} nnz, expected 3781404")
        print(f"phase 4: cant_like built in {time.perf_counter() - t0:.1f} s "
              f"(at {time.perf_counter() - t_start:.1f} s)", flush=True)
        for backend in ("pallas", "mxu", "edge", "ell_pallas"):
            pl, b_dev, c_dev, _ = drive("phase 4 cant_like", cant, backend, 512, times=10)
            check_kernel("phase 4 cant_like", cant, pl, b_dev, c_dev, iters=1, rounds=2,
                         slow_plain=True)
            if backend == "mxu":  # K2 at full width, on the same pack
                packed = pl.packed
                del pl, b_dev, c_dev
                pl, b_dev, c_dev, _ = drive("phase 4 cant_like", cant, "mxu", 16, times=10,
                                            packed=packed)
                check_kernel("phase 4 cant_like", cant, pl, b_dev, c_dev, iters=1, rounds=2,
                             slow_plain=True)
                del packed
            del pl, b_dev, c_dev
            torch.cuda.empty_cache()

        # ---- phase 5: the hybrid path ----
        splits = {}

        rest_ulps = {}  # (matrix, N, precise) -> ulp of max|C| outside the hub rows

        def drive_hybrid(tag, coo, n, times, bar, time_dia=False, precise=0, tally=None,
                         rest_bar=None):
            name_ = tag.split()[-1]
            b, c, ref, exact = golden(name_, coo, n)
            if (name_, n) not in splits:  # phase 9 runs phase 5's splits again
                t0 = time.perf_counter()
                splits[name_, n] = sx.split_structure(coo, n=n), time.perf_counter() - t0
            split, t_split = splits[name_, n]
            marks = launch_marks(counted)
            pl = sx.HybridSpmmPlan(split, n, residue_config=block_cfg, backend="pallas",
                                   precise=precise, device="cuda")
            runs_note = ""
            if pl._runs is not None:  # K6's run plan, made again alone
                t0 = time.perf_counter()
                ptr = dia_runs(split.diag_offsets, DIA_SPAN_MAX)
                runs_note = (f"; dia_runs {time.perf_counter() - t0:.5f} s, {ptr.nbytes} bytes, "
                             f"{ptr.size - 1} runs (span <= {pl._runs.span})")
            got_dev = pl(b, ALPHA, BETA, c)
            res = sx.verify(ref, got_dev.cpu().numpy())  # the host gate, before any timing
            b_dev = torch.as_tensor(b, device=pl.device)
            c_dev = torch.as_tensor(c, device=pl.device)
            t = statistics.median(time_repeat(pl, b_dev, ALPHA, BETA, c_dev, times=times)
                                  for _ in range(3))
            dia = "spmm_dia_skinny" if n <= SKINNY_MAX_N else "spmm_dia"
            expected = ({dia} | ({"spmm_block"} if pl.residue_plan else set())
                        | ({"hybrid_hub"} if any(h.jobs for h in pl.hub_passes) else set()))
            traced = profile(pl, b_dev, c_dev, tuple(expected))
            torch.cuda.synchronize()
            ran = launched_since(counted, marks)
            if set(ran) != expected:
                fail(f"{tag} hybrid N={n}: launches {ran}, expected {sorted(expected)}")
            tally = launches if tally is None else tally
            for name, count in ran.items():
                tally[name] = tally.get(name, 0) + count
            acc = accuracy((name_, n), got_dev, hub_rows=split.head_rows)
            ulp, rest, above, worst = acc["ulp"], acc["rest"], acc["above"], acc["worst"]
            m = coo.shape[0]
            runs[name_, "hybrid", n, precise] = (ulp, t)
            rest_ulps[name_, n, precise] = rest
            ok = res.passed and ulp <= bar and acc["finite"] and tuple(got_dev.shape) == (m, n) \
                and (rest_bar is None or rest <= rest_bar)
            mb = pl.nbytes / 1e6
            print(f"{tag}: hybrid precise={precise} N={n} {coo.shape[0]}x{coo.shape[1]} "
                  f"nnz={coo.nnz} {split.summary()} in {t_split:.3f} s, {mb:.2f} MB on the "
                  f"card{runs_note}; verify {'Success!' if res.passed else 'Failed.'} "
                  f"({res.mismatch_percent:.2f}% mismatches) max_abs_vs_f64 "
                  f"{acc['max_abs']:.3e} = {ulp:.4f} ulp of max|C| ({rest:.4f} outside the hub "
                  f"rows), {above} of {got_dev.numel()} elements above their f32 floor (bar {bar:g}"
                  f"{'' if rest_bar is None else f', {rest_bar:g} outside the hub rows'}; "
                  f"worst in row {worst}, "
                  f"{'a hub row' if worst in set(split.head_rows.tolist()) else 'not a hub row'}"
                  f"); time_repeat {t * 1e3:.4f} ms GFLOPS {sx.gflops(coo.nnz, m, n, t):.1f}; "
                  f"{traced}; launches {ran} {at()}", flush=True)
            if not ok:
                fail(f"{tag} hybrid precise={precise} N={n}: verify {res.passed}, "
                     f"{ulp:.4f} ulp (bar {bar}), {rest:.4f} outside the hub rows "
                     f"(bar {rest_bar})")
            del pl, b_dev, c_dev, got_dev
            torch.cuda.empty_cache()
            if time_dia:  # the DIA kernel alone, beside its plain version and the library
                check_dia(tag, split, n, iters=1, rounds=2, slow_plain=True)
                torch.cuda.empty_cache()
                if split.head_cols.size or split.head_rows.size:  # and the hub pass
                    check_hub(tag, split, n, iters=5, rounds=2)
                    torch.cuda.empty_cache()

        for n in (512, 16):
            drive_hybrid("phase 5 synthetic4704", coo, n, times=20, bar=ULP_BAR)
        t0 = time.perf_counter()
        scircuit = circuit_like(170998, seed=9)
        laplace = stencil_3d(64, seed=12)
        if (scircuit.nnz, laplace.nnz) != (906267, 1826686):
            fail(f"scircuit_like / laplace3d_64 have {scircuit.nnz} / {laplace.nnz} nnz")
        print(f"phase 5: scircuit_like and laplace3d_64 built in "
              f"{time.perf_counter() - t0:.1f} s (at {time.perf_counter() - t_start:.1f} s)",
              flush=True)
        drive_hybrid("phase 5 scircuit_like", scircuit, 512, times=10, bar=HUB_ULP_BAR,
                     time_dia=True)
        drive_hybrid("phase 5 laplace3d_64", laplace, 16, times=10, bar=ULP_BAR,
                     time_dia=True)
        # K5 on scircuit_like's 40 hub rows, which outgrow a tile: their
        # virtual rows past M go through the kernel's scratch to the long fold
        pl, b_dev, c_dev, _ = drive("phase 5 scircuit_like", scircuit, "ell_pallas", 512,
                                    times=5, bar=HUB_ULP_BAR)
        if not pl.ranges.long_rows.numel():
            fail("phase 5 scircuit_like: the ELL pack has no long rows")
        check_kernel("phase 5 scircuit_like", scircuit, pl, b_dev, c_dev, iters=1, exact=True,
                     rounds=2, slow_plain=True)
        del pl, b_dev, c_dev
        torch.cuda.empty_cache()

        print(f"phase 3-5: launches on the main paths {launches} (at "
              f"{time.perf_counter() - t_start:.1f} s)", flush=True)
        if min(launches.values()) == 0:
            fail(f"a kernel of the main path never launched: {launches}")

        # ---- phase 6: the CLI, one process per run, all at once ----
        env = dict(os.environ)
        env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
        cli_runs = {f"--backend {backend}": ["--backend", backend]
                    for backend in ("mxu", "edge", "ell_pallas")}
        cli_runs["--hybrid --backend pallas"] = ["--hybrid", "--backend", "pallas"]
        for backend in ("pallas", "mxu", "edge", "ell_pallas"):
            cli_runs[f"--precise --backend {backend}"] = ["--precise", "--backend", backend]
        cli_runs["--precise --hybrid --backend pallas"] = ["--precise", "--hybrid",
                                                           "--backend", "pallas"]
        procs = {
            label: subprocess.Popen(
                [sys.executable, "-m", "sextans_tpu_torch", str(mtx), "16", *flags],
                cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)
            for label, flags in cli_runs.items()
        }
        for label, proc in procs.items():
            try:
                out, err = proc.communicate(timeout=600)
            except subprocess.TimeoutExpired:
                for p in procs.values():
                    p.kill()
                fail(f"CLI {label} did not finish")
            last = [ln for ln in out.splitlines() if ln.strip()][-3:]
            print(f"phase 6: CLI {label} rc={proc.returncode}: "
                  f"{' | '.join(last)}", flush=True)
            if proc.returncode != 0 or "Success!" not in out:
                fail(f"CLI {label} did not succeed:\n{out}\n{err}")

        # ---- phase 7: the EFT probe (P3's twin) ----
        probe = {"df32_probe_pairs": df32.eft_probe_pairs,
                 "df32_probe_chain": df32.eft_probe_chain}
        a, b, v, bb = df32.probe_inputs(0)
        ta, tb, tv, tbb = (torch.as_tensor(x, device="cuda") for x in (a, b, v, bb))
        marks = launch_marks(probe)
        pairs, chain = df32.eft_probe_pairs(ta, tb), df32.eft_probe_chain(tv, tbb)
        torch.cuda.synchronize()
        ran = launched_since(probe, marks)
        probe_launches = {name: ran.get(name, 0) for name in probe}
        if min(probe_launches.values()) == 0:
            fail(f"phase 7: a probe kernel never launched: {probe_launches}")
        report = df32.probe_report(a, b, v, bb, [x.cpu().numpy() for x in pairs],
                                   chain.cpu().numpy())
        print(f"phase 7: EFT probe on the card: {report}; launches {probe_launches}",
              flush=True)
        if (report["two_sum_violations"] or report["two_prod_violations"]
                or report["add_mismatches"] or report["mul_mismatches"]
                or report["chain_above_floor"] or report["chain_excess"] > 0):
            fail(f"phase 7: nvcc broke an error-free transform: {report}")
        probe_calls = {
            "df32_probe_pairs": ((lambda: df32.eft_probe_pairs(ta, tb)),
                                 (lambda: df32.eft_probe_pairs_ref(ta, tb)),
                                 # a, b in; s, e, p, pe out; two_sum 6 ops, two_prod 3
                                 24 * a.size, 9 * a.size),
            "df32_probe_chain": ((lambda: (df32.eft_probe_chain(tv, tbb),)),
                                 (lambda: (df32.eft_probe_chain_ref(tv, tbb),)),
                                 # v, bb in; one f32 a column out; two_prod + acc_step
                                 # 10 ops a term, the epilogue 6 a column
                                 8 * v.size + 4 * v.shape[1], 10 * v.size + 6 * v.shape[1]),
        }
        for name, (run_kernel, run_plain, nbytes, nops) in probe_calls.items():
            got, want = run_kernel(), run_plain()
            torch.cuda.synchronize()
            err = max((g - w).abs().max().item() for g, w in zip(got, want))
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                fail(f"phase 7: {name} differs from its plain version by {err:.3e}")
            ms = abba_ms({"plain": run_plain, "kernel": run_kernel}, iters=20)
            byte_ms = nbytes / PEAK_HBM_BYTES * 1e3
            flop_ms = nops / PEAK_F32_FLOPS * 1e3
            kernels[name] = dict(max_abs_err=err, ms=ms["kernel"], plain_ms=ms["plain"],
                                 bound_ms=max(byte_ms, flop_ms),
                                 bound_by="operations" if flop_ms > byte_ms else "bytes",
                                 library_ms=None)
            launches[name] = probe_launches[name]
            print(f"phase 7: {name}: kernel - plain 0 (to the bit); kernel {ms['kernel']:.4f} ms "
                  f"plain {ms['plain']:.4f} ms bound {kernels[name]['bound_ms']:.7f} ms "
                  f"({kernels[name]['bound_by']})", flush=True)

        # ---- phase 8: precise levels on the main path ----
        print(f"phase 8: precise levels (at {time.perf_counter() - t_start:.1f} s)", flush=True)
        for n in (512, 16):
            for backend in ("pallas", "edge", "mxu"):
                for level in (1, 2):
                    base = (slab_cfg if backend == "mxu"
                            else masked_cfg if backend == "edge" and n <= SKINNY_MAX_N
                            else block_cfg)
                    bar = (min(SLAB_PRECISE_BAR, runs["synthetic4704", "mxu", n, 0][0])
                           if backend == "mxu" else PRECISE_BAR[level])
                    tally = {}
                    pl, b_dev, c_dev, ran = drive(
                        "phase 8 synthetic4704", coo, backend, n, times=5,
                        cfg=base.with_(precise=level), bar=bar, tally=tally)
                    name, row = check_kernel("phase 8 synthetic4704", synth, pl, b_dev, c_dev,
                                             iters=3, exact=backend != "mxu", rounds=2,
                                             slow_plain=True)
                    variant = f"{name}_precise{level}"
                    kernels.setdefault(variant, row)
                    launches[variant] = launches.get(variant, 0) + tally[name]
                    del pl, b_dev, c_dev
        for backend, level in (("pallas", 2), ("edge", 2), ("mxu", 1)):
            bar = (min(SLAB_PRECISE_BAR, runs["cant_like", "mxu", 512, 0][0])
                   if backend == "mxu" else PRECISE_BAR[level])
            tally = {}
            base = slab_cfg if backend == "mxu" else block_cfg
            pl, b_dev, c_dev, ran = drive("phase 8 cant_like", cant, backend, 512, times=5,
                                          cfg=base.with_(precise=level), bar=bar, tally=tally)
            name = kernel_calls(pl, 512)[0]
            launches[f"{name}_precise{level}"] += tally[name]
            ulp0, t0_ = runs["cant_like", backend, 512, 0]
            ulp1, t1_ = runs["cant_like", backend, 512, level]
            print(f"phase 8 cant_like: {name} precise={level}: {ulp1:.4f} ulp against "
                  f"{ulp0:.4f} in plain mode; time_repeat {t1_ * 1e3:.4f} ms against "
                  f"{t0_ * 1e3:.4f} ms (phase 4), x{t1_ / t0_:.2f}", flush=True)
            del pl, b_dev, c_dev
            torch.cuda.empty_cache()

        # ---- phase 9: precise ELL, DIA and hybrid ----
        # K5, K6 and K7 have one precise variant (levels 1 and 2 are one
        # computation): its launches and rows go under "<kernel>_precise1";
        # the hybrid's residue runs K3 at level 1
        print(f"phase 9: precise ELL, DIA and hybrid (at {time.perf_counter() - t_start:.1f} s)",
              flush=True)

        def count_precise(tally):
            for name, count in tally.items():
                launches[f"{name}_precise1"] = launches.get(f"{name}_precise1", 0) + count

        for n in (512, 16):
            for level in (1, 2):
                tally = {}
                pl, b_dev, c_dev, _ = drive(
                    "phase 9 synthetic4704", coo, "ell_pallas", n, times=5,
                    cfg=block_cfg.with_(precise=level), bar=ELL_PRECISE_BAR, tally=tally)
                name, row = check_kernel("phase 9 synthetic4704", synth, pl, b_dev, c_dev,
                                         iters=3, exact=True, rounds=2, slow_plain=True)
                kernels.setdefault(f"{name}_precise1", row)
                count_precise(tally)
                del pl, b_dev, c_dev
                drive("phase 9 synthetic4704", coo, "ell", n, times=5,
                      cfg=block_cfg.with_(precise=level), bar=ELL_F64_BAR)
            name, row = check_dia("phase 9 synthetic4704", splits["synthetic4704", n][0], n,
                                  iters=3, rounds=2, slow_plain=True, precise=1)
            kernels[f"{name}_precise1"] = row
            # the precise hybrid is held to its bar and to plain mode's
            # reading on the same inputs (phase 5)
            tally = {}
            drive_hybrid("phase 9 synthetic4704", coo, n, times=10, precise=1, tally=tally,
                         bar=min(HYBRID_PRECISE_BAR, runs["synthetic4704", "hybrid", n, 0][0]))
            count_precise(tally)

        # full width, against the f64 oracles of phases 4 and 5, each kernel
        # again to the bit against its plain version at these shapes
        tally = {}
        pl, b_dev, c_dev, _ = drive("phase 9 cant_like", cant, "ell_pallas", 512, times=5,
                                    cfg=block_cfg.with_(precise=1), bar=ELL_PRECISE_BAR,
                                    tally=tally)
        count_precise(tally)
        check_kernel("phase 9 cant_like", cant, pl, b_dev, c_dev, iters=1, exact=True,
                     rounds=2, slow_plain=True)
        del pl, b_dev, c_dev
        torch.cuda.empty_cache()
        # scircuit_like's hub rows are dot products of ~850 terms that
        # neither package compensates, summed by the hub pass as in plain
        # mode: every row is held to plain mode's reading there (phase 5)
        for tag, coo_, n, bars in (
                ("phase 9 scircuit_like", scircuit, 512,
                 (min(HUB_ULP_BAR, runs["scircuit_like", "hybrid", 512, 0][0]),
                  rest_ulps["scircuit_like", 512, 0])),
                ("phase 9 laplace3d_64", laplace, 16,
                 (min(DIA_PRECISE_BAR, runs["laplace3d_64", "hybrid", 16, 0][0]), None))):
            tally = {}
            drive_hybrid(tag, coo_, n, times=5, bar=bars[0], rest_bar=bars[1], precise=1,
                         tally=tally)
            count_precise(tally)
            check_dia(tag, splits[tag.split()[-1], n][0], n, iters=1, rounds=2,
                      slow_plain=True, precise=1)
            torch.cuda.empty_cache()
        for key, (ulp1, t1_) in sorted(runs.items()):
            if key[3] and key[0] in ("cant_like", "scircuit_like", "laplace3d_64") \
                    and key[1] in ("ell_pallas", "hybrid"):
                ulp0, t0_ = runs[(*key[:3], 0)]
                rest = (f" ({rest_ulps[key[0], key[2], key[3]]:.4f} against "
                        f"{rest_ulps[key[0], key[2], 0]:.4f} outside the hub rows)"
                        if key[1] == "hybrid" else "")
                print(f"phase 9 {key[0]}: {key[1]} precise={key[3]} N={key[2]}: {ulp1:.4f} ulp "
                      f"against {ulp0:.4f} in plain mode{rest}; time_repeat {t1_ * 1e3:.4f} ms "
                      f"against {t0_ * 1e3:.4f} ms (phases 4-5), x{t1_ / t0_:.2f}", flush=True)
        del scircuit, laplace

    # ---- phase 10: the gather probes (P1's and P2's twins) ----
    t10 = time.perf_counter()
    print(f"phase 10: the gather probes {at()}", flush=True)
    gather_probes(kernels, launches)
    print(f"phase 10: done in {time.perf_counter() - t10:.1f} s {at()}", flush=True)

    # ---- phase 11: serving (SpmmServer, PackCache) ----
    t11 = time.perf_counter()
    print(f"phase 11: serving {at()}", flush=True)
    from sextans_tpu_torch.format.pack_cache import RAW_BYTES_DEFAULT, _packed_nbytes

    builds = build_kernels.cache_info().misses  # the library builds on a miss
    serving_kernels = {"vpu": "spmm_block", "edge": "spmm_edge", "ell": None}
    served = {}  # (matrix, format, N) -> the served product

    def serve(tag, srv, coo_, name, iters):
        """One served product, driven from host B and C as a user serves
        it, with its launches counted from just before it to just
        after; then held against SpmmPlan on the unbucketed pack (to the
        bit; K1 in plain mode within ULP_BAR of max|C|) and the f64 oracle,
        and the kernel timed on the bucketed pack beside the unbucketed."""
        n, fmt, level = srv.n, srv.fmt, int(srv.config.precise)
        b, c, ref, _ = golden(tag, coo_, n)
        expected = serving_kernels[fmt] if fmt != "mxu" else (
            "spmm_slab" if n > SKINNY_MAX_N else "spmm_slab_skinny")
        marks = launch_marks(counted)
        t0 = time.perf_counter()
        pl = srv.plan(coo_, name)
        t_plan = time.perf_counter() - t0
        got = pl(b, ALPHA, BETA, c)
        torch.cuda.synchronize()
        ran = launched_since(counted, marks)
        if ran != ({expected: 1} if expected else {}):
            fail(f"phase 11 {tag} {fmt} N={n}: launches {ran}, expected {expected} once")
        if expected:
            key = f"{expected}_precise{level}" if level else expected
            launches[key] = launches.get(key, 0) + 1
        unbucketed = srv.pack_cache.get_or_pack(name, coo_, srv.config, fmt)
        pl0 = sx.SpmmPlan(unbucketed, n, srv.backend, device="cuda")
        b_dev, c_dev = (torch.as_tensor(x, device="cuda") for x in (b, c))
        want = pl0(b_dev, ALPHA, BETA, c_dev)
        unit = float(np.spacing(np.float32(want.abs().max().item())))
        diff = (got - want).abs().max().item() / unit
        k1 = expected == "spmm_slab" and not level
        if not (torch.equal(got, want) or (k1 and diff <= ULP_BAR)):
            fail(f"phase 11 {tag} {fmt} N={n}: served product {diff:.4f} ulp off the "
                 f"unbucketed plan's")
        res = sx.verify(ref, got.cpu().numpy())
        acc = accuracy((tag, n), got)
        bar = PRECISE_BAR[level] if level else ULP_BAR
        if not (res.passed and acc["finite"] and acc["ulp"] <= bar
                and tuple(got.shape) == coo_.shape[:1] + (n,)):
            fail(f"phase 11 {tag} {fmt} N={n}: verify {res.passed}, {acc['ulp']:.4f} ulp "
                 f"(bar {bar:g})")
        b_p, c_p = pl.pad_b(b_dev), pl.pad_c(c_dev)
        b0_p, c0_p = pl0.pad_b(b_dev), pl0.pad_c(c_dev)
        ms = abba_ms({"unbucketed": lambda: pl0._run(*pl0.arrays, b0_p, c0_p, ALPHA, BETA),
                      "bucketed": lambda: pl.call_padded(b_p, c_p, ALPHA, BETA)}, iters, 2)
        ms["served"] = event_ms(lambda: pl(b, ALPHA, BETA, c), max(1, iters // 5))
        a_bytes = [sum(t.nbytes for t in p_.arrays) for p_ in (pl, pl0)]
        p_, p0 = pl.packed, unbucketed
        shape = (f"rows {p0.m_padded} -> {p_.m_padded}, R {p0.slots_per_row} -> "
                 f"{p_.slots_per_row}, {p0.n_virt} -> {p_.n_virt} virtual rows"
                 if fmt == "ell" else
                 f"{'chunks' if fmt == 'edge' else 'groups'} "
                 f"{p0.n_chunks if fmt == 'edge' else p0.n_groups} -> "
                 f"{p_.n_chunks if fmt == 'edge' else p_.n_groups}, M-tiles "
                 f"{p0.n_mtiles} -> {p_.n_mtiles}, K-windows {p0.n_kwins} -> {p_.n_kwins}")
        print(f"phase 11 {tag}: {fmt} ({srv.backend}, precise={level}) N={n} "
              f"{coo_.shape[0]}x{coo_.shape[1]} nnz={coo_.nnz}, bucket "
              f"{'new' if pl.bucket_new else 'warm'} ({shape}; A {a_bytes[1] / 1e6:.3f} -> "
              f"{a_bytes[0] / 1e6:.3f} MB on the card); plan {t_plan:.3f} s; vs unbucketed "
              f"plan {'equal' if torch.equal(got, want) else f'{diff:.4f} ulp of max|C|'}; "
              f"verify {'Success!' if res.passed else 'Failed.'}, {acc['ulp']:.4f} ulp of "
              f"max|C| vs f64 (bar {bar:g}); [{smi}] served call {ms['served']:.4f} ms (host "
              f"B, C in, pad, kernel, slice); kernel on the bucketed pack "
              f"{ms['bucketed']:.4f} ms, unbucketed {ms['unbucketed']:.4f} ms "
              f"({100 * (ms['bucketed'] / ms['unbucketed'] - 1):+.1f} %); launches {ran} "
              f"{at()}", flush=True)
        served[tag, fmt, n] = got
        return pl

    with tempfile.TemporaryDirectory() as tmp11:
        cache = sx.PackCache(root=Path(tmp11) / "packs")

        def server(fmt, n, level=0, pack_cache=cache):
            cfg = (slab_cfg if fmt == "mxu" else block_cfg).with_(precise=level)
            return sx.SpmmServer(n, config=cfg, fmt=fmt, pack_cache=pack_cache, device="cuda")

        cases = [("vpu", 512), ("mxu", 512), ("mxu", 16), ("edge", 512), ("ell", 512)]
        servers = {case: server(*case) for case in cases}
        first = {case: serve("synthetic4704", srv, coo, "synthetic4704", 10)
                 for case, srv in servers.items()}
        if not all(pl.bucket_new for pl in first.values()):
            fail("phase 11: synthetic4704 found a warm bucket on new servers")
        # a precise server on the same cached pack shares the plain one's upload
        precise_pl = serve("synthetic4704", server("vpu", 512, level=1), coo, "synthetic4704",
                           10)
        plain_pl = first["vpu", 512]
        if not (precise_pl.arrays[0] is plain_pl.arrays[0]
                and precise_pl.ranges is plain_pl.ranges):
            fail("phase 11: the precise variant uploaded its own copy of the cached pack")
        print(f"phase 11: the precise (level 1) and plain servers share one upload "
              f"({sum(t.nbytes for t in plain_pl.arrays) / 1e6:.3f} MB) and one host scan",
              flush=True)
        del first, precise_pl, plain_pl
        # a second matrix, never seen: another seed, m, k and nnz, the same buckets
        other = sx.COOMatrix.random(4690, 4710, 104000, seed=43, banded=True, bandwidth=300)
        for case, srv in servers.items():
            if serve("synthetic4704b", srv, other, "synthetic4704b", 10).bucket_new:
                fail(f"phase 11: the second matrix missed the warm bucket of {case}")
        # cant_like: a new bucket, its packs above the raw threshold
        for case in cases[:4]:
            if not serve("cant_like", servers[case], cant, "cant_like", 2).bucket_new:
                fail(f"phase 11: cant_like landed in a warm bucket of {case}")
            torch.cuda.empty_cache()
        raw = sorted(p.name for p in (Path(tmp11) / "packs").glob("*.raw"))
        reloaded = sx.PackCache(root=Path(tmp11) / "packs")
        for fmt in ("vpu", "mxu", "edge"):
            srv = server(fmt, 512, pack_cache=reloaded)
            b, c = operands(*cant.shape, 512)
            marks = launch_marks(counted)
            pl = srv.plan(cant, "cant_like")
            got = pl(b, ALPHA, BETA, c)
            torch.cuda.synchronize()
            ran = launched_since(counted, marks)
            for k, count in ran.items():
                launches[k] += count
            packed = reloaded.get_or_pack("cant_like", cant, srv.config, fmt)
            # a pack above the raw threshold comes back memory-mapped
            memmapped = isinstance(packed.vals, np.memmap)
            big = _packed_nbytes(packed) > RAW_BYTES_DEFAULT
            same = torch.equal(got, served["cant_like", fmt, 512])
            print(f"phase 11: cant_like {fmt} from a second PackCache on the same root: "
                  f"disk hits {reloaded.disk_hits}, {_packed_nbytes(packed) / 2**20:.1f} MiB, "
                  f"memory-mapped {memmapped}; served product "
                  f"{'equal to' if same else 'DIFFERENT from'} the freshly packed one's; "
                  f"launches {ran}", flush=True)
            if not (same and memmapped == big and ran):
                fail(f"phase 11: cant_like {fmt} from the disk cache")
            del pl, got, packed
        if reloaded.disk_hits != 3 or reloaded.misses or not raw:
            fail(f"phase 11: disk hits {reloaded.disk_hits}, misses {reloaded.misses}, raw "
                 f"entries {raw}")
        del served
        torch.cuda.empty_cache()
        # the hybrid's residue through the cache: the uncached plan's bits
        split = splits["synthetic4704", 512][0]
        b, c, _, _ = golden("synthetic4704", coo, 512)
        kw = dict(residue_config=block_cfg, backend="pallas", device="cuda")
        marks = launch_marks(counted)
        got = sx.HybridSpmmPlan(split, 512, pack_cache=cache,
                                cache_name="synthetic4704@n512-residue", **kw)(b, ALPHA, BETA, c)
        torch.cuda.synchronize()
        ran = launched_since(counted, marks)
        if ran != {"spmm_dia": 1, "spmm_block": 1, "hybrid_hub": 1}:
            fail(f"phase 11: the cached hybrid launched {ran}")
        for k, count in ran.items():
            launches[k] += count
        same = torch.equal(got, sx.HybridSpmmPlan(split, 512, **kw)(b, ALPHA, BETA, c))
        print(f"phase 11: hybrid synthetic4704 N=512, residue through the cache (misses "
              f"{cache.misses}): {'equal to' if same else 'DIFFERENT from'} the uncached plan; "
              f"launches {ran}", flush=True)
        if not same:
            fail("phase 11: the cached hybrid differs from the uncached one")
    if build_kernels.cache_info().misses != builds:
        fail(f"phase 11: the kernel library was built again: {build_kernels.cache_info()}")
    print(f"phase 11: build_kernels {build_kernels.cache_info()}: no build in the phase; "
          f"done in {time.perf_counter() - t11:.1f} s {at()}", flush=True)

    # ---- phase 12: training (spmm_value_op) ----
    t12 = time.perf_counter()
    print(f"phase 12: training {at()}", flush=True)
    training(cant, synth, slab_cfg, block_cfg, operands, counted, launches, kernels, smi)
    if build_kernels.cache_info().misses != builds:
        fail(f"phase 12: the kernel library was built again: {build_kernels.cache_info()}")
    print(f"phase 12: no build in the phase; done in {time.perf_counter() - t12:.1f} s {at()}",
          flush=True)

    print(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s")
    probe_src = "benchmarks/scratch/mosaic_eft_probe.py"
    sources = {
        "spmm_block": ("sextans_tpu_torch/csrc/spmm_block.cu",
                       "sextans_tpu/ops/spmm_pallas.py:202"),
        "spmm_slab": ("sextans_tpu_torch/csrc/spmm_slab.cu",
                      "sextans_tpu/ops/spmm_mxu_pallas.py:146"),
        "spmm_slab_skinny": ("sextans_tpu_torch/csrc/spmm_slab.cu",
                             "sextans_tpu/ops/spmm_mxu_pallas.py:388"),
        "spmm_edge": ("sextans_tpu_torch/csrc/spmm_edge.cu",
                      "sextans_tpu/ops/spmm_edge_pallas.py:205"),
        "spmm_ell": ("sextans_tpu_torch/csrc/spmm_ell.cu",
                     "sextans_tpu/ops/spmm_ell_pallas.py:156"),
        "spmm_dia": ("sextans_tpu_torch/csrc/spmm_dia.cu",
                     "sextans_tpu/ops/spmm_dia_pallas.py:124"),
        "spmm_dia_skinny": ("sextans_tpu_torch/csrc/spmm_dia.cu",
                            "sextans_tpu/ops/spmm_dia_pallas.py:294"),
    }
    for name in ("spmm_block", "spmm_edge", "spmm_slab", "spmm_slab_skinny"):
        for level in (1, 2):
            sources[f"{name}_precise{level}"] = sources[name]
    for variant in PRECISE1:
        sources[variant] = sources[variant.removesuffix("_precise1")]
    sources["df32_probe_pairs"] = ("sextans_tpu_torch/csrc/df32_probe.cu", f"{probe_src}:21")
    sources["df32_probe_chain"] = ("sextans_tpu_torch/csrc/df32_probe.cu", f"{probe_src}:39")
    for name in GATHER_PROBES:
        sources[name] = ("sextans_tpu_torch/csrc/gather_probe.cu",
                         "benchmarks/scratch/dma_gather_probe.py:37" if name.startswith("dma")
                         else "benchmarks/scratch/ell_issue_probe.py:24")
    sources["sddmm"] = ("sextans_tpu_torch/csrc/sddmm.cu",
                        "none: sextans_tpu/ops/autodiff.py:58 _sddmm is XLA ops")
    sources["hybrid_hub"] = ("sextans_tpu_torch/csrc/hybrid_hub.cu",
                             "none: the dense head and hub-row matmuls of "
                             "sextans_tpu/ops/hybrid.py are XLA ops")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], **kernels[name]}
        for name, (src, rep) in sources.items()
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
