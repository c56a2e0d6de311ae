#!/usr/bin/env python3
"""Device time of the redesigned slab, DIA and ELL kernels (K1, K2, K5, K6,
K7) at their measured shapes, to compare two trees of the repository on one
card, K6's time under run plans cut finer by hand, and K5's 4- and 16-byte
loads.

    python3 tools/kernel_times.py ROOT [--pace] [--vec] [--k1]

imports ``sextans_tpu_torch`` from the tree at ROOT (a checkout of any
commit since ``DiaRuns`` holds its offsets), builds its kernels and prints
one JSON line per case: ``{"case": ..., "ms": ...}``,
the kernel's device milliseconds per launch from ``torch.profiler`` (the
median of 3 traces of 20 launches each), with alpha 0.85, beta -2.06, C
read, and B, C from numpy seed 0. Every kernel is called as its plan calls
it (the plan's scan, run plan and operand tiles), so any tree since then
runs. The cases:

* K1 over ``pack_mxu`` with ``bench.py``'s slab config (tile_m 1024,
  window_k 4096, block_k 128, group_blocks 8) at N = 512 on synthetic4704
  (``COOMatrix.random(4704, 4704, 104756, seed=42, banded=True,
  bandwidth=300)``) and cant_like (``fem_like(62451, dofs=3, neighbors=21,
  seed=2)``), plain and precise (level 1);
* K2 over the same packs at N = 16;
* K6 over the diagonal part of ``split_structure(coo, n=N)``, plain and
  precise, on synthetic4704 and scircuit_like (``circuit_like(170998,
  seed=9)``) at N = 512 and laplace3d_64 (``stencil_3d(64, seed=12)``) at
  N = 64: in a tree with the entry walk both walks, the dense one
  (``walk=dense``) and over the entry map (``walk=entries``), with the
  share of the dense slots that hold an entry (``fill``) and that the
  map's slots cover (``slot_share``), whichever the plan would choose;
* K7 over the diagonal part of ``split_structure(coo, n=16)`` at N = 16,
  plain and precise, on synthetic4704 and laplace3d_64 (``stencil_3d(64,
  seed=12)``);
* K5 over ``pack_ell`` with the default config, with its hub fold: every
  device op of the plan's call (an earlier tree folds in PyTorch after
  the kernel), plain and precise, at N = 512, 16 and 13 (4-byte loads) on
  synthetic4704 and N = 512 on cant_like.

``--k1`` times K1 alone, plain and precise, on synthetic4704, cant_like
and the benchmark's cant stand-in (``fem_like(62451, dofs=3,
neighbors=22, bandwidth=661, seed=13)``), and stops there.

``--vec`` times K5 in a tree that has ``ELL_VEC4_MIN_N`` both ways at every
N that takes them: 16-byte loads (a thread a 4-column chunk) and 4-byte
loads (a thread a column, four times the threads).

``--walks`` times K6 alone (the cases above), then both walks, plain and
precise, on laplace3d_64's 7 diagonals and on scircuit_like's 121
consecutive offsets filled at random (numpy seed 0) to a share of their
slots, 1, 3/4, 1/2, 3/8 ... 1/16 (N = 64 and 512 as above), and on a
tridiagonal matrix of scircuit_like's 170,998 rows at N = 512: the fills at
which the walks cross set ``DIA_ENTRY_SHARE``.

``--pace`` adds K6 on scircuit_like's 121 diagonals (-60..60) under plans
cut by hand at spans 0, 1, 3, 7, 15, 31 and ``DIA_SPAN_MAX`` (121 runs down
to ``dia_plan``'s two), and on its first diagonal alone (one run), plain and
precise. Every such plan gives the same bits, so what changes is how often
a tile stages a window and its dvals: the slope of time over runs is what a
run's staging costs, and the rest is the diagonals' steps and the epilogue.
To compare two trees, run ROOT_A, ROOT_B, ROOT_B, ROOT_A in one call; two
trees that differ only in how K1 contracts in plain mode (FFMA or the
tensor cores) race the two on one host in turns.
"""

from __future__ import annotations

import json
import statistics
import sys
from pathlib import Path

ALPHA, BETA = 0.85, -2.06
CALLS, TRACES = 20, 3


def device_ms(fn, symbol: str) -> float:
    """Median over TRACES traces of the device time of the ops whose name
    holds ``symbol`` (every op for ""), per call of ``fn`` (CALLS calls a
    trace)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(TRACES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(CALLS):
                fn()
            torch.cuda.synchronize()
        us = 0.0
        for evt in prof.key_averages():
            if evt.device_type == torch.autograd.DeviceType.CUDA and symbol in evt.key:
                us += getattr(evt, "self_device_time_total", None) or evt.self_cuda_time_total
        if us == 0.0:
            raise RuntimeError(f"the trace held no device time for {symbol}")
        per_call.append(us / 1e3 / CALLS)
    return statistics.median(per_call)


def main(argv) -> int:
    flags = argv[1:]
    if not argv or any(f not in ("--pace", "--vec", "--k1", "--walks") for f in flags):
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(argv[0]).resolve()))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        return 2
    import sextans_tpu_torch as sx
    from sextans_tpu_torch.ops.spmm_dia import dia_plan, spmm_dia, spmm_dia_skinny
    from sextans_tpu_torch.utils.matrices import circuit_like, fem_like, stencil_3d

    root = str(Path(sx.__file__).parent.parent)

    def emit(case, ms, **extra):
        print(json.dumps({"root": root, "case": case, "ms": ms, **extra}), flush=True)

    synth = sx.COOMatrix.random(4704, 4704, 104756, seed=42, banded=True, bandwidth=300)
    slab_cfg = sx.SpmmConfig(tile_m=1024, window_k=4096, block_k=128, group_blocks=8,
                             chunk_unroll=2)
    cant = fem_like(62451, dofs=3, neighbors=21, seed=2)
    k1_only = "--k1" in flags
    walks_only = "--walks" in flags
    mats = [] if walks_only else [("synthetic4704", synth), ("cant_like", cant)]
    if k1_only:
        mats.append(("cant_stand_in", fem_like(62451, dofs=3, neighbors=22, bandwidth=661,
                                               seed=13)))
    for tag, coo in mats:
        for n, precise in ((512, 0), (512, 1)) + (() if k1_only else ((16, 0),)):
            rng = np.random.default_rng(0)
            b = rng.standard_normal((coo.shape[1], n)).astype(np.float32)
            c = rng.standard_normal((coo.shape[0], n)).astype(np.float32)
            pl = sx.plan(sx.pack_mxu(coo, slab_cfg.with_(precise=precise)), n, "mxu",
                         device="cuda")
            b_p, c_p = pl.pad_b(b), pl.pad_c(c)
            # the kernel alone, as the plan calls it (K1 at N = 512, K2 at 16)
            emit(f"{'K1' if n > 32 else 'K2'} {tag} N={n} precise={precise}", device_ms(
                lambda: pl._run(*pl.arrays, b_p, c_p, ALPHA, BETA),
                "spmm_slab" if n > 32 else "spmm_slab_skinny_kernel"))
            del pl, b_p, c_p
            torch.cuda.empty_cache()
    if k1_only:
        return 0

    from sextans_tpu_torch.ops import spmm_ell

    vec_min = getattr(spmm_ell, "ELL_VEC4_MIN_N", None)
    modes = ([(" vec4", 1), (" vec1", 1 << 30)] if "--vec" in flags and vec_min
             else [("", vec_min)])
    for tag, coo, ns in () if walks_only else (("synthetic4704", synth, (512, 16, 13)),
                                                ("cant_like", cant, (512,))):
        for precise in (0, 1):
            packed = sx.pack_ell(coo, sx.SpmmConfig(precise=precise))
            for n in ns:
                rng = np.random.default_rng(0)
                b = rng.standard_normal((coo.shape[1], n)).astype(np.float32)
                c = rng.standard_normal((coo.shape[0], n)).astype(np.float32)
                pl = sx.plan(packed, n, "ell_pallas", device="cuda")
                b_p, c_p = pl.pad_b(b), pl.pad_c(c)
                for label, min_n in modes:
                    if min_n is not None:
                        spmm_ell.ELL_VEC4_MIN_N = min_n
                    # the kernel with its fold: every device op of the call
                    emit(f"K5 {tag} N={n} precise={precise}{label}", device_ms(
                        lambda: pl._run(*pl.arrays, b_p, c_p, ALPHA, BETA), ""))
                if vec_min is not None:
                    spmm_ell.ELL_VEC4_MIN_N = vec_min
                del pl, b_p, c_p
            del packed
            torch.cuda.empty_cache()

    laplace = stencil_3d(64, seed=12)
    for tag, coo in () if walks_only else (("synthetic4704", synth), ("laplace3d_64", laplace)):
        n = 16
        rng = np.random.default_rng(0)
        b = torch.as_tensor(rng.standard_normal((coo.shape[1], n)).astype(np.float32),
                            device="cuda")
        c = torch.as_tensor(rng.standard_normal((coo.shape[0], n)).astype(np.float32),
                            device="cuda")
        pl = sx.HybridSpmmPlan(sx.split_structure(coo, n=n), n,
                               residue_config=sx.SpmmConfig(), backend="pallas", device="cuda")
        if pl._dia is not spmm_dia_skinny:
            raise RuntimeError(f"{tag} N={n}: the plan does not run spmm_dia_skinny")
        for precise in (0, 1):
            emit(f"K7 {tag} N={n} precise={precise}", device_ms(
                lambda: spmm_dia_skinny(pl._dvals, pl._offsets, b, c, ALPHA, BETA,
                                        precise=precise, **getattr(pl, "_dia_kw", {})),
                "spmm_dia_skinny_kernel"), diagonals=int(pl._dvals.shape[0]))
        del pl, b, c
        torch.cuda.empty_cache()

    from sextans_tpu_torch.ops import spmm_dia as dia_mod

    has_walk = hasattr(dia_mod, "dia_entries")  # a tree with the entry walk
    scircuit = circuit_like(170998, seed=9)

    def time_k6(label, n, values, offsets, b, c, precisions):
        """K6 over ``values`` (D, M) on ``offsets``, each walk the tree has."""
        dv = torch.as_tensor(values, device="cuda")
        plan = dia_plan(offsets, "cuda")
        walks = [("", plan, {})]
        fill = slot_share = None
        if has_walk:
            entries = dia_mod.dia_entries(dv, plan.offsets, values)
            fill = entries.entries / values.size
            slot_share = dia_mod.DIA_GROUP_ROWS * entries.slots.shape[0] / values.size
            walks = [(" walk=dense", plan, {}),
                     (" walk=entries", entries.runs, {"entries": entries})]
        for walk, runs, kw in walks:
            for precise in precisions:
                emit(f"K6 {label} N={n} precise={precise}{walk}", device_ms(
                    lambda: spmm_dia(dv, plan.offsets, b, c, ALPHA, BETA, runs=plan,
                                     precise=precise, **kw), "spmm_dia"),
                     diagonals=int(dv.shape[0]), runs=int(runs.ptr.numel() - 1), fill=fill,
                     slot_share=slot_share)
        return dv, plan

    def operands(coo, n):
        rng = np.random.default_rng(0)
        return tuple(torch.as_tensor(rng.standard_normal((rows, n)).astype(np.float32),
                                     device="cuda") for rows in (coo.shape[1], coo.shape[0]))

    for tag, coo, n in (("synthetic4704", synth, 512), ("scircuit_like", scircuit, 512),
                        ("laplace3d_64", laplace, 64)):
        b, c = operands(coo, n)
        split = sx.split_structure(coo, n=n)
        dv, plan = time_k6(tag, n, split.diag_vals, split.diag_offsets, b, c, (0, 1))
        if tag == "scircuit_like" and "--pace" in flags:
            from sextans_tpu_torch.ops.spmm_dia import DIA_SPAN_MAX, DiaRuns, dia_runs

            host = split.diag_offsets.astype(np.int64)
            plans = []
            for cut in (0, 1, 3, 7, 15, 31, DIA_SPAN_MAX):
                ptr = dia_runs(host, cut)
                runs = DiaRuns(plan.offsets, torch.from_numpy(ptr).to("cuda"),
                               int((host[ptr[1:] - 1] - host[ptr[:-1]]).max()),
                               int(np.diff(ptr).max()))
                plans.append((f" cut={cut} runs={ptr.size - 1}", runs, dv))
            plans.append((" first diagonal", dia_plan(host[:1], "cuda"), dv[:1].contiguous()))
            for label, runs, d in plans:
                for precise in (0, 1):
                    emit(f"K6 {tag} N={n} precise={precise}{label}", device_ms(
                        lambda: spmm_dia(d, runs.offsets, b, c, ALPHA, BETA, runs=runs,
                                         precise=precise),
                        "spmm_dia_kernel"), diagonals=int(d.shape[0]),
                         runs=int(runs.ptr.numel() - 1))
        if walks_only and has_walk and tag != "synthetic4704":
            # the same offsets, their slots filled at random to a share
            rng = np.random.default_rng(0)
            for share in (1.0, 0.75, 0.5, 0.375, 0.25, 0.125, 0.0625):
                values = np.where(rng.random(split.diag_vals.shape) < share,
                                  rng.standard_normal(split.diag_vals.shape), 0.0)
                if tag == "laplace3d_64":  # the stencil's own values, thinned
                    values = np.where(values != 0.0, split.diag_vals, 0.0)
                time_k6(f"{tag} filled={share}", n, values.astype(np.float32),
                        split.diag_offsets, b, c, (0, 1))
        if walks_only and has_walk and tag == "scircuit_like":
            # a tridiagonal matrix (a 1D Laplacian) of as many rows: three
            # consecutive diagonals, every slot full
            tri = np.tile(np.array([[-1.0], [2.0], [-1.0]], dtype=np.float32), coo.shape[0])
            tri[0, 0] = tri[2, -1] = 0.0  # the slots outside the matrix
            time_k6(f"tridiagonal_{coo.shape[0]}", n, tri, np.arange(-1, 2), b, c, (0, 1))
        del b, c, dv, plan
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
