#!/usr/bin/env python3
"""Device time of the skinny slab kernel (K2) and the wide DIA kernel (K6)
at their measured shapes, to compare two trees of the repository on one
card, and K6's time under run plans cut finer by hand.

    python3 tools/kernel_times.py ROOT [--pace]

imports ``sextans_tpu_torch`` from the tree at ROOT (a checkout of any
commit since ``DiaRuns`` holds its offsets), builds its kernels and prints
one JSON line per case: ``{"case": ..., "ms": ...}``,
the kernel's device milliseconds per launch from ``torch.profiler`` (the
median of 3 traces of 20 launches each), with alpha 0.85, beta -2.06, C
read, and B, C from numpy seed 0. The cases:

* K2 over ``pack_mxu`` with ``bench.py``'s slab config (tile_m 1024,
  window_k 4096, block_k 128, group_blocks 8) at N = 16 on synthetic4704
  (``COOMatrix.random(4704, 4704, 104756, seed=42, banded=True,
  bandwidth=300)``) and cant_like (``fem_like(62451, dofs=3, neighbors=21,
  seed=2)``);
* K6 over the diagonal part of ``split_structure(coo, n=512)`` at N = 512,
  plain and precise, on synthetic4704 and scircuit_like
  (``circuit_like(170998, seed=9)``).

``--pace`` adds K6 on scircuit_like's 121 diagonals (-60..60) under plans
cut by hand at spans 0, 1, 3, 7, 15, 31 and ``DIA_SPAN_MAX`` (121 runs down
to ``dia_plan``'s two), and on its first diagonal alone (one run), plain and
precise. Every such plan gives the same bits, so what changes is how often
a tile stages a window and its dvals: the slope of time over runs is what a
run's staging costs, and the rest is the diagonals' steps and the epilogue.
To compare two trees, run ROOT_A, ROOT_B, ROOT_B, ROOT_A in one call.
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
    holds ``symbol``, per call of ``fn`` (CALLS calls a trace)."""
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
    if len(argv) not in (1, 2) or argv[1:] not in ([], ["--pace"]):
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(argv[0]).resolve()))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        return 2
    import sextans_tpu_torch as sx
    from sextans_tpu_torch.ops.spmm_dia import dia_plan, spmm_dia
    from sextans_tpu_torch.ops.spmm_slab import spmm_slab_skinny_padded
    from sextans_tpu_torch.utils.matrices import circuit_like, fem_like

    root = str(Path(sx.__file__).parent.parent)

    def emit(case, ms, **extra):
        print(json.dumps({"root": root, "case": case, "ms": ms, **extra}), flush=True)

    synth = sx.COOMatrix.random(4704, 4704, 104756, seed=42, banded=True, bandwidth=300)
    slab_cfg = sx.SpmmConfig(tile_m=1024, window_k=4096, block_k=128, group_blocks=8,
                             chunk_unroll=2)
    for tag, coo in (("synthetic4704", synth),
                     ("cant_like", fem_like(62451, dofs=3, neighbors=21, seed=2))):
        n = 16
        rng = np.random.default_rng(0)
        b = rng.standard_normal((coo.shape[1], n)).astype(np.float32)
        c = rng.standard_normal((coo.shape[0], n)).astype(np.float32)
        pl = sx.plan(sx.pack_mxu(coo, slab_cfg), n, "mxu", device="cuda")
        b_p, c_p = pl.pad_b(b), pl.pad_c(c)
        kw = dict(tile_m=slab_cfg.tile_m, window_k=slab_cfg.window_k,
                  block_k=slab_cfg.block_k, group_blocks=slab_cfg.group_blocks,
                  ranges=pl.ranges)
        emit(f"K2 {tag} N={n}", device_ms(
            lambda: spmm_slab_skinny_padded(*pl.arrays, b_p, c_p, ALPHA, BETA, **kw),
            "spmm_slab_skinny_kernel"))
        del pl, b_p, c_p
        torch.cuda.empty_cache()

    scircuit = circuit_like(170998, seed=9)
    for tag, coo in (("synthetic4704", synth), ("scircuit_like", scircuit)):
        n = 512
        rng = np.random.default_rng(0)
        b = torch.as_tensor(rng.standard_normal((coo.shape[1], n)).astype(np.float32),
                            device="cuda")
        c = torch.as_tensor(rng.standard_normal((coo.shape[0], n)).astype(np.float32),
                            device="cuda")
        split = sx.split_structure(coo, n=n)
        dv = torch.as_tensor(split.diag_vals, device="cuda")
        plan = dia_plan(split.diag_offsets, "cuda")
        plans = [("", plan, dv)]
        if tag == "scircuit_like" and argv[1:] == ["--pace"]:
            from sextans_tpu_torch.ops.launch import dia_runs
            from sextans_tpu_torch.ops.spmm_dia import DIA_SPAN_MAX, DiaRuns

            host = split.diag_offsets.astype(np.int64)
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
        del b, c, dv, plan, plans
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
