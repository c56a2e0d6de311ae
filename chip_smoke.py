#!/usr/bin/env python3
"""Smoke run of sextans_tpu_torch on one NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases (each prints one line; any failure exits non-zero):

0. torch / CUDA versions and the card's name and power limit (nvidia-smi).
1. Build the CUDA kernels from ``sextans_tpu_torch/csrc`` (timed).
2. Each kernel against its plain PyTorch version on the card, at the shapes
   the main path gives it: the banded synthetic 4704 x 4704 matrix
   (104,756 nnz, the one ``bench.py`` uses without nasa4704); block kernel
   (K3) at N = 512 and 16 with the default config, slab kernel (K1) at
   N = 512 and skinny slab kernel (K2) at N = 16 with ``bench.py``'s slab
   config. Tolerance: 4 * spacing(f32(max |plain|)).
3. The main path end to end: write_mtx -> read_mtx -> pack / pack_mxu ->
   plan(device="cuda") -> verify against golden_spmm, and max-abs against
   golden_spmm_exact in ulp of max|C| (bar: 4 ulp), for pallas and mxu at
   N = 512 and 16; alpha 0.85, beta -2.06, B and C from numpy seed 0.
4. The same at full size: cant_like (fem_like(62451, dofs=3, neighbors=21,
   seed=2), 3,781,404 nnz) at N = 512 through pallas and mxu, with kernel
   ms and GFLOPS = 2 * N * (nnz + M) / t.
5. ``python -m sextans_tpu_torch <mtx> 16 --backend mxu`` must print
   Success!.

Launch counters are zeroed just before phase 3 and must be above zero for
every kernel after phase 4. The last two lines are a JSON object with one
entry per kernel and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
ALPHA, BETA = 0.85, -2.06
ULP_BAR = 4.0


def fail(msg: str):
    raise RuntimeError(f"chip_smoke FAILED: {msg}")


def event_ms(fn, iters: int = 10) -> float:
    """Mean device milliseconds of ``fn()`` over ``iters`` launches, after a
    warm-up, bracketed by CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing run",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import numpy as np

    import sextans_tpu_torch as sx
    from sextans_tpu_torch.ops.spmm_block import spmm_block_padded, spmm_block_padded_ref
    from sextans_tpu_torch.ops.spmm_slab import (
        spmm_slab_padded,
        spmm_slab_padded_ref,
        spmm_slab_skinny_padded,
    )
    from sextans_tpu_torch.runtime.build import build_kernels
    from sextans_tpu_torch.utils.matrices import fem_like
    from sextans_tpu_torch.utils.timing import time_repeat

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
    slab_cfg = sx.SpmmConfig(tile_m=1024, window_k=4096, block_k=128,
                             group_blocks=8, chunk_unroll=2)
    synth = sx.COOMatrix.random(4704, 4704, 104756, seed=42, banded=True,
                                bandwidth=300)
    if synth.nnz != 104756:
        fail(f"synthetic matrix has {synth.nnz} nnz, expected 104756")

    def operands(m, k, n):
        rng = np.random.default_rng(0)
        b = rng.standard_normal((k, n)).astype(np.float32)
        c = rng.standard_normal((m, n)).astype(np.float32)
        return b, c

    # ---- phase 2: kernel vs plain version on the card ----
    kernels = {}
    packs = {"pallas": sx.pack(synth, block_cfg), "mxu": sx.pack_mxu(synth, slab_cfg)}
    cases = [
        ("spmm_block", spmm_block_padded, spmm_block_padded_ref, "pallas", 512),
        ("spmm_block", spmm_block_padded, spmm_block_padded_ref, "pallas", 16),
        ("spmm_slab", spmm_slab_padded, spmm_slab_padded_ref, "mxu", 512),
        ("spmm_slab_skinny", spmm_slab_skinny_padded, spmm_slab_padded_ref, "mxu", 16),
    ]
    for name, kernel, plain, backend, n in cases:
        packed = packs[backend]
        pl = sx.plan(packed, n, backend, device="cuda")
        b, c = operands(*synth.shape, n)
        b_p, c_p = pl.pad_b(b), pl.pad_c(c)
        cfg = packed.config
        kw = dict(tile_m=cfg.tile_m, window_k=cfg.window_k,
                  block_k=cfg.block_k, group_blocks=cfg.group_blocks)
        got = kernel(*pl.arrays, b_p, c_p, ALPHA, BETA, ranges=pl.ranges, **kw)
        want = plain(*pl.arrays, b_p, c_p, ALPHA, BETA, **kw)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        tol = ULP_BAR * float(np.spacing(np.float32(want.abs().max().item())))
        ms = event_ms(lambda: kernel(*pl.arrays, b_p, c_p, ALPHA, BETA,
                                     ranges=pl.ranges, **kw))
        plain_ms = event_ms(lambda: plain(*pl.arrays, b_p, c_p, ALPHA, BETA, **kw))
        ok = bool(torch.isfinite(got).all().item()) and err <= tol
        print(f"phase 2: {name} N={n}: max_abs_err vs plain {err:.3e} "
              f"(tol {tol:.3e}) kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
              f"{'ok' if ok else 'MISMATCH'}", flush=True)
        if not ok:
            fail(f"{name} at N={n} disagrees with its plain version")
        if name not in kernels:  # the N=512 row of the block kernel is kept
            kernels[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)

    # ---- phases 3 and 4: the main path ----
    counted = (spmm_block_padded, spmm_slab_padded, spmm_slab_skinny_padded)
    for fn in counted:
        fn.launches = 0

    def drive(tag, coo, backend, cfg, n, times):
        packed = sx.pack_mxu(coo, cfg) if backend == "mxu" else sx.pack(coo, cfg)
        pl = sx.plan(packed, n, backend, device="cuda")
        b, c = operands(*coo.shape, n)
        got = pl(b, ALPHA, BETA, c).cpu().numpy()
        csr = sx.CSRMatrix.from_coo(coo)
        res = sx.verify(sx.golden_spmm(csr, b, ALPHA, BETA, c), got)
        exact = sx.golden_spmm_exact(csr, b, ALPHA, BETA, c)
        max_abs = float(np.abs(got.astype(np.float64) - exact).max())
        ulp = max_abs / float(np.spacing(np.float32(np.abs(exact).max())))
        b_dev = torch.as_tensor(b, device=pl.device)
        c_dev = torch.as_tensor(c, device=pl.device)
        t = time_repeat(pl, b_dev, ALPHA, BETA, c_dev, times=times)
        m = coo.shape[0]
        ok = res.passed and ulp <= ULP_BAR and bool(np.isfinite(got).all()) \
            and got.shape == (m, n)
        print(f"{tag}: {backend} N={n} {coo.shape[0]}x{coo.shape[1]} nnz={coo.nnz} "
              f"verify {'Success!' if res.passed else 'Failed.'} "
              f"({res.mismatch_percent:.2f}% mismatches) max_abs_vs_f64 "
              f"{max_abs:.3e} = {ulp:.2f} ulp of max|C|; kernel {t * 1e3:.4f} ms "
              f"GFLOPS {sx.gflops(coo.nnz, m, n, t):.1f}", flush=True)
        if not ok:
            fail(f"{tag} {backend} N={n}: verify {res.passed}, {ulp:.2f} ulp")
        return pl, b_dev, c_dev

    with tempfile.TemporaryDirectory() as tmp:
        mtx = Path(tmp) / "synthetic4704.mtx"
        sx.write_mtx(mtx, synth)
        coo = sx.read_mtx(mtx)
        if coo.nnz != synth.nnz or coo.shape != synth.shape:
            fail("write_mtx/read_mtx round trip changed the matrix")
        for backend, n in (("pallas", 512), ("pallas", 16), ("mxu", 512), ("mxu", 16)):
            drive("phase 3", coo, backend, slab_cfg if backend == "mxu" else block_cfg,
                  n, times=50)

        t0 = time.perf_counter()
        cant = fem_like(62451, dofs=3, neighbors=21, seed=2)
        if cant.nnz != 3781404:
            fail(f"cant_like has {cant.nnz} nnz, expected 3781404")
        print(f"phase 4: cant_like built in {time.perf_counter() - t0:.1f} s", flush=True)
        for backend, cfg, plain in (("pallas", block_cfg, spmm_block_padded_ref),
                                    ("mxu", slab_cfg, spmm_slab_padded_ref)):
            pl, b_dev, c_dev = drive("phase 4", cant, backend, cfg, 512, times=10)
            b_p, c_p = pl.pad_b(b_dev), pl.pad_c(c_dev)
            kw = dict(tile_m=cfg.tile_m, window_k=cfg.window_k,
                      block_k=cfg.block_k, group_blocks=cfg.group_blocks)
            plain_ms = event_ms(lambda: plain(*pl.arrays, b_p, c_p, ALPHA, BETA, **kw),
                                iters=3)
            print(f"phase 4: {backend} plain version {plain_ms:.4f} ms", flush=True)

        launches = {
            "spmm_block": spmm_block_padded.launches,
            "spmm_slab": spmm_slab_padded.launches,
            "spmm_slab_skinny": spmm_slab_skinny_padded.launches,
        }
        print(f"phase 3-4: launches on the main path {launches}", flush=True)
        if min(launches.values()) == 0:
            fail(f"a kernel of the main path never launched: {launches}")

        # ---- phase 5: the CLI ----
        env = dict(os.environ)
        env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
        proc = subprocess.run(
            [sys.executable, "-m", "sextans_tpu_torch", str(mtx), "16",
             "--backend", "mxu"],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=600,
        )
        last = [ln for ln in proc.stdout.splitlines() if ln.strip()][-3:]
        print(f"phase 5: CLI rc={proc.returncode}: {' | '.join(last)}", flush=True)
        if proc.returncode != 0 or "Success!" not in proc.stdout:
            fail(f"CLI did not succeed:\n{proc.stdout}\n{proc.stderr}")

    sources = {
        "spmm_block": ("sextans_tpu_torch/csrc/spmm_block.cu",
                       "sextans_tpu/ops/spmm_pallas.py:202"),
        "spmm_slab": ("sextans_tpu_torch/csrc/spmm_slab.cu",
                      "sextans_tpu/ops/spmm_mxu_pallas.py:146"),
        "spmm_slab_skinny": ("sextans_tpu_torch/csrc/spmm_slab.cu",
                             "sextans_tpu/ops/spmm_mxu_pallas.py:388"),
    }
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
