"""Command-line interface — parity with the reference host binary.

Reference usage (src/sextans-host.cpp:26-48)::

    ./sextans [matrix A file] [N] [rp_time] [alpha] [beta]

Here::

    python -m sextans_tpu_torch [matrix A file] [N] [rp_time] [alpha] [beta]
        [--backend pallas|mxu|xla] [--tile-m ..] [--window-k ..]
        [--block-k ..] [--group-blocks ..] [--device cuda|cpu]

The same positional semantics, B (all 1.0, src/sextans-host.cpp:100-104),
C ((m+1)(n+1)/M/N, src/sextans-host.cpp:107-111), defaults (alpha=0.85,
beta=-2.06, rp_time=1), GFLOPS formula and Success!/Failed report as
``python -m sextans_tpu``. N is rounded up to a multiple of 8 like
tapa::round_up<8> (src/sextans-host.cpp:51). The device defaults to
``cuda``; there is no fallback to the CPU, which takes ``--device cpu``.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from sextans_tpu_torch.format.csr import CSRMatrix
from sextans_tpu_torch.format.pack import pack
from sextans_tpu_torch.format.pack_mxu import pack_mxu
from sextans_tpu_torch.io.mtx import read_mtx
from sextans_tpu_torch.ops.golden import golden_spmm
from sextans_tpu_torch.ops.spmm import plan as make_plan
from sextans_tpu_torch.utils.config import SpmmConfig, round_up
from sextans_tpu_torch.utils.timing import time_repeat
from sextans_tpu_torch.utils.verify import gflops, verify


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="sextans_tpu_torch",
        description="SpMM on an NVIDIA GPU: C = alpha*A*B + beta*C over Matrix Market inputs",
    )
    p.add_argument("matrix", help="Matrix Market (.mtx/.mtx.gz) sparse A file")
    p.add_argument("N", type=int, help="dense columns (rounded up to multiple of 8)")
    p.add_argument("rp_time", type=int, nargs="?", default=1, help="kernel repeats for timing")
    p.add_argument("alpha", type=float, nargs="?", default=0.85)
    p.add_argument("beta", type=float, nargs="?", default=-2.06)
    p.add_argument(
        "--backend",
        default="pallas",
        choices=["pallas", "mxu", "xla"],
        help="pallas = block kernel; mxu = slab kernels (skinny kernel at "
        "N <= 32); xla = plain PyTorch block version",
    )
    p.add_argument("--tile-m", type=int, default=None)
    p.add_argument("--window-k", type=int, default=None)
    p.add_argument("--block-k", type=int, default=None)
    p.add_argument("--group-blocks", type=int, default=None)
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    print("start host")

    n = round_up(args.N, 8)
    print(f"N = {n}")
    print(f"alpha = {args.alpha}")
    print(f"beta = {args.beta}")

    print("Reading sparse A matrix...", flush=True)
    coo = read_mtx(args.matrix)
    m, k = coo.shape
    nnz = coo.nnz
    print("done")
    print("Matrix size:")
    print(f"A: sparse matrix, {m} x {k}. NNZ = {nnz}")
    print(f"B: dense matrix, {k} x {n}")
    print(f"C: dense matrix, {m} x {n}")

    # Deterministic dense operands, matching the reference host exactly.
    b = np.ones((k, n), dtype=np.float32)
    mm, nn = np.meshgrid(np.arange(m), np.arange(n), indexing="ij")
    c = ((mm + 1.0) * (nn + 1.0) / m / n).astype(np.float32)

    cfg_kwargs = {}
    for name in ("tile_m", "window_k", "block_k", "group_blocks"):
        v = getattr(args, name)
        if v is not None:
            cfg_kwargs[name] = v
    cfg = SpmmConfig(**cfg_kwargs)

    print(f"Packing sparse A for {args.device} ...", flush=True)
    t0 = time.perf_counter()
    packed = pack_mxu(coo, cfg) if args.backend == "mxu" else pack(coo, cfg)
    t_pack = time.perf_counter() - t0
    s = packed.stats
    print(
        f"done ({t_pack * 1e3:.1f} msec): {s.blocks} blocks, "
        f"fill {s.block_fill:.3f}, {s.groups} groups, group fill {s.group_fill:.3f}"
    )

    print("Run spmm on cpu...", flush=True)
    csr = CSRMatrix.from_coo(coo)
    t0 = time.perf_counter()
    c_ref = golden_spmm(csr, b, args.alpha, args.beta, c)
    t_cpu = time.perf_counter() - t0
    print(f"done ({t_cpu * 1e3:.3f} msec)")
    print(f"CPU GFLOPS: {gflops(nnz, m, n, t_cpu):.3f}")

    print("launch kernel", flush=True)
    pl = make_plan(packed, n, backend=args.backend, device=args.device)
    device_name = (
        torch.cuda.get_device_name(pl.device) if pl.device.type == "cuda" else "cpu"
    )
    print(f"device: {device_name}")
    b_dev = torch.as_tensor(b, device=pl.device)  # upload dense operands once
    c0 = torch.as_tensor(c, device=pl.device)
    t_kernel = time_repeat(pl, b_dev, args.alpha, args.beta, c0, times=args.rp_time)
    print(f"Kernel time is {t_kernel * 1e3:f} ms")
    print(f"GFLOPS:{gflops(nnz, m, n, t_kernel):f}")

    got = pl(b_dev, args.alpha, args.beta, c0).cpu().numpy()
    result = verify(c_ref, got)
    print(result)
    return 0 if result.passed else 1


if __name__ == "__main__":
    sys.exit(main())
