#!/usr/bin/env python3
"""Save the outputs of the kernels that have been redesigned (K1, K2, K3,
K4, K5, K6, K7), to compare two trees of the repository on one card.

    python3 tools/kernel_outputs.py save ROOT OUT [--full]
    python3 tools/kernel_outputs.py compare OUT_A OUT_B

``save`` imports ``sextans_tpu_torch`` from the tree at ROOT (a checkout of
any commit since the port has K2-K7), builds its kernels, and runs them at
``chip_smoke.py``'s phase-2 shapes, on the banded synthetic 4704 x 4704
matrix (104,756 nnz, seed 42):

* K3 over ``pack`` with the default config at N = 512 and 16;
* K4 over ``pack_edge`` with the default config at N = 512 and with
  ``edge_masked``, ``edge_lanes=4`` at N = 16;
* K2 over ``pack_mxu`` with ``bench.py``'s slab config (tile_m 1024,
  window_k 4096, block_k 128, group_blocks 8) at N = 16 and 9 (a column
  group that is not full), and K1 with the same pack at N = 512 and 100 (a
  column tile that is not full);
* K5 over ``pack_ell`` with the default config at N = 512, 16 and 13
  (4-byte loads), with its hub fold, through the plan (an earlier tree
  folds in PyTorch after the kernel, this one in the kernel);

each at precise levels 0, 1 and 2, K1 and K2 also through the plan's call
(``SpmmPlan.__call__``: whatever B, C and output rows a tree's plan hands
its kernel, the (M, N) result), and

* K6 over the diagonal part of ``split_structure(coo, n=N)`` at N = 512
  and 37 (4-byte columns), and K7 at N = 16 and 9, each at levels 0 and 1
  (their one precise variant);

each with and without C, on the plan's own arrays (``SpmmPlan`` or
``HybridSpmmPlan``, and their host scans, K6's entry map where the plan
takes it and, for K1, operand tiles), alpha
0.85, beta -2.06 and B, C from numpy seed 0. ``--full`` adds the full-size
shapes: K2 on cant_like (``fem_like(62451, dofs=3, neighbors=21, seed=2)``)
at N = 16, K1 and K5 on it at N = 512, K6 on scircuit_like (``circuit_like(170998,
seed=9)``) at N = 512 and K7 on laplace3d_64 (``stencil_3d(64, seed=12)``)
at N = 16. It writes the outputs to OUT (``torch.save``) and prints one line
per output.

``compare`` prints, for every output of OUT_A, whether OUT_B holds the same
bits; K1's plain-mode outputs of a direct launch, which a tree may contract
on the tensor cores (3xTF32) where another used FFMA, are held instead to
within ``ULP_BAR`` (4) ulp of max|C|, and their difference is printed in
those ulp. It exits 1 unless every other output is equal and every such K1
output is within the bar.
"""

from __future__ import annotations

import sys
from pathlib import Path

ALPHA, BETA = 0.85, -2.06


def save(root: str, out: str, full: bool = False) -> int:
    sys.path.insert(0, str(Path(root).resolve()))
    import numpy as np
    import torch

    import sextans_tpu_torch as sx
    from sextans_tpu_torch.ops.spmm_block import spmm_block_padded
    from sextans_tpu_torch.ops.spmm_dia import spmm_dia, spmm_dia_skinny
    from sextans_tpu_torch.ops.spmm_edge import spmm_edge_padded
    from sextans_tpu_torch.ops.spmm_ell import spmm_ell_gather_padded
    from sextans_tpu_torch.ops.spmm_slab import spmm_slab_padded, spmm_slab_skinny_padded
    from sextans_tpu_torch.utils.matrices import circuit_like, fem_like, stencil_3d

    if not torch.cuda.is_available():
        print("kernel_outputs: no CUDA device", file=sys.stderr)
        return 2
    print(f"sextans_tpu_torch from {Path(sx.__file__).parent}", flush=True)
    synth = sx.COOMatrix.random(4704, 4704, 104756, seed=42, banded=True, bandwidth=300)
    slab_cfg = sx.SpmmConfig(tile_m=1024, window_k=4096, block_k=128, group_blocks=8,
                             chunk_unroll=2)
    packed_cases = [("spmm_block", synth, sx.pack, sx.SpmmConfig(), 512),
                    ("spmm_block", synth, sx.pack, sx.SpmmConfig(), 16),
                    ("spmm_edge", synth, sx.pack_edge, sx.SpmmConfig(), 512),
                    ("spmm_edge", synth, sx.pack_edge,
                     sx.SpmmConfig(edge_masked=True, edge_lanes=4), 16),
                    ("spmm_slab_skinny", synth, sx.pack_mxu, slab_cfg, 16),
                    ("spmm_slab_skinny", synth, sx.pack_mxu, slab_cfg, 9),
                    ("spmm_slab", synth, sx.pack_mxu, slab_cfg, 512),
                    ("spmm_slab", synth, sx.pack_mxu, slab_cfg, 100),
                    ("spmm_ell", synth, sx.pack_ell, sx.SpmmConfig(), 512),
                    ("spmm_ell", synth, sx.pack_ell, sx.SpmmConfig(), 16),
                    ("spmm_ell", synth, sx.pack_ell, sx.SpmmConfig(), 13)]
    dia_cases = [("synthetic4704", synth, 512), ("synthetic4704", synth, 37),
                 ("synthetic4704", synth, 16), ("synthetic4704", synth, 9)]
    if full:
        cant = fem_like(62451, dofs=3, neighbors=21, seed=2)
        packed_cases += [("spmm_slab_skinny", cant, sx.pack_mxu, slab_cfg, 16),
                         ("spmm_slab", cant, sx.pack_mxu, slab_cfg, 512),
                         ("spmm_ell", cant, sx.pack_ell, sx.SpmmConfig(), 512)]
        dia_cases += [("scircuit_like", circuit_like(170998, seed=9), 512),
                      ("laplace3d_64", stencil_3d(64, seed=12), 16)]
    kernels = {"spmm_block": (spmm_block_padded, "pallas"),
               "spmm_edge": (spmm_edge_padded, "edge"),
               "spmm_slab_skinny": (spmm_slab_skinny_padded, "mxu"),
               "spmm_slab": (spmm_slab_padded, "mxu"),
               "spmm_ell": (spmm_ell_gather_padded, "ell_pallas")}
    outs = {}

    def launches(kernel) -> int:
        """The kernel's launches so far: the ``launch.<wrapper>`` counter of
        ``sx.counters()``, or on a tree older than the counters the
        wrapper's own ``launches`` attribute."""
        if hasattr(sx, "counters"):
            return sx.counters().get(f"launch.{kernel.__name__}", 0)
        return kernel.launches

    def keep(key, kernel, before, got):
        torch.cuda.synchronize()
        if launches(kernel) != before + 1:
            raise RuntimeError(f"{key}: the kernel did not launch")
        outs[key] = got.cpu()
        print(f"{key}: {tuple(got.shape)}, finite {bool(torch.isfinite(got).all())}",
              flush=True)

    for name, coo, packer, cfg, n in packed_cases:
        rng = np.random.default_rng(0)
        b = rng.standard_normal((coo.shape[1], n)).astype(np.float32)
        c = rng.standard_normal((coo.shape[0], n)).astype(np.float32)
        kernel, backend = kernels[name]
        tag = "" if coo is synth else "cant_like "
        for level in (0, 1, 2):
            packed = packer(coo, cfg.with_(precise=level))
            pl = sx.plan(packed, n, backend, device="cuda")
            b_p, c_p = pl.pad_b(b), pl.pad_c(c)
            if name == "spmm_edge":
                kw = dict(tile_m=cfg.tile_m, window_k=cfg.window_k,
                          edge_chunk=cfg.edge_chunk, masked=cfg.edge_masked)
            else:
                kw = dict(tile_m=cfg.tile_m, window_k=cfg.window_k, block_k=cfg.block_k,
                          group_blocks=cfg.group_blocks)
            for with_c in (True, False):
                before = launches(kernel)
                # through the plan: its scan (and tiles), and whatever else a tree binds
                if name in ("spmm_slab", "spmm_slab_skinny", "spmm_ell"):
                    got = pl._run(*pl.arrays, b_p, c_p, ALPHA, BETA if with_c else 0.0,
                                  with_c=with_c)
                else:
                    got = kernel(*pl.arrays, b_p, c_p, ALPHA, BETA if with_c else 0.0,
                                 ranges=pl.ranges, with_c=with_c, precise=level, **kw)
                keep(f"{tag}{name} N={n} precise={level} with_c={with_c}", kernel, before, got)
                if name.startswith("spmm_slab"):
                    before = launches(kernel)
                    got = pl(b, ALPHA, BETA, c) if with_c else pl(b, ALPHA)
                    keep(f"{tag}{name} N={n} precise={level} with_c={with_c} (plan call)",
                         kernel, before, got)
            del pl, packed, b_p, c_p
        torch.cuda.empty_cache()

    for tag, coo, n in dia_cases:
        rng = np.random.default_rng(0)
        b = torch.as_tensor(rng.standard_normal((coo.shape[1], n)).astype(np.float32),
                            device="cuda")
        c = torch.as_tensor(rng.standard_normal((coo.shape[0], n)).astype(np.float32),
                            device="cuda")
        split = sx.split_structure(coo, n=n)
        pl = sx.HybridSpmmPlan(split, n, residue_config=sx.SpmmConfig(), backend="pallas",
                               device="cuda")
        kernel = spmm_dia if n > 32 else spmm_dia_skinny
        if pl._dia is not kernel:
            raise RuntimeError(f"{tag} N={n}: the plan does not run {kernel.__name__}")
        for level in (0, 1):
            for with_c in (True, False):
                before = launches(kernel)
                got = kernel(pl._dvals, pl._offsets, b, c, ALPHA, BETA if with_c else 0.0,
                             with_c=with_c, precise=level, **getattr(pl, "_dia_kw", {}))
                keep(f"{'' if coo is synth else tag + ' '}{kernel.__name__} N={n} "
                     f"precise={level} with_c={with_c}", kernel, before, got)
        del pl, b, c
        torch.cuda.empty_cache()
    torch.save(outs, out)
    return 0


ULP_BAR = 4.0  # chip_smoke.py: a kernel against its plain version, in ulp of max|C|


def compare(path_a: str, path_b: str) -> int:
    import numpy as np
    import torch

    a, b = torch.load(path_a), torch.load(path_b)
    ok = set(a) == set(b)
    for key, x in a.items():
        same = key in b and torch.equal(x, b[key])
        if same:
            print(f"{key}: equal to the bit")
        elif key in b and x.shape == b[key].shape:
            diff = (x - b[key]).abs().max().item()
            if key.split()[-4] == "spmm_slab" and "precise=0" in key:  # K1, plain mode
                ulp = diff / float(np.spacing(np.float32(x.abs().max().item())))
                print(f"{key}: {ulp:.4f} ulp of max|C| apart (bar {ULP_BAR:g}), "
                      f"{'within' if ulp <= ULP_BAR else 'PAST'} the bar")
                same = ulp <= ULP_BAR
            else:
                print(f"{key}: DIFFERENT (max |a - b| {diff})")
        else:
            print(f"{key}: DIFFERENT (missing or another shape)")
        ok = ok and same
    print(f"kernel_outputs: {len(a)} outputs, "
          f"{'all equal or within the bar' if ok else 'NOT all equal'}")
    return 0 if ok else 1


def main(argv) -> int:
    if len(argv) in (3, 4) and argv[0] == "save" and argv[3:] in ([], ["--full"]):
        return save(argv[1], argv[2], full=argv[3:] == ["--full"])
    if len(argv) == 3 and argv[0] == "compare":
        return compare(argv[1], argv[2])
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
