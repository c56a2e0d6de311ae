#!/usr/bin/env python3
"""Save the block (K3) and edge (K4) kernels' outputs, to compare two trees
of the repository bit for bit on one card.

    python3 tools/kernel_outputs.py save ROOT OUT
    python3 tools/kernel_outputs.py compare OUT_A OUT_B

``save`` imports ``sextans_tpu_torch`` from the tree at ROOT (a checkout of
any commit since the port has K3 and K4), builds its kernels, and runs them
at ``chip_smoke.py``'s phase-2 shapes: the banded synthetic 4704 x 4704
matrix (104,756 nnz, seed 42); K3 over ``pack`` with the default config at
N = 512 and 16; K4 over ``pack_edge`` with the default config at N = 512 and
with ``edge_masked``, ``edge_lanes=4`` at N = 16. Each runs at precise
levels 0, 1 and 2, with and without C, on the plan's own arrays and ranges,
alpha 0.85, beta -2.06 and B, C from numpy seed 0. It writes the outputs to
OUT (``torch.save``) and prints one line per output.

``compare`` prints, for every output of OUT_A, whether OUT_B holds the same
bits, and exits 1 unless all are equal.
"""

from __future__ import annotations

import sys
from pathlib import Path

ALPHA, BETA = 0.85, -2.06


def save(root: str, out: str) -> int:
    sys.path.insert(0, str(Path(root).resolve()))
    import numpy as np
    import torch

    import sextans_tpu_torch as sx
    from sextans_tpu_torch.ops.spmm_block import spmm_block_padded
    from sextans_tpu_torch.ops.spmm_edge import spmm_edge_padded

    if not torch.cuda.is_available():
        print("kernel_outputs: no CUDA device", file=sys.stderr)
        return 2
    print(f"sextans_tpu_torch from {Path(sx.__file__).parent}", flush=True)
    synth = sx.COOMatrix.random(4704, 4704, 104756, seed=42, banded=True, bandwidth=300)
    cases = [("spmm_block", sx.pack, sx.SpmmConfig(), 512),
             ("spmm_block", sx.pack, sx.SpmmConfig(), 16),
             ("spmm_edge", sx.pack_edge, sx.SpmmConfig(), 512),
             ("spmm_edge", sx.pack_edge, sx.SpmmConfig(edge_masked=True, edge_lanes=4), 16)]
    outs = {}
    for name, packer, cfg, n in cases:
        rng = np.random.default_rng(0)
        b = rng.standard_normal((synth.shape[1], n)).astype(np.float32)
        c = rng.standard_normal((synth.shape[0], n)).astype(np.float32)
        for level in (0, 1, 2):
            packed = packer(synth, cfg.with_(precise=level))
            backend = "pallas" if name == "spmm_block" else "edge"
            pl = sx.plan(packed, n, backend, device="cuda")
            b_p, c_p = pl.pad_b(b), pl.pad_c(c)
            if name == "spmm_block":
                kernel = spmm_block_padded
                kw = dict(tile_m=cfg.tile_m, window_k=cfg.window_k, block_k=cfg.block_k,
                          group_blocks=cfg.group_blocks)
            else:
                kernel = spmm_edge_padded
                kw = dict(tile_m=cfg.tile_m, window_k=cfg.window_k,
                          edge_chunk=cfg.edge_chunk, masked=cfg.edge_masked)
            for with_c in (True, False):
                before = kernel.launches
                got = kernel(*pl.arrays, b_p, c_p, ALPHA, BETA if with_c else 0.0,
                             ranges=pl.ranges, with_c=with_c, precise=level, **kw)
                torch.cuda.synchronize()
                if kernel.launches != before + 1:
                    raise RuntimeError(f"{name} did not launch")
                key = f"{name} N={n} precise={level} with_c={with_c}"
                outs[key] = got.cpu()
                print(f"{key}: {tuple(got.shape)}, finite {bool(torch.isfinite(got).all())}",
                      flush=True)
    torch.save(outs, out)
    return 0


def compare(path_a: str, path_b: str) -> int:
    import torch

    a, b = torch.load(path_a), torch.load(path_b)
    equal = set(a) == set(b)
    for key, x in a.items():
        same = key in b and torch.equal(x, b[key])
        diff = (x - b[key]).abs().max().item() if key in b and x.shape == b[key].shape else None
        print(f"{key}: {'equal to the bit' if same else f'DIFFERENT (max |a - b| {diff})'}")
        equal = equal and same
    print(f"kernel_outputs: {len(a)} outputs, {'all equal' if equal else 'NOT all equal'}")
    return 0 if equal else 1


def main(argv) -> int:
    if len(argv) == 3 and argv[0] == "save":
        return save(argv[1], argv[2])
    if len(argv) == 3 and argv[0] == "compare":
        return compare(argv[1], argv[2])
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
