#!/usr/bin/env python3
"""Whether the edge cell's product at precise level 2 is correctly rounded,
element by element, at its full size.

    python3 tools/level2_exactness.py ROOT SEED [SEED ...] [--cpu]

imports the tree at ROOT (its ``sextans_tpu_torch`` and ``bench_torch``),
makes ``cant_edge_n512_p2.repeat``'s matrix, values, B and C from each
seed as the benchmark does, runs one product through the plan on the card
(``--cpu``: a 3,000-row cut of the matrix at N = 32 on the CPU, to try the
script), and prints one JSON line a seed:

* ``elements``; ``max_ulp`` against the benchmark's f64 reference;
* ``above_floor_vs_f64``: elements farther from that reference than its own
  f32 rounding is;
* ``candidates``: those, and every element whose f64 reference lies within
  the reference's own error bound (2**-46 of its terms' magnitudes) of an f32
  rounding boundary, so that the reference cannot say which way it rounds;
* ``exact_wrong``: candidates whose f32 is not the nearest to the exact
  value, computed in rationals (``fractions``), with up to 5 of them;
  ``ref64_wrong_among_candidates``: the same count for the f64 reference;
* where the tree has the level-2 check (``ops/spmm_edge.py:
  _nearest_elements``): ``unsure``, the elements its check sent to be summed
  again, and ``kernel_vs_plain_differ``, the elements where the kernel and
  its plain version (run on the card's tensors) differ.

Every element outside the candidates rounds as its f64 reference does, and
that reference is correct there, so ``exact_wrong`` counts every element
that is not correctly rounded.
"""

import argparse
import json
import sys
import time
from fractions import Fraction

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("root")
    ap.add_argument("seeds", type=int, nargs="+")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, args.root)

    import torch

    import sextans_tpu_torch as sx
    from bench_torch import harness, port, reference
    from sextans_tpu_torch.ops import spmm_edge

    cell = harness.resolve(harness.load_json(harness.ROOT / "BENCHMARK.json"),
                           "cant_edge_n512_p2.repeat")
    dev = torch.device("cuda")
    if args.cpu:
        matrix = cell.config["matrix"]
        cell.config["matrix"] = {**matrix, "args": {**matrix["args"], "m": 3000}}
        cell.config["n"] = 32
        dev = torch.device("cpu")
    for seed in args.seeds:
        t0 = time.time()
        ctx = harness.make_context(cell, seed, dev, False)
        m, k = ctx.pattern.shape
        b, c = ctx.normal("b", (k, ctx.n)), ctx.normal("c", (m, ctx.n))
        packed = port.packed(ctx.config, ctx.pattern)
        plan = sx.plan(packed, ctx.n, "edge", device=dev)
        out = plan(b, ctx.alpha, ctx.beta, c)
        ctx.sync()
        rec = {"root": args.root, "seed": seed, "elements": out.numel()}
        if hasattr(spmm_edge, "_nearest_elements"):
            seen = {}

            def counted(*a, check=spmm_edge.checked_epilogue, **kw):
                r, unsure = check(*a, **kw)
                seen["unsure"] = int(unsure[:m].sum())
                return r, unsure

            spmm_edge.checked_epilogue = counted
            cfg = packed.config
            plain = spmm_edge.spmm_edge_padded_ref(
                *plan.arrays, plan.pad_b(b), plan.pad_c(c), ctx.alpha, ctx.beta,
                tile_m=cfg.tile_m, window_k=cfg.window_k, edge_chunk=cfg.edge_chunk,
                masked=cfg.edge_masked, precise=cfg.precise)[:m]
            spmm_edge.checked_epilogue = counted.__kwdefaults__["check"]
            rec["unsure"] = seen["unsure"]
            rec["kernel_vs_plain_differ"] = int((out != plain).sum())
        a = ctx.coo()
        ref = reference.spmm(a, ctx.vals, b, c, ctx.alpha, ctx.beta)
        terms = reference.spmm(a, ctx.vals.abs(), b.abs(), c, abs(ctx.alpha), 0.0)
        rec["max_ulp"] = reference.ulp_gap(out, ref)
        r32 = ref.float()
        above = (out.double() - ref).abs() > (r32.double() - ref).abs()
        rec["above_floor_vs_f64"] = int(above.sum())
        # the f64 reference's own error, and the f32 boundary nearest to it
        bound = terms * 2.0**-46 + ref.abs() * 2.0**-52 + c.abs().double() * 2.0**-60
        toward = torch.full_like(r32, float("inf")).where(ref > r32.double(),
                                                          torch.full_like(r32, float("-inf")))
        mid = (r32.double() + torch.nextafter(r32, toward).double()) / 2
        cand = torch.nonzero(above | ((ref - mid).abs() <= bound)).cpu().tolist()
        rec["candidates"] = len(cand)
        pat = ctx.pattern
        order = np.argsort(pat.rows, kind="stable")
        rows, cols, vals = pat.rows[order], pat.cols[order], pat.vals[order]
        ptr = np.searchsorted(rows, np.arange(m + 1))
        bh, ch, oh = b.cpu().numpy(), c.cpu().numpy(), out.cpu().numpy()
        al, be = Fraction(float(np.float32(ctx.alpha))), Fraction(float(np.float32(ctx.beta)))
        wrong, ref_wrong = [], 0
        for i, j in cand:
            y = al * sum(Fraction(float(vals[e])) * Fraction(float(bh[cols[e], j]))
                         for e in range(ptr[i], ptr[i + 1])) + be * Fraction(float(ch[i, j]))
            x = np.float32(float(y))
            near = min((np.nextafter(x, np.float32(-np.inf)), x, np.nextafter(x, np.float32(np.inf))),
                       key=lambda z: (abs(Fraction(float(z)) - y),
                                      int(np.array(z).view(np.int32)) & 1))
            if oh[i, j] != near:
                wrong.append([i, j, float(oh[i, j]), float(near), float(y)])
            ref_wrong += bool(np.float32(ref[i, j].item()) != near)
        rec["exact_wrong"] = len(wrong)
        rec["wrong_examples"] = wrong[:5]
        rec["ref64_wrong_among_candidates"] = ref_wrong
        rec["seconds"] = time.time() - t0
        print(json.dumps(rec), flush=True)
        del plan, out, ref, terms, b, c
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
