"""Products back to back through ``HybridSpmmPlan.__call__``: the
``repeat`` loop (``loops/repeat.py``: the same B and C, a new output each,
its sync, release, hook and sampling) with the plan made by the program's
structure split, ``sx.split_structure`` (the configuration's ``split`` holds
its arguments beside ``n``), then ``sx.HybridSpmmPlan`` with the
configuration's residue route, DIA backend and precise level.

The check adds ``max_ulp_rest`` to ``max_ulp``: the widest gap outside the
split's hub rows, in ulp of the largest reference magnitude outside them.
A hub row sums hundreds of terms and sets max|C|, so a lower precision in
the diagonals' kernel alone, whose rows sum a few, could hide under
``max_ulp``."""

from __future__ import annotations

import numpy as np
import torch

import sextans_tpu_torch as sx

from bench_torch import port, reference
from bench_torch.loops.repeat import CALLS, Repeat  # noqa: F401  the same hook


class HybridRepeat(Repeat):

    def __init__(self, ctx):
        self.ctx = ctx
        conf = ctx.config
        m, k = ctx.pattern.shape
        self.b = ctx.normal("b", (k, ctx.n))
        self.c = ctx.normal("c", (m, ctx.n))
        ctx.mark("inputs")
        split = sx.split_structure(port.coo(ctx.pattern), n=ctx.n, **conf["split"])
        ctx.mark("pack")
        self.hub_rows = np.asarray(split.head_rows, dtype=np.int64)
        self.plan = sx.HybridSpmmPlan(split, ctx.n, residue_fmt=conf["format"],
                                      residue_config=port.spmm_config(conf),
                                      backend=conf["backend"], dia_backend=conf["dia_backend"],
                                      precise=conf["precise"], device=ctx.device)
        ctx.mark("plan")
        self.product = ctx.hook("product", self.plan)
        for _ in range(int(ctx.traffic["warm_units"])):
            self.step(-1)

    def check(self, samples):
        """The widest gap of a sampled product from the f64 reference, in
        ulp of its largest magnitude, over all rows and over the rows
        outside the hubs."""
        ctx = self.ctx
        m, k = ctx.pattern.shape
        ref = reference.spmm(ctx.coo(), ctx.vals, ctx.normal("b", (k, ctx.n)),
                             ctx.normal("c", (m, ctx.n)), ctx.alpha, ctx.beta)
        rest = torch.ones(m, dtype=torch.bool, device=ref.device)
        rest[torch.as_tensor(self.hub_rows, device=ref.device)] = False
        gaps = [reference.ulp_gap(out, ref) for _, out in samples]
        rests = [rest_gap(out, ref, rest) for _, out in samples]
        return [("max_ulp", reference.worst(gaps)), ("max_ulp_rest", reference.worst(rests))]


def rest_gap(out: torch.Tensor, ref: torch.Tensor, rest: torch.Tensor) -> float:
    """``reference.ulp_gap`` over the rows ``rest`` (a mask) alone; NaN for
    an output of another shape."""
    if tuple(out.shape) != tuple(ref.shape):
        return float("nan")
    return reference.ulp_gap(out[rest.to(out.device)], ref[rest])


def setup(ctx):
    return HybridRepeat(ctx)
