"""Products back to back through ``SpmmPlan.__call__`` (the reference
host's ``rp_time`` loop, which re-reads its inputs): each product reads the
same device-resident B and C and writes a new output. Not chained through
C: with beta = -2.06 a chained C overflows within about 120 products."""

from __future__ import annotations

import sextans_tpu_torch as sx

from bench_torch import port, reference


CALLS = ("product",)  # the hooks this loop makes (faults.py)


class Repeat:

    def __init__(self, ctx):
        self.ctx = ctx
        m, k = ctx.pattern.shape
        self.b = ctx.normal("b", (k, ctx.n))
        self.c = ctx.normal("c", (m, ctx.n))
        ctx.mark("inputs")
        packed = port.packed(ctx.config, ctx.pattern)
        ctx.mark("pack")
        self.plan = sx.plan(packed, ctx.n, ctx.config["backend"], device=ctx.device)
        ctx.mark("plan")
        self.product = ctx.hook("product", self.plan)
        for _ in range(int(ctx.traffic["warm_units"])):
            self.step(-1)

    def step(self, i):
        with self.ctx.span("plan.call"):
            return self.product(self.b, self.ctx.alpha, self.ctx.beta, self.c)

    def sync(self):
        self.ctx.sync()

    def release(self):
        del self.plan, self.product, self.b, self.c

    def check(self, samples):
        """The widest gap of a sampled product from the f64 reference, in
        ulp of its largest magnitude."""
        ctx = self.ctx
        m, k = ctx.pattern.shape
        ref = reference.spmm(ctx.coo(), ctx.vals, ctx.normal("b", (k, ctx.n)),
                             ctx.normal("c", (m, ctx.n)), ctx.alpha, ctx.beta)
        gaps = [reference.ulp_gap(out, ref) for _, out in samples]
        return [("max_ulp", reference.worst(gaps))]


def setup(ctx):
    return Repeat(ctx)
