"""Training steps of ``spmm_value_op``: learn A's values and B so that
``alpha * A(vals) @ b + beta * C`` meets a target made from A's own values
(the run's, drawn from the seed) and the seeded B, from seeded normal
values. Each step runs ``zero_grad``, the forward pass, the MSE loss,
backward and ``torch.optim.Adam([vals, b])``; none reads a value back to
the host.

Set-up builds the one op, its parameters and optimizer, and drives them
through the first ``check_steps`` steps by the window's own ``step``; the
window goes on from there with the same objects, and once it has closed
one more step by the same call (the held step) starts from the parameters
and the optimizer's state as the window left them, so that a step that
behaves otherwise once set-up is over is seen too. The check holds the
first steps to the f64 reference: each step's loss, the first gradient's
norm as Adam holds it after one step (its first moment over 1 - beta1), and
the norm of each parameter's change after the last of them. It holds the
held step to the reference started from that step's parameters and Adam
state: its loss, each leaf's gradient norm, and each leaf's change. Norms
are compared by each leaf's gap of norms against the larger of the
reference's norm of that leaf and of the median leaf. A leaf whose
reference gradient is under a thousandth of the median leaf's moves by
rounding alone and is left out of the changes.
"""

from __future__ import annotations

import copy
import statistics

import numpy as np
import torch

import sextans_tpu_torch as sx

from bench_torch import port, reference

LEAVES = ("vals", "b")


CALLS = ("value_op", "loss", "optimizer_step")  # the hooks this loop makes (faults.py)


class Train:

    def __init__(self, ctx):
        self.ctx = ctx
        tr = ctx.traffic
        m, k = ctx.pattern.shape
        self.lr = float(tr["lr"])
        self.steps = int(tr["check_steps"])
        c = ctx.normal("c", (m, ctx.n))
        b0 = ctx.normal("b", (k, ctx.n))
        ctx.mark("inputs")
        with ctx.apart():  # the target: the plain reference at A's own values, rounded to f32
            self.target = reference.spmm(ctx.coo(), ctx.vals, b0, c, ctx.alpha,
                                         ctx.beta).to(torch.float32)
        ctx.mark("target")
        op = sx.spmm_value_op(port.coo(ctx.pattern), ctx.n, config=port.spmm_config(ctx.config),
                              fmt=ctx.config["format"], backend=ctx.config["backend"],
                              device=ctx.device)
        ctx.mark("value_op")
        self.c = c
        self.vals = ctx.normal("vals0", (ctx.pattern.nnz,)).requires_grad_()
        self.b = b0.clone().requires_grad_()
        self.al = torch.tensor(float(np.float32(ctx.alpha)), device=ctx.device)
        self.be = torch.tensor(float(np.float32(ctx.beta)), device=ctx.device)
        self.opt = torch.optim.Adam([self.vals, self.b], lr=self.lr)
        self.op = ctx.hook("value_op", op)
        self.loss = ctx.hook("loss", lambda out, target: torch.mean((out - target) ** 2))
        self.opt_step = ctx.hook("optimizer_step", self.opt.step)
        self.losses = []
        for i in range(self.steps):
            self.losses.append(self.step(i))
            if i == 0:
                self.moment1 = {name: self._state(p, "exp_avg") for name, p in self._leaves()}
        self.after = self._params()
        ctx.mark("check_steps")
        for i in range(int(tr["warm_units"])):
            self.step(self.steps + i)

    def _leaves(self):
        return zip(LEAVES, (self.vals, self.b))

    def _params(self) -> dict:
        return {name: p.detach().clone() for name, p in self._leaves()}

    def _state(self, p, key):
        state = self.opt.state.get(p, {})
        return state[key].detach().clone() if key in state else None

    def step(self, i):
        """One training step; returns its loss (on the device)."""
        span = self.ctx.span
        with span("train.zero_grad"):
            self.opt.zero_grad()
        with span("train.forward"):
            loss = self.loss(self.op(self.vals, self.b, self.c, self.al, self.be), self.target)
        with span("train.backward"):
            loss.backward()
        with span("train.optimizer"):
            self.opt_step()
        return loss.detach()

    def sync(self):
        self.ctx.sync()

    def release(self):
        """Run the held step (see the module) and keep what the check
        needs of it; then drop the program's state."""
        self.held_from = self._params()
        self.held_state = copy.deepcopy(self.opt.state_dict())
        self.held_loss = self.step(-1)
        self.held_grad = {name: None if p.grad is None else p.grad.detach().clone()
                          for name, p in self._leaves()}
        self.held_to = self._params()
        self.sync()
        del self.op, self.opt, self.opt_step, self.vals, self.b, self.loss

    def check(self, samples):
        """``loss``, ``grad1``, ``change``: the first steps; ``held_loss``,
        ``held_grad``, ``held_change``: the held step. Losses by their
        relative gap, norms by the worst leaf's gap (see the module)."""
        ctx = self.ctx
        m, k = ctx.pattern.shape
        a = ctx.coo()
        c = ctx.normal("c", (m, ctx.n))
        v0 = ctx.normal("vals0", (ctx.pattern.nnz,))
        b0 = ctx.normal("b", (k, ctx.n))
        ref = reference.train_reference(a, v0, b0, c, self.target, ctx.alpha, ctx.beta,
                                        lr=self.lr, steps=self.steps)
        beta1 = 0.9  # torch.optim.Adam's default
        grad1 = {name: (float("nan") if mom is None else mom.double().norm().item() / (1 - beta1))
                 for name, mom in self.moment1.items()}
        kept = [n for n in LEAVES
                if ref["grad1"][n] >= 1e-3 * statistics.median(ref["grad1"].values())]
        held = reference.held_step(a, self.held_from, self.held_state, c, self.target,
                                   ctx.alpha, ctx.beta, lr=self.lr)
        held_grad = {name: float("nan") if g is None else g.double().norm().item()
                     for name, g in self.held_grad.items()}
        return [("loss", loss_gap([float(x) for x in self.losses], ref["losses"])),
                ("grad1", worst_leaf(grad1, ref["grad1"], LEAVES)),
                ("change", worst_leaf(change({"vals": v0, "b": b0}, self.after),
                                      ref["change"], kept)),
                ("held_loss", loss_gap([float(self.held_loss)], [held["loss"]])),
                ("held_grad", worst_leaf(held_grad, held["grad"], LEAVES)),
                ("held_change", worst_leaf(change(self.held_from, self.held_to),
                                           held["change"], kept))]


def loss_gap(got, want) -> float:
    """The widest relative gap of a loss from the reference's."""
    return reference.worst(abs(g - w) / abs(w) for g, w in zip(got, want))


def change(start: dict, end: dict) -> dict:
    """Each leaf's norm of its change from ``start`` to ``end``."""
    return {name: (end[name].double() - start[name].double()).norm().item() for name in end}


def worst_leaf(got: dict, want: dict, leaves) -> float:
    """The largest of ``|got - want|`` over ``leaves``, each against the
    larger of its own ``want`` and the median leaf's."""
    median = statistics.median(want[n] for n in leaves)
    return reference.worst(abs(got[n] - want[n]) / max(want[n], median) for n in leaves)


def setup(ctx):
    return Train(ctx)
