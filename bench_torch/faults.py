"""Faults planted in the timed path, and the control put in its place.

Neither ever runs in a benchmark run: ``test_bench.py`` plants them at a
small size on the CPU and ``calibrate.py`` on the card at a cell's own size,
and both see ``correct`` come out false. Each entry maps the name of a call
that a loop makes through ``Context.hook`` to a wrapper of that call:

* ``product`` — ``f(b, alpha, beta, c) -> C``, the program's product
  (an ``SpmmPlan``; B and C tensors on its device);
* ``value_op`` — ``op(vals, b, c, alpha, beta)``, the training op;
* ``loss`` — ``loss(out, target)``;
* ``optimizer_step`` — ``step()``.

A fault names the calls it breaks; a loop that makes none of them cannot
have that fault (``applies``).
"""

from __future__ import annotations

import torch

from bench_torch import reference

ALTER_BY = 1.0  # added to one element of every answer


def _unchanged_product(f):
    """The product returns its C unchanged."""
    def call(b, alpha, beta, c):
        return c.clone()
    return call


def _half_product(f):
    """The product leaves out half of B's columns (the batch of vectors)."""
    def call(b, alpha, beta, c):
        b = b.clone()
        b[:, b.shape[1] // 2:] = 0.0
        return f(b, alpha, beta, c)
    return call


def _altered_product(f):
    """Every answer has one element altered where it is produced."""
    def call(b, alpha, beta, c):
        out = f(b, alpha, beta, c).clone()
        out.view(-1)[out.numel() // 3] += ALTER_BY
        return out
    return call


def _half_loss(f):
    """The loss leaves out half of the output's rows and takes the mean
    over the rest."""
    def loss(out, target):
        half = out.shape[0] // 2
        return f(out[:half], target[:half])
    return loss


def _no_step(f):
    """The optimizer's step returns its state unchanged."""
    return lambda: None


FAULTS = {
    "unchanged": {"product": _unchanged_product, "optimizer_step": _no_step},
    "half_batch": {"product": _half_product, "loss": _half_loss},
    "altered": {"product": _altered_product},
}


def applies(fault: str, calls) -> bool:
    """Whether a loop that makes ``calls`` can have ``fault``."""
    return bool(set(FAULTS[fault]) & set(calls))


def control(coo: reference.Coo, vals: torch.Tensor) -> dict:
    """The reference in TF32, the precision below the configurations' f32,
    in the program's place: the product and the training op, over A's
    pattern ``coo`` and its values ``vals`` (the run's own, from the seed)."""
    def product(f):
        def call(b, alpha, beta, c):
            return reference.spmm(coo, vals, b, c, alpha, beta, "tf32")
        return call

    return {"product": product, "value_op": lambda f: reference.ControlOp.op(coo)}
