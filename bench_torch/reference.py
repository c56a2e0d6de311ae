"""The plain reference: what the program's outputs are held to.

Plain PyTorch over the benchmark's own COO arrays, in blocks of entries so
that it fits beside nothing else on the card. It imports nothing of the
program and takes nothing the program made: the matrix comes from
``generators/``, every input from ``inputs.py`` and the seed.

* :func:`spmm` — ``alpha * A @ B + beta * C`` in f64, or in a precision
  below the configuration's (``"tf32"``: A's values and B rounded to TF32,
  products summed in f32, as one pass of the tensor cores would), which is
  the control that the comparison has to fail.
* :func:`ulp_gap` — the widest gap of an f32 output from the f64 reference,
  in units of the last place of the reference's largest magnitude.
* :func:`loss_and_grads` — a training step's MSE loss against a target and
  its gradients by hand (the SDDMM for A's values and A^T G for B) in f64.
* :func:`train_reference` — the first training steps: those losses and
  gradients, ``torch.optim.Adam`` on f32 parameters.
* :func:`held_step` — one such step from a given point and Adam state.
* :class:`ControlOp` — the training op in TF32, put in the program's place
  for the control.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

ENTRY_BYTES = 1 << 29  # the gathered (entries, N) block of one pass


@dataclass
class Coo:
    """A's pattern on the device: int64 rows and cols, and its shape."""

    shape: tuple
    rows: torch.Tensor
    cols: torch.Tensor

    @classmethod
    def of(cls, pattern, device) -> "Coo":
        return cls(tuple(pattern.shape),
                   torch.as_tensor(pattern.rows.astype(np.int64), device=device),
                   torch.as_tensor(pattern.cols.astype(np.int64), device=device))

    @property
    def nnz(self) -> int:
        return int(self.rows.numel())

    def blocks(self, n: int, dtype):
        """Entry ranges whose gathered (entries, n) rows hold ENTRY_BYTES."""
        step = max(1, ENTRY_BYTES // (n * torch.finfo(dtype).bits // 8))
        for e0 in range(0, self.nnz, step):
            yield e0, min(self.nnz, e0 + step)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` rounded to TF32 (10 stored mantissa bits), to nearest with
    ties away from zero, as the tensor cores' ``cvt.rna.tf32.f32`` does."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def as_f32(x: float) -> float:
    """``x`` as the f32 number the program is given (0.85 is not one)."""
    return float(np.float32(x))


def a_times(a: Coo, vals: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``A @ x`` in the dtype of ``x``: each block of entries gathers its
    rows of ``x``, scales them by their values and adds them into its rows."""
    out = torch.zeros((a.shape[0], x.shape[1]), dtype=x.dtype, device=x.device)
    for e0, e1 in a.blocks(x.shape[1], x.dtype):
        out.index_add_(0, a.rows[e0:e1], vals[e0:e1, None] * x[a.cols[e0:e1]])
    return out


def at_times(a: Coo, vals: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``A^T @ g`` in the dtype of ``g``."""
    out = torch.zeros((a.shape[1], g.shape[1]), dtype=g.dtype, device=g.device)
    for e0, e1 in a.blocks(g.shape[1], g.dtype):
        out.index_add_(0, a.cols[e0:e1], vals[e0:e1, None] * g[a.rows[e0:e1]])
    return out


def sddmm(a: Coo, g: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``(g @ b^T)`` at A's entries, in the dtype of ``g``."""
    out = torch.empty(a.nnz, dtype=g.dtype, device=g.device)
    for e0, e1 in a.blocks(g.shape[1], g.dtype):
        out[e0:e1] = (g[a.rows[e0:e1]] * b[a.cols[e0:e1]]).sum(dim=1)
    return out


def spmm(a: Coo, vals, b, c, alpha: float, beta: float, precision: str = "float64"):
    """``alpha * A @ b + beta * c``: in f64 (``precision="float64"``, an f64
    result), or with A's values and b rounded to TF32 and the rest in f32
    (``"tf32"``, an f32 result)."""
    alpha, beta = as_f32(alpha), as_f32(beta)
    if precision == "float64":
        return alpha * a_times(a, vals.double(), b.double()) + beta * c.double()
    if precision != "tf32":
        raise ValueError(f"no reference in {precision!r}")
    return alpha * a_times(a, tf32(vals), tf32(b)) + beta * c.to(torch.float32)


def worst(values) -> float:
    """The largest of ``values``; NaN if any is NaN or there are none."""
    values = [float(v) for v in values]
    if not values or any(np.isnan(v) for v in values):
        return float("nan")
    return max(values)


def ulp_gap(out: torch.Tensor, ref: torch.Tensor) -> float:
    """max |out - ref| in units of the last place of f32(max |ref|); NaN
    if ``out`` holds a NaN."""
    if tuple(out.shape) != tuple(ref.shape):
        return float("nan")
    gap = (out.to(ref.device, torch.float64) - ref).abs().max().item()
    return gap / float(np.spacing(np.float32(ref.abs().max().item())))


class ControlOp(torch.autograd.Function):
    """The training op ``alpha * A(vals) @ b + beta * c`` in TF32: the
    forward and both gradients (A^T G, the SDDMM) take their operands
    rounded to TF32 and sum in f32. Called as ``ControlOp.op(a)``."""

    @staticmethod
    def forward(ctx, a, vals, b, c, alpha, beta):
        ctx.a = a
        ctx.save_for_backward(vals, b, alpha)
        return alpha * a_times(a, tf32(vals), tf32(b)) + beta * c

    @staticmethod
    def backward(ctx, g):
        vals, b, alpha = ctx.saved_tensors
        need = ctx.needs_input_grad
        g = tf32(g)
        dvals = alpha * sddmm(ctx.a, g, tf32(b)) if need[1] else None
        db = alpha * at_times(ctx.a, tf32(vals), g) if need[2] else None
        return None, dvals, db, None, None, None

    @staticmethod
    def op(a: Coo):
        """``op(vals, b, c, alpha, beta)`` as the program's value op is
        called (alpha and beta 0-dim tensors, taking no gradient)."""
        return lambda vals, b, c, alpha, beta: ControlOp.apply(a, vals, b, c, alpha, beta)


def loss_and_grads(a: Coo, v, b, c, target, alpha: float, beta: float):
    """The loss ``mean((alpha * A(v) @ b + beta * c - target) ** 2)`` at
    ``v`` and ``b`` and its gradients for A's values and for B (by hand: the
    SDDMM and A^T G), all in f64."""
    alpha, beta = as_f32(alpha), as_f32(beta)
    v64, b64 = v.double(), b.double()
    res = alpha * a_times(a, v64, b64) + beta * c.double() - target.double()
    loss = (res * res).mean().item()
    g = res * (2.0 / res.numel())
    del res
    return loss, alpha * sddmm(a, g, b64), alpha * at_times(a, v64, g)


def train_reference(a: Coo, v0, b0, c, target, alpha: float, beta: float, *,
                    lr: float, steps: int) -> dict:
    """``steps`` Adam steps (``torch.optim.Adam``, ``lr``, torch's default
    betas and eps) on A's values and B from ``v0`` and ``b0``, each on the
    loss of :func:`loss_and_grads`. The loss and its gradients are computed
    in f64; the parameters, their gradients as Adam takes them and Adam's
    state are f32, the configuration's precision, so that the parameters'
    change is rounded as the configuration stores it. Returns each step's
    loss, the first step's gradient norm of each leaf, and the norm of each
    leaf's change after the last step."""
    v = v0.to(torch.float32).clone()
    b = b0.to(torch.float32).clone()
    opt = torch.optim.Adam([v, b], lr=lr)
    losses, grad1 = [], {}
    for step in range(steps):
        loss, dv, db = loss_and_grads(a, v, b, c, target, alpha, beta)
        losses.append(loss)
        if step == 0:
            grad1 = {"vals": dv.norm().item(), "b": db.norm().item()}
        v.grad, b.grad = dv.to(torch.float32), db.to(torch.float32)
        del dv, db
        opt.step()
    change = {"vals": (v.double() - v0.double()).norm().item(),
              "b": (b.double() - b0.double()).norm().item()}
    return {"losses": losses, "grad1": grad1, "change": change}


def held_step(a: Coo, start: dict, adam_state: dict, c, target, alpha: float, beta: float, *,
              lr: float) -> dict:
    """One Adam step from the parameters ``start`` (``"vals"``, ``"b"``)
    and the optimizer's ``adam_state`` (a ``state_dict``) that the
    program's step began from: the loss and each leaf's gradient norm at
    ``start`` (:func:`loss_and_grads`, f64), and each leaf's norm of change
    after ``torch.optim.Adam``'s step on f32 parameters with the f32
    rounding of those gradients."""
    v = start["vals"].to(torch.float32).clone()
    b = start["b"].to(torch.float32).clone()
    loss, dv, db = loss_and_grads(a, v, b, c, target, alpha, beta)
    grad = {"vals": dv.norm().item(), "b": db.norm().item()}
    opt = torch.optim.Adam([v, b], lr=lr)
    opt.load_state_dict(adam_state)
    v.grad, b.grad = dv.to(torch.float32), db.to(torch.float32)
    del dv, db
    opt.step()
    change = {"vals": (v.double() - start["vals"].double()).norm().item(),
              "b": (b.double() - start["b"].double()).norm().item()}
    return {"loss": loss, "grad": grad, "change": change}
