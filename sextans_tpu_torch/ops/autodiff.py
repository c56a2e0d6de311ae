"""Differentiable SpMM: gradients through C = alpha * A @ B + beta * C.

The PyTorch counterpart of ``sextans_tpu.ops.autodiff``: one
``torch.autograd.Function`` whose backward follows the JAX op's term by term,

    d/dB     = alpha * A^T @ G            (the same kernel family, over a pack of A^T)
    d/dC     = beta * G
    d/dvals  = alpha * (G @ B^T)|_pattern (SDDMM, sampled at A's entries)
    d/dalpha = <G, A@B>
    d/dbeta  = <G, C>

``spmm_value_op`` gives the full form ``op(vals, b, c, alpha, beta)``: A's
*structure* is fixed (packed once, steering and host scans uploaded once)
while A's *values* are an input at each call. They are scattered into the
packed buffer on the device through the COO -> slot map
(``format/slots.py``), so the forward runs the same kernels as the inference
path (K3, K1/K2, K4, K5 or a plain engine). The plans walk the pack's
structure, not its values at build time (``SpmmPlan(structure=...)``): a
block, stripe visit or virtual row that holds an entry is walked whatever
its value. ``spmm_op`` keeps the simple ``op(b, c)`` with vals, alpha and
beta closed over.

The scatter is PyTorch ops, as it is XLA ops in the JAX package (no Pallas
kernel there). It adds in COO entry order on every device (one pass per
rank of ``ops/launch.py:rank_groups``), so scattering ``a.vals`` gives
``packed.vals`` to the bit. The SDDMM (``ops/sddmm.py:sddmm_rows``) is a
hand-written kernel on the card, over a host plan of A's entries made once
per op, and its plain version on the CPU; both multiply-add in f32 and sum
over N, never a contraction, so TF32 cannot touch it.

``device`` is required, as it is for ``plan`` and ``SpmmPlan``: the JAX op
takes none.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from sextans_tpu_torch.format.coo import COOMatrix
from sextans_tpu_torch.format.slots import slot_map
from sextans_tpu_torch.ops.launch import rank_groups
from sextans_tpu_torch.ops.plan import FORMATS, SpmmPlan, dense_operand, resolve_device
from sextans_tpu_torch.ops.sddmm import sddmm_plan, sddmm_rows
from sextans_tpu_torch.utils.config import SpmmConfig
from sextans_tpu_torch.utils.profiling import annotate, timed

__all__ = ["spmm_op", "spmm_value_op", "SpmmValueOp", "bwd_backend", "structure_mask"]


@timed("upload_s")
def structure_mask(packed, slots: np.ndarray) -> np.ndarray:
    """The slots of ``packed.vals`` that its COO entries fill (``slots``:
    :func:`~sextans_tpu_torch.format.slots.slot_map` of the matrix it was
    packed from), as a bool array of the values' shape: the ``live`` mask of
    the scans for a plan whose values are given at call time."""
    live = np.zeros(packed.vals.size, dtype=bool)
    live[slots] = True
    return live.reshape(packed.vals.shape)


class ValueScatter:
    """COO values -> a pack's value buffer, ``flat[slots[e]] += vals[e]`` in
    COO entry order on every device: one pass per rank of
    :func:`~sextans_tpu_torch.ops.launch.rank_groups` (made once), each of
    which adds into a slot at most once, so duplicates sum in entry order,
    as the packs' ``np.add.at`` sums them. ``index_add_`` and
    ``index_put_(accumulate=True)`` on CUDA add duplicates in atomic order."""

    @timed("upload_s")
    def __init__(self, slots: np.ndarray, shape, device: torch.device):
        self.shape = tuple(shape)
        self.numel = int(np.prod(self.shape))
        self.device = device
        idx = torch.as_tensor(np.asarray(slots, dtype=np.int64), device=device)
        self.groups = ([(idx[sel], sel) for sel in rank_groups(idx)] if idx.numel() else [])

    def __call__(self, vals: torch.Tensor) -> torch.Tensor:
        with annotate("sx.autodiff.scatter"):
            flat = torch.zeros(self.numel, dtype=torch.float32, device=self.device)
            for idx, sel in self.groups:
                flat[idx] = flat[idx] + vals[sel]
            return flat.view(self.shape)


def bwd_backend(backend: str, fwd_plan: SpmmPlan) -> str:
    """The transpose pack is the same format family, so reuse the forward
    plan's *resolved* backend (an explicit request passes through)."""
    return backend if backend != "auto" else fwd_plan.backend


class SpmmValueOp:
    """``op(vals, b, c, alpha, beta) = alpha * A(vals) @ b + beta * c``,
    differentiable in all five (see the module docstring); built by
    :func:`spmm_value_op`. Its parts are methods, so that a caller can time
    them apart: :meth:`ab`, :meth:`atg` (each a scatter and one kernel) and
    :meth:`sddmm`."""

    def __init__(self, a: COOMatrix, n: int, *, backend: str = "auto",
                 config: Optional[SpmmConfig] = None, fmt: str = "vpu", device):
        if fmt not in FORMATS:
            raise ValueError(f"unknown pack format {fmt!r}; expected one of {tuple(FORMATS)}")
        cfg = config or SpmmConfig()
        self.device = resolve_device(device)
        self.shape, self.n, self.nnz = a.shape, n, a.nnz
        at = a.transpose()
        packed, packed_t = FORMATS[fmt](a, cfg), FORMATS[fmt](at, cfg)
        slots, slots_t = slot_map(a, cfg, fmt), slot_map(at, cfg, fmt)
        self.fwd_plan = SpmmPlan(packed, n, backend, device=self.device,
                                 structure=structure_mask(packed, slots))
        self.bwd_plan = SpmmPlan(packed_t, n, bwd_backend(backend, self.fwd_plan),
                                 device=self.device, structure=structure_mask(packed_t, slots_t))
        self.scatter = ValueScatter(slots, packed.vals.shape, self.device)
        self.scatter_t = ValueScatter(slots_t, packed_t.vals.shape, self.device)
        self.rows = torch.as_tensor(a.rows.astype(np.int64), device=self.device)
        self.cols = torch.as_tensor(a.cols.astype(np.int64), device=self.device)
        self.sddmm_tiles = sddmm_plan(a.rows, a.cols, a.shape, self.device)

    @staticmethod
    def _product(plan: SpmmPlan, pv: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """``A @ b`` for packed values ``pv``, unscaled, through ``plan``'s
        kernel (alpha 1, no C), B and the output at the rows its calls take
        (:meth:`~sextans_tpu_torch.ops.plan.SpmmPlan.operands`)."""
        return plan.unpad(plan.run_values(pv, *plan.operands(b), 1.0, 0.0, with_c=False))

    def ab(self, vals: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """``A(vals) @ b`` through the pack's kernel."""
        with annotate("sx.autodiff.ab"):
            return self._product(self.fwd_plan, self.scatter(vals), b)

    def atg(self, vals: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        """``A(vals)^T @ g`` through the transpose pack's kernel."""
        with annotate("sx.autodiff.atg"):
            return self._product(self.bwd_plan, self.scatter_t(vals), g)

    def sddmm(self, g: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """``dvals[e] = g[rows[e]] . b[cols[e]]`` in f32
        (:func:`~sextans_tpu_torch.ops.sddmm.sddmm_rows`: the kernel over the
        op's tiles on the card, the plain version on the CPU)."""
        with annotate("sx.autodiff.sddmm"):
            return sddmm_rows(g.contiguous(), b.contiguous(), self.rows, self.cols,
                              tiles=self.sddmm_tiles)

    def __call__(self, vals, b, c, alpha, beta) -> torch.Tensor:
        m, k = self.shape
        dev = self.device
        vals = dense_operand(vals, (self.nnz,), "vals", dev)
        b = dense_operand(b, (k, self.n), "B", dev)
        c = dense_operand(c, (m, self.n), "C", dev)
        alpha = dense_operand(alpha, (), "alpha", dev)
        beta = dense_operand(beta, (), "beta", dev)
        return _SpmmValueFn.apply(self, vals, b, c, alpha, beta)


class _SpmmValueFn(torch.autograd.Function):
    """The forward and backward of ``autodiff.py:130-147`` of the JAX
    package, each gradient made only where its input needs one."""

    @staticmethod
    def forward(ctx, op: SpmmValueOp, vals, b, c, alpha, beta):
        ab = op.ab(vals, b)
        ctx.op = op
        ctx.save_for_backward(vals, b, c, alpha, beta, ab if ctx.needs_input_grad[4] else None)
        return alpha * ab + beta * c

    @staticmethod
    def backward(ctx, g):
        op = ctx.op
        vals, b, c, alpha, beta, ab = ctx.saved_tensors
        need = ctx.needs_input_grad
        g = g.to(torch.float32).contiguous()
        dvals = alpha * op.sddmm(g, b) if need[1] else None
        db = alpha * op.atg(vals, g) if need[2] else None
        dc = beta * g if need[3] else None
        dalpha = torch.dot(g.reshape(-1), ab.reshape(-1)) if need[4] else None
        dbeta = torch.dot(g.reshape(-1), c.reshape(-1)) if need[5] else None
        return None, dvals, db, dc, dalpha, dbeta


def spmm_value_op(
    a: COOMatrix,
    n: int,
    *,
    backend: str = "auto",
    config: Optional[SpmmConfig] = None,
    fmt: str = "vpu",
    device,
) -> SpmmValueOp:
    """Build the fully differentiable ``op(vals, b, c, alpha, beta)``.

    * ``vals`` — (nnz,) values of A in ``a``'s COO entry order (the
      structure — coordinates, tiling, steering — is fixed at build time);
    * gradients flow to all five arguments (see the module docstring);
      ``alpha`` and ``beta`` may be numbers or 0-dim tensors;
    * ``fmt`` selects the packed format and kernel family ("vpu", "mxu",
      "edge", "ell") for both the forward product and the A^T product;
    * ``device`` is where the op runs (``"cuda"``, or ``"cpu"`` for the
      plain versions); inputs elsewhere are copied there, differentiably.
    """
    return SpmmValueOp(a, n, backend=backend, config=config, fmt=fmt, device=device)


def spmm_op(
    a: COOMatrix,
    n: int,
    alpha: float = 1.0,
    beta: float = 0.0,
    *,
    backend: str = "auto",
    config: Optional[SpmmConfig] = None,
    fmt: str = "vpu",
    device,
):
    """Convenience wrapper: ``f(b, c) -> alpha*A@b + beta*c`` with A's
    values, alpha and beta closed over as constants. Differentiable with
    respect to ``b`` and ``c``; use :func:`spmm_value_op` for d/dvals (SDDMM)
    and for alpha and beta as inputs."""
    full = spmm_value_op(a, n, backend=backend, config=config, fmt=fmt, device=device)
    vals0 = torch.as_tensor(a.vals.astype(np.float32), device=full.device)
    al = torch.tensor(alpha, dtype=torch.float32, device=full.device)
    be = torch.tensor(beta, dtype=torch.float32, device=full.device)

    def op(b, c):
        return full(vals0, b, c, al, be)

    return op
