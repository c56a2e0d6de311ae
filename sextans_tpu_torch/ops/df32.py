"""Double-float32 (error-free transform) arithmetic for precise mode, and
the EFT probe.

``two_sum``, ``two_prod``, ``acc_step`` and ``compensated_epilogue`` are
the twins of ``sextans_tpu.ops.df32``'s, on f32 tensors; the plain versions
of the kernels use them, and ``csrc/df32.cuh`` holds the same four for the
CUDA kernels. PyTorch runs each elementwise op on its own and rounds it
once, so here they are exact, where XLA:CPU (which contracts a multiply and
an add into one FMA) is only faithful. ``two_prod`` takes the FMA form,
``e = fma(a, b, -p)``: the same (p, e) as the JAX package's Dekker split
wherever that is exact (no overflow in the split, no underflow).

``add_rows_compensated`` is the precise counterpart of
:func:`~sextans_tpu_torch.ops.launch.add_rows_in_order`: a Neumaier step per
row visit, in visit order.

``acc_step_bounded``, ``add_rows_bounded``, ``checked_epilogue``,
``nearest_f32`` and ``nearest_epilogue`` are the twins of ``csrc/df32.cuh``'s
level 2 with a rounding check (the edge kernel K4): the pair's steps also
gather a bound on its error, the epilogue says where its f32 may not be the
nearest one, and those elements are summed again from f64. The pair and
the result take the kernel's roundings; the bound is gathered in another
order (a run's own, then its flush) and without the kernel's pad steps.
Each bound is rigorous, so wherever either is sure its f32 is the nearest
one, and the outputs agree to the bit.

``eft_probe_pairs`` and ``eft_probe_chain`` are the twin of the TPU probe P3
(``benchmarks/scratch/mosaic_eft_probe.py``): on a CUDA tensor each
launches its kernel in ``csrc/df32_probe.cu``, on a CPU tensor it runs its
plain version. ``probe_inputs`` makes the probe's inputs and
``probe_report`` counts what it asks about.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from sextans_tpu_torch.ops.launch import f32, need, rank_groups, stream_of
from sextans_tpu_torch.runtime.build import build_kernels, check_launch
from sextans_tpu_torch.utils.profiling import count

__all__ = [
    "two_sum",
    "two_prod",
    "acc_step",
    "compensated_epilogue",
    "add_rows_compensated",
    "acc_step_bounded",
    "add_rows_bounded",
    "checked_epilogue",
    "nearest_f32",
    "nearest_epilogue",
    "probe_inputs",
    "eft_probe_pairs",
    "eft_probe_pairs_ref",
    "eft_probe_chain",
    "eft_probe_chain_ref",
    "probe_report",
]


def two_sum(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact addition: ``s = fl(a + b)`` and ``s + e == a + b``."""
    s = a + b
    v = s - a
    e = (a - (s - v)) + (b - v)
    return s, e


def two_prod(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact product: ``p = fl(a * b)`` and ``p + e == a * b`` (no
    underflow). ``e`` is ``fma(a, b, -p)``, taken as ``a * b - p`` in f64:
    the product of two f32 values is exact there, and so is its difference
    from ``p`` (at most 24 significant bits), so the one rounding to f32 is
    the FMA's (``fma_f32`` gives the same bits in more passes)."""
    p = a * b
    return p, (a.double() * b.double() - p.double()).float()


def acc_step(acc, comp, x, xerr=None):
    """Neumaier-compensated accumulate: ``(acc', comp')`` with ``acc' -
    comp' == (acc - comp) + x + xerr`` up to the rounding of ``comp``.
    ``comp`` is the amount by which ``acc`` overstates the true sum;
    ``xerr`` an exact residual of ``x`` to add (a two_prod error)."""
    t, e = two_sum(acc, x)
    c = comp - e
    if xerr is not None:
        c = c - xerr
    return t, c


def compensated_epilogue(alpha, total, comp, beta=None, cin=None):
    """``alpha * (total - comp) + beta * cin`` with every product and sum
    compensated and one final rounding; ``beta=None`` for the no-C form
    ``alpha * (total - comp)``. ``alpha`` and ``beta`` are scalars, rounded
    to f32 as a kernel receives them."""
    a = torch.tensor(f32(alpha), dtype=torch.float32, device=total.device)
    p, pe = two_prod(a, total)
    err = pe - a * comp
    if beta is None or cin is None:
        return p + err
    bt = torch.tensor(f32(beta), dtype=torch.float32, device=total.device)
    q, qe = two_prod(bt, cin)
    s, se = two_sum(p, q)
    return s + ((err + qe) + se)


def add_rows_compensated(acc: torch.Tensor, comp: torch.Tensor, index: torch.Tensor,
                         x: torch.Tensor, xerr: Optional[torch.Tensor] = None) -> None:
    """``acc[index[i]], comp[index[i]] = acc_step(acc[index[i]],
    comp[index[i]], x[i], xerr[i])`` for every i, in i order, in place.

    A kernel steps each accumulator row through its visits in pack order.
    Here each visit gets its rank among the visits to the same row; one
    step per rank then touches each row at most once."""
    if index.numel() == 0:
        return
    for sel in rank_groups(index):
        rows = index[sel]
        t, c = acc_step(acc[rows], comp[rows], x[sel], None if xerr is None else xerr[sel])
        acc[rows] = t
        comp[rows] = c


# ---- level 2 with a rounding check (csrc/df32.cuh, K4) ----

def acc_step_bounded(acc, comp, bound, p, pe):
    """``(acc, comp) += p + pe`` with the step's two errors summed first,
    ``comp' = comp - fl(e + pe)``, and ``bound + |comp'|``: over a run of
    such steps from ``comp = 0`` the pair's error is at most 3.0001 * 2**-24
    * the bound's gain (``df32.cuh:acc_step_bounded``, which adds ``|comp'|``
    to the bound in the other order)."""
    t, e = two_sum(acc, p)
    c = comp - (e + pe)
    return t, c, bound + c.abs()


def add_rows_bounded(acc: torch.Tensor, comp: torch.Tensor, bound: torch.Tensor,
                     index: torch.Tensor, x: torch.Tensor, xc: torch.Tensor,
                     xb: torch.Tensor) -> None:
    """Each run's flush into its row, in visit order, in place: ``acc_step``
    of the run's sum ``x``, then ``comp + xc``; the row's bound gathers the
    run's own bound ``xb`` and the magnitudes of those two roundings (the
    kernel's ``df32.cuh:flush_bounded`` has its run's steps in the row's
    bound already)."""
    if index.numel() == 0:
        return
    for sel in rank_groups(index):
        rows = index[sel]
        t, e = two_sum(acc[rows], x[sel])
        c1 = comp[rows] - e
        c2 = c1 + xc[sel]
        acc[rows] = t
        comp[rows] = c2
        bound[rows] = ((bound[rows] + xb[sel]) + c1.abs()) + c2.abs()


def checked_epilogue(alpha, total, comp, bound, beta=None, cin=None):
    """:func:`compensated_epilogue`'s result ``r``, to the bit, and where
    ``r`` may not be the f32 nearest to ``alpha * (total - comp) + beta *
    cin`` when the pair is the exact sum to within ``2**-22 * bound``: ``r +
    d`` is the epilogue's sum before its rounding, each of its roundings is
    at most 2**-24 of its result, and ``r`` is sure where ``|d|`` and those
    errors stay under half the gap to ``r``'s nearer neighbour. A
    non-finite ``r`` reads as sure (``df32.cuh:checked_epilogue``)."""
    a = torch.tensor(f32(alpha), dtype=torch.float32, device=total.device)
    p, pe = two_prod(a, total)
    ac = a * comp
    err = pe - ac
    s, tail = p, err
    slack = ac.abs() + err.abs()
    if beta is not None and cin is not None:
        bt = torch.tensor(f32(beta), dtype=torch.float32, device=total.device)
        q, qe = two_prod(bt, cin)
        s, se = two_sum(p, q)
        t1 = err + qe
        tail = t1 + se
        slack = (slack + t1.abs()) + tail.abs()
    r, d = two_sum(s, tail)
    margin = d.abs() + (a.abs() * bound + slack) * 2.0**-22
    bits = r.view(torch.int32)
    ef = (bits >> 23) & 0xFF
    shift = torch.where((bits & 0x7FFFFF) != 0, 24, 25)
    half_gap = torch.where(ef > shift, (ef - shift) << 23, 0).to(torch.int32).view(torch.float32)
    return r, (margin >= half_gap) & (margin > 0)


def _prod_err(a: float, x: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """``a * x - p`` exactly, for an f32 ``a``, an f64 ``x`` and ``p =
    fl(a * x)``: the residual of an FMA, by Dekker's product with ``x``
    split into halves of 26 bits (each product with ``a`` is exact)."""
    c = 134217729.0 * x  # 2**27 + 1
    hi = c - (c - x)
    return (a * hi - p) + a * (x - hi)


def nearest_f32(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """The f32 nearest to ``hi + lo`` (f64): their sum rounded to odd, then
    to f32, which with 53 >= 24 + 2 bits is one rounding."""
    z, zl = two_sum(hi, lo)
    bits = z.view(torch.int64)
    step = torch.where((zl > 0) == (z > 0), 1, -1)
    bits = torch.where((zl != 0) & ((bits & 1) == 0), bits + step, bits)
    return bits.view(torch.float64).float()


def nearest_epilogue(acc: torch.Tensor, comp: torch.Tensor, alpha, beta=None,
                     cin=None) -> torch.Tensor:
    """``alpha * (acc - comp) + beta * cin`` (or without C) for f64 pairs,
    rounded once to f32 (``df32.cuh:nearest_epilogue``)."""
    a = f32(alpha)
    p = a * acc
    lo = _prod_err(a, acc, p) - a * comp
    hi = p
    if beta is not None and cin is not None:
        hi, se = two_sum(p, f32(beta) * cin.double())
        lo = lo + se
    return nearest_f32(hi, lo)


# ---- P3's twin: the EFT probe ----

def probe_inputs(seed: int = 0):
    """The TPU probe's inputs, drawn in its order from one numpy generator:
    ``a``, ``b`` (8, 128) standard normal scaled by 10**[-6, 6), then ``v``,
    ``bb`` (64, 128) standard normal; all f32."""
    rng = np.random.default_rng(seed)

    def scaled():
        return (rng.standard_normal((8, 128))
                * 10.0 ** rng.integers(-6, 6, (8, 128)).astype(np.float64)).astype(np.float32)

    a, b = scaled(), scaled()
    v = rng.standard_normal((64, 128)).astype(np.float32)
    bb = rng.standard_normal((64, 128)).astype(np.float32)
    return a, b, v, bb


def eft_probe_pairs_ref(a: torch.Tensor, b: torch.Tensor):
    """Plain version: ``(s, e, p, pe)`` of ``two_sum(a, b)`` and
    ``two_prod(a, b)``."""
    return (*two_sum(a, b), *two_prod(a, b))


def eft_probe_pairs(a: torch.Tensor, b: torch.Tensor):
    """``(s, e, p, pe)``: two_sum and two_prod of two same-shaped f32
    tensors, elementwise, by the probe kernel on a CUDA tensor."""
    if a.device.type == "cpu":
        return eft_probe_pairs_ref(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"df32_probe runs on cpu or cuda, not {a.device}")
    if a.numel() == 0:
        raise ValueError("the probe needs at least one element")
    need(a, "a", torch.float32, a.shape, a.device)
    need(b, "b", torch.float32, a.shape, a.device)
    outs = [torch.empty_like(a) for _ in range(4)]
    lib = build_kernels()
    with torch.cuda.device(a.device):
        err = lib.df32_probe_pairs(a.data_ptr(), b.data_ptr(),
                                   *(o.data_ptr() for o in outs), a.numel(),
                                   stream_of(a.device))
    check_launch(lib, "df32_probe_pairs", err)
    count("launch.eft_probe_pairs")
    return tuple(outs)


def eft_probe_chain_ref(v: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version: per column, ``two_prod`` + ``acc_step`` over the rows
    in order, then ``compensated_epilogue(1, acc, comp)``."""
    acc = torch.zeros_like(v[0])
    comp = torch.zeros_like(v[0])
    for j in range(v.shape[0]):
        acc, comp = acc_step(acc, comp, *two_prod(v[j], b[j]))
    return compensated_epilogue(1.0, acc, comp)


def eft_probe_chain(v: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The compensated dot product of each column of two (terms, width) f32
    tensors, by the probe kernel on a CUDA tensor."""
    if v.device.type == "cpu":
        return eft_probe_chain_ref(v, b)
    if v.device.type != "cuda":
        raise ValueError(f"df32_probe runs on cpu or cuda, not {v.device}")
    if v.dim() != 2 or v.shape[1] == 0:
        raise ValueError("v must be (terms, width) with width >= 1")
    need(v, "v", torch.float32, v.shape, v.device)
    need(b, "b", torch.float32, v.shape, v.device)
    out = torch.empty(v.shape[1], dtype=torch.float32, device=v.device)
    lib = build_kernels()
    with torch.cuda.device(v.device):
        err = lib.df32_probe_chain(v.data_ptr(), b.data_ptr(), out.data_ptr(),
                                   v.shape[0], v.shape[1], stream_of(v.device))
    check_launch(lib, "df32_probe_chain", err)
    count("launch.eft_probe_chain")
    return out


def probe_report(a, b, v, bb, pairs, chain) -> Dict[str, float]:
    """What the probe asks, from its numpy inputs and outputs: elements
    where ``s + e != a + b`` or ``p + pe != a * b`` in f64 (violations),
    where ``s`` or ``p`` differ from numpy's f32 ``a + b`` or ``a * b``, and
    for the chain the largest error over f64 beyond the f32 representation
    floor of the exact dot product, and the columns above that floor."""
    s, e, p, pe = (np.asarray(x, dtype=np.float64) for x in pairs)
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    v1 = np.abs((s + e) - (a64 + b64))
    v2 = np.abs((p + pe) - a64 * b64)
    exact = (v.astype(np.float64) * bb.astype(np.float64)).sum(0)
    err = np.abs(np.asarray(chain, dtype=np.float64) - exact)
    floor = np.abs(exact.astype(np.float32).astype(np.float64) - exact)
    return {
        "two_sum_violations": int((v1 > 0).sum()),
        "two_prod_violations": int((v2 > 0).sum()),
        "add_mismatches": int((pairs[0] != a + b).sum()),
        "mul_mismatches": int((pairs[2] != a * b).sum()),
        "chain_excess": float((err - floor).max()),
        "chain_above_floor": int((err > floor + 1e-12).sum()),
    }
