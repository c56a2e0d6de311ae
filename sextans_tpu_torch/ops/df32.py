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
