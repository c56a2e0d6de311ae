"""SpMM over the ELL gather pack (format/pack_ell.py).

``spmm_ell_gather_padded`` is the twin of ``sextans_tpu.ops.spmm_ell_pallas``'s
``spmm_ell_gather_padded`` (kernel K5) and its hub fold: on a CUDA tensor it
launches the hand-written kernel in ``csrc/spmm_ell.cu``, which walks the
tiles of the host scan :func:`~sextans_tpu_torch.ops.launch.ell_tiles`
(``SpmmPlan.ranges``) and folds the virtual hub rows itself; on a CPU tensor
it runs the plain PyTorch version ``spmm_ell_gather_padded_ref``. Any other
device raises.

``spmm_ell_padded_ref`` is the plain twin of
``sextans_tpu.ops.spmm_ell_xla.spmm_ell_padded``, the engine of backend
``"ell"`` on any device. The two engines differ where the JAX package's do:

* ``ell`` multiplies every slot, pads included (``0 * B[0]``, NaN for a
  non-finite ``B[0]``), folds the virtual rows into ``A @ B`` and then
  applies ``alpha``/``beta``;
* ``ell_pallas`` selects out every slot whose value is 0, applies
  ``alpha``/``beta`` to every padded row that C holds (``alpha`` alone to
  the rest), and then folds ``out[m_base + j] - beta * C[m_base + j]``
  into ``fold_rows[j]`` (``out[m_base + j]`` alone where C has no such
  row), which stays exact when C is the live carry of ``SpmmPlan.repeat``.
  C and the result have the caller's M rows or the padded ones.

``precise`` (``SpmmConfig.precise``; 1 and 2 are one computation here, as
in the JAX package, whose ELL engines take one ``precise`` flag): ``ell``
sums, folds and applies ``alpha``/``beta`` in f64 and rounds once;
``ell_pallas`` runs K5's compensated slots and epilogue (``ops/df32.py``)
and then the hub fold in f64, rounding once. The JAX package folds in f64
only under ``jax.enable_x64`` and in f32 otherwise; PyTorch always has f64,
so the port always takes the f64 fold.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from sextans_tpu_torch.ops.df32 import acc_step, compensated_epilogue, two_prod
from sextans_tpu_torch.ops.launch import (
    ELL_GROUP_MAX,
    EllTiles,
    Launch,
    add_rows_in_order,
    check_csr,
    f32,
    fma_f32,
    need,
    stream_of,
)
from sextans_tpu_torch.runtime.build import build_kernels, check_launch
from sextans_tpu_torch.utils.profiling import annotate, count

__all__ = ["spmm_ell_gather_padded", "spmm_ell_gather_padded_ref", "spmm_ell_padded_ref",
           "ell_launch", "ELL_VEC4_MIN_N"]

# K5 (csrc/spmm_ell.cu): threads a CTA, and the least N that its 16-byte
# loads take (below it, four times the threads on 4-byte loads)
ELL_THREADS = 256
ELL_VEC4_MIN_N = 16

# Bytes of one (rows, n) temporary per step of the plain versions.
_REF_CHUNK_BYTES = 256 << 20


def _row_steps(m_padded: int, n: int, itemsize: int = 4):
    step = max(1, _REF_CHUNK_BYTES // (itemsize * n))
    return ((r0, min(m_padded, r0 + step)) for r0 in range(0, m_padded, step))


def spmm_ell_padded_ref(
    vals: torch.Tensor,  # (m_padded, R) f32
    cols: torch.Tensor,  # (m_padded, R) i32
    fold_rows: torch.Tensor,  # (n_virt,) i32
    b_padded: torch.Tensor,  # (k, n) f32
    c_padded: torch.Tensor,  # (m_padded, n) f32
    alpha: float,
    beta: float,
    *,
    m_base: int,
    with_c: bool = True,
    precise: int = 0,
) -> torch.Tensor:
    """Plain gather engine (backend ``"ell"``): ``AB[i] = sum_r vals[i, r] *
    B[cols[i, r]]`` in slot order, pads multiplied; the virtual rows folded
    into ``AB`` (duplicates in order); then ``alpha * AB + beta * C``. In
    precise mode every step runs in f64 and the result rounds once to f32."""
    m_padded, r_slots = vals.shape
    n = b_padded.shape[1]
    dt = torch.float64 if precise else torch.float32
    ab = torch.empty((m_padded, n), dtype=dt, device=vals.device)
    for r0, r1 in _row_steps(m_padded, n, ab.element_size()):
        v, cl = vals[r0:r1].to(dt), cols[r0:r1].long()
        acc = v[:, 0, None] * b_padded[cl[:, 0]].to(dt)
        for r in range(1, r_slots):
            acc = acc + v[:, r, None] * b_padded[cl[:, r]].to(dt)
        ab[r0:r1] = acc
    n_virt = fold_rows.shape[0]
    if n_virt:
        add_rows_in_order(ab, fold_rows.long(), ab[m_base:m_base + n_virt].clone())
    out = ab * f32(alpha)
    if with_c:
        out = out + c_padded.to(dt) * f32(beta)
    return out.float()


def _epilogue(alpha, acc, comp, beta, c, *, precise):
    """The kernel's epilogue of ``acc`` (and ``comp`` in precise mode):
    ``fma(alpha, acc, beta * c)``, or ``alpha * acc`` where ``c`` is None."""
    cin = () if c is None else (beta, c)
    if precise:
        return compensated_epilogue(alpha, acc, comp, *cin)
    if c is not None:
        return fma_f32(torch.full_like(acc, f32(alpha)), acc, c * f32(beta))
    return acc * f32(alpha)


def _fold(out, past, fold_rows, c_padded, beta, *, m_base, with_c, precise=0):
    """``out[fold_rows[j]] += o_v - beta * C[v]`` for the virtual row ``v =
    m_base + j`` (the beta term only where v lies in C; ``o_v`` is
    ``out[v]`` below ``out``'s row count and ``past[v - rows]`` beyond it),
    duplicates in order: in place in f32, or in precise mode in f64 with one
    rounding to f32 at the end."""
    n_virt = fold_rows.shape[0]
    if not n_virt:
        return out
    if precise:
        out, past = out.double(), past.double()
    rows, end = out.shape[0], m_base + n_virt
    split = min(rows, end)  # the virtual rows below it lie in out, the rest in past
    add = out[m_base:split]
    if with_c:
        add = add - c_padded[m_base:split].to(out.dtype) * f32(beta)
    add = torch.cat([add, past[split - rows:end - rows]])
    add_rows_in_order(out, fold_rows.long(), add)
    return out.float()


def spmm_ell_gather_padded_ref(
    vals: torch.Tensor,
    cols: torch.Tensor,
    fold_rows: torch.Tensor,
    b_padded: torch.Tensor,
    c_padded: torch.Tensor,
    alpha: float,
    beta: float,
    *,
    m_base: int,
    with_c: bool = True,
    precise: int = 0,
) -> torch.Tensor:
    """Plain version of K5 (backend ``"ell_pallas"`` on the CPU), rounding as
    the kernel does: one fused multiply-add per slot in slot order from zero,
    value-0 slots selected out; ``fma(alpha, acc, beta * C)`` on every padded
    row that lies in C (``alpha * acc`` on the rest); then the hub fold
    that strips the virtual rows' ``beta * C`` term. In precise mode each
    slot is ``two_prod`` and a Neumaier step, the epilogue is
    ``compensated_epilogue`` and the fold runs in f64. Returns as many rows
    as ``c_padded`` has (m_base up to m_padded; with ``with_c=False`` it
    gives the shape only), a tensor of its own."""
    m_padded, r_slots = vals.shape
    n = b_padded.shape[1]
    acc = torch.zeros((m_padded, n), dtype=torch.float32, device=vals.device)
    comp = torch.zeros_like(acc) if precise else None
    for r0, r1 in _row_steps(m_padded, n):
        v, cl = vals[r0:r1, :, None], cols[r0:r1].long()
        a = acc[r0:r1]
        cm = comp[r0:r1] if precise else None
        for r in range(r_slots):
            live = v[:, r] != 0
            x = b_padded[cl[:, r]]
            if precise:
                t, e = acc_step(a, cm, *two_prod(v[:, r], x))
                a, cm = torch.where(live, t, a), torch.where(live, e, cm)
            else:
                a = torch.where(live, fma_f32(v[:, r], x, a), a)
        acc[r0:r1] = a
        if precise:
            comp[r0:r1] = cm
    rows = c_padded.shape[0]
    out = _epilogue(alpha, acc[:rows], comp[:rows] if precise else None, beta,
                    c_padded if with_c else None, precise=precise)
    past = _epilogue(alpha, acc[rows:], comp[rows:] if precise else None, beta, None,
                     precise=precise)
    return _fold(out, past, fold_rows, c_padded, beta, m_base=m_base, with_c=with_c,
                 precise=precise)


def ell_launch(n: int, vec: int, n_tiles: int = 1) -> Launch:
    """K5's thread map and grid (``csrc/spmm_ell.cu``): ``lanes`` threads a
    tile (a power of two >= ceil(n / vec), at most 32), each over ``vec``
    columns at a time (``cols``) and walking the column chunks ``lane``,
    ``lane + lanes``, ...; 256 threads a CTA; ``grid`` = (CTAs, 1) for
    ``n_tiles`` tiles."""
    if n < 1:
        raise ValueError(f"spmm_ell takes n >= 1, got {n}")
    lanes = 1
    while lanes * vec < n and lanes < 32:
        lanes *= 2
    return Launch(lanes, vec, ELL_THREADS, (-(-n_tiles * lanes // ELL_THREADS), 1))


def _check_tiles(ranges, m_padded: int, device) -> Tuple[int, int]:
    """Check an :class:`EllTiles` of tensors as the launch takes it; returns
    (tiles, long rows)."""
    if not isinstance(ranges, EllTiles):
        raise ValueError("spmm_ell on cuda needs ranges=EllTiles from ell_tiles, uploaded")
    n_tiles = ranges.tile_ptr.shape[0] - 1
    if n_tiles < 1:
        raise ValueError("ranges holds no tile")
    need(ranges.tile_ptr, "tile_ptr", torch.int32, (n_tiles + 1,), device)
    need(ranges.rows, "rows", torch.int32, (m_padded,), device)
    need(ranges.members, "members", torch.int32, (n_tiles,), device)
    if not 1 <= ranges.group_max <= ELL_GROUP_MAX:
        raise ValueError(f"group_max must be in [1, {ELL_GROUP_MAX}], got {ranges.group_max}")
    n_long = ranges.long_rows.shape[0]
    check_csr(ranges.long_ptr, (ranges.long_virt,), ("long_ptr", "long_virt"), n_long, device)
    need(ranges.long_rows, "long_rows", torch.int32, (n_long,), device)
    return n_tiles, n_long


def spmm_ell_gather_padded(
    vals: torch.Tensor,
    cols: torch.Tensor,
    fold_rows: torch.Tensor,
    b_padded: torch.Tensor,
    c_padded: torch.Tensor,
    alpha: float,
    beta: float,
    *,
    m_base: int,
    ranges: Optional[EllTiles] = None,
    with_c: bool = True,
    precise: int = 0,
) -> torch.Tensor:
    """``alpha * A @ B + beta * C``, any n. C and the result have the rows
    that ``c_padded`` has: from ``m_base``, the real rows (``SpmmPlan``'s
    call hands the caller's C as it lies), up to ``m_padded``, where the
    virtual rows' own results are returned too (``SpmmPlan.repeat``); the
    virtual rows are folded into their real rows either way, and a row past
    C's is taken with no C term. ``ranges`` is the pack's
    :func:`~sextans_tpu_torch.ops.launch.ell_tiles` on the same device
    (``SpmmPlan.ranges``); the CPU path does not read it. ``with_c=False``
    drops the C read and ``c_padded`` then gives the shape only. ``precise``
    1 or 2 runs the compensated kernel (one variant for both) and the f64
    fold. On the card one launch gathers and folds; a second folds the
    logical rows that outgrow a tile, where there are any, with a scratch
    for their virtual rows past C's."""
    with annotate("sx.kernel.spmm_ell_gather_padded"):
        kw = dict(m_base=m_base, with_c=with_c, precise=int(precise))
        if int(precise) not in (0, 1, 2):
            raise ValueError(f"precise must be 0, 1 or 2, got {precise}")
        if vals.device.type == "cpu":
            return spmm_ell_gather_padded_ref(
                vals, cols, fold_rows, b_padded, c_padded, alpha, beta, **kw)
        if vals.device.type != "cuda":
            raise ValueError(f"spmm_ell runs on cpu or cuda, not {vals.device}")
        device = vals.device
        m_padded, r_slots = vals.shape
        need(vals, "vals", torch.float32, (m_padded, r_slots), device)
        need(cols, "cols", torch.int32, (m_padded, r_slots), device)
        need(fold_rows, "fold_rows", torch.int32, (fold_rows.shape[0],), device)
        if b_padded.dim() != 2 or b_padded.shape[1] == 0:
            raise ValueError("b_padded must be 2-D with at least one column")
        k, n = b_padded.shape
        need(b_padded, "b_padded", torch.float32, (k, n), device)
        rows = c_padded.shape[0] if c_padded.dim() == 2 else -1
        if not m_base <= rows <= m_padded:
            raise ValueError(f"c_padded must have from {m_base} to {m_padded} rows, "
                             f"got shape {tuple(c_padded.shape)}")
        if with_c:
            need(c_padded, "c_padded", torch.float32, (rows, n), device)
        elif tuple(c_padded.shape) != (rows, n):
            raise ValueError(f"c_padded must have shape {(rows, n)}")
        if m_base + fold_rows.shape[0] > m_padded:
            raise ValueError("the virtual hub rows run past m_padded")
        n_tiles, n_long = _check_tiles(ranges, m_padded, device)
        if k == 0:  # no slot is live; the kernel indexes row 0 and drops what it reads
            b_padded = torch.zeros((1, n), dtype=torch.float32, device=device)
        out = torch.empty((rows, n), dtype=torch.float32, device=device)
        # the rows past C's, where the long rows' virtual rows are kept for their fold
        scratch = (torch.empty((m_padded - rows, n), dtype=torch.float32, device=device)
                   if n_long and rows < m_padded else None)
        dense = (b_padded, out) + ((c_padded,) if with_c else ()) + (
            (scratch,) if scratch is not None else ())
        vec = 4 if (n >= ELL_VEC4_MIN_N and n % 4 == 0
                    and all(t.data_ptr() % 16 == 0 for t in dense)) else 1
        go = ell_launch(n, vec, n_tiles)
        lib = build_kernels()
        with torch.cuda.device(device):
            err = lib.spmm_ell_launch(
                vals.data_ptr(), cols.data_ptr(),
                *(t.data_ptr() for t in ranges[:-1]), b_padded.data_ptr(),
                c_padded.data_ptr() if with_c else None, out.data_ptr(),
                None if scratch is None else scratch.data_ptr(), n_tiles, r_slots, n,
                n_long, rows, float(alpha), float(beta), int(with_c), int(bool(precise)),
                vec, go.lanes, ranges.group_max, stream_of(device),
            )
        check_launch(lib, "spmm_ell", err)
        count("launch.spmm_ell_gather_padded", 1 + (n_long > 0))
        return out
