"""SpMM over the ELL gather pack (format/pack_ell.py).

``spmm_ell_gather_padded`` is the twin of ``sextans_tpu.ops.spmm_ell_pallas``'s
``spmm_ell_gather_padded`` (kernel K5) and its hub fold: on a CUDA tensor it
launches the hand-written kernel in ``csrc/spmm_ell.cu``, which walks the
tiles of the host scan :func:`ell_tiles` (``SpmmPlan.ranges``) and folds
the virtual hub rows itself; on a CPU tensor
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

import dataclasses
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from sextans_tpu_torch.ops.df32 import acc_step, compensated_epilogue, two_prod
from sextans_tpu_torch.ops.launch import (
    Launch,
    PackHost,
    add_rows_in_order,
    check_csr,
    check_int32,
    f32,
    fma_f32,
    need,
    stream_of,
)
from sextans_tpu_torch.runtime.build import build_kernels, check_launch
from sextans_tpu_torch.utils.profiling import annotate, count

__all__ = ["spmm_ell_gather_padded", "spmm_ell_gather_padded_ref", "spmm_ell_padded_ref",
           "ell_launch", "ELL_VEC4_MIN_N", "EllTiles", "ell_tiles", "ell_fold_count",
           "check_ell_pack", "ELL_GROUP_MAX", "ELL_LONG_ROWS", "ELL_HOST", "ell_gather_runner",
           "ell_runner", "ell_in_place"]

# K5 (csrc/spmm_ell.cu): threads a CTA, and the least N that its 16-byte
# loads take (below it, four times the threads on 4-byte loads)
ELL_THREADS = 256
ELL_VEC4_MIN_N = 16

# Bytes of one (rows, n) temporary per step of the plain versions.
_REF_CHUNK_BYTES = 256 << 20


# K5's tiles (csrc/spmm_ell.cu): at most ELL_GROUP_MAX logical rows a tile;
# groups are kept only where they hold ELL_GROUP_MIN_MEAN logical rows on
# average; a logical row of more than ELL_LONG_ROWS padded rows is cut into
# tiles of one padded row and folded by a second kernel
ELL_GROUP_MAX = 3
ELL_GROUP_MIN_MEAN = 2.0
ELL_LONG_ROWS = 64


class EllTiles(NamedTuple):
    """K5's host scan of an ELL pack (:func:`ell_tiles`): int32 arrays, and
    the most logical rows a tile holds (the kernel's instance)."""

    tile_ptr: np.ndarray  # (tiles + 1,) into rows
    rows: np.ndarray  # (m_padded,) the padded rows in tile order
    members: np.ndarray  # (tiles,) logical rows in each tile
    long_ptr: np.ndarray  # (long rows + 1,) into long_virt
    long_rows: np.ndarray  # real rows whose logical row outgrows a tile
    long_virt: np.ndarray  # their virtual rows, in fold-table order
    group_max: int


def ell_tiles(packed, group_max: int = ELL_GROUP_MAX) -> EllTiles:
    """The ELL gather kernel's tiles, from a host scan of the pack.

    A *logical row* is a real row followed by its virtual rows in
    fold-table order (``fold_rows`` need not be sorted: the virtual rows
    are grouped by their real row, fold-table order kept within a group);
    each pad row after ``m_base + n_virt`` is one of its own. ``rows`` lists
    the padded rows in that order, every one once, and ``tile_ptr`` cuts it
    into tiles of whole logical rows: runs of consecutive logical rows with
    the same number of padded rows and the same ``cols``, padded row by
    padded row (the dofs of a finite-element node), at most ``group_max`` a
    tile. A tile's ``members`` logical rows then read one B row a slot, which
    the kernel loads once for all of them. Where the tiles would hold fewer
    than ``ELL_GROUP_MIN_MEAN`` logical rows on average, each logical row is
    a tile of its own and ``group_max`` is 1: the kernel's wider instance
    would only add work. A logical row of more than ``ELL_LONG_ROWS``
    padded rows is cut into tiles of one padded row each (the kernel folds nothing
    there) and listed in ``long_rows`` / ``long_virt``, to be folded after
    the tiles.

    The kernel computes what it computed before, whichever rows share a
    tile: each padded row's chain in slot order, its epilogue, then each
    real row's fold in fold-table order.

    Counts ``ell.tiles`` and ``ell.tile_rows``, the tiles and the sum of
    their ``members`` (pad rows included; a long row's pieces one each):
    their ratio is how many rows share each staged B row.
    """
    vals, cols = np.asarray(packed.vals), np.asarray(packed.cols)
    m_padded, r_slots = cols.shape
    m, n_virt = packed.m_base, packed.n_virt
    if group_max < 1:
        raise ValueError(f"group_max must be positive, got {group_max}")
    check_int32(m_padded * r_slots, "ell_tiles")
    fr = np.asarray(packed.fold_rows, dtype=np.int64)
    vcnt = np.bincount(fr, minlength=m)[:m]
    vstart = np.concatenate([[0], np.cumsum(vcnt)])
    lsize = np.concatenate([1 + vcnt, np.ones(m_padded - m - n_virt, np.int64)])
    lstart = np.concatenate([[0], np.cumsum(lsize)])
    n_logical = lsize.size
    # the padded rows in logical order
    vorder = np.argsort(fr, kind="stable")
    rows = np.empty(m_padded, np.int64)
    rows[lstart[:m]] = np.arange(m)
    rows[lstart[fr[vorder]] + 1 + np.arange(n_virt) - vstart[fr[vorder]]] = m + vorder
    rows[lstart[m:-1]] = np.arange(m + n_virt, m_padded)

    # which logical rows read the same B rows as the one before them
    long = lsize > ELL_LONG_ROWS
    same = np.zeros(n_logical, bool)
    cand = np.flatnonzero((lsize[1:] == lsize[:-1]) & ~long[1:]) + 1
    if cand.size:
        size = lsize[cand]
        first = np.concatenate([[0], np.cumsum(size)[:-1]])
        pos = np.repeat(lstart[cand] - first, size) + np.arange(size.sum())
        eq = (cols[rows[pos]] == cols[rows[pos - np.repeat(size, size)]]).all(axis=1)
        same[cand[np.logical_and.reduceat(eq, first)]] = True
    run_start = np.maximum.accumulate(np.where(same, 0, np.arange(n_logical)))
    lead = (np.arange(n_logical) - run_start) % group_max == 0
    if (~long).sum() < ELL_GROUP_MIN_MEAN * (lead & ~long).sum():
        lead[:] = True
    starts = np.flatnonzero(lead)
    members = np.diff(np.append(starts, n_logical))
    # a long logical row: a tile a padded row
    pieces = np.where(long[starts], lsize[starts], 1)
    offset = np.arange(pieces.sum()) - np.repeat(np.cumsum(pieces) - pieces, pieces)
    tile_ptr = np.append(np.repeat(lstart[starts], pieces) + offset, m_padded)
    members = np.repeat(members, pieces)

    long_real = np.flatnonzero(long[:m])
    long_ptr = np.concatenate([[0], np.cumsum(vcnt[long_real])])
    long_virt = m + np.concatenate(
        [vorder[vstart[i]:vstart[i + 1]] for i in long_real] or [np.empty(0, np.int64)])
    count("ell.tiles", members.size)
    count("ell.tile_rows", int(members.sum()))
    i32 = lambda a: np.ascontiguousarray(a, dtype=np.int32)  # noqa: E731
    return EllTiles(i32(tile_ptr), i32(rows), i32(members), i32(long_ptr), i32(long_real),
                    i32(long_virt), int(members.max(initial=1)))


def ell_fold_count(packed, live: Optional[np.ndarray] = None) -> int:
    """How many of an ELL pack's virtual rows a plan folds: all but a
    trailing run of all-zero virtual rows that repeat the last one (the same
    ``cols`` and fold target), of which the first is kept.

    A bucketized pack (ops/serve.py) pads its virtual rows with such a run,
    all folding into the last real target: folded one by one, in order,
    they would cost one pass each. Every row of the run computes the same
    ``0 * B`` terms, so it adds the same +-0 or NaN; after the first, adding
    it again changes no bit (x + v + v = x + v for v = +-0 or NaN), and in
    the kernel's fold ``out - beta * C`` is +0 for such a row whatever its
    C. The rows past the count are then pad rows, folded nowhere. ``live``
    is as in :func:`~sextans_tpu_torch.ops.spmm_slab.slab_visits`: a virtual row that holds an entry is
    folded whatever its value now.
    """
    n = packed.n_virt
    if n < 2:
        return n
    m0 = packed.m_base
    live = packed.vals != 0 if live is None else live
    cols = packed.cols[m0:m0 + n]
    same = (~live[m0:m0 + n].any(axis=1) & (cols == cols[-1]).all(axis=1)
            & (packed.fold_rows == packed.fold_rows[-1]))
    run = n - np.flatnonzero(~same)[-1] - 1 if not same.all() else n
    return n - max(run - 1, 0)


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
    :func:`ell_tiles` on the same device
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


def check_ell_pack(packed) -> None:
    """Bounds of an ELL pack, checked once on the host before upload: the
    gather kernel trusts ``cols`` and the hub fold trusts ``fold_rows``.

    ``m_base`` is ``m`` as packed; a bucketized pack (ops/serve.py) rounds it
    up, and its rows ``m .. m_base - 1`` must then hold only zero values:
    they are pad rows, whose products the plan slices off."""
    shape = packed.cols.shape
    if packed.vals.shape != shape or len(shape) != 2 or shape[1] < 1:
        raise ValueError("cols and vals must be one (m_padded, R) shape")
    if packed.m_base < packed.m:
        raise ValueError(f"m_base {packed.m_base} must be at least m {packed.m}")
    if np.any(packed.vals[packed.m:packed.m_base]):
        raise ValueError(f"rows {packed.m}..{packed.m_base - 1} past m must be all-zero "
                         "pad rows")
    if packed.m_base + packed.n_virt > shape[0]:
        raise ValueError("the virtual hub rows run past m_padded")
    if packed.cols.size and (packed.cols.min() < 0 or packed.cols.max() >= max(packed.k, 1)):
        raise ValueError(f"a slot's column is outside [0, k={packed.k})")
    fr = packed.fold_rows
    if fr.size and (fr.min() < 0 or fr.max() >= packed.m):
        raise ValueError(f"fold_rows holds a row outside [0, m={packed.m})")


def _ell_checked(packed, live):
    """:func:`check_ell_pack`; counts ``ell.*``; returns the pack with
    ``fold_rows`` cut to :func:`ell_fold_count`, or None if nothing is cut."""
    check_ell_pack(packed)
    n_fold = ell_fold_count(packed, live)
    count("ell.entries", packed.nnz)
    count("ell.slots", packed.cols.size)
    count("ell.rows", packed.m_padded)
    count("ell.fold_rows", n_fold)
    if n_fold == packed.n_virt:
        return None
    return dataclasses.replace(packed, fold_rows=packed.fold_rows[:n_fold])


# the plain versions walk no tiles
ELL_HOST = PackHost(
    check=_ell_checked,
    arrays=lambda packed: ((packed.vals, np.float32), (packed.cols, np.int32),
                           (packed.fold_rows, np.int32)),
    scan=lambda packed, live: ell_tiles(packed),
    cuda_only=True)


def ell_gather_runner(packed, n: int, ranges, image=None):
    """K5 and its hub fold (backend ``ell_pallas``) bound as ``SpmmPlan`` runs it."""
    return functools.partial(spmm_ell_gather_padded, m_base=packed.m_base, ranges=ranges,
                             precise=int(packed.config.precise))


def ell_runner(packed, n: int, ranges, image=None):
    """The plain ELL engine (backend ``ell``), bound as :func:`ell_gather_runner`."""
    return functools.partial(spmm_ell_padded_ref, m_base=packed.m_base,
                             precise=int(packed.config.precise))


def ell_in_place(packed) -> bool:
    """Whether ``SpmmPlan.__call__`` gives K5 C and its output at the caller's
    M rows: where the pack's real rows are the matrix's, not a bucket's."""
    return packed.m_base == packed.m
