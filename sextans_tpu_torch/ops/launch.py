"""What the kernel wrappers share: the host scans of a pack's steering,
bounds checks of the packs before upload, operand checks before a launch,
and the f32 rule of the plain versions."""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from sextans_tpu_torch.format.pack_edge import COL_SHIFT, PAD_BIT, ROW_END, ROW_SHIFT
from sextans_tpu_torch.format.pack_mxu import MSLAB
from sextans_tpu_torch.utils.profiling import count, timed

__all__ = [
    "SMEM_LIMIT",
    "SharedMemoryError",
    "COL_MASK",
    "structure_mask",
    "slab_visits",
    "stripe_visits",
    "dia_runs",
    "row_runs",
    "EllTiles",
    "ell_tiles",
    "ell_fold_count",
    "ELL_GROUP_MAX",
    "ELL_LONG_ROWS",
    "SddmmTiles",
    "sddmm_tiles",
    "SDDMM_RING_ROWS",
    "SDDMM_TILE_ENTRIES",
    "check_pack_indices",
    "check_edge_pack",
    "check_ell_pack",
    "check_split",
    "need",
    "check_dense",
    "check_operands",
    "check_csr",
    "Launch",
    "no_tf32",
    "add_rows_in_order",
    "rank_groups",
    "fma_f32",
    "f32",
    "stream_of",
]

# Dynamic shared memory one CUDA block may use on an H100 (sm_90), in bytes.
SMEM_LIMIT = 232448


class SharedMemoryError(ValueError):
    """A kernel's shared-memory request does not fit in one CUDA block: the
    counterpart of the JAX package's ``check_kernel_vmem`` refusal."""

# The column field of an edge's meta word, after the shift by COL_SHIFT.
COL_MASK = (1 << (ROW_SHIFT - COL_SHIFT)) - 1


@timed("upload_s")
def structure_mask(packed, slots: np.ndarray) -> np.ndarray:
    """The slots of ``packed.vals`` that its COO entries fill (``slots``:
    :func:`~sextans_tpu_torch.format.slots.slot_map` of the matrix it was
    packed from), as a bool array of the values' shape: the ``live`` mask of
    the scans for a plan whose values are given at call time."""
    live = np.zeros(packed.vals.size, dtype=bool)
    live[slots] = True
    return live.reshape(packed.vals.shape)


def slab_visits(packed, live: Optional[np.ndarray] = None
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Each 128-row slab's blocks, in pack order, for the slab kernels.

    Returns the CSR triple ``(slab_ptr, slab_blocks, slab_rows)``: the
    blocks of global slab ``s = group_mtile * tile_m / 128 + qm`` are the
    flat block indices ``g * G + i`` in ``slab_blocks[slab_ptr[s]:
    slab_ptr[s+1]]``, ascending, which is the order in which the pack adds
    them (the groups of an M-tile in group order, then the blocks of a
    group); ``slab_rows`` holds beside each the row of B where the block's
    terms start, ``group_kwin[g] * window_k + bcol[g, i]``.

    Of the blocks whose values are all zero (the pack's pad blocks, and the
    pad groups a bucket appends to the last M-tile's slab 0, ops/serve.py),
    one per distinct (slab, K-window, bcol) is kept, the first; the rest are
    dropped from the slabs' lists, as :func:`stripe_visits` drops them, and
    parked after ``slab_ptr[-1]``, where no kernel reads them: so
    ``slab_blocks`` still holds every block once, and the wrappers check
    its length against the pack's. That leaves every sum as it was to the
    bit: a zero block's terms are ``0 * B`` (+-0 where its B
    rows are finite, NaN where one is not), so its block sum is +-0 or NaN,
    and adding +-0 to an accumulator that starts at +0 and is never -0
    leaves it unchanged, in the FFMA chains (K2, K1 in precise mode, a
    Neumaier step as well) and in K1's 3xTF32 steps alike; NaN sticks, and
    the kept block reads the same B rows as the dropped ones. A kernel
    visits no block twice, so a slab's chain is as long as its distinct
    blocks, however many pad groups the bucket adds.

    ``live`` (the shape of ``packed.vals``, default ``packed.vals != 0``)
    marks the slots that count as nonzero. A plan over values given at call
    time passes its structure (:func:`structure_mask`): every block that
    holds an entry is then walked, whatever its value now.
    """
    cfg = packed.config
    ng, G, bk = packed.n_groups, cfg.group_blocks, cfg.block_k
    per_tile = cfg.tile_m // MSLAB
    _check_int32(ng * G, "slab_visits")
    tiles = _check_owner_tiles(packed.group_mtile[:ng], packed.n_mtiles, "group_mtile")
    qm = np.asarray(packed.qm, dtype=np.int64)
    if qm.size and (qm.min() < 0 or qm.max() >= per_tile):
        raise ValueError(f"qm holds a slab outside [0, {per_tile})")
    slab = (tiles[:, None] * per_tile + qm).reshape(-1)
    _check_int32(packed.k_padded, "slab_visits")
    rows = (np.asarray(packed.group_kwin, dtype=np.int64)[:, None] * cfg.window_k
            + packed.bcol).reshape(-1)
    live = packed.vals != 0 if live is None else live
    keep = live.reshape(ng * G, bk * MSLAB).any(axis=1)
    zero = np.flatnonzero(~keep)
    if zero.size:
        key = slab[zero] * packed.k_padded + rows[zero]
        _, first = np.unique(key, return_index=True)
        keep[zero[first]] = True
    kept = np.flatnonzero(keep)
    order = np.concatenate([kept[np.argsort(slab[kept], kind="stable")],
                            np.flatnonzero(~keep)])
    return (_csr_ptr(slab[kept], packed.n_mtiles * per_tile), order.astype(np.int32),
            rows[order].astype(np.int32))


def dia_runs(offsets, span_max: int) -> np.ndarray:
    """The DIA kernel's runs of diagonals, from a host scan of the offsets.

    Cuts the strictly ascending ``offsets``, in order, into runs of
    consecutive diagonals whose span (last offset minus first) is at most
    ``span_max``, each run as long as that allows (the greedy cut, which
    gives the fewest runs). Returns ``run_ptr`` (int32, runs + 1): run ``r``
    holds diagonals ``run_ptr[r]:run_ptr[r+1]``. Walking the runs in order
    walks every diagonal once, in ascending offset order.
    """
    offs = np.asarray(offsets, dtype=np.int64)
    if offs.ndim != 1 or np.any(np.diff(offs) <= 0):
        raise ValueError("offsets must be 1-D and ascend strictly")
    if span_max < 0:
        raise ValueError(f"span_max must be >= 0, got {span_max}")
    starts = [0] if offs.size else []
    while starts and starts[-1] < offs.size:
        starts.append(int(np.searchsorted(offs, offs[starts[-1]] + span_max, side="right")))
    return np.array(starts or [0], dtype=np.int32)


def _csr_ptr(owner: np.ndarray, n_owners: int) -> np.ndarray:
    """The int32 offsets of a CSR list whose items belong to ``owner``."""
    ptr = np.zeros(n_owners + 1, dtype=np.int32)
    np.cumsum(np.bincount(owner, minlength=n_owners), out=ptr[1:])
    return ptr


def _check_owner_tiles(tiles: np.ndarray, n_mtiles: int, what: str) -> np.ndarray:
    tiles = np.asarray(tiles, dtype=np.int64)
    if tiles.size and (tiles.min() < 0 or tiles.max() >= n_mtiles):
        raise ValueError(f"{what} holds an M-tile outside [0, {n_mtiles})")
    return tiles


def _check_int32(count: int, what: str) -> None:
    if count > np.iinfo(np.int32).max:
        raise ValueError(f"{what}: {count} flat indices do not fit in int32")


def stripe_visits(packed, live: Optional[np.ndarray] = None) -> Tuple[np.ndarray, np.ndarray]:
    """Each 8-row stripe's block visits, in pack order, for the block kernel.

    Returns the CSR pair ``(stripe_ptr, visits)``: the visits of global
    stripe ``s = group_mtile * tile_m / 8 + qrow`` are the flat block
    indices ``g * G + i`` in ``visits[stripe_ptr[s]:stripe_ptr[s+1]]``,
    ascending, which is the order in which the pack adds them (the groups of
    an M-tile in group order, then the blocks of a group).

    Of the visits whose 8 x block_k values are all zero (the pack's pad
    blocks: qrow 0, bcol 0), one per distinct (stripe, K-window, bcol) is
    kept, the first; the rest are dropped. That leaves every sum as it was
    to the bit. A zero block adds ``contrib = +-0`` where its B rows are
    finite, and NaN where one is not. An accumulator starts at +0 and is
    never -0 in round-to-nearest (``a + b`` is -0 only if both are), so
    adding +-0 leaves it unchanged; NaN sticks, and the kept visit reads
    the same B rows as the dropped ones. The same holds for ``acc_step`` at
    both precise levels: its error term is then +0, and ``comp`` (also
    never -0) is unchanged by subtracting +-0. ``live`` is as in
    :func:`slab_visits`.
    """
    cfg = packed.config
    ng, G, bk = packed.n_groups, cfg.group_blocks, cfg.block_k
    stripes_per_tile = cfg.tile_m // 8
    n_stripes = packed.n_mtiles * stripes_per_tile
    _check_int32(ng * G, "stripe_visits")
    tiles = _check_owner_tiles(packed.group_mtile[:ng], packed.n_mtiles, "group_mtile")
    stripe = (tiles[:, None] * stripes_per_tile + packed.qrow).reshape(-1)
    live = packed.vals != 0 if live is None else live
    keep = live.reshape(ng, 8, G, bk).any(axis=(1, 3)).reshape(-1)
    zero = np.flatnonzero(~keep)
    if zero.size:
        kwin = packed.group_kwin.astype(np.int64)[zero // G]
        key = (stripe[zero] * packed.n_kwins + kwin) * cfg.window_k + packed.bcol.reshape(-1)[zero]
        _, first = np.unique(key, return_index=True)
        keep[zero[first]] = True
    kept = np.flatnonzero(keep)
    order = np.argsort(stripe[kept], kind="stable")
    return _csr_ptr(stripe[kept], n_stripes), kept[order].astype(np.int32)


def row_runs(packed) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Each padded output row's runs, in pack order, for the edge kernel.

    A run is the stretch of slots ``[start, stop]`` (flat indices into the
    (chunks, 1, E) arrays) that one register sums before it flushes into a
    row: it ends at a ``row_end`` slot, including the flush the packer
    forces on a chunk's last slot, and starts after the previous run's end
    or at its chunk's first slot, so it never crosses a chunk. Its row is
    its M-tile's first row plus the row field of its ``row_end`` slot. Pads
    inside a run stay in it. Slots after a chunk's last ``row_end`` (the
    all-padding chunks of empty M-tiles) flush nowhere and are not listed.

    A run of pads alone (the tail of a job's last chunk, up to a chunk long,
    which the packer's forced flush adds into the tile's row 0) is cut to
    its last slot. That leaves every sum as it was to the bit: every pad
    reads column 0 of its chunk's K-window and adds ``0 * B`` of that row
    (unmasked) or nothing (masked), so the run's register stays +0 for a
    finite row and turns NaN for another, however many pads it holds; the
    same at both precise levels, where the product's error is +-0 too.

    Returns the CSR triple ``(row_ptr, run_start, run_stop)``: row ``r``'s
    runs are ``row_ptr[r]:row_ptr[r+1]``, in ascending slot order, which is
    the order in which the pack flushes them.
    """
    cfg = packed.config
    nc, E = packed.n_chunks, cfg.edge_chunk
    m_padded = packed.n_mtiles * cfg.tile_m
    _check_int32(nc * E, "row_runs")
    tiles = _check_owner_tiles(packed.chunk_mtile[:nc], packed.n_mtiles, "chunk_mtile")
    w = np.ascontiguousarray(packed.meta).reshape(-1).view(np.uint32)
    stop = np.flatnonzero(w & ROW_END)
    chunk = stop // E
    after_prev = np.empty_like(stop)
    after_prev[:1] = 0
    after_prev[1:] = stop[:-1] + 1
    start = np.maximum(after_prev, chunk * E)
    reals = np.concatenate([[0], np.cumsum((w & PAD_BIT) == 0)])
    start = np.where(reals[stop + 1] > reals[start], start, stop)
    row = tiles[chunk] * cfg.tile_m + (w[stop] >> ROW_SHIFT).astype(np.int64)
    order = np.argsort(row, kind="stable")
    return (_csr_ptr(row, m_padded), start[order].astype(np.int32),
            stop[order].astype(np.int32))


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
    _check_int32(m_padded * r_slots, "ell_tiles")
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
    is as in :func:`slab_visits`: a virtual row that holds an entry is
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


# The SDDMM kernel's tiles (csrc/sddmm.cu). A unit is up to SDDMM_GROUP_MAX
# consecutive rows with the same columns (a finite-element node's dofs) of
# at most SDDMM_UNIT_ENTRIES entries and SDDMM_UNIT_SLOTS slots (columns
# plus rows), or a piece of SDDMM_LONG entries of a row too long for one; a
# tile is a run of units with at most SDDMM_RING_ROWS slots (its distinct G
# rows and B rows, the rows of the kernel's shared-memory ring) and
# SDDMM_TILE_ENTRIES entries (the kernel's registers)
SDDMM_GROUP_MAX = 4
SDDMM_UNIT_ENTRIES = 224
SDDMM_UNIT_SLOTS = 96
SDDMM_LONG = min(SDDMM_UNIT_ENTRIES, SDDMM_UNIT_SLOTS - 1)
SDDMM_RING_ROWS = 128
SDDMM_TILE_ENTRIES = 256


class SddmmTiles(NamedTuple):
    """The SDDMM kernel's host plan of A's entries (:func:`sddmm_tiles`):
    int32 arrays, A's shape and the most slots a tile holds."""

    perm: Optional[np.ndarray]  # (nnz,) the COO entry of each CSR-ordered one; None: identity
    tile_ptr: np.ndarray  # (tiles + 1,) into the CSR-ordered entries
    slot_ptr: np.ndarray  # (tiles + 1,) into slots
    tile_rows: np.ndarray  # (tiles,) how many of a tile's slots are G rows (they come first)
    slots: np.ndarray  # each tile's distinct rows of A (G rows), then its distinct columns (B rows)
    codes: np.ndarray  # (nnz,) an entry's G slot | its B slot << 16, within its tile
    shape: Tuple[int, int]  # A's (m, k): the rows of G and of B
    ring_rows: int  # the most slots a tile holds


def sddmm_tiles(rows: np.ndarray, cols: np.ndarray, shape: Tuple[int, int]) -> SddmmTiles:
    """The SDDMM kernel's tiles of A's entries (COO ``rows``, ``cols`` of an
    (m, k) matrix), from a host scan.

    The entries are taken in CSR order, a stable (row, col) sort; ``perm``
    is None when the COO is already in that order. Consecutive rows with
    the same columns form units of up to ``SDDMM_GROUP_MAX`` rows, as many
    as fit ``SDDMM_UNIT_ENTRIES`` entries and ``SDDMM_UNIT_SLOTS`` slots:
    their entries read each B row once for all of them. A row longer than
    ``SDDMM_LONG`` is cut into units of that many entries, contiguous
    slices, so it is spread over tiles. A tile is a run of consecutive
    units, cut where the running sum of the units' slots (columns plus
    rows, a bound on what the tile stages) or of their entries enters a new
    bin: the bins are narrower than the limits by the most one of A's units
    adds, so a tile never holds more than ``SDDMM_RING_ROWS`` slots or
    ``SDDMM_TILE_ENTRIES`` entries, and the shorter A's rows, the more
    units a tile takes. Each tile lists its distinct rows (G
    rows), then its distinct columns (B rows); ``codes`` gives each entry's
    two slots.

    Vectorised: no Python loop over tiles, units or rows."""
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    m, k = (int(x) for x in shape)
    nnz = rows.size
    if cols.shape != rows.shape or rows.ndim != 1:
        raise ValueError("rows and cols must be 1-D arrays of one length")
    _check_int32(nnz, "sddmm_tiles")
    if nnz and (rows.min() < 0 or rows.max() >= m or cols.min() < 0 or cols.max() >= k):
        raise ValueError(f"an entry lies outside the ({m}, {k}) matrix")
    i32 = lambda a: np.ascontiguousarray(a, dtype=np.int32)  # noqa: E731
    if nnz == 0:
        zero, empty = np.zeros(1, np.int32), np.zeros(0, np.int32)
        return SddmmTiles(None, zero, zero, empty, empty, empty, (m, k), 0)
    d_row = np.diff(rows)
    perm = None
    if not np.all((d_row > 0) | ((d_row == 0) & (np.diff(cols) >= 0))):
        perm = np.lexsort((cols, rows))
        rows, cols = rows[perm], cols[perm]
        d_row = np.diff(rows)
    row_start = np.concatenate([[0], np.flatnonzero(d_row) + 1])
    rlen = np.diff(np.append(row_start, nnz))
    n_rows = row_start.size

    # which rows hold the same columns as the one before them
    same = np.zeros(n_rows, bool)
    cand = np.flatnonzero((rlen[1:] == rlen[:-1]) & (rlen[1:] <= SDDMM_LONG)) + 1
    if cand.size:
        size = rlen[cand]
        first = np.concatenate([[0], np.cumsum(size)[:-1]])
        at = np.repeat(row_start[cand] - first, size) + np.arange(size.sum())
        eq = cols[at] == cols[at - np.repeat(size, size)]
        same[cand[np.logical_and.reduceat(eq, first)]] = True
    # segments: a row, or a slice of SDDMM_LONG entries of a longer one
    pieces = -(-rlen // SDDMM_LONG)
    seg_row = np.repeat(np.arange(n_rows), pieces)
    seg_in = np.arange(seg_row.size) - np.repeat(np.cumsum(pieces) - pieces, pieces)
    seg_start = row_start[seg_row] + seg_in * SDDMM_LONG
    seg_len = np.minimum(rlen[seg_row] - seg_in * SDDMM_LONG, SDDMM_LONG)
    n_segs = seg_row.size
    # units: as many rows of a run of equal ones as fit; each slice of a long row
    run_start = np.maximum.accumulate(np.where(same, 0, np.arange(n_rows)))
    per_unit = np.clip(np.minimum(SDDMM_UNIT_ENTRIES // rlen, SDDMM_UNIT_SLOTS - rlen),
                       1, SDDMM_GROUP_MAX)
    lead = ((np.arange(n_rows) - run_start) % per_unit == 0)[seg_row] | (seg_in > 0)
    unit_first = np.flatnonzero(lead)  # each unit's first segment
    unit_of = np.cumsum(lead) - 1  # of each segment
    useg = np.diff(np.append(unit_first, n_segs))  # its rows, or 1
    uent = seg_len[unit_first] * useg
    uslots = seg_len[unit_first] + useg
    bin_slots = SDDMM_RING_ROWS - int(uslots.max()) + 1
    bin_ents = SDDMM_TILE_ENTRIES - int(uent.max()) + 1
    key_s = (np.cumsum(uslots) - uslots) // bin_slots
    key_e = (np.cumsum(uent) - uent) // bin_ents
    tlead = np.ones(unit_first.size, bool)
    tlead[1:] = (key_s[1:] != key_s[:-1]) | (key_e[1:] != key_e[:-1])
    n_tiles = int(tlead.sum())
    tile_first = unit_first[tlead]  # each tile's first segment
    tile_ptr = np.append(seg_start[tile_first], nnz)
    tile_of = (np.cumsum(tlead) - 1)[unit_of]  # of each segment

    # G slots: the tile's distinct rows, in order
    new_trow = seg_in == 0
    new_trow[tile_first] = True
    crow = np.cumsum(new_trow)
    lrow = crow - crow[tile_first][tile_of]
    t_rows = np.bincount(tile_of[new_trow], minlength=n_tiles)
    # B slots: the tile's distinct columns, from each unit's first segment
    # (the unit's other rows repeat its columns in order)
    first_len = seg_len[unit_first]
    at = np.repeat(seg_start[unit_first] - (np.cumsum(first_len) - first_len), first_len)
    at += np.arange(at.size)
    keys = np.repeat(tile_of[unit_first], first_len) * k + cols[at]
    order = None if np.all(keys[1:] >= keys[:-1]) else np.argsort(keys, kind="stable")
    sk = keys if order is None else keys[order]
    new_key = np.ones(sk.size, bool)
    new_key[1:] = sk[1:] != sk[:-1]
    uniq = sk[new_key]
    rank = np.cumsum(new_key) - 1  # of each sorted key
    utile = uniq // k
    t_cols = np.bincount(utile, minlength=n_tiles)
    col_first = np.concatenate([[0], np.cumsum(t_cols)[:-1]])
    lcol_first = np.empty(at.size, np.int64)
    lcol_first[slice(None) if order is None else order] = rank
    lcol_first -= np.repeat(col_first[tile_of[unit_first]], first_len)
    # each segment's entries take their unit's first segment's
    ufirst_at = (np.cumsum(first_len) - first_len)[unit_of]
    lcol = lcol_first[np.repeat(ufirst_at - seg_start, seg_len) + np.arange(nnz)]

    tslots = t_rows + t_cols
    slot_ptr = np.concatenate([[0], np.cumsum(tslots)])
    slots = np.empty(int(slot_ptr[-1]), np.int64)
    slots[slot_ptr[tile_of[new_trow]] + lrow[new_trow]] = rows[row_start[seg_row[new_trow]]]
    slots[slot_ptr[utile] + t_rows[utile] + np.arange(uniq.size) - col_first[utile]] = uniq % k
    codes = np.repeat(lrow | t_rows[tile_of] << 16, seg_len) + (lcol << 16)
    ring_rows = int(tslots.max())
    if ring_rows > SDDMM_RING_ROWS or np.diff(tile_ptr).max() > SDDMM_TILE_ENTRIES:
        raise RuntimeError("sddmm_tiles made a tile past the kernel's limits")
    count("sddmm.entries", nnz)
    count("sddmm.b_rows", int(t_cols.sum()))
    return SddmmTiles(None if perm is None else i32(perm), i32(tile_ptr), i32(slot_ptr),
                      i32(t_rows), i32(slots), i32(codes), (m, k), ring_rows)


def check_pack_indices(packed, idx: np.ndarray, idx_limit: int) -> None:
    """Bounds of a pack's steering, checked once on the host before upload:
    a kernel trusts them for its address arithmetic."""
    cfg = packed.config
    ng = packed.n_groups
    if packed.group_mtile.shape != (ng + 1,) or packed.group_kwin.shape != (ng,):
        raise ValueError("group_mtile must be (ng+1,) and group_kwin (ng,)")
    if idx.shape != (ng, cfg.group_blocks) or packed.bcol.shape != idx.shape:
        raise ValueError(f"index arrays must be ({ng}, {cfg.group_blocks})")
    if ng == 0:
        return
    if packed.group_kwin.min() < 0 or packed.group_kwin.max() >= packed.n_kwins:
        raise ValueError("group_kwin holds a K-window outside the padded K")
    if idx.min() < 0 or idx.max() >= idx_limit:
        raise ValueError(f"a block's row index is outside [0, {idx_limit})")
    if packed.bcol.min() < 0 or packed.bcol.max() + cfg.block_k > cfg.window_k:
        raise ValueError("a block's bcol runs past the end of its K-window")


def check_edge_pack(packed) -> None:
    """Bounds of an edge pack's meta words and chunk steering, checked once
    on the host before upload: the edge kernel trusts them for its
    addresses. ``chunk_mtile`` is checked by :func:`row_runs`."""
    cfg = packed.config
    nc, E = packed.n_chunks, cfg.edge_chunk
    if packed.vals.shape != (nc, 1, E) or packed.meta.shape != (nc, 1, E):
        raise ValueError(f"vals and meta must be ({nc}, 1, {E})")
    if packed.chunk_mtile.shape != (nc + 1,) or packed.chunk_mtile[-1] != -1:
        raise ValueError("chunk_mtile must be (chunks+1,) and end in the sentinel -1")
    if nc == 0:
        raise ValueError("an edge pack has at least one chunk per M-tile")
    if packed.chunk_kwin.min() < 0 or packed.chunk_kwin.max() >= packed.n_kwins:
        raise ValueError("chunk_kwin holds a K-window outside the padded K")
    w = packed.meta.view(np.uint32)
    if (w >> ROW_SHIFT).max() >= cfg.tile_m:
        raise ValueError(f"an edge's row is outside [0, tile_m={cfg.tile_m})")
    if ((w >> COL_SHIFT) & COL_MASK).max() >= cfg.window_k:
        raise ValueError(f"an edge's column is outside [0, window_k={cfg.window_k})")


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


def check_split(split) -> None:
    """Shapes and indices of a hybrid split, checked once on the host before
    upload: the plan gathers B rows at ``head_cols`` and adds into C rows at
    ``head_rows``, and a diagonal must cross A."""
    m, k = split.m, split.k
    offs, rows = np.asarray(split.diag_offsets), np.asarray(split.head_rows)
    cols = np.asarray(split.head_cols)
    shapes = {"diag_vals": (offs.size, m), "head_dense": (m, cols.size),
              "head_rows_dense": (rows.size, k)}
    for name, shape in shapes.items():
        if np.shape(getattr(split, name)) != shape:
            raise ValueError(f"{name} must be {shape}, got {np.shape(getattr(split, name))}")
    if offs.ndim != 1 or cols.ndim != 1 or rows.ndim != 1:
        raise ValueError("diag_offsets, head_cols and head_rows must be 1-D")
    if tuple(split.residue.shape) != (m, k):
        raise ValueError(f"the residue must be ({m}, {k}), got {tuple(split.residue.shape)}")
    if offs.size and (np.any(np.diff(offs) <= 0) or offs[0] <= -m or offs[-1] >= k):
        raise ValueError(f"diag_offsets must ascend strictly within ({-m}, {k})")
    if cols.size and (cols.min() < 0 or cols.max() >= k):
        raise ValueError(f"head_cols holds a column outside [0, k={k})")
    if rows.size and (np.any(np.diff(rows) <= 0) or rows[0] < 0 or rows[-1] >= m):
        raise ValueError(f"head_rows must ascend strictly within [0, m={m})")


def need(t: torch.Tensor, name: str, dtype, shape: Sequence[int], device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_dense(
    b_padded, c_padded, *, tile_m: int, window_k: int, with_c: bool, device,
) -> Tuple[int, int]:
    """Check the padded B and C of a launch; returns ``(m_padded, n)``.

    With ``with_c=False``, ``c_padded`` is used for its shape only and may be
    a broadcast view (e.g. ``torch.zeros(1).expand(m_padded, n)``).
    """
    if b_padded.dim() != 2 or c_padded.dim() != 2:
        raise ValueError("b_padded and c_padded must be 2-D")
    k_padded, n = b_padded.shape
    m_padded = c_padded.shape[0]
    if k_padded % window_k or m_padded % tile_m or m_padded == 0:
        raise ValueError(
            f"B rows {k_padded} must be a multiple of window_k {window_k}, "
            f"C rows {m_padded} a positive multiple of tile_m {tile_m}"
        )
    need(b_padded, "b_padded", torch.float32, (k_padded, n), device)
    if with_c:
        need(c_padded, "c_padded", torch.float32, (m_padded, n), device)
    elif tuple(c_padded.shape) != (m_padded, n):
        raise ValueError(f"c_padded must have shape {(m_padded, n)}")
    # grid.y counts column chunks of at least 8 columns and is at most 65535
    if n == 0 or n > 65535 * 8:
        raise ValueError(f"N must be in [1, {65535 * 8}], got {n}")
    return m_padded, n


def check_operands(
    vals, idx, bcol, group_mtile, group_kwin, b_padded, c_padded,
    *, vals_shape_per_group: Tuple[int, int], tile_m: int, window_k: int,
    group_blocks: int, with_c: bool,
) -> Tuple[int, int]:
    """Check the pack and dense operands of a block or slab launch; returns
    ``(m_padded, n)``. ``c_padded`` is as in :func:`check_dense`. Each
    wrapper checks its own ``ranges``.
    """
    device = vals.device
    ng = vals.shape[0]
    G = group_blocks
    need(vals, "vals", torch.float32, (ng, *vals_shape_per_group), device)
    need(idx, "qrow/qm", torch.int32, (ng, G), device)
    need(bcol, "bcol", torch.int32, (ng, G), device)
    need(group_mtile, "group_mtile", torch.int32, (ng + 1,), device)
    need(group_kwin, "group_kwin", torch.int32, (ng,), device)
    m_padded, n = check_dense(b_padded, c_padded, tile_m=tile_m,
                              window_k=window_k, with_c=with_c, device=device)
    if vals.data_ptr() % 16:
        raise ValueError("vals must be 16-byte aligned")
    return m_padded, n


class Launch(NamedTuple):
    """A thread map of the row-parallel kernels (K3, K4, K5): a lane group
    of ``lanes`` threads works on one owner (a stripe, a row or a tile),
    each thread over ``cols`` consecutive columns; ``threads`` per CTA;
    ``grid`` = (CTAs along the owners, CTAs along N); ``smem`` bytes of
    shared memory a CTA."""

    lanes: int
    cols: int
    threads: int
    grid: Tuple[int, int]
    smem: int = 0


def check_csr(ptr: torch.Tensor, items: Sequence[torch.Tensor], names: Sequence[str],
              n_owners: int, device) -> int:
    """Check a CSR list of a host scan (``slab_visits``, ``stripe_visits``,
    ``row_runs``) as a launch takes it: int32 offsets for ``n_owners``, then
    1-D int32 item arrays of one length. Returns that length."""
    need(ptr, names[0], torch.int32, (n_owners + 1,), device)
    if items[0].dim() != 1:
        raise ValueError(f"{names[1]} must be 1-D, got shape {tuple(items[0].shape)}")
    for t, name in zip(items, names[1:]):
        need(t, name, torch.int32, (items[0].shape[0],), device)
    return items[0].shape[0]


@contextlib.contextmanager
def no_tf32():
    """Both TF32 switches off inside the block, as the caller left them
    after it. The plain versions contract with ``einsum``/``matmul``; on the
    card that is a cuBLAS matmul, which would round its inputs to TF32
    (10-bit mantissa) if allowed. The JAX package contracts at
    ``Precision.HIGHEST`` and leaves global state alone, so every plain
    contraction runs inside this (``with no_tf32():``, or ``@no_tf32()`` on a
    function) and the caller's setting survives the call."""
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = matmul.allow_tf32, cudnn.allow_tf32
    matmul.allow_tf32 = cudnn.allow_tf32 = False
    try:
        yield
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = saved


def rank_groups(index: torch.Tensor):
    """The positions of ``index`` grouped by their rank among the equal
    entries before them (0 for the first visit of a row, 1 for the second,
    ...), each group ascending: one pass per rank then touches each row at
    most once, and the passes in rank order visit each row's entries in
    ``index`` order."""
    order = torch.argsort(index, stable=True)
    sorted_idx = index[order]
    pos = torch.arange(index.numel(), device=index.device)
    start = torch.ones_like(sorted_idx, dtype=torch.bool)
    start[1:] = sorted_idx[1:] != sorted_idx[:-1]
    run_start = torch.cummax(torch.where(start, pos, 0), 0).values
    rank = torch.empty_like(pos)
    rank[order] = pos - run_start
    by_rank = torch.argsort(rank, stable=True)
    return torch.split(by_rank, torch.bincount(rank).tolist())


def add_rows_in_order(acc: torch.Tensor, index: torch.Tensor, src: torch.Tensor) -> None:
    """``acc[index[i]] += src[i]`` for every i, duplicates added in i order.

    The kernels add blocks into their accumulator in pack order, so the plain
    versions do too, and the two differ only by the rounding of the block
    products and the epilogue. On the CPU ``index_add_`` runs sequentially.
    On CUDA neither it (atomics) nor ``index_put_(accumulate=True)`` keeps
    that order: on an H100 the latter sums a row's duplicates in another
    order than ``index_add_`` where a row is narrower than a warp
    (PERF.md). So there each rank of :func:`rank_groups` is one pass that
    adds into each row at most once.
    """
    if acc.device.type != "cuda":
        acc.index_add_(0, index, src)
        return
    if index.numel() == 0:
        return
    for sel in rank_groups(index):
        rows = index[sel]
        acc[rows] = acc[rows] + src[sel]


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` for f32 tensors, rounded once to f32, as a kernel's
    ``__fmaf_rn`` rounds it. The product of two f32 values is exact in f64;
    the f64 sum is rounded to odd (TwoSum recovers its error, and an inexact
    sum whose last bit is even steps one f64 ulp toward the exact value). A
    sum rounded to odd at 53 bits rounds to nearest at 24 bits as the exact
    sum does (Boldo and Melquiond), so no double rounding creeps in where
    the f64 sum lands halfway between two f32 values. Elementwise ops only,
    so it never waits for the device."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    v = s - p
    e = (p - (s - v)) + (cd - v)
    fix = (e != 0) & ((s.view(torch.int64) & 1) == 0)
    toward = torch.where(e > 0, torch.inf, -torch.inf).to(s.dtype)
    return torch.where(fix, torch.nextafter(s, toward), s).float()


def f32(x) -> float:
    """A scalar rounded through float32, as a kernel's ``c_float`` sees it."""
    return float(np.float32(x))


def stream_of(device: torch.device) -> Optional[int]:
    """The current CUDA stream of ``device`` as a pointer for ``ctypes``."""
    return torch.cuda.current_stream(device).cuda_stream or None
