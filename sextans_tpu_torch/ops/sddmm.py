"""The SDDMM of the differentiable SpMM: ``dvals[e] = G[rows[e]] . B[cols[e]]``
over A's entries (``ops/autodiff.py`` multiplies it by alpha for d/dvals).

``sddmm_rows`` launches the hand-written kernel in ``csrc/sddmm.cu`` on a
CUDA tensor, walking the tiles of the host plan :func:`sddmm_tiles` (made
once per op, :func:`sddmm_plan`); on a CPU tensor it runs the plain PyTorch version
``sddmm_rows_ref``. Any other device raises.

The kernel replaces no TPU kernel: the JAX package computes the SDDMM with
XLA ops (``sextans_tpu/ops/autodiff.py:_sddmm``), as the plain version does
here, gathering both operands' rows into (entries, N) intermediates in
device memory. What bounds the kernel, and what its ring of G and B rows
in shared memory does about it, is in its source.

``sddmm_rows_walk`` is the kernel's arithmetic on the host, walking the
plan in the kernel's order of roundings: the tests hold the plan and the
kernel to it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from sextans_tpu_torch.ops.launch import (Launch, check_csr, check_int32, fma_f32, need,
                                          put_scan, stream_of)
from sextans_tpu_torch.runtime.build import build_kernels, check_launch
from sextans_tpu_torch.utils.profiling import annotate, count, timed

__all__ = ["sddmm_rows", "sddmm_rows_ref", "sddmm_rows_walk", "sddmm_plan", "sddmm_launch",
           "SddmmTiles", "sddmm_tiles", "SDDMM_RING_ROWS", "SDDMM_TILE_ENTRIES"]

# csrc/sddmm.cu: threads a CTA, and the most lanes an entry takes
SDDMM_THREADS = 128
SDDMM_MAX_LANES = 8

SDDMM_REF_CHUNK = 65536  # bounds the plain version's (chunk, N) gathered intermediates


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
    check_int32(nnz, "sddmm_tiles")
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


def sddmm_rows_ref(g: torch.Tensor, b: torch.Tensor, rows: torch.Tensor,
                   cols: torch.Tensor) -> torch.Tensor:
    """Plain version: ``g[rows[e]] . b[cols[e]]`` in f32, in chunks of
    ``SDDMM_REF_CHUNK`` entries so that the gathered (chunk, N) rows stay
    bounded: a product and a sum over N (no ``einsum``, which may lower to a
    TF32 ``bmm``)."""
    nnz = rows.numel()
    out = torch.empty(nnz, dtype=torch.float32, device=g.device)
    for e0 in range(0, nnz, SDDMM_REF_CHUNK):
        e1 = min(nnz, e0 + SDDMM_REF_CHUNK)
        out[e0:e1] = (g[rows[e0:e1]] * b[cols[e0:e1]]).sum(dim=1)
    return out


def sddmm_launch(n: int, vec: int, n_tiles: int = 1) -> Launch:
    """The kernel's thread map (``csrc/sddmm.cu``): ``lanes`` threads an
    entry (a power of two >= ceil(n / vec), at most 8), each over ``vec``
    columns of every chunk of ``lanes * vec``; 128 threads a CTA, a CTA a
    tile. The kernel sizes its ring itself: two stages of the plan's
    ``ring_rows`` rows of a chunk, at most 32 KB."""
    if n < 1:
        raise ValueError(f"sddmm_rows takes n >= 1, got {n}")
    lanes = 1
    while lanes * vec < n and lanes < SDDMM_MAX_LANES:
        lanes *= 2
    return Launch(lanes, vec, SDDMM_THREADS, (n_tiles, 1))


@timed("upload_s")
def sddmm_plan(rows: np.ndarray, cols: np.ndarray, shape, device: torch.device
               ) -> Optional[SddmmTiles]:
    """:func:`sddmm_tiles` of A's COO
    coordinates, uploaded to ``device`` (int32 tensors); None on the CPU,
    whose plain version walks no tiles."""
    if device.type != "cuda":
        return None
    return put_scan(sddmm_tiles(rows, cols, shape), device)


def _check_tiles(tiles, shape, nnz, device) -> int:
    """Check an uploaded :class:`SddmmTiles` of ``nnz`` entries as the launch
    takes it; returns its number of tiles."""
    if not isinstance(tiles, SddmmTiles):
        raise ValueError("sddmm_rows on cuda needs tiles=sddmm_plan(...) on the device")
    if tuple(tiles.shape) != tuple(shape):
        raise ValueError(f"the tiles are of a {tiles.shape} matrix, G and B give {shape}")
    n_tiles = tiles.tile_rows.shape[0]
    if tiles.codes.shape[0] != nnz:
        raise ValueError(f"the tiles hold {tiles.codes.shape[0]} entries, the coordinates {nnz}")
    check_csr(tiles.tile_ptr, (tiles.codes,), ("tile_ptr", "codes"), n_tiles, device)
    check_csr(tiles.slot_ptr, (tiles.slots,), ("slot_ptr", "slots"), n_tiles, device)
    need(tiles.tile_rows, "tile_rows", torch.int32, (n_tiles,), device)
    if tiles.perm is not None:
        need(tiles.perm, "perm", torch.int32, (nnz,), device)
    return n_tiles


def sddmm_rows(g: torch.Tensor, b: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor, *,
               tiles: Optional[SddmmTiles] = None) -> torch.Tensor:
    """``dvals[e] = g[rows[e]] . b[cols[e]]`` (f32) for the (nnz,) COO
    coordinates of an (m, k) matrix A, with ``g`` (m, N) and ``b`` (k, N).
    ``tiles`` is :func:`sddmm_plan` of the same coordinates on the same
    device; the CPU path does not read it, and the kernel reads the
    coordinates from it alone (the launch checks that it holds as many). The lanes an entry takes follow N. One launch
    where A has an entry."""
    with annotate("sx.kernel.sddmm_rows"):
        if g.device.type == "cpu":
            return sddmm_rows_ref(g, b, rows, cols)
        if g.device.type != "cuda":
            raise ValueError(f"sddmm_rows runs on cpu or cuda, not {g.device}")
        device = g.device
        if g.dim() != 2 or b.dim() != 2 or g.shape[1] != b.shape[1] or g.shape[1] == 0:
            raise ValueError("g and b must be 2-D with one number of columns, at least one")
        (m, n), k = g.shape, b.shape[0]
        need(g, "g", torch.float32, (m, n), device)
        need(b, "b", torch.float32, (k, n), device)
        if rows.shape != cols.shape or rows.dim() != 1:
            raise ValueError("rows and cols must be 1-D and of one length")
        n_tiles = _check_tiles(tiles, (m, k), rows.numel(), device)
        out = torch.empty(tiles.codes.shape[0], dtype=torch.float32, device=device)
        if n_tiles == 0:
            return out
        vec = 4 if n % 4 == 0 and g.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0 else 1
        go = sddmm_launch(n, vec, n_tiles)
        lib = build_kernels()
        with torch.cuda.device(device):
            err = lib.sddmm_tile_launch(
                g.data_ptr(), b.data_ptr(), tiles.tile_ptr.data_ptr(),
                tiles.slot_ptr.data_ptr(), tiles.tile_rows.data_ptr(), tiles.slots.data_ptr(),
                tiles.codes.data_ptr(), None if tiles.perm is None else tiles.perm.data_ptr(),
                out.data_ptr(), n_tiles, n, tiles.ring_rows, vec, go.lanes, stream_of(device))
        check_launch(lib, "sddmm_rows", err)
        count("launch.sddmm_rows")
        return out


def sddmm_rows_walk(tiles: SddmmTiles, g: torch.Tensor, b: torch.Tensor, vec: int
                    ) -> torch.Tensor:
    """The kernel's result on the host: walks the host plan ``tiles``
    (NumPy, :func:`sddmm_tiles`) and takes the
    kernel's roundings in its order (``csrc/sddmm.cu``): per lane and
    chunk a product and an FFMA chain over its columns, added to the lane's
    sum chunk by chunk, then the lanes' butterfly.
    For f32 ``g`` and ``b`` on the CPU."""
    n = g.shape[1]
    lanes = sddmm_launch(n, vec).lanes
    width = lanes * vec
    chunks = -(-n // width)
    nnz = tiles.codes.size
    tile_of = np.repeat(np.arange(tiles.tile_rows.size), np.diff(tiles.tile_ptr))
    base = tiles.slot_ptr[:-1][tile_of]
    g_rows = torch.as_tensor(tiles.slots[base + (tiles.codes & 0xffff)], dtype=torch.int64)
    b_rows = torch.as_tensor(tiles.slots[base + (tiles.codes >> 16)], dtype=torch.int64)

    def staged(x, idx):
        padded = torch.zeros((nnz, chunks * width), dtype=torch.float32)
        padded[:, :n] = x[idx]
        return padded.view(nnz, chunks, lanes, vec)

    x, y = staged(g, g_rows), staged(b, b_rows)
    acc = torch.zeros((nnz, lanes), dtype=torch.float32)
    for c in range(chunks):
        part = x[:, c, :, 0] * y[:, c, :, 0]
        for v in range(1, vec):
            part = fma_f32(x[:, c, :, v], y[:, c, :, v], part)
        acc = acc + part
    while acc.shape[1] > 1:
        half = acc.shape[1] // 2
        acc = acc[:, :half] + acc[:, half:]
    out = torch.empty(nnz, dtype=torch.float32)
    at = np.arange(nnz) if tiles.perm is None else tiles.perm
    out[torch.as_tensor(at, dtype=torch.int64)] = acc[:, 0]
    return out
