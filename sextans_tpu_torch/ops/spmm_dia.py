"""SpMM over the diagonal part of a hybrid split (ops/hybrid.py).

``spmm_dia`` is the twin of ``sextans_tpu.ops.spmm_dia_pallas``'s
``spmm_dia_padded`` (kernel K6, the hybrid plan's route for N > 32) and
``spmm_dia_skinny`` of its ``spmm_dia_ct_padded`` (kernel K7, N <= 32). On a
CUDA tensor each launches its hand-written kernel in ``csrc/spmm_dia.cu``; on
a CPU tensor both run the one plain PyTorch version, ``spmm_dia_ref``. Any
other device raises.

The layout is the port's own: one (D, M) ``dvals`` array for both kernels,
the (D,) offsets as an int32 tensor beside it, and B and C as they are,
(K, N) and (M, N). The JAX kernels take B padded with
``pad_lo = max(0, -min(offsets))`` zero rows on top and zero rows below it,
K7 on B and C transposed; here a row of B outside [0, K) reads as 0, which is
what those zero rows held, so no padded or transposed copy is made.

Both kernels take their diagonals in runs (:func:`dia_plan`, from the host
scan :func:`dia_runs` of the offsets, made
once where the split is uploaded, with the offsets it holds on the device):
a run's window of B and its ``dvals`` are staged in shared memory per row
tile, 64 rows by 16 or 64 columns for K6 (:func:`dia_launch`), 16 or 64 rows
by all N <= 32 columns for K7, in a ring of buffers (:func:`dia_skinny_launch`).

K6 has a second walk, over an entry map (:func:`dia_entries`, made once
where the split is uploaded, from the values it uploads): per run of
diagonals and group of 8 rows, slots of 8 (value, window row) pairs, one a
row, that list the slots of ``dvals`` that hold a value, so that a split
whose diagonals are mostly stored zeros multiplies its entries alone
(:func:`dia_entry_launch`). The hybrid plan takes it where it holds no more
than :func:`entry_walk_slots`, always in precise mode; a window of B that holds a value that is not
finite is walked densely all the same, so that a stored zero meets it as
on the TPU.

``precise`` 1 or 2 runs the compensated variant of both kernels (the JAX
kernels have one ``precise`` flag, so both levels are one computation):
per diagonal the exact product ``two_prod`` and a Neumaier step, then the
compensated epilogue (``ops/df32.py``, ``csrc/df32.cuh``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from sextans_tpu_torch.ops.df32 import acc_step, compensated_epilogue, two_prod
from sextans_tpu_torch.ops.launch import (
    SMEM_LIMIT,
    Launch,
    SharedMemoryError,
    f32,
    fma_f32,
    need,
    stream_of,
)
from sextans_tpu_torch.ops.spmm_slab import SKINNY_MAX_N
from sextans_tpu_torch.runtime.build import build_kernels, check_launch
from sextans_tpu_torch.utils.config import cdiv, round_up
from sextans_tpu_torch.utils.profiling import annotate, count

__all__ = ["spmm_dia", "spmm_dia_skinny", "spmm_dia_ref", "DiaRuns", "dia_plan",
           "dia_launch", "dia_skinny_launch", "DIA_SPAN_MAX", "dia_runs", "DiaEntries",
           "dia_entries", "dia_entry_map", "check_entry_map", "dia_entry_launch",
           "entry_walk_slots", "DIA_ENTRY_SPAN_MAX"]

# K6's tile (csrc/spmm_dia.cu: kTileRows, kLanes, kThreads): 64 rows by 16
# lanes of VEC columns, 128 threads of 8 rows each
DIA_TILE_ROWS = 64
DIA_LANES = 16
DIA_THREADS = 128
# The widest run of diagonals a window covers: at VEC = 4 a CTA then holds
# (64 + 64 + 8) * 64 * 4 bytes of B and at most 65 * 65 * 4 of dvals and
# offsets, 51,716 bytes, so four CTAs fit on an SM.
DIA_SPAN_MAX = 64


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


@dataclass(frozen=True)
class DiaRuns:
    """K6's run plan of one set of offsets, on their device: ``offsets``
    (D,) int32, ascending; run ``r`` holds diagonals ``ptr[r]:ptr[r+1]``;
    ``span`` bounds each run's last offset minus its first and ``length``
    its number of diagonals, which size the kernel's shared memory. Made by
    :func:`dia_plan`; one built by hand is held to its offsets here (a copy
    of both to the host), so that no plan the kernel is given stages past
    the memory it sized. :func:`spmm_dia` takes only the offsets tensor its
    plan holds."""

    offsets: torch.Tensor
    ptr: torch.Tensor
    span: int
    length: int

    def __post_init__(self):
        if self.offsets.dim() != 1 or self.ptr.dim() != 1 or self.ptr.numel() < 1:
            raise ValueError("DiaRuns takes 1-D offsets and a 1-D ptr of at least one entry")
        offs = self.offsets.cpu().numpy().astype(np.int64)
        ptr = self.ptr.cpu().numpy().astype(np.int64)
        if np.any(np.diff(offs) <= 0):
            raise ValueError("DiaRuns: the offsets must ascend strictly")
        if ptr[0] != 0 or ptr[-1] != offs.size or np.any(np.diff(ptr) < 1):
            raise ValueError(f"DiaRuns: ptr must cut the {offs.size} diagonals into non-empty "
                             "runs, in order")
        if offs.size:
            span = int((offs[ptr[1:] - 1] - offs[ptr[:-1]]).max())
            length = int(np.diff(ptr).max())
            if span > self.span or length > self.length:
                raise ValueError(f"DiaRuns: a run spans {span} and one holds {length} "
                                 f"diagonals, beyond span {self.span} and length {self.length}")


def dia_plan(offsets, device) -> DiaRuns:
    """The run plan of the ascending ``offsets`` (a host array), with the
    offsets uploaded to ``device`` as int32:
    :func:`dia_runs` at the run limit
    ``DIA_SPAN_MAX``."""
    offs = np.asarray(offsets, dtype=np.int64)
    ptr = dia_runs(offs, DIA_SPAN_MAX)
    first, last = ptr[:-1], ptr[1:] - 1
    span = int((offs[last] - offs[first]).max(initial=0))
    length = int(np.diff(ptr).max(initial=0))
    return DiaRuns(torch.from_numpy(offs.astype(np.int32)).to(device),
                   torch.from_numpy(ptr).to(device), span, length)


def dia_launch(n: int, m: int, runs: DiaRuns, vec: int) -> Launch:
    """K6's thread map and grid (``csrc/spmm_dia.cu``): one CTA of 128
    threads per (64-row tile, 16 * ``vec`` columns), the column tiles of a
    row tile adjacent; a thread over 8 rows and ``vec`` columns; shared
    memory for the widest run's window of B, (64 + span) rows of the tile's
    columns and 8 rows of slack, and the longest run's dvals, length x 64,
    and offsets. Raises
    :class:`SharedMemoryError` where that exceeds a CTA's."""
    tn = DIA_LANES * vec
    smem = 4 * ((DIA_TILE_ROWS + runs.span + 8) * tn + runs.length * (DIA_TILE_ROWS + 1))
    if smem > SMEM_LIMIT:
        raise SharedMemoryError(
            f"spmm_dia: a run of span {runs.span} and {runs.length} diagonals needs "
            f"{smem} bytes of shared memory at {tn} columns, more than the "
            f"{SMEM_LIMIT} of a CTA (dia_plan cuts runs at span {DIA_SPAN_MAX})")
    tiles = cdiv(m, DIA_TILE_ROWS) * cdiv(n, tn)
    if tiles >= 2**31:
        raise ValueError(f"spmm_dia: {tiles} tiles exceed the grid")
    return Launch(DIA_LANES, vec, DIA_THREADS, (tiles, 1), smem)

# K7's tiles (csrc/spmm_dia.cu: skinny_threads): 16 rows by all n columns,
# a thread a cell, four buffers of one run each; or, where tiles of 64 rows
# still fill the card four times over, 64 rows, 4 cells a thread, two buffers
DIA_SKINNY_WIDE_CTAS = 4 * 132


def dia_skinny_launch(n: int, m: int, runs: DiaRuns) -> Launch:
    """K7's thread map and grid (``csrc/spmm_dia.cu``): one CTA per tile of
    ``rows`` rows and all ``n`` <= 32 columns; 64 rows where ceil(m / 64)
    CTAs fill the card four times over, 4 cells of the tile's row-major
    (row, column) index a thread and two buffers, else 16 rows, a thread a
    cell and four buffers (``lanes`` = rows, ``cols`` = cells a thread).
    Each buffer in shared memory holds the widest run's window of B, rows +
    span rows of n floats, and the longest run's dvals, length x rows, and
    offsets, so that the next runs' copies land while one run's diagonals
    are added. Raises :class:`SharedMemoryError` where that exceeds a
    CTA's."""
    if not 1 <= n <= SKINNY_MAX_N:
        raise ValueError(f"spmm_dia_skinny takes 1 <= n <= {SKINNY_MAX_N}, got {n}")
    wide = cdiv(m, 64) >= DIA_SKINNY_WIDE_CTAS
    rows, cells, stages = (64, 4, 2) if wide else (16, 1, 4)
    smem = stages * 4 * round_up((rows + runs.span) * n + runs.length * (rows + 1), 4)
    if smem > SMEM_LIMIT:
        raise SharedMemoryError(
            f"spmm_dia_skinny: a run of span {runs.span} and {runs.length} diagonals needs "
            f"{smem} bytes of shared memory at {n} columns, more than the {SMEM_LIMIT} of a "
            f"CTA (dia_plan cuts runs at span {DIA_SPAN_MAX})")
    threads = 32 * cdiv(rows * n, 32 * cells)
    return Launch(rows, cells, threads, (cdiv(m, rows), 1), smem)

# K6's entry walk: a thread walks the slots of a group of 8 rows of its
# tile, each slot a value and a window row for each of the 8
DIA_GROUP_ROWS = 8
# The widest run of the entry walk: it stages no dvals, so at VEC = 4 a CTA
# holds (64 + 128) * 64 * 4 = 49,152 bytes of B and four CTAs fit on an SM;
# scircuit_like's -60..60 is one run.
DIA_ENTRY_SPAN_MAX = 128
# A slot's bytes, and the shared memory of an entry walk's CTA that leaves
# four an SM (228 KB, 1 KB of each reserved): a tile's slots fill the rest
DIA_SLOT_BYTES = 64
DIA_ENTRY_SMEM = 228 * 1024 // 4 - 1024
# In plain mode the entry walk runs where its slots' rows (8 a slot, pads
# included) are at most this share of the dense walk's steps (a row's
# steps: each run's span + 1; D on consecutive offsets) times M: on an H100
# the two walks cross at 0.26-0.39 on scircuit_like's 121 consecutive
# offsets filled at random, a tridiagonal matrix's full slots (share 1)
# are 3 % faster densely, and on laplace3d_64's 7 offsets in 131 steps the
# entry walk is the faster at every fill. In precise mode the entry walk
# is the faster at every fill of all three, 5.04 against 5.52 ms with
# every slot of the 121 offsets full (`tools/kernel_times.py --walks`;
# PERF.md §6).
DIA_ENTRY_SHARE = 0.3


def entry_walk_slots(offsets, m: int, precise: int = 0) -> Optional[int]:
    """The most slots at which K6's entry walk beats its dense walk (the
    run plan :func:`dia_plan` makes of the ascending ``offsets``) over ``m``
    rows: ``DIA_ENTRY_SHARE`` of the dense walk's steps in plain mode, no
    limit (None) in precise mode."""
    if precise:
        return None
    offs = np.asarray(offsets, dtype=np.int64)
    ptr = dia_runs(offs, DIA_SPAN_MAX)
    steps = int((offs[ptr[1:] - 1] - offs[ptr[:-1]] + 1).sum()) if offs.size else 0
    return int(DIA_ENTRY_SHARE * steps * m) // DIA_GROUP_ROWS


def dia_entry_map(values, offsets, span_max: int = DIA_ENTRY_SPAN_MAX, *,
                  within: Optional[int] = None):
    """The host arrays of K6's entry map of the (D, M) ``values`` on the
    ascending ``offsets``. A 64-row tile's rows are taken in ``order``
    (uint8, a permutation of 0..63 a tile): by how many values each holds,
    most first (the rows past M last), so that the 8 rows of a group, one
    thread's, hold about as many. ``ptr``, the runs (:func:`dia_runs` at
    ``span_max``); ``slot_ptr`` (int32, runs x groups + 1, 8 groups a
    tile), the slots of group ``g`` (the tile's rows ``order[8g ..
    8g + 7]``) in run ``r`` at ``slot_ptr[r * groups + g]`` up to the next;
    ``slots`` (int32, S x 16), each slot the bits of its 8 rows' values,
    then their rows of the run's window: the row in the tile plus the
    offset less the run's first. A row's slots list the diagonals of the
    run at which it holds a value that is not zero (NaN included), in
    ascending offset order, one a slot; a row with fewer than its group's
    most takes value 0 and window row 0 in the rest, as do the rows past M.
    Returns ``(ptr, order, slot_ptr, slots, entries)``, ``entries`` the
    values listed; None where the map would hold more than ``within``
    slots, found from the rows' counts before any slot is made."""
    vals = np.asarray(values, dtype=np.float32)
    offs = np.asarray(offsets, dtype=np.int64)
    if vals.ndim != 2 or vals.shape[0] != offs.size:
        raise ValueError(f"values must be (D, M) with D = {offs.size}, got {vals.shape}")
    m = vals.shape[1]
    rows = round_up(m, DIA_TILE_ROWS)
    groups = rows // DIA_GROUP_ROWS
    ptr = dia_runs(offs, span_max)
    held = np.full(rows, -1)
    held[:m] = np.count_nonzero(vals, axis=0)
    order = np.argsort(-held.reshape(-1, DIA_TILE_ROWS), axis=1, kind="stable")
    at_row = np.empty(rows, dtype=np.int64)  # each row's place in the walk
    at_row[(order + np.arange(0, rows, DIA_TILE_ROWS)[:, None]).ravel()] = np.arange(rows)
    per_group = []
    for d0, d1 in zip(ptr[:-1], ptr[1:]):
        per_row = np.zeros(rows, dtype=np.int64)
        per_row[at_row[:m]] = np.count_nonzero(vals[d0:d1], axis=0)
        per_group.append(per_row.reshape(groups, DIA_GROUP_ROWS).max(axis=1))
    slot_ptr = np.zeros(len(per_group) * groups + 1, dtype=np.int64)
    if per_group:
        np.cumsum(np.concatenate(per_group), out=slot_ptr[1:])
    if within is not None and slot_ptr[-1] > within:
        return None
    if slot_ptr[-1] >= 2**31:
        raise ValueError(f"dia_entry_map: {slot_ptr[-1]} slots exceed int32")
    slots = np.zeros((int(slot_ptr[-1]), 2 * DIA_GROUP_ROWS), dtype=np.int32)
    bits = vals.view(np.int32)
    entries = 0
    for r, (d0, d1) in enumerate(zip(ptr[:-1], ptr[1:])):
        i, d = np.nonzero(vals[d0:d1].T != 0)  # by row, then offset
        d += d0
        first = np.searchsorted(i, i, side="left")  # each row's first entry
        at = slot_ptr[r * groups + at_row[i] // DIA_GROUP_ROWS] + (np.arange(i.size) - first)
        lane = at_row[i] % DIA_GROUP_ROWS
        slots[at, lane] = bits[d, i]
        slots[at, DIA_GROUP_ROWS + lane] = i % DIA_TILE_ROWS + offs[d] - offs[d0]
        entries += i.size
    return ptr, order.astype(np.uint8).ravel(), slot_ptr.astype(np.int32), slots, entries


def check_entry_map(ptr, order, slot_ptr, slots, offsets, m: int) -> int:
    """Hold the host arrays of an entry map (:func:`dia_entry_map`) of M
    rows on the ascending ``offsets`` to its tiles and its runs' windows, so
    that no thread takes a row twice and no slot reads past the window the
    kernel stages. Returns the most slots a tile has in a run."""
    offs = np.asarray(offsets, dtype=np.int64)
    ptr = np.asarray(ptr, dtype=np.int64)
    rows = round_up(m, DIA_TILE_ROWS)
    groups = rows // DIA_GROUP_ROWS
    n_runs = ptr.size - 1
    if order.shape != (rows,) or np.any(
            np.sort(order.reshape(-1, DIA_TILE_ROWS), axis=1) != np.arange(DIA_TILE_ROWS)):
        raise ValueError("entry map: order must take each row of a tile once")
    sp = np.asarray(slot_ptr, dtype=np.int64)
    if sp.shape != (n_runs * groups + 1,) or sp[0] != 0 or sp[-1] != slots.shape[0] \
            or np.any(np.diff(sp) < 0):
        raise ValueError(f"entry map: slot_ptr must cut the {slots.shape[0]} slots into "
                         f"{n_runs} x {groups} groups, in order")
    spans = offs[ptr[1:] - 1] - offs[ptr[:-1]] if offs.size else np.zeros(0, np.int64)
    # each slot's run's window: 64 + span rows
    window = np.repeat(DIA_TILE_ROWS + spans, np.diff(sp[np.arange(n_runs + 1) * groups]))
    at = slots[:, DIA_GROUP_ROWS:]
    if at.size and (at.min() < 0 or np.any(at.max(axis=1) >= window)):
        raise ValueError("entry map: a slot reads past its run's window")
    return int(np.diff(sp[::DIA_TILE_ROWS // DIA_GROUP_ROWS]).max(initial=0))


@dataclass(frozen=True)
class DiaEntries:
    """K6's entry map of one ``dvals`` tensor, on its device
    (:func:`dia_entries`): ``runs``, its run plan over the offsets K6
    takes (each run's span at most ``DIA_ENTRY_SPAN_MAX``); ``order``,
    uint8; ``slot_ptr`` and ``slots``, int32; ``entries``, the values it
    lists; ``tile_slots``, the most slots a tile has in a run. It is tied
    to the ``dvals`` it was made from, as a run plan to its offsets:
    :func:`spmm_dia` takes only that tensor beside it, since a map of other
    values skips their entries."""

    dvals: torch.Tensor
    runs: DiaRuns
    order: torch.Tensor
    slot_ptr: torch.Tensor
    slots: torch.Tensor
    entries: int
    tile_slots: int

    def __post_init__(self):
        if self.dvals.dim() != 2 or self.dvals.shape[0] != self.runs.offsets.numel():
            raise ValueError("DiaEntries: dvals must be (D, M) over the run plan's D offsets")
        rows = round_up(self.dvals.shape[1], DIA_TILE_ROWS)
        groups = rows // DIA_GROUP_ROWS
        device = self.dvals.device
        need(self.order, "order", torch.uint8, (rows,), device)
        need(self.slot_ptr, "slot_ptr", torch.int32,
             ((self.runs.ptr.numel() - 1) * groups + 1,), device)
        need(self.slots, "slots", torch.int32, (self.slots.shape[0], 2 * DIA_GROUP_ROWS), device)


def dia_entries(dvals: torch.Tensor, offsets: torch.Tensor, values=None, *,
                within: Optional[int] = None) -> Optional[DiaEntries]:
    """K6's entry map of ``dvals`` on the ascending ``offsets`` (the int32
    tensor K6 takes, which the map's run plan holds), checked on the host
    (:func:`check_entry_map`) and uploaded to their device; ``values`` is
    ``dvals`` on the host where the caller has it (no copy back), and must
    hold the same values. None where the map would hold more than
    ``within`` slots (:func:`dia_entry_map`), before anything is uploaded."""
    values = dvals.cpu().numpy() if values is None else values
    offs = offsets.cpu().numpy()
    host = dia_entry_map(values, offs, within=within)
    if host is None:
        return None
    ptr, order, slot_ptr, slots, entries = host
    tile_slots = check_entry_map(ptr, order, slot_ptr, slots, offs, dvals.shape[1])
    offs = offs.astype(np.int64)
    span = int((offs[ptr[1:] - 1] - offs[ptr[:-1]]).max(initial=0))
    runs = DiaRuns(offsets, torch.from_numpy(ptr).to(offsets.device), span,
                   int(np.diff(ptr).max(initial=0)))
    return DiaEntries(dvals, runs, *(torch.from_numpy(a).to(dvals.device)
                                     for a in (order, slot_ptr, slots)), entries, tile_slots)


def dia_entry_launch(n: int, m: int, entries: DiaEntries, vec: int) -> Launch:
    """The entry walk's thread map and grid (``csrc/spmm_dia.cu``): K6's
    (:func:`dia_launch`), with shared memory for the widest run's window of
    B, 64 + span rows of the tile's 16 * ``vec`` columns, and beside it a
    tile's slots in a run, ``lanes`` of them: the most a tile has, or as
    many as leave four CTAs an SM (a tile with more reads its slots from
    global memory). Raises :class:`SharedMemoryError` where the window alone
    exceeds a CTA's."""
    tn = DIA_LANES * vec
    window = 4 * (DIA_TILE_ROWS + entries.runs.span) * tn
    if window > SMEM_LIMIT:
        raise SharedMemoryError(
            f"spmm_dia: an entry run of span {entries.runs.span} needs {window} bytes of shared "
            f"memory at {tn} columns, more than the {SMEM_LIMIT} of a CTA (dia_entry_map "
            f"cuts runs at span {DIA_ENTRY_SPAN_MAX})")
    staged = min(entries.tile_slots, max(0, DIA_ENTRY_SMEM - window) // DIA_SLOT_BYTES)
    tiles = cdiv(m, DIA_TILE_ROWS) * cdiv(n, tn)
    if tiles >= 2**31:
        raise ValueError(f"spmm_dia: {tiles} tiles exceed the grid")
    return Launch(staged, vec, DIA_THREADS, (tiles, 1), window + DIA_SLOT_BYTES * staged)

# Bytes of one (rows, n) f64 temporary per row step of the plain version.
_REF_CHUNK_BYTES = 256 << 20


def spmm_dia_ref(
    dvals: torch.Tensor,  # (D, m) f32
    offsets: torch.Tensor,  # (D,) i32
    b: torch.Tensor,  # (k, n) f32
    c: torch.Tensor,  # (m, n) f32
    alpha: float,
    beta: float,
    *,
    with_c: bool = True,
    precise: int = 0,
) -> torch.Tensor:
    """Plain PyTorch version of both kernels, rounding as they do: for each
    row, one fused multiply-add per diagonal in offset order from zero,
    ``dvals[d, i] * B[i + offsets[d]]`` with B zero-padded above and below,
    then ``fma(alpha, acc, beta * C)``; in precise mode ``two_prod`` and a
    Neumaier step per diagonal and the compensated epilogue. Works in row
    steps, so that no (M, N) temporary is made per diagonal."""
    n_diags, m = dvals.shape
    k, n = b.shape
    offs = [int(o) for o in offsets.tolist()]
    pad_lo = max(0, -min(offs, default=0))
    pad_hi = max(0, max(offs, default=0) + m - k)
    b_p = F.pad(b, (0, 0, pad_lo, pad_hi))
    acc = torch.empty((m, n), dtype=torch.float32, device=dvals.device)
    comp = torch.empty_like(acc) if precise else None
    step = max(1, _REF_CHUNK_BYTES // (8 * n))
    for r0 in range(0, m, step):
        r1 = min(m, r0 + step)
        a = torch.zeros((r1 - r0, n), dtype=torch.float32, device=dvals.device)
        cm = torch.zeros_like(a) if precise else None
        for d, off in enumerate(offs):
            lo = r0 + off + pad_lo
            dv, x = dvals[d, r0:r1, None], b_p[lo:lo + r1 - r0]
            if precise:
                a, cm = acc_step(a, cm, *two_prod(dv, x))
            else:
                a = fma_f32(dv, x, a)
        acc[r0:r1] = a
        if precise:
            comp[r0:r1] = cm
    if precise:
        return compensated_epilogue(alpha, acc, comp, *((beta, c) if with_c else ()))
    if not with_c:
        return acc * f32(alpha)
    return fma_f32(torch.full_like(acc, f32(alpha)), acc, c * f32(beta))


def _check_dia_operands(dvals, offsets, b, c, *, with_c):
    """Check every operand of a launch; returns ``(n_diags, m, k, n)``. With
    ``with_c=False``, ``c`` is used for its shape only and may be a
    broadcast view."""
    device = dvals.device
    if dvals.dim() != 2 or b.dim() != 2 or c.dim() != 2:
        raise ValueError("dvals, b and c must be 2-D")
    n_diags, m = dvals.shape
    k, n = b.shape
    need(dvals, "dvals", torch.float32, (n_diags, m), device)
    need(offsets, "offsets", torch.int32, (n_diags,), device)
    need(b, "b", torch.float32, (k, n), device)
    if with_c:
        need(c, "c", torch.float32, (m, n), device)
    elif tuple(c.shape) != (m, n):
        raise ValueError(f"c must have shape {(m, n)}")
    if m == 0 or n == 0 or max(m, k, n) >= 2**31:
        raise ValueError(f"M, K and N must be in [1, 2**31), got {(m, k, n)}")
    return n_diags, m, k, n


def _check_entries(entries, dvals, offsets):
    """A map is walked only over the values and offsets it was made from."""
    if entries.dvals is not dvals:
        raise ValueError("spmm_dia takes the dvals its entry map was made from: pass "
                         "entries.dvals")
    if entries.runs.offsets is not offsets:
        raise ValueError("spmm_dia takes the offsets its entry map's run plan holds: pass "
                         "entries.runs.offsets")


def _launch(name, dvals, offsets, b, c, alpha, beta, *, with_c, precise, runs=None,
            entries=None):
    if int(precise) not in (0, 1, 2):
        raise ValueError(f"precise must be 0, 1 or 2, got {precise}")
    if dvals.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {dvals.device}")
    n_diags, m, k, n = _check_dia_operands(dvals, offsets, b, c, with_c=with_c)
    if runs is None:
        raise ValueError(f"{name} needs runs=dia_plan(offsets, device) on a CUDA device, "
                         "and runs.offsets as its offsets")
    if runs.offsets is not offsets:
        raise ValueError(f"{name} takes the offsets its run plan holds: pass runs.offsets")
    if entries is not None:  # the entry walk, over the map's own runs
        runs = entries.runs
    n_runs = runs.ptr.shape[0] - 1
    need(runs.ptr, "runs.ptr", torch.int32, (n_runs + 1,), dvals.device)
    if name == "spmm_dia":
        dense = (b, c) if with_c else (b,)
        vec = 4 if n % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in dense) else 1
        go = (dia_launch(n, m, runs, vec) if entries is None
              else dia_entry_launch(n, m, entries, vec))
    else:  # K7 reads C per element: only B's rows are copied 16 bytes at a time
        vec = int(n % 4 == 0 and b.data_ptr() % 16 == 0)
        go = dia_skinny_launch(n, m, runs)
    out = torch.empty((m, n), dtype=torch.float32, device=dvals.device)
    lib = build_kernels()
    c_ptr = c.data_ptr() if with_c else None
    tail = (float(alpha), float(beta), int(with_c), int(bool(precise)), vec, runs.span)
    with torch.cuda.device(dvals.device):
        if entries is not None:
            err = lib.spmm_dia_entry_launch(
                dvals.data_ptr(), offsets.data_ptr(), runs.ptr.data_ptr(),
                entries.order.data_ptr(), entries.slot_ptr.data_ptr(), entries.slots.data_ptr(),
                b.data_ptr(), c_ptr, out.data_ptr(), m, k, n, n_runs, *tail, go.lanes,
                go.threads, go.grid[0], go.smem, stream_of(dvals.device))
        else:
            launch = lib.spmm_dia_launch if name == "spmm_dia" else lib.spmm_dia_skinny_launch
            err = launch(dvals.data_ptr(), offsets.data_ptr(), runs.ptr.data_ptr(),
                         b.data_ptr(), c_ptr, out.data_ptr(), m, k, n, n_runs, *tail,
                         runs.length, *(() if name == "spmm_dia" else (go.lanes,)),
                         go.threads, go.grid[0], go.smem, stream_of(dvals.device))
    check_launch(lib, name, err)
    return out


def spmm_dia(
    dvals: torch.Tensor,
    offsets: torch.Tensor,
    b: torch.Tensor,
    c: torch.Tensor,
    alpha: float,
    beta: float,
    *,
    runs: Optional[DiaRuns] = None,
    entries: Optional[DiaEntries] = None,
    with_c: bool = True,
    precise: int = 0,
) -> torch.Tensor:
    """``alpha * A_dia @ B + beta * C`` with the wide-N kernel; returns the
    (M, N) result. On a CUDA device ``runs`` is the run plan of the same
    offsets, and ``offsets`` is ``runs.offsets`` (:func:`dia_plan`; any
    cut of them into runs gives the same bits); the plain version on the
    CPU does not read ``runs``. ``entries``, the entry map of ``dvals`` on
    those offsets (:func:`dia_entries`), runs the entry walk (the same bits;
    on the CPU the plain version, but only over the ``dvals`` and offsets
    the map was made from). ``with_c=False`` drops
    the C read and ``c`` then gives the shape only; ``precise`` 1 or 2 runs
    the compensated variant."""
    with annotate("sx.kernel.spmm_dia"):
        if entries is not None:
            _check_entries(entries, dvals, offsets)
        if dvals.device.type == "cpu":
            return spmm_dia_ref(dvals, offsets, b, c, alpha, beta, with_c=with_c,
                                precise=precise)
        out = _launch("spmm_dia", dvals, offsets, b, c, alpha, beta, with_c=with_c,
                      precise=precise, runs=runs, entries=entries)
        count("launch.spmm_dia")
        if entries is not None:
            count("launch.spmm_dia.entries")
        return out


def spmm_dia_skinny(
    dvals: torch.Tensor,
    offsets: torch.Tensor,
    b: torch.Tensor,
    c: torch.Tensor,
    alpha: float,
    beta: float,
    *,
    runs: Optional[DiaRuns] = None,
    with_c: bool = True,
    precise: int = 0,
) -> torch.Tensor:
    """The same function as :func:`spmm_dia` for N <= 32 with the skinny-N
    kernel (a 16-row tile by all N columns a CTA, a window of B per run in
    shared memory, :func:`dia_skinny_launch`); ``runs`` as for
    :func:`spmm_dia`."""
    with annotate("sx.kernel.spmm_dia_skinny"):
        if dvals.device.type == "cpu":
            return spmm_dia_ref(dvals, offsets, b, c, alpha, beta, with_c=with_c,
                                precise=precise)
        out = _launch("spmm_dia_skinny", dvals, offsets, b, c, alpha, beta, with_c=with_c,
                      precise=precise, runs=runs)
        count("launch.spmm_dia_skinny")
        return out
