"""Edge-stream pack pass: COO → per-nonzero packed edge chunks.

The NumPy path of ``sextans_tpu.format.pack_edge``, carried over unchanged so
that both packages see byte-identical packed arrays. It feeds the edge-stream
kernel (ops/spmm_edge.py). One record per nonzero, no block padding, so the
packed size is ~8 B/nnz whatever the sparsity pattern. Each edge packs

    meta = row_local(14b) << 17 | col_local(15b) << 2 | row_end << 1 | pad

(row/col local to the M-tile / K-window), CSR-sorted within each (M-tile,
K-window) job, so a kernel can sum a row's run in a register and add it to
the accumulator once per (row, chunk).

Array layout (chunk = ``config.edge_chunk`` edges):

* ``vals``  (chunks, 1, E) f32 — edge values;
* ``meta``  (chunks, 1, E) i32 — packed steering word per edge (above);
* ``chunk_mtile`` (chunks+1,) i32, sentinel -1 / ``chunk_kwin`` (chunks,)
  i32 — the same steering as the block formats: a chunk belongs to exactly
  one (M-tile, K-window) job.

Row runs are padded to a multiple of ``config.edge_lanes``; padding slots
(value 0, col 0, the run's row, pad bit set) also complete the last chunk of
each job. The final slot of every chunk is force-marked ``row_end`` so row
partials never span chunks (a row split across chunks flushes twice — the
accumulator add is associative and hazard-free). M-tiles with no edges get
one all-padding chunk, appended after all real chunks.

Precondition (all padded kernels): B must be finite. A pad slot computes
``0 * B_window[0, :]``, which is exactly 0.0 for finite B but NaN if B
carries Inf/NaN in the first row of a K-window, unless
``config.edge_masked`` selects pads out.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from sextans_tpu_torch.format.coo import COOMatrix
from sextans_tpu_torch.format.pack import (
    PackStats,
    _check_impl,
    reorder_columns,
    reorder_rows,
)
from sextans_tpu_torch.utils.config import SpmmConfig, cdiv
from sextans_tpu_torch.utils.profiling import timed

__all__ = ["PackedSpMatrixEdge", "pack_edge"]

ROW_SHIFT = 17
COL_SHIFT = 2
ROW_END = 2
PAD_BIT = 1  # slot is padding (value 0); lets a masked kernel skip it
MAX_TILE_M = 1 << (31 - ROW_SHIFT)  # 16384
MAX_WINDOW_K = 1 << (ROW_SHIFT - COL_SHIFT)  # 32768


@dataclass
class PackedSpMatrixEdge:
    """Per-nonzero edge-stream matrix for the edge kernel."""

    m: int
    k: int
    nnz: int
    config: SpmmConfig
    n_mtiles: int
    n_kwins: int
    vals: np.ndarray  # (chunks, 1, E) f32
    meta: np.ndarray  # (chunks, 1, E) i32
    chunk_mtile: np.ndarray  # (chunks+1,) i32, sentinel -1
    chunk_kwin: np.ndarray  # (chunks,) i32
    stats: PackStats
    col_perm: Optional[np.ndarray] = None
    row_perm: Optional[np.ndarray] = None

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.m, self.k)

    @property
    def n_chunks(self) -> int:
        return int(self.chunk_kwin.shape[0])

    # chunk ≙ group: the steering vocabulary of the block formats
    @property
    def n_groups(self) -> int:
        return self.n_chunks

    @property
    def group_mtile(self) -> np.ndarray:
        return self.chunk_mtile

    @property
    def group_kwin(self) -> np.ndarray:
        return self.chunk_kwin

    @property
    def m_padded(self) -> int:
        return self.n_mtiles * self.config.tile_m

    @property
    def k_padded(self) -> int:
        return self.n_kwins * self.config.window_k

    def save(self, path) -> None:
        np.savez_compressed(
            path,
            fmt=np.array(["edge"]),
            shape=np.array([self.m, self.k, self.nnz], dtype=np.int64),
            cfg=np.array(
                [
                    self.config.tile_m,
                    self.config.window_k,
                    self.config.edge_chunk,
                    -1 if self.config.tile_n is None else self.config.tile_n,
                    self.config.edge_lanes,
                ],
                dtype=np.int64,
            ),
            vals=self.vals,
            meta=self.meta,
            chunk_mtile=self.chunk_mtile,
            chunk_kwin=self.chunk_kwin,
            stats=np.array(
                [
                    self.stats.nnz,
                    self.stats.blocks,
                    self.stats.slots,
                    self.stats.groups,
                    self.stats.pad_blocks,
                    self.stats.jobs,
                    self.stats.empty_mtiles,
                    self.stats.a_bytes or 0,
                ],
                dtype=np.int64,
            ),
            col_perm=(
                self.col_perm
                if self.col_perm is not None
                else np.empty(0, np.int32)
            ),
            row_perm=(
                self.row_perm
                if self.row_perm is not None
                else np.empty(0, np.int32)
            ),
        )

    @classmethod
    def load(cls, path) -> "PackedSpMatrixEdge":
        z = np.load(path)
        if "fmt" not in z or str(z["fmt"][0]) != "edge":
            raise ValueError(f"{path} is not an edge-format pack file")
        m, k, nnz = (int(x) for x in z["shape"])
        cf = [int(x) for x in z["cfg"]]
        tm, wk, ec, tn = cf[:4]
        cfg = SpmmConfig(
            tile_m=tm,
            window_k=wk,
            edge_chunk=ec,
            tile_n=None if tn < 0 else tn,
            edge_lanes=cf[4] if len(cf) > 4 else 1,
        )
        s = [int(x) for x in z["stats"]]
        stats = PackStats(
            nnz=s[0], blocks=s[1], slots=s[2], groups=s[3],
            pad_blocks=s[4], jobs=s[5], empty_mtiles=s[6],
            a_bytes=s[7] or None,
        )
        return cls(
            m=m, k=k, nnz=nnz, config=cfg,
            n_mtiles=max(1, cdiv(m, tm)), n_kwins=max(1, cdiv(k, wk)),
            vals=z["vals"], meta=z["meta"],
            chunk_mtile=z["chunk_mtile"], chunk_kwin=z["chunk_kwin"],
            stats=stats,
            col_perm=(
                z["col_perm"] if "col_perm" in z and z["col_perm"].size else None
            ),
            row_perm=(
                z["row_perm"] if "row_perm" in z and z["row_perm"].size else None
            ),
        )


@timed("pack_s")
def pack_edge(
    coo: COOMatrix,
    config: SpmmConfig,
    reorder_cols: bool = False,
    reorder_rows_: bool = False,
    impl: str = "auto",
) -> PackedSpMatrixEdge:
    """Pack a COO matrix into the edge-stream format.

    Requires ``tile_m <= 16384`` and ``window_k <= 32768`` (the local
    row/col fields of the packed meta word). ``impl``: "numpy" or "auto"
    (which means NumPy here); "native" raises ``NotImplementedError``, as in
    :func:`~sextans_tpu_torch.format.pack.pack`. The arrays are
    byte-identical to ``sextans_tpu.format.pack_edge.pack_edge(...,
    impl="numpy")``.
    """
    _check_impl(impl)
    tm, wk, E = config.tile_m, config.window_k, config.edge_chunk
    if tm > MAX_TILE_M:
        raise ValueError(f"edge format needs tile_m <= {MAX_TILE_M}, got {tm}")
    if wk > MAX_WINDOW_K:
        raise ValueError(
            f"edge format needs window_k <= {MAX_WINDOW_K}, got {wk}"
        )

    col_perm = None
    row_perm = None
    if reorder_cols and coo.nnz > 0:
        coo, col_perm = reorder_columns(coo)
    if reorder_rows_ and coo.nnz > 0:
        coo, row_perm = reorder_rows(coo)

    m, k = coo.shape
    n_mtiles = max(1, cdiv(m, tm))
    n_kwins = max(1, cdiv(k, wk))
    nnz = coo.nnz

    if nnz == 0:
        stats = PackStats(
            nnz=0, blocks=0, slots=0, groups=n_mtiles, pad_blocks=0, jobs=0,
            empty_mtiles=n_mtiles, a_bytes=8 * E * n_mtiles,
        )
        # one all-padding epilogue chunk per M-tile so every beta*C output
        # tile is still written
        return PackedSpMatrixEdge(
            m=m, k=k, nnz=0, config=config,
            n_mtiles=n_mtiles, n_kwins=n_kwins,
            vals=np.zeros((n_mtiles, 1, E), np.float32),
            meta=np.full((n_mtiles, 1, E), PAD_BIT, np.int32),
            chunk_mtile=np.append(
                np.arange(n_mtiles, dtype=np.int32), np.int32(-1)
            ),
            chunk_kwin=np.zeros(n_mtiles, np.int32),
            stats=stats, col_perm=col_perm, row_perm=row_perm,
        )

    rows = coo.rows.astype(np.int64)
    cols = coo.cols.astype(np.int64)
    L = config.edge_lanes

    mt = rows // tm
    kwin = cols // wk
    # CSR order within each (M-tile, K-window) job: the kernel accumulates a
    # row's run in registers and flushes on row change.
    order = np.lexsort((cols, rows, kwin, mt))
    mt_s, kw_s = mt[order], kwin[order]
    rl = (rows % tm)[order].astype(np.int64)
    cl = (cols % wk)[order].astype(np.int64)
    v_s = coo.vals[order].astype(np.float32)

    new_job = np.ones(nnz, dtype=bool)
    if nnz > 1:
        new_job[1:] = (mt_s[1:] != mt_s[:-1]) | (kw_s[1:] != kw_s[:-1])
    job_of_edge = np.cumsum(new_job) - 1
    n_jobs = int(job_of_edge[-1]) + 1

    # row runs (maximal same-row stretches within a job), padded to a
    # multiple of L (the JAX kernel's L independent accumulation registers
    # always hold partials of ONE row)
    new_run = new_job.copy()
    if nnz > 1:
        new_run[1:] |= rl[1:] != rl[:-1]
    run_of_edge = np.cumsum(new_run) - 1
    run_first = np.flatnonzero(new_run)
    n_runs = run_first.size
    run_len = np.diff(np.append(run_first, nnz))
    run_padlen = -(-run_len // L) * L
    run_row = rl[run_first]
    run_job = job_of_edge[run_first]

    pad_cum = np.concatenate([[0], np.cumsum(run_padlen)])
    # index of each job's first run in run numbering
    job_first_run_idx = run_of_edge[np.flatnonzero(new_job)]
    job_pad_base = pad_cum[job_first_run_idx]
    run_off_in_job = pad_cum[:n_runs] - job_pad_base[run_job]

    job_padlen = np.concatenate(
        [job_pad_base[1:], [pad_cum[-1]]]
    ) - job_pad_base
    job_chunks = -(-job_padlen // E)
    chunk_of_job = np.concatenate([[0], np.cumsum(job_chunks)])
    n_chunks = int(chunk_of_job[-1])

    idx_in_run = np.arange(nnz, dtype=np.int64) - run_first[run_of_edge]
    dst_in_job = run_off_in_job[run_of_edge] + idx_in_run
    dst = chunk_of_job[job_of_edge] * E + dst_in_job

    vals = np.zeros((n_chunks, 1, E), np.float32)
    # start every slot marked pad (bit 0); real edges overwrite it below
    meta = np.ones((n_chunks, 1, E), np.int32)
    flat_v = vals.reshape(-1)
    flat_m = meta.reshape(-1)

    # real edges: row_end iff final slot of a pad-free run
    real_end = (idx_in_run == (run_len - 1)[run_of_edge]) & (
        (run_padlen == run_len)[run_of_edge]
    )
    word = (
        (rl << ROW_SHIFT) | (cl << COL_SHIFT) | (real_end.astype(np.int64) << 1)
    ).astype(np.int32)
    flat_v[dst] = v_s
    flat_m[dst] = word

    # pad slots: value 0, col 0, the RUN's row (a chunk-end forced flush can
    # land on any in-run slot and must write the right row); the final pad
    # of each run carries row_end.
    pad_counts = run_padlen - run_len
    padded_runs = np.flatnonzero(pad_counts > 0)
    if padded_runs.size:
        reps = pad_counts[padded_runs]
        pr = np.repeat(padded_runs, reps)
        # offset of each pad slot within its run's padding
        off = np.arange(reps.sum(), dtype=np.int64) - np.repeat(
            np.concatenate([[0], np.cumsum(reps)[:-1]]), reps
        )
        pad_dst = (
            chunk_of_job[run_job[pr]] * E
            + run_off_in_job[pr]
            + run_len[pr]
            + off
        )
        is_final = off == np.repeat(reps - 1, reps)
        pad_word = (
            (run_row[pr] << ROW_SHIFT)
            | (is_final.astype(np.int64) << 1)
            | 1  # pad bit
        ).astype(np.int32)
        flat_m[pad_dst] = pad_word

    # chunk-end forced flush: a run straddling a chunk boundary must flush
    # its register partials before the chunk ends (slot E-1 always has
    # either the straddling run's row or an empty word whose zero-add to
    # row 0 is harmless)
    flat_m[E - 1 :: E] |= 2

    # M-tiles with no edges still need a beta*C epilogue chunk (all-padding)
    occupied = np.zeros(n_mtiles, dtype=bool)
    occupied[np.unique(mt_s).astype(np.int64)] = True
    missing = np.flatnonzero(~occupied).astype(np.int32)
    n_total = n_chunks + len(missing)

    chunk_mtile = np.full(n_total + 1, -1, np.int32)
    chunk_kwin = np.zeros(n_total, np.int32)
    job_first_edge = np.flatnonzero(new_job)
    jm = mt_s[job_first_edge].astype(np.int32)
    jk = kw_s[job_first_edge].astype(np.int32)
    chunk_mtile[:n_chunks] = np.repeat(jm, job_chunks)
    chunk_kwin[:n_chunks] = np.repeat(jk, job_chunks)
    chunk_mtile[n_chunks:n_total] = missing
    if len(missing):
        vals = np.concatenate(
            [vals, np.zeros((len(missing), 1, E), np.float32)]
        )
        meta = np.concatenate(
            [meta, np.full((len(missing), 1, E), PAD_BIT, np.int32)]
        )
        n_chunks = n_total

    stats = PackStats(
        nnz=nnz,
        blocks=nnz,
        slots=n_chunks * E,
        groups=n_chunks,
        pad_blocks=n_chunks * E - nnz,
        jobs=n_jobs,
        empty_mtiles=int((~occupied).sum()),
        a_bytes=8 * n_chunks * E,
    )
    return PackedSpMatrixEdge(
        m=m, k=k, nnz=nnz, config=config,
        n_mtiles=n_mtiles, n_kwins=n_kwins,
        vals=vals, meta=meta,
        chunk_mtile=chunk_mtile, chunk_kwin=chunk_kwin,
        stats=stats, col_perm=col_perm, row_perm=row_perm,
    )
