"""Pack pass: COO → tiled 8 x block_k block-sparse format.

The NumPy path of ``sextans_tpu.format.pack``, carried over unchanged so
that both packages see byte-identical packed arrays. Its design notes:

It replaces the reference's entire preprocessing
stack — window tiler + PE assigner (src/sparse_helper.h:345-403), the
out-of-order cycle scheduler (src/sparse_helper.h:292-342) and the 64-bit
edge encoder / channel interleaver (src/sparse_helper.h:406-473).

Design (see SURVEY.md §7): instead of scheduling single nonzeros into 64
scalar PEs with RAW-hazard bubbles, we pack A into dense **8 × block_k
micro-blocks** (8 = float32 sublane count), grouped by (M-tile, K-window):

* every block lies inside one C row-stripe (8 consecutive rows) and one
  B window, so the kernel's inner loop is a gather of ``block_k`` contiguous
  B rows + ``block_k`` broadcast-FMAs onto an (8, TILE_N) accumulator slice —
  full-width VPU work with zero scatter hazards;
* blocks are grouped into fixed-size *groups* of ``group_blocks`` blocks, all
  sharing the same (M-tile, K-window) pair — the unit a kernel walks (the
  analog of the FIFO-batched A stream, src/sextans.cpp:75-100);
* within a group, blocks are round-robin interleaved across row stripes so
  consecutive FMAs target different accumulator rows (pipeline-friendly;
  the OoO scheduler's spirit with none of its correctness burden);
* M-tiles with no nonzeros get one all-padding group so the kernel still
  writes their ``beta * C`` epilogue.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from sextans_tpu_torch.format.coo import COOMatrix
from sextans_tpu_torch.utils.config import SpmmConfig, cdiv
from sextans_tpu_torch.utils.profiling import timed

__all__ = ["PackedSpMatrix", "PackStats", "pack", "reorder_columns"]


@dataclass(frozen=True)
class PackStats:
    """Occupancy accounting — the analog of the reference scheduler's
    padding/bubble overhead (src/sparse_helper.h:390-400)."""

    nnz: int
    blocks: int  # real (non-padding) blocks
    slots: int  # blocks * 8 * block_k value slots
    groups: int  # total groups incl. padding-only groups
    pad_blocks: int  # padding block slots added by grouping
    jobs: int  # distinct (m_tile, k_window) pairs with nonzeros
    empty_mtiles: int
    # exact packed-A byte count (vals + steering) for formats whose layout
    # the generic formula below cannot describe (edge-stream format); when
    # None, bytes_per_nnz derives it from the block geometry.
    a_bytes: Optional[int] = None

    @property
    def block_fill(self) -> float:
        """Fraction of packed value slots that hold real nonzeros."""
        return self.nnz / self.slots if self.slots else 0.0

    @property
    def group_fill(self) -> float:
        """Fraction of group block slots that are real blocks."""
        total = self.blocks + self.pad_blocks
        return self.blocks / total if total else 0.0

    @property
    def bytes_per_nnz(self) -> float:
        """Packed A bytes (vals incl. group padding + steering) per nonzero —
        the HBM A-stream tax relative to the reference's 8 B/nnz edge stream
        (src/sparse_helper.h:406-473). CSR costs ~8 B/nnz."""
        if self.nnz == 0:
            return 0.0
        if self.a_bytes is not None:
            return self.a_bytes / self.nnz
        slot_bytes = 4 * (self.slots // max(self.blocks, 1))
        total = (self.blocks + self.pad_blocks) * (slot_bytes + 8)
        return total / self.nnz


@dataclass
class PackedSpMatrix:
    """Tiled 8×block_k block-sparse matrix, ready for the kernels.

    Array layout (all NumPy on host; ``SpmmPlan`` uploads them once):

    * ``vals``  (groups, 8, group_blocks*block_k) float32 — block values;
      sublane = row-within-stripe, lanes = block*block_k + col-within-block.
      This keeps the native (8, 128) float32 register tiling fully packed.
    * ``qrow``  (groups, group_blocks) int32 — row-stripe index within the
      M-tile (global rows = tile_m*m_tile + 8*qrow + 0..7).
    * ``bcol``  (groups, group_blocks) int32 — element column offset of the
      block within its K-window (global cols = window_k*k_win + bcol + 0..block_k-1).
    * ``group_mtile`` (groups+1,) int32 — M-tile of each group, sentinel -1;
      the plan scans it once, with ``qrow``, into per-stripe visit lists
      (``ops/spmm_block.py:stripe_visits``).
    * ``group_kwin``  (groups,) int32 — K-window of each group.
    """

    m: int
    k: int
    nnz: int
    config: SpmmConfig
    n_mtiles: int
    n_kwins: int
    vals: np.ndarray
    qrow: np.ndarray
    bcol: np.ndarray
    group_mtile: np.ndarray
    group_kwin: np.ndarray
    stats: PackStats
    # Optional column permutation (degree sort): A was packed with columns
    # reordered as A[:, col_perm]; executors must feed B[col_perm] to the
    # kernel. Improves block fill on skewed (power-law) matrices.
    col_perm: Optional[np.ndarray] = None
    # Optional row permutation (degree sort): A was packed as A[row_perm, :];
    # executors feed C[row_perm] in and scatter the output back. Together
    # with col_perm this is the 2-D degree reorder for power-law matrices.
    row_perm: Optional[np.ndarray] = None

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.m, self.k)

    @property
    def n_groups(self) -> int:
        return int(self.group_kwin.shape[0])

    @property
    def m_padded(self) -> int:
        return self.n_mtiles * self.config.tile_m

    @property
    def k_padded(self) -> int:
        return self.n_kwins * self.config.window_k

    def nbytes(self) -> int:
        return sum(
            a.nbytes
            for a in (self.vals, self.qrow, self.bcol, self.group_mtile, self.group_kwin)
        )

    # -- persistence (the reference's closest analog is bitstream reuse via
    #    TAPAB, README.md:46-48; here the expensive host step is packing) --
    def save(self, path) -> None:
        np.savez_compressed(
            Path(path),
            m=self.m,
            k=self.k,
            nnz=self.nnz,
            n_mtiles=self.n_mtiles,
            n_kwins=self.n_kwins,
            vals=self.vals,
            qrow=self.qrow,
            bcol=self.bcol,
            group_mtile=self.group_mtile,
            group_kwin=self.group_kwin,
            config=np.array(
                [
                    self.config.tile_m,
                    self.config.window_k,
                    self.config.block_k,
                    self.config.group_blocks,
                    int(self.config.interleave),
                    # full round-trip of the kernel knobs (-1 = tile_n None)
                    -1 if self.config.tile_n is None else self.config.tile_n,
                    self.config.n_acc,
                    self.config.chunk_unroll,
                    int(self.config.precise),
                ],
                dtype=np.int64,
            ),
            # a_bytes None is stored as 0 (None means "derive from geometry")
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
                else np.zeros(0, dtype=np.int32)
            ),
            row_perm=(
                self.row_perm
                if self.row_perm is not None
                else np.zeros(0, dtype=np.int32)
            ),
        )

    @staticmethod
    def load(path) -> "PackedSpMatrix":
        z = np.load(Path(path))
        cfg_arr = z["config"]
        extra = {}
        if cfg_arr.shape[0] > 5:  # formats saved since round 2
            extra = dict(
                tile_n=None if int(cfg_arr[5]) < 0 else int(cfg_arr[5]),
                n_acc=int(cfg_arr[6]),
                chunk_unroll=int(cfg_arr[7]),
            )
            if cfg_arr.shape[0] > 8:
                extra["precise"] = int(cfg_arr[8])
        cfg = SpmmConfig(
            tile_m=int(cfg_arr[0]),
            window_k=int(cfg_arr[1]),
            block_k=int(cfg_arr[2]),
            group_blocks=int(cfg_arr[3]),
            interleave=bool(cfg_arr[4]),
            **extra,
        )
        sf = [int(x) for x in z["stats"]]
        stats = PackStats(
            *sf[:7], a_bytes=(sf[7] or None) if len(sf) > 7 else None
        )
        return PackedSpMatrix(
            m=int(z["m"]),
            k=int(z["k"]),
            nnz=int(z["nnz"]),
            config=cfg,
            n_mtiles=int(z["n_mtiles"]),
            n_kwins=int(z["n_kwins"]),
            vals=z["vals"],
            qrow=z["qrow"],
            bcol=z["bcol"],
            group_mtile=z["group_mtile"],
            group_kwin=z["group_kwin"],
            stats=stats,
            col_perm=(
                z["col_perm"] if "col_perm" in z and z["col_perm"].size else None
            ),
            row_perm=(
                z["row_perm"] if "row_perm" in z and z["row_perm"].size else None
            ),
        )


def reorder_columns(coo: COOMatrix):
    """Degree-sort the columns of ``coo`` (descending). Returns
    ``(reordered_coo, col_perm)`` with ``reordered[:, j] == coo[:, col_perm[j]]``.
    Clusters the hub columns of power-law matrices into dense blocks; measured
    3x+ kernel speedup on webgraph-class inputs (with block_k=2, large tiles)."""
    k = coo.shape[1]
    deg = np.bincount(coo.cols, minlength=k)
    col_perm = np.argsort(-deg, kind="stable").astype(np.int32)
    rank = np.empty(k, dtype=np.int32)
    rank[col_perm] = np.arange(k, dtype=np.int32)
    return (
        COOMatrix(coo.shape, coo.rows, rank[coo.cols], coo.vals),
        col_perm,
    )


def reorder_rows(coo: COOMatrix):
    """Degree-sort the rows of ``coo`` (descending). Returns
    ``(reordered_coo, row_perm)`` with ``reordered[i, :] == coo[row_perm[i], :]``.

    Combined with :func:`reorder_columns` this is the 2-D degree reorder:
    hub rows x hub columns cluster into a dense top-left corner, so the
    power-law core that shatters blocked formats (near-empty 8xBK blocks
    scattered over the whole plane) concentrates into well-filled blocks.
    Executors gather C rows through ``row_perm`` on the way in and scatter
    them back on the way out (ops/plan.py), so results are unchanged."""
    m = coo.shape[0]
    deg = np.bincount(coo.rows, minlength=m)
    row_perm = np.argsort(-deg, kind="stable").astype(np.int32)
    rank = np.empty(m, dtype=np.int32)
    rank[row_perm] = np.arange(m, dtype=np.int32)
    return (
        COOMatrix(coo.shape, rank[coo.rows], coo.cols, coo.vals),
        row_perm,
    )


def _check_impl(impl: str) -> None:
    """Shared by :func:`pack` and ``pack_mxu``: only the NumPy packer exists."""
    if impl == "native":
        raise NotImplementedError(
            "the native C++ packer is not ported yet (ROADMAP.md, still to "
            "port); use impl='numpy'"
        )
    if impl not in ("auto", "numpy"):
        raise ValueError(f"unknown pack impl {impl!r}")


@timed("pack_s")
def pack(
    coo: COOMatrix,
    config: SpmmConfig = SpmmConfig(),
    impl: str = "auto",
    reorder_cols: bool = False,
    reorder_rows_: bool = False,
) -> PackedSpMatrix:
    """Pack a COO matrix into the tiled block format.

    ``impl``: "numpy" or "auto" (which means NumPy here). The JAX package's
    native C++ packer is not ported yet, so "native" raises
    ``NotImplementedError``. The arrays are byte-identical to
    ``sextans_tpu.format.pack.pack(..., impl="numpy")``.

    ``reorder_cols``: permute columns by descending degree before packing
    (clusters hub columns of power-law matrices into dense blocks). The
    permutation is recorded in ``col_perm``; executors apply ``B[col_perm]``
    on device, so results are unchanged.

    ``reorder_rows_``: same for rows (2-D degree reorder when combined);
    recorded in ``row_perm``, executors permute C at the plan boundary.
    """
    _check_impl(impl)
    config.validate_vpu()
    m, k = coo.shape
    col_perm = None
    row_perm = None
    if reorder_cols and coo.nnz > 0:
        coo, col_perm = reorder_columns(coo)
    if reorder_rows_ and coo.nnz > 0:
        coo, row_perm = reorder_rows(coo)
    tm, wk, bk, G = (
        config.tile_m,
        config.window_k,
        config.block_k,
        config.group_blocks,
    )
    tmq = tm // 8  # row stripes per M-tile
    n_mtiles = max(1, cdiv(m, tm))
    n_kwins = max(1, cdiv(k, wk))
    nnz = coo.nnz

    if nnz == 0:
        return _empty_pack(m, k, config, n_mtiles, n_kwins)

    rows = coo.rows.astype(np.int64)
    cols = coo.cols.astype(np.int64)
    vals = coo.vals

    mt = rows // tm
    kwin = cols // wk
    br = rows >> 3  # global 8-row stripe
    bcb = cols // bk  # global block column

    order = np.lexsort((bcb, br, kwin, mt))
    mt_s, kw_s, br_s, bcb_s = mt[order], kwin[order], br[order], bcb[order]
    r_s = (rows & 7)[order]
    j_s = (cols % bk)[order]
    v_s = vals[order]

    # --- identify unique blocks (consecutive after the sort) ---
    new_blk = np.ones(nnz, dtype=bool)
    if nnz > 1:
        new_blk[1:] = (
            (mt_s[1:] != mt_s[:-1])
            | (kw_s[1:] != kw_s[:-1])
            | (br_s[1:] != br_s[:-1])
            | (bcb_s[1:] != bcb_s[:-1])
        )
    blk_of_edge = np.cumsum(new_blk) - 1
    nb = int(blk_of_edge[-1]) + 1
    first = np.flatnonzero(new_blk)

    b_mt = mt_s[first]
    b_kw = kw_s[first]
    b_q = (br_s[first] - b_mt * tmq).astype(np.int32)
    b_c = ((bcb_s[first] * bk) % wk).astype(np.int32)

    # --- densify block values (duplicate coordinates sum, like CSR build) ---
    dense = np.zeros((nb, 8, bk), dtype=np.float32)
    np.add.at(dense, (blk_of_edge, r_s, j_s), v_s)

    # --- jobs = (m_tile, k_window) runs ---
    new_job = np.ones(nb, dtype=bool)
    if nb > 1:
        new_job[1:] = (b_mt[1:] != b_mt[:-1]) | (b_kw[1:] != b_kw[:-1])
    job_of_blk = np.cumsum(new_job) - 1
    njobs = int(job_of_blk[-1]) + 1
    job_first = np.flatnonzero(new_job)
    job_mt = b_mt[job_first].astype(np.int32)
    job_kw = b_kw[job_first].astype(np.int32)
    job_sizes = np.bincount(job_of_blk, minlength=njobs)

    # --- schedule blocks within each job ---
    if config.interleave:
        # Round-robin across row stripes: sort by (job, occurrence-rank within
        # (job, stripe), stripe). Blocks are currently sorted by (job, q, bcb),
        # so rank within (job, q) is positional.
        runkey_change = np.ones(nb, dtype=bool)
        if nb > 1:
            runkey_change[1:] = (job_of_blk[1:] != job_of_blk[:-1]) | (
                b_q[1:] != b_q[:-1]
            )
        run_id = np.cumsum(runkey_change) - 1
        run_first = np.flatnonzero(runkey_change)
        rank = np.arange(nb) - run_first[run_id]
        sched = np.lexsort((b_q, rank, job_of_blk))
    else:
        sched = np.arange(nb)

    # --- assign scheduled blocks to fixed-size groups, padding per job ---
    job_groups = -(-job_sizes // G)
    grp_offset = np.zeros(njobs + 1, dtype=np.int64)
    np.cumsum(job_groups, out=grp_offset[1:])
    ngroups_real = int(grp_offset[-1])

    sched_job = job_of_blk[sched]
    job_first_pos = np.zeros(njobs + 1, dtype=np.int64)
    np.cumsum(job_sizes, out=job_first_pos[1:])
    pos_in_job = np.arange(nb) - job_first_pos[sched_job]
    dst_group = (grp_offset[sched_job] + pos_in_job // G).astype(np.int64)
    dst_slot = (pos_in_job % G).astype(np.int64)

    # --- M-tiles with no blocks at all still need a beta*C epilogue group ---
    present = np.zeros(n_mtiles, dtype=bool)
    present[job_mt] = True
    missing = np.flatnonzero(~present).astype(np.int32)
    ngroups = ngroups_real + len(missing)

    grp_job = np.repeat(np.arange(njobs), job_groups)
    group_mtile = np.empty(ngroups + 1, dtype=np.int32)
    group_kwin = np.zeros(ngroups, dtype=np.int32)
    group_mtile[:ngroups_real] = job_mt[grp_job]
    group_kwin[:ngroups_real] = job_kw[grp_job]
    group_mtile[ngroups_real:ngroups] = missing
    group_mtile[ngroups] = -1  # sentinel for last-group detection

    vp = np.zeros((ngroups, 8, G * bk), dtype=np.float32)
    lane = (dst_slot[:, None] * bk + np.arange(bk)[None, :])[:, None, :]
    vp[dst_group[:, None, None], np.arange(8)[None, :, None], lane] = dense[sched]

    qrow = np.zeros((ngroups, G), dtype=np.int32)
    bcol = np.zeros((ngroups, G), dtype=np.int32)
    qrow[dst_group, dst_slot] = b_q[sched]
    bcol[dst_group, dst_slot] = b_c[sched]

    stats = PackStats(
        nnz=nnz,
        blocks=nb,
        slots=nb * 8 * bk,
        groups=ngroups,
        pad_blocks=ngroups * G - nb,
        jobs=njobs,
        empty_mtiles=len(missing),
    )
    return PackedSpMatrix(
        col_perm=col_perm,
        row_perm=row_perm,
        m=m,
        k=k,
        nnz=nnz,
        config=config,
        n_mtiles=n_mtiles,
        n_kwins=n_kwins,
        vals=vp,
        qrow=qrow,
        bcol=bcol,
        group_mtile=group_mtile,
        group_kwin=group_kwin,
        stats=stats,
    )


def _empty_pack(m, k, config, n_mtiles, n_kwins) -> PackedSpMatrix:
    G, bk = config.group_blocks, config.block_k
    ngroups = n_mtiles
    stats = PackStats(0, 0, 0, ngroups, ngroups * G, 0, n_mtiles)
    group_mtile = np.concatenate(
        [np.arange(n_mtiles, dtype=np.int32), np.array([-1], dtype=np.int32)]
    )
    return PackedSpMatrix(
        m=m,
        k=k,
        nnz=0,
        config=config,
        n_mtiles=n_mtiles,
        n_kwins=n_kwins,
        vals=np.zeros((ngroups, 8, G * bk), dtype=np.float32),
        qrow=np.zeros((ngroups, G), dtype=np.int32),
        bcol=np.zeros((ngroups, G), dtype=np.int32),
        group_mtile=group_mtile,
        group_kwin=np.zeros(ngroups, dtype=np.int32),
        stats=stats,
    )
