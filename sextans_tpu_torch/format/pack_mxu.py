"""Slab pack pass: COO → (block_k × 128) dense-slab block format.

The NumPy path of ``sextans_tpu.format.pack_mxu``, carried over unchanged so
that both packages see byte-identical packed arrays. Where the block format
(format/pack.py) uses 8-row × block_k blocks, this one uses **block_k × 128**
slabs of A stored transposed (k in rows, m in the 128 columns), so each block
is one small dense product ``(bk, 128)ᵀ · (bk, n) → (128, n)`` against a B
window slab, added into a whole 128-row accumulator slab selected by one
index. It trades padding (lower fill on 128-wide slabs) for dense inner
work. The JAX package feeds it to the TPU's matrix unit (hence "MXU" in the
names kept here); the CUDA kernels are ops/spmm_slab.py.

Array layout:

* ``vals``  (groups, group_blocks*block_k, 128) f32 — block b of a group
  occupies rows [b*bk, (b+1)*bk); ``vals[g, b*bk+kk, mm]`` is
  A[tile_m*mt + 128*qm + mm, window_k*kw + bcol + kk].
* ``qm``    (groups, group_blocks) i32 — 128-row slab index within the M-tile.
* ``bcol``  (groups, group_blocks) i32 — k offset of the block within its
  K-window (multiple of block_k).
* ``group_mtile`` (groups+1,) i32 / ``group_kwin`` (groups,) i32 — same
  steering as the block format.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from sextans_tpu_torch.format.coo import COOMatrix
from sextans_tpu_torch.format.pack import PackStats, _check_impl
from sextans_tpu_torch.utils.config import SpmmConfig, cdiv

__all__ = ["PackedSpMatrixMXU", "pack_mxu"]

MSLAB = 128  # block m-width (the TPU's lane count in the JAX package)


@dataclass
class PackedSpMatrixMXU:
    """Dense-slab block-sparse matrix for the slab kernels."""

    m: int
    k: int
    nnz: int
    config: SpmmConfig
    n_mtiles: int
    n_kwins: int
    vals: np.ndarray  # (groups, G*bk, 128) f32
    qm: np.ndarray  # (groups, G) i32
    bcol: np.ndarray  # (groups, G) i32
    group_mtile: np.ndarray  # (groups+1,) i32, sentinel -1
    group_kwin: np.ndarray  # (groups,) i32
    stats: PackStats
    col_perm: Optional[np.ndarray] = None
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
            for a in (self.vals, self.qm, self.bcol, self.group_mtile, self.group_kwin)
        )

    # -- persistence (the TAPAB bitstream-reuse analog, README.md:46-48) --
    def save(self, path) -> None:
        np.savez_compressed(
            Path(path),
            fmt=np.array([1], dtype=np.int64),  # 1 = MXU dense-slab format
            m=self.m,
            k=self.k,
            nnz=self.nnz,
            n_mtiles=self.n_mtiles,
            n_kwins=self.n_kwins,
            vals=self.vals,
            qm=self.qm,
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
                    -1 if self.config.tile_n is None else self.config.tile_n,
                    self.config.n_acc,
                    self.config.chunk_unroll,
                    int(self.config.precise),
                ],
                dtype=np.int64,
            ),
            stats=np.array(
                [
                    self.stats.nnz, self.stats.blocks, self.stats.slots,
                    self.stats.groups, self.stats.pad_blocks, self.stats.jobs,
                    self.stats.empty_mtiles,
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
    def load(path) -> "PackedSpMatrixMXU":
        z = np.load(Path(path))
        if "fmt" not in z or int(z["fmt"][0]) != 1:
            raise ValueError(
                f"{path} is not an MXU-format packed matrix "
                "(use PackedSpMatrix.load for the VPU block format)"
            )
        cfg_arr = z["config"]
        cfg = SpmmConfig(
            tile_m=int(cfg_arr[0]),
            window_k=int(cfg_arr[1]),
            block_k=int(cfg_arr[2]),
            group_blocks=int(cfg_arr[3]),
            interleave=bool(cfg_arr[4]),
            tile_n=None if int(cfg_arr[5]) < 0 else int(cfg_arr[5]),
            n_acc=int(cfg_arr[6]),
            chunk_unroll=int(cfg_arr[7]),
            precise=int(cfg_arr[8]),
        )
        sf = [int(x) for x in z["stats"]]
        stats = PackStats(
            *sf[:7], a_bytes=(sf[7] or None) if len(sf) > 7 else None
        )
        return PackedSpMatrixMXU(
            m=int(z["m"]),
            k=int(z["k"]),
            nnz=int(z["nnz"]),
            config=cfg,
            n_mtiles=int(z["n_mtiles"]),
            n_kwins=int(z["n_kwins"]),
            vals=z["vals"],
            qm=z["qm"],
            bcol=z["bcol"],
            group_mtile=z["group_mtile"],
            group_kwin=z["group_kwin"],
            stats=stats,
            col_perm=(
                z["col_perm"] if z["col_perm"].size else None
            ),
            row_perm=(
                z["row_perm"]
                if "row_perm" in z and z["row_perm"].size
                else None
            ),
        )


def pack_mxu(
    coo: COOMatrix,
    config: SpmmConfig,
    reorder_cols: bool = False,
    impl: str = "auto",
    reorder_rows_: bool = False,
) -> PackedSpMatrixMXU:
    """Pack a COO matrix into the MXU dense-slab format.

    Requires ``config.tile_m % 128 == 0`` and ``block_k % 8 == 0``, as the
    JAX package does.

    ``impl``: as in :func:`~sextans_tpu_torch.format.pack.pack` — NumPy
    only; "native" raises ``NotImplementedError``. The arrays are
    byte-identical to ``sextans_tpu.format.pack_mxu.pack_mxu(...,
    impl="numpy")``.
    """
    _check_impl(impl)
    tm, wk, bk, G = (
        config.tile_m,
        config.window_k,
        config.block_k,
        config.group_blocks,
    )
    if tm % MSLAB != 0:
        raise ValueError(f"MXU format needs tile_m % {MSLAB} == 0, got {tm}")
    if bk % 8 != 0:
        raise ValueError(f"MXU format needs block_k % 8 == 0, got {bk}")
    if wk % bk != 0:
        raise ValueError("window_k must be a multiple of block_k")

    col_perm = None
    row_perm = None
    if reorder_cols and coo.nnz > 0:
        from sextans_tpu_torch.format.pack import reorder_columns

        coo, col_perm = reorder_columns(coo)
    if reorder_rows_ and coo.nnz > 0:
        from sextans_tpu_torch.format.pack import reorder_rows

        coo, row_perm = reorder_rows(coo)

    m, k = coo.shape
    n_mtiles = max(1, cdiv(m, tm))
    n_kwins = max(1, cdiv(k, wk))
    nnz = coo.nnz

    if nnz == 0:
        return _empty(m, k, config, n_mtiles, n_kwins)


    rows = coo.rows.astype(np.int64)
    cols = coo.cols.astype(np.int64)

    mt = rows // tm
    kwin = cols // wk
    mslab = rows // MSLAB  # global 128-row slab
    bcb = cols // bk  # global block column

    order = np.lexsort((bcb, mslab, kwin, mt))
    mt_s, kw_s, ms_s, bcb_s = mt[order], kwin[order], mslab[order], bcb[order]
    mm_s = (rows % MSLAB)[order]
    kk_s = (cols % bk)[order]
    v_s = coo.vals[order]

    new_blk = np.ones(nnz, dtype=bool)
    if nnz > 1:
        new_blk[1:] = (
            (mt_s[1:] != mt_s[:-1])
            | (kw_s[1:] != kw_s[:-1])
            | (ms_s[1:] != ms_s[:-1])
            | (bcb_s[1:] != bcb_s[:-1])
        )
    blk_of_edge = np.cumsum(new_blk) - 1
    nb = int(blk_of_edge[-1]) + 1
    first = np.flatnonzero(new_blk)

    b_mt = mt_s[first]
    b_kw = kw_s[first]
    b_qm = (ms_s[first] - b_mt * (tm // MSLAB)).astype(np.int32)
    b_c = ((bcb_s[first] * bk) % wk).astype(np.int32)

    # jobs = (m_tile, k_window) runs
    new_job = np.ones(nb, dtype=bool)
    if nb > 1:
        new_job[1:] = (b_mt[1:] != b_mt[:-1]) | (b_kw[1:] != b_kw[:-1])
    job_of_blk = np.cumsum(new_job) - 1
    njobs = int(job_of_blk[-1]) + 1
    job_first = np.flatnonzero(new_job)
    job_mt = b_mt[job_first].astype(np.int32)
    job_kw = b_kw[job_first].astype(np.int32)
    job_sizes = np.bincount(job_of_blk, minlength=njobs)

    # fixed-size groups, padded per job (blocks stay in (qm, bcol) order —
    # consecutive MXU ops already alternate accumulator slabs enough; no
    # interleave pass needed)
    job_groups = -(-job_sizes // G)
    grp_offset = np.zeros(njobs + 1, dtype=np.int64)
    np.cumsum(job_groups, out=grp_offset[1:])
    ngroups_real = int(grp_offset[-1])

    job_first_pos = np.zeros(njobs + 1, dtype=np.int64)
    np.cumsum(job_sizes, out=job_first_pos[1:])
    pos_in_job = np.arange(nb) - job_first_pos[job_of_blk]
    dst_group = (grp_offset[job_of_blk] + pos_in_job // G).astype(np.int64)
    dst_slot = (pos_in_job % G).astype(np.int64)

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
    group_mtile[ngroups] = -1

    # scatter edge values straight into the packed buffer (no dense
    # per-block intermediate: at bk=128 that array would be as large as the
    # output, doubling peak host memory on ldoor-class matrices)
    vp = np.zeros((ngroups, G * bk, MSLAB), dtype=np.float32)
    e_grp = dst_group[blk_of_edge]
    e_sub = dst_slot[blk_of_edge] * bk + kk_s
    np.add.at(vp, (e_grp, e_sub, mm_s), v_s)

    qm = np.zeros((ngroups, G), dtype=np.int32)
    bcol = np.zeros((ngroups, G), dtype=np.int32)
    qm[dst_group, dst_slot] = b_qm
    bcol[dst_group, dst_slot] = b_c

    stats = PackStats(
        nnz=nnz,
        blocks=nb,
        slots=nb * bk * MSLAB,
        groups=ngroups,
        pad_blocks=ngroups * G - nb,
        jobs=njobs,
        empty_mtiles=len(missing),
    )
    return PackedSpMatrixMXU(
        m=m,
        k=k,
        nnz=nnz,
        config=config,
        n_mtiles=n_mtiles,
        n_kwins=n_kwins,
        vals=vp,
        qm=qm,
        bcol=bcol,
        group_mtile=group_mtile,
        group_kwin=group_kwin,
        stats=stats,
        col_perm=col_perm,
        row_perm=row_perm,
    )


def _empty(m, k, config, n_mtiles, n_kwins) -> PackedSpMatrixMXU:
    G, bk = config.group_blocks, config.block_k
    ngroups = n_mtiles
    stats = PackStats(0, 0, 0, ngroups, ngroups * G, 0, n_mtiles)
    group_mtile = np.concatenate(
        [np.arange(n_mtiles, dtype=np.int32), np.array([-1], dtype=np.int32)]
    )
    return PackedSpMatrixMXU(
        m=m,
        k=k,
        nnz=0,
        config=config,
        n_mtiles=n_mtiles,
        n_kwins=n_kwins,
        vals=np.zeros((ngroups, G * bk, MSLAB), dtype=np.float32),
        qm=np.zeros((ngroups, G), dtype=np.int32),
        bcol=np.zeros((ngroups, G), dtype=np.int32),
        group_mtile=group_mtile,
        group_kwin=np.zeros(ngroups, dtype=np.int32),
        stats=stats,
    )
