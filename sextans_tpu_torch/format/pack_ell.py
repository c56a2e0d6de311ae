"""ELL gather pack pass: COO → fixed-slots-per-row gather format.

The NumPy path of ``sextans_tpu.format.pack_ell``, carried over unchanged so
that both packages see byte-identical packed arrays. It feeds the ELL
gather engines (ops/spmm_ell.py), which phrase the product as R row-gathers
from B plus a slot-weighted reduction:

    C[i, :] = sum_r  vals[i, r] * B[cols[i, r], :]        r < R

The layout is the classic ELLPACK with hub-row splitting: rows with degree
> R spill into appended *virtual rows* that the engine folds back with one
small scatter-add, so a single power-law hub row cannot inflate the whole
matrix's slot count.

Layout (R = ``slots_per_row``, chosen at pack time):

* ``cols`` (m_padded, R) int32 — global B-row index per slot (0 for pads);
* ``vals`` (m_padded, R) f32  — edge value per slot (0.0 for pads);
* ``fold_rows`` (n_virt,) int32 — target real row of each virtual row;
  virtual rows occupy indices [m_base, m_base + n_virt).

Padding slots compute ``0 * B[0, :]`` in the plain engine — exactly 0.0 for
finite B (the same precondition as the other padded formats); the gather
kernel selects them out instead.

This trades the edge stream's 8 B/nnz for ``(8 * m_padded * R) / nnz``
B/nnz; the pack refuses (ValueError) when that inflation exceeds
``max_bytes_per_nnz``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from sextans_tpu_torch.format.coo import COOMatrix
from sextans_tpu_torch.format.pack import PackStats
from sextans_tpu_torch.utils.config import SpmmConfig, cdiv, round_up
from sextans_tpu_torch.utils.profiling import timed

__all__ = [
    "PackedSpMatrixELL",
    "pack_ell",
    "choose_slots_per_row",
    "ell_traffic_bytes",
    "ell_bytes_per_nnz",
    "check_ell_inflation",
]

# Refuse packs whose slot inflation exceeds this many packed bytes per
# nonzero (cols+vals = 8 B/slot; CSR/edge-stream is ~8 B/nnz).
DEFAULT_MAX_BYTES_PER_NNZ = 64.0


@dataclass
class PackedSpMatrixELL:
    """Fixed-slots-per-row gather matrix for the ELL engines."""

    m: int
    k: int
    nnz: int
    config: SpmmConfig
    slots_per_row: int
    m_base: int  # real rows (m) — virtual hub rows start here
    cols: np.ndarray  # (m_padded, R) i32
    vals: np.ndarray  # (m_padded, R) f32
    fold_rows: np.ndarray  # (n_virt,) i32 — real row per virtual row
    stats: PackStats
    col_perm: Optional[np.ndarray] = None
    row_perm: Optional[np.ndarray] = None

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.m, self.k)

    @property
    def n_virt(self) -> int:
        return int(self.fold_rows.shape[0])

    @property
    def m_padded(self) -> int:
        return int(self.cols.shape[0])

    @property
    def k_padded(self) -> int:
        return self.k  # whole-B gather: no K windowing

    def save(self, path) -> None:
        np.savez_compressed(
            path,
            fmt=np.array(["ell"]),
            shape=np.array(
                [self.m, self.k, self.nnz, self.slots_per_row, self.m_base],
                dtype=np.int64,
            ),
            cfg=np.array(
                [
                    self.config.tile_m,
                    -1 if self.config.tile_n is None else self.config.tile_n,
                ],
                dtype=np.int64,
            ),
            cols=self.cols,
            vals=self.vals,
            fold_rows=self.fold_rows,
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
    def load(cls, path) -> "PackedSpMatrixELL":
        z = np.load(path)
        if "fmt" not in z or str(z["fmt"][0]) != "ell":
            raise ValueError(f"{path} is not an ELL-format pack file")
        m, k, nnz, r, m_base = (int(x) for x in z["shape"])
        cf = [int(x) for x in z["cfg"]]
        cfg = SpmmConfig(
            tile_m=cf[0], tile_n=None if cf[1] < 0 else cf[1], ell_r=r
        )
        s = [int(x) for x in z["stats"]]
        stats = PackStats(
            nnz=s[0], blocks=s[1], slots=s[2], groups=s[3],
            pad_blocks=s[4], jobs=s[5], empty_mtiles=s[6],
            a_bytes=s[7] or None,
        )
        cp = z["col_perm"]
        rp = z["row_perm"]
        return cls(
            m=m, k=k, nnz=nnz, config=cfg, slots_per_row=r, m_base=m_base,
            cols=z["cols"], vals=z["vals"], fold_rows=z["fold_rows"],
            stats=stats,
            col_perm=cp if cp.size else None,
            row_perm=rp if rp.size else None,
        )


# Modeled minimum HBM transaction per gathered B row: a row fetch costs
# max(4*n, ELL_MIN_FETCH) bytes regardless of how narrow N is.
ELL_MIN_FETCH = 256


def ell_traffic_bytes(deg: np.ndarray, r: int, n: int) -> float:
    """Modeled HBM bytes of one engine call at ``slots_per_row=r``:
    every slot (real or pad) gathers one B row; every virtual hub row adds
    an output row plus fold traffic."""
    chunks = np.maximum(-(-deg // r), (deg > 0).astype(np.int64))
    slots = int(np.maximum(chunks, 1).sum()) * r  # zero-deg rows occupy r pads
    virt = int(np.maximum(chunks - 1, 0).sum())
    m = deg.shape[0]
    row_bytes = max(4 * n, ELL_MIN_FETCH)
    return (
        slots * (row_bytes + 8.0)  # B-row gather + cols/vals stream
        + (m + virt) * n * 4.0  # AB write
        + virt * n * 4.0 * 3.0  # fold: read virt + read/write targets
    )


def choose_slots_per_row(coo: COOMatrix, n: int = 512) -> int:
    """Cost-based slot count: minimize modeled gather traffic over the
    degree histogram. Small R keeps pad slots cheap but splits hub rows
    into virtual rows (fold overhead); large R pads every thin row."""
    if coo.nnz == 0:
        return 1
    deg = np.bincount(coo.rows, minlength=coo.shape[0]).astype(np.int64)
    cands = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32)
    best_r, best_cost = 1, float("inf")
    for r in cands:
        c = ell_traffic_bytes(deg, r, n)
        if c < best_cost:
            best_r, best_cost = r, c
    return best_r


def ell_bytes_per_nnz(
    deg: np.ndarray, r: int, nnz: int, pad_rows: int = 0
) -> float:
    """Packed bytes per nonzero of the ELL grid over a degree histogram
    (cols+vals = 8 B/slot; virtual hub rows counted, ``pad_rows`` is extra
    tile_m-rounding slack)."""
    chunks = np.maximum(cdiv_arr(deg, r), (deg > 0).astype(np.int64))
    n_virt = int(np.maximum(chunks - 1, 0).sum())
    return 8.0 * (deg.shape[0] + n_virt + pad_rows) * r / max(nnz, 1)


def check_ell_inflation(
    deg: np.ndarray,
    r: int,
    nnz: int,
    pad_rows: int = 0,
    max_bytes_per_nnz: float = DEFAULT_MAX_BYTES_PER_NNZ,
) -> None:
    """Raise the pack_ell inflation ValueError from a degree histogram
    (same absolute 1 MiB floor: tiny grids are always packable)."""
    bpn = ell_bytes_per_nnz(deg, r, nnz, pad_rows)
    total = bpn * max(nnz, 1)
    if bpn > max_bytes_per_nnz and total > (1 << 20):
        raise ValueError(
            f"ELL pack inflation {bpn:.1f} B/nnz exceeds "
            f"{max_bytes_per_nnz:.1f} (rows+virt+pad="
            f"{int(total / (8 * r))}, R={r}, nnz={nnz}); "
            f"this matrix wants the edge or block formats"
        )


@timed("pack_s")
def pack_ell(
    coo: COOMatrix,
    config: SpmmConfig = SpmmConfig(),
    slots_per_row: Optional[int] = None,
    max_bytes_per_nnz: float = DEFAULT_MAX_BYTES_PER_NNZ,
) -> PackedSpMatrixELL:
    """COO → ELL gather format with hub-row splitting.

    ``config.tile_m`` rounds ``m_padded`` up to a multiple of it. Slot
    count: explicit ``slots_per_row`` arg > ``config.ell_r`` > cost-based
    :func:`choose_slots_per_row`. The arrays are byte-identical to
    ``sextans_tpu.format.pack_ell.pack_ell``.
    """
    m, k = coo.shape
    nnz = coo.nnz
    r = slots_per_row or config.ell_r or choose_slots_per_row(coo)

    if nnz == 0:
        m_padded = round_up(max(m, 1), config.tile_m)
        stats = PackStats(nnz=0, blocks=0, slots=m_padded * r, groups=0,
                          pad_blocks=0, jobs=0, empty_mtiles=0,
                          a_bytes=8 * m_padded * r)
        return PackedSpMatrixELL(
            m=m, k=k, nnz=0, config=config, slots_per_row=r, m_base=m,
            cols=np.zeros((m_padded, r), np.int32),
            vals=np.zeros((m_padded, r), np.float32),
            fold_rows=np.empty(0, np.int32), stats=stats,
        )

    # CSR sort, then slot position within the row
    order = np.lexsort((coo.cols, coo.rows))
    rows = coo.rows[order].astype(np.int64)
    cols = coo.cols[order].astype(np.int64)
    vals = coo.vals[order].astype(np.float32)
    deg = np.bincount(rows, minlength=m)
    row_start = np.concatenate(([0], np.cumsum(deg)))
    pos = np.arange(nnz, dtype=np.int64) - row_start[rows]

    # hub-row splitting: slot chunk c = pos // r of row i becomes virtual
    # row (m_base + virt_index) for c >= 1
    chunk = pos // r
    n_chunks_per_row = np.maximum(cdiv_arr(deg, r), (deg > 0).astype(np.int64))
    extra = np.maximum(n_chunks_per_row - 1, 0)
    n_virt = int(extra.sum())
    virt_base = np.concatenate(([0], np.cumsum(extra)))  # per-row virt offset

    ell_rows = np.where(chunk == 0, rows, m + virt_base[rows] + (chunk - 1))
    ell_pos = pos - chunk * r

    m_total = m + n_virt
    m_padded = round_up(max(m_total, 1), config.tile_m)
    bytes_per_nnz = 8.0 * m_padded * r / nnz
    # absolute floor: tiny matrices are always packable (the ratio test is
    # meaningless when the whole grid is under a megabyte)
    if bytes_per_nnz > max_bytes_per_nnz and 8 * m_padded * r > (1 << 20):
        raise ValueError(
            f"ELL pack inflation {bytes_per_nnz:.1f} B/nnz exceeds "
            f"{max_bytes_per_nnz:.1f} (m_padded={m_padded}, R={r}, "
            f"nnz={nnz}); this matrix wants the edge or block formats"
        )

    ell_cols = np.zeros((m_padded, r), np.int32)
    ell_vals = np.zeros((m_padded, r), np.float32)
    ell_cols[ell_rows, ell_pos] = cols.astype(np.int32)
    ell_vals[ell_rows, ell_pos] = vals

    # fold table: virtual row j (row-major over rows with extra chunks,
    # chunk-major within a row) folds into its real row
    hub = np.nonzero(extra)[0]
    fold_rows = np.repeat(hub, extra[hub]).astype(np.int32)

    jobs = cdiv(m_padded, config.tile_m)
    stats = PackStats(
        nnz=nnz,
        blocks=m_total,  # one "block" per (real+virtual) row
        slots=m_padded * r,
        groups=jobs,
        pad_blocks=m_padded - m_total,
        jobs=jobs,
        empty_mtiles=0,
        a_bytes=8 * m_padded * r,
    )
    return PackedSpMatrixELL(
        m=m, k=k, nnz=nnz, config=config, slots_per_row=r, m_base=m,
        cols=ell_cols, vals=ell_vals, fold_rows=fold_rows, stats=stats,
    )


def cdiv_arr(a: np.ndarray, b: int) -> np.ndarray:
    return -(-a // b)
