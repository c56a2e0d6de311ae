"""COO sparse matrix container + deterministic sorters.

Host-side (NumPy) analog of the reference's ``rcv`` triple arrays and
``sort_by_fn``/``cmp_by_row_column``/``cmp_by_column_row``
(reference: src/sparse_helper.h:14-87), vectorized with ``np.lexsort``
instead of a per-element ``qsort``. The same container as
``sextans_tpu.format.coo`` without its JAX interop (``from_bcoo``/``to_bcoo``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

__all__ = ["COOMatrix"]


@dataclass
class COOMatrix:
    """Coordinate-format sparse matrix (host memory, NumPy arrays)."""

    shape: Tuple[int, int]
    rows: np.ndarray  # int32 (nnz,)
    cols: np.ndarray  # int32 (nnz,)
    vals: np.ndarray  # float32 (nnz,)

    def __post_init__(self):
        self.rows = np.ascontiguousarray(self.rows, dtype=np.int32)
        self.cols = np.ascontiguousarray(self.cols, dtype=np.int32)
        self.vals = np.ascontiguousarray(self.vals, dtype=np.float32)
        if not (self.rows.shape == self.cols.shape == self.vals.shape):
            raise ValueError("rows/cols/vals must have identical shapes")
        if self.rows.ndim != 1:
            raise ValueError("COO arrays must be 1-D")
        if self.nnz:
            if self.rows.min(initial=0) < 0 or self.cols.min(initial=0) < 0:
                raise ValueError("negative indices in COO matrix")
            if self.rows.max(initial=-1) >= self.shape[0]:
                raise ValueError("row index out of range")
            if self.cols.max(initial=-1) >= self.shape[1]:
                raise ValueError("col index out of range")

    @property
    def nnz(self) -> int:
        return int(self.rows.shape[0])

    def sorted_by_row(self) -> "COOMatrix":
        """Stable (row, col) sort — the CSR ordering (src/sparse_helper.h:37-48)."""
        order = np.lexsort((self.cols, self.rows))
        return COOMatrix(self.shape, self.rows[order], self.cols[order], self.vals[order])

    def sorted_by_col(self) -> "COOMatrix":
        """Stable (col, row) sort — the CSC ordering (src/sparse_helper.h:50-62)."""
        order = np.lexsort((self.rows, self.cols))
        return COOMatrix(self.shape, self.rows[order], self.cols[order], self.vals[order])

    def to_csr(self):
        from sextans_tpu_torch.format.csr import CSRMatrix

        return CSRMatrix.from_coo(self)

    def to_csc(self):
        from sextans_tpu_torch.format.csr import CSCMatrix

        return CSCMatrix.from_coo(self)

    def to_dense(self) -> np.ndarray:
        dense = np.zeros(self.shape, dtype=np.float64)
        np.add.at(dense, (self.rows, self.cols), self.vals.astype(np.float64))
        return dense.astype(np.float32)

    def transpose(self) -> "COOMatrix":
        return COOMatrix((self.shape[1], self.shape[0]), self.cols, self.rows, self.vals)

    @staticmethod
    def from_dense(dense: np.ndarray) -> "COOMatrix":
        """Dense (M, K) array -> COO, dropping exact zeros (the loader's
        bitwise-zero rule: -0.0 entries are kept, src/sparse_helper.h:145)."""
        dense = np.asarray(dense)
        if dense.ndim != 2:
            raise ValueError(f"dense matrix must be 2-D, got shape {dense.shape}")
        vals32 = dense.astype(np.float32)
        keep = vals32.view(np.uint32) != 0
        rows, cols = np.nonzero(keep)
        return COOMatrix(
            dense.shape,
            rows.astype(np.int32),
            cols.astype(np.int32),
            vals32[rows, cols],
        )

    @staticmethod
    def from_scipy(mat) -> "COOMatrix":
        """Any ``scipy.sparse`` matrix/array -> COO (duplicates summed, the
        scipy convention)."""
        coo = mat.tocoo()
        coo.sum_duplicates()
        return COOMatrix(
            coo.shape,
            coo.row.astype(np.int32),
            coo.col.astype(np.int32),
            coo.data.astype(np.float32),
        )

    def to_scipy(self):
        """COO -> ``scipy.sparse.coo_matrix`` (float32)."""
        import scipy.sparse as sp

        return sp.coo_matrix((self.vals, (self.rows, self.cols)), shape=self.shape)

    @staticmethod
    def random(
        m: int,
        k: int,
        nnz: int,
        *,
        seed: int = 0,
        banded: bool = False,
        bandwidth: int = 64,
    ) -> "COOMatrix":
        """Synthesize a random test matrix (unique coordinates, nonzero values)."""
        rng = np.random.default_rng(seed)
        if banded:
            rows = rng.integers(0, m, size=2 * nnz)
            offs = rng.integers(-bandwidth, bandwidth + 1, size=2 * nnz)
            cols = np.clip(rows + offs, 0, k - 1)
        else:
            rows = rng.integers(0, m, size=2 * nnz)
            cols = rng.integers(0, k, size=2 * nnz)
        lin = rows.astype(np.int64) * k + cols
        _, first = np.unique(lin, return_index=True)
        first = first[:nnz]
        rows, cols = rows[first], cols[first]
        vals = rng.standard_normal(len(rows)).astype(np.float32)
        vals[vals == 0] = 1.0
        return COOMatrix((m, k), rows.astype(np.int32), cols.astype(np.int32), vals)
