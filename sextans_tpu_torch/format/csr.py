"""CSR / CSC compressed sparse containers and conversions.

Host-side analog of the reference's counting-sort CSR/CSC construction in
``read_suitsparse_matrix`` (src/sparse_helper.h:216-258) and ``CSC_2_CSR``
(src/sparse_helper.h:475-509), vectorized with NumPy.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

from sextans_tpu_torch.format.coo import COOMatrix

__all__ = ["CSRMatrix", "CSCMatrix"]


def _compress(sorted_major: np.ndarray, n_major: int) -> np.ndarray:
    """Counting-sort style ptr array from sorted major indices."""
    counts = np.bincount(sorted_major, minlength=n_major)
    ptr = np.zeros(n_major + 1, dtype=np.int64)
    np.cumsum(counts, out=ptr[1:])
    return ptr


@dataclass
class CSRMatrix:
    shape: Tuple[int, int]
    indptr: np.ndarray  # int64 (M+1,)
    indices: np.ndarray  # int32 (nnz,) column indices, sorted within a row
    vals: np.ndarray  # float32 (nnz,)

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    @staticmethod
    def from_coo(coo: COOMatrix) -> "CSRMatrix":
        s = coo.sorted_by_row()
        indptr = _compress(s.rows, coo.shape[0])
        return CSRMatrix(coo.shape, indptr, s.cols, s.vals)

    def to_coo(self) -> COOMatrix:
        rows = np.repeat(
            np.arange(self.shape[0], dtype=np.int32), np.diff(self.indptr)
        )
        return COOMatrix(self.shape, rows, self.indices, self.vals)

    def to_csc(self) -> "CSCMatrix":
        """CSR → CSC, semantics of CSC_2_CSR transposed (src/sparse_helper.h:475)."""
        return CSCMatrix.from_coo(self.to_coo())

    def row_lengths(self) -> np.ndarray:
        return np.diff(self.indptr)


@dataclass
class CSCMatrix:
    shape: Tuple[int, int]
    indptr: np.ndarray  # int64 (K+1,)
    indices: np.ndarray  # int32 (nnz,) row indices, sorted within a column
    vals: np.ndarray  # float32 (nnz,)

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    @staticmethod
    def from_coo(coo: COOMatrix) -> "CSCMatrix":
        s = coo.sorted_by_col()
        indptr = _compress(s.cols, coo.shape[1])
        return CSCMatrix(coo.shape, indptr, s.rows, s.vals)

    def to_coo(self) -> COOMatrix:
        cols = np.repeat(
            np.arange(self.shape[1], dtype=np.int32), np.diff(self.indptr)
        )
        return COOMatrix(self.shape, self.indices, cols, self.vals)

    def to_csr(self) -> CSRMatrix:
        """CSC → CSR (reference: CSC_2_CSR, src/sparse_helper.h:475-509)."""
        return CSRMatrix.from_coo(self.to_coo())
