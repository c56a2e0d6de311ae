"""Golden CPU SpMM oracle: C = alpha * A @ B + beta * C.

NumPy re-derivation of the reference's correctness oracle ``cpu_spmm_CSR``
(src/sparse_helper.h:262-290): row-wise CSR accumulation in float32 with a
per-row partial-sum buffer, applied to column-major dense B/C semantics.

Two variants are provided:

* :func:`golden_spmm` — vectorized float32 NumPy, the everyday oracle;
* :func:`golden_spmm_exact` — float64 accumulation, used as the "truth"
  against which both the golden float32 model and the device kernels are judged
  for the 1e-6 max-abs-error north star (BASELINE.md).
"""

from __future__ import annotations

import numpy as np

from sextans_tpu_torch.format.csr import CSRMatrix

__all__ = ["golden_spmm", "golden_spmm_exact", "spmm_flops"]


def golden_spmm(
    a: CSRMatrix,
    b: np.ndarray,
    alpha: float = 1.0,
    beta: float = 0.0,
    c: np.ndarray | None = None,
) -> np.ndarray:
    """float32 row-wise CSR SpMM, mirroring cpu_spmm_CSR's loop order."""
    m, k = a.shape
    if b.shape[0] != k:
        raise ValueError(f"B has {b.shape[0]} rows, expected {k}")
    n = b.shape[1]
    b = np.asarray(b, dtype=np.float32)
    try:
        # scipy CSR matvec is a C row-wise loop — same float32 left-to-right
        # association as the reference triple loop, ~50x faster than the
        # NumPy fallback at benchmark scale.
        import scipy.sparse as sp

        mat = sp.csr_matrix(
            (a.vals, a.indices, a.indptr.astype(np.int64)), shape=a.shape
        )
        out = np.asarray(mat @ b, dtype=np.float32)
    except ImportError:
        out = np.zeros((m, n), dtype=np.float32)
        # Vectorized per-row psum: contributions gathered then segment-added
        # in CSR order (left-to-right association of the reference loop).
        lengths = np.diff(a.indptr)
        contrib = a.vals[:, None].astype(np.float32) * b[a.indices]
        row_ids = np.repeat(np.arange(m), lengths)
        np.add.at(out, row_ids, contrib)
    if c is None:
        if beta != 0.0:
            raise ValueError("beta != 0 requires an input C")
        return np.float32(alpha) * out
    c = np.asarray(c, dtype=np.float32)
    if c.shape != (m, n):
        raise ValueError(f"C has shape {c.shape}, expected {(m, n)}")
    return np.float32(alpha) * out + np.float32(beta) * c


def golden_spmm_exact(
    a: CSRMatrix,
    b: np.ndarray,
    alpha: float = 1.0,
    beta: float = 0.0,
    c: np.ndarray | None = None,
) -> np.ndarray:
    """float64-accumulated oracle for tight error bounds.

    scipy's CSR matmul runs the same row-wise left-to-right loop as the
    reference triple loop, in f64, with O(M*N) memory; the NumPy fallback
    chunks rows so the nnz-by-N contribution buffer stays bounded (a full
    materialization is ~190 GB for ldoor-class matrices at N=512).

    alpha/beta are rounded through float32 BEFORE widening: every kernel
    (and the reference host, src/sextans-host.cpp:29-30) consumes f32
    scalars, so an oracle scaling by the f64 literal (0.85 vs
    f32(0.85) = 0.85000002384...) would measure a 2.4e-8-relative
    phantom error (~0.2 ulp of max|C|) that no f32 kernel can close —
    found while banking the 1e-6 gate in round 5 (docs/ACCURACY.md).
    """
    alpha = float(np.float32(alpha))
    beta = float(np.float32(beta))
    m, k = a.shape
    n = b.shape[1]
    b64 = np.asarray(b, dtype=np.float64)
    try:
        import scipy.sparse as sp

        mat = sp.csr_matrix(
            (a.vals.astype(np.float64), a.indices, a.indptr.astype(np.int64)),
            shape=a.shape,
        )
        out = np.asarray(mat @ b64, dtype=np.float64)
    except ImportError:
        out = np.zeros((m, n), dtype=np.float64)
        vals64 = a.vals.astype(np.float64)
        lengths = np.diff(a.indptr)
        # row-chunked segment add: cap the contribution buffer at ~256 MB
        chunk_nnz = max(1, (32 << 20) // max(n, 1))
        row_chunk = max(1, int(chunk_nnz // max(lengths.mean(), 1.0)))
        for r0 in range(0, m, row_chunk):
            r1 = min(m, r0 + row_chunk)
            lo, hi = a.indptr[r0], a.indptr[r1]
            contrib = vals64[lo:hi, None] * b64[a.indices[lo:hi]]
            row_ids = np.repeat(np.arange(r0, r1), lengths[r0:r1])
            np.add.at(out, row_ids, contrib)
    out *= float(alpha)
    if c is not None:
        out += float(beta) * np.asarray(c, dtype=np.float64)
    return out


def spmm_flops(nnz: int, m: int, n: int) -> int:
    """Reference throughput formula: 2*N*(nnz+M) FLOPs (src/sextans-host.cpp:255-259).

    ``2*nnz*N`` multiply-adds for A@B plus ``2*M*N`` for the alpha/beta epilogue.
    """
    return 2 * n * (nnz + m)
