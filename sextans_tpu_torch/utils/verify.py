"""Verification gate + throughput metrics.

Re-implements the reference host's acceptance criterion
(src/sextans-host.cpp:262-290): per-element relative difference with a 1e-4
denominator floor, tolerance 1e-4, PASS iff fewer than 2% of the M*N elements
mismatch — plus the stricter max-abs-error gate from the BASELINE north star.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["VerifyResult", "verify", "gflops"]

REL_TOL = 1e-4  # src/sextans-host.cpp:274
DENOM_FLOOR = 1e-4  # src/sextans-host.cpp:273
PASS_MISMATCH_PERCENT = 2.0  # src/sextans-host.cpp:282


@dataclass
class VerifyResult:
    passed: bool
    mismatch_count: int
    mismatch_percent: float
    max_abs_err: float
    max_rel_err: float

    def __str__(self) -> str:
        status = "Success!" if self.passed else "Failed."
        return (
            f"{status}\nnum_mismatch = {self.mismatch_count}, "
            f"percent = {self.mismatch_percent:.2f}%  "
            f"(max_abs_err={self.max_abs_err:.3e}, max_rel_err={self.max_rel_err:.3e})"
        )


def verify(
    reference: np.ndarray,
    computed: np.ndarray,
    *,
    rel_tol: float = REL_TOL,
    pass_percent: float = PASS_MISMATCH_PERCENT,
) -> VerifyResult:
    """Reference-parity tolerance gate (src/sextans-host.cpp:262-289)."""
    ref = np.asarray(reference, dtype=np.float64)
    got = np.asarray(computed, dtype=np.float64)
    if ref.shape != got.shape:
        raise ValueError(f"shape mismatch: {ref.shape} vs {got.shape}")
    diff = np.abs(ref - got)
    denom = np.minimum(np.abs(ref), np.abs(got)) + DENOM_FLOOR
    rel = diff / denom
    mismatch = rel > rel_tol
    count = int(mismatch.sum())
    percent = 100.0 * count / max(ref.size, 1)
    return VerifyResult(
        passed=percent < pass_percent,
        mismatch_count=count,
        mismatch_percent=percent,
        max_abs_err=float(diff.max(initial=0.0)),
        max_rel_err=float(rel.max(initial=0.0)),
    )


def gflops(nnz: int, m: int, n: int, seconds: float) -> float:
    """GFLOPS = 2*N*(nnz+M)/t (src/sextans-host.cpp:255-259)."""
    if seconds <= 0:
        return float("inf")
    return 2.0 * n * (nnz + m) / 1e9 / seconds
