"""The card's published peaks and the least time of a product.

The arithmetic of ``chip_smoke.py:bound`` and the peaks of
``sextans_tpu_torch/utils/timing.py`` (``PEAK_F32_FLOPS``, ``PEAK_HBM_BYTES``),
copied so that the yardstick stays where later changes to the program cannot
move it. The work is counted from A's nnz, M, K and N, never from a pack's
slots, so it reads the same whatever implements the product.
"""

from __future__ import annotations

# one NVIDIA H100 SXM at its full 700 W (NVIDIA's data sheet): f32 outside
# the tensor cores, and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12


def spmm_flops(nnz: int, n: int) -> float:
    """Operations of C = alpha * A @ B + beta * C that A's entries need: a
    multiply and an add per entry and column."""
    return 2.0 * nnz * n


def spmm_bytes(nnz: int, m: int, k: int, n: int) -> float:
    """Bytes each input needs read once and the output written once: A's
    values and column indices (8 bytes an entry), B (K x N f32), C in and
    out (M x N f32 each)."""
    return 8.0 * nnz + 4.0 * k * n + 8.0 * m * n


def spmm_bound_s(nnz: int, m: int, k: int, n: int) -> float:
    """Least seconds of one product on one card: the larger of its
    operations over the f32 peak and its bytes over the HBM peak."""
    return max(spmm_flops(nnz, n) / PEAK_F32_FLOPS, spmm_bytes(nnz, m, k, n) / PEAK_HBM_BYTES)
