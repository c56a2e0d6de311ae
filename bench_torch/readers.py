"""What the metric readers share (each metric's own file,
``metrics/<metric>.py``, names one of these as its ``read``)."""

from __future__ import annotations

from typing import Optional

from bench_torch.roofline import spmm_bound_s

K1 = "spmm_slab_tc_kernel"  # the slab kernel on the tensor cores, csrc/spmm_slab.cu


def window_ms_per_unit(record) -> Optional[float]:
    """Host-clock milliseconds a unit over the window: from its start to
    the final synchronise, over the units completed."""
    return record.window_s / record.units * 1e3 if record.units else None


def k1_roofline(record) -> Optional[float]:
    """K1's share of its roofline, in percent: the least time of a product
    (``roofline.py``, from A's nnz, M, K and N at the card's published
    peaks) over the device time a unit spends in K1. Nothing to read where
    the traced window ran no K1."""
    tr = record.trace
    kernel_s = tr.device_s(lambda op: K1 in op.name) if tr else 0.0
    if kernel_s <= 0.0 or not tr.units:
        return None
    s = record.shape
    return 100.0 * spmm_bound_s(s["nnz"], s["m"], s["k"], s["n"]) / (kernel_s / tr.units)


def outside_spmm_ms(record) -> Optional[float]:
    """Device milliseconds a unit in every operation that is not one of the
    port's SpMM kernels (``spmm_*``)."""
    tr = record.trace
    if not tr or not tr.device or not tr.units:
        return None
    return tr.device_s(lambda op: "spmm_" not in op.name) / tr.units * 1e3


def idle_pct(record) -> Optional[float]:
    """The device's idle share of the traced window (``Trace.idle_pct``)."""
    return record.trace.idle_pct() if record.trace else None
