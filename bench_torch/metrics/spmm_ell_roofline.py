"""K5's share of its roofline, in percent, in the cantilever's repeated
products through the ELL engine: ``roofline.py``'s least time of a product
(from A's nnz, M, K and N, as K1's reader counts it) over the device time a
unit spends in kernels whose short name starts with ``spmm_ell`` (K5,
``spmm_ell_kernel``, and its long-row fold where one launches). Nothing to
read where the traced window ran no such kernel."""

from bench_torch.roofline import spmm_bound_s
from bench_torch.trace import short


def read(record):
    tr = record.trace
    kernel_s = tr.device_s(lambda op: short(op.name).startswith("spmm_ell")) if tr else 0.0
    if kernel_s <= 0.0 or not tr.units:
        return None
    s = record.shape
    return 100.0 * spmm_bound_s(s["nnz"], s["m"], s["k"], s["n"]) / (kernel_s / tr.units)
