"""K4's share of its roofline, in percent, in the cantilever's repeated
products through the edge stream: ``roofline.py``'s least time of a product
(from A's nnz, M, K and N, as K1's and K5's readers count it) over the
device time a unit spends in kernels whose short name starts with
``spmm_edge`` (K4, ``spmm_edge_kernel``). The yardstick is the product's
own least time, whatever precise level implements it: the extra operations
of level 2's error-free chain are work the product itself does not need, so
they show as a low share, by design. Nothing to read where the traced
window ran no such kernel."""

from bench_torch.roofline import spmm_bound_s
from bench_torch.trace import short


def read(record):
    tr = record.trace
    kernel_s = tr.device_s(lambda op: short(op.name).startswith("spmm_edge")) if tr else 0.0
    if kernel_s <= 0.0 or not tr.units:
        return None
    s = record.shape
    return 100.0 * spmm_bound_s(s["nnz"], s["m"], s["k"], s["n"]) / (kernel_s / tr.units)
