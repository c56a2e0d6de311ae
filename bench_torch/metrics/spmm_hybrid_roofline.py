"""The hybrid product's share of its roofline, in percent, in the circuit
matrix's repeated products: ``roofline.py``'s least time of a product (from
A's nnz, M, K and N, as the other roofline readers count it) over the
device's busy time a unit, the union of all its operations' intervals
(``Trace.busy_s``). The product is many operations (K6, the hub matmuls, a
gather, the adds), so the whole product is the yardstick, whatever
implements it. Nothing to read where the traced window ran nothing on the
device."""

from bench_torch.roofline import spmm_bound_s


def read(record):
    tr = record.trace
    busy_s = tr.busy_s() if tr and tr.device else 0.0
    if busy_s <= 0.0 or not tr.units:
        return None
    s = record.shape
    return 100.0 * spmm_bound_s(s["nnz"], s["m"], s["k"], s["n"]) / (busy_s / tr.units)
