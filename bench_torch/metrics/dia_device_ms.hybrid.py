"""Device milliseconds a product in the DIA kernels (kernels whose short
name starts with ``spmm_dia``: K6, ``csrc/spmm_dia.cu``) in the circuit
matrix's hybrid products; nothing to read where the traced window ran no
such kernel."""

from bench_torch.trace import short


def read(record):
    tr = record.trace
    if not tr or not tr.units:
        return None
    kernel_s = tr.device_s(lambda op: short(op.name).startswith("spmm_dia"))
    return kernel_s / tr.units * 1e3 if kernel_s > 0.0 else None
