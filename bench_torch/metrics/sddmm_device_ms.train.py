"""Device milliseconds a training step in the SDDMM's kernel (``sddmm_*``,
``sextans_tpu_torch/csrc/sddmm.cu``); nothing to read where the traced
window ran no such kernel, as in a program that computes the SDDMM with
PyTorch operations."""

from bench_torch.trace import short


def read(record):
    tr = record.trace
    if not tr or not tr.units:
        return None
    kernel_s = tr.device_s(lambda op: short(op.name).startswith("sddmm_"))
    return kernel_s / tr.units * 1e3 if kernel_s > 0.0 else None
